#!/usr/bin/env python3
"""K2 (the quantized-state decode step) alone on the card.

Builds only ``decode_step_q.cu`` (seconds), prints the compiler's
register and spill report and the launch each build makes (grid, blocks
of a thread-block cluster, threads of a block), holds the kernel against
its plain version (``kernels.ref.selective_state_step_q``) at d 512, 513
(a ragged group of one channel), 1100, 1536 (mamba-130m) and 8192
(jamba-v0.1) by slots 1, 4, 9 and 16, int8 and fp8 state, f32 and int8
A, f32 and bf16 (chip_smoke's rules: y within 1e-4 / 2e-2, scales to
rtol 1e-6, payloads within one code), each launch repeated bit for bit;
holds y, the payload and the scales equal to every ``--root`` build's bit
for bit at every shape; counts the device kernels a call; then times the
bf16 rows (mamba-130m at 4 slots, int8 and fp8 state, int8 A as served
and f32 A; d 8192; 1 and 16 slots; d 1100) as CUDA-graph device time
beside the byte bound, in turns over the builds.  Run from the
repository root on a machine with a CUDA card:

    python3 scripts/torch_k2.py [--root DIR ...]

Each ``--root`` (repeatable) builds another tree's ``decode_step_q.cu``
(a ``git archive`` of an earlier commit unpacked under ``build/``,
patched there to try a design) and times its rows in the same process,
in turns (the roots, this tree, this tree, the roots in reverse).  Each
source is built by its own ``nvcc``, all started together.  It exits
non-zero if a check fails.
"""
import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as cs  # noqa: E402

ENTRY = "marca_decode_step_q"
SHAPE = "marca_decode_step_q_shape"
DS = (512, 513, 1100, 1536, 8192)
SLOTS = (1, 4, 9, 16)
# (slots, d, state, int8 A) of the timed rows, bf16
ROWS = ((4, 1536, "int8", True), (4, 1536, "fp8", True),
        (4, 1536, "int8", False), (4, 1536, "fp8", False),
        (4, 8192, "int8", True), (4, 8192, "fp8", True),
        (1, 1536, "int8", True), (16, 1536, "int8", True),
        (4, 1100, "int8", True))


def log(*a):
    print(*a, flush=True)


def build(sources):
    """{name: loaded library} of each (name, .cu file) in ``sources``, one
    ``nvcc`` each, all started together; prints each build's register
    and spill report."""
    from repro_torch.kernels import _lib
    out = HERE / "build" / "k2"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in sources:
        so = out / f"lib_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_lib.nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I",
             str(_lib.CSRC), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    handles = {}
    for name, (so, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{text}")
        regs = cs.kernel_registers(
            text, lambda f: f if "decode_step_q_kernel" in f else None)
        log(f"built {name} ({so.name}): " + "; ".join(
            f"{r['registers']} registers, {r['spill_stores']} B spilled"
            for r in regs.values()))
        handle = ctypes.CDLL(str(so))
        fn = getattr(handle, ENTRY)
        fn.argtypes = _lib._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        if hasattr(handle, SHAPE):
            fn = getattr(handle, SHAPE)
            fn.argtypes = _lib._SIGNATURES[SHAPE]
            fn.restype = ctypes.c_int
        handles[name] = handle
    log(f"built {len(procs)} in {time.perf_counter() - t0:.1f} s")
    return handles


def use(handle):
    """Route the wrapper's launches to ``handle``."""
    from repro_torch.kernels import _lib
    _lib._lib = handle


def shape_of(handle, slots, d):
    """The launch a build makes for (slots, d), as it reports it; a build
    without the report (the 12-block design) launched grid (groups,
    slots) of 512 threads, no cluster."""
    from repro_torch.kernels import decode_step
    if not hasattr(handle, SHAPE):
        return f"grid ({-(-d // 512)}, {slots}) x 512, no cluster"
    use(handle)
    s = decode_step.q_launch_shape(slots, d)
    return (f"grid {s['grid']} x {s['threads']}, clusters of "
            f"{s['cluster']}")


def inputs(slots, d, sd, a8, dtype, dev, seed):
    """chip_smoke's K2 inputs: slot 0 a fresh slot (zero codes, zero
    scale), the others h * 4 quantized; z and D given."""
    gen = torch.Generator().manual_seed(seed)
    x, dt, A, B, C, D, z, h = cs.scan_inputs(slots, 1, d, 16, 48, dtype,
                                             gen, dev)
    hq, h_scale = cs.q_state(h, sd)
    a_scale = None
    if a8:
        from repro_torch.core import weight_quant
        A, a_scale = weight_quant.quantize_rows(A)
    args = (hq, h_scale, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    return args, dict(D=D, z_t=z[:, 0], state_dtype=sd, a_scale=a_scale)


def same_bits(a, b) -> bool:
    """Whether two (y, payload, scales) results hold the same bits."""
    def raw(t):
        return t.view(torch.uint8) if t.dtype.itemsize == 1 else t.view(
            torch.int16 if t.dtype.itemsize == 2 else torch.int32)
    return all(torch.equal(raw(u), raw(v)) for u, v in zip(a, b))


def checks(dev, handles):
    """Every shape against the plain version, repeated bit for bit, and
    bitwise against every other build."""
    from repro_torch.kernels import decode_step, ref
    graph_kernels = cs.shared_inputs().graph_kernels
    tree = handles["tree"]
    n = 0
    for d in DS:
        for slots in SLOTS:
            for sd in ("int8", "fp8"):
                for a8 in (False, True):
                    for dtype, tol in ((torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)):
                        args, kw = inputs(slots, d, sd, a8, dtype, dev,
                                          cs.SEED + d + slots)
                        name = (f"K2 d={d} slots={slots} {sd} "
                                f"{'int8' if a8 else 'f32'} A "
                                f"{str(dtype)[6:]}")
                        use(tree)
                        n0 = decode_step.launches_q
                        got = decode_step.selective_state_step_q(*args, **kw)
                        again = decode_step.selective_state_step_q(*args,
                                                                   **kw)
                        calls = decode_step.launches_q - n0
                        want = ref.selective_state_step_q(*args, **kw)
                        torch.cuda.synchronize()
                        quiet = cs.log
                        cs.log = lambda m: None
                        ey = cs.check_q(name, got, want, tol)
                        cs.log = quiet
                        same = same_bits(got, again)
                        others = {}
                        for label, h in handles.items():
                            if label == "tree":
                                continue
                            use(h)
                            o = decode_step.selective_state_step_q(*args,
                                                                   **kw)
                            torch.cuda.synchronize()
                            others[label] = same_bits(got, o)
                        use(tree)
                        nk = 1
                        if slots == 4 and dtype == torch.bfloat16:
                            nk = graph_kernels(
                                lambda: decode_step.selective_state_step_q(
                                    *args, **kw))
                        n += 1
                        bad = (name in cs.FAILURES or not same
                               or calls != 2 or nk != 1
                               or not all(others.values()))
                        if bad or (slots == 4 and dtype == torch.bfloat16):
                            log(f"  {name}: y err {ey:.2e}, repeated "
                                f"{'bitwise equal' if same else 'FAIL'}, "
                                f"{nk} device kernel(s) a call, "
                                + ", ".join(
                                    f"vs {k} {'bitwise equal' if v else 'FAIL'}"
                                    for k, v in others.items())
                                + f"  {'FAIL' if bad else 'ok'}")
                        if bad and name not in cs.FAILURES:
                            cs.FAILURES.append(name)
    log(f"K2: {n} cases checked")


def timing(dev, handles):
    """The bf16 rows in turns over the builds (each in order, then in
    reverse), CUDA-graph device time in µs, beside the byte bound."""
    from repro_torch.kernels import decode_step
    order = list(handles.items())
    order += list(reversed(order))
    for slots, d, sd, a8 in ROWS:
        args, kw = inputs(slots, d, sd, a8, torch.bfloat16, dev,
                          cs.SEED + 7)
        nbytes, ops = cs.q_step_work(slots, d, 16, 2)
        if not a8:
            nbytes += 3 * d * 16   # A in f32 instead of int8 codes
        bound = cs.bound_ms(nbytes, ops)[0] * 1e3
        got = {}
        for label, handle in order:
            use(handle)
            us = cs.device_ms(
                lambda: decode_step.selective_state_step_q(*args, **kw),
                50) * 1e3
            got.setdefault(label, []).append(us)
        cells = "; ".join(f"{k} " + " / ".join(f"{v:.2f}" for v in vs)
                          for k, vs in got.items())
        log(f"K2 slots={slots} d={d} {sd} state "
            f"{'int8' if a8 else 'f32'} A bf16: {cells} µs; bound "
            f"{bound:.3f} µs (bytes)")
        for label, handle in handles.items():
            log(f"    {label}: {shape_of(handle, slots, d)}")
    use(handles["tree"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, action="append", default=[],
                    help="also check and time this tree's kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    log(cs.card_line())
    src = "src/repro_torch/csrc/decode_step_q.cu"
    sources = [(f"root{i}:{r.name}", r.resolve() / src)
               for i, r in enumerate(args.root)]
    sources.append(("tree", HERE / src))
    handles = build(sources)
    t0 = time.perf_counter()
    checks(dev, handles)
    log(f"checks took {time.perf_counter() - t0:.1f} s")
    timing(dev, handles)
    log(cs.card_line())
    log(f"failures: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
