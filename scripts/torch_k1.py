#!/usr/bin/env python3
"""K1 (the f32-state decode step) alone on the card.

Builds only ``decode_step.cu`` (seconds), prints the compiler's register
and spill report and the launch each build makes (grid and threads of a
block), holds the kernel against its plain version
(``kernels.ref.selective_state_step``: y within 1e-5 f32 / 2e-2 bf16, h'
within 1e-5) at d 513, 1040, 1100, 1536 (mamba-130m), 5120 (mamba-2.8b)
and 8192 (jamba-v0.1) by slots 1, 4, 9 and 16, f32 and int8 A, f32 and
bf16, every exp/SiLU variant, on B and C rows cut from one wider x_proj
output as the Mamba block passes them (dt_rank ceil(d / 32): 17, 33, 35,
48, 160 and 256, so some rows start only 2-byte aligned); holds y and h'
equal to every ``--root`` build's bit for bit, checks that each launch
repeats bit for bit, and counts the device kernels a call.  Then it
times the bf16 rows (mamba-130m at 4 slots, 1 and 16 slots, mamba-2.8b's
and jamba's widths at 4 slots, jamba's at 16, the ragged d 1100), f32 A
and int8 A, as CUDA-graph device time: hot (the same inputs every call,
as ``chip_smoke.device_ms`` times it) and cold (a rotation over
distinct input sets of more than 100 MB together, so every call reads
from device memory and not from the 50 MB L2), beside the byte bound,
in turns over the builds.  Run from the repository root on a machine
with a CUDA card:

    python3 scripts/torch_k1.py [--root DIR ...] [--floor] [--sass DIR]
                                [--decode]

Each ``--root`` (repeatable) builds another tree's ``decode_step.cu`` (a
``git archive`` of an earlier commit unpacked under ``build/``, patched
there to try a design), checks it and times its rows in the same process,
in turns (the roots, this tree, this tree, the roots in reverse).
``--floor`` adds two timed-only builds that price the launch at this
tree's shape: a kernel that does nothing and one that only copies h to
h' in 16-byte words.  ``--sass DIR`` writes each build's SASS
(``cuobjdump -sass``) to DIR.  ``--decode`` also builds the full library
(about 70 s) and times the per-layer mamba-130m decode step (f32
weights, and int8 weights with an f32 state) with each checked build's
K1 in its place, in turns.  Each source is built by its own ``nvcc``,
all started together.  It exits non-zero if a check fails.
"""
import argparse
import ctypes
import itertools
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as cs  # noqa: E402

ENTRY = "marca_decode_step"
SHAPE = "marca_decode_step_shape"
SRC = "src/repro_torch/csrc/decode_step.cu"
DS = (513, 1040, 1100, 1536, 5120, 8192)
SLOTS = (1, 4, 9, 16)
# (slots, d) of the timed rows, bf16
ROWS = ((4, 1536), (1, 1536), (16, 1536), (4, 5120), (4, 8192),
        (16, 8192), (4, 1100))
COLD_BYTES = 100e6

# the floor: a kernel at this tree's launch shape that does nothing, and
# one that copies h to h' in 16-byte words (4 lanes a channel, 32
# channels a block of 128); timed only, never shipped
FLOOR = r"""
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(128)
floor_decode_step_kernel(const float4* __restrict__ h,
                         float4* __restrict__ h_new, int d) {
  const int ch = blockIdx.x * 32 + threadIdx.x / 4;
  if (ch >= d) return;
  const int64_t i = ((int64_t)blockIdx.y * d + ch) * 4 + threadIdx.x % 4;
  BODY
}

}  // namespace

extern "C" int marca_decode_step(const void* h, const void*, const void*,
                                 const void*, const void*, const void*,
                                 const void*, const void*, const void*,
                                 void*, void* h_new, int slots, int d, int n,
                                 int64_t, int64_t, int64_t, int64_t, int64_t,
                                 int, int, int, void* stream) {
  if (n != 16 || slots < 1 || slots > 65535 || d < 1)
    return cudaErrorInvalidValue;
  floor_decode_step_kernel<<<dim3((d + 31) / 32, slots), 128, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      (const float4*)h, (float4*)h_new, d);
  return (int)cudaGetLastError();
}

extern "C" int marca_decode_step_shape(int slots, int d, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = (d + 31) / 32;
  o[1] = slots;
  o[2] = 128;
  return 0;
}
"""
FLOOR_BODIES = {"floor_empty": "(void)i;", "floor_copy": "h_new[i] = h[i];"}


def log(*a):
    print(*a, flush=True)


def build(sources, sass_dir=None):
    """{name: loaded library} of each (name, .cu file) in ``sources``, one
    ``nvcc`` each, all started together; prints each build's register
    and spill report (and writes its SASS to ``sass_dir``)."""
    from repro_torch.kernels import _lib
    out = HERE / "build" / "k1"
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
            text, lambda f: f if "decode_step_kernel" in f else None)
        log(f"built {name} ({so.name}): " + "; ".join(
            f"{k[:60]} {r['registers']} registers, {r['spill_stores']} B "
            f"spilled" for k, r in regs.items()))
        if sass_dir is not None:
            tool = Path(_lib.nvcc()).with_name("cuobjdump")
            sass = subprocess.run([str(tool), "-sass", str(so)],
                                  capture_output=True, text=True,
                                  check=True, timeout=300).stdout
            (sass_dir / f"k1_{name}.sass").write_text(sass)
        handle = ctypes.CDLL(str(so))
        for sym in (ENTRY, SHAPE):
            if hasattr(handle, sym):
                fn = getattr(handle, sym)
                fn.argtypes = _lib._SIGNATURES[sym]
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
    without the report (the parent's design) launched grid (ceil(d / 8),
    slots) of 128 threads."""
    from repro_torch.kernels import decode_step
    if not hasattr(handle, SHAPE):
        return f"grid ({-(-d // 8)}, {slots}) x 128"
    use(handle)
    s = decode_step.launch_shape(slots, d)
    return f"grid {s['grid']} x {s['threads']}"


def inputs(slots, d, a8, dtype, dev, seed):
    """chip_smoke's step inputs: x and z halves of one (slots, 2d) row, B
    and C columns of one (slots, r + 32) x_proj row after dt_rank r =
    ceil(d / 32) columns, h and A (f32, or int8 codes with a_scale)."""
    from repro_torch.core import weight_quant
    gen = torch.Generator().manual_seed(seed)
    x, dt, A, B, C, D, z, h = cs.scan_inputs(slots, 1, d, 16, -(-d // 32),
                                             dtype, gen, dev)
    a_scale = None
    if a8:
        A, a_scale = weight_quant.quantize_rows(A)
    args = (h, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    return args, dict(D=D, z_t=z[:, 0], a_scale=a_scale)


def fresh(t):
    """A copy of ``t`` in new memory, cut from a copy of its base with the
    same strides."""
    if t is None:
        return None
    base = t if t._base is None else t._base
    return base.clone().as_strided(t.size(), t.stride(),
                                   t.storage_offset() - base.storage_offset())


def raw(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.dtype.itemsize])


def same_bits(a, b) -> bool:
    """Whether two (y, h') results hold the same bits."""
    return all(torch.equal(raw(u), raw(v)) for u, v in zip(a, b))


def checks(dev, handles):
    """Every shape against the plain version, repeated bit for bit, one
    device kernel a call, and bitwise against every other build."""
    from repro_torch.kernels import decode_step, ref
    graph_kernels = cs.shared_inputs().graph_kernels
    tree = handles["tree"]
    n = 0
    for d in DS:
        for slots in SLOTS:
            for a8 in (False, True):
                for dtype, tol in ((torch.float32, 1e-5),
                                   (torch.bfloat16, 2e-2)):
                    args, kw = inputs(slots, d, a8, dtype, dev,
                                      cs.SEED + d + slots)
                    for ei, si in cs.VARIANTS:
                        kw.update(exp_impl=ei, silu_impl=si)
                        name = (f"K1 d={d} slots={slots} "
                                f"{'int8' if a8 else 'f32'} A "
                                f"{str(dtype)[6:]} exp={ei} silu={si}")
                        use(tree)
                        n0 = decode_step.launches + decode_step.launches_int8a
                        got = decode_step.selective_state_step(*args, **kw)
                        again = decode_step.selective_state_step(*args, **kw)
                        calls = (decode_step.launches
                                 + decode_step.launches_int8a - n0)
                        want = ref.selective_state_step(*args, **kw)
                        torch.cuda.synchronize()
                        quiet = cs.log
                        cs.log = lambda m: None
                        ey = cs.check(name + " y", got[0], want[0], tol, tol)
                        eh = cs.check(name + " h'", got[1], want[1], 1e-5,
                                      1e-5)
                        cs.log = quiet
                        same = same_bits(got, again)
                        others = {}
                        for label, h in handles.items():
                            if label == "tree":
                                continue
                            use(h)
                            o = decode_step.selective_state_step(*args, **kw)
                            torch.cuda.synchronize()
                            others[label] = same_bits(got, o)
                        use(tree)
                        nk = graph_kernels(
                            lambda: decode_step.selective_state_step(*args,
                                                                     **kw))
                        n += 1
                        bad = (any(name in f for f in cs.FAILURES)
                               or not same or calls != 2 or nk != 1
                               or not all(others.values()))
                        if bad or (slots == 4 and dtype == torch.bfloat16
                                   and ei == "exact"):
                            log(f"  {name}: y err {ey:.2e}, h' err "
                                f"{eh:.2e}, repeated "
                                f"{'bitwise equal' if same else 'FAIL'}, "
                                f"{nk} device kernel(s) a call, "
                                + ", ".join(
                                    f"vs {k} "
                                    f"{'bitwise equal' if v else 'FAIL'}"
                                    for k, v in others.items())
                                + f"  {'FAIL' if bad else 'ok'}")
                        if bad and name not in cs.FAILURES:
                            cs.FAILURES.append(name)
    log(f"K1: {n} cases checked")


def work(slots, d, a8):
    """(bytes, operations) of one bf16 call: chip_smoke's s6_work, A as
    int8 codes plus its (d,) scales where ``a8``."""
    nbytes, ops, _ = cs.s6_work(slots, 1, d, 16, 2, True)
    if a8:
        return nbytes - 3 * d * 16, ops + d * 16
    return nbytes, ops


def timing(dev, handles):
    """The bf16 rows, hot and cold, in turns over the builds (each in
    order, then in reverse), CUDA-graph device time in µs, beside the
    byte bound."""
    from repro_torch.kernels import decode_step
    order = list(handles.items())
    order += list(reversed(order))
    for slots, d in ROWS:
        for a8 in (False, True):
            args, kw = inputs(slots, d, a8, torch.bfloat16, dev,
                              cs.SEED + 7)
            nbytes, ops = work(slots, d, a8)
            bound = cs.bound_ms(nbytes, ops)[0] * 1e3
            out_bytes = slots * d * (2 + 64)
            n_sets = int(COLD_BYTES // (nbytes - out_bytes)) + 1
            sets = [([fresh(t) for t in args],
                     {k: fresh(v) for k, v in kw.items()})
                    for _ in range(n_sets)]
            got = {}
            for label, handle in order:
                use(handle)
                hot = cs.device_ms(
                    lambda: decode_step.selective_state_step(*args, **kw),
                    50) * 1e3
                ring = itertools.cycle(sets)

                def cold_call():
                    a, k = next(ring)
                    return decode_step.selective_state_step(*a, **k)
                cold = cs.device_ms(cold_call, n_sets) * 1e3
                got.setdefault(label, []).append((hot, cold))
            del sets
            torch.cuda.empty_cache()
            cells = "; ".join(
                f"{k} " + " / ".join(f"{h:.2f}" for h, _ in vs) + " hot, "
                + " / ".join(f"{c:.2f}" for _, c in vs) + " cold"
                for k, vs in got.items())
            log(f"K1 slots={slots} d={d} {'int8' if a8 else 'f32'} A bf16: "
                f"{cells} µs; bound {bound:.3f} µs (bytes, "
                f"{nbytes / 1e6:.2f} MB); cold over {n_sets} sets")
        for label, handle in handles.items():
            log(f"    {label}: {shape_of(handle, slots, d)}")
    use(handles["tree"])


def decode_steps(dev, handles):
    """The per-layer mamba-130m decode step at 4 slots, bf16, CUDA-graph
    device time (24 K1 launches among each step's other kernels and
    GEMMs), f32 weights and state, and int8 weights with an f32 state
    (K1 with int8 A): each build's K1 swapped into the full library, in
    turns over the builds."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.models import registry
    _lib._lib = None
    t0 = time.perf_counter()
    full = _lib.lib()
    log(f"built the full library in {time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(configs.get_config("mamba-130m"),
                              scan_impl="pallas", conv_impl="pallas",
                              step_impl="fused", dtype="bfloat16",
                              state_dtype="f32")
    order = list(handles.items())
    order += list(reversed(order))
    for wd in ("f32", "int8"):
        c = dataclasses.replace(cfg, weight_dtype=wd)
        p = cs.k3_params(c, wd, dev)
        cache = registry.init_cache(c, 4, 64, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}
        got = {}
        for label, handle in order:
            full.marca_decode_step = handle.marca_decode_step
            ms, how = cs.device_time(
                lambda: registry.decode_step(c, p, cache, batch), 5)
            got.setdefault(label, []).append(f"{ms:.4f}")
        log(f"mamba-130m decode step per layer at 4 slots, bf16, {wd} "
            f"weights, f32 state ({how}): " + "; ".join(
                f"{k} " + " / ".join(v) for k, v in got.items()) + " ms")
    _lib._lib = None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, action="append", default=[],
                    help="also check and time this tree's kernel")
    ap.add_argument("--floor", action="store_true",
                    help="also time the empty and copy-only kernels")
    ap.add_argument("--sass", type=Path, help="write each build's SASS here")
    ap.add_argument("--decode", action="store_true",
                    help="also time the per-layer mamba-130m decode step "
                    "with each checked build's K1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    log(cs.card_line())
    sources = [(f"root{i}:{r.name}", r.resolve() / SRC)
               for i, r in enumerate(args.root)]
    sources.append(("tree", HERE / SRC))
    timed_only = []
    if args.floor:
        out = HERE / "build" / "k1"
        out.mkdir(parents=True, exist_ok=True)
        for name, body in FLOOR_BODIES.items():
            src = out / f"{name}.cu"
            src.write_text(FLOOR.replace("BODY", body))
            sources.append((name, src))
            timed_only.append(name)
    if args.sass is not None:
        args.sass.mkdir(parents=True, exist_ok=True)
    handles = build(sources, args.sass)
    t0 = time.perf_counter()
    checks(dev, {k: v for k, v in handles.items() if k not in timed_only})
    log(f"checks took {time.perf_counter() - t0:.1f} s")
    timing(dev, handles)
    if args.decode:
        decode_steps(dev, {k: v for k, v in handles.items()
                           if k not in timed_only})
    log(cs.card_line())
    log(f"failures: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
