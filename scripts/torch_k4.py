#!/usr/bin/env python3
"""K4 (the prefill selective scan) alone on the card.

Builds only ``selective_scan.cu`` (seconds), prints the compiler's
register and spill report, holds the kernel against its plain version
(``kernels.ref.selective_scan``) at the lengths where its time segments
begin and end (L 1, 2, 31, 32, 33, 127, 300, 512, 576), b 1 and 3, with
h0 and without, on the strided x/z and B/C views the Mamba block passes
(dt_rank 48, d_inner 1536: B and C read 4 states at a time; dt_rank 35,
d_inner 1102: element by element, a ragged last block of channels),
f32 and bf16, every exp/SiLU variant, at chip_smoke's tolerances (y 5e-4
f32 and 2e-2 bf16, h_last 5e-4), each launch repeated bit for bit and
one device kernel a call; then times the bf16 prefill rows (exact exp,
h0 none: L 64, 127, 256 and 512 at mamba-130m's d_inner 1536, L 512 at
jamba's 8192, and L 512 where the call's channels b * d lie between the
two: b=2 at 1536, b=1 at mamba-370m's 2048 and mamba-790m's 3072) as
CUDA-graph device time beside the bytes and exponentials bound, with the
time segments the kernel a call ran was built for (its name's last
template argument).  Run from the repository root on a machine with a
CUDA card:

    python3 scripts/torch_k4.py [--root DIR]

``--root`` also builds another tree's ``selective_scan.cu`` (a ``git
archive`` of an earlier commit unpacked under ``build/``, patched there
to try a design) and times its rows in the same process, in turns (that
tree, this one, this one, that tree).  Each source is built by its own
``nvcc``, both started together.  It prints each bf16 kernel's SASS
instruction counts.  It exits non-zero if a check fails.
"""
import argparse
import ctypes
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as cs  # noqa: E402

ENTRY = "marca_selective_scan"
LENGTHS = (1, 2, 31, 32, 33, 127, 300, 512, 576)
# (b, d, L) of the timed rows, bf16, exact exp, h0 none
ROWS = ((1, 1536, 64), (1, 1536, 127), (1, 1536, 256), (1, 1536, 512),
        (1, 8192, 512), (2, 1536, 512), (1, 2048, 512), (1, 3072, 512))


def log(*a):
    print(*a, flush=True)


def build(sources):
    """{name: (.so path, loaded library)} of each (name, .cu file) in
    ``sources``, one ``nvcc`` each, all started together; prints each
    build's register and spill report."""
    from repro_torch.kernels import _lib
    out = HERE / "build" / "k4"
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
        log(f"built {name} ({so.name})")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  " + line.strip())
        handle = ctypes.CDLL(str(so))
        fn = getattr(handle, ENTRY)
        fn.argtypes = _lib._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        handles[name] = (so, handle)
    log(f"built {len(procs)} in {time.perf_counter() - t0:.1f} s")
    return handles


def sass_counts(so):
    """Instruction counts of each bf16 kernel in ``so``'s SASS."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(so)], capture_output=True, text=True,
                          check=True).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "bfloat16" in m.group(1) else None
            if fn:
                counts[fn] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9]*)(\.[A-Z0-9.]+)?", line)
        if fn and m:
            counts[fn][m.group(1)] += 1
    for fn, c in counts.items():
        log(f"  SASS {fn}: {sum(c.values())} instructions; "
            + ", ".join(f"{k} {v}" for k, v in c.most_common(16)))


def use(handle):
    """Route the wrapper's launches to ``handle``."""
    from repro_torch.kernels import _lib
    _lib._lib = handle


def checks(dev):
    """Each case against the plain version, repeated bit for bit, one
    device kernel a call."""
    from repro_torch.kernels import ref, selective_scan
    graph_kernels = cs.shared_inputs().graph_kernels
    gen = torch.Generator().manual_seed(cs.SEED + 40)
    n = 0
    dtypes = ((torch.float32, 5e-4), (torch.bfloat16, 2e-2))
    for dtype, tol in dtypes:
        for r in (48, 35):
            for L in LENGTHS:
                for b in (1, 3):
                    for h0 in (True, False):
                        variants = (cs.VARIANTS if (r, b, h0) == (48, 1, True)
                                    else cs.VARIANTS[:1])
                        for ei, si in variants:
                            x, dt, A, B, C, D, z, hinit = cs.scan_inputs(
                                b, L, 1536 if r == 48 else 1102, 16, r,
                                dtype, gen, dev, h0=h0)
                            kw = dict(D=D, z=z, h0=hinit, exp_impl=ei,
                                      silu_impl=si)
                            n0 = selective_scan.launches
                            y1, h1 = selective_scan.selective_scan(
                                x, dt, A, B, C, **kw)
                            y2, h2 = selective_scan.selective_scan(
                                x, dt, A, B, C, **kw)
                            y0, hr = ref.selective_scan(x, dt, A, B, C, **kw)
                            torch.cuda.synchronize()
                            name = (f"K4 {str(dtype)[6:]} dt_rank={r} L={L} "
                                    f"b={b} h0={h0} exp={ei} silu={si}")
                            quiet = cs.log
                            cs.log = lambda m: None
                            e1 = cs.check(name + " y", y1, y0, tol, tol)
                            e2 = cs.check(name + " h_last", h1, hr, 5e-4,
                                          5e-4)
                            cs.log = quiet
                            same = torch.equal(y1, y2) and torch.equal(h1, h2)
                            calls = selective_scan.launches - n0
                            nk = 1
                            if L in (33, 512) and ei == "exact":
                                nk = graph_kernels(
                                    lambda: selective_scan.selective_scan(
                                        x, dt, A, B, C, **kw))
                            n += 1
                            bad = (not same or calls != 2 or nk != 1
                                   or name + " y" in cs.FAILURES
                                   or name + " h_last" in cs.FAILURES)
                            if bad or L in (1, 33, 576):
                                log(f"  {name}: y err {e1:.2e}, h_last err "
                                    f"{e2:.2e}, repeated "
                                    f"{'bitwise equal' if same else 'FAIL'}"
                                    f", {nk} device kernel(s) a call  "
                                    f"{'FAIL' if bad else 'ok'}")
                            if bad and name not in cs.FAILURES:
                                cs.FAILURES.append(name)
    log(f"K4: {n} cases checked")


def timing(dev, handles):
    """The rows in turns over the builds (each in order, then in reverse),
    CUDA-graph device time in µs, and each build's time segments."""
    from repro_torch.kernels import selective_scan
    device_kernels = cs.shared_inputs().device_kernels
    gen = torch.Generator().manual_seed(cs.SEED + 41)
    order = list(handles) + list(reversed(handles))
    for b, d, L in ROWS:
        x, dt, A, B, C, D, z, _ = cs.scan_inputs(b, L, d, 16, 48,
                                                 torch.bfloat16, gen, dev,
                                                 h0=False)
        nbytes, ops, exps = cs.s6_work(b, L, d, 16, 2, False)
        bound = max(nbytes / cs.HBM_BYTES_PER_S, exps / cs.SFU_PER_S) * 1e6
        by = "bytes" if nbytes / cs.HBM_BYTES_PER_S >= exps / cs.SFU_PER_S \
            else "exp"
        got, segs = {}, {}
        for label, handle in order:
            use(handle)

            def call():
                return selective_scan.selective_scan(x, dt, A, B, C, D=D,
                                                     z=z)
            if label not in segs:
                names = device_kernels(call)
                segs[label] = ",".join(
                    m.group(1) for m in (re.search(r"(\d+)>", n)
                                         for n in names) if m) or "?"
            us = cs.device_ms(call, 20) * 1e3
            got.setdefault(label, []).append(us)
        cells = "; ".join(f"{k} ({segs[k]} segments) "
                          + " / ".join(f"{v:.2f}" for v in vs)
                          for k, vs in got.items())
        log(f"K4 b={b} L={L} d={d} bf16 exact: {cells} µs; bound "
            f"{bound:.2f} µs (by {by})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="also time this tree's kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k4: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    log(cs.card_line())
    here = HERE / "src/repro_torch/csrc/selective_scan.cu"
    sources = [("tree", here)]
    if args.root is not None:
        sources.insert(0, ("root", args.root.resolve()
                           / "src/repro_torch/csrc/selective_scan.cu"))
    built = build(sources)
    sass_counts(built["tree"][0])
    handles = [(name, h) for name, (_, h) in built.items()]
    use(built["tree"][1])
    t0 = time.perf_counter()
    checks(dev)
    log(f"checks took {time.perf_counter() - t0:.1f} s")
    timing(dev, handles)
    use(built["tree"][1])
    log(cs.card_line())
    log(f"failures: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
