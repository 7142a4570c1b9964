#!/usr/bin/env python3
"""K5 (causal conv) and K7 (flash attention) alone on the card.

Builds only ``conv1d.cu`` and ``flash_attention.cu`` (seconds, where the
whole library takes half a minute), prints the compiler's register and
spill report and each kernel's tensor-core (HGMMA) and TMA (UTMALDG)
instruction counts from ``cuobjdump -sass``, holds both kernels against
their plain versions at many shapes (K7 in bf16 and f32, ragged and
suffix lengths, GQA packings, dh 16-128, each launch repeated bit for
bit; K5 at L 1-300, d 17-1536, with and without x_prev, dense or
strided x, its tail bitwise), then times them at jamba's and
mamba-130m's shapes beside SDPA and ``F.conv1d`` (device time from a
CUDA graph replay, eager time from CUDA events, device kernels a call
from the nodes of a graph that captures one), and splits the host cost
of one eager K5 call into its pieces.  Run from the repository root on
a machine with a CUDA card:

    python3 scripts/torch_k5_k7.py

It exits non-zero if a check fails.
"""
import re
import subprocess
import sys
import time
import timeit
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

FAILURES = []


def log(*a):
    print(*a, flush=True)


def build():
    """Build a library of the two sources only (its own hash)."""
    from repro_torch.kernels import _lib
    _lib.SOURCES = ("conv1d.cu", "flash_attention.cu")
    _lib.BUILDS = {}
    _lib._SIGNATURES = {k: v for k, v in _lib._SIGNATURES.items()
                        if k in ("marca_causal_conv1d",
                                 "marca_flash_attention")}
    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    log(_lib.build_log())
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(so)], capture_output=True, text=True,
                          check=True).stdout
    fn = None
    for line in sass.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if fn:
                log(f"SASS {fn}: {counts}")
            fn, counts = m.group(1), {"HGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in counts:
                counts[op] += bool(re.search(rf"\b{op}\b", line))


def graph_us(fn, reps=20):
    """Device time of one call, from a CUDA graph of ``reps`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return event_us(g.replay, 20) / reps


def event_us(fn, iters=200):
    """Time of one call issued eagerly, host cost included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters * 1e3


def check_k7(dev, gen):
    from repro_torch.kernels import flash_attention, ref
    shapes = [  # b, lq, lk, hq, hkv, dh
        (1, 64, 64, 32, 8, 128), (1, 127, 127, 32, 8, 128),
        (1, 512, 512, 32, 8, 128), (1, 64, 512, 32, 8, 128),
        (1, 65, 65, 32, 8, 128), (1, 129, 129, 32, 8, 128),
        (1, 200, 200, 32, 8, 128), (1, 37, 300, 32, 8, 128),
        (2, 300, 300, 32, 8, 128), (1, 500, 700, 32, 8, 128),
        (2, 37, 37, 4, 2, 16), (1, 17, 100, 8, 2, 64), (1, 1, 45, 4, 4, 16),
        (2, 70, 70, 8, 8, 64), (1, 100, 100, 6, 2, 96),
        (1, 33, 33, 4, 4, 32)]
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        for b, lq, lk, hq, hkv, dh in shapes:
            name = f"K7 {dtype} b={b} lq={lq} lk={lk} hq={hq} hkv={hkv} " \
                   f"dh={dh}"
            q = torch.randn(b, lq, hq, dh, generator=gen).to(dev, dtype)
            k = torch.randn(b, lk, hkv, dh, generator=gen).to(dev, dtype)
            v = torch.randn(b, lk, hkv, dh, generator=gen).to(dev, dtype)
            got = flash_attention.flash_attention(q, k, v, causal=True)
            again = flash_attention.flash_attention(q, k, v, causal=True)
            want = ref.attention(q, k, v, causal=True)
            err = (got.float() - want.float()).abs()
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= tol + tol * want.float().abs()).all())
            same = torch.equal(got, again)
            log(f"{name}: max_err {float(err.max()):.3e} "
                f"{'ok' if ok else 'FAIL'}, repeated "
                f"{'bitwise equal' if same else 'FAIL'}")
            if not (ok and same):
                FAILURES.append(name)
    q = torch.randn(2, 33, 4, 32, generator=gen).to(dev, torch.bfloat16)
    k = torch.randn(2, 50, 2, 32, generator=gen).to(dev, torch.bfloat16)
    v = torch.randn(2, 50, 2, 32, generator=gen).to(dev, torch.bfloat16)
    err = float((flash_attention.flash_attention(q, k, v, causal=False)
                 .float() - ref.attention(q, k, v, causal=False).float())
                .abs().max())
    log(f"K7 bf16 non-causal: max_err {err:.3e} "
        f"{'ok' if err <= 3e-2 else 'FAIL'}")
    if err > 3e-2:
        FAILURES.append("K7 non-causal")


def check_k5(dev, gen):
    from repro_torch.kernels import conv1d, ref
    n = 0
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        for d in (17, 40, 200, 1536):
            for L in (1, 2, 3, 5, 300):
                for prev in (True, False):
                    for strided in (False, True):
                        xz = torch.randn(3, L, 2 * d, generator=gen).to(
                            dev, dtype)
                        x = xz[..., :d] if strided else xz[..., :d].clone()
                        w = torch.randn(4, d, generator=gen).to(dev)
                        bias = torch.randn(d, generator=gen).to(dev)
                        xp = (torch.randn(3, 3, d, generator=gen).to(
                            dev, dtype) if prev else None)
                        y1, s1 = conv1d.causal_conv1d(x, w, bias, xp)
                        y0, s0 = ref.causal_conv1d(x, w, bias, xp)
                        err = (y1.float() - y0.float()).abs()
                        n += 1
                        if not (bool((err <= tol + tol * y0.float().abs())
                                     .all()) and torch.equal(s1, s0)):
                            name = (f"K5 {dtype} d={d} L={L} prev={prev} "
                                    f"strided={strided}")
                            log(f"{name}: FAIL")
                            FAILURES.append(name)
    log(f"K5: {n} cases checked, tails bitwise")


def timing(dev):
    from _torch_inputs import graph_kernels
    from repro_torch.kernels import conv1d, flash_attention
    bf = torch.bfloat16
    for L in (512, 127, 64):
        q = torch.randn(1, L, 32, 128, device=dev, dtype=bf)
        k = torch.randn(1, L, 8, 128, device=dev, dtype=bf)
        v = torch.randn(1, L, 8, 128, device=dev, dtype=bf)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        f = (lambda q=q, k=k, v=v:
             flash_attention.flash_attention(q, k, v, causal=True))
        s = (lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        log(f"K7 L={L}: {graph_us(f):.2f} us device (eager "
            f"{event_us(f):.2f}, {graph_kernels(f)} kernels a call); "
            f"SDPA {graph_us(s):.2f} us")
    w = torch.randn(4, 1536, device=dev)
    bias = torch.randn(1536, device=dev)
    for b, L in ((4, 1), (1, 512)):
        x = torch.randn(b, L, 3072, device=dev, dtype=bf)[..., :1536]
        xp = torch.randn(b, 3, 1536, device=dev, dtype=bf)
        xpc = torch.cat([xp, x], 1).transpose(1, 2).contiguous()
        wl, bl = w.t().contiguous().unsqueeze(1).to(bf), bias.to(bf)
        f = (lambda x=x, xp=xp: conv1d.causal_conv1d(x, w, bias, xp))
        c = (lambda xpc=xpc: F.conv1d(xpc, wl, bl, groups=1536))
        log(f"K5 b={b} L={L}: {graph_us(f, 50):.2f} us device (eager "
            f"{event_us(f):.2f}, {graph_kernels(f)} kernels a call); "
            f"F.conv1d {graph_us(c, 50):.2f} us")


def host_pieces(dev):
    """The host's cost of one eager K5 call at decode, by piece."""
    from repro_torch.kernels import _lib, conv1d
    bf = torch.bfloat16
    x = torch.randn(4, 1, 3072, device=dev, dtype=bf)[..., :1536]
    w = torch.randn(4, 1536, device=dev)
    bias = torch.randn(1536, device=dev)
    xp = torch.randn(4, 3, 1536, device=dev, dtype=bf)
    y = torch.empty(4, 1, 1536, device=dev, dtype=bf)
    tail = torch.empty(4, 3, 1536, device=dev, dtype=bf)
    args = (x.data_ptr(), w.data_ptr(), bias.data_ptr(), xp.data_ptr(),
            y.data_ptr(), tail.data_ptr(), 4, 1, 1536, 4, x.stride(0),
            x.stride(1), 1)
    fn = _lib.lib().marca_causal_conv1d
    stream = torch.cuda.current_stream(dev).cuda_stream

    def checks():
        _lib.check_dtype(x)
        _lib.check_same_device(x.device, w=w, b=bias, x_prev=xp)
        _lib.check_rows("x", x, x.dtype, (4, 1, 1536))
        _lib.check_dense("w", w, torch.float32, (4, 1536))
        _lib.check_dense("b", bias, torch.float32, (1536,))
        _lib.check_dense("x_prev", xp, x.dtype, (4, 3, 1536))

    pieces = {
        "whole wrapper": lambda: conv1d.causal_conv1d(x, w, bias, xp),
        "argument checks": checks,
        "two torch.empty": lambda: (torch.empty_like(y),
                                    torch.empty_like(tail)),
        "_lib.call": lambda: _lib.call("marca_causal_conv1d", dev, *args),
        "ctypes launch alone": lambda: fn(*args, stream),
    }
    for label, f in pieces.items():
        f()
        torch.cuda.synchronize()
        us = timeit.timeit(f, number=2000) / 2000 * 1e6
        torch.cuda.synchronize()
        log(f"host {label}: {us:.2f} us")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k5_k7: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    build()
    gen = torch.Generator().manual_seed(0)
    check_k7(dev, gen)
    check_k5(dev, gen)
    timing(dev)
    host_pieces(dev)
    log(f"failures: {FAILURES}")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
