"""Selective scan: wrapper over the CUDA kernel ``csrc/selective_scan.cu``.

Port of ``repro/kernels/selective_scan.py`` (Pallas ``_scan_kernel``,
pallas_call at :138).  Same semantics and public layout as
``kernels.ref.selective_scan``: x, dt, z (b, L, d); A (d, n); B, C
(b, L, n); D (d,); h0 and h_last (b, d, n) f32.  On a CUDA tensor the
kernel runs (and d_state must be 16); on a CPU tensor the plain
version does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

#: kernel launches made by this wrapper
launches = 0


def selective_scan(x, dt, A, B, C, D=None, z=None, h0=None,
                   exp_impl: str = "exact", silu_impl: str = "exact"):
    """Returns (y (b, L, d) in x.dtype, h_last (b, d, n) f32).

    x, dt, z, B and C may be strided views (unit stride on the last
    axis only); A, D and h0 must be contiguous f32."""
    global launches
    _lib.check_dtype(x)
    bsz, L, d = x.shape
    n = A.shape[-1]
    _lib.check_same_device(x.device, dt=dt, A=A, B=B, C=C, D=D, z=z, h0=h0)
    for name, t in (("x", x), ("dt", dt), ("z", z)):
        _lib.check_rows(name, t, x.dtype, (bsz, L, d))
    for name, t in (("B", B), ("C", C)):
        _lib.check_rows(name, t, x.dtype, (bsz, L, n))
    _lib.check_dense("A", A, torch.float32, (d, n))
    _lib.check_dense("D", D, torch.float32, (d,))
    _lib.check_dense("h0", h0, torch.float32, (bsz, d, n))
    _lib.check_impls(exp_impl, silu_impl)
    _lib.require(L >= 1, "empty sequence")
    if x.device.type == "cpu":
        return ref.selective_scan(x, dt, A, B, C, D=D, z=z, h0=h0,
                                  exp_impl=exp_impl, silu_impl=silu_impl)
    _lib.require(n == 16, f"the CUDA scan takes d_state 16, got {n}")
    y = torch.empty(bsz, L, d, dtype=x.dtype, device=x.device)
    h_last = torch.empty(bsz, d, n, dtype=torch.float32, device=x.device)
    zs = (z.stride(0), z.stride(1)) if z is not None else (0, 0)
    _lib.call("marca_selective_scan", x.device,
              _lib.ptr(x), _lib.ptr(dt), _lib.ptr(A), _lib.ptr(B),
              _lib.ptr(C), _lib.ptr(D), _lib.ptr(z), _lib.ptr(h0),
              _lib.ptr(y), _lib.ptr(h_last), bsz, L, d, n,
              x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
              B.stride(0), B.stride(1), C.stride(0), C.stride(1), *zs,
              _lib.DTYPES[x.dtype], _lib.EXP_IMPLS[exp_impl],
              _lib.SILU_IMPLS[silu_impl])
    launches += 1
    return y, h_last
