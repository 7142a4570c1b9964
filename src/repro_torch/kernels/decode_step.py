"""Fused S6 decode step: wrapper over the CUDA kernel ``csrc/decode_step.cu``.

Port of ``repro/kernels/decode_step.py`` ``selective_state_step``
(Pallas ``_step_kernel``, pallas_call at :316), f32 weights only: the
int8-A variant and the quantized-state kernel are ROADMAP K2, the
cross-layer megakernel K3.  Same semantics and layout as
``kernels.ref.selective_state_step``: h (slots, d, n) f32; x, dt, z
(slots, d); A (d, n) f32; B, C (slots, n); D (d,) f32.  On a CUDA tensor
the kernel runs (d_state 16); on a CPU tensor the plain version does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

#: kernel launches made by this wrapper
launches = 0


def selective_state_step(h, x_t, dt_t, A, B_t, C_t, D=None, z_t=None,
                         exp_impl: str = "exact", silu_impl: str = "exact"):
    """Returns (y (slots, d) in x_t.dtype, h_new (slots, d, n) f32).

    h_new is a new tensor: masking inactive slots stays with the caller.
    x_t, dt_t, z_t, B_t and C_t may be strided views (unit stride on the
    last axis only); h, A and D must be contiguous f32."""
    global launches
    _lib.check_dtype(x_t)
    slots, d = x_t.shape
    n = A.shape[-1]
    _lib.check_same_device(x_t.device, h=h, dt_t=dt_t, A=A, B_t=B_t,
                           C_t=C_t, D=D, z_t=z_t)
    for name, t in (("x_t", x_t), ("dt_t", dt_t), ("z_t", z_t)):
        _lib.check_rows(name, t, x_t.dtype, (slots, d))
    for name, t in (("B_t", B_t), ("C_t", C_t)):
        _lib.check_rows(name, t, x_t.dtype, (slots, n))
    _lib.check_dense("h", h, torch.float32, (slots, d, n))
    _lib.check_dense("A", A, torch.float32, (d, n))
    _lib.check_dense("D", D, torch.float32, (d,))
    _lib.check_impls(exp_impl, silu_impl)
    if x_t.device.type == "cpu":
        return ref.selective_state_step(h, x_t, dt_t, A, B_t, C_t, D=D,
                                        z_t=z_t, exp_impl=exp_impl,
                                        silu_impl=silu_impl)
    _lib.require(n == 16, f"the CUDA decode step takes d_state 16, got {n}")
    y = torch.empty(slots, d, dtype=x_t.dtype, device=x_t.device)
    h_new = torch.empty_like(h)
    sz = z_t.stride(0) if z_t is not None else 0
    _lib.call("marca_decode_step", x_t.device,
              _lib.ptr(h), _lib.ptr(x_t), _lib.ptr(dt_t), _lib.ptr(A),
              _lib.ptr(B_t), _lib.ptr(C_t), _lib.ptr(D), _lib.ptr(z_t),
              _lib.ptr(y), _lib.ptr(h_new), slots, d, n,
              x_t.stride(0), dt_t.stride(0), B_t.stride(0), C_t.stride(0),
              sz, _lib.DTYPES[x_t.dtype], _lib.EXP_IMPLS[exp_impl],
              _lib.SILU_IMPLS[silu_impl])
    launches += 1
    return y, h_new
