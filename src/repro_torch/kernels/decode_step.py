"""Fused S6 decode step: wrappers over the CUDA kernels
``csrc/decode_step.cu`` and ``csrc/decode_step_q.cu``.

Port of ``repro/kernels/decode_step.py``: ``selective_state_step``
(Pallas ``_step_kernel``, pallas_call at :316) with f32 A or int8 A
codes plus ``a_scale``, and ``selective_state_step_q`` (Pallas
``_step_kernel_q``, pallas_call at :396) on an int8/fp8 state payload;
``launch_shape`` and ``q_launch_shape`` report the launch each makes on
the card.  The cross-layer megakernel is ROADMAP K3.  Same semantics
and layout as the plain versions in ``kernels.ref``: h (slots, d, n);
x, dt, z (slots, d); A (d, n); B, C (slots, n); D (d,) f32.  On a CUDA
tensor the kernel runs (d_state 16); on a CPU tensor the plain version
does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import state_quant
from repro_torch.kernels import _lib, ref

#: kernel launches made by this module's wrappers, one count per kernel
#: variant: the f32-A step, the int8-A step and the quantized-state step
#: (either A)
launches = 0
launches_int8a = 0
launches_q = 0


def _check_step(kernel, x_t, dt_t, A, B_t, C_t, D, z_t, a_scale, exp_impl,
                silu_impl, **state):
    _lib.check_no_grad(kernel, x_t, dt_t, A, B_t, C_t, D, z_t, a_scale,
                       *state.values())
    _lib.check_dtype(x_t)
    slots, d = x_t.shape
    n = A.shape[-1]
    _lib.check_same_device(x_t.device, dt_t=dt_t, A=A, a_scale=a_scale,
                           B_t=B_t, C_t=C_t, D=D, z_t=z_t, **state)
    for name, t in (("x_t", x_t), ("dt_t", dt_t), ("z_t", z_t)):
        _lib.check_rows(name, t, x_t.dtype, (slots, d))
    for name, t in (("B_t", B_t), ("C_t", C_t)):
        _lib.check_rows(name, t, x_t.dtype, (slots, n))
    _lib.check_a(A, a_scale, d, n)
    _lib.check_dense("D", D, torch.float32, (d,))
    _lib.check_impls(exp_impl, silu_impl)
    return slots, d, n


def _strides(x_t, dt_t, B_t, C_t, z_t):
    return (x_t.stride(0), dt_t.stride(0), B_t.stride(0), C_t.stride(0),
            z_t.stride(0) if z_t is not None else 0)


def selective_state_step(h, x_t, dt_t, A, B_t, C_t, D=None, z_t=None,
                         exp_impl: str = "exact", silu_impl: str = "exact",
                         a_scale=None):
    """Returns (y (slots, d) in x_t.dtype, h_new (slots, d, n) f32).

    ``a_scale`` (d,) f32 marks A as int8 codes, dequantized in the kernel
    with the one multiply ``weight_quant.dequantize_rows`` runs.  h_new
    is a new tensor: masking inactive slots stays with the caller.  x_t,
    dt_t, z_t, B_t and C_t may be strided views (unit stride on the last
    axis only); h, A, a_scale and D must be contiguous, and on the card h
    and A must start on a 16-byte boundary."""
    global launches, launches_int8a
    slots, d, n = _check_step("selective_state_step", x_t, dt_t, A, B_t,
                              C_t, D, z_t, a_scale, exp_impl, silu_impl,
                              h=h)
    _lib.check_dense("h", h, torch.float32, (slots, d, n))
    if x_t.device.type == "cpu":
        return ref.selective_state_step(h, x_t, dt_t, A, B_t, C_t, D=D,
                                        z_t=z_t, exp_impl=exp_impl,
                                        silu_impl=silu_impl,
                                        a_scale=a_scale)
    _lib.require(n == 16, f"the CUDA decode step takes d_state 16, got {n}")
    y = torch.empty(slots, d, dtype=x_t.dtype, device=x_t.device)
    h_new = torch.empty_like(h)
    # the kernel moves h, A and h' in 16-byte words
    _lib.check_aligned(16, h=h, A=A, h_new=h_new)
    _lib.call("marca_decode_step", x_t.device,
              _lib.ptr(h), _lib.ptr(x_t), _lib.ptr(dt_t), _lib.ptr(A),
              _lib.ptr(a_scale), _lib.ptr(B_t), _lib.ptr(C_t), _lib.ptr(D),
              _lib.ptr(z_t), _lib.ptr(y), _lib.ptr(h_new), slots, d, n,
              *_strides(x_t, dt_t, B_t, C_t, z_t), _lib.DTYPES[x_t.dtype],
              _lib.EXP_IMPLS[exp_impl], _lib.SILU_IMPLS[silu_impl])
    if a_scale is None:
        launches += 1
    else:
        launches_int8a += 1
    return y, h_new


def selective_state_step_q(hq, h_scale, x_t, dt_t, A, B_t, C_t, D=None,
                           z_t=None, state_dtype: str = "int8",
                           exp_impl: str = "exact",
                           silu_impl: str = "exact", a_scale=None):
    """Quantized-state step: returns (y (slots, d) in x_t.dtype, hq_new
    (slots, d, n) in the storage dtype, scale_new (slots, g) f32).

    hq is the int8 (``state_dtype="int8"``) or float8_e4m3fn ("fp8")
    payload and h_scale its (slots, g) group scales
    (``state_quant.n_groups(d)``); the kernel dequantizes on read and
    requantizes on write, so the f32 state never reaches device memory.
    Other arguments as in ``selective_state_step``."""
    global launches_q
    slots, d, n = _check_step("selective_state_step_q", x_t, dt_t, A, B_t,
                              C_t, D, z_t, a_scale, exp_impl, silu_impl,
                              hq=hq, h_scale=h_scale)
    if not state_quant.is_quantized(state_dtype):
        raise ValueError(f"state_dtype {state_dtype!r} is not quantized")
    g = state_quant.n_groups(d)
    _lib.check_dense("hq", hq, state_quant.storage_dtype(state_dtype),
                     (slots, d, n))
    _lib.check_dense("h_scale", h_scale, torch.float32, (slots, g))
    if x_t.device.type == "cpu":
        return ref.selective_state_step_q(
            hq, h_scale, x_t, dt_t, A, B_t, C_t, D=D, z_t=z_t,
            state_dtype=state_dtype, exp_impl=exp_impl,
            silu_impl=silu_impl, a_scale=a_scale)
    _lib.require(n == 16, f"the CUDA decode step takes d_state 16, got {n}")
    y = torch.empty(slots, d, dtype=x_t.dtype, device=x_t.device)
    hq_new = torch.empty_like(hq)
    scale_new = torch.empty_like(h_scale)
    _lib.call("marca_decode_step_q", x_t.device,
              _lib.ptr(hq), _lib.ptr(h_scale), _lib.ptr(x_t),
              _lib.ptr(dt_t), _lib.ptr(A), _lib.ptr(a_scale), _lib.ptr(B_t),
              _lib.ptr(C_t), _lib.ptr(D), _lib.ptr(z_t), _lib.ptr(y),
              _lib.ptr(hq_new), _lib.ptr(scale_new), slots, d, n, g,
              *_strides(x_t, dt_t, B_t, C_t, z_t), _lib.DTYPES[x_t.dtype],
              _lib.STATE_DTYPES[hq.dtype], _lib.EXP_IMPLS[exp_impl],
              _lib.SILU_IMPLS[silu_impl])
    launches_q += 1
    return y, hq_new, scale_new


def launch_shape(slots: int, d: int) -> dict:
    """The launch ``selective_state_step`` makes on the card for (slots,
    d): its grid and the threads of a block (4 lanes a channel)."""
    out = (ctypes.c_int * 3)()
    rc = _lib.lib().marca_decode_step_shape(
        slots, d, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"marca_decode_step_shape: CUDA error {rc}")
    return {"grid": (out[0], out[1]), "threads": out[2]}


def q_launch_shape(slots: int, d: int) -> dict:
    """The launch ``selective_state_step_q`` makes on the card for
    (slots, d): its grid, the blocks of a thread-block cluster (one
    cluster per (slot, 512-channel group)) and the threads of a block."""
    out = (ctypes.c_int * 4)()
    rc = _lib.lib().marca_decode_step_q_shape(
        slots, d, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"marca_decode_step_q_shape: CUDA error {rc}")
    return {"grid": (out[0], out[1]), "cluster": out[2], "threads": out[3]}
