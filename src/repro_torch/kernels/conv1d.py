"""Causal depthwise conv1d: wrapper over the CUDA kernel ``csrc/conv1d.cu``.

Port of ``repro/kernels/conv1d.py`` (Pallas ``_conv_kernel``,
pallas_call at :73).  Same semantics and layout as
``kernels.ref.causal_conv1d``: x (b, L, d); w (k, d) f32; bias (d,) f32;
x_prev and the returned tail (b, k-1, d) in x's dtype.  On a CUDA
tensor the kernel runs, one launch that writes y and the tail; on a CPU
tensor the plain version does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

#: kernel launches made by this wrapper
launches = 0

#: the most taps the kernel holds in registers
MAX_TAPS = 4


def causal_conv1d(x, w, b=None, x_prev=None):
    """Returns (y (b, L, d) in x.dtype, new_state (b, k-1, d)), the tail
    a fresh tensor (never x_prev).

    x may be a strided view (unit stride on the last axis only); w, b
    and x_prev must be contiguous."""
    global launches
    _lib.check_no_grad("causal_conv1d", x, w, b, x_prev)
    _lib.check_dtype(x)
    bsz, L, d = x.shape
    k = w.shape[0]
    _lib.check_same_device(x.device, w=w, b=b, x_prev=x_prev)
    _lib.check_rows("x", x, x.dtype, (bsz, L, d))
    _lib.check_dense("w", w, torch.float32, (k, d))
    _lib.check_dense("b", b, torch.float32, (d,))
    _lib.check_dense("x_prev", x_prev, x.dtype, (bsz, k - 1, d))
    _lib.require(L >= 1 and k >= 1, "empty sequence or filter")
    if x.device.type == "cpu":
        return ref.causal_conv1d(x, w, b=b, x_prev=x_prev)
    _lib.require(k <= MAX_TAPS, f"K5 takes at most {MAX_TAPS} taps, got {k}")
    y = torch.empty(bsz, L, d, dtype=x.dtype, device=x.device)
    tail = torch.empty(bsz, k - 1, d, dtype=x.dtype, device=x.device)
    _lib.call("marca_causal_conv1d", x.device,
              _lib.ptr(x), _lib.ptr(w), _lib.ptr(b), _lib.ptr(x_prev),
              _lib.ptr(y), _lib.ptr(tail), bsz, L, d, k, x.stride(0),
              x.stride(1), _lib.DTYPES[x.dtype])
    launches += 1
    return y, tail


def conv_backward(x, w, x_prev, dy, dtail, has_bias: bool):
    """Gradients (x, w, b, x_prev) of ``causal_conv1d``: the transpose of
    the depthwise causal conv as k shifted multiply-adds over the padded
    input xp = [x_prev | x] (y_t = sum_i xp_{t+i} w_i + b; the tail is
    xp's last k-1 rows), in f32, each returned in its input's dtype."""
    bsz, L, d = x.shape
    k = w.shape[0]
    f32 = torch.float32
    head = (torch.zeros(bsz, k - 1, d, dtype=f32, device=x.device)
            if x_prev is None else x_prev.float())
    xp = torch.cat([head, x.float()], dim=1)              # (b, L+k-1, d)
    dyf = dy.float()
    dxp = torch.zeros_like(xp)
    dxp[:, L:] = dtail.float()
    dw = torch.empty(k, d, dtype=f32, device=x.device)
    for i in range(k):
        dxp[:, i:i + L].addcmul_(dyf, w[i].float())
        dw[i] = torch.einsum("bld,bld->d", dyf, xp[:, i:i + L])
    db = dyf.sum((0, 1)) if has_bias else None
    dprev = None if x_prev is None else dxp[:, :k - 1].to(x_prev.dtype)
    return dxp[:, k - 1:].to(x.dtype), dw.to(w.dtype), db, dprev


class _TrainableConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, x_prev):
        y, tail = causal_conv1d(x, w, b=b, x_prev=x_prev)
        ctx.save_for_backward(x, w, x_prev)
        ctx.has_bias = b is not None
        return y, tail

    @staticmethod
    def backward(ctx, dy, dtail):
        x, w, x_prev = ctx.saved_tensors
        return conv_backward(x, w, x_prev, dy, dtail, ctx.has_bias)


def causal_conv1d_trainable(x, w, b=None, x_prev=None):
    """``causal_conv1d`` with a backward: the forward is one wrapper call
    (K5 on the card), the backward ``conv_backward``."""
    return _TrainableConv.apply(x, w, b, x_prev)
