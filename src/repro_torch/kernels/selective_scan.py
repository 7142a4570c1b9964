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
    _lib.check_no_grad("selective_scan", x, dt, A, B, C, D, z, h0)
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


# ---------------------------------------------------------------------------
# The trainable scan (``repro/kernels/selective_scan.py:214-331``): the
# kernel's forward under a ``torch.autograd.Function`` whose backward
# recomputes the chunk-boundary states with one more forward (a launch a
# chunk) and runs the reverse recurrence a chunk at a time in PyTorch:
#
#   ghat_t = C_t (x) ybar_t + dA_{t+1} * ghat_{t+1}
#   dt    += sum_n ghat*(h_{t-1}*dA*A) + x * sum_n ghat*B
#   A     += sum_{b,t} ghat*h_{t-1}*dA*dt
#   x      = dt * sum_n ghat*B;  B = sum_d ghat*dt*x;  C = sum_d h*ybar
#
# Only the inputs are saved; h_t exists a chunk at a time.  The D skip
# and the z gate stay outside (``kernels.ops``), in tensor ops autograd
# differentiates, as in ``repro``.
# ---------------------------------------------------------------------------

def _time_major(t, s, e):
    """t[:, s:e] as a contiguous f32 (T, b, ...) tensor."""
    return t[:, s:e].transpose(0, 1).contiguous().float()


def scan_backward(x, dt, A, B, C, ybar, hbar, chunk: int):
    """Gradients (x, dt, A, B, C) of the recurrence core from h0 = 0,
    given ybar (b, L, d) and hbar (b, d, n), each in its input's dtype.
    Port of ``_sst_bwd``: the state entering each chunk is recomputed by
    the forward wrapper (K4 on the card, the plain scan on the CPU), then
    each chunk, last first, rematerializes its h_t from that state and
    runs the reverse recurrence, both one tensor op a time step; the rest
    is whole-chunk tensor ops, with exact ``torch.exp``."""
    bsz, L, d = x.shape
    n = A.shape[1]
    Af = A.float()
    starts = list(range(0, L, chunk))
    h_in, h = [], None
    for s in starts:
        h_in.append(h)
        e = min(s + chunk, L)
        _, h = selective_scan(x[:, s:e], dt[:, s:e], A, B[:, s:e],
                              C[:, s:e], h0=h)
    f32, dev = torch.float32, x.device
    dx = torch.empty(bsz, L, d, dtype=f32, device=dev)
    ddt = torch.empty_like(dx)
    dB = torch.empty(bsz, L, n, dtype=f32, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.zeros(d, n, dtype=f32, device=dev)
    g = hbar.float()                      # dL/dh after the chunk's last step
    for s, h0 in zip(reversed(starts), reversed(h_in)):
        e = min(s + chunk, L)
        T = e - s
        xt, dtt, Bt, Ct, yt = (_time_major(t, s, e)
                               for t in (x, dt, B, C, ybar))
        if h0 is None:
            h0 = torch.zeros(bsz, d, n, dtype=f32, device=dev)
        dAt = torch.exp(dtt[..., None] * Af)              # (T, b, d, n)
        dtx = dtt * xt
        dBx = dtx[..., None] * Bt[:, :, None, :]
        H = torch.empty_like(dAt)                         # h_t, t in chunk
        h = h0
        for t in range(T):
            h = torch.addcmul(dBx[t], dAt[t], h, out=H[t])
        G = torch.empty_like(dAt)                         # ghat_t
        CY = Ct[:, :, None, :] * yt[..., None]
        torch.add(CY[T - 1], g, out=G[T - 1])
        for t in range(T - 2, -1, -1):
            torch.addcmul(CY[t], G[t + 1], dAt[t + 1], out=G[t])
        g = G[0] * dAt[0]
        gdA = G * torch.cat([h0[None], H[:-1]]) * dAt     # ghat*h_{t-1}*dA
        gB = torch.einsum("tbdn,tbn->tbd", G, Bt)
        dx[:, s:e] = (gB * dtt).transpose(0, 1)
        ddt[:, s:e] = (torch.einsum("tbdn,dn->tbd", gdA, Af)
                       + gB * xt).transpose(0, 1)
        dA += torch.einsum("tbdn,tbd->dn", gdA, dtt)
        dB[:, s:e] = torch.einsum("tbdn,tbd->tbn", G, dtx).transpose(0, 1)
        dC[:, s:e] = torch.einsum("tbdn,tbd->tbn", H, yt).transpose(0, 1)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype))


class _TrainableScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, h_last = selective_scan(x, dt, A, B, C)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y.float(), h_last

    @staticmethod
    def backward(ctx, ybar, hbar):
        return (*scan_backward(*ctx.saved_tensors, ybar, hbar, ctx.chunk),
                None)


def selective_scan_trainable(x, dt, A, B, C, chunk: int = 64):
    """The recurrence core from h0 = 0 with a backward: x, dt (b, L, d);
    A (d, n) f32; B, C (b, L, n) -> (y (b, L, d) f32, h_last (b, d, n)
    f32).  The forward is one wrapper call with exact exp (K4 on the
    card); ``chunk`` is the backward's recompute interval
    (``cfg.scan_chunk``)."""
    _lib.require(chunk >= 1, f"scan chunk {chunk}")
    return _TrainableScan.apply(x, dt, A, B, C, chunk)
