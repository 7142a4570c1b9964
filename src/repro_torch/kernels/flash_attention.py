"""Causal GQA flash attention (K7): wrapper over the CUDA kernel
``csrc/flash_attention.cu``.

Port of ``repro/kernels/flash_attention.py`` (Pallas ``_flash_kernel``,
pallas_call at :80), in ``repro``'s public layout: q (b, lq, hq, dh),
k/v (b, lk, hkv, dh), the output like q.  The queries may be the suffix
of the sequence (lq < lk): query i attends to keys j <= i + lk - lq.
On a CUDA tensor the kernel runs (bf16 on the tensor cores, f32 on the
SIMT pipes); on a CPU tensor the plain version ``kernels.ref.attention``
does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

#: kernel launches made by this wrapper
launches = 0

#: the widest head the kernel stages
MAX_HEAD_DIM = 128


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Returns (b, lq, hq, dh) in q's dtype.  q, k and v contiguous, of
    one dtype (float32 or bfloat16); hq a multiple of hkv; dh a multiple
    of 4 up to 128 in float32, of 16 up to 128 in bfloat16 (and q, k, v
    on 16-byte boundaries, as the tensor cores' copies need); with
    ``causal``, lq <= lk."""
    global launches
    _lib.check_no_grad("flash_attention", q, k, v)
    _lib.check_dtype(q)
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    _lib.check_same_device(q.device, k=k, v=v)
    _lib.check_dense("q", q, q.dtype, (b, lq, hq, dh))
    _lib.check_dense("k", k, q.dtype, (b, lk, hkv, dh))
    _lib.check_dense("v", v, q.dtype, (b, lk, hkv, dh))
    _lib.require(hkv >= 1 and hq % hkv == 0,
                 f"{hq} query heads for {hkv} kv heads")
    _lib.require(not causal or lq <= lk,
                 f"causal attention of {lq} queries over {lk} keys")
    if scale is None:
        scale = dh ** -0.5
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale)
    step = 16 if q.dtype == torch.bfloat16 else 4
    _lib.require(dh % step == 0 and step <= dh <= MAX_HEAD_DIM,
                 f"K7 in {q.dtype} takes a head dim that is a multiple of "
                 f"{step} up to {MAX_HEAD_DIM}, got {dh}")
    _lib.require(q.dtype != torch.bfloat16 or all(
        t.data_ptr() % 16 == 0 for t in (q, k, v)),
        "K7 in bfloat16 needs q, k and v on 16-byte boundaries")
    o = q.new_empty(q.shape)
    _lib.call("marca_flash_attention", q.device, _lib.ptr(q), _lib.ptr(k),
              _lib.ptr(v), _lib.ptr(o), b, lq, lk, hq, hkv, dh,
              float(scale), int(causal), _lib.DTYPES[q.dtype])
    launches += 1
    return o


def attention_backward(q, k, v, o, do, causal: bool, scale):
    """Gradients (q, k, v) of attention, the standard backward in f32
    from q, k, v, the forward's output o and its gradient do: the scores
    and softmax recomputed with the causal mask (queries the suffix of the
    keys, as the forward), dS = P * (dP - rowsum(dO * O)); the k and v
    gradients of a GQA group summed over its query heads.  K7 returns no
    log-sum-exp, so the probabilities are materialized: (b, hq, lq, lk)
    f32, a few of them at once.  Returned in the inputs' dtypes."""
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)     # (b, hq, lq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, lk, hkv, rep, dh).sum(3)
    dv = dv.reshape(b, lk, hkv, rep, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _TrainableAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*attention_backward(q, k, v, o, do, ctx.causal, ctx.scale),
                None, None)


def flash_attention_trainable(q, k, v, causal: bool = True, scale=None):
    """``flash_attention`` with a backward: the forward is one wrapper
    call (K7 on the card), the backward ``attention_backward``."""
    return _TrainableAttention.apply(q, k, v, causal, scale)
