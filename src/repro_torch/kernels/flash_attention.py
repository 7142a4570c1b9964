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
