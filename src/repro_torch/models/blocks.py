"""Model building blocks (port of ``repro/models/blocks.py``): dense
projection, norms (with the xLSTM group norm), rotary embedding, GQA attention with its decode
cache, gated MLPs, embedding and unembedding.

Parameters are plain tensors in nested dicts laid out as ``repro``'s
(dense weights are ``(d_in, d_out)``, int8 weights carry a ``w_scale``
sibling), so ``bridge.py`` maps one tree onto the other leaf for leaf.
Compute dtype follows cfg.dtype; norms and logits are f32.  The GEMMs
are ``torch.matmul``, as ``repro`` leaves them to XLA.

Initializers draw from a ``torch.Generator`` on its own device: a CPU
generator gives the same weights on every device, a CUDA one draws a
large tree where it is served (other numbers from the same seed).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import approx
from repro_torch.kernels import ops


def dense_init(gen, d_in, d_out, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": torch.randn(d_in, d_out, generator=gen, device=gen.device)
            * scale}


def dense(p, x, compute_dtype=None):
    """x @ w (+ b).  An int8 ``w`` is dequantized with its per-output-
    channel ``w_scale`` (``w.float() * w_scale``, as
    ``repro/models/blocks.py:45`` does) before the cast to the compute
    dtype."""
    w = p["w"]
    if "w_scale" in p:
        w = w.float() * p["w_scale"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def norm_init(cfg):
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(d)}
    if cfg.norm == "ln":
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}
    if cfg.norm == "ln_nonparam":
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg, p, x, eps=1e-5):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        xf = xf * p["scale"]
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "ln":
            xf = xf * p["scale"] + p["bias"]
    return xf.to(x.dtype)


def group_norm(x, scale, n_groups, eps=1e-5):
    """x (..., d) normalized per group of d / n_groups channels (the xLSTM
    head norm, ``repro`` blocks.py:87): mean and biased variance in f32,
    then the scale, cast back to x's dtype."""
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], n_groups, -1)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(shp)
    return (xf * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta):
    """x (b, l, h, dh); positions (b, l) int (``repro`` blocks.py:101)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                # (b, l, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + rotary + optional bias), cache-aware
# ---------------------------------------------------------------------------

def attention_init(cfg, gen):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(d_in, d_out, bias):
        p = dense_init(gen, d_in, d_out)
        if bias:
            p["b"] = torch.zeros(d_out, device=gen.device)
        return p

    return {"wq": proj(d, hq * dh, cfg.qkv_bias),
            "wk": proj(d, hkv * dh, cfg.qkv_bias),
            "wv": proj(d, hkv * dh, cfg.qkv_bias),
            "wo": proj(hq * dh, d, False)}


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention over a cache (``repro`` blocks.py:181, left
    to XLA there, plain PyTorch here).  q (b, 1, hq, dh); k/v_cache
    (b, S, hkv, dh); pos (b,) the index of the query token.  Scores and
    the weighted sum in f32 (exact products of the stored values), the
    probabilities rounded to the cache's dtype first, as ``repro``."""
    b, _, hq, dh = q.shape
    S, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float()) * dh ** -0.5
    mask = (torch.arange(S, device=q.device)[None, :]
            <= pos[:, None])                                   # (b, S)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def _kv_quant(t):
    """(b, l, hkv*dh) -> int8 payload + per-(b, l) f32 absmax scale
    (``repro`` blocks.py:199).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(-1, keepdim=True), min=1e-6) / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def _kv_dequant(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def attention_apply(cfg, p, x, positions, cache=None, pos=None,
                    return_kv=False):
    """``repro`` blocks.py:212.  cache: {k, v (b, S, hkv*dh)} (+ k_scale,
    v_scale (b, S, 1) with cfg.kv_cache_dtype "int8"); pos (b,).  With a
    cache the new k/v are written at ``pos`` (new tensors, as ``repro``'s
    functional update) and the token attends over the cache; without
    one the sequence attends causally through ``ops.attention`` (K7 on
    the card).  ``return_kv`` also returns the rotated flat k/v of the
    sequence (the prefill cache fill)."""
    b, l, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = x.dtype
    q = dense(p["wq"], x, cdt).reshape(b, l, hq, dh)
    k = dense(p["wk"], x, cdt).reshape(b, l, hkv, dh)
    v = dense(p["wv"], x, cdt).reshape(b, l, hkv, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is not None:
        S = cache["k"].shape[1]
        onehot = (torch.arange(S, device=x.device)[None, :]
                  == pos[:, None])[..., None]                  # (b, S, 1)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = _kv_quant(k.reshape(b, l, hkv * dh))
            vq, vs = _kv_quant(v.reshape(b, l, hkv * dh))
            new_cache = {"k": torch.where(onehot, kq, cache["k"]),
                         "v": torch.where(onehot, vq, cache["v"]),
                         "k_scale": torch.where(onehot, ks,
                                                cache["k_scale"]),
                         "v_scale": torch.where(onehot, vs,
                                                cache["v_scale"])}
            kc = _kv_dequant(new_cache["k"], new_cache["k_scale"], cdt)
            vc = _kv_dequant(new_cache["v"], new_cache["v_scale"], cdt)
        else:
            kd = cache["k"].dtype
            new_cache = {
                "k": torch.where(onehot, k.reshape(b, l, hkv * dh).to(kd),
                                 cache["k"]),
                "v": torch.where(onehot, v.reshape(b, l, hkv * dh).to(kd),
                                 cache["v"])}
            kc, vc = new_cache["k"], new_cache["v"]
        o = decode_attention(q, kc.reshape(b, S, hkv, dh),
                             vc.reshape(b, S, hkv, dh), pos)
    else:
        o = ops.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        if return_kv:
            new_cache = {"k": k.reshape(b, l, hkv * dh),
                         "v": v.reshape(b, l, hkv * dh)}
    return dense(p["wo"], o.reshape(b, l, hq * dh), cdt), new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(cfg, gen, d_ff=None, d_in=None):
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"w1": dense_init(gen, d, f), "w3": dense_init(gen, d, f),
                "w2": dense_init(gen, f, d)}
    return {"w1": dense_init(gen, d, f), "w2": dense_init(gen, f, d)}


def mlp_apply(cfg, p, x):
    """``repro`` blocks.py:284: swiglu ``w2(silu(w1 x) * w3 x)`` with the
    MARCA SiLU of cfg.silu_impl, or ``w2(gelu(w1 x))``."""
    cdt = x.dtype
    if cfg.mlp == "swiglu":
        h = approx.get_silu(cfg.silu_impl)(dense(p["w1"], x, cdt))
        h = h * dense(p["w3"], x, cdt)
    else:
        h = F.gelu(dense(p["w1"], x, cdt), approximate="tanh")
    return dense(p["w2"], h, cdt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(cfg, gen):
    return {"tok": torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                               device=gen.device) * 0.02}


def embed_apply(cfg, p, tokens, dtype):
    # index then cast: the same values as repro's cast-then-index
    return p["tok"][tokens].to(dtype)


def unembed_init(cfg, gen):
    if cfg.tie_embeddings:
        return {}
    return {"w": torch.randn(cfg.d_model, cfg.vocab, generator=gen,
                             device=gen.device) * cfg.d_model ** -0.5}


def unembed_apply(cfg, p, embed_p, x):
    w = embed_p["tok"].T if cfg.tie_embeddings else p["w"]
    ldt = getattr(torch, cfg.logits_dtype)
    return torch.matmul(x.to(ldt), w.to(ldt))
