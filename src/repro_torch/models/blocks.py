"""Model building blocks (port of ``repro/models/blocks.py``): dense
projection, norms (with the xLSTM group norm), rotary embedding, GQA
attention with its decode cache (and the chunked causal form of
``attn_impl="chunked"``), gated MLPs, embedding and unembedding.

Parameters are plain tensors in nested dicts laid out as ``repro``'s
(dense weights are ``(d_in, d_out)``, int8 weights carry a ``w_scale``
sibling), so ``bridge.py`` maps one tree onto the other leaf for leaf.
Compute dtype follows cfg.dtype; norms and logits are f32.  The GEMMs
are ``torch.matmul``, as ``repro`` leaves them to XLA.

Initializers draw from a ``torch.Generator`` on its own device: a CPU
generator gives the same weights on every device, a CUDA one draws a
large tree where it is served (other numbers from the same seed).

Under a tensor-parallel mesh (``parallel/sharding.py``) each rank holds
its shard of the weights: column-parallel projections (q/k/v, the MLP's
up projections) give the rank's slice of their outputs, row-parallel
ones (``o_proj``, the MLP's down projection) sum their partial products
over the ranks (``dense_row``); the embedding is vocab-parallel (a
masked lookup of the rank's rows, summed), the unembedding gives the
rank's vocab columns, gathered into full logits; attention runs on the
rank's query and KV heads, and its KV cache holds those heads.  With no
mesh every one of these is the single-device computation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import approx
from repro_torch.kernels import ops
from repro_torch.parallel import sharding


def dense_init(gen, d_in, d_out, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": torch.randn(d_in, d_out, generator=gen, device=gen.device)
            * scale}


def dense_axes(d_in_name, d_out_name, bias=False, parts=1):
    """Logical axes of a ``dense_init`` tree (``repro``'s ``dense_init``
    axes; ``registry.param_axes`` adds the int8 scale leaves).  A fused
    projection whose output is ``parts`` equal pieces marks its leaves
    ``sharding.Fused``, so a mesh cuts each piece."""
    p = {"w": sharding.fused((d_in_name, d_out_name), parts)}
    if bias:
        p["b"] = sharding.fused((d_out_name,), parts)
    return p


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


def dense_row(p, x, compute_dtype, full_in: int, logical: str):
    """``dense`` of a row-parallel projection whose input dim (``full_in``
    wide, named ``logical``) may be split over the mesh: the partial
    products summed over the ranks, then the bias once."""
    y = dense({k: v for k, v in p.items() if k != "b"}, x, compute_dtype)
    y = sharding.sum_partials(y, full_in, logical)
    return y + p["b"].to(y.dtype) if "b" in p else y


def norm_init(cfg):
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(d)}
    if cfg.norm == "ln":
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}
    if cfg.norm == "ln_nonparam":
        return {}
    raise ValueError(cfg.norm)


def norm_axes(cfg):
    return {k: ("embed",) for k in norm_init(cfg)}


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


def group_norm(x, scale, n_groups, eps=1e-5, cols=None):
    """x (..., d) normalized per group of d / n_groups channels (the xLSTM
    head norm, ``repro`` blocks.py:87): mean and biased variance in f32,
    then the scale, cast back to x's dtype.  ``cols`` = (start, size)
    keeps those channels of the normed x before the scale (a rank's
    shard, ``scale`` its slice)."""
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], n_groups, -1)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(shp)
    if cols is not None:
        xf = xf.narrow(-1, *cols)
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


def attention_axes(cfg):
    return {"wq": dense_axes("embed", "heads", cfg.qkv_bias),
            "wk": dense_axes("embed", "kv", cfg.qkv_bias),
            "wv": dense_axes("embed", "kv", cfg.qkv_bias),
            "wo": dense_axes("heads", "embed")}


def _grouped_scores(q, k, scale):
    """q (b, lq, hkv, rep, dh), k (b, lk, hkv, dh) -> scores (b, hkv, rep,
    lq, lk) in f32 (``repro`` blocks.py:133): the products of the stored
    values summed in f32, grouped heads with no KV repetition."""
    return torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float()) * scale


def chunked_causal_attention(q, k, v, chunk=512, q_offset=0):
    """Memory-bounded causal attention (``repro`` blocks.py:143, its
    ``attn_impl="chunked"``): the queries in chunks of ``chunk``, scores
    kept at (chunk x lk), grouped heads.  Query i (of the chunk starting
    at row r) attends to keys j <= q_offset + r + i.  q (b, lq, hq, dh),
    k/v (b, lk, hkv, dh); returns (b, lq, hq, dh) in q's dtype.  Plain
    PyTorch: the prefill path runs ``ops.attention`` (K7 on the card)
    under every ``attn_impl`` name."""
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = dh ** -0.5
    chunk = min(chunk, lq)
    cols = torch.arange(lk, device=q.device)
    outs = []
    for start in range(0, lq, chunk):
        qc = q[:, start:start + chunk]
        n = qc.shape[1]
        s = _grouped_scores(qc.reshape(b, n, hkv, rep, dh), k, scale)
        rows = q_offset + start + torch.arange(n, device=q.device)
        s = s.masked_fill(~(rows[:, None] >= cols[None, :]), float("-inf"))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p.float(), v.float())
        outs.append(o.to(q.dtype).reshape(b, n, hq, dh))
    return torch.cat(outs, dim=1)


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


def _kv_quant(t, full=None):
    """(b, l, hkv*dh) -> int8 payload + per-(b, l) f32 absmax scale
    (``repro`` blocks.py:199).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  ``full``: the KV width when ``t`` holds the
    rank's heads of it, whose absmax is then taken over the ranks."""
    tf = t.float()
    amax = tf.abs().amax(-1, keepdim=True)
    if full is not None:
        amax = sharding.max_over(full, "kv")(amax)
    scale = torch.clamp(amax, min=1e-6) / 127.0
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
    hq, hkv = local_heads(cfg, p)
    dh = cfg.head_dim
    kv_full = cfg.n_kv_heads * dh
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
            kq, ks = _kv_quant(k.reshape(b, l, hkv * dh), kv_full)
            vq, vs = _kv_quant(v.reshape(b, l, hkv * dh), kv_full)
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
    return (dense_row(p["wo"], o.reshape(b, l, hq * dh), cdt,
                      cfg.n_heads * dh, "heads"), new_cache)


def local_heads(cfg, p):
    """(query heads, KV heads) of an attention layer's param shard: all of
    them off a mesh, the rank's where the mesh splits them.  A split must
    fall between heads and keep each query group with its KV head."""
    dh = cfg.head_dim
    wq, wk = p["wq"]["w"].shape[-1], p["wk"]["w"].shape[-1]
    if wq % dh or wk % dh:
        raise ValueError(
            f"the mesh splits attention inside a head (local q/kv widths "
            f"{wq}/{wk}, head_dim {dh})")
    hq, hkv = wq // dh, wk // dh
    if hq * cfg.n_kv_heads != hkv * cfg.n_heads:
        raise ValueError(
            f"the mesh splits the {cfg.n_heads} query and {cfg.n_kv_heads} "
            f"KV heads unevenly ({hq}/{hkv} a rank): a query group must "
            f"stay with its KV head")
    return hq, hkv


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


def mlp_axes(cfg):
    names = ("w1", "w3", "w2") if cfg.mlp == "swiglu" else ("w1", "w2")
    return {k: (dense_axes("ffn", "embed") if k == "w2"
                else dense_axes("embed", "ffn")) for k in names}


def mlp_apply(cfg, p, x, d_ff=None):
    """``repro`` blocks.py:284: swiglu ``w2(silu(w1 x) * w3 x)`` with the
    MARCA SiLU of cfg.silu_impl, or ``w2(gelu(w1 x))``.  ``d_ff`` (the
    hidden width, cfg.d_ff when None) tells ``w2`` whether the mesh
    splits its contraction."""
    cdt = x.dtype
    if cfg.mlp == "swiglu":
        h = approx.get_silu(cfg.silu_impl)(dense(p["w1"], x, cdt))
        h = h * dense(p["w3"], x, cdt)
    else:
        h = F.gelu(dense(p["w1"], x, cdt), approximate="tanh")
    return dense_row(p["w2"], h, cdt, d_ff or cfg.d_ff, "ffn")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(cfg, gen):
    return {"tok": torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                               device=gen.device) * 0.02}


def embed_axes(cfg):
    return {"tok": ("vocab", "embed")}


def embed_apply(cfg, p, tokens, dtype):
    # index then cast: the same values as repro's cast-then-index
    start, n = sharding.local_range(cfg.vocab, "vocab")
    if n == cfg.vocab:
        return p["tok"][tokens].to(dtype)
    # vocab-parallel: the rank's rows, zeros for the others' tokens, summed
    # over the ranks (one nonzero term each: exact)
    local = tokens.long() - start
    inside = (local >= 0) & (local < n)
    rows = p["tok"][local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return sharding.sum_partials(rows, cfg.vocab, "vocab").to(dtype)


def unembed_init(cfg, gen):
    if cfg.tie_embeddings:
        return {}
    return {"w": torch.randn(cfg.d_model, cfg.vocab, generator=gen,
                             device=gen.device) * cfg.d_model ** -0.5}


def unembed_axes(cfg):
    return {} if cfg.tie_embeddings else {"w": ("embed", "vocab")}


def unembed_apply(cfg, p, embed_p, x):
    w = embed_p["tok"].T if cfg.tie_embeddings else p["w"]
    ldt = getattr(torch, cfg.logits_dtype)
    return sharding.gather_cols(torch.matmul(x.to(ldt), w.to(ldt)),
                                cfg.vocab, "vocab")
