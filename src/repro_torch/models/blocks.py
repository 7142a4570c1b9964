"""Model building blocks the Mamba LM needs (subset of
``repro/models/blocks.py``): dense projection, norms, embedding and the
tied unembedding.

Parameters are plain tensors in nested dicts laid out as ``repro``'s
(dense weights are ``(d_in, d_out)``, int8 weights carry a ``w_scale``
sibling), so ``bridge.py`` maps one tree onto the other leaf for leaf.
Compute dtype follows cfg.dtype; norms and logits are f32.  The GEMMs
are ``torch.matmul``, as ``repro`` leaves them to XLA.
"""
from __future__ import annotations

import torch


def dense_init(gen, d_in, d_out, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": torch.randn(d_in, d_out, generator=gen) * scale}


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


def embed_init(cfg, gen):
    return {"tok": torch.randn(cfg.vocab, cfg.d_model, generator=gen) * 0.02}


def embed_apply(cfg, p, tokens, dtype):
    # index then cast: the same values as repro's cast-then-index
    return p["tok"][tokens].to(dtype)


def unembed_init(cfg, gen):
    if cfg.tie_embeddings:
        return {}
    return {"w": torch.randn(cfg.d_model, cfg.vocab, generator=gen)
            * cfg.d_model ** -0.5}


def unembed_apply(cfg, p, embed_p, x):
    w = embed_p["tok"].T if cfg.tie_embeddings else p["w"]
    ldt = getattr(torch, cfg.logits_dtype)
    return torch.matmul(x.to(ldt), w.to(ldt))
