"""Pure Mamba LM (the paper's Table-1 models): the port of
``repro/models/mamba_lm.py``.

Pre-norm residual stack of Mamba blocks with tied embeddings.  ``repro``
stacks the layer parameters on a leading L axis for ``lax.scan``; the
port keeps one dict per layer in a list (``p["layers"][l]``) and loops
in Python, while the decode cache keeps ``repro``'s stacked layout:
h (L, b, di, n), conv (L, b, k-1, di), pos (b,) int32, and with an
int8/fp8 state the group scales h_scale (L, b, g) f32.

A decode step runs per layer (``step_impl`` "fused": two kernel launches
per layer, the conv and the step) or as one launch of the cross-layer
kernel K3 for the whole stack (``stacked_step``, "megakernel", which
reads the layers through ``p["stack"]`` from
``registry.stack_params``).

Speculative decoding adds the draft views (the target's first n layers,
embed and final norm shared) and ``verify_window``, which runs a K-token
window through every layer's ``mamba.mamba_block_verify``.
"""
from __future__ import annotations

import torch

from repro_torch.core import state_quant
from repro_torch.kernels import megakernel, ops
from repro_torch.models import blocks, mamba


def init(cfg, gen):
    """Parameters from a ``torch.Generator`` (on the CPU; move the tree
    with ``registry.tree_to``)."""
    return {"embed": blocks.embed_init(cfg, gen),
            "layers": [{"norm": blocks.norm_init(cfg),
                        "mixer": mamba.mamba_block_init(cfg, gen)}
                       for _ in range(cfg.n_layers)],
            "norm_f": blocks.norm_init(cfg),
            "unembed": blocks.unembed_init(cfg, gen)}


def _layer_apply(cfg, lp, x, state=None, step=False):
    xn = blocks.apply_norm(cfg, lp["norm"], x)
    if step:
        y, new_state = mamba.mamba_block_step(cfg, lp["mixer"], xn, state)
    else:
        y, new_state = mamba.mamba_block_apply(cfg, lp["mixer"], xn,
                                               state=state)
    return x + y, new_state


def _logits(cfg, p, h):
    h = blocks.apply_norm(cfg, p["norm_f"], h)
    return blocks.unembed_apply(cfg, p.get("unembed", {}), p["embed"], h)


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def forward(cfg, p, batch):
    h = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    for lp in p["layers"]:
        h, _ = _layer_apply(cfg, lp, h)
    return _logits(cfg, p, h), {}


def _quantized(cfg):
    return state_quant.is_quantized(cfg.state_dtype)


def _state_keys(cfg):
    return ("h", "h_scale", "conv") if _quantized(cfg) else ("h", "conv")


def init_cache(cfg, batch, max_seq, dtype, device):
    L, di, n, k = cfg.n_layers, cfg.d_inner, cfg.d_state, cfg.d_conv
    out = {
        "h": torch.zeros(L, batch, di, n,
                         dtype=ops.storage_dtype(cfg.state_dtype),
                         device=device),
        "conv": torch.zeros(L, batch, k - 1, di, dtype=dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }
    if _quantized(cfg):
        # per-slot, per-layer, per-channel-group scales: every slot
        # operation moves them with their payload
        out["h_scale"] = torch.zeros(L, batch, state_quant.n_groups(di),
                                     dtype=torch.float32, device=device)
    return out


def cache_slot_axes(cfg):
    """Batch/slot axis index per cache leaf (layout matches init_cache)."""
    ax = {"h": 1, "conv": 1, "pos": 0}
    if _quantized(cfg):
        ax["h_scale"] = 1
    return ax


def _stack(cfg, states, pos):
    out = {k: torch.stack([s[k] for s in states]) for k in _state_keys(cfg)}
    out["pos"] = pos
    return out


def prefill(cfg, p, cache, batch):
    """Full-sequence forward that also returns the decode cache (from the
    init state, as repro's prefill does)."""
    tokens = batch["tokens"]
    h = blocks.embed_apply(cfg, p["embed"], tokens, _dtype(cfg))
    states = []
    for lp in p["layers"]:
        h, ns = _layer_apply(cfg, lp, h)
        states.append(ns)
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    return _logits(cfg, p, h), _stack(cfg, states, pos)


def stack_params(cfg, params):
    """``params`` with K3's view of the layers under ``"stack"``: a
    ``megakernel.MambaStack`` over the same tensors, built once per engine
    (``registry.stack_params``)."""
    return {**params, "stack": megakernel.MambaStack(cfg, params["layers"])}


def stacked_step(cfg, p, cache, batch):
    """Single-token decode as ONE kernel launch for the whole stack
    (``repro/models/mamba_lm.py:140``): embed, K3 over every layer
    (norm -> ``mamba.mamba_block_megastep`` -> residual, on the stacked
    cache), then the final norm and the tied unembed in PyTorch."""
    if "stack" not in p:
        raise ValueError(
            "step_impl='megakernel' decodes from the stacked layers: build "
            "them once with registry.stack_params(cfg, params)")
    x0 = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    x, h, h_scale, conv = megakernel.mamba_stacked_step(
        cfg, x0, p["stack"], cache["h"], cache.get("h_scale"),
        cache["conv"])
    out = {"h": h, "conv": conv, "pos": cache["pos"] + 1}
    if h_scale is not None:
        out["h_scale"] = h_scale
    return _logits(cfg, p, x), out


def decode_step(cfg, p, cache, batch):
    """One token for every slot: (logits (b, 1, V), new cache)."""
    if ops.resolve_step_impl(cfg.step_impl,
                             batch["tokens"].device) == "megakernel":
        return stacked_step(cfg, p, cache, batch)
    h = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    states = []
    for l, lp in enumerate(p["layers"]):
        state = {k: cache[k][l] for k in _state_keys(cfg)}
        h, ns = _layer_apply(cfg, lp, h, state=state, step=True)
        states.append(ns)
    return _logits(cfg, p, h), _stack(cfg, states, cache["pos"] + 1)


# ---------------------------------------------------------------------------
# Speculative decoding: the self-speculative draft is the target's first
# n layers (embed / final norm / unembed shared), so a draft needs no
# second parameter set, only a slice of the layer list and of the pooled
# cache that merges back leaf for leaf (``repro`` mamba_lm.py:118-137).
# ---------------------------------------------------------------------------

def draft_params(cfg, p, n):
    """First-``n``-layers view of a param tree.  The target's ``"stack"``
    (K3's view of all its layers) is left out: a megakernel draft builds
    its own over these layers, once (``SpecDecoder``)."""
    out = {k: v for k, v in p.items() if k != "stack"}
    out["layers"] = p["layers"][:n]
    return out


def draft_cache(cfg, cache, n):
    """First-``n``-layers view of a pooled cache (pos shared): leading-axis
    slices, contiguous as K3 takes them."""
    out = {k: cache[k][:n] for k in _state_keys(cfg)}
    out["pos"] = cache["pos"]
    return out


def draft_cache_merge(cfg, full, sub, n):
    """``full`` with its first ``n`` layers replaced by ``sub``'s (the
    inverse of ``draft_cache``); a new tree, layers from n on shared."""
    out = {k: torch.cat([sub[k], full[k][n:]]) for k in _state_keys(cfg)}
    out["pos"] = sub["pos"]
    return out


def verify_window(cfg, p, cache, tokens):
    """The speculative verify over a K-token window (``repro``
    mamba_lm.py:214): one embed, then per layer ``mamba_block_verify``
    (projections, conv and dt over the window, the SSM recurrence as the
    micro-scan), then the final norm and unembed over the window.

    tokens (b, K).  Returns (logits (b, K, V), caches): the cache tree
    with a leading per-step axis, caches[t] the cache after tokens[:, t]
    (h (K, L, b, di, n) ...).  A (b, K, d) matmul need not give each row
    the bits of the (b, 1, d) one in PyTorch, so the logits equal K
    chained decode steps' to rounding, not bitwise."""
    K = tokens.shape[1]
    x = blocks.embed_apply(cfg, p["embed"], tokens, _dtype(cfg))
    states = []
    for l, lp in enumerate(p["layers"]):
        xn = blocks.apply_norm(cfg, lp["norm"], x)
        y, st = mamba.mamba_block_verify(
            cfg, lp["mixer"], xn, {k: cache[k][l] for k in _state_keys(cfg)})
        x = x + y
        states.append(st)
    # each leaf (b, K, ...) a layer -> the chained layout (K, L, b, ...)
    out = {k: torch.stack([s[k] for s in states]).movedim(2, 0)
           for k in _state_keys(cfg)}
    out["pos"] = (cache["pos"][None, :]
                  + torch.arange(1, K + 1, dtype=torch.int32,
                                 device=tokens.device)[:, None])
    return _logits(cfg, p, x), out
