"""Model registry: family dispatch, slot-indexable caches and parameter
counts — the port of ``repro/models/registry.py`` for every family of
the zoo: mamba, jamba, xlstm and transformer.

  init_params(cfg, seed, device) -> param tree (nested dicts of tensors)
  quantize_params(cfg, params) -> the int8 + scale tree (weight_dtype)
  stack_params(cfg, params) -> the tree with the megakernel's view of
      its layers (built once per engine)
  forward / prefill / decode_step(cfg, params, ...) -> (logits, ...)
  init_cache(cfg, batch, max_seq, dtype, device) -> decode cache
  param_axes / cache_axes(cfg) -> the logical axes of every param and
      cache leaf (``repro``'s ``abstract_params`` / ``cache_axes`` axes,
      int8 weights' code and scale leaves included; a fused projection's
      leaves are ``sharding.Fused``), for ``parallel/sharding.py``;
      abstract_cache -> init_cache's shapes on the meta device
  gather_slots / scatter_slots / mask_slots -> the serving engine's
      slot contract over cache_slot_axes (nested cache trees: jamba's
      {"layers": {"pos{i}": {...}}, "pos"}, xLSTM's {"layers": [{"mlstm":
      {...}} | {"slstm": {...}}, ...], "pos"}; the transformer's flat
      {"k", "v", "pos"} (+ "k_scale", "v_scale"))
  uses_megakernel(cfg, device) -> whether a decode step runs K3
  verify_scan / verify_chain / select_step -> the speculative verify
      window over K tokens, with every step's cache, and the per-slot
      rollback to one step
  supports_draft / draft_config / draft_params / draft_cache /
      draft_cache_merge -> the self-speculative draft views
  loss_fn(cfg, params, batch) -> (loss, metrics), the training loss
  batch_shapes / make_batch(cfg, batch, seq, gen) -> a random batch
  count_params(cfg) -> analytical N
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import weight_quant
from repro_torch.kernels import ops
from repro_torch.models import jamba, mamba_lm, transformer, xlstm
from repro_torch.parallel import sharding

_FAMILIES = {"transformer": transformer, "mamba": mamba_lm, "jamba": jamba,
             "xlstm": xlstm}


def family(cfg):
    return _FAMILIES[cfg.family]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template, leaves):
    """The tree of ``template``'s structure with ``leaves`` in the order
    ``tree_leaves`` gives."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def tree_zip(fn, axes, *trees):
    """``fn(axis, *leaves)`` over trees of one structure, walked along
    ``axes`` (a tree of ints in dicts and lists, as ``cache_slot_axes``
    gives); returns the tree of the results."""
    if isinstance(axes, dict):
        return {k: tree_zip(fn, a, *(t[k] for t in trees))
                for k, a in axes.items()}
    if isinstance(axes, (list, tuple)):
        return [tree_zip(fn, a, *(t[i] for t in trees))
                for i, a in enumerate(axes)]
    return fn(axes, *trees)


# ---------------------------------------------------------------------------
# Params / caches
# ---------------------------------------------------------------------------

def init_params(cfg, seed: int = 0, device="cpu", draw_device="cpu"):
    """Weights made from ``seed`` with a ``torch.Generator`` on
    ``draw_device``, then moved to ``device``.  A CPU generator (the
    default) gives the same weights on every device; a CUDA one draws a
    large tree on the card (jamba-v0.1 is 53 GB in f32), with other
    numbers from the same seed.  Quantized when cfg.weight_dtype is
    "int8"."""
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    return tree_to(quantize_params(cfg, family(cfg).init(cfg, gen)), device)


def quantize_params(cfg, params):
    """Quantize an f32 param tree per cfg.weight_dtype (unchanged for
    "f32"): the int8 + scale tree the decode path serves from."""
    if not weight_quant.is_quantized(cfg.weight_dtype):
        return params
    return weight_quant.quantize_tree(params)


def stack_params(cfg, params):
    """``params`` with ``"stack"``: the layers as the cross-layer decode
    kernel (K3, ``step_impl="megakernel"``) reads them, over the same
    tensors (no weight is copied), built by the family: a
    ``megakernel.MambaStack`` of every layer for mamba, one
    ``megakernel.JambaRun`` per pure-SSM run of each group for jamba.
    ``repro`` holds its layers stacked on a leading axis; the port keeps
    per-layer dicts and builds this once per engine, after the tree has
    moved to its device, never per token."""
    return family(cfg).stack_params(cfg, params)


def uses_megakernel(cfg, device, mesh=None) -> bool:
    """Whether a decode step of ``cfg`` on ``device`` runs the cross-layer
    kernel K3 (and so needs ``stack_params``).  ``"auto"`` gives K3 on the
    card only for a family that has an instance of it, and the per-layer
    step otherwise (a transformer, whose ``repro`` decode step is per
    layer); an explicit ``"megakernel"`` for a family without one raises,
    as ``repro``'s ``stacked_step`` does.  Under a tensor-parallel
    ``mesh`` a decode step is per layer ("auto"; the engine serves such a
    config as "fused"): K3 runs whole layers in one launch, with no
    point between their row-parallel contractions where the ranks could
    sum, and an explicit "megakernel" raises."""
    if mesh is not None:
        if cfg.step_impl == "megakernel":
            raise ValueError(
                f"step_impl='megakernel' is unsupported under a mesh "
                f"({mesh}): the cross-layer kernel has no point between "
                f"a layer's row-parallel contractions for the ranks' sums "
                f"(ROADMAP A16); use 'auto' or 'fused'")
        return False
    if ops.resolve_step_impl(cfg.step_impl, device) != "megakernel":
        return False
    if hasattr(family(cfg), "stacked_step"):
        return True
    if cfg.step_impl == "auto":
        return False
    raise NotImplementedError(
        f"family {cfg.family!r} has no megakernel decode path")


def init_cache(cfg, batch, max_seq, dtype=None, device="cpu"):
    dtype = dtype or getattr(torch, cfg.dtype)
    return family(cfg).init_cache(cfg, batch, max_seq, dtype, device)


# ---------------------------------------------------------------------------
# Logical axes (tensor-parallel serving, ``parallel/sharding.py``)
# ---------------------------------------------------------------------------

def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _quantized_axes(node):
    """The axes of ``weight_quant.quantize_tree``'s output: a dense
    ``w`` gains ``w_scale`` on its output dim, ``A_log`` becomes ``A_q``
    (the same axes) and ``A_scale`` (its rows'), the subtrees under
    ``weight_quant.SKIP_KEYS`` stay as they are."""
    if isinstance(node, dict):
        if ("w" in node and set(node) <= {"w", "b"} and _is_axes(node["w"])
                and len(node["w"]) >= 2):
            w = node["w"]
            out = {"w": w, "w_scale": sharding.fused(
                w[:-2] + w[-1:], sharding.parts_of(w))}
            if "b" in node:
                out["b"] = node["b"]
            return out
        out = {}
        for k, v in node.items():
            if k in weight_quant.SKIP_KEYS:
                out[k] = v
            elif k == "A_log":
                out["A_q"], out["A_scale"] = v, v[:-1]
            else:
                out[k] = _quantized_axes(v)
        return out
    if isinstance(node, list):
        return [_quantized_axes(v) for v in node]
    return node


def param_axes(cfg):
    """A tree congruent with ``init_params(cfg)`` (f32 or int8 per
    cfg.weight_dtype) whose leaves are the logical axes of each param
    leaf: ``repro``'s ``abstract_params`` axes without its stacked
    "layers" axis (the port keeps layers in a list)."""
    axes = family(cfg).param_axes(cfg)
    if weight_quant.is_quantized(cfg.weight_dtype):
        axes = _quantized_axes(axes)
    return axes


def cache_axes(cfg):
    """A tree congruent with ``init_cache(cfg, ...)`` whose leaves are the
    logical axes of each cache leaf, as ``repro``'s ``cache_axes``."""
    return family(cfg).cache_axes(cfg)


def abstract_cache(cfg, batch, max_seq, dtype=None):
    """``init_cache``'s tree on the meta device: shapes and dtypes, no
    memory (``repro``'s ``abstract_cache``)."""
    return init_cache(cfg, batch, max_seq, dtype, device="meta")


# ---------------------------------------------------------------------------
# Slot-indexable caches (continuous-batching serving engine)
# ---------------------------------------------------------------------------

def cache_slot_axes(cfg):
    return family(cfg).cache_slot_axes(cfg)


def _bits(t):
    """``t`` itself, or for an fp8 leaf its bytes (a dtype view, no
    copy): slot copies and selects move codes, and PyTorch's CPU
    ``index_copy_`` has no fp8 kernel."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def gather_slots(cfg, cache, slot_ids):
    """Sub-cache of ``slot_ids`` (int64 tensor (m,)), a copy."""
    return tree_zip(
        lambda ax, v: _bits(v).index_select(ax, slot_ids).view(v.dtype),
        cache_slot_axes(cfg), cache)


def scatter_slots(cfg, pool_cache, sub_cache, slot_ids):
    """Write a sub-cache (m slot entries) into ``pool_cache`` at
    ``slot_ids``.  In place — the pool's buffers are updated rather than
    copied, unlike repro's functional ``.at[].set`` — and returned."""
    def put(ax, dst, src):
        _bits(dst).index_copy_(ax, slot_ids, _bits(src.to(dst.dtype)))

    tree_zip(put, cache_slot_axes(cfg), pool_cache, sub_cache)
    return pool_cache


def mask_slots(cfg, old_cache, new_cache, active):
    """Per-slot select: ``new_cache`` where ``active`` (bool (slots,)),
    else ``old_cache`` — inactive slots never change."""
    def mix(ax, old, new):
        shape = [1] * old.dim()
        shape[ax] = -1
        return torch.where(active.reshape(shape), _bits(new.to(old.dtype)),
                           _bits(old)).view(old.dtype)

    return tree_zip(mix, cache_slot_axes(cfg), old_cache, new_cache)


# ---------------------------------------------------------------------------
# Forward / serving entry points
# ---------------------------------------------------------------------------

def forward(cfg, params, batch):
    return family(cfg).forward(cfg, params, batch)


def prefill(cfg, params, cache, batch):
    return family(cfg).prefill(cfg, params, cache, batch)


def decode_step(cfg, params, cache, batch):
    return family(cfg).decode_step(cfg, params, cache, batch)


# ---------------------------------------------------------------------------
# Training: the loss and a random batch (``repro`` registry.py:262, :339)
# ---------------------------------------------------------------------------

def loss_fn(cfg, params, batch):
    """Causal LM loss, multi-codebook aware, softmax in the logits dtype
    (f32 by default): the mean next-token NLL plus every aux loss of the
    forward (the MoE's ``moe_lb`` and ``moe_z``).  Returns (loss,
    metrics) with ``nll``, each aux loss and ``loss``, 0-dim tensors.
    The vision stub's image prefix carries no loss; with n_codebooks > 1
    the logits are (b, l, ncb, V) against labels (b, l, ncb)."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"].long()
    if cfg.n_codebooks <= 1 and cfg.frontend == "vision_stub":
        logits = logits[:, -labels.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    nll = (lse - ll).mean()
    loss = nll
    metrics = {"nll": nll}
    for k, v in aux.items():
        loss = loss + v
        metrics[k] = v
    metrics["loss"] = loss
    return loss, metrics


def batch_shapes(cfg, batch_size, seq_len, with_labels=True) -> dict:
    """{name: (shape, dtype)} of one step's batch per frontend: audio
    frame embeddings and codebook labels for the audio stub, tokens and
    image patch embeddings for the vision stub, else tokens (labels
    beside each)."""
    tok = ((batch_size, seq_len), torch.int32)
    emb = getattr(torch, cfg.dtype)
    out = {}
    if cfg.frontend == "audio_stub":
        out["embeds"] = ((batch_size, seq_len, cfg.d_model), emb)
        if with_labels:
            out["labels"] = ((batch_size, seq_len, cfg.n_codebooks),
                             torch.int32)
    elif cfg.frontend == "vision_stub":
        out["tokens"] = tok
        out["img_embeds"] = ((batch_size, cfg.img_tokens, cfg.d_model), emb)
        if with_labels:
            out["labels"] = tok
    else:
        out["tokens"] = tok
        if with_labels:
            out["labels"] = tok
    return out


def make_batch(cfg, batch_size, seq_len, gen=None, with_labels=True,
               device="cpu"):
    """A random batch of ``batch_shapes``: integers uniform in [0, vocab),
    embeddings standard normal, drawn in name order from ``gen`` (a
    ``torch.Generator``; seed 0 when None) on its device, then moved to
    ``device``."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    out = {}
    for name, (shape, dtype) in sorted(
            batch_shapes(cfg, batch_size, seq_len, with_labels).items()):
        if dtype == torch.int32:
            t = torch.randint(0, cfg.vocab, shape, generator=gen,
                              device=gen.device, dtype=dtype)
        else:
            t = torch.randn(shape, generator=gen, device=gen.device).to(
                dtype)
        out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# Speculative decoding: the K-step verify window, the per-slot rollback
# select and the self-speculative draft views (``repro`` registry.py:161)
# ---------------------------------------------------------------------------

def _freeze_steps(cfg, cache0, stacked, active):
    """Per-slot freeze over a verify stack (leading per-step axis):
    inactive slots read ``cache0`` at every step, which is what the
    chained verify's per-step ``mask_slots`` accumulates to."""
    def mix(ax, old, new):
        shape = [1] * new.dim()
        shape[ax + 1] = -1
        return torch.where(active.reshape(shape), _bits(new.to(old.dtype)),
                           _bits(old)[None]).view(old.dtype)

    return tree_zip(mix, cache_slot_axes(cfg), cache0, stacked)


def _stack(trees):
    """A list of trees of one structure -> one tree, leaves stacked on a
    new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(trees[0]))]
    return torch.stack(trees)


def verify_chain(cfg, params, cache, tokens, active=None):
    """The verify as K chained ``decode_step`` calls, each cache masked
    to ``active``: ``verify_scan``'s path for a family without a window,
    and the reference its windows are held to.  Returns what
    ``verify_scan`` returns."""
    logits, steps = [], []
    for t in range(tokens.shape[1]):
        lg, new = decode_step(cfg, params, cache,
                              {"tokens": tokens[:, t:t + 1]})
        cache = new if active is None else mask_slots(cfg, cache, new,
                                                      active)
        logits.append(lg[:, -1])
        steps.append(cache)
    return torch.stack(logits, 1), _stack(steps)


def verify_scan(cfg, params, cache, tokens, active=None):
    """Run K candidate tokens through the model: the speculative verify
    pass.  The mamba, jamba and xLSTM families run their batched
    ``verify_window`` (projections and convs over the window, only the
    recurrences chained per token); the transformer chains
    ``decode_step`` (``verify_chain``), as ``repro``'s does.

    tokens (b, K); ``active`` (b,) bool freezes the other slots.
    Returns (logits (b, K, V), caches), the cache tree with a leading
    per-step axis, caches[t] the cache after tokens[:, t].  The window's
    logits equal the chained steps' to rounding: PyTorch's (b, K, d)
    matmul need not give each row the bits of the (b, 1, d) one."""
    window = getattr(family(cfg), "verify_window", None)
    if window is None:
        return verify_chain(cfg, params, cache, tokens, active)
    logits, caches = window(cfg, params, cache, tokens)
    if active is not None:
        caches = _freeze_steps(cfg, cache, caches, active)
    return logits, caches


def select_step(cfg, stacked_cache, step_idx):
    """Per-slot rollback: from a verify stack (leading per-step axis)
    pick step ``step_idx[s]`` (int tensor (slots,)) for slot s.  Returns
    a cache tree of new contiguous leaves, each slot's state after
    exactly its accepted prefix."""
    def pick(ax, leaf):
        m = _bits(leaf).movedim(ax + 1, 0)            # (slots, K, ...)
        rows = torch.arange(m.shape[0], device=m.device)
        sel = m[rows, step_idx.to(m.device, torch.int64)]
        return sel.movedim(0, ax).contiguous().view(leaf.dtype)

    return tree_zip(pick, cache_slot_axes(cfg), stacked_cache)


def supports_draft(cfg) -> bool:
    return hasattr(family(cfg), "draft_params")


def draft_config(cfg, n_layers: int):
    """Model config of the first-``n_layers`` self-speculative draft.
    Jamba drafts whole groups (``jamba._n_draft_groups`` validates)."""
    if not supports_draft(cfg):
        raise NotImplementedError(
            f"family {cfg.family!r} has no self-speculative draft view")
    if cfg.family == "jamba":
        jamba._n_draft_groups(cfg, n_layers)
    elif not 0 < n_layers <= cfg.n_layers:
        raise ValueError(
            f"draft layers must be in (0, {cfg.n_layers}]; got {n_layers}")
    return dataclasses.replace(cfg, n_layers=n_layers)


def draft_params(cfg, params, n_layers: int):
    """First-``n_layers`` view of a param tree (no weight copied), without
    the target's K3 view (``"stack"``)."""
    return family(cfg).draft_params(cfg, params, n_layers)


def draft_cache(cfg, cache, n_layers: int):
    """First-``n_layers`` view of a pooled cache."""
    return family(cfg).draft_cache(cfg, cache, n_layers)


def draft_cache_merge(cfg, full_cache, sub_cache, n_layers: int):
    """``full_cache`` with the draft's layers of ``sub_cache`` written
    back: a new tree."""
    return family(cfg).draft_cache_merge(cfg, full_cache, sub_cache,
                                         n_layers)


# ---------------------------------------------------------------------------
# Analytical parameter counts (a copy of repro's; pure arithmetic)
# ---------------------------------------------------------------------------

def count_params(cfg, active_only: bool = False) -> int:
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = 0

    def attn():
        return d * hq * dh + 2 * d * hkv * dh + hq * dh * d

    def dense_mlp(ff):
        return 3 * d * ff if cfg.mlp == "swiglu" else 2 * d * ff

    def moe_mlp():
        E = cfg.top_k if active_only else cfg.n_experts
        m = E * 3 * d * f + d * cfg.n_experts  # router always full
        if cfg.n_shared_experts:
            m += 3 * d * (cfg.n_shared_experts * f)
        if cfg.dense_residual:
            m += dense_mlp(f)
        return m

    def mamba_blk():
        di, ns, r, k = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
        return (2 * d * di + k * di + di * (r + 2 * ns) + r * di
                + di * ns + di + di * d)

    def mlstm_blk():
        di = 2 * d
        dh2 = di // hq
        return 2 * d * di + cfg.d_conv * di + 2 * hq * dh2 * dh2 + di + d * di

    def slstm_blk():
        dh2 = d // hq
        return 4 * d * d + 4 * hq * dh2 * dh2 + d * d

    def is_slstm(i):                     # repro/models/xlstm.py:476
        return (cfg.slstm_every > 0 and i % cfg.slstm_every
                == cfg.slstm_offset % cfg.slstm_every)

    def pos_kind(i):                     # repro/models/jamba.py:24
        is_attn = (cfg.attn_every > 0 and i % cfg.attn_every
                   == cfg.attn_offset % cfg.attn_every)
        is_moe = (cfg.is_moe and cfg.moe_every > 0
                  and i % cfg.moe_every == cfg.moe_offset % cfg.moe_every)
        return is_attn, is_moe

    if cfg.family == "mamba":
        n += L * mamba_blk()
    elif cfg.family == "xlstm":
        for i in range(L):
            n += slstm_blk() if is_slstm(i) else mlstm_blk()
    elif cfg.family == "jamba":
        for i in range(L):
            is_attn, is_moe = pos_kind(i)
            n += attn() if is_attn else mamba_blk()
            n += moe_mlp() if is_moe else dense_mlp(f)
    else:
        per = attn() + (moe_mlp() if cfg.is_moe else dense_mlp(f))
        n += L * per
    n += V * d                      # embed
    if not cfg.tie_embeddings:
        n += d * V * cfg.n_codebooks
    return int(n)
