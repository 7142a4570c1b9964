"""Jamba (arXiv:2403.19887): Mamba and attention interleaved 1:7, MoE every
other layer -- the port of ``repro/models/jamba.py``.

The layer stack is a sequence of groups of ``attn_every`` positions (the
repeating pattern).  With attn_every=8, moe_every=2, moe_offset=1,
attn_offset=4 a group is

  pos: 0      1        2      3        4       5        6      7
       mamba  mamba    mamba  mamba    attn    mamba    mamba  mamba
       dense  MoE      dense  MoE      dense   MoE      dense  MoE

``repro`` stacks each position's parameters on a leading group axis for
``lax.scan``; the port keeps one dict per group in a list
(``p["groups"][g]["pos{i}"]``, as ``mamba_lm`` keeps per-layer dicts)
and loops in Python.  The decode cache keeps ``repro``'s stacked layout:
``{"layers": {"pos{i}": {...}}, "pos": (b,)}``, each leaf with a leading
group axis: k, v (G, b, S, hkv*dh) (+ k_scale, v_scale (G, b, S, 1) for
an int8 KV cache) at the attention position, h (G, b, d_inner, 16), conv
(G, b, k-1, d_inner) (+ h_scale (G, b, g) for an int8/fp8 state)
elsewhere.

A decode step runs per sublayer (``step_impl`` "fused": the conv and
step kernels at each mamba position) or, with "megakernel", each
maximal run of pure-SSM positions (mamba block and dense MLP) of a group
as one launch of K3's jamba instance (``stacked_step``), the attention
and MoE positions staying on their per-sublayer path.  The new cache is
written into fresh stacked leaves, K3 writing its positions' states
there itself.

Speculative decoding: ``verify_window`` runs a K-token window through
each group, the pure-SSM positions through ``sublayer_verify`` (the
mamba block's batched verify window and the MLP over the window), the
attention and MoE positions chained per token through
``_sublayer_apply``, as in ``repro``.  A draft is whole groups.
"""
from __future__ import annotations

import torch

from repro_torch.core import state_quant
from repro_torch.kernels import megakernel, ops
from repro_torch.models import blocks, mamba, moe


def _period(cfg):
    return cfg.attn_every or 8


def _n_groups(cfg):
    return cfg.n_layers // _period(cfg)


def _pos_kind(cfg, pos):
    is_attn = (cfg.attn_every > 0
               and pos % cfg.attn_every == cfg.attn_offset % cfg.attn_every)
    is_moe = (cfg.is_moe and cfg.moe_every > 0
              and pos % cfg.moe_every == cfg.moe_offset % cfg.moe_every)
    return is_attn, is_moe


def _sublayer_init(cfg, gen, pos):
    is_attn, is_moe = _pos_kind(cfg, pos)
    p = {"norm1": blocks.norm_init(cfg), "norm2": blocks.norm_init(cfg)}
    if is_attn:
        p["attn"] = blocks.attention_init(cfg, gen)
    else:
        p["mamba"] = mamba.mamba_block_init(cfg, gen)
    if is_moe:
        p["moe"] = moe.moe_init(cfg, gen)
    else:
        p["mlp"] = blocks.mlp_init(cfg, gen)
    return p


def _sublayer_axes(cfg, pos):
    is_attn, is_moe = _pos_kind(cfg, pos)
    p = {"norm1": blocks.norm_axes(cfg), "norm2": blocks.norm_axes(cfg)}
    if is_attn:
        p["attn"] = blocks.attention_axes(cfg)
    else:
        p["mamba"] = mamba.mamba_block_axes(cfg)
    if is_moe:
        p["moe"] = moe.moe_axes(cfg)
    else:
        p["mlp"] = blocks.mlp_axes(cfg)
    return p


def param_axes(cfg):
    """Logical axes of ``init``'s tree (``repro`` jamba.py, per group
    without the stacked group axis)."""
    return {"embed": blocks.embed_axes(cfg),
            "groups": [{f"pos{i}": _sublayer_axes(cfg, i)
                        for i in range(_period(cfg))}
                       for _ in range(_n_groups(cfg))],
            "norm_f": blocks.norm_axes(cfg),
            "unembed": blocks.unembed_axes(cfg)}


def cache_axes(cfg):
    """Logical axes of ``init_cache``'s leaves: the group axis is
    ``repro``'s "layers"."""
    layers = {}
    for i in range(_period(cfg)):
        if _pos_kind(cfg, i)[0]:
            kv = ("layers", "act_batch", "act_seq", "act_ffn")
            leaf = {"k": kv, "v": kv}
            if cfg.kv_cache_dtype == "int8":
                sc = ("layers", "act_batch", "act_seq", None)
                leaf.update({"k_scale": sc, "v_scale": sc})
        else:
            leaf = {k: ("layers",) + a
                    for k, a in mamba.mamba_state_axes(cfg).items()}
        layers[f"pos{i}"] = leaf
    return {"layers": layers, "pos": ("act_batch",)}


def _zero_aux(device):
    return {"moe_lb": torch.zeros((), device=device),
            "moe_z": torch.zeros((), device=device)}


def _sublayer_apply(cfg, p, pos, x, positions, state=None, dpos=None):
    """One sublayer; ``state`` the mamba state or KV cache of this
    position, ``dpos`` (b,) the decode positions (None for a whole
    sequence).  Returns (x, new_state, aux)."""
    is_attn, is_moe = _pos_kind(cfg, pos)
    xn = blocks.apply_norm(cfg, p["norm1"], x)
    if is_attn:
        h, new_state = blocks.attention_apply(cfg, p["attn"], xn, positions,
                                              cache=state, pos=dpos)
    elif dpos is None:
        h, new_state = mamba.mamba_block_apply(cfg, p["mamba"], xn,
                                               state=state)
    else:
        h, new_state = mamba.mamba_block_step(cfg, p["mamba"], xn, state)
    x = x + h
    xn = blocks.apply_norm(cfg, p["norm2"], x)
    aux = _zero_aux(x.device)
    if is_moe:
        hm, aux = moe.moe_apply(cfg, p["moe"], xn)
    else:
        hm = blocks.mlp_apply(cfg, p["mlp"], xn)
    return x + hm, new_state, aux


def sublayer_verify(cfg, p, pos, x, state):
    """K-token verify window of one mamba sublayer (``repro``
    jamba.py:72): ``mamba.mamba_block_verify``, then the MLP or MoE over
    the window.  Attention positions have no window and raise
    (``verify_window`` chains them per token).  Returns (x (b, K, d),
    states stacked per step on axis 1)."""
    is_attn, is_moe = _pos_kind(cfg, pos)
    if is_attn:
        raise NotImplementedError(
            "jamba attention sublayers have no K-token verify window; "
            "verify_window chains them per token")
    xn = blocks.apply_norm(cfg, p["norm1"], x)
    h, states = mamba.mamba_block_verify(cfg, p["mamba"], xn, state)
    x = x + h
    xn = blocks.apply_norm(cfg, p["norm2"], x)
    if is_moe:
        hm, _ = moe.moe_apply(cfg, p["moe"], xn)
    else:
        hm = blocks.mlp_apply(cfg, p["mlp"], xn)
    return x + hm, states


def init(cfg, gen):
    """Parameters from a ``torch.Generator``, drawn on its device."""
    period = _period(cfg)
    if cfg.n_layers % period:
        raise ValueError(f"n_layers {cfg.n_layers} is no multiple of the "
                         f"group period {period}")
    return {"embed": blocks.embed_init(cfg, gen),
            "groups": [{f"pos{i}": _sublayer_init(cfg, gen, i)
                        for i in range(period)}
                       for _ in range(_n_groups(cfg))],
            "norm_f": blocks.norm_init(cfg),
            "unembed": blocks.unembed_init(cfg, gen)}


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _positions(b, l, device):
    return torch.arange(l, device=device)[None].expand(b, l)


def _logits(cfg, p, h):
    h = blocks.apply_norm(cfg, p["norm_f"], h)
    return blocks.unembed_apply(cfg, p.get("unembed", {}), p["embed"], h)


def forward(cfg, p, batch):
    """(logits (b, l, V), the summed aux losses)."""
    tokens = batch["tokens"]
    h = blocks.embed_apply(cfg, p["embed"], tokens, _dtype(cfg))
    positions = _positions(*tokens.shape, tokens.device)
    aux = _zero_aux(tokens.device)
    for gp in p["groups"]:
        for i in range(_period(cfg)):
            h, _, a = _sublayer_apply(cfg, gp[f"pos{i}"], i, h, positions)
            aux = {k: aux[k] + a[k] for k in aux}
    return _logits(cfg, p, h), aux


def _quantized(cfg):
    return state_quant.is_quantized(cfg.state_dtype)


def init_cache(cfg, batch, max_seq, dtype, device):
    """Per-position caches stacked over the groups: KV strips at the
    attention position, the mamba state (h, conv) elsewhere."""
    G = _n_groups(cfg)
    layers = {}
    for i in range(_period(cfg)):
        is_attn, _ = _pos_kind(cfg, i)
        if is_attn:
            shape = (G, batch, max_seq, cfg.n_kv_heads * cfg.head_dim)
            if cfg.kv_cache_dtype == "int8":
                # int8 strips with per-(slot, position) absmax scales
                # beside them: payload and scale move together
                sshape = (G, batch, max_seq, 1)
                layers[f"pos{i}"] = {
                    "k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshape, device=device),
                    "v_scale": torch.zeros(sshape, device=device)}
            else:
                layers[f"pos{i}"] = {
                    "k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            st = mamba.mamba_state_init(cfg, batch, dtype, device)
            layers[f"pos{i}"] = {k: v[None].repeat(G, *([1] * v.dim()))
                                 for k, v in st.items()}
    return {"layers": layers,
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def cache_slot_axes(cfg):
    """Batch/slot axis index per cache leaf (layout matches init_cache)."""
    mamba_ax = {"h": 1, "conv": 1}
    if _quantized(cfg):
        mamba_ax["h_scale"] = 1
    attn_ax = {"k": 1, "v": 1}
    if cfg.kv_cache_dtype == "int8":
        attn_ax.update({"k_scale": 1, "v_scale": 1})
    return {"layers": {f"pos{i}": dict(attn_ax if _pos_kind(cfg, i)[0]
                                       else mamba_ax)
                       for i in range(_period(cfg))},
            "pos": 0}


def _stack_groups(per_group):
    """[{leaf: (b, ...)}] per group -> {leaf: (G, b, ...)}."""
    return {k: torch.stack([s[k] for s in per_group])
            for k in per_group[0]}


def prefill(cfg, p, cache, batch):
    """Full-sequence forward that fills the KV strips (padded to the
    cache's max_seq) and the mamba states; the returned cache is new."""
    tokens = batch["tokens"]
    b, l = tokens.shape
    h = blocks.embed_apply(cfg, p["embed"], tokens, _dtype(cfg))
    positions = _positions(b, l, tokens.device)
    period = _period(cfg)
    S = next((cache["layers"][f"pos{i}"]["k"].shape[2]
              for i in range(period) if _pos_kind(cfg, i)[0]), l)
    states = {f"pos{i}": [] for i in range(period)}
    for gp in p["groups"]:
        for i in range(period):
            is_attn, is_moe = _pos_kind(cfg, i)
            lp = gp[f"pos{i}"]
            xn = blocks.apply_norm(cfg, lp["norm1"], h)
            if is_attn:
                hh, kv = blocks.attention_apply(cfg, lp["attn"], xn,
                                                positions, return_kv=True)

                def pad(t):
                    return torch.nn.functional.pad(t, (0, 0, 0, S - l))

                if cfg.kv_cache_dtype == "int8":
                    kv_full = cfg.n_kv_heads * cfg.head_dim
                    kq, ks = blocks._kv_quant(kv["k"], kv_full)
                    vq, vs = blocks._kv_quant(kv["v"], kv_full)
                    st = {"k": pad(kq), "v": pad(vq), "k_scale": pad(ks),
                          "v_scale": pad(vs)}
                else:
                    st = {"k": pad(kv["k"]), "v": pad(kv["v"])}
            else:
                hh, st = mamba.mamba_block_apply(cfg, lp["mamba"], xn)
                st = {**st, "conv": st["conv"].to(_dtype(cfg))}
            states[f"pos{i}"].append(st)
            h = h + hh
            xn = blocks.apply_norm(cfg, lp["norm2"], h)
            if is_moe:
                hm, _ = moe.moe_apply(cfg, lp["moe"], xn)
            else:
                hm = blocks.mlp_apply(cfg, lp["mlp"], xn)
            h = h + hm
    layers = {k: _stack_groups(v) for k, v in states.items()}
    pos = torch.full((b,), l, dtype=torch.int32, device=tokens.device)
    return _logits(cfg, p, h), {"layers": layers, "pos": pos}


def _megakernel_plan(cfg):
    """The decode plan of the megakernel path (``repro`` jamba.py:252): a
    group's positions split into maximal runs of pure-SSM positions (no
    attention, no MoE), each one K3 launch ("mega", positions), the
    others on their per-sublayer path ("one", position)."""
    plan, cur = [], []
    for pos in range(_period(cfg)):
        is_attn, is_moe = _pos_kind(cfg, pos)
        if is_attn or is_moe:
            if cur:
                plan.append(("mega", tuple(cur)))
                cur = []
            plan.append(("one", pos))
        else:
            cur.append(pos)
    if cur:
        plan.append(("mega", tuple(cur)))
    return tuple(plan)


def stack_params(cfg, params):
    """``params`` with K3's view of the decode weights under ``"stack"``:
    for each group, one ``megakernel.JambaRun`` per "mega" entry of the
    plan, in plan order.  Built once per engine
    (``registry.stack_params``); no weight is copied."""
    runs = [seg for kind, seg in _megakernel_plan(cfg) if kind == "mega"]
    return {**params, "stack": [
        [megakernel.JambaRun(cfg, [gp[f"pos{i}"] for i in run])
         for run in runs] for gp in params["groups"]]}


def _group_state(cache_layers, key, g):
    return {k: v[g] for k, v in cache_layers[key].items()}


def _new_layers(layers):
    """Uninitialized leaves like the cache's, that a decode step fills
    group by group (no stack of per-group results)."""
    return {k: {kk: torch.empty_like(vv) for kk, vv in v.items()}
            for k, v in layers.items()}


def stacked_step(cfg, p, cache, batch):
    """Single-token decode with each pure-SSM run of a group as ONE
    launch of K3's jamba instance (``repro`` jamba.py:279), the attention
    and MoE positions on their per-sublayer path.  Reads the runs'
    weights through ``p["stack"]`` (``registry.stack_params``)."""
    if "stack" not in p:
        raise ValueError(
            "step_impl='megakernel' decodes from the stacked runs: build "
            "them once with registry.stack_params(cfg, params)")
    dpos = cache["pos"]
    x = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    positions = dpos[:, None]
    layers = cache["layers"]
    new = _new_layers(layers)
    for g, gp in enumerate(p["groups"]):
        runs = iter(p["stack"][g])
        for kind, seg in _megakernel_plan(cfg):
            if kind == "mega":
                keys = [f"pos{i}" for i in seg]
                x = megakernel.jamba_stacked_run(
                    cfg, x, next(runs),
                    [_group_state(layers, k, g) for k in keys],
                    [_group_state(new, k, g) for k in keys])
            else:
                key = f"pos{seg}"
                x, ns, _ = _sublayer_apply(
                    cfg, gp[key], seg, x, positions,
                    state=_group_state(layers, key, g), dpos=dpos)
                for k, v in ns.items():
                    new[key][k][g].copy_(v)
    return _logits(cfg, p, x), {"layers": new, "pos": dpos + 1}


def decode_step(cfg, p, cache, batch):
    """One token for every slot: (logits (b, 1, V), new cache)."""
    if ops.resolve_step_impl(cfg.step_impl,
                             batch["tokens"].device) == "megakernel":
        return stacked_step(cfg, p, cache, batch)
    dpos = cache["pos"]
    x = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    positions = dpos[:, None]
    layers = cache["layers"]
    new = _new_layers(layers)
    for g, gp in enumerate(p["groups"]):
        for i in range(_period(cfg)):
            key = f"pos{i}"
            x, ns, _ = _sublayer_apply(cfg, gp[key], i, x, positions,
                                       state=_group_state(layers, key, g),
                                       dpos=dpos)
            for k, v in ns.items():
                new[key][k][g].copy_(v)
    return _logits(cfg, p, x), {"layers": new, "pos": dpos + 1}


def verify_window(cfg, p, cache, tokens):
    """The speculative verify over a K-token window (``repro``
    jamba.py:391).  Pure-SSM positions run ``sublayer_verify``; attention
    positions (K sequential KV writes) and MoE positions (routing couples
    the batch) chain ``_sublayer_apply`` per token.  Returns (logits
    (b, K, V), caches), the cache tree with a leading per-step axis
    (layers' leaves (K, G, b, ...))."""
    K = tokens.shape[1]
    dpos = cache["pos"]
    x = blocks.embed_apply(cfg, p["embed"], tokens, _dtype(cfg))
    per_group = {f"pos{i}": [] for i in range(_period(cfg))}
    for g, gp in enumerate(p["groups"]):
        for i in range(_period(cfg)):
            key = f"pos{i}"
            is_attn, is_moe = _pos_kind(cfg, i)
            st = _group_state(cache["layers"], key, g)
            if is_attn or is_moe:
                xs, steps = [], []
                for t in range(K):
                    xt, st, _ = _sublayer_apply(
                        cfg, gp[key], i, x[:, t:t + 1], (dpos + t)[:, None],
                        state=st, dpos=dpos + t)
                    xs.append(xt)
                    steps.append(st)
                x = torch.cat(xs, dim=1)
                per_group[key].append({k: torch.stack([s[k] for s in steps])
                                       for k in steps[0]})
            else:
                x, states = sublayer_verify(cfg, gp[key], i, x, st)
                per_group[key].append({k: v.movedim(1, 0)
                                       for k, v in states.items()})
    layers = {key: {k: torch.stack([grp[k] for grp in groups], dim=1)
                    for k in groups[0]}
              for key, groups in per_group.items()}
    pos = (dpos[None, :] + torch.arange(1, K + 1, dtype=torch.int32,
                                        device=tokens.device)[:, None])
    return _logits(cfg, p, x), {"layers": layers, "pos": pos}


# ---------------------------------------------------------------------------
# Self-speculative draft views (``repro`` jamba.py:221-249): whole groups,
# so each group keeps its mamba/attention/MoE pattern.  A megakernel
# draft builds its own K3 runs over them, once; the port's one-group
# configs draft at full depth and reuse the target's.
# ---------------------------------------------------------------------------

def _n_draft_groups(cfg, n):
    period = _period(cfg)
    if n % period or not 0 < n <= cfg.n_layers:
        raise ValueError(
            f"jamba draft layers must be a multiple of the group period "
            f"({period}) in (0, {cfg.n_layers}]; got {n}")
    return n // period


def draft_params(cfg, p, n):
    out = {k: v for k, v in p.items() if k != "stack"}
    out["groups"] = p["groups"][:_n_draft_groups(cfg, n)]
    return out


def draft_cache(cfg, cache, n):
    ng = _n_draft_groups(cfg, n)
    return {"layers": {key: {k: v[:ng] for k, v in leaves.items()}
                       for key, leaves in cache["layers"].items()},
            "pos": cache["pos"]}


def draft_cache_merge(cfg, full, sub, n):
    ng = _n_draft_groups(cfg, n)
    return {"layers": {key: {k: torch.cat([sub["layers"][key][k], v[ng:]])
                             for k, v in leaves.items()}
                       for key, leaves in full["layers"].items()},
            "pos": sub["pos"]}
