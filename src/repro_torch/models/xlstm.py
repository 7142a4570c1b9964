"""xLSTM (Beck et al. 2024, arXiv:2405.04517): mLSTM and sLSTM blocks -- the
port of ``repro/models/xlstm.py``.

The layer stack is a python list of ``{"mlstm": ...}`` / ``{"slstm": ...}``
dicts (sLSTM where ``i % slstm_every == slstm_offset``), in ``repro`` as
here, and so is the decode cache: ``{"layers": [{"mlstm": {C, n, m, conv}
(+ C_scale)} | {"slstm": {c, n, h, m}}, ...], "pos": (b,)}``, each leaf
slot-leading.  An mLSTM layer keeps its matrix memory C (b, nh, dh, dh) in
cfg.state_dtype's storage (int8/fp8 codes with one f32 scale per row in
C_scale (b, nh, dh)); n, m and the conv tail stay f32, as do the sLSTM
states, whatever the compute dtype (``repro``'s leaf dtypes: a bf16 conv
tail is cast to f32 where it is written).

Per mLSTM block: norm -> up (d -> 2 x 2d) -> [u | g] -> causal conv of u
(no bias) -> SiLU -> per-head q, k; v = u; the i/f gates from the conv
output -> stabilised matrix-memory recurrence -> group norm -> x SiLU(g)
-> down.  Per sLSTM block: norm -> wx (d -> 4d) + R h_{t-1} + bias ->
scalar-memory recurrence -> group norm -> out.

``conv_impl`` "pallas" runs the conv through the conv kernel (K5 on the
card); "xla" runs it as plain tensor code, as ``repro`` runs it in XLA,
so the per-layer decode path launches no kernel then, as ``repro``'s
(whose per-layer step is pure XLA).  A decode step runs per layer
(``step_impl`` "fused") or with each maximal run of same-kind layers as
one launch of K3's xLSTM instance (``stacked_step``, "megakernel"; six
launches a token at xlstm-350m, two at its smoke config).  Prefill runs
the recurrences as a per-token loop of plain tensor code, as ``repro``
runs them in ``lax.scan`` with no kernel.

Under a tensor-parallel mesh each rank holds its heads where the mesh
splits them: the mLSTM's up projection cut piecewise into [u | g] of the
rank's channels, its conv, q/k/i/f weights, group norm and states over
the rank's heads, the sLSTM's four gates cut piecewise, its R and states
over the rank's heads; the down / out projections sum their partial
products over the ranks.  Where the heads do not divide (4 heads on 8
ranks) ``spec_for_shape`` keeps the head-wise leaves (q/k/i/f weights,
R, the recurrent states) whole while it still splits the channel-wise
ones (up, conv, gates, group norm scale, down / out): each rank then
gathers its channel shards before the recurrence, runs every head, and
keeps its channels of the normed output (``_mesh_heads``).

Speculative decoding: ``mlstm_block_verify`` / ``slstm_block_verify``
run a K-token window with the front end over the whole window and the
recurrence chained per token through the decode step's cell (an int8/fp8
C requantized at every step), ``verify_window`` runs them layer by
layer, and the draft views are the first n layers (the mLSTM/sLSTM
pattern is by layer index, so a prefix keeps it).
"""
from __future__ import annotations

import torch

from repro_torch.core import approx, state_quant
from repro_torch.kernels import megakernel, ops, ref
from repro_torch.models import blocks, mamba
from repro_torch.parallel import sharding


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C (dh x dh) per head
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg):
    di = 2 * cfg.d_model                 # pf = 2 up-projection
    return di, di // cfg.n_heads


def _mesh_heads(cfg, nh_local, width, full):
    """(the rank's head count, whether it gathers its channels) from its
    shard's shapes: ``nh_local`` heads over ``width`` of ``full``
    channels.  The heads split with their channels, or every head stays
    whole on a channel shard, which the rank gathers before the
    head-wise recurrence."""
    if width * cfg.n_heads == full * nh_local:
        return nh_local, False
    if nh_local != cfg.n_heads:
        raise ValueError(f"{nh_local} of {cfg.n_heads} xLSTM heads on "
                         f"{width} of {full} channels")
    return nh_local, True


def _head_norm(h, scale, nh, full):
    """The per-head group norm of h (b, L, nh*dh) with the rank's
    ``scale``: where the rank runs every head on a channel shard (the
    scale narrower than h), its channels of the normed h."""
    cols = None
    if scale.shape[-1] != h.shape[-1]:
        cols = sharding.local_range(full, "ffn")
    return blocks.group_norm(h, scale, nh, cols=cols)


def mlstm_block_axes(cfg):
    """Logical axes of ``mlstm_block_init``'s tree (``repro``
    xlstm.py:40-62)."""
    return {"norm": blocks.norm_axes(cfg),
            "up": blocks.dense_axes("embed", "ffn", parts=2),
            "conv_w": ("conv", "ffn"),
            "wq": ("heads", None, None), "wk": ("heads", None, None),
            "wi": ("heads", None), "wf": ("heads", None),
            "bi": ("heads",), "bf": ("heads",), "gn_scale": ("ffn",),
            "down": blocks.dense_axes("ffn", "embed")}


def mlstm_block_init(cfg, gen):
    d, nh = cfg.d_model, cfg.n_heads
    di, dh = _mlstm_dims(cfg)
    dev = gen.device

    def ph(*shape):
        return torch.randn(*shape, generator=gen, device=dev) * dh ** -0.5

    return {
        "norm": blocks.norm_init(cfg),
        "up": blocks.dense_init(gen, d, 2 * di),
        "conv_w": torch.randn(cfg.d_conv, di, generator=gen, device=dev)
        / cfg.d_conv,
        "wq": ph(nh, dh, dh),
        "wk": ph(nh, dh, dh),
        "wi": ph(nh, dh),
        "wf": ph(nh, dh),
        "bi": torch.zeros(nh),
        "bf": torch.full((nh,), 3.0),
        "gn_scale": torch.ones(di),
        "down": blocks.dense_init(gen, di, d),
    }


def _conv(cfg, u, w, conv_state, conv_impl):
    """The causal conv of the mLSTM front end (no bias): the conv kernel
    for "pallas", plain tensor code for "xla".  The f32 tail is handed
    over in u's dtype (lossless: it holds values of that dtype); the new
    tail comes back in u's dtype, contiguous."""
    impl = conv_impl or cfg.conv_impl
    x_prev = None if conv_state is None else conv_state.to(u.dtype)
    if impl == "xla":
        y, tail = ref.conv_math(u, w, None, x_prev=x_prev)
    else:
        y, tail = ops.causal_conv1d(u, w, None, x_prev=x_prev, impl=impl)
    return y, tail.contiguous()


def _mlstm_inputs(cfg, p, x, conv_state, conv_impl=None):
    """Block front end shared by apply (L = seq) and step (L = 1): norm ->
    up -> conv -> SiLU -> q, k, v and the gate pre-activations
    (``repro`` xlstm.py:110).  Also returns the gate g, the new conv tail
    and the conv input u, each over the rank's channels."""
    di, dh = _mlstm_dims(cfg)
    nh, gather = _mesh_heads(cfg, p["wq"].shape[0], p["conv_w"].shape[-1],
                             di)
    b, L, _ = x.shape
    silu = approx.get_silu(cfg.silu_impl)
    xn = blocks.apply_norm(cfg, p["norm"], x)
    ug = blocks.dense(p["up"], xn, x.dtype)
    u, g = ug.chunk(2, dim=-1)                           # (b, L, di) each
    c, new_conv = _conv(cfg, u, p["conv_w"], conv_state, conv_impl)
    ch, v = silu(c), u
    if gather:
        ch, v = (sharding.gather_cols(t, di, "ffn") for t in (ch, v))
    ch = ch.reshape(b, L, nh, dh)
    q = torch.einsum("blhd,hde->blhe", ch, p["wq"].to(x.dtype))
    k = torch.einsum("blhd,hde->blhe", ch, p["wk"].to(x.dtype))
    v = v.reshape(b, L, nh, dh)
    chf = ch.float()
    ig = torch.einsum("blhd,hd->blh", chf, p["wi"]) + p["bi"]
    fg = torch.einsum("blhd,hd->blh", chf, p["wf"]) + p["bf"]
    return q, k, v, ig, fg, g, new_conv, u


def _mlstm_scan(q, k, v, ig, fg, state, chunk):
    """The mLSTM recurrence over a sequence, one ``ref.mlstm_cell`` per
    token.  q, k, v (b, L, nh, dh); ig, fg (b, L, nh); state {C, n, m} f32.

    ``repro`` pads the sequence to a multiple of ``chunk`` with steps of
    q = k = v = 0, i = -1e30, f = 30 (xlstm.py:96): they leave C and n
    as they are and can move m by an ulp where |m| is tiny.  The port runs
    the same padding steps after the L true ones, so its state is
    ``repro``'s step for step.  Returns (h (b, L, nh, dh), new state)."""
    b, L, nh, dh = q.shape
    chunk = max(1, min(chunk, L))
    qf, kf, vf, igf, fgf = (t.float() for t in (q, k, v, ig, fg))
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(L):
        h, (C, n, m) = ref.mlstm_cell(C, n, m, qf[:, t], kf[:, t], vf[:, t],
                                      igf[:, t], fgf[:, t], dh)
        hs.append(h)
    pad = (-L) % chunk
    if pad:
        zero = qf.new_zeros(b, nh, dh)
        i_pad = qf.new_full((b, nh), -1e30)
        f_pad = qf.new_full((b, nh), 30.0)
        for _ in range(pad):
            _, (C, n, m) = ref.mlstm_cell(C, n, m, zero, zero, zero, i_pad,
                                          f_pad, dh)
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def read_state_C(cfg, state):
    """The stored matrix memory as f32: a cast, or for int8/fp8 codes a
    dequantization with the per-row scales in ``state["C_scale"]``."""
    if state_quant.is_quantized(cfg.state_dtype):
        return state_quant.dequantize_mat(state["C"], state["C_scale"])
    return state["C"].float()


def write_state_C(cfg, C, prev_state=None):
    """The {"C"} (+ "C_scale") leaves storing the f32 ``C``; only C is
    quantized (n, m and the conv tail are O(d) per slot and stay f32).
    ``prev_state`` gives the previous scales to the running absmax; None
    is a cold start (prefill)."""
    if state_quant.is_quantized(cfg.state_dtype):
        prev = None if prev_state is None else prev_state["C_scale"]
        q, scale = state_quant.quantize_mat(C, cfg.state_dtype,
                                            prev_scale=prev)
        return {"C": q, "C_scale": scale}
    return {"C": C.to(state_quant.storage_dtype(cfg.state_dtype))}


def mlstm_block_apply(cfg, p, x, state=None):
    """Full-sequence path; ``state`` a continuation or None (the init
    state).  Returns (y (b, L, d), new state)."""
    b = x.shape[0]
    conv_state = None if state is None else state["conv"]
    q, k, v, ig, fg, g, new_conv, _ = _mlstm_inputs(cfg, p, x, conv_state)
    if state is None:
        s0 = _mlstm_state(cfg, b, x.device, q.shape[2])
        rec = {"C": s0["C"], "n": s0["n"], "m": s0["m"]}
    else:
        rec = {"C": read_state_C(cfg, state), "n": state["n"],
               "m": state["m"]}
    h, new_rec = _mlstm_scan(q, k, v, ig, fg, rec, cfg.scan_chunk)
    out = _mlstm_out(cfg, p, h, g, x.dtype)
    new_state = write_state_C(cfg, new_rec["C"], prev_state=state)
    new_state.update({"n": new_rec["n"], "m": new_rec["m"],
                      "conv": new_conv})
    return out, new_state


def mlstm_block_step(cfg, p, x_t, state, conv_impl=None):
    """Single-token decode over the slot pool: the shared front end and
    one ``ref.mlstm_cell`` step.  ``h`` is contracted from the f32 C'
    before C' is requantized.  ``conv_impl`` overrides cfg.conv_impl (the
    plain K3 passes "xla", as ``repro``'s megakernel body does)."""
    _, dh = _mlstm_dims(cfg)
    q, k, v, ig, fg, g, new_conv, _ = _mlstm_inputs(
        cfg, p, x_t, state["conv"], conv_impl=conv_impl)
    h_t, (C_new, n_new, m_new) = ref.mlstm_cell(
        read_state_C(cfg, state), state["n"], state["m"], q[:, 0].float(),
        k[:, 0].float(), v[:, 0].float(), ig[:, 0], fg[:, 0], dh)
    out = _mlstm_out(cfg, p, h_t[:, None], g, x_t.dtype)
    new_state = write_state_C(cfg, C_new, prev_state=state)
    new_state.update({"n": n_new, "m": m_new,
                      "conv": new_conv.to(state["conv"].dtype)})
    return out, new_state


def mlstm_block_verify(cfg, p, x, state):
    """K-token verify window (``repro`` xlstm.py:222): K chained
    ``mlstm_block_step`` calls in meaning, with the front end (norm, up,
    one conv over the window with the tail passed in, q/k/v and the
    gates) over the whole window and the recurrence chained through the
    same ``ref.mlstm_cell``, C stored (requantized) after every step.
    Returns (out (b, K, d), states), each state leaf stacked per step on
    axis 1."""
    _, dh = _mlstm_dims(cfg)
    q, k, v, ig, fg, g, _, u = _mlstm_inputs(cfg, p, x, state["conv"])
    conv_all = mamba._conv_tail_states(state["conv"], u)
    st, hs, steps = state, [], []
    for t in range(x.shape[1]):
        h_t, (C, n, m) = ref.mlstm_cell(
            read_state_C(cfg, st), st["n"], st["m"], q[:, t].float(),
            k[:, t].float(), v[:, t].float(), ig[:, t], fg[:, t], dh)
        st = {**write_state_C(cfg, C, prev_state=st), "n": n, "m": m}
        hs.append(h_t)
        steps.append(st)
    out = _mlstm_out(cfg, p, torch.stack(hs, 1), g, x.dtype)
    states = {key: torch.stack([s[key] for s in steps], 1) for key in st}
    states["conv"] = conv_all
    return out, states


def _mlstm_out(cfg, p, h, g, dtype):
    """h (b, L, nh, dh) and the gate g (b, L, channels) -> the block
    output: the head norm, the SiLU gate, the down projection summed
    over the ranks."""
    b, L, nh, _ = h.shape
    di = _mlstm_dims(cfg)[0]
    silu = approx.get_silu(cfg.silu_impl)
    hf = _head_norm(h.reshape(b, L, -1), p["gn_scale"], nh, di)
    return blocks.dense_row(p["down"], hf * silu(g), dtype, di, "ffn")


def _mlstm_state(cfg, batch, device, nh=None):
    """The f32 init state of ``nh`` heads (all of them when None)."""
    nh = nh or cfg.n_heads
    _, dh = _mlstm_dims(cfg)
    di = nh * dh
    return {
        "C": torch.zeros(batch, nh, dh, dh, device=device),
        "n": torch.zeros(batch, nh, dh, device=device),
        "m": torch.full((batch, nh), -1e30, device=device),
        "conv": torch.zeros(batch, cfg.d_conv - 1, di, device=device),
    }


def mlstm_state_init(cfg, batch, device):
    """The init state in its storage dtypes (zero scales for an int8/fp8
    C: the first write sets real ones)."""
    s = _mlstm_state(cfg, batch, device)
    s["C"] = s["C"].to(state_quant.storage_dtype(cfg.state_dtype))
    if state_quant.is_quantized(cfg.state_dtype):
        _, dh = _mlstm_dims(cfg)
        s["C_scale"] = torch.zeros(batch, cfg.n_heads, dh, device=device)
    return s


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with a hidden-state recurrence
# ---------------------------------------------------------------------------

def mlstm_state_axes(cfg):
    """Logical axes of ``mlstm_state_init``'s leaves (``repro``
    xlstm.py:300-309)."""
    out = {"C": ("act_batch", "act_heads", None, None),
           "n": ("act_batch", "act_heads", None),
           "m": ("act_batch", "act_heads"),
           "conv": ("act_batch", None, "act_ffn")}
    if state_quant.is_quantized(cfg.state_dtype):
        out["C_scale"] = ("act_batch", "act_heads", None)
    return out


def slstm_block_axes(cfg):
    """Logical axes of ``slstm_block_init``'s tree (``repro``
    xlstm.py:318-336)."""
    return {"norm": blocks.norm_axes(cfg),
            "wx": blocks.dense_axes("embed", "ffn", parts=4),
            "r": (None, "heads", None, None),
            "b": sharding.fused(("ffn",), 4),
            "gn_scale": ("ffn",), "out": blocks.dense_axes("ffn", "embed")}


def _slstm_front(cfg, p, x):
    """norm -> the gate pre-activations (b, L, 4 * the rank's channels),
    and (nh, dh, p) for the recurrence: where the rank runs every head on
    a channel shard, the four gates' shards and the bias gathered whole
    (p then carries the whole bias)."""
    d = cfg.d_model
    nh, gather = _mesh_heads(cfg, p["r"].shape[1], p["gn_scale"].shape[0],
                             d)
    xn = blocks.apply_norm(cfg, p["norm"], x)
    gx = blocks.dense(p["wx"], xn, x.dtype)
    if gather:
        gx, bias = (sharding.gather_cols(t.unflatten(-1, (4, -1)), d,
                                         "ffn").flatten(-2)
                    for t in (gx, p["b"]))
        p = {**p, "b": bias}
    return gx, nh, d // cfg.n_heads, p


def _slstm_out(cfg, p, h, nh, dtype):
    """h (b, L, nh*dh) -> the head norm and the out projection summed
    over the ranks."""
    hf = _head_norm(h, p["gn_scale"], nh, cfg.d_model)
    return blocks.dense_row(p["out"], hf, dtype, cfg.d_model, "ffn")


def slstm_block_init(cfg, gen):
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    return {
        "norm": blocks.norm_init(cfg),
        "wx": blocks.dense_init(gen, d, 4 * d),
        "r": torch.randn(4, nh, dh, dh, generator=gen, device=gen.device)
        * d ** -0.5,
        "b": torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0),
                        torch.zeros(d)]),                # z, i, f, o
        "gn_scale": torch.ones(d),
        "out": blocks.dense_init(gen, d, d),
    }


def _slstm_gates(p, g_t, h, nh, dh):
    """The combined pre-activations (b, 4, nh, dh): input part + R h +
    bias, in that order (``repro`` xlstm.py:376)."""
    b = g_t.shape[0]
    rec = torch.einsum("gher,bhe->bghr", p["r"], h)
    return g_t.reshape(b, 4, nh, dh) + rec + p["b"].reshape(4, nh, dh)


def _slstm_scan(p, gates_x, state, nh, dh):
    """The sLSTM recurrence over a sequence, one ``ref.slstm_cell`` per
    token.  ``repro`` pads to scan_chunk and keeps the state through the
    padding steps with a 0/1 mask, which is exact: the port runs the L
    true steps only.  Returns (h (b, L, d), new state)."""
    b, L, _ = gates_x.shape
    gx = gates_x.float()
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(L):
        h, (c, n, m) = ref.slstm_cell(c, n, m,
                                      _slstm_gates(p, gx[:, t], h, nh, dh))
        hs.append(h)
    return (torch.stack(hs, dim=1).reshape(b, L, nh * dh),
            {"c": c, "n": n, "h": h, "m": m})


def slstm_block_apply(cfg, p, x, state=None):
    gates_x, nh, dh, p = _slstm_front(cfg, p, x)
    if state is None:
        state = slstm_state_init(cfg, x.shape[0], x.device, nh)
    h, new_state = _slstm_scan(p, gates_x, state, nh, dh)
    return _slstm_out(cfg, p, h, nh, x.dtype), new_state


def slstm_block_step(cfg, p, x_t, state):
    """Single-token decode: one gate recurrence step."""
    gx, nh, dh, p = _slstm_front(cfg, p, x_t)
    b = x_t.shape[0]
    h_new, (c_new, n_new, m_new) = ref.slstm_cell(
        state["c"], state["n"], state["m"],
        _slstm_gates(p, gx[:, 0].float(), state["h"], nh, dh))
    out = _slstm_out(cfg, p, h_new.reshape(b, 1, nh * dh), nh, x_t.dtype)
    return out, {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_block_verify(cfg, p, x, state):
    """K-token verify window (``repro`` xlstm.py:429): the gate inputs
    over the whole window, the hidden-state recurrence (R h_{t-1})
    chained per token.  Returns (out (b, K, d), states (c, n, h, m)
    stacked per step on axis 1)."""
    gx, nh, dh, p = _slstm_front(cfg, p, x)
    gx = gx.float()                                          # (b, K, 4d)
    b, K, _ = x.shape
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    steps = []
    for t in range(K):
        h, (c, n, m) = ref.slstm_cell(c, n, m,
                                      _slstm_gates(p, gx[:, t], h, nh, dh))
        steps.append({"c": c, "n": n, "h": h, "m": m})
    states = {key: torch.stack([s[key] for s in steps], 1)
              for key in steps[0]}
    return (_slstm_out(cfg, p, states["h"].reshape(b, K, nh * dh), nh,
                       x.dtype), states)


def slstm_state_init(cfg, batch, device, nh=None):
    """The init state of ``nh`` heads (all of them when None)."""
    dh = cfg.d_model // cfg.n_heads
    nh = nh or cfg.n_heads
    return {"c": torch.zeros(batch, nh, dh, device=device),
            "n": torch.zeros(batch, nh, dh, device=device),
            "h": torch.zeros(batch, nh, dh, device=device),
            "m": torch.full((batch, nh, dh), -1e30, device=device)}


# ---------------------------------------------------------------------------
# Full model: mLSTM and sLSTM interleaved (7:1 at xlstm-350m)
# ---------------------------------------------------------------------------

def _is_slstm(cfg, i):
    return (cfg.slstm_every > 0
            and i % cfg.slstm_every == cfg.slstm_offset % cfg.slstm_every)


def _kind(cfg, i):
    return "slstm" if _is_slstm(cfg, i) else "mlstm"


def slstm_state_axes(cfg):
    """Logical axes of ``slstm_state_init``'s leaves (``repro``
    xlstm.py:469)."""
    return {k: ("act_batch", "act_heads", None) for k in ("c", "n", "h", "m")}


def param_axes(cfg):
    """Logical axes of ``init``'s tree (``repro``'s)."""
    return {"embed": blocks.embed_axes(cfg),
            "layers": [{_kind(cfg, i): (slstm_block_axes if _is_slstm(cfg, i)
                                        else mlstm_block_axes)(cfg)}
                       for i in range(cfg.n_layers)],
            "norm_f": blocks.norm_axes(cfg),
            "unembed": blocks.unembed_axes(cfg)}


def cache_axes(cfg):
    """Logical axes of ``init_cache``'s leaves (``repro``'s)."""
    return {"layers": [{_kind(cfg, i): (slstm_state_axes if _is_slstm(cfg, i)
                                        else mlstm_state_axes)(cfg)}
                       for i in range(cfg.n_layers)],
            "pos": ("act_batch",)}


def init(cfg, gen):
    """Parameters from a ``torch.Generator``, drawn on its device."""
    layers = [{_kind(cfg, i): (slstm_block_init if _is_slstm(cfg, i)
                               else mlstm_block_init)(cfg, gen)}
              for i in range(cfg.n_layers)]
    return {"embed": blocks.embed_init(cfg, gen), "layers": layers,
            "norm_f": blocks.norm_init(cfg),
            "unembed": blocks.unembed_init(cfg, gen)}


def _block_apply(cfg, lp, x, state=None):
    if "slstm" in lp:
        y, ns = slstm_block_apply(cfg, lp["slstm"], x, state=state)
        return x + y, {"slstm": ns}
    y, ns = mlstm_block_apply(cfg, lp["mlstm"], x, state=state)
    return x + y, {"mlstm": ns}


def _logits(cfg, p, h):
    h = blocks.apply_norm(cfg, p["norm_f"], h)
    return blocks.unembed_apply(cfg, p.get("unembed", {}), p["embed"], h)


def forward(cfg, p, batch):
    h = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    for lp in p["layers"]:
        h, _ = _block_apply(cfg, lp, h)
    return _logits(cfg, p, h), {}


def init_cache(cfg, batch, max_seq, dtype, device):
    """One state dict per layer (xLSTM's state does not grow with the
    sequence: ``max_seq`` and ``dtype`` are not read)."""
    return {"layers": [
        {"slstm": slstm_state_init(cfg, batch, device)} if _is_slstm(cfg, i)
        else {"mlstm": mlstm_state_init(cfg, batch, device)}
        for i in range(cfg.n_layers)],
        "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def cache_slot_axes(cfg):
    """Batch/slot axis index per cache leaf (layout matches init_cache):
    every xLSTM state leaf is slot-leading."""
    mlstm_keys = ["C", "n", "m", "conv"]
    if state_quant.is_quantized(cfg.state_dtype):
        mlstm_keys.append("C_scale")
    return {"layers": [
        {"slstm": {k: 0 for k in ("c", "n", "h", "m")}} if _is_slstm(cfg, i)
        else {"mlstm": {k: 0 for k in mlstm_keys}}
        for i in range(cfg.n_layers)], "pos": 0}


def prefill(cfg, p, cache, batch):
    """Full-sequence forward from the init state that returns the decode
    cache (pos = the prompt length)."""
    tokens = batch["tokens"]
    h = blocks.embed_apply(cfg, p["embed"], tokens, _dtype(cfg))
    layers = []
    for lp in p["layers"]:
        h, ns = _block_apply(cfg, lp, h)
        layers.append(ns)
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    return _logits(cfg, p, h), {"layers": layers, "pos": pos}


def _kind_runs(cfg):
    """Maximal runs of consecutive same-kind layers, each one K3 launch
    (``repro`` xlstm.py:558): ((kind, (layer, ...)), ...)."""
    runs = []
    for i in range(cfg.n_layers):
        kind = _kind(cfg, i)
        if runs and runs[-1][0] == kind:
            runs[-1][1].append(i)
        else:
            runs.append((kind, [i]))
    return tuple((kind, tuple(run)) for kind, run in runs)


def stack_params(cfg, params):
    """``params`` with K3's view of the decode weights under ``"stack"``:
    one ``megakernel.XlstmRun`` per run of ``_kind_runs``, in order.  Built
    once per engine (``registry.stack_params``); no weight is copied."""
    return {**params, "stack": [
        megakernel.XlstmRun(cfg, kind,
                            [params["layers"][i][kind] for i in run])
        for kind, run in _kind_runs(cfg)]}


def stacked_step(cfg, p, cache, batch):
    """Single-token decode with each same-kind run of layers as ONE
    launch of K3's xLSTM instance (``repro`` xlstm.py:575); embed, the
    final norm and the unembed stay in PyTorch.  K3 writes the new
    states into fresh leaves, one pointer per layer and state tensor."""
    if "stack" not in p:
        raise ValueError(
            "step_impl='megakernel' decodes from the stacked runs: build "
            "them once with registry.stack_params(cfg, params)")
    x = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    layers = cache["layers"]
    new = [None] * cfg.n_layers
    for (kind, run), xrun in zip(_kind_runs(cfg), p["stack"]):
        states = [layers[i][kind] for i in run]
        outs = [{k: torch.empty_like(v) for k, v in st.items()}
                for st in states]
        x = megakernel.xlstm_stacked_run(cfg, x, xrun, states, outs)
        for i, out in zip(run, outs):
            new[i] = {kind: out}
    return _logits(cfg, p, x), {"layers": new, "pos": cache["pos"] + 1}


def decode_step(cfg, p, cache, batch):
    """One token for every slot: (logits (b, 1, V), new cache).
    "megakernel" routes to ``stacked_step``; every other step_impl takes
    the per-layer single-step functions (``repro`` xlstm.py:623)."""
    if ops.resolve_step_impl(cfg.step_impl,
                             batch["tokens"].device) == "megakernel":
        return stacked_step(cfg, p, cache, batch)
    h = blocks.embed_apply(cfg, p["embed"], batch["tokens"], _dtype(cfg))
    layers = []
    for lp, lc in zip(p["layers"], cache["layers"]):
        if "slstm" in lp:
            y, ns = slstm_block_step(cfg, lp["slstm"], h, lc["slstm"])
            layers.append({"slstm": ns})
        else:
            y, ns = mlstm_block_step(cfg, lp["mlstm"], h, lc["mlstm"])
            layers.append({"mlstm": ns})
        h = h + y
    return _logits(cfg, p, h), {"layers": layers, "pos": cache["pos"] + 1}


def verify_window(cfg, p, cache, tokens):
    """The speculative verify over a K-token window (``repro``
    xlstm.py:657): each layer's block verify in turn.  Returns (logits
    (b, K, V), caches), the cache tree with a leading per-step axis."""
    K = tokens.shape[1]
    x = blocks.embed_apply(cfg, p["embed"], tokens, _dtype(cfg))
    layers = []
    for lp, lc in zip(p["layers"], cache["layers"]):
        kind = "slstm" if "slstm" in lp else "mlstm"
        fn = slstm_block_verify if kind == "slstm" else mlstm_block_verify
        y, states = fn(cfg, lp[kind], x, lc[kind])
        layers.append({kind: {k: v.movedim(1, 0) for k, v in states.items()}})
        x = x + y
    pos = (cache["pos"][None, :]
           + torch.arange(1, K + 1, dtype=torch.int32,
                          device=tokens.device)[:, None])
    return _logits(cfg, p, x), {"layers": layers, "pos": pos}


# ---------------------------------------------------------------------------
# Self-speculative draft views (``repro`` xlstm.py:545): the first n
# layers, a list slice.  A megakernel draft builds its own K3 runs over
# them (``stack_params`` on the draft's config), once.
# ---------------------------------------------------------------------------

def draft_params(cfg, p, n):
    out = {k: v for k, v in p.items() if k != "stack"}
    out["layers"] = p["layers"][:n]
    return out


def draft_cache(cfg, cache, n):
    return {"layers": cache["layers"][:n], "pos": cache["pos"]}


def draft_cache_merge(cfg, full, sub, n):
    return {"layers": list(sub["layers"]) + list(full["layers"][n:]),
            "pos": sub["pos"]}
