"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): top-k router
with capacity and the dense scatter/gather dispatch.

The routing is ``repro``'s, step for step: f32 router logits (padded
experts forced out), softmax, top-k, renormalized gates (``norm_topk``),
token-major slot positions by a cumulative count per expert, overflow
assignments dropped (they scatter zeros into slot 0 and are masked off
at the combine), gate x keep, and the load-balance and z aux losses.
The expert GEMMs are ``torch.matmul`` over the (E, capacity, d) buckets,
as ``repro`` leaves them to XLA, with the expert weights cast to the
compute dtype per call as there.

``moe_impl="ep"`` (the shard_map all-to-all dispatch) waits for the
port of parallel serving (ROADMAP A13) and raises; "auto" finds no mesh
here and takes the dense dispatch, as ``repro`` does without one.
"""
from __future__ import annotations

import torch

from repro_torch.core import approx
from repro_torch.models import blocks


def _e_padded(cfg):
    return max(cfg.expert_pad_to, cfg.n_experts)


def moe_init(cfg, gen, d_ff=None):
    d, E = cfg.d_model, _e_padded(cfg)
    f = d_ff or cfg.d_ff
    sc = d ** -0.5

    def ew(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device) * sc

    p = {"router": blocks.dense_init(gen, d, E),
         "w1": ew(E, d, f), "w3": ew(E, d, f), "w2": ew(E, f, d)}
    if cfg.n_shared_experts:
        p["shared"] = blocks.mlp_init(cfg, gen,
                                      d_ff=cfg.n_shared_experts * f)
    return p


def _capacity(cfg, n_tokens):
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor
              // max(cfg.n_experts, 1))
    return max(cap, cfg.top_k, 1)


def moe_apply(cfg, p, x):
    """x (b, s, d) -> (y (b, s, d), aux dict with the load-balance and
    router z losses), ``repro/models/moe.py:50`` with the dense dispatch."""
    if cfg.moe_impl == "ep":
        raise NotImplementedError(
            "moe_impl='ep' (expert-parallel all-to-all) is not ported to "
            "repro_torch yet (ROADMAP A13)")
    if cfg.moe_impl not in ("auto", "dense"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    silu = approx.get_silu(cfg.silu_impl)
    b, s, d = x.shape
    E, k = _e_padded(cfg), cfg.top_k
    T = b * s
    cap = _capacity(cfg, T)
    xf = x.reshape(T, d)

    logits = blocks.dense(p["router"], xf.float(), torch.float32)
    if E > cfg.n_experts:
        # padded experts are inert: forced out of the top-k
        pad = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad[None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                  # (T, k)
    if cfg.norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # aux losses (GShard/Switch load balance + router z-loss)
    experts = torch.arange(E, device=x.device)
    me = probs.mean(0)
    assign = (idx[:, :1] == experts).float().mean(0)
    aux = {"moe_lb": cfg.n_experts * torch.sum(me * assign)
           * cfg.router_aux_coef,
           "moe_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
           * cfg.router_z_coef}

    # capacity-based dispatch: position = rank within the expert, in
    # token-major order
    e_flat = idx.reshape(-1)                                  # (T*k,)
    onehot = (e_flat[:, None] == experts).long()             # (T*k, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, e_flat * cap + pos, torch.zeros_like(pos))
    xrep = xf.repeat_interleave(k, dim=0)                     # (T*k, d)
    buckets = torch.zeros(E * cap, d, dtype=x.dtype, device=x.device)
    buckets.index_add_(0, slot, torch.where(keep[:, None], xrep,
                                            torch.zeros_like(xrep)))
    buckets = buckets.reshape(E, cap, d)

    # the experts: a batched swiglu
    cdt = x.dtype
    h = silu(torch.bmm(buckets, p["w1"].to(cdt)))
    h = h * torch.bmm(buckets, p["w3"].to(cdt))
    y_flat = torch.bmm(h, p["w2"].to(cdt)).reshape(E * cap, d)

    # combine: gather back, weight by the gate, sum over the k choices
    gflat = (gate.reshape(-1) * keep).to(cdt)
    y = (y_flat[slot] * gflat[:, None]).reshape(T, k, d).sum(1)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + blocks.mlp_apply(cfg, p["shared"], x)
    return y, aux
