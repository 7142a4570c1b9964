"""Speculative decoding over the slot state pool: the port of
``repro/runtime/spec_decode.py``.

An SSM's whole decode state is a fixed block per layer and slot, so a
draft fork is one gather and scatter of pool rows and a rollback one
per-slot select: no tree attention and no ragged KV bookkeeping.  One
speculative pass over the live slots:

1. FORK: lease one scratch slot per live slot and fork its state and
   sampling params into it (``SlotStatePool.fork``).
2. DRAFT: k decode steps of the self-speculative draft (the target's
   first ``DraftConfig.layers`` layers) over the pool with every row but
   the scratch rows frozen, each proposal sampled with its slot's own
   params at its slot's stream position.  A megakernel config drafts
   through K3 on a view of the first n layers, built once here.
3. VERIFY: one batched target window over [pending token, draft_1 ..
   draft_k] (``registry.verify_scan``): per layer one conv launch over
   the window and k+1 chained decode-step launches, every step's cache
   kept.
4. ACCEPT: per-slot acceptance (``accept_tokens_hetero``): a greedy slot
   accepts while the draft equals the target's argmax and then emits the
   target's own token; a sampled slot accepts with probability
   min(1, p_t / p_d) on its filtered distributions and resamples the
   residual at the first rejection.
5. ROLLBACK: a per-slot select of the cache after each slot's accepted
   prefix (``registry.select_step``).

Greedy streams equal plain greedy decoding up to ties only: the window's
(b, k+1, d) products need not give each row the bits of the (b, 1, d)
products a decode step makes (``repro``'s claim of bitwise identity
rests on XLA, not on PyTorch), and under a megakernel config plain
decoding runs K3, whose sums run in another order.  A token may differ
only where the reference's top two logits are within the stated
tolerance.  The draws are ``torch.Generator`` streams, not ``repro``'s
threefry keys, so sampled streams are held within the port.

The device work of a pass chains from the fork to the rollback; the
host reads the result once a pass.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.runtime import sampling


@dataclasses.dataclass(frozen=True)
class DraftConfig:
    """Self-speculative draft settings (``EngineConfig.draft``).

    k: tokens proposed per target pass; a pass emits 1 to k+1 tokens.
    layers: draft depth in model layers; 0 is full depth (the draft is
       the target and accepts every proposal but at ties).  Jamba takes
       a multiple of its group period.
    step_impl: the draft's step routing, None for the target's.
    adaptive: after ``adapt_warmup`` passes, clamp each slot's window to
       its realized acceptance (ceil(accepted / passes) + 1, at least 1);
       window lengths change, token values do not.
    """
    k: int = 4
    layers: int = 0
    step_impl: Optional[str] = None
    adaptive: bool = False
    adapt_warmup: int = 2


def default_shallow_layers(cfg) -> int:
    """A half-depth draft at the family's granularity: jamba drafts whole
    groups (one group deep: full depth), the others any layer prefix."""
    if cfg.family == "jamba":
        period = cfg.attn_every or 8
        return max(1, cfg.n_layers // period // 2) * period
    return max(1, cfg.n_layers // 2)


# ---------------------------------------------------------------------------
# Acceptance
# ---------------------------------------------------------------------------

def _generators(rows, sp, step, tag, device):
    """One generator per sampled row, seeded from the row's (seed, stream
    position, tag)."""
    gens = []
    for r in rows:
        gen = torch.Generator(device=device)
        gen.manual_seed(sampling.fold_tag(sp["seed"][r], step[r], tag))
        gens.append(gen)
    return gens


def accept_tokens_hetero(draft_toks, target_logits, draft_logits, sp, step,
                         depth_limit):
    """Per-slot speculative acceptance over one window.

    draft_toks (K, b) int64 proposals; target_logits (K+1, b, V) the
    verify's; draft_logits (K, b, V) the draft's (read for sampled rows
    only); ``sp`` host arrays of b rows (``SlotParams.rows``); ``step``
    (b,) host ints, each row's stream position at the pass's start;
    ``depth_limit`` (b,) the most drafts a row may accept.

    Returns (emit (K+1, b), n_acc (b,), pending (b,)) on the logits'
    device: row s emits emit[:n_acc[s] + 1, s], and pending[s] =
    emit[n_acc[s], s] is the token whose state update is not applied
    yet.  Greedy rows emit the target's argmax stream; an all-greedy
    window costs one argmax and no host sync.  A sampled row accepts
    draft i when u_i < p_t / p_d on its own filtered, scaled
    distributions (``sampling.sample_dist``), draws the residual
    max(p_t - p_d, 0) at the first rejection and a bonus token from the
    target after a full acceptance, from streams tagged 1, 2 and 3
    (``sampling.fold_tag``), so the emitted marginal is the target's
    sampling distribution."""
    K, b = draft_toks.shape
    dev = target_logits.device
    tgt = torch.argmax(target_logits.float(), dim=-1)            # (K+1, b)
    emit, ok = tgt, draft_toks == tgt[:K]
    rows = np.flatnonzero(sp["temperature"] > 0)
    if rows.size:
        idx = torch.as_tensor(rows, device=dev)
        r, V = rows.size, target_logits.shape[-1]
        knobs = {f: sp[f][rows] for f in ("temperature", "top_k", "top_p")}
        tiled = {f: np.tile(v, K) for f, v in knobs.items()}

        def logp(lg):                                      # (K, r, V)
            return torch.log_softmax(sampling.sample_dist(
                lg[:, idx].reshape(K * r, V), tiled), -1).reshape(K, r, V)

        logp_t, logp_d = logp(target_logits[:K]), logp(draft_logits)
        d = draft_toks[:, idx]                                    # (K, r)
        ratio = (logp_t.gather(-1, d[..., None])
                 - logp_d.gather(-1, d[..., None]))[..., 0]
        u = torch.stack([torch.rand(K, generator=g, device=dev)
                         for g in _generators(rows, sp, step, 1, dev)], -1)
        ok_s = torch.log(u.clamp_min(1e-20)) < ratio
        res = (logp_t.exp() - logp_d.exp()).clamp_min(0.0)
        norm = res.sum(-1, keepdim=True)
        safe = torch.where(norm > 0, res / norm.clamp_min(1e-30),
                           logp_t.exp())
        corr = torch.stack([
            torch.multinomial(safe[:, j], 1, generator=g)[:, 0]
            for j, g in enumerate(_generators(rows, sp, step, 2, dev))], -1)
        bonus_p = torch.softmax(sampling.sample_dist(target_logits[K, idx],
                                                     knobs), -1)
        bonus = torch.stack([
            torch.multinomial(bonus_p[j], 1, generator=g)[0]
            for j, g in enumerate(_generators(rows, sp, step, 3, dev))])
        emit, ok = emit.clone(), ok.clone()
        emit[:, idx] = torch.cat([torch.where(ok_s, d, corr), bonus[None]])
        ok[:, idx] = ok_s
    acc = torch.cumprod(ok.to(torch.int64), dim=0)
    n_acc = torch.minimum(acc.sum(0), torch.as_tensor(depth_limit,
                                                      device=dev))
    pending = emit.gather(0, n_acc[None])[0]
    return emit, n_acc, pending


def accept_tokens(draft_toks, target_logits, temperature: float,
                  draft_logits=None, seed: Optional[int] = None):
    """Scalar-parameter acceptance (a reference entry; the engine calls
    ``accept_tokens_hetero`` with per-slot params).  Temperature 0 is
    the greedy rule; a positive one gives every row that temperature, no
    top-k or top-p, the seed ``seed`` and stream position = its row
    index, so the rows draw from distinct streams."""
    K, b = draft_toks.shape
    if temperature > 0 and (draft_logits is None or seed is None):
        raise ValueError("sampled acceptance needs draft_logits and seed")
    sp = {"temperature": np.full((b,), max(temperature, 0.0), np.float32),
          "top_k": np.zeros((b,), np.int64),
          "top_p": np.ones((b,), np.float32),
          "seed": np.full((b,), seed or 0, np.int64)}
    return accept_tokens_hetero(draft_toks, target_logits, draft_logits, sp,
                                np.arange(b), np.full((b,), K))


# ---------------------------------------------------------------------------
# The draft and verify passes
# ---------------------------------------------------------------------------

class SpecDecoder:
    """One engine's speculative decoder: the draft's config and param view
    (and, for a megakernel draft, its K3 view, built here once), and the
    propose / verify halves of a pass."""

    def __init__(self, cfg, params, draft: DraftConfig, device):
        if draft.k < 1:
            raise ValueError("draft.k must be >= 1")
        n = draft.layers or cfg.n_layers
        dcfg = registry.draft_config(cfg, n)
        if draft.step_impl is not None:
            dcfg = dataclasses.replace(dcfg, step_impl=draft.step_impl)
        self.cfg, self.dcfg = cfg, dcfg
        self.k = draft.k
        self.n_draft = n
        self.full = n == cfg.n_layers
        self.draft_params = (params if self.full else
                             registry.draft_params(cfg, params, n))
        if (ops.resolve_step_impl(dcfg.step_impl, device) == "megakernel"
                and "stack" not in self.draft_params):
            # the draft's K3 view of its layers, built once; a full-depth
            # draft reuses the target's
            self.draft_params = registry.stack_params(dcfg,
                                                      self.draft_params)

    def propose(self, cache, toks, scratch_mask, sp, base_step, k_eff: int):
        """``k_eff`` (<= k) draft steps over the pool.  ``toks`` (total, 1)
        holds the forked slots' pending tokens at their scratch rows;
        ``scratch_mask`` (total,) bool keeps every other row frozen; ``sp``
        and ``base_step`` are the pool rows' params and stream positions
        (a scratch row mirrors its live slot's, so proposal i draws what
        plain decoding would draw at position base + i).  Returns (cache,
        draft tokens (k_eff, total), draft logits (k_eff, total, V)),
        indexed by pool row and left on the device."""
        mask = torch.as_tensor(scratch_mask, device=toks.device)
        # only the scratch rows' proposals are read: sample the others
        # greedily rather than draw for them
        sp = {**sp, "temperature": np.where(scratch_mask,
                                            sp["temperature"], 0.0)}
        d_toks, d_logits = [], []
        for i in range(k_eff):
            sub = (cache if self.full else
                   registry.draft_cache(self.cfg, cache, self.n_draft))
            logits, new = registry.decode_step(self.dcfg, self.draft_params,
                                               sub, {"tokens": toks})
            new = registry.mask_slots(self.dcfg, sub, new, mask)
            cache = (new if self.full else registry.draft_cache_merge(
                self.cfg, cache, new, self.n_draft))
            last = logits[:, -1]
            tok = sampling.sample(last, sp, base_step + i)
            toks = tok[:, None]
            d_toks.append(tok)
            d_logits.append(last)
        return cache, torch.stack(d_toks), torch.stack(d_logits)

    def verify(self, params, cache, x0, draft_toks, draft_logits, active,
               sp, step, depth_limit):
        """One batched target window, the acceptance and the rollback.
        x0 (total, 1) the pending tokens; draft_toks (K, total) and
        draft_logits (K, total, V) at the live slots' rows; ``active``
        (total,) bool.  Returns (emit (K+1, total), n_acc (total,),
        pending (total,), the rolled-back cache, chosen logprobs
        (K+1, total), top-logprob values and ids (K+1, total, TOP)), on
        the device.  The rollback selects each slot's step and freezes
        the inactive slots: the same cache as ``select_step`` over
        ``verify_scan`` with ``active``, without a frozen copy of every
        step."""
        inputs = torch.cat([x0, draft_toks.T], dim=1)            # (b, K+1)
        logits, caches = registry.verify_scan(self.cfg, params, cache,
                                              inputs)
        tl = logits.movedim(1, 0)                                # (K+1, b, V)
        emit, n_acc, pending = accept_tokens_hetero(
            draft_toks, tl, draft_logits, sp, step, depth_limit)
        snap = registry.mask_slots(
            self.cfg, cache, registry.select_step(self.cfg, caches, n_acc),
            torch.as_tensor(active, device=x0.device))
        del caches
        K1, b, V = tl.shape
        lp, tv, ti = sampling.token_logprobs(tl.reshape(K1 * b, V),
                                             emit.reshape(-1))
        return (emit, n_acc, pending, snap, lp.reshape(K1, b),
                tv.reshape(K1, b, -1), ti.reshape(K1, b, -1))
