"""Continuous-batching serving engine over the slot pool (port of
``repro/runtime/engine.py``).

Request lifecycle: submit(prompt, SamplingParams) -> [pending until
arrival] -> ready queue (highest priority first, FIFO within one) ->
exact-length prefill into a free slot, first token sampled -> pooled
decode bursts with inactive slots masked -> stop id / stop sequence /
max_new (or cancel()) -> evict.  ``stream_cb(req, new_tokens)`` gets
each request's new tokens at every host sync.

Each decode burst runs to the next certain scheduling event (the
shortest remaining budget), capped by ``sched_quantum`` only when an
uncertain event could act sooner (a stop id, a stream callback, a free
slot with queued work).  Tokens chain on the device through the burst
and the host syncs once at its end.  PyTorch runs eagerly, so there is
no compile to share between engines.

``weight_dtype="int8"`` quantizes the handed-in f32 tree for decode
(the decode-bandwidth lever) and keeps the f32 tree as the prefill
master (``prefill_params``), as ``repro``'s engine does; both live on
the device (a jamba tree shares its MoE experts, which stay f32,
between the two).  ``state_dtype`` "int8"/"fp8" stores the pooled state
as codes with f32 group scales, ``kv_cache_dtype="int8"`` jamba's KV
strips as codes with per-position scales.  The engine touches the cache
only through the registry's slot operations, which walk any nested
cache tree.

``step_impl="megakernel"`` (and "auto" on the card) decodes each token
of the pool with one launch of the cross-layer kernel K3; the engine
builds K3's stacked view of the decode weights once, when it is made
(``registry.stack_params``).  "fused" (and "auto" on the CPU) runs the
per-layer conv and step kernels.

Speculative decoding (``EngineConfig.draft``, ``runtime/spec_decode.py``)
makes each scheduler iteration one fork -> k-token draft -> batched
verify -> rollback pass in place of a decode burst: the pool gains one
scratch slot per live slot, and a pass emits 1 to k+1 tokens a slot
with one host sync.  ``Request.spec_passes`` / ``spec_accepted`` and
``ServeStats`` count the passes and the accepted drafts; ``spec_cap``
clamps every slot's window.

Not ported yet (ROADMAP A7, A8b, A13): the prefix cache, tensor-parallel
serving (``mesh``), best-of-n (``n > 1``) and infinite-stream sessions.
The first three raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import weight_quant
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.runtime import metrics as metrics_lib
from repro_torch.runtime import sampling
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_decode import DraftConfig, SpecDecoder
from repro_torch.runtime.state_pool import SlotStatePool


def derive_seed(engine_seed: int, req_id: int) -> int:
    """Per-request seed for unseeded requests (as repro's)."""
    return (engine_seed * 1_000_003 + req_id) & 0x7FFFFFFF


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    max_seq: int = 256
    # derives per-request seeds for requests whose SamplingParams.seed
    # is None
    seed: int = 0
    default_params: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # max decode steps per burst when an uncertain event could act
    # sooner than the next certain eviction
    sched_quantum: int = 8
    # overrides of the model config (None keeps cfg's setting):
    # step_impl megakernel (auto on the card) | fused | pallas | xla
    # (fused, pallas and xla run the per-layer step kernel; so does auto
    # on the CPU); state_dtype "f32" | "bf16" | "int8" | "fp8";
    # weight_dtype "f32" | "int8" (int8 quantizes the handed-in f32 tree
    # for decode); kv_cache_dtype "model" | "int8" (jamba's attention KV
    # strips: state_dtype covers the recurrent blocks, this the strips)
    step_impl: Optional[str] = None
    state_dtype: Optional[str] = None
    weight_dtype: Optional[str] = None
    kv_cache_dtype: Optional[str] = None
    # speculative decoding: None for plain decode bursts; a DraftConfig
    # makes every decode iteration one fork -> draft -> verify ->
    # rollback pass, and the pool gains n_slots scratch slots
    draft: Optional[DraftConfig] = None
    # not ported yet: must stay None
    prefix_cache: Optional[object] = None
    mesh: Optional[object] = None
    # where the engine runs: "cuda" unless the caller asks for "cpu"
    device: str = "cuda"


@dataclasses.dataclass
class Request:
    """One generation request; the engine fills tokens and timings."""
    req_id: int
    prompt: np.ndarray                    # (Lp,) int32
    params: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    seed: int = 0                         # resolved per-request seed
    max_new: int = 32                     # mirrors params.max_new
    stop_ids: frozenset = frozenset()     # params.stop (+ eos_id)
    eos_id: Optional[int] = None
    priority: int = 0                     # higher admits earlier
    stream_cb: Optional[Callable] = None  # (req, new_tokens) per sync
    cancelled: bool = False
    arrival: float = 0.0                  # offset (s) from run() start
    tenant: Optional[str] = None
    tokens: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    logprobs: list = dataclasses.field(default_factory=list)
    top_logprobs: list = dataclasses.field(default_factory=list)
    cum_logprob: float = 0.0
    # speculative decoding: target passes this request's slot took and
    # drafts it accepted (drives DraftConfig.adaptive)
    spec_passes: int = 0
    spec_accepted: int = 0

    @property
    def finished(self) -> bool:
        return self.t_done is not None


class Engine:
    def __init__(self, cfg, params, ecfg: EngineConfig,
                 logger: Optional[metrics_lib.MetricsLogger] = None,
                 clock: Callable[[], float] = time.perf_counter):
        for name in ("prefix_cache", "mesh"):
            if getattr(ecfg, name) is not None:
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported to repro_torch yet "
                    "(ROADMAP A7/A13)")
        if ecfg.step_impl is not None:
            cfg = dataclasses.replace(cfg, step_impl=ecfg.step_impl)
        if ecfg.state_dtype is not None:
            cfg = dataclasses.replace(cfg, state_dtype=ecfg.state_dtype)
        if ecfg.kv_cache_dtype is not None:
            cfg = dataclasses.replace(cfg,
                                      kv_cache_dtype=ecfg.kv_cache_dtype)
        ecfg.default_params.validate()
        self.device = resolve_device(ecfg.device)
        stack = ops.resolve_step_impl(cfg.step_impl,
                                      self.device) == "megakernel"
        prefill_params = params
        if ecfg.weight_dtype is not None:
            already = weight_quant.is_quantized(cfg.weight_dtype)
            cfg = dataclasses.replace(cfg, weight_dtype=ecfg.weight_dtype)
            if weight_quant.is_quantized(cfg.weight_dtype) and not already:
                # decode streams the int8 tree; the compute-bound prefill
                # stays exact on the caller's f32 master (a tree handed
                # in already quantized has no master: prefill then
                # dequantizes its codes)
                params = registry.quantize_params(cfg, params)
        self.cfg = cfg
        self.params = registry.tree_to(params, self.device)
        self.prefill_params = (self.params if prefill_params is params
                               else registry.tree_to(prefill_params,
                                                     self.device))
        if stack:
            # K3's view of the decode layers: built once, here
            self.params = registry.stack_params(cfg, self.params)
        self.ecfg = ecfg
        # one scratch slot per live slot: every live slot forks a draft
        # in the same speculative pass
        self.pool = SlotStatePool(
            cfg, ecfg.n_slots, ecfg.max_seq, device=self.device,
            n_scratch=ecfg.n_slots if ecfg.draft is not None else 0)
        self._spec = (SpecDecoder(cfg, self.params, ecfg.draft, self.device)
                      if ecfg.draft is not None else None)
        # the scheduler's degradation knob: clamps every slot's window
        self.spec_cap: Optional[int] = None
        self.stats = metrics_lib.ServeStats()
        self.logger = logger
        self._now = clock
        self._pending: list[Request] = []      # arrival-gated, sorted
        self._ready: list[tuple] = []          # (-priority, seq, Request)
        self._seq = 0
        self._by_id: dict[int, Request] = {}
        self._cancel_dirty = False
        self._slot_req: list[Optional[Request]] = [None] * ecfg.n_slots
        self._next_tok = np.zeros((self.pool.n_total, 1), np.int64)
        self._finished: list[Request] = []
        self._next_id = 0

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               max_new: Optional[int] = None,
               eos_id: Optional[int] = None,
               arrival: Optional[float] = None,
               priority: int = 0,
               stream_cb: Optional[Callable] = None,
               tenant: Optional[str] = None) -> Request:
        """Enqueue a request (``repro``'s ``Engine.submit`` without
        sessions).  ``max_new`` overrides params.max_new and ``eos_id``
        extends params.stop; ``arrival`` (s from run() start) gates
        admission; higher ``priority`` admits earlier."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        params = params if params is not None else self.ecfg.default_params
        if max_new is not None:
            params = dataclasses.replace(params, max_new=max_new)
        if eos_id is not None:
            params = dataclasses.replace(
                params, stop=tuple(params.stop) + (eos_id,))
        params.validate()
        if params.n > 1:
            raise NotImplementedError(
                "best-of-n (n > 1) is not ported to repro_torch yet "
                "(ROADMAP A8)")
        if prompt.size + params.max_new > self.ecfg.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({params.max_new}) "
                f"exceeds max_seq ({self.ecfg.max_seq})")
        req_id = self._next_id
        self._next_id += 1
        seed = (params.seed if params.seed is not None
                else derive_seed(self.ecfg.seed, req_id))
        req = Request(req_id=req_id, prompt=prompt, params=params,
                      seed=seed, max_new=params.max_new,
                      stop_ids=frozenset(params.stop), eos_id=eos_id,
                      priority=priority, stream_cb=stream_cb,
                      arrival=arrival or 0.0, t_submit=self._now(),
                      tenant=tenant)
        self._by_id[req_id] = req
        if arrival is None:
            self._push_ready(req)
        else:
            bisect.insort(self._pending, req, key=lambda r: r.arrival)
        return req

    def _push_ready(self, req: Request) -> None:
        heapq.heappush(self._ready, (-req.priority, self._seq, req))
        self._seq += 1

    def cancel(self, req_id: int) -> bool:
        """Cancel a request: dropped before admission if queued, its slot
        reclaimed at the next sync if running.  Safe from a stream_cb.
        Returns False for unknown or already-finished ids."""
        req = self._by_id.get(req_id)
        if req is None or req.finished or req.cancelled:
            return False
        req.cancelled = True
        self._cancel_dirty = True
        return True

    # ------------------------------------------------------------------
    # Scheduler core
    # ------------------------------------------------------------------

    def _drop_cancelled(self, req: Request) -> None:
        req.t_done = self._now()
        self.stats.record_cancelled()
        self._finished.append(req)
        self._by_id.pop(req.req_id, None)
        if self.logger:
            self.logger.log(event="cancel", req=req.req_id, slot=None,
                            n_tokens=len(req.tokens))

    def _sweep_cancelled(self) -> bool:
        if not self._cancel_dirty:
            return False
        self._cancel_dirty = False
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.cancelled:
                self._finish(slot)
        keep = []
        for r in self._pending:
            (keep.append(r) if not r.cancelled else self._drop_cancelled(r))
        self._pending = keep
        if any(e[2].cancelled for e in self._ready):
            for e in self._ready:
                if e[2].cancelled:
                    self._drop_cancelled(e[2])
            # keep the original (priority, seq) tuples: FIFO order holds
            self._ready = [e for e in self._ready if not e[2].cancelled]
            heapq.heapify(self._ready)
        return True

    def _deliver(self, req: Request, new_toks: list) -> None:
        """Stream delivery at a sync.  A raising callback is counted,
        dropped, and its request cancelled; other streams are untouched."""
        if req.stream_cb is None or not new_toks:
            return
        try:
            req.stream_cb(req, new_toks)
        except Exception:
            self.stats.n_callback_errors += 1
            req.stream_cb = None
            if self.logger:
                self.logger.log(event="stream_cb_error", req=req.req_id,
                                n_tokens=len(req.tokens))
            if not req.finished and not req.cancelled:
                self.cancel(req.req_id)

    def _append_token(self, req: Request, tok: int, lp, tv, ti) -> None:
        req.tokens.append(tok)
        req.cum_logprob += float(lp)
        if req.params.logprobs:
            req.logprobs.append(float(lp))
        if req.params.top_logprobs:
            k = req.params.top_logprobs
            req.top_logprobs.append(
                [(int(ti[i]), float(tv[i])) for i in range(k)])

    def _admit(self, req: Request) -> None:
        """Exact-length prefill of the prompt into a free slot, then the
        first token, sampled with the request's own params."""
        slot = self.pool.alloc()
        assert slot is not None
        self.pool.params.set(slot, req.params, req.seed)
        t0 = self._now()
        req.t_admit = t0
        tokens = torch.as_tensor(req.prompt[None], dtype=torch.int64,
                                 device=self.device)
        logits, sub = registry.prefill(self.cfg, self.prefill_params,
                                       self.pool.fresh, {"tokens": tokens})
        self.pool.admit(slot, sub)
        last = logits[:, -1, :]
        tok_dev = sampling.sample(last, self.pool.params.rows([slot]), [0])
        lp, tv, ti = sampling.token_logprobs(last, tok_dev)
        tok = int(tok_dev[0])                    # host sync: first token
        req.t_first = self._now()
        self.stats.record_prefill(int(req.prompt.size), req.t_first - t0)
        self._slot_req[slot] = req
        self._next_tok[slot, 0] = tok
        self._append_token(req, tok, lp[0].item(), tv[0].tolist(),
                           ti[0].tolist())
        if self.logger:
            self.logger.log(event="admit", req=req.req_id, slot=slot,
                            prompt_len=int(req.prompt.size))
        if self._hit_stop(req):
            self._finish(slot)
        self._deliver(req, [tok])
        if req.cancelled and not req.finished:
            self._finish(slot)

    def _hit_stop(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new:
            return True
        if req.stop_ids and req.tokens[-1] in req.stop_ids:
            return True
        for seq in req.params.stop_seqs:
            seq = tuple(seq)
            if (len(req.tokens) >= len(seq)
                    and tuple(req.tokens[-len(seq):]) == seq):
                return True
        return False

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        req.t_done = self._now()
        if req.cancelled:
            self.stats.record_cancelled()
        else:
            self.stats.record_request(ttft=req.t_first - req.t_submit,
                                      latency=req.t_done - req.t_submit,
                                      n_tokens=len(req.tokens),
                                      tenant=req.tenant)
        self.pool.evict(slot)
        self._slot_req[slot] = None
        self._next_tok[slot, 0] = 0
        self._finished.append(req)
        self._by_id.pop(req.req_id, None)
        if self.logger:
            self.logger.log(
                event="cancel" if req.cancelled else "finish",
                req=req.req_id, slot=slot, n_tokens=len(req.tokens))

    def _burst_len(self, active) -> int:
        """Decode steps until the next scheduling event (repro's rule)."""
        remaining = min(self._slot_req[s].max_new
                        - len(self._slot_req[s].tokens) for s in active)
        uncertain = any(self._slot_req[s].stop_ids
                        or self._slot_req[s].params.stop_seqs
                        or self._slot_req[s].stream_cb is not None
                        for s in active)
        may_admit = self.pool.n_free > 0 and (self._ready or self._pending)
        if uncertain or may_admit:
            return max(1, min(remaining, self.ecfg.sched_quantum))
        return max(1, remaining)

    def _base_steps(self, active) -> np.ndarray:
        """Each pool row's stream position: the tokens its request has
        emitted (0 for other rows)."""
        base = np.zeros((self.pool.n_total,), np.int64)
        for s in active:
            base[s] = len(self._slot_req[s].tokens)
        return base

    def _decode_burst(self) -> None:
        active = self.pool.active_slots()
        n_steps = self._burst_len(active)
        t0 = self._now()
        toks = torch.as_tensor(self._next_tok, device=self.device)
        act = torch.as_tensor(self.pool.active_mask(), device=self.device)
        sp = self.pool.params.rows()
        base = self._base_steps(active)
        cache = self.pool.cache
        outs, lps, tvs, tis = [], [], [], []
        for t in range(n_steps):
            logits, new_cache = registry.decode_step(self.cfg, self.params,
                                                     cache, {"tokens": toks})
            cache = registry.mask_slots(self.cfg, cache, new_cache, act)
            last = logits[:, -1, :]
            tok = sampling.sample(last, sp, base + t)
            lp, tv, ti = sampling.token_logprobs(last, tok)
            toks = tok[:, None]
            outs.append(tok)
            lps.append(lp)
            tvs.append(tv)
            tis.append(ti)
        self.pool.cache = cache
        # one host sync per burst
        burst = torch.stack(outs, 1).cpu().numpy()         # (slots, steps)
        lp_h = torch.stack(lps).cpu().numpy()              # (steps, slots)
        tv_h = torch.stack(tvs).cpu().numpy()
        ti_h = torch.stack(tis).cpu().numpy()
        n_appended = 0
        for slot in active:
            req = self._slot_req[slot]
            new_toks = []
            for t in range(n_steps):
                tok = int(burst[slot, t])
                self._append_token(req, tok, lp_h[t, slot], tv_h[t, slot],
                                   ti_h[t, slot])
                new_toks.append(tok)
                n_appended += 1
                self._next_tok[slot, 0] = tok
                if self._hit_stop(req):
                    self._finish(slot)
                    break                 # trim overshoot past a stop
            self._deliver(req, new_toks)
            if req.cancelled and not req.finished:
                self._finish(slot)
        self.stats.record_decode(n_active=len(active),
                                 n_slots=self.ecfg.n_slots,
                                 dt=self._now() - t0,
                                 n_steps=n_steps, n_tokens=n_appended)

    # ------------------------------------------------------------------
    # Speculative decoding (EngineConfig.draft)
    # ------------------------------------------------------------------

    def _slot_depth(self, req: Request) -> int:
        """A slot's speculative window: k, or ``spec_cap`` below it; with
        DraftConfig.adaptive, after the warm-up passes, the request's
        realized acceptance + 1.  Window lengths only: token values do
        not change."""
        dc = self.ecfg.draft
        kmax = (self._spec.k if self.spec_cap is None
                else max(1, min(self._spec.k, self.spec_cap)))
        if not dc.adaptive or req.spec_passes < max(1, dc.adapt_warmup):
            return kmax
        realized = req.spec_accepted / req.spec_passes
        return int(min(kmax, max(1, math.ceil(realized) + 1)))

    def _spec_pass(self) -> None:
        """One fork -> draft -> verify -> rollback pass over the live
        slots, 1 to k+1 tokens a slot, one host sync.  The scratch leases
        are released even if the pass raises."""
        spec = self._spec
        active = self.pool.active_slots()
        # draft no further than the shortest remaining budget: tokens
        # past it would be trimmed anyway
        remaining = min(self._slot_req[s].max_new
                        - len(self._slot_req[s].tokens) for s in active)
        depths = {s: self._slot_depth(self._slot_req[s]) for s in active}
        k_eff = min(max(depths.values()), remaining - 1)
        if k_eff < 1:
            # every slot needs exactly one more token: a plain burst
            self._decode_burst()
            return
        t0 = self._now()
        leases: list[int] = []
        try:
            for _ in active:
                sc = self.pool.lease_scratch()
                assert sc is not None            # n_scratch == n_slots
                leases.append(sc)
            # the fork copies each seed verbatim: a draft proposes from
            # its request's own stream
            self.pool.fork(active, leases)
            total = self.pool.n_total
            toks = np.zeros((total, 1), np.int64)
            toks[leases, 0] = self._next_tok[active, 0]
            scratch = np.zeros((total,), bool)
            scratch[leases] = True
            base = self._base_steps(active)
            base[leases] = base[active]
            limit = np.full((total,), k_eff, np.int64)
            for s in active:
                limit[s] = min(depths[s], k_eff)
            sp = self.pool.params.rows()
            cache, d_toks, d_logits = spec.propose(
                self.pool.cache, torch.as_tensor(toks, device=self.device),
                scratch, sp, base, k_eff)
            # proposals were drafted at the scratch rows; the verify
            # reads them at their live slots' rows
            perm = np.arange(total)
            perm[active] = leases
            perm = torch.as_tensor(perm, device=self.device)
            emit, n_acc, _, snap, v_lp, v_tv, v_ti = spec.verify(
                self.params, cache,
                torch.as_tensor(self._next_tok, device=self.device),
                d_toks[:, perm], d_logits[:, perm], self.pool.active_mask(),
                sp, base, limit)
            del cache, d_toks, d_logits
            # the rollback: each live row of snap is its slot's state
            # after exactly its accepted prefix
            self.pool.cache = snap
            # the pass's one host sync
            emit_h, n_acc_h = emit.cpu().numpy(), n_acc.cpu().numpy()
            lp_h, tv_h, ti_h = (v_lp.cpu().numpy(), v_tv.cpu().numpy(),
                                v_ti.cpu().numpy())
        finally:
            for sc in leases:
                self.pool.release_scratch(sc)
        n_appended = n_accepted = 0
        for slot in active:
            req = self._slot_req[slot]
            n_emit = int(n_acc_h[slot]) + 1
            n_accepted += n_emit - 1
            req.spec_passes += 1
            req.spec_accepted += n_emit - 1
            new_toks = []
            for t in range(n_emit):
                tok = int(emit_h[t, slot])
                self._append_token(req, tok, lp_h[t, slot], tv_h[t, slot],
                                   ti_h[t, slot])
                new_toks.append(tok)
                n_appended += 1
                self._next_tok[slot, 0] = tok
                if self._hit_stop(req):
                    self._finish(slot)
                    break                 # trim overshoot past a stop
            self._deliver(req, new_toks)
            if req.cancelled and not req.finished:
                self._finish(slot)
        self.stats.record_decode(n_active=len(active),
                                 n_slots=self.ecfg.n_slots,
                                 dt=self._now() - t0,
                                 n_steps=k_eff + 1, n_tokens=n_appended)
        self.stats.record_spec(n_active=len(active),
                               n_drafted=k_eff * len(active),
                               n_accepted=n_accepted,
                               n_emitted=n_appended, n_draft_steps=k_eff)

    def step(self) -> bool:
        """One scheduler iteration: reclaim cancellations, admit into
        free slots (highest priority first), then one decode burst (one
        speculative pass with a draft).
        Returns False when there was nothing to do."""
        did = self._sweep_cancelled()
        while self._ready and self.pool.n_free:
            _, _, req = heapq.heappop(self._ready)
            if req.cancelled:
                self._drop_cancelled(req)
                continue
            self._admit(req)
            did = True
        if self.pool.n_active:
            if self._spec is not None:
                self._spec_pass()
            else:
                self._decode_burst()
            did = True
        return did

    def run(self) -> list[Request]:
        """Run until every submitted request is finished or cancelled,
        replaying arrival-gated requests against a clock starting now.
        Returns the requests retired during this call, in order."""
        self.stats.start()
        self._finished = []
        t0 = self._now()
        while self._pending or self._ready or self.pool.n_active:
            now = self._now() - t0
            while self._pending and self._pending[0].arrival <= now:
                req = self._pending.pop(0)
                if req.cancelled:
                    self._drop_cancelled(req)
                    continue
                req.t_submit = self._now()
                self._push_ready(req)
            if not self.step() and self._pending:
                wait = self._pending[0].arrival - (self._now() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        self.stats.stop()
        if self.logger:
            self.logger.log(event="summary", **self.stats.summary())
        return self._finished
