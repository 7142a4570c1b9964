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
per-layer conv and step kernels.  The transformer family has no K3
instance: "auto" decodes it per layer on every device, and an explicit
"megakernel" raises (``registry.uses_megakernel``).  As in ``repro``,
the stub frontends (audio_stub, vision_stub) are not served.

Speculative decoding (``EngineConfig.draft``, ``runtime/spec_decode.py``)
makes each scheduler iteration one fork -> k-token draft -> batched
verify -> rollback pass in place of a decode burst: the pool gains one
scratch slot per live slot, and a pass emits 1 to k+1 tokens a slot
with one host sync.  ``Request.spec_passes`` / ``spec_accepted`` and
``ServeStats`` count the passes and the accepted drafts; ``spec_cap``
clamps every slot's window.

Prefix-state cache (``EngineConfig.prefix_cache``,
``runtime/prefix_cache.py``): an admission whose prompt shares a cached
block-boundary prefix restores that snapshot and computes only the
suffix, one batch-1 ``decode_step`` a token (K3 on the card, on K3's view
of the prefill master); a cold admission prefills the first block, then
chains the rest the same way and stores a snapshot at every boundary it
crosses.  A hit therefore emits bitwise the tokens of a cold admission of
the same prompt.  Only the boundary states of a chain are kept.

Best-of-n (``SamplingParams.n``): one prefill, then a fork into n - 1
more slots whose seeds are re-derived per branch (branch 0 keeps the
request's, so it is the same request served at n = 1); the parent
``Request`` holds no slot and ends with the branches ranked by
cumulative logprob.  ``submit(session=True)`` opens an infinite-stream
session (no max_new horizon, slot pinned) for families whose state does
not grow with max_seq; ``submit_snapshot`` admits a request prefilled
elsewhere (``runtime/disagg.py``) with one scatter.

Tensor-parallel serving (``EngineConfig.mesh``, a ``launch.mesh.Mesh``
from ``make_serving_mesh(tp)``; ``rules`` the logical-axis rules) is
SPMD: one process per rank, each making the same ``Engine`` from the
same full param tree (the engine cuts the rank's shard,
``sharding.shard_params``; an int8 engine's f32 prefill master too) and
making the same calls — every ``submit`` and ``cancel`` on every rank,
in the same order, and the same ``step``/``run`` loop.  The models sum
their row-parallel products and gather the vocab-parallel logits over
the mesh (``parallel/sharding.py``), so every rank computes the same
full logits; the tokens each step samples (with their logprobs) are
still broadcast from the first rank, so no rank's host state (slots,
stops, stream callbacks, which fire on every rank) can drift.  Under a
mesh a decode step runs per layer ("auto" serves as "fused"; an
explicit "megakernel" raises, ``registry.uses_megakernel``), the MoE's
"auto" dispatch is the dense one and "ep" raises, as in ``repro``.
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
from repro_torch.models import registry
from repro_torch.parallel import sharding
from repro_torch.runtime import metrics as metrics_lib
from repro_torch.runtime import sampling
from repro_torch.runtime.prefix_cache import (PrefixCache, PrefixCacheConfig,
                                              snapshot_to_device,
                                              snapshot_to_host)
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_decode import DraftConfig, SpecDecoder
from repro_torch.runtime.state_pool import SlotStatePool


def derive_seed(engine_seed: int, req_id: int) -> int:
    """Per-request seed for unseeded requests (as repro's); module-level so
    that a disaggregated pipeline numbers its requests as an engine does."""
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
    # prompt-prefix state cache: None prefills every prompt whole; a
    # PrefixCacheConfig restores cached block-boundary snapshots and
    # computes only the suffix
    prefix_cache: Optional[PrefixCacheConfig] = None
    # tensor-parallel serving: a launch.mesh.Mesh (make_serving_mesh(tp),
    # 1-D over "model"); every rank makes the same Engine and the same
    # calls.  None (default) serves on one device
    mesh: Optional[object] = None
    # logical-axis -> mesh-axis rules; None = sharding.ShardingRules()
    rules: Optional[sharding.ShardingRules] = None
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
    # infinite-stream session: no max_new horizon, slot pinned until a
    # stop or cancel()
    session: bool = False
    # disaggregated admission: a shipped prefill snapshot
    # (runtime/disagg.py Snapshot) restored in place of a local prefill
    snapshot: Optional[object] = dataclasses.field(default=None,
                                                   repr=False)
    # best-of-n: the submitted request is the parent and holds no slot;
    # its n children (``branches``, ranked by cum_logprob when done) do,
    # each with its ``branch`` tag and a ``parent`` link
    branches: Optional[list] = dataclasses.field(default=None, repr=False)
    parent: Optional["Request"] = dataclasses.field(default=None,
                                                    repr=False)
    branch: int = 0
    _open: int = 0                        # unfinished children (parent)

    @property
    def finished(self) -> bool:
        return self.t_done is not None


class Engine:
    def __init__(self, cfg, params, ecfg: EngineConfig,
                 logger: Optional[metrics_lib.MetricsLogger] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if cfg.frontend in ("audio_stub", "vision_stub"):
            raise NotImplementedError(
                "serving engine supports token frontends only")
        if ecfg.step_impl is not None:
            cfg = dataclasses.replace(cfg, step_impl=ecfg.step_impl)
        if ecfg.state_dtype is not None:
            cfg = dataclasses.replace(cfg, state_dtype=ecfg.state_dtype)
        if ecfg.kv_cache_dtype is not None:
            cfg = dataclasses.replace(cfg,
                                      kv_cache_dtype=ecfg.kv_cache_dtype)
        ecfg.default_params.validate()
        self.device = resolve_device(ecfg.device)
        self.mesh = ecfg.mesh
        self.rules = ecfg.rules or sharding.ShardingRules()
        # K3 for a family that has an instance of it; a transformer
        # decodes per layer (an explicit "megakernel" raises here, and
        # under a mesh)
        stack = registry.uses_megakernel(cfg, self.device, self.mesh)
        if self.mesh is not None:
            if cfg.step_impl == "auto":
                cfg = dataclasses.replace(cfg, step_impl="fused")
            # the dense dispatch routes with the global capacity on every
            # rank; the expert-parallel one would drop overflow tokens by
            # a shard's capacity, and its logits would differ from the
            # single-device routing's
            if getattr(cfg, "moe_impl", None) == "ep":
                raise ValueError(
                    "moe_impl='ep' is unsupported under a serving mesh: "
                    "per-shard capacity drops break token identity")
            if getattr(cfg, "moe_impl", None) == "auto":
                cfg = dataclasses.replace(cfg, moe_impl="dense")
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
        distinct = prefill_params is not params
        if self.mesh is not None:
            # the rank's shard of each tree; the f32 prefill master under
            # the rules an unquantized engine's weights take
            params = sharding.shard_params(cfg, params, self.mesh,
                                           self.rules)
            if distinct:
                prefill_params = sharding.shard_params(
                    dataclasses.replace(cfg, weight_dtype="f32"),
                    prefill_params, self.mesh, self.rules)
        self.params = registry.tree_to(params, self.device)
        self.prefill_params = (registry.tree_to(prefill_params, self.device)
                               if distinct else self.params)
        # the prefix cache's suffix chain steps the prefill master, through
        # K3 where decode runs K3: its own view of the master unless the
        # master is the decode tree
        self._chain_params = self.prefill_params
        if stack:
            # K3's view of the decode layers: built once, here
            master_is_decode = self.prefill_params is self.params
            self.params = registry.stack_params(cfg, self.params)
            if ecfg.prefix_cache is not None:
                self._chain_params = (
                    self.params if master_is_decode
                    else registry.stack_params(cfg, self.prefill_params))
        self.ecfg = ecfg
        # one scratch slot per live slot: every live slot forks a draft
        # in the same speculative pass
        self.pool = SlotStatePool(
            cfg, ecfg.n_slots, ecfg.max_seq, device=self.device,
            n_scratch=ecfg.n_slots if ecfg.draft is not None else 0,
            mesh=self.mesh, rules=self.rules)
        self._spec = (SpecDecoder(cfg, self.params, ecfg.draft, self.device,
                                  mesh=self.mesh)
                      if ecfg.draft is not None else None)
        # the scheduler's degradation knob: clamps every slot's window
        self.spec_cap: Optional[int] = None
        # sessions need a state that does not grow with max_seq (jamba's
        # KV strips do): compare a slot with the cache one position longer,
        # made on the meta device, so nothing is allocated
        slot = registry.abstract_cache(cfg, 1, ecfg.max_seq)
        longer = registry.abstract_cache(cfg, 1, ecfg.max_seq + 1)
        self._cache_growable = any(
            x.shape != y.shape
            for x, y in zip(registry.tree_leaves(slot),
                            registry.tree_leaves(longer)))
        self._prefix = (PrefixCache(ecfg.prefix_cache, self.device)
                        if ecfg.prefix_cache is not None else None)
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
               tenant: Optional[str] = None,
               session: bool = False) -> Request:
        """Enqueue a request (``repro``'s ``Engine.submit``).  ``max_new``
        overrides params.max_new and ``eos_id`` extends params.stop;
        ``arrival`` (s from run() start) gates admission; higher
        ``priority`` admits earlier.  ``session=True`` opens an
        infinite-stream session: no max_new horizon (a stop or cancel()
        ends it), its slot pinned; refused for a family whose cache grows
        with max_seq (jamba's KV strips)."""
        prompt, params = self.resolve(prompt, params, max_new, eos_id,
                                      session, stream_cb)
        req_id = self._next_id
        self._next_id += 1
        req = Request(req_id=req_id, prompt=prompt, params=params,
                      seed=self.seed_for(params, req_id),
                      max_new=params.max_new,
                      stop_ids=frozenset(params.stop), eos_id=eos_id,
                      priority=priority, stream_cb=stream_cb,
                      arrival=arrival or 0.0, t_submit=self._now(),
                      tenant=tenant, session=session)
        return self._enqueue(req, arrival)

    def resolve(self, prompt, params: Optional[SamplingParams] = None,
                max_new: Optional[int] = None,
                eos_id: Optional[int] = None, session: bool = False,
                stream_cb: Optional[Callable] = None):
        """The request policy of ``submit``, ``submit_snapshot`` and
        ``DisaggPipeline.submit``: the prompt as int32 and the params
        with ``max_new`` and ``eos_id`` applied, held to this engine's
        max_seq, slots and cache.  Returns (prompt, params)."""
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
        if session:
            if self._cache_growable:
                raise ValueError(
                    "infinite-stream sessions need a max_seq-independent "
                    "decode state; this family's cache grows with "
                    "max_seq (per-position KV strips)")
            if params.n > 1:
                raise ValueError("sessions are single-stream (n == 1)")
            if prompt.size > self.ecfg.max_seq:
                raise ValueError(
                    f"session prompt ({prompt.size}) exceeds max_seq "
                    f"({self.ecfg.max_seq})")
        elif prompt.size + params.max_new > self.ecfg.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({params.max_new}) "
                f"exceeds max_seq ({self.ecfg.max_seq})")
        if params.n > self.ecfg.n_slots:
            raise ValueError(
                f"n ({params.n}) exceeds n_slots ({self.ecfg.n_slots}): "
                f"every branch needs a slot")
        if params.n > 1 and stream_cb is not None:
            raise ValueError("stream_cb is unsupported for n > 1 "
                             "(n branches have no single stream)")
        return prompt, params

    def seed_for(self, params: SamplingParams, index: int) -> int:
        """The sampling seed of the ``index``-th submission: its params'
        own, else one derived from the engine seed and the index."""
        return (params.seed if params.seed is not None
                else derive_seed(self.ecfg.seed, index))

    def submit_snapshot(self, snap, arrival: Optional[float] = None,
                        priority: int = 0,
                        stream_cb: Optional[Callable] = None,
                        tenant: Optional[str] = None,
                        session: bool = False) -> Request:
        """Enqueue a request prefilled elsewhere (``runtime/disagg.py``).

        ``snap`` carries the prompt, the resolved SamplingParams and seed,
        the post-prompt batch-1 cache tree (payload, scales, position) and
        the first token with its logprob surface.  Admission scatters the
        state into a slot and installs that token, with no local prefill,
        so the stream is the engine's own for the same request: the
        worker ran the same prefill with the same seed, and a gather,
        copy and scatter move the state exactly.  The state's layout must
        be this engine's (same model, state and KV dtypes, max_seq)."""
        if snap.params.n > 1:
            raise ValueError("snapshot admission is single-stream "
                             "(best-of-n forks decode-side state that "
                             "does not exist yet)")
        prompt, params = self.resolve(snap.prompt, snap.params,
                                      session=session, stream_cb=stream_cb)
        want = registry.tree_leaves(self.pool.fresh)
        got = registry.tree_leaves(snap.state)
        if len(want) != len(got) or any(
                w.shape != g.shape or w.dtype != g.dtype
                for w, g in zip(want, got)):
            raise ValueError(
                "snapshot state does not match this engine's cache "
                "layout (model config / state_dtype / max_seq mismatch)")
        req = Request(req_id=self._next_id, prompt=prompt, params=params,
                      seed=snap.seed, max_new=params.max_new,
                      stop_ids=frozenset(params.stop),
                      priority=priority, stream_cb=stream_cb,
                      arrival=arrival or 0.0, t_submit=self._now(),
                      tenant=tenant, session=session, snapshot=snap)
        self._next_id += 1
        return self._enqueue(req, arrival)

    def _enqueue(self, req: Request, arrival: Optional[float]) -> Request:
        self._by_id[req.req_id] = req
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
        if req.branches is not None:
            # best-of-n: the parent holds no slot, its live branches do
            for child in req.branches:
                if not child.finished:
                    child.cancelled = True
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

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks), dtype=torch.int64,
                               device=self.device)

    def _agree(self, *tensors):
        """The tensors as the mesh's first rank holds them (the sampled
        tokens and their logprobs; one broadcast of all of them, packed
        in f64, which holds token ids and f32 values exactly).  Off a
        mesh, the tensors themselves."""
        if self.mesh is None:
            return tensors
        flat = sharding.broadcast(torch.cat(
            [t.reshape(-1).to(torch.float64) for t in tensors]))
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return tuple(out)

    def _admit_into_slot(self, req: Request, slot: int):
        """Prefill ``req``'s prompt into ``slot`` (its params row already
        set) and sample its first token.  With the prefix cache and a
        usable boundary: restore the deepest cached snapshot (a hit) or
        prefill the first block (cold), then chain the rest of the prompt
        (``_suffix_chain``).  Returns (tok, lp, tv row, ti row, last
        logits (1, V)), the last on the device: best-of-n samples its
        other branches' first tokens from it."""
        t0 = self._now()
        req.t_admit = t0
        prompt = req.prompt
        length = int(prompt.size)
        pc = self._prefix
        bound = pc.boundary(length) if pc is not None else 0
        hit = None
        if bound:
            hit = pc.lookup(prompt)
            if hit is not None:
                p_from, snap = hit
            else:
                p_from = pc.cfg.block
                _, snap = registry.prefill(
                    self.cfg, self.prefill_params, self.pool.fresh,
                    {"tokens": self._tokens(prompt[None, :p_from])})
                snap = self.pool.as_slot(snap)
                pc.insert(prompt[:p_from], snap)
            last, final = self._suffix_chain(prompt, p_from, snap, bound)
            self.pool.admit(slot, final)
            self.stats.record_prefix(hit is not None,
                                     p_from if hit is not None else 0)
        else:
            logits, sub = registry.prefill(
                self.cfg, self.prefill_params, self.pool.fresh,
                {"tokens": self._tokens(prompt[None])})
            self.pool.admit(slot, sub)
            last = logits[:, -1, :]
        tok_dev = sampling.sample(last, self.pool.params.rows([slot]), [0])
        lp, tv, ti = sampling.token_logprobs(last, tok_dev)
        tok_dev, lp, tv, ti = self._agree(tok_dev, lp, tv, ti)
        tok = int(tok_dev[0])                    # host sync: first token
        req.t_first = self._now()
        # prefill_tokens counts computed tokens only: restored ones go to
        # prefix_cached_tokens
        self.stats.record_prefill(length - (p_from if hit is not None
                                            else 0), req.t_first - t0)
        return tok, lp[0].item(), tv[0].tolist(), ti[0].tolist(), last

    def _suffix_chain(self, prompt, p_from: int, snap, bound: int):
        """Run ``prompt[p_from:]`` from the snapshot ``snap`` one batch-1
        ``decode_step`` a token, on the prefill master (K3's view of it
        where decode runs K3), storing the state at every block boundary
        the chain crosses up to ``bound``.  Only those states are kept.
        Returns (the last token's logits (1, V), the final state)."""
        block = self._prefix.cfg.block
        toks = self._tokens(prompt[p_from:]).reshape(-1, 1, 1)
        cache = snap
        for j in range(toks.shape[0]):
            logits, cache = registry.decode_step(
                self.cfg, self._chain_params, cache, {"tokens": toks[j]})
            done = p_from + j + 1
            if done % block == 0 and done <= bound:
                self._prefix.insert(prompt[:done], cache)
        return logits[:, -1, :], cache

    def prefill_snapshot(self, prompt, params: SamplingParams, seed: int):
        """Prefill ``prompt`` as an admission would (the prefix cache's
        path included), sample its first token with ``seed`` and export
        the slot's state to the CPU, a copy that owns its memory; the
        slot is evicted at once.  The prefill side of disaggregated
        serving (``runtime/disagg.py``).  Returns (state, tok, lp, tv row,
        ti row)."""
        with sharding.use_mesh(self.mesh, self.rules):
            return self._prefill_snapshot(prompt, params, seed)

    def _prefill_snapshot(self, prompt, params, seed):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        slot = self.pool.alloc()
        if slot is None:
            raise RuntimeError("prefill_snapshot needs a free slot")
        self.pool.params.set(slot, params, seed)
        req = Request(req_id=self._next_id, prompt=prompt, params=params,
                      seed=seed, max_new=params.max_new,
                      stop_ids=frozenset(params.stop))
        self._next_id += 1
        try:
            tok, lp, tv, ti, _ = self._admit_into_slot(req, slot)
            state = snapshot_to_host(self.pool.read([slot]))
        finally:
            self.pool.evict(slot)
        if self._prefix is not None:
            self._prefix.flush_pending(limit=None)
            self.stats.sync_prefix(self._prefix.counters())
        return state, tok, lp, tv, ti

    def _admit_snapshot_into_slot(self, req: Request, slot: int):
        """Disaggregated admission: one scatter of the shipped state into
        ``slot``, then the worker's first token.  No local prefill, so
        prefill_tokens is untouched; the snapshot_* counters take it."""
        t0 = self._now()
        req.t_admit = t0
        snap = req.snapshot
        self.pool.admit(slot, snapshot_to_device(snap.state, self.device))
        req.t_first = self._now()
        self.stats.record_snapshot_admit(n_tokens=int(req.prompt.size),
                                         nbytes=snap.nbytes)
        return snap.tok, snap.lp, snap.tv, snap.ti

    def _install(self, req: Request, slot: int, tok: int, lp, tv,
                 ti) -> None:
        """Bind an admitted request to its slot and deliver its first
        token (the tail of plain and best-of-n admission)."""
        self._slot_req[slot] = req
        self._next_tok[slot, 0] = tok
        self._append_token(req, tok, lp, tv, ti)
        if self.logger:
            self.logger.log(event="admit", req=req.req_id, slot=slot,
                            prompt_len=int(req.prompt.size))
        if self._hit_stop(req):
            self._finish(slot)
        self._deliver(req, [tok])
        if req.cancelled and not req.finished:
            self._finish(slot)

    def _admit(self, req: Request) -> None:
        slot = self.pool.alloc()
        assert slot is not None
        self.pool.params.set(slot, req.params, req.seed)
        if req.snapshot is not None:
            tok, lp, tv, ti = self._admit_snapshot_into_slot(req, slot)
        else:
            tok, lp, tv, ti, _ = self._admit_into_slot(req, slot)
        if req.session:
            # eviction-free lease: _finish unpins before evicting
            self.pool.pin(slot)
        self._install(req, slot, tok, lp, tv, ti)

    def _branch_request(self, parent: Request, b: int) -> Request:
        """Branch ``b`` of a best-of-n parent.  Its pool row's seed comes
        from the fork's tag, so ``seed`` is bookkeeping only."""
        child = Request(
            req_id=self._next_id, prompt=parent.prompt,
            params=dataclasses.replace(parent.params, n=1),
            seed=parent.seed, max_new=parent.max_new,
            stop_ids=parent.stop_ids, eos_id=parent.eos_id,
            priority=parent.priority, t_submit=parent.t_submit,
            branch=b, parent=parent)
        self._next_id += 1
        self._by_id[child.req_id] = child
        return child

    def _admit_group(self, parent: Request) -> None:
        """Best-of-n admission: one prefill into the first slot, one fork
        into the other n - 1 with branch tags 1..n-1 (each its own seed),
        then each of those branches' first token sampled from the
        prefill's last logits with its own seed.  Branch 0 keeps the
        parent's seed: its stream is the request served at n = 1."""
        n = parent.params.n
        slots = [self.pool.alloc() for _ in range(n)]
        assert all(s is not None for s in slots)
        children = [self._branch_request(parent, b) for b in range(n)]
        parent.branches = list(children)
        parent._open = n
        self.pool.params.set(slots[0], parent.params, parent.seed)
        tok0, lp0, tv0, ti0, last = self._admit_into_slot(children[0],
                                                          slots[0])
        parent.t_admit = children[0].t_admit
        parent.t_first = children[0].t_first
        # fork before any stop or cancel can evict the first slot
        self.pool.fork([slots[0]] * (n - 1), slots[1:],
                       branch_tags=list(range(1, n)))
        firsts = [(tok0, lp0, tv0, ti0)]
        for b in range(1, n):
            tb = sampling.sample(last, self.pool.params.rows([slots[b]]),
                                 [0])
            lb, tvb, tib = sampling.token_logprobs(last, tb)
            tb, lb, tvb, tib = self._agree(tb, lb, tvb, tib)
            firsts.append((int(tb[0]), lb[0].item(), tvb[0].tolist(),
                           tib[0].tolist()))
        for b in range(n):
            self._install(children[b], slots[b], *firsts[b])

    def _hit_stop(self, req: Request) -> bool:
        # a session has no token horizon: only stops and cancel end it
        if not req.session and len(req.tokens) >= req.max_new:
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
        if req.parent is not None:
            # a best-of-n branch: stats and the finished list see only
            # its parent
            pass
        elif req.cancelled:
            self.stats.record_cancelled()
        else:
            self.stats.record_request(ttft=req.t_first - req.t_submit,
                                      latency=req.t_done - req.t_submit,
                                      n_tokens=len(req.tokens),
                                      tenant=req.tenant)
        if req.session:
            self.pool.unpin(slot)
        self.pool.evict(slot)
        self._slot_req[slot] = None
        self._next_tok[slot, 0] = 0
        if req.parent is None:
            self._finished.append(req)
        self._by_id.pop(req.req_id, None)
        if self.logger:
            self.logger.log(
                event="cancel" if req.cancelled else "finish",
                req=req.req_id, slot=slot, n_tokens=len(req.tokens))
        if req.parent is not None:
            req.parent._open -= 1
            if req.parent._open == 0:
                self._finalize_parent(req.parent)

    def _finalize_parent(self, parent: Request) -> None:
        """Every branch finished: rank them by cumulative logprob (ties by
        branch), give the parent the best one's stream, retire it."""
        kids = sorted(parent.branches,
                      key=lambda c: (-c.cum_logprob, c.branch))
        parent.branches = kids
        best = kids[0]
        parent.tokens = list(best.tokens)
        parent.logprobs = list(best.logprobs)
        parent.top_logprobs = list(best.top_logprobs)
        parent.cum_logprob = best.cum_logprob
        parent.t_done = self._now()
        if parent.cancelled:
            self.stats.record_cancelled()
        else:
            self.stats.record_request(
                ttft=parent.t_first - parent.t_submit,
                latency=parent.t_done - parent.t_submit,
                n_tokens=len(parent.tokens), tenant=parent.tenant)
        self._finished.append(parent)
        self._by_id.pop(parent.req_id, None)
        if self.logger:
            self.logger.log(event="finish_group", req=parent.req_id,
                            n=len(kids), best=best.branch,
                            n_tokens=len(parent.tokens))

    @staticmethod
    def _remaining(req: Request) -> int:
        """Tokens left before the certain eviction; a session has none
        (only a stop or cancel ends it)."""
        if req.session:
            return 1 << 30
        return req.max_new - len(req.tokens)

    def _burst_len(self, active) -> int:
        """Decode steps until the next scheduling event (repro's rule): the
        shortest remaining budget, capped by the quantum when an uncertain
        event could act sooner (a stop, a stream callback, a session, a
        host-store snapshot waiting for its copy, a free slot with queued
        work)."""
        remaining = min(self._remaining(self._slot_req[s]) for s in active)
        uncertain = any(self._slot_req[s].stop_ids
                        or self._slot_req[s].params.stop_seqs
                        or self._slot_req[s].stream_cb is not None
                        or self._slot_req[s].session
                        for s in active)
        if self._prefix is not None and self._prefix.has_pending():
            uncertain = True
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
            tok, lp, tv, ti = self._agree(tok, lp, tv, ti)
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
        remaining = min(self._remaining(self._slot_req[s]) for s in active)
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
        free slots (highest priority first; a best-of-n group when n slots
        are free), then one decode burst (one speculative pass with a
        draft).
        Returns False when there was nothing to do."""
        with sharding.use_mesh(self.mesh, self.rules):
            return self._step()

    def _step(self) -> bool:
        did = self._sweep_cancelled()
        while self._ready and self.pool.n_free:
            req = self._ready[0][2]
            if req.cancelled:
                heapq.heappop(self._ready)
                self._drop_cancelled(req)
                continue
            # a best-of-n group needs n free slots at once and blocks the
            # line until it has them
            if req.params.n > self.pool.n_free:
                break
            heapq.heappop(self._ready)
            if req.params.n > 1:
                self._admit_group(req)
            else:
                self._admit(req)
            did = True
        if self.pool.n_active:
            if self._spec is not None:
                self._spec_pass()
            else:
                self._decode_burst()
            did = True
        if self._prefix is not None:
            # the burst just synced: move one host-store snapshot to the
            # CPU, and adopt the cache's counters
            if self._prefix.has_pending():
                self._prefix.flush_pending(limit=1)
                did = True
            self.stats.sync_prefix(self._prefix.counters())
        return did

    @property
    def n_ready(self) -> int:
        """Requests in line for a slot (arrived, not yet admitted)."""
        return len(self._ready)

    def busy(self) -> bool:
        return bool(self._pending or self._ready or self.pool.n_active)

    def start_run(self) -> None:
        """Open a run: start the stats clock and the list of the requests
        it retires."""
        self.stats.start()
        self._finished = []

    def end_run(self) -> list[Request]:
        """Close a run: move every host-store snapshot to the CPU, stop
        the stats clock.  Returns the requests retired since
        ``start_run``, in order."""
        if self._prefix is not None:
            self._prefix.flush_pending(limit=None)
            self.stats.sync_prefix(self._prefix.counters())
        self.stats.stop()
        if self.logger:
            self.logger.log(event="summary", **self.stats.summary())
        return self._finished

    def run(self) -> list[Request]:
        """Run until every submitted request is finished or cancelled,
        replaying arrival-gated requests against a clock starting now.
        Returns the requests retired during this call, in order."""
        self.start_run()
        t0 = self._now()
        while self.busy():
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
        return self.end_run()
