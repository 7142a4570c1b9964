"""Prefill/decode disaggregation over snapshot admission (port of
``repro/runtime/disagg.py``).

Prefill is compute-bound over the whole prompt, decode a long run of
small bandwidth-bound steps; disaggregated serving runs them in two
pools and ships the post-prompt state across.  A recurrent family's
whole state is a fixed block (plus conv tail, scales and position), the
tree the prefix cache snapshots, so the handoff is one host round trip
of that block whatever the prompt's length.

Exactness, bitwise for every family and state dtype:

  1. The prefill worker is a 1-slot ``Engine`` over the same config and
     ``EngineConfig`` (so on the same device), running the admission a
     monolithic engine runs, with the same seed and params (seeds from
     the submission index through ``engine.derive_seed``).
  2. The shipped state is ``snapshot_to_host(pool.read([slot]))``, its
     admission ``pool.admit(slot, snapshot_to_device(...))``: a gather,
     a copy and a scatter, exact at any state dtype.
  3. The worker sampled the first token (and its logprob surface) with
     the request's own seed at position 0; it ships with the snapshot and
     is installed as it is.  Later draws depend on (seed, position) only.

So a disaggregated stream is the monolithic engine's stream for the
same submission order.

The transfer queue between the pools is bounded (``queue_depth``):
prefill stalls at the bound rather than buffer state blocks without
limit; counters keep the transfers, their bytes and the queue's peak.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.runtime.engine import Engine, EngineConfig, Request
from repro_torch.runtime.prefix_cache import tree_bytes
from repro_torch.runtime.sampling import SamplingParams


@dataclasses.dataclass
class Snapshot:
    """One prefilled request, ready to decode anywhere: prompt +
    resolved sampling identity (params, seed) + the post-prompt state
    block + the worker-sampled first-token surface."""
    prompt: np.ndarray
    params: SamplingParams
    seed: int
    state: object                 # batch-1 cache tree on the CPU
    tok: int                      # first token (sampled at step 0)
    lp: float                     # its chosen logprob
    tv: list                      # top-k logprob values row
    ti: list                      # top-k token id row
    nbytes: int                   # state payload bytes (the wire cost)


class PrefillWorker:
    """A 1-slot prefill pool: admits into its one slot as an engine does,
    gathers the state back out, and never decodes.  It takes the
    engine's prefix-cache path, so shared prefixes are snapshotted and
    restored as in a monolithic engine."""

    def __init__(self, cfg, params, ecfg: EngineConfig):
        wcfg = dataclasses.replace(ecfg, n_slots=1, draft=None)
        self.engine = Engine(cfg, params, wcfg)
        self.n_prefilled = 0

    def prefill(self, prompt, params: SamplingParams, seed: int) -> Snapshot:
        """Admit one prompt and export the slot as a snapshot on the CPU
        (``Engine.prefill_snapshot``).  The worker holds no state."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        state, tok, lp, tv, ti = self.engine.prefill_snapshot(
            prompt, params, seed)
        self.n_prefilled += 1
        return Snapshot(prompt=prompt, params=params, seed=seed,
                        state=state, tok=tok, lp=lp, tv=tv, ti=ti,
                        nbytes=tree_bytes(state))


@dataclasses.dataclass
class DisaggConfig:
    """queue_depth: most prefilled snapshots in flight between the
    pools; prefill stalls at the bound (backpressure)."""
    queue_depth: int = 8

    def validate(self) -> None:
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")


@dataclasses.dataclass(eq=False)
class _Item:
    """A submission moving through the pipeline.  Compared by identity
    (eq=False): field comparison would compare prompt arrays in
    ``deque.__contains__``."""
    prompt: np.ndarray
    params: SamplingParams
    seed: int
    kw: dict                      # decode-side submit_snapshot kwargs
    snap: Optional[Snapshot] = None
    req: Optional[Request] = None


class DisaggPipeline:
    """Prefill pool -> bounded transfer queue -> decode pool, both on the
    device ``EngineConfig.device`` names.

    In place of an Engine at the submit/run level: ``submit`` mirrors
    ``Engine.submit`` (without best-of-n, which forks decode-side state
    that does not exist at prefill time), ``run`` drives both pools to
    the end.  ``step``: fill the transfer queue up to its bound, drain it
    into free decode slots, one decode scheduler step."""

    def __init__(self, cfg, params, ecfg: EngineConfig,
                 dcfg: Optional[DisaggConfig] = None):
        self.dcfg = dcfg or DisaggConfig()
        self.dcfg.validate()
        self.worker = PrefillWorker(cfg, params, ecfg)
        self.decode = Engine(cfg, params, ecfg)
        self._pending: "collections.deque[_Item]" = collections.deque()
        self._queue: "collections.deque[_Item]" = collections.deque()
        self._n_submitted = 0
        # the transfers' accounting
        self.transfers = 0
        self.transfer_bytes = 0
        self.max_queue_depth = 0

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               max_new: Optional[int] = None,
               eos_id: Optional[int] = None,
               stream_cb=None, tenant: Optional[str] = None,
               session: bool = False, priority: int = 0) -> _Item:
        """``Engine.submit``'s mirror, through the decode engine's
        ``resolve`` and ``seed_for``: submission i is seeded as a
        monolithic engine's i-th, so the streams are its streams for the
        same order."""
        prompt, params = self.decode.resolve(prompt, params, max_new,
                                             eos_id, session, stream_cb)
        if params.n > 1:
            raise ValueError("disaggregated serving is single-stream "
                             "(best-of-n forks decode-side state)")
        seed = self.decode.seed_for(params, self._n_submitted)
        self._n_submitted += 1
        item = _Item(prompt=prompt, params=params, seed=seed,
                     kw=dict(stream_cb=stream_cb, tenant=tenant,
                             session=session, priority=priority))
        self._pending.append(item)
        return item

    def cancel(self, item: _Item) -> bool:
        """Cancel wherever the request is: before its prefill or in the
        transfer queue it is dropped; admitted, it cancels through the
        decode engine."""
        if item in self._pending:
            self._pending.remove(item)
            return True
        if item in self._queue:
            self._queue.remove(item)
            return True
        if item.req is not None:
            return self.decode.cancel(item.req.req_id)
        return False

    # -- drive --------------------------------------------------------------

    def step(self) -> bool:
        did = False
        # produce: prefill into the transfer queue up to its bound
        while self._pending and len(self._queue) < self.dcfg.queue_depth:
            item = self._pending.popleft()
            item.snap = self.worker.prefill(item.prompt, item.params,
                                            item.seed)
            self._queue.append(item)
            self.transfers += 1
            self.transfer_bytes += item.snap.nbytes
            self.max_queue_depth = max(self.max_queue_depth,
                                       len(self._queue))
            did = True
        # drain: one-scatter admissions into free decode slots
        while (self._queue and self.decode.pool.n_free
               > self.decode.n_ready):
            item = self._queue.popleft()
            item.req = self.decode.submit_snapshot(item.snap, **item.kw)
            did = True
        return self.decode.step() or did

    def busy(self) -> bool:
        return bool(self._pending or self._queue or self.decode.busy())

    def run(self) -> list:
        """Drive both pools until every request retires (sessions must be
        cancelled by the caller, as with ``Engine.run``).  Returns the
        decode engine's finished requests in completion order."""
        self.decode.start_run()
        while self.busy():
            self.step()
        return self.decode.end_run()

    def counters(self) -> dict:
        return {
            "transfers": self.transfers,
            "transfer_bytes": self.transfer_bytes,
            "max_queue_depth": self.max_queue_depth,
            "prefilled": self.worker.n_prefilled,
        }
