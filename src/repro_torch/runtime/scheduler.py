"""SLO-aware multi-tenant admission scheduler for the serving engine
(port of ``repro/runtime/scheduler.py``; host-side only, it runs on the
device of the engine it wraps and launches nothing itself).

The engine's own policy (engine.py ``step``) is admit-eagerly by
priority — correct for one cooperative client, wrong for a shared
front door: one tenant bursting 50 requests starves everyone behind
it, and admission control that only looks at free slots happily queues
an hour of work against a 200 ms TTFT budget.  This module holds the
requests OUTSIDE the engine and releases them by policy:

Weighted fair queuing (start-time virtual clock).  Each tenant has a
weight; each request a cost in *service units* (prompt tokens +
max_new * n — the token work the engine will spend on it).  On submit
the request is stamped ``start = max(V, tenant_finish)`` and the
tenant's virtual finish advances by ``cost / weight``; release always
picks the smallest start tag across tenant-queue heads (FIFO within a
tenant).  This is textbook SFQ: a tenant's share of admissions
converges to its weight share, and no backlogged tenant waits more
than one maximal request per competing tenant between its own
admissions — the no-starvation bound the tests assert
deterministically via ``starvation_bound``.

SLO classes + load shedding.  Every request carries an SLOClass with a
TTFT budget in deterministic service STEPS (never wall-clock, which
would make decisions depend on the host): the projected queue wait for
a new request is ``(resident remaining tokens + queued cost) /
effective slots``, where effective slots excludes pinned session
leases.  The degradation ladder runs at submit, cheapest remedy first,
so resident requests keep their slots and their pace *before*
anything is refused:

  1. projected > spec_degrade_frac * budget: cap speculative depth
     engine-wide (``Engine.spec_cap = 1``) — sheds draft/verify work,
     token streams unchanged (depth is data, not distribution);
  2. projected > degrade_n_frac * budget: admit best-of-n requests at
     n=1 (cost shrinks n-fold; counted in ``n_degraded``);
  3. projected > budget: reject (shed) if the class allows it —
     counted, never submitted, ``Ticket.shed`` True.  Non-sheddable
     classes are always admitted and may violate (the wall-clock SLO
     accounting in ``finalize`` counts that, decisions never read it).

Determinism: every decision above is a function of (submission order,
token counts, config) only.  Wall-clock appears exactly once — in
``finalize``'s per-tenant violation accounting, which feeds dashboards
and uses the engine's injectable clock, so tests pin it.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.runtime.engine import Engine
from repro_torch.runtime.sampling import SamplingParams


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One request class's service-level objective.

    ttft_budget: admission-control budget in deterministic service
      steps (projected decode-step-equivalents of queue wait) — the
      shed/degrade ladder compares against this, never wall-clock.
    ttft_slo_s / tpot_slo_s: optional wall-clock budgets for
      *accounting* (violation counters in ServeStats); decisions never
      read them.
    sheddable: False = never rejected (degrade only; may violate)."""
    name: str = "standard"
    ttft_budget: int = 256
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    sheddable: bool = True


@dataclasses.dataclass
class SchedConfig:
    """weights: tenant -> WFQ weight (unknown tenants get 1.0).
    classes: available SLOClasses; default_class names the fallback.
    spec_degrade_frac / degrade_n_frac: ladder thresholds as fractions
    of the request's class ttft_budget.  session_cost: WFQ cost charge
    for an infinite-stream session (its true cost is unbounded; this
    is the admission-fairness charge for taking a slot out of the
    pool)."""
    weights: dict = dataclasses.field(
        default_factory=lambda: {"default": 1.0})
    classes: tuple = (SLOClass(),)
    default_class: str = "standard"
    spec_degrade_frac: float = 0.5
    degrade_n_frac: float = 0.75
    session_cost: int = 256

    def validate(self) -> None:
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")
        if self.default_class not in names:
            raise ValueError(f"default_class {self.default_class!r} "
                             f"not in classes {names}")
        if not (0.0 < self.spec_degrade_frac
                <= self.degrade_n_frac <= 1.0):
            raise ValueError(
                "need 0 < spec_degrade_frac <= degrade_n_frac <= 1 "
                "(the ladder runs cheapest remedy first)")
        for w in self.weights.values():
            if w <= 0:
                raise ValueError("tenant weights must be > 0")


@dataclasses.dataclass
class Ticket:
    """The scheduler's handle for one submission.  ``req`` is None
    until release (and stays None forever when shed)."""
    tenant: str
    slo: SLOClass
    cost: int
    start: float                     # WFQ start tag
    seq: int                         # global FIFO tiebreak
    shed: bool = False
    degraded: bool = False           # best-of-n shrunk to 1
    req: Optional[object] = None
    _kw: dict = dataclasses.field(default_factory=dict, repr=False)


class SLOScheduler:
    """Admission front door over an Engine.  Hold -> decide -> release.

    Usage::

        sched = SLOScheduler(engine, SchedConfig(...))
        t = sched.submit(prompt, params, tenant="acme", slo="premium")
        if t.shed: ...           # rejected at the door
        done = sched.run()       # drives engine to completion
    """

    def __init__(self, engine: Engine, scfg: Optional[SchedConfig] = None):
        self.engine = engine
        self.cfg = scfg or SchedConfig()
        self.cfg.validate()
        self._classes = {c.name: c for c in self.cfg.classes}
        self._queues: dict[str, collections.deque] = {}
        self._vtime = 0.0
        self._finish: dict[str, float] = {}   # per-tenant virtual finish
        self._seq = 0
        self._n_queued = 0
        self._queued_cost = 0
        # deterministic fairness audit trail: tenant name per admission,
        # and the worst pass-over count any backlogged tenant suffered
        self.admitted_order: list[str] = []
        self.starvation_bound = 0
        self._waited: dict[str, int] = {}
        self.tickets: list[Ticket] = []

    # -- projections (all deterministic service-step arithmetic) ------------

    def _weight(self, tenant: str) -> float:
        return float(self.cfg.weights.get(tenant, 1.0))

    def _effective_slots(self) -> int:
        """Slots admission can ever reuse: pinned session leases are
        never evicted, so they are capacity the projection must not
        count on."""
        return self.engine.ecfg.n_slots - self.engine.pool.n_pinned

    def _resident_cost(self) -> int:
        """Remaining token work held by live non-session slots."""
        total = 0
        for req in self.engine._slot_req:
            if req is not None and not req.session:
                total += max(0, req.max_new - len(req.tokens))
        return total

    def projected_wait(self) -> float:
        """Service steps a request submitted NOW waits before a slot
        frees for it: all resident + queued work divided across the
        effective slots.  inf when sessions pinned every slot."""
        eff = self._effective_slots()
        backlog = self._resident_cost() + self._queued_cost + sum(
            e[2].params.max_new * e[2].params.n for e in
            self.engine._ready)
        if eff <= 0:
            return float("inf")
        return backlog / eff

    @staticmethod
    def _cost_of(prompt_len: int, params: SamplingParams,
                 session: bool, session_cost: int) -> int:
        if session:
            return prompt_len + session_cost
        return prompt_len + params.max_new * params.n

    # -- intake -------------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               tenant: str = "default", slo: Optional[str] = None,
               session: bool = False, **engine_kw) -> Ticket:
        """Admission-control a request and queue it for WFQ release.

        Runs the degradation ladder against the current projected wait
        (see module docstring); a shed ticket never reaches the engine.
        ``engine_kw`` passes through to ``Engine.submit`` (max_new,
        eos_id, stream_cb, ...)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        params = (params if params is not None
                  else self.engine.ecfg.default_params)
        if "max_new" in engine_kw and engine_kw["max_new"] is not None:
            params = dataclasses.replace(params,
                                         max_new=engine_kw.pop("max_new"))
        cls = self._classes[slo or self.cfg.default_class]
        projected = self.projected_wait()
        self._update_pressure(projected)
        degraded = False
        if (projected > self.cfg.degrade_n_frac * cls.ttft_budget
                and params.n > 1):
            # rung 2: a best-of-n under pressure costs n slots and n
            # streams — collapse to the single branch 0 stream (which
            # is bitwise the n=1 serve of the same request) instead of
            # shedding it outright
            params = dataclasses.replace(params, n=1)
            degraded = True
        if projected > cls.ttft_budget and cls.sheddable:
            t = Ticket(tenant=tenant, slo=cls, cost=0, start=self._vtime,
                       seq=self._seq, shed=True)
            self._seq += 1
            self.tickets.append(t)
            self.engine.stats.record_shed(tenant)
            return t
        if degraded:
            self.engine.stats.record_degraded(tenant)
        cost = self._cost_of(int(prompt.size), params, session,
                             self.cfg.session_cost)
        start = max(self._vtime, self._finish.get(tenant, 0.0))
        self._finish[tenant] = start + cost / self._weight(tenant)
        t = Ticket(tenant=tenant, slo=cls, cost=cost, start=start,
                   seq=self._seq, degraded=degraded,
                   _kw=dict(engine_kw, params=params, session=session))
        t._kw["prompt"] = prompt
        self._seq += 1
        self._queues.setdefault(tenant, collections.deque()).append(t)
        self._n_queued += 1
        self._queued_cost += cost
        self.tickets.append(t)
        return t

    def _update_pressure(self, projected: float) -> None:
        """Rung 1 of the ladder: under pressure, cap speculative depth
        engine-wide.  Depth is pure host-side arithmetic (engine
        ``_slot_depth``), so flipping the cap never changes a token — it
        sheds draft/verify dispatches only.
        Threshold uses the default class's budget (engine-wide knob,
        engine-wide reference point); restored as soon as the backlog
        clears it."""
        if self.engine._spec is None:
            return
        budget = self._classes[self.cfg.default_class].ttft_budget
        over = projected > self.cfg.spec_degrade_frac * budget
        self.engine.spec_cap = 1 if over else None

    # -- release ------------------------------------------------------------

    def _committed(self) -> int:
        """Slots the engine's ready queue will consume once admitted."""
        return sum(e[2].params.n for e in self.engine._ready)

    def release(self) -> int:
        """Move queued tickets into the engine while capacity allows,
        smallest WFQ start tag first (seq breaks ties FIFO).  Returns
        the number released.  Also the fairness audit point: every
        release that passes over a backlogged tenant bumps its waited
        counter, and ``starvation_bound`` records the worst wait any
        tenant's head-of-queue ever saw."""
        released = 0
        while self._n_queued:
            free = self.engine.pool.n_free - self._committed()
            head = None
            for tenant, q in self._queues.items():
                if not q:
                    continue
                cand = q[0]
                if head is None or (cand.start, cand.seq) < (head.start,
                                                             head.seq):
                    head = cand
            if head is None:
                break
            if head._kw["params"].n > free:
                break
            self._queues[head.tenant].popleft()
            self._n_queued -= 1
            self._queued_cost -= head.cost
            self._vtime = max(self._vtime, head.start)
            # fairness audit: everyone else still backlogged was passed
            # over by this admission
            self.starvation_bound = max(self.starvation_bound,
                                        self._waited.get(head.tenant, 0))
            self._waited[head.tenant] = 0
            for tenant, q in self._queues.items():
                if q and tenant != head.tenant:
                    self._waited[tenant] = self._waited.get(tenant, 0) + 1
            kw = dict(head._kw)
            head.req = self.engine.submit(
                kw.pop("prompt"), kw.pop("params"), tenant=head.tenant,
                **kw)
            self.admitted_order.append(head.tenant)
            released += 1
        return released

    # -- drive --------------------------------------------------------------

    def step(self) -> bool:
        did = self.release() > 0
        return self.engine.step() or did

    def run(self) -> list:
        """Release + step until every queued and resident request
        retires.  Infinite-stream sessions never retire on their own —
        cancel them (or run the loop yourself) before calling this
        with sessions resident.  Returns the engine's finished list and
        runs the wall-clock SLO accounting over it."""
        eng = self.engine
        eng.stats.start()
        eng._finished = []
        while True:
            did = self.step()
            if (not did and not self._n_queued and not eng._ready
                    and not eng.pool.n_active):
                break
        eng.stats.stop()
        self.finalize(eng._finished)
        return eng._finished

    def finalize(self, finished: list) -> None:
        """Wall-clock SLO violation accounting (the only place the
        scheduler touches time, via the engine's injectable clock).
        Cancelled requests are excluded — a client that hung up cannot
        violate an SLO it stopped caring about."""
        by_req = {id(t.req): t for t in self.tickets if t.req is not None}
        for req in finished:
            t = by_req.get(id(req))
            if t is None or req.cancelled or req.t_first is None:
                continue
            cls = t.slo
            ttft = req.t_first - req.t_submit
            if cls.ttft_slo_s is not None and ttft > cls.ttft_slo_s:
                self.engine.stats.record_slo_violation("ttft", t.tenant)
            if (cls.tpot_slo_s is not None and len(req.tokens) > 1
                    and req.t_done is not None):
                tpot = (req.t_done - req.t_first) / (len(req.tokens) - 1)
                if tpot > cls.tpot_slo_s:
                    self.engine.stats.record_slo_violation("tpot",
                                                           t.tenant)

    # -- audit --------------------------------------------------------------

    def counters(self) -> dict:
        return {
            "admitted": len(self.admitted_order),
            "shed": sum(1 for t in self.tickets if t.shed),
            "degraded": sum(1 for t in self.tickets if t.degraded),
            "starvation_bound": self.starvation_bound,
            "admitted_per_tenant": dict(collections.Counter(
                self.admitted_order)),
        }
