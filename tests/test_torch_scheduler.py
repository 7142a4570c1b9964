"""The SLO scheduler and the async front-end in the port on the CPU
(repro's ``test_scheduler.py`` and ``test_frontend.py``, case for case).

The scheduler is host-side only and its decisions (WFQ order, sheds, the
degradation ladder, the starvation bound) depend on submission order and
token counts alone.  ``test_decisions_equal_repros`` drives repro's
scheduler on a repro engine and the port's on a port engine, both over
the same bridged weights, through the same traces (WFQ under a burst,
shedding, the best-of-n ladder, the speculative-depth cap, the
multi-tenant trace), and holds every decision and every greedy stream
equal; the other cases also assert repro's recorded numbers.  The one
wall-clock surface (SLO violation accounting) runs under an injected
clock.  The front-end's streams are ``Engine.run``'s, bitwise.  Every
front-end test runs under a hard asyncio deadline.
"""
import asyncio
import dataclasses
import functools
import types

import numpy as np
import pytest

from repro.runtime import engine as jengine
from repro.runtime import sampling as jsampling
from repro.runtime import scheduler as jscheduler
from repro.runtime import spec_decode as jspec
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import sampling as tsampling
from repro_torch.runtime import scheduler as tscheduler
from repro_torch.runtime import spec_decode as tspec
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.frontend import AsyncFrontend
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import SchedConfig, SLOClass, SLOScheduler

from _torch_serving import CPU, model

DEADLINE_S = 120.0


def _package(eng_mod, samp_mod, sched_mod, spec_mod, port):
    def engine(vocab=64, **kw):
        jcfg, tcfg, jp, tp = model("mamba-130m", vocab=vocab)
        if port:
            return eng_mod.Engine(tcfg, tp, eng_mod.EngineConfig(
                device=CPU, **kw))
        return eng_mod.Engine(jcfg, jp, eng_mod.EngineConfig(**kw))
    return types.SimpleNamespace(
        engine=engine, SamplingParams=samp_mod.SamplingParams,
        SchedConfig=sched_mod.SchedConfig, SLOClass=sched_mod.SLOClass,
        SLOScheduler=sched_mod.SLOScheduler,
        DraftConfig=spec_mod.DraftConfig)


#: each package's serving front over the bridged smoke weights
PORT = _package(tengine, tsampling, tscheduler, tspec, port=True)
REPRO = _package(jengine, jsampling, jscheduler, jspec, port=False)


def _setup():
    _, cfg, _, params = model("mamba-130m")
    return cfg, params


def _ecfg(**kw):
    return EngineConfig(device=CPU, **kw)


def _prompt(rng, n=4):
    return rng.integers(1, 60, size=n)


class _Trace:
    """A scheduler over one package's engine that records the spec cap
    after every submission."""

    def __init__(self, pkg, scfg, **ecfg):
        self.eng = pkg.engine(**ecfg)
        self.sched = pkg.SLOScheduler(self.eng, scfg)
        self.caps = []

    def submit(self, *a, **kw):
        t = self.sched.submit(*a, **kw)
        self.caps.append(self.eng.spec_cap)
        return t

    def record(self):
        """Every decision, and the greedy streams in submission order."""
        sched = self.sched
        return dict(
            admitted=sched.admitted_order,
            tickets=[(t.tenant, t.shed, t.degraded, t.cost, t.start,
                      None if t.req is None else t.req.params.n)
                     for t in sched.tickets],
            starvation_bound=sched.starvation_bound,
            counters=sched.counters(), spec_caps=self.caps,
            greedy=[t.req.tokens for t in sched.tickets if t.req is not None
                    and t.req.params.temperature == 0.0],
            shed_per_tenant={k: v["shed"] for k, v in
                             self.eng.stats.summary()["per_tenant"].items()})


def _trace_wfq(pkg):
    """Tenant 'heavy' floods 10 requests before 'light' submits 3."""
    tr = _Trace(pkg, pkg.SchedConfig(
        weights={"heavy": 1.0, "light": 1.0},
        classes=(pkg.SLOClass(ttft_budget=10_000),)),
        n_slots=1, max_seq=32, seed=0)
    rng = np.random.default_rng(0)
    for _ in range(10):
        tr.submit(_prompt(rng), tenant="heavy", max_new=4)
    for _ in range(3):
        tr.submit(_prompt(rng), tenant="light", max_new=4)
    tr.done = tr.sched.run()
    return tr


def _trace_shed(pkg):
    """1 slot, cost 12 a request, TTFT budget 20 steps."""
    tr = _Trace(pkg, pkg.SchedConfig(
        weights={"t": 1.0}, classes=(pkg.SLOClass(ttft_budget=20),)),
        n_slots=1, max_seq=32, seed=0)
    rng = np.random.default_rng(2)
    tr.tickets = [tr.submit(_prompt(rng), tenant="t", max_new=8)
                  for _ in range(4)]
    tr.done = tr.sched.run()
    return tr


def _trace_ladder(pkg):
    """A best-of-n request admitted at n=1 under pressure, the next
    one shed past the budget."""
    tr = _Trace(pkg, pkg.SchedConfig(
        weights={"t": 1.0}, classes=(pkg.SLOClass(ttft_budget=20),),
        degrade_n_frac=0.5), n_slots=2, max_seq=32, seed=0)
    rng = np.random.default_rng(3)
    sp_n2 = pkg.SamplingParams(temperature=1.0, n=2, max_new=8, seed=9)
    # backlog 16/2 slots = 8 projected: over 0.5*20, under 20
    tr.submit(_prompt(rng), tenant="t", max_new=12)
    tr.submit(_prompt(rng), tenant="t", max_new=12)
    tr.deg = tr.submit(_prompt(rng), sp_n2, tenant="t")
    # push the backlog past the budget: next one sheds
    tr.shed = tr.submit(_prompt(rng), sp_n2, tenant="t")
    tr.done = tr.sched.run()
    return tr


def _trace_spec(pkg):
    """Backlog past spec_degrade_frac caps the speculative depth; a
    later submission with the backlog clear restores it."""
    tr = _Trace(pkg, pkg.SchedConfig(
        weights={"t": 1.0}, classes=(pkg.SLOClass(ttft_budget=100),),
        spec_degrade_frac=0.2), n_slots=1, max_seq=32, seed=0,
        draft=pkg.DraftConfig(k=3, layers=0))
    rng = np.random.default_rng(4)
    for _ in range(4):
        tr.submit(_prompt(rng), tenant="t", max_new=8)
    tr.done = tr.sched.run()
    tr.submit(_prompt(rng), tenant="t", max_new=8)      # backlog clear
    tr.sched.run()
    return tr


def _trace_multi_tenant(pkg, max_new=8):
    """serve_throughput's multi-tenant trace (``frontend_sched_comparison``
    at bench_ci's arguments: mamba-130m smoke, vocab 256, 2 slots, 8 new
    tokens)."""
    tr = _Trace(pkg, pkg.SchedConfig(
        weights={"burst": 1.0, "steady": 1.0, "premium": 4.0},
        classes=(pkg.SLOClass(name="standard", ttft_budget=64),
                 pkg.SLOClass(name="gold", ttft_budget=10_000,
                              sheddable=False)),
        default_class="standard"),
        vocab=256, n_slots=2, max_seq=24 + max_new + 8, seed=0)
    rng = np.random.default_rng(0)

    def prompt():
        return rng.integers(0, 256, size=(8,)).astype(np.int32)

    bo2 = pkg.SamplingParams(temperature=0.9, n=2, max_new=max_new, seed=5)
    for i in range(10):
        if i in (6, 7):
            tr.submit(prompt(), dataclasses.replace(bo2, seed=5 + i),
                      tenant="burst")
        else:
            tr.submit(prompt(), tenant="burst", max_new=max_new)
    for tenant in ("steady", "premium"):
        for _ in range(3):
            tr.submit(prompt(), tenant=tenant, max_new=max_new, slo="gold")
    tr.done = tr.sched.run()
    return tr


TRACES = {"wfq": _trace_wfq, "shed": _trace_shed, "ladder": _trace_ladder,
          "spec": _trace_spec, "multi_tenant": _trace_multi_tenant}


@functools.cache
def _port(name):
    """The port's run of a trace, shared by the parity case and the case
    that asserts repro's numbers (both only read it)."""
    return TRACES[name](PORT)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_decisions_equal_repros(name):
    """repro's scheduler on repro's engine and the port's on the port's,
    one trace, the same bridged weights: the admission order, each
    ticket's shed and degraded flags, cost and start tag, the starvation
    bound, the spec cap after every submission and the greedy streams
    are the same."""
    got, want = _port(name).record(), TRACES[name](REPRO).record()
    assert got["greedy"], name
    assert got == want


def test_wfq_no_starvation_under_adversarial_burst():
    """Equal weights and costs: start-time fair queuing interleaves the
    burst 1:1 — light's requests land in the first admissions instead of
    behind the flood, and no backlogged tenant is ever passed over more
    than twice between its own admissions."""
    tr = _port("wfq")
    assert len(tr.done) == 13
    order = tr.sched.admitted_order
    light_pos = [i for i, t in enumerate(order) if t == "light"]
    assert light_pos == [1, 3, 5], order
    assert tr.sched.starvation_bound <= 2
    assert tr.sched.counters()["shed"] == 0


def test_wfq_weights_bias_admission_share():
    """A weight-4 tenant's virtual finish advances 4x slower, so its
    backlog admits ~4:1 against a weight-1 tenant."""
    cfg, params = _setup()
    eng = Engine(cfg, params, _ecfg(n_slots=1, max_seq=32, seed=0))
    sched = SLOScheduler(eng, SchedConfig(
        weights={"heavy": 1.0, "premium": 4.0},
        classes=(SLOClass(ttft_budget=10_000),)))
    rng = np.random.default_rng(1)
    for _ in range(6):
        sched.submit(_prompt(rng), tenant="heavy", max_new=4)
    for _ in range(4):
        sched.submit(_prompt(rng), tenant="premium", max_new=4)
    sched.run()
    first5 = sched.admitted_order[:5]
    assert first5.count("premium") >= 3, sched.admitted_order
    assert sched.starvation_bound <= 4


def test_shed_exact_counts_before_budget_violation():
    """1-slot pool, cost 12 per request (4 prompt + 8 decode), TTFT
    budget 20 service steps: the third and fourth submissions project
    24 steps of wait and are shed AT THE DOOR — deterministically, by
    arithmetic, before any resident request is disturbed."""
    tr = _port("shed")
    assert [t.shed for t in tr.tickets] == [False, False, True, True]
    # shed requests never reached the engine; admitted ones ran to
    # their full budget untouched
    assert len(tr.done) == 2
    assert all(len(r.tokens) == 8 for r in tr.done)
    assert tr.eng.stats.n_shed == 2
    assert tr.eng.stats.summary()["per_tenant"]["t"]["shed"] == 2


def test_degradation_ladder_shrinks_best_of_n_then_sheds():
    """Between degrade_n_frac and 1.0 of the budget, a best-of-n
    request is admitted at n=1 (branch 0 is bitwise the n=1 serve)
    instead of shed; past the budget it sheds."""
    tr = _port("ladder")
    assert tr.deg.degraded and not tr.deg.shed
    assert tr.shed.shed
    assert tr.eng.stats.n_degraded == 1 and tr.eng.stats.n_shed == 1
    deg = tr.deg.req
    assert deg is not None and deg.params.n == 1
    assert len(deg.tokens) == 8
    assert len(tr.done) == 3


def test_spec_depth_capped_under_pressure_and_restored():
    """Rung 1: backlog past spec_degrade_frac caps speculative depth
    engine-wide (host-side only); a later low-pressure submit restores
    it."""
    tr = _port("spec")
    # projected backlog 0, 12, 24, 36 against 0.2 * 100, then clear
    assert tr.caps == [None, None, 1, 1, None]
    assert all(len(r.tokens) == 8 for r in tr.done)


def test_nonsheddable_class_never_rejected():
    """sheddable=False means degrade-only: under heavy overload every
    request is still admitted (and may violate, which is accounting's
    problem, not admission's)."""
    cfg, params = _setup()
    eng = Engine(cfg, params, _ecfg(n_slots=1, max_seq=32, seed=0))
    sched = SLOScheduler(eng, SchedConfig(
        weights={"t": 1.0},
        classes=(SLOClass(name="critical", ttft_budget=4,
                          sheddable=False),),
        default_class="critical"))
    rng = np.random.default_rng(5)
    for _ in range(6):
        sched.submit(_prompt(rng), tenant="t", max_new=8)
    done = sched.run()
    assert len(done) == 6
    assert eng.stats.n_shed == 0


def test_session_lease_excluded_from_capacity_projection():
    """A pinned session slot is capacity the projection must not count
    on: with 1 of 2 slots leased, queued work projects against ONE
    effective slot."""
    cfg, params = _setup()
    eng = Engine(cfg, params, _ecfg(n_slots=2, max_seq=16, seed=0))
    sched = SLOScheduler(eng, SchedConfig(
        weights={"t": 1.0}, classes=(SLOClass(ttft_budget=10_000),)))
    rng = np.random.default_rng(6)
    sess = sched.submit(_prompt(rng), tenant="t", session=True)
    sched.step()                       # admit + pin the session
    assert eng.pool.n_pinned == 1
    sched.submit(_prompt(rng), tenant="t", max_new=8)   # cost 12 queued
    assert sched.projected_wait() == pytest.approx(12.0)
    eng.cancel(sess.req.req_id)
    sched.run()


def test_slo_violation_accounting_with_fake_clock():
    """Wall-clock SLO budgets count violations per tenant — under an
    injected clock (1s per reading), every request blows a 1ms TTFT
    budget, deterministically."""
    cfg, params = _setup()
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    eng = Engine(cfg, params, _ecfg(n_slots=2, max_seq=32, seed=0),
                 clock=clock)
    sched = SLOScheduler(eng, SchedConfig(
        weights={"a": 1.0, "b": 1.0},
        classes=(SLOClass(ttft_budget=10_000, ttft_slo_s=0.001,
                          tpot_slo_s=0.001),)))
    rng = np.random.default_rng(7)
    for tenant in ("a", "a", "b"):
        sched.submit(_prompt(rng), tenant=tenant, max_new=4)
    sched.run()
    s = eng.stats.summary()
    assert s["slo_ttft_violations"] == 3
    assert s["slo_tpot_violations"] == 3
    assert s["per_tenant"]["a"]["slo_ttft_violations"] == 2
    assert s["per_tenant"]["b"]["slo_ttft_violations"] == 1
    # TPOT distributions populated alongside TTFT
    assert s["tpot_p95_s"] > 0 and s["per_tenant"]["a"]["tpot_p95_s"] > 0


def test_cancelled_requests_stay_out_of_percentiles():
    """A cancelled request contributes to n_cancelled, never to the
    TTFT/TPOT/latency distributions."""
    cfg, params = _setup()
    eng = Engine(cfg, params, _ecfg(n_slots=1, max_seq=32, seed=0))
    rng = np.random.default_rng(8)
    keep = eng.submit(_prompt(rng), max_new=4, tenant="t")
    kill = eng.submit(_prompt(rng), max_new=4, tenant="t")
    eng.step()
    eng.cancel(kill.req_id)
    eng.run()
    s = eng.stats.summary()
    assert s["requests"] == 1 and s["cancelled"] == 1
    assert len(eng.stats._ttft) == 1
    assert s["per_tenant"]["t"]["requests"] == 1
    assert keep.finished and len(keep.tokens) == 4


# ---------------------------------------------------------------------------
# The async front-end
# ---------------------------------------------------------------------------

def _run(coro):
    asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def test_stream_tokens_match_engine_run():
    """The async iterator delivers exactly the tokens a plain
    ``Engine.run`` of the same submissions produces (bitwise — the
    front-end is plumbing, not math), including sampled streams."""
    cfg, params = _setup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 60, size=6) for _ in range(4)]
    sps = [SamplingParams(max_new=5),
           SamplingParams(temperature=0.8, top_k=8, max_new=5, seed=3),
           SamplingParams(max_new=5),
           SamplingParams(temperature=1.1, top_p=0.9, max_new=5, seed=4)]

    ref_eng = Engine(cfg, params, _ecfg(n_slots=2, max_seq=32, seed=1))
    for p, sp in zip(prompts, sps):
        ref_eng.submit(p, sp)
    ref = [r.tokens for r in sorted(ref_eng.run(),
                                    key=lambda r: r.req_id)]

    async def main():
        eng = Engine(cfg, params, _ecfg(n_slots=2, max_seq=32, seed=1))
        async with AsyncFrontend(eng) as fe:
            handles = [await fe.submit(p, sp)
                       for p, sp in zip(prompts, sps)]
            streams = []
            for h in handles:
                toks = [t async for t in h.tokens()]
                req = await h.result()
                assert req.tokens == toks
                streams.append(toks)
        assert streams == ref

    _run(main())


def test_concurrent_consumers_interleave():
    """Two clients consuming their streams concurrently each see their
    own complete stream."""
    cfg, params = _setup()
    rng = np.random.default_rng(1)

    async def main():
        eng = Engine(cfg, params, _ecfg(n_slots=2, max_seq=32, seed=2))
        async with AsyncFrontend(eng) as fe:
            ha = await fe.submit(rng.integers(1, 60, size=6), max_new=6)
            hb = await fe.submit(rng.integers(1, 60, size=6), max_new=6)

            async def consume(h):
                return [t async for t in h.tokens()]

            ta, tb = await asyncio.gather(consume(ha), consume(hb))
            ra, rb = await ha.result(), await hb.result()
            assert ra.tokens == ta and rb.tokens == tb
            assert len(ta) == 6 and len(tb) == 6

    _run(main())


def test_cancel_mid_stream_ends_iterator():
    cfg, params = _setup()
    rng = np.random.default_rng(2)

    async def main():
        eng = Engine(cfg, params, _ecfg(n_slots=1, max_seq=64, seed=0,
                                        sched_quantum=2))
        async with AsyncFrontend(eng) as fe:
            h = await fe.submit(rng.integers(1, 60, size=5), max_new=40)
            got = []
            async for tok in h.tokens():
                got.append(tok)
                if len(got) == 4:
                    await fe.cancel(h)
            req = await h.result()
            assert req.cancelled and req.finished
            # tokens already delivered stand; no unbounded overrun past
            # the cancel sync
            assert len(got) >= 4 and len(got) < 40

    _run(main())


def test_shed_handle_resolves_with_empty_stream():
    """Admission-control rejection IS the response: the handle resolves
    immediately, shed=True, zero tokens.  Deterministic under the
    concurrent pump: a session pins the ONLY slot, so the projected
    wait for the next request is inf regardless of decode progress."""
    cfg, params = _setup()
    rng = np.random.default_rng(3)

    async def main():
        eng = Engine(cfg, params, _ecfg(n_slots=1, max_seq=16, seed=0))
        sched = SLOScheduler(eng, SchedConfig(
            weights={"t": 1.0}, classes=(SLOClass(ttft_budget=20),)))
        async with AsyncFrontend(eng, sched) as fe:
            sess = await fe.submit(rng.integers(1, 60, size=4),
                                   tenant="t", session=True)
            # one token out => the session is admitted and its lease
            # pinned; from here effective slots == 0, projection == inf
            agen = sess.tokens()
            await agen.__anext__()
            await agen.aclose()
            shed = await fe.submit(rng.integers(1, 60, size=4),
                                   tenant="t", max_new=8)
            assert shed.shed
            toks = [t async for t in shed.tokens()]
            assert toks == [] and await shed.result() is None
            await fe.cancel(sess)
            res = await sess.result()
            assert res.cancelled
        assert eng.stats.n_shed == 1

    _run(main())


def test_tenant_context_binds_labels():
    cfg, params = _setup()
    rng = np.random.default_rng(4)

    async def main():
        eng = Engine(cfg, params, _ecfg(n_slots=2, max_seq=32, seed=0))
        sched = SLOScheduler(eng, SchedConfig(
            weights={"acme": 2.0}, classes=(SLOClass(ttft_budget=999),)))
        async with AsyncFrontend(eng, sched) as fe:
            acme = fe.tenant("acme")
            h = await acme.submit(rng.integers(1, 60, size=5), max_new=4)
            req = await h.result()
            assert req.tenant == "acme"
        assert eng.stats.summary()["per_tenant"]["acme"]["requests"] == 1

    _run(main())


def test_stop_drains_infinite_session():
    """Context-manager exit cancels live sessions so no slot stays
    pinned and every handle resolves — the eviction-free lease ends
    with the connection."""
    cfg, params = _setup()
    rng = np.random.default_rng(5)

    async def main():
        eng = Engine(cfg, params, _ecfg(n_slots=2, max_seq=16, seed=0))
        async with AsyncFrontend(eng) as fe:
            h = await fe.submit(rng.integers(1, 60, size=4),
                                session=True)
            got = []
            async for tok in h.tokens():
                got.append(tok)
                if len(got) >= 12:
                    break                 # client walks away mid-stream
            assert eng.pool.n_pinned == 1
        # __aexit__ drained: session cancelled, lease released
        assert eng.pool.n_pinned == 0
        assert h.finished and h.req.cancelled
        assert len(h.req.tokens) >= 12

    _run(main())


def test_submit_before_start_raises():
    cfg, params = _setup()

    async def main():
        eng = Engine(cfg, params, _ecfg(n_slots=1, max_seq=32))
        fe = AsyncFrontend(eng)
        with pytest.raises(RuntimeError, match="not started"):
            await fe.submit(np.arange(1, 5), max_new=4)

    _run(main())


def test_multi_tenant_trace_counts():
    """The multi-tenant trace gives repro's recorded counts
    (BENCH_PR10.json): 14 admitted (8 burst, 3 steady, 3 premium), 2
    shed (both burst), 1 degraded, starvation bound 4, 119 useful tokens;
    every admitted request gets its full budget."""
    tr = _port("multi_tenant")
    c = tr.sched.counters()
    s = tr.eng.stats.summary()
    assert (c["admitted"], c["shed"], c["degraded"]) == (14, 2, 1)
    assert c["starvation_bound"] == 4
    assert c["admitted_per_tenant"] == {"burst": 8, "steady": 3,
                                        "premium": 3}
    assert {t: s["per_tenant"][t]["shed"] for t in s["per_tenant"]} == \
        {"burst": 2, "steady": 0, "premium": 0}
    assert len(tr.done) == 14 and s["useful_tokens"] == 119
    assert all(len(r.tokens) == 8 for r in tr.done)
