"""Prefill/decode disaggregation and infinite-stream sessions in the port
on the CPU (repro's ``test_disagg.py``, case for case).

- ``DisaggPipeline`` streams (greedy and sampled) and cumulative
  logprobs are bitwise the port's monolithic engine's, for mamba, jamba
  and xLSTM with an f32 and an int8 state; the decode pool runs no
  prefill; the queue is bounded; a snapshot of another layout is
  refused; cancel works at every stage.
- Sessions: the pool's leaves keep their shapes and bytes past max_seq,
  the slot is pinned (``evict`` refuses it), jamba is refused (its KV
  strips grow with max_seq: the meta-device probe), sessions coexist
  with bounded requests and with disaggregation.
- serve_throughput's disaggregation trace with repro's recorded counts.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import registry as tregistry
from repro_torch.runtime.disagg import (DisaggConfig, DisaggPipeline,
                                        PrefillWorker)
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.sampling import SamplingParams

from _torch_inputs import tree_equal
from _torch_serving import ARCHS, CPU, engine, model


def _ecfg(**kw):
    return EngineConfig(device=CPU, **kw)


def _mixed_requests(rng, n=5, max_new=6):
    out = []
    for i in range(n):
        prompt = rng.integers(1, 60, size=int(rng.integers(4, 12)))
        params = (SamplingParams(max_new=max_new) if i % 2 == 0 else
                  SamplingParams(temperature=0.9, top_k=12,
                                 max_new=max_new))
        out.append((prompt, params))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_disagg_bitwise_identical_to_monolithic(arch, state_dtype):
    _, tcfg, _, tp = model(arch)
    reqs = _mixed_requests(np.random.default_rng(3), n=2, max_new=4)
    kw = dict(n_slots=2, max_seq=48, seed=11, state_dtype=state_dtype)
    mono = Engine(tcfg, tp, _ecfg(**kw))
    for prompt, sp in reqs:
        mono.submit(prompt, sp)
    ref = {r.req_id: (r.tokens, r.cum_logprob) for r in mono.run()}
    pipe = DisaggPipeline(tcfg, tp, _ecfg(**kw), DisaggConfig(queue_depth=3))
    items = [pipe.submit(prompt, sp) for prompt, sp in reqs]
    pipe.run()
    assert pipe.decode.stats.snapshot_admits == len(reqs)
    assert pipe.decode.stats.prefill_tokens == 0
    assert pipe.worker.engine.device == pipe.decode.device == \
        torch.device(CPU)
    for i, item in enumerate(items):
        assert (item.req.tokens, item.req.cum_logprob) == ref[i], i
        assert item.snap.nbytes == mono.pool.state_bytes_per_slot()


def test_snapshot_owns_its_state():
    """The shipped state is a copy: it stays bitwise what the worker
    exported while the worker's pool takes the next prompts."""
    _, tcfg, _, tp = model("mamba-130m")
    worker = PrefillWorker(tcfg, tp, _ecfg(n_slots=1, max_seq=48, seed=0))
    snap = worker.prefill(np.arange(1, 9), SamplingParams(max_new=4), 1)
    kept = tregistry.tree_map(torch.clone, snap.state)
    for n in (5, 7):
        worker.prefill(np.arange(2, 2 + n), SamplingParams(max_new=4), 2)
    assert tree_equal(snap.state, kept)
    assert all(t.device.type == "cpu"
               for t in tregistry.tree_leaves(snap.state))


def test_bounded_transfer_queue_backpressure():
    _, tcfg, _, tp = model("mamba-130m")
    pipe = DisaggPipeline(tcfg, tp, _ecfg(n_slots=1, max_seq=48, seed=0),
                          DisaggConfig(queue_depth=1))
    rng = np.random.default_rng(0)
    items = [pipe.submit(rng.integers(1, 60, size=6), max_new=4)
             for _ in range(5)]
    assert len(pipe.run()) == 5
    assert pipe.max_queue_depth == 1 and pipe.transfers == 5
    assert pipe.transfer_bytes == 5 * items[0].snap.nbytes


def test_snapshot_layout_mismatch_rejected():
    _, tcfg, _, tp = model("mamba-130m")
    worker = PrefillWorker(tcfg, tp, _ecfg(n_slots=1, max_seq=48, seed=0,
                                           state_dtype="f32"))
    snap = worker.prefill(np.arange(1, 7), SamplingParams(max_new=4), seed=1)
    other = Engine(tcfg, tp, _ecfg(n_slots=2, max_seq=48,
                                   state_dtype="int8"))
    with pytest.raises(ValueError, match="does not match"):
        other.submit_snapshot(snap)


def test_disagg_rejects_best_of_n():
    _, tcfg, _, tp = model("mamba-130m")
    pipe = DisaggPipeline(tcfg, tp, _ecfg(n_slots=2, max_seq=48))
    with pytest.raises(ValueError, match="single-stream"):
        pipe.submit(np.arange(1, 5), SamplingParams(n=2, temperature=1.0,
                                                    max_new=4))


def test_pipeline_cancel_at_every_stage():
    _, tcfg, _, tp = model("mamba-130m")
    pipe = DisaggPipeline(tcfg, tp, _ecfg(n_slots=1, max_seq=48, seed=0),
                          DisaggConfig(queue_depth=1))
    rng = np.random.default_rng(1)
    items = [pipe.submit(rng.integers(1, 60, size=6), max_new=4)
             for _ in range(4)]
    assert pipe.cancel(items[3])          # still pending
    pipe.step()
    while pipe.busy():
        if items[1] in pipe._queue:
            assert pipe.cancel(items[1])
        if items[0].req is not None and not items[0].req.finished:
            pipe.cancel(items[0])          # admitted: engine-side cancel
        pipe.step()
    ids = {r.req_id for r in pipe.decode._finished}
    assert items[2].req is not None and items[2].req.req_id in ids
    assert items[2].req.tokens and not items[2].req.cancelled
    assert items[3].req is None


# ---------------------------------------------------------------------------
# Infinite-stream sessions
# ---------------------------------------------------------------------------

def _shapes(cache):
    return [(t.shape, t.numel() * t.element_size())
            for t in tregistry.tree_leaves(cache)]


@pytest.mark.parametrize("arch", ["mamba-130m", "xlstm-350m"])
def test_session_state_bytes_constant_past_horizon(arch):
    _, tcfg, _, tp = model(arch)
    eng = Engine(tcfg, tp, _ecfg(n_slots=2, max_seq=16, seed=3))
    assert not eng._cache_growable
    req = eng.submit(np.arange(1, 6), max_new=8, session=True)
    shapes0, bytes0 = _shapes(eng.pool.cache), eng.pool.state_bytes_per_slot()
    while len(req.tokens) < 3 * 8:
        eng.step()
        assert _shapes(eng.pool.cache) == shapes0
        assert eng.pool.state_bytes_per_slot() == bytes0
    assert len(req.tokens) >= 24 > 16
    assert eng.pool.n_pinned == 1
    eng.cancel(req.req_id)
    eng.step()
    assert req.finished and eng.pool.n_pinned == 0


def test_session_ends_on_a_stop_id():
    """A session has no token horizon: it ends on its stop id, and its
    slot is unpinned and freed."""
    _, tcfg, _, tp = model("mamba-130m")
    probe = engine(tcfg, tp, n_slots=1, max_seq=16)
    sess = probe.submit(np.arange(1, 6), session=True)
    while len(sess.tokens) < 24:
        probe.step()
    stop = sess.tokens[20]
    eng = engine(tcfg, tp, n_slots=1, max_seq=16)
    req = eng.submit(np.arange(1, 6), session=True, eos_id=stop)
    eng.run()
    assert req.finished and not req.cancelled
    assert req.tokens == sess.tokens[:sess.tokens.index(stop) + 1]
    assert eng.pool.n_pinned == 0 and eng.pool.n_free == 1


def test_session_refused_for_growable_cache():
    _, tcfg, _, tp = model("jamba-v0.1-52b")
    eng = Engine(tcfg, tp, _ecfg(n_slots=1, max_seq=16))
    assert eng._cache_growable
    with pytest.raises(ValueError, match="max_seq-independent"):
        eng.submit(np.arange(1, 5), session=True)


def test_session_slot_pinned_against_evict():
    _, tcfg, _, tp = model("mamba-130m")
    eng = Engine(tcfg, tp, _ecfg(n_slots=2, max_seq=16))
    req = eng.submit(np.arange(1, 5), session=True)
    eng.step()
    slot = eng._slot_req.index(req)
    assert eng.pool.is_pinned(slot)
    with pytest.raises(RuntimeError, match="eviction-free lease"):
        eng.pool.evict(slot)
    eng.cancel(req.req_id)
    eng.step()
    assert not eng.pool.is_pinned(slot)


def test_session_coexists_with_bounded_requests():
    _, tcfg, _, tp = model("mamba-130m")
    eng = Engine(tcfg, tp, _ecfg(n_slots=2, max_seq=32, seed=5))
    sess = eng.submit(np.arange(1, 5), session=True)
    rng = np.random.default_rng(2)
    bounded = [eng.submit(rng.integers(1, 60, size=6), max_new=5)
               for _ in range(3)]
    while not all(r.finished for r in bounded):
        eng.step()
    assert all(len(r.tokens) == 5 for r in bounded)
    assert not sess.finished and len(sess.tokens) > 0
    eng.cancel(sess.req_id)
    eng.step()


def test_disagg_session_streams():
    _, tcfg, _, tp = model("mamba-130m")
    pipe = DisaggPipeline(tcfg, tp, _ecfg(n_slots=1, max_seq=16, seed=0))
    item = pipe.submit(np.arange(1, 6), session=True)
    while item.req is None or len(item.req.tokens) < 40:
        pipe.step()
    assert pipe.decode.pool.n_pinned == 1
    pipe.cancel(item)
    pipe.step()
    assert item.req.finished and pipe.decode.pool.n_pinned == 0


def test_disagg_trace_counts():
    """serve_throughput's disaggregation trace (``disagg_comparison`` at
    bench_ci's arguments: mamba-130m smoke, vocab 256, 2 slots, 6 mixed
    requests, 8 new tokens, queue depth 2): streams bitwise the
    monolithic engine's, and repro's recorded counts (BENCH_PR10.json):
    6 transfers of 38,916 B, the queue at its bound, 6 snapshot
    admissions of 120 prompt tokens, no decode-side prefill."""
    _, tcfg, _, tp = model("mamba-130m", vocab=256)
    rng = np.random.default_rng(0)
    lens, max_new = (8, 12, 16, 24), 8
    max_seq = max(lens) + max_new + 8
    trace = []
    for i in range(6):
        p = rng.integers(0, tcfg.vocab,
                         size=(int(rng.choice(lens)),)).astype(np.int32)
        sp = (SamplingParams(max_new=max_new) if i % 2 == 0 else
              SamplingParams(temperature=0.9, top_k=12, max_new=max_new))
        trace.append((p, sp))
    mono = Engine(tcfg, tp, _ecfg(n_slots=2, max_seq=max_seq, seed=0))
    for p, sp in trace:
        mono.submit(p, sp)
    ref = {r.req_id: (r.tokens, r.cum_logprob) for r in mono.run()}
    pipe = DisaggPipeline(tcfg, tp, _ecfg(n_slots=2, max_seq=max_seq,
                                          seed=0),
                          DisaggConfig(queue_depth=2))
    items = [pipe.submit(p, sp) for p, sp in trace]
    pipe.run()
    assert all((it.req.tokens, it.req.cum_logprob) == ref[i]
               for i, it in enumerate(items))
    s = pipe.decode.stats.summary()
    c = pipe.counters()
    assert (c["transfers"], c["transfer_bytes"]) == (6, 6 * 38916)
    assert c["max_queue_depth"] == 2
    assert (s["snapshot_admits"], s["snapshot_tokens"]) == (6, 120)
    assert s["prefill_tokens"] == 0 and s["useful_tokens"] == 48
