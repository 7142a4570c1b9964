"""The port's serving stack on the CPU: Engine greedy streams against
repro's Engine on the same (bridged) weights, with f32 and with
quantized state and weights, the slot pool's byte count and hygiene,
sampling against repro's filter and logprob math, the request lifecycle
(stops, cancel, streams, priority), Server and the CLI, and what the
port refuses because it is not ported yet."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro.runtime import engine as jengine
from repro.runtime import sampling as jsampling
from repro.runtime.state_pool import SlotStatePool as JPool
from repro_torch import bridge, resolve_device
from repro_torch import configs as tconfigs
from repro_torch.core import state_quant
from repro_torch.kernels import ref
from repro_torch.launch import serve as tlaunch
from repro_torch.models import registry as tregistry
from repro_torch.runtime import sampling as tsampling
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.serve import ServeConfig, Server
from repro_torch.runtime.spec_decode import DraftConfig
from repro_torch.runtime.state_pool import SlotStatePool

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"


def _cfgs(**kw):
    kw = {"vocab": 64, "dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.smoke_variant(
                jconfigs.get_config("mamba-130m")), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config("mamba-130m")), **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, sharding.tree_values(
        jregistry.init_params(jcfg, jax.random.key(0))))
    return jcfg, tcfg, jp, bridge.params_from_repro(jp)


def _engine(tcfg, tp, **kw):
    return Engine(tcfg, tp, EngineConfig(device=CPU, **kw))


def _prompts(seed, lens, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


def _greedy_alone(tcfg, tp, prompt, max_new):
    cache = tregistry.init_cache(tcfg, 1, 64)
    logits, cache = tregistry.prefill(tcfg, tp, cache, {
        "tokens": torch.from_numpy(prompt[None]).long()})
    out = [int(logits[0, -1].argmax())]
    while len(out) < max_new:
        logits, cache = tregistry.decode_step(
            tcfg, tp, cache, {"tokens": torch.tensor([[out[-1]]])})
        out.append(int(logits[0, -1].argmax()))
    return out


# ---------------------------------------------------------------------------
# Engine against repro's Engine
# ---------------------------------------------------------------------------

def test_engine_greedy_streams_equal_repros(model):
    """5 variable-length requests through 2 slots (queueing, eviction,
    slot reuse): the port's streams are repro's, token for token."""
    jcfg, tcfg, jp, tp = model
    lens, max_news = [3, 5, 9, 4, 7], [6, 3, 8, 5, 4]
    prompts = _prompts(5, lens)
    jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(n_slots=2,
                                                         max_seq=64))
    teng = _engine(tcfg, tp, n_slots=2, max_seq=64)
    jreqs = [jeng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
    treqs = [teng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
    jeng.run()
    done = teng.run()
    assert len(done) == 5
    for j, t, m in zip(jreqs, treqs, max_news):
        assert t.finished and len(t.tokens) == m
        assert t.tokens == j.tokens, f"req {t.req_id} diverged from repro"
    for t, p, m in zip(treqs, prompts, max_news):
        assert t.tokens == _greedy_alone(tcfg, tp, p, m)
    np.testing.assert_allclose([t.cum_logprob for t in treqs],
                               [j.cum_logprob for j in jreqs], rtol=1e-4,
                               atol=1e-4)


def _first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


@pytest.mark.parametrize("state_dtype,weight_dtype",
                         [("int8", "int8"), ("fp8", None)],
                         ids=["int8_state_int8_weights", "fp8_state"])
def test_quantized_engine_greedy_streams_equal_repros(model, state_dtype,
                                                      weight_dtype):
    """The slot-churn trace of test_engine_greedy_streams_equal_repros
    with a quantized pool (and int8 weights, quantized by each engine
    from the same f32 tree): the port's greedy streams are repro's,
    token for token, and the slot bytes agree."""
    jcfg, tcfg, jp, tp = model
    lens, max_news = [3, 5, 9, 4, 7], [6, 3, 8, 5, 4]
    prompts = _prompts(5, lens)
    kw = dict(n_slots=2, max_seq=64, state_dtype=state_dtype,
              weight_dtype=weight_dtype)
    jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(**kw))
    teng = _engine(tcfg, tp, **kw)
    jreqs = [jeng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
    treqs = [teng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
    jeng.run()
    assert len(teng.run()) == 5
    for j, t, m in zip(jreqs, treqs, max_news):
        assert t.finished and len(t.tokens) == m
        assert t.tokens == j.tokens, (
            f"req {t.req_id} diverged from repro at token "
            f"{_first_divergence(t.tokens, j.tokens)}")
    assert teng.pool.state_bytes_per_slot() == \
        jeng.pool.state_bytes_per_slot() == 14356
    assert teng.pool.cache["h"].dtype == state_quant.storage_dtype(
        state_dtype)


@pytest.mark.parametrize("state_dtype,want", [("f32", 38916),
                                              ("bf16", 22532),
                                              ("int8", 14356),
                                              ("fp8", 14356)])
def test_state_bytes_per_slot_equal_repros(state_dtype, want):
    jcfg, tcfg = _cfgs(state_dtype=state_dtype)
    tpool = SlotStatePool(tcfg, n_slots=3, max_seq=32)
    jpool = JPool(jcfg, n_slots=3, max_seq=32)
    assert tpool.state_bytes_per_slot() == want
    assert jpool.state_bytes_per_slot() == want
    assert tpool.slots_per_gb() == pytest.approx(jpool.slots_per_gb())


def _same(a, b):
    """torch.equal; fp8 leaves (no CPU equal kernel) by their bytes."""
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
def test_quantized_pool_moves_scales_with_payload(model, state_dtype):
    """Admission brings the prefill's scales into the slot, a masked
    commit leaves an inactive slot's payload and scales alone, and
    eviction gives the slot zero codes and zero scales back."""
    _, tcfg, _, tp = model
    tcfg = dataclasses.replace(tcfg, state_dtype=state_dtype)
    pool = SlotStatePool(tcfg, n_slots=2, max_seq=32)
    _, sub = tregistry.prefill(tcfg, tp, pool.fresh,
                               {"tokens": torch.arange(5)[None]})
    a, b = pool.alloc(), pool.alloc()
    pool.admit(a, sub)
    assert bool((pool.read([a])["h_scale"] > 0).all())
    _, new_cache = tregistry.decode_step(tcfg, tp, pool.cache,
                                         {"tokens": torch.ones(2, 1).long()})
    before_b = pool.read([b])
    pool.commit(new_cache, active=np.array([True, False]))
    got_b = pool.read([b])
    for k in before_b:
        assert _same(got_b[k], before_b[k]), k
    assert not torch.equal(pool.read([a])["h_scale"], sub["h_scale"])
    pool.evict(a)
    got = pool.read([a])
    assert not bool(got["h_scale"].any())
    assert not bool(got["h"].view(torch.uint8).any())


def test_int8_weights_prefill_from_the_f32_master(model):
    """weight_dtype="int8" quantizes the handed-in tree for decode and
    prefills from the f32 master: every first token equals the f32
    engine's, and the decode tree holds int8 codes."""
    _, tcfg, _, tp = model
    prompts = _prompts(31, (4, 6, 9, 5))
    firsts = {}
    for wd in ("f32", "int8"):
        eng = _engine(tcfg, tp, n_slots=2, max_seq=64, weight_dtype=wd)
        reqs = [eng.submit(p, max_new=3) for p in prompts]
        eng.run()
        firsts[wd] = [r.tokens[0] for r in reqs]
        if wd == "int8":
            mixer = eng.params["layers"][0]["mixer"]
            assert mixer["A_q"].dtype == mixer["in_proj"]["w"].dtype \
                == torch.int8
            assert "A_log" in eng.prefill_params["layers"][0]["mixer"]
            assert eng.cfg.weight_dtype == "int8"
    assert firsts["int8"] == firsts["f32"]


def test_engine_eos_evicts_and_backfills(model):
    _, tcfg, _, tp = model
    prompts = _prompts(9, (4, 6, 5))
    ref0 = _greedy_alone(tcfg, tp, prompts[0], 10)
    eos = ref0[2]
    eng = _engine(tcfg, tp, n_slots=1, max_seq=64)
    r0 = eng.submit(prompts[0], max_new=10, eos_id=eos)
    r1 = eng.submit(prompts[1], max_new=4)
    r2 = eng.submit(prompts[2], max_new=3)
    eng.run()
    assert r0.tokens == ref0[:ref0.index(eos) + 1]
    assert r1.tokens == _greedy_alone(tcfg, tp, prompts[1], 4)
    assert r2.tokens == _greedy_alone(tcfg, tp, prompts[2], 3)
    s = eng.stats
    assert s.n_requests == 3 and s.prefill_calls == 3
    assert s.prefill_tokens == 15
    assert s.useful_tokens == sum(len(r.tokens) for r in (r0, r1, r2))


def test_cancel_stream_and_priority(model):
    _, tcfg, _, tp = model
    prompts = _prompts(12, (4, 5, 6, 3))
    eng = _engine(tcfg, tp, n_slots=1, max_seq=64)
    seen = []

    def cb(req, toks):
        seen.extend(toks)
        if len(req.tokens) >= 3:
            eng.cancel(req.req_id)

    streamed = eng.submit(prompts[0], max_new=20, stream_cb=cb)
    queued = eng.submit(prompts[1], max_new=4)
    urgent = eng.submit(prompts[2], max_new=2, priority=5)
    dropped = eng.submit(prompts[3], max_new=4)
    assert eng.cancel(dropped.req_id) and not eng.cancel(dropped.req_id)
    done = eng.run()
    assert streamed.cancelled and 3 <= len(streamed.tokens) < 20
    assert seen == streamed.tokens
    assert dropped.cancelled and dropped.tokens == []
    # the high-priority request was admitted before the earlier one
    order = [r.req_id for r in done if not r.cancelled]
    assert order.index(urgent.req_id) < order.index(queued.req_id)
    assert urgent.tokens == _greedy_alone(tcfg, tp, prompts[2], 2)
    assert eng.stats.n_cancelled == 2


def test_pool_eviction_restores_the_init_state(model):
    _, tcfg, _, tp = model
    pool = SlotStatePool(tcfg, n_slots=2, max_seq=32)
    fresh = tregistry.init_cache(tcfg, 1, 32)
    _, sub = tregistry.prefill(tcfg, tp, tregistry.init_cache(tcfg, 1, 32),
                               {"tokens": torch.arange(5)[None]})
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1) and pool.alloc() is None
    pool.admit(a, sub)
    got = pool.read([a])
    assert all(torch.equal(got[k], sub[k].to(got[k].dtype)) for k in sub)
    _, new_cache = tregistry.decode_step(tcfg, tp, pool.cache,
                                         {"tokens": torch.zeros(2, 1).long()})
    before_b = pool.read([b])
    pool.commit(new_cache, active=np.array([True, False]))
    assert all(torch.equal(pool.read([b])[k], before_b[k]) for k in fresh)
    pool.evict(a)
    assert all(torch.equal(pool.read([a])[k], fresh[k]) for k in fresh)
    assert pool.alloc() == a


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def test_filter_and_logprobs_match_repro():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(6, 50)) * 3).astype(np.float32)
    logits[1, :4] = logits[1, 0]                       # ties at the k-th
    top_k = np.array([0, 3, 1, 10, 0, 50], np.int32)
    top_p = np.array([1.0, 1.0, 0.5, 0.9, 0.3, 0.01], np.float32)
    want = np.asarray(jsampling.filter_logits(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = tsampling.filter_logits(torch.from_numpy(logits),
                                  torch.from_numpy(top_k).long(),
                                  torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    tok = np.array([0, 1, 2, 3, 4, 5], np.int32)
    jl = jsampling.token_logprobs(jnp.asarray(logits), jnp.asarray(tok))
    tl = tsampling.token_logprobs(torch.from_numpy(logits),
                                  torch.from_numpy(tok).long())
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_sampled_streams_are_seeded_and_slot_independent(model):
    """A sampled request's stream depends on its seed alone, not on its
    slot or on what shares the batch; top_k=1 sampling is greedy."""
    _, tcfg, _, tp = model
    prompts = _prompts(21, (5, 7, 4))
    sp = tsampling.SamplingParams(temperature=0.9, top_k=20, seed=77,
                                  max_new=6)

    def run(n_slots, lead):
        eng = _engine(tcfg, tp, n_slots=n_slots, max_seq=64)
        for p in lead:
            eng.submit(p, max_new=5)
        r = eng.submit(prompts[0], sp)
        eng.run()
        return r.tokens

    alone = run(1, [])
    assert run(3, prompts[1:]) == alone
    assert run(2, prompts[2:]) == alone
    eng = _engine(tcfg, tp, n_slots=2, max_seq=64)
    r = eng.submit(prompts[1], tsampling.SamplingParams(
        temperature=1.0, top_k=1, seed=5, max_new=5))
    eng.run()
    assert r.tokens == _greedy_alone(tcfg, tp, prompts[1], 5)


def test_logprobs_surface(model):
    _, tcfg, _, tp = model
    eng = _engine(tcfg, tp, n_slots=2, max_seq=64)
    r = eng.submit(_prompts(2, (6,))[0], tsampling.SamplingParams(
        max_new=4, logprobs=True, top_logprobs=3))
    eng.run()
    assert len(r.logprobs) == len(r.top_logprobs) == 4
    for tok, lp, top in zip(r.tokens, r.logprobs, r.top_logprobs):
        assert top[0][0] == tok and abs(top[0][1] - lp) < 1e-6
        assert len(top) == 3 and lp <= 0
    assert abs(r.cum_logprob - sum(r.logprobs)) < 1e-5


# ---------------------------------------------------------------------------
# Server, CLI, devices, and what is not ported yet
# ---------------------------------------------------------------------------

def test_server_generate_and_cli(model, capsys):
    _, tcfg, _, tp = model
    srv = Server(tcfg, tp, ServeConfig(batch_slots=2, max_seq=64,
                                       device=CPU))
    prompts = np.stack(_prompts(7, (5, 5)))
    out = srv.generate(prompts, max_new=4)
    assert out.shape == (2, 4)
    for row, p in zip(out, prompts):
        assert row.tolist() == _greedy_alone(tcfg, tp, p, 4)
    with pytest.raises(ValueError):
        srv.generate(np.stack(_prompts(7, (5, 5, 5))))
    tlaunch.main(["--arch", "mamba-130m", "--smoke", "--device", "cpu",
                  "--requests", "3", "--batch-slots", "2", "--max-new", "3"])
    assert "3 requests, 9 tokens" in capsys.readouterr().out


def test_cpu_serving_runs_the_plain_versions(model):
    _, tcfg, _, tp = model
    ref.CALLS.clear()
    eng = _engine(tcfg, tp, n_slots=2, max_seq=64)
    eng.submit(_prompts(1, (5,))[0], max_new=3)
    eng.run()
    L = tcfg.n_layers
    s = eng.stats
    assert ref.CALLS["selective_scan"] == L * s.prefill_calls
    assert ref.CALLS["selective_state_step"] == L * s.decode_steps
    assert ref.CALLS["causal_conv1d"] == L * (s.prefill_calls
                                              + s.decode_steps)


def test_entry_points_run_on_cuda_unless_asked_for_cpu(model):
    _, tcfg, _, tp = model
    assert EngineConfig().device == "cuda" and ServeConfig().device == "cuda"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tcfg, tp, EngineConfig())


@pytest.mark.parametrize("what", ["draft", "prefix_cache", "mesh", "n",
                                  "weight_int8", "megakernel",
                                  "int8_state", "fp8_state"])
def test_unported_features_raise(model, what):
    """What is not ported raises NotImplementedError; int8 weights,
    int8/fp8 state, the megakernel and speculative decoding (``draft``),
    which did before they were ported, now build an engine that serves a
    request."""
    _, tcfg, _, tp = model
    ecfg = EngineConfig(device=CPU, n_slots=2, max_seq=64)
    if what in ("prefix_cache", "mesh"):
        setattr(ecfg, what, object())
    elif what == "draft":
        ecfg.draft = DraftConfig(k=2, layers=1)
    elif what == "weight_int8":
        ecfg.weight_dtype = "int8"
    elif what == "megakernel":
        ecfg.step_impl = "megakernel"
    elif what.endswith("_state"):
        ecfg.state_dtype = what.split("_")[0]
    if what == "n":
        eng = Engine(tcfg, tp, ecfg)
        with pytest.raises(NotImplementedError):
            eng.submit(np.arange(4), tsampling.SamplingParams(n=2))
        return
    if what in ("weight_int8", "int8_state", "fp8_state", "megakernel",
                "draft"):
        eng = Engine(tcfg, tp, ecfg)
        r = eng.submit(np.arange(4), max_new=3)
        eng.run()
        assert r.finished and len(r.tokens) == 3
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(tcfg, tp, ecfg)


def test_engine_rejects_bad_requests(model):
    _, tcfg, _, tp = model
    eng = _engine(tcfg, tp, n_slots=1, max_seq=16)
    with pytest.raises(ValueError):
        eng.submit(np.arange(10), max_new=10)
    with pytest.raises(ValueError):
        eng.submit(np.arange(0))
    with pytest.raises(ValueError):
        eng.submit(np.arange(3), tsampling.SamplingParams(top_p=0.0))
