"""Transformers served by the port's ``Engine`` against ``repro``'s, on the
CPU.

- Greedy streams equal ``repro``'s token for token under slot churn for
  granite-20b (MQA) and qwen2-7b (GQA + bias) at smoke size, f32 and
  int8 weights with an int8 KV cache, on the same (bridged) weights.
- ``state_bytes_per_slot`` equals ``repro``'s at smoke size and, from
  the abstract cache, at full width (the numbers chip_smoke.py checks).
- The serving front, family-agnostic in ``repro``: prefix-cache hits are
  bitwise cold admissions and the streams and counters are ``repro``'s
  (cache on vs off under the tie rule, f32); ``DisaggPipeline`` streams
  are bitwise the monolithic engine's; best-of-n's branch 0 is bitwise
  the request at n = 1.
- Refusals as ``repro``'s: sessions (the KV cache grows with max_seq),
  the stub frontends, drafts; an explicit ``step_impl="megakernel"``
  raises (no K3 instance for this family), "auto" decodes per layer.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.runtime import engine as jengine
from repro.runtime import spec_decode as jspec
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.runtime.disagg import DisaggConfig, DisaggPipeline
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_decode import DraftConfig

from _torch_serving import cached_admission_equal_repros, engine, model
from _torch_transformer import cfgs, repro_weights

jax.config.update("jax_platform_name", "cpu")


def _prompts(n, seed=11, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(l,)).astype(np.int32)
            for l in rng.integers(3, 10, size=n)]


ENGINE_CASES = {  # arch, EngineConfig overrides
    "granite-f32": ("granite-20b", {}),
    "granite-int8_weights_int8_kv": ("granite-20b", dict(
        weight_dtype="int8", kv_cache_dtype="int8")),
    "qwen2-7b-f32": ("qwen2-7b", {}),
    "qwen2-7b-int8_weights_int8_kv": ("qwen2-7b", dict(
        weight_dtype="int8", kv_cache_dtype="int8")),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_equal_repros(case):
    """5 requests through 2 slots (admission, eviction, slot reuse): the
    port's greedy streams equal repro's token for token."""
    arch, over = ENGINE_CASES[case]
    jcfg, tcfg = cfgs(arch)
    w = repro_weights(arch)
    prompts = _prompts(5)
    kw = dict(n_slots=2, max_seq=32, **over)
    eng = Engine(tcfg, bridge.params_from_repro(w),
                 EngineConfig(device="cpu", **kw))
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    jeng = jengine.Engine(jcfg, w, jengine.EngineConfig(**kw))
    jreqs = [jeng.submit(p, max_new=6) for p in prompts]
    jeng.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert eng.stats.decode_steps > 0 and eng.pool.n_free == 2


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_state_bytes_per_slot_equal_repros(kv):
    jcfg, tcfg = cfgs("qwen2-7b")
    kw = dict(n_slots=2, max_seq=40, kv_cache_dtype=kv)
    w = repro_weights("qwen2-7b")
    eng = Engine(tcfg, bridge.params_from_repro(w),
                 EngineConfig(device="cpu", **kw))
    jeng = jengine.Engine(jcfg, w, jengine.EngineConfig(**kw))
    assert eng.pool.state_bytes_per_slot() == jeng.pool.state_bytes_per_slot()
    assert eng.pool.slots_per_gb() == pytest.approx(jeng.pool.slots_per_gb())


@pytest.mark.parametrize("arch,layers,kv,want", [
    ("qwen2-7b", 28, "model", 33030148),
    ("qwen2-7b", 28, "int8", 16644100),
    ("qwen2-moe-a2.7b", 8, "model", 37748740)])
def test_full_width_slot_bytes(arch, layers, kv, want):
    """Full width at max_seq 576, bf16 (qwen2-moe cut to 8 layers): the
    numbers chip_smoke.py checks on the card, from repro's abstract
    cache: L x 576 x hkv*dh x (2 bytes, or 1 + 4 / (hkv*dh) for int8
    codes and their scales) x 2 (k and v) + 4 (pos)."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch), n_layers=layers,
                               kv_cache_dtype=kv)
    leaves = jax.tree.leaves(jregistry.abstract_cache(jcfg, 4, 576))
    assert sum(np.prod(a.shape) * a.dtype.itemsize
               for a in leaves) // 4 == want
    tcfg = dataclasses.replace(tconfigs.get_config(arch), n_layers=layers,
                               kv_cache_dtype=kv)
    cache = tregistry.init_cache(tcfg, 1, 576, device="meta")
    assert sum(t.numel() * t.element_size()
               for t in tregistry.tree_leaves(cache)) == want


# ---------------------------------------------------------------------------
# The serving front
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "int8"])
def test_cached_admission_equal_repros(kv):
    cached_admission_equal_repros("qwen2-7b", None, kv_cache_dtype=kv)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_disagg_bitwise_identical_to_monolithic(kv):
    _, tcfg, _, tp = model("granite-20b")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, 60, size=int(rng.integers(4, 12))), sp)
            for sp in (SamplingParams(max_new=4),
                       SamplingParams(temperature=0.9, top_k=12, max_new=4))]
    kw = dict(n_slots=2, max_seq=48, seed=11, kv_cache_dtype=kv)
    mono = Engine(tcfg, tp, EngineConfig(device="cpu", **kw))
    for prompt, sp in reqs:
        mono.submit(prompt, sp)
    ref = {r.req_id: (r.tokens, r.cum_logprob) for r in mono.run()}
    pipe = DisaggPipeline(tcfg, tp, EngineConfig(device="cpu", **kw),
                          DisaggConfig(queue_depth=3))
    items = [pipe.submit(prompt, sp) for prompt, sp in reqs]
    pipe.run()
    assert pipe.decode.stats.snapshot_admits == len(reqs)
    assert pipe.decode.stats.prefill_tokens == 0
    for i, item in enumerate(items):
        assert (item.req.tokens, item.req.cum_logprob) == ref[i], i
        assert item.snap.nbytes == mono.pool.state_bytes_per_slot()


def test_bestofn_branch0_bitwise_the_request_at_n1():
    _, tcfg, _, tp = model("qwen2-7b")
    prompt = np.arange(1, 12, dtype=np.int32)
    sp = SamplingParams(n=3, temperature=0.9, seed=5, max_new=5)
    eng = engine(tcfg, tp, n_slots=3, max_seq=32)
    parent = eng.submit(prompt, params=sp)
    eng.run()
    assert eng.stats.prefill_calls == 1
    assert len({tuple(c.tokens) for c in parent.branches}) > 1
    solo_eng = engine(tcfg, tp, n_slots=3, max_seq=32)
    solo = solo_eng.submit(prompt, params=dataclasses.replace(sp, n=1))
    solo_eng.run()
    b0 = next(c for c in parent.branches if c.branch == 0)
    assert b0.tokens == solo.tokens and b0.logprobs == solo.logprobs
    assert eng.pool.n_free == 3


# ---------------------------------------------------------------------------
# Refusals and the decode path
# ---------------------------------------------------------------------------

def test_refusals_as_repros():
    jcfg, tcfg, jp, tp = model("qwen2-7b")
    eng = engine(tcfg, tp, n_slots=2, max_seq=32)
    jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(n_slots=2,
                                                         max_seq=32))
    # sessions: the KV strips grow with max_seq
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="session"):
            e.submit(np.arange(1, 5), session=True)
    # no self-speculative draft view for this family
    with pytest.raises(NotImplementedError, match="draft"):
        engine(tcfg, tp, draft=DraftConfig(k=2, layers=1))
    with pytest.raises(NotImplementedError, match="draft"):
        jengine.Engine(jcfg, jp, jengine.EngineConfig(
            draft=jspec.DraftConfig(k=2, layers=1)))
    # no cross-layer decode kernel for this family: an explicit
    # "megakernel" raises (on the card too: test_torch_transformer.py's
    # registry test), it never runs per layer
    with pytest.raises(NotImplementedError, match="megakernel"):
        Engine(tcfg, tp, EngineConfig(device="cpu", n_slots=2, max_seq=32,
                                      step_impl="megakernel"))
    # the stub frontends are not served
    for arch in ("musicgen-large", "phi-3-vision-4.2b"):
        jc, tc = cfgs(arch)
        with pytest.raises(NotImplementedError, match="token frontends"):
            jengine.Engine(jc, repro_weights(arch),
                           jengine.EngineConfig(n_slots=1, max_seq=16))
        with pytest.raises(NotImplementedError, match="token frontends"):
            Engine(tc, {}, EngineConfig(device="cpu", n_slots=1,
                                        max_seq=16))


def test_auto_decodes_per_layer_with_k7_once_a_layer():
    """step_impl "auto" builds no K3 view, and every admission runs the
    plain K7 once a layer (the decode steps none)."""
    from repro_torch.kernels import ref
    _, tcfg, _, tp = model("granite-20b")
    eng = engine(tcfg, tp, n_slots=2, max_seq=32)
    assert "stack" not in eng.params
    ref.CALLS.clear()
    reqs = [eng.submit(p, max_new=4) for p in _prompts(3)]
    eng.run()
    assert all(len(r.tokens) == 4 for r in reqs)
    assert ref.CALLS["attention"] == tcfg.n_layers * eng.stats.prefill_calls
    assert eng.stats.prefill_calls == 3
    assert set(ref.CALLS) == {"attention"}
    assert torch.device("cpu") == eng.device
