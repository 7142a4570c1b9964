"""Jamba served by the port's ``Engine`` against ``repro``'s, on the CPU.

The same weights (``repro``'s, bridged as numpy) go through both
engines in f32: greedy streams equal token for token under slot churn
(f32; int8 state + int8 KV; int8 weights; per layer and through the
plain K3; the dense and GQA variants), and the slot bytes equal
``repro``'s, at smoke size and, from the abstract cache, at full width.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.runtime import engine as jengine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels import ref
from repro_torch.models import registry as tregistry
from repro_torch.runtime.engine import Engine, EngineConfig

from _torch_jamba import ARCH, cfgs, repro_weights

jax.config.update("jax_platform_name", "cpu")


# ---------------------------------------------------------------------------
# Engines: greedy streams equal repro's, slot bytes
# ---------------------------------------------------------------------------

def _prompts(n, seed=11, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(l,)).astype(np.int32)
            for l in rng.integers(3, 10, size=n)]


ENGINE_CASES = {  # variant, EngineConfig overrides
    "f32-fused": ("moe", dict(step_impl="fused")),
    "f32-megakernel": ("moe", dict(step_impl="megakernel")),
    "int8_state_int8_kv-fused": ("moe", dict(step_impl="fused",
                                             state_dtype="int8",
                                             kv_cache_dtype="int8")),
    "int8_state_int8_kv-megakernel": ("moe", dict(step_impl="megakernel",
                                                  state_dtype="int8",
                                                  kv_cache_dtype="int8")),
    "int8_weights-megakernel": ("moe", dict(step_impl="megakernel",
                                            weight_dtype="int8")),
    "dense-megakernel": ("dense", dict(step_impl="megakernel")),
    "gqa-fused": ("gqa", dict(step_impl="fused")),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_equal_repros(case):
    """5 requests through 2 slots (admission, eviction, slot reuse): the
    port's greedy streams equal repro's token for token, per layer and
    through K3, and the port's K3 engine's equal its per-layer engine's
    bit for bit."""
    variant, over = ENGINE_CASES[case]
    jcfg, tcfg = cfgs(variant)
    w = repro_weights(variant)
    prompts = _prompts(5)
    kw = dict(n_slots=2, max_seq=32, **over)
    eng = Engine(tcfg, bridge.params_from_repro(w),
                 EngineConfig(device="cpu", **kw))
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    ref.CALLS.clear()
    eng.run()
    got = [r.tokens for r in reqs]
    if over["step_impl"] == "megakernel":
        assert ref.CALLS["jamba_stacked_run"] > 0
        per_layer = Engine(tcfg, bridge.params_from_repro(w), EngineConfig(
            device="cpu", **{**kw, "step_impl": "fused"}))
        preqs = [per_layer.submit(p, max_new=6) for p in prompts]
        per_layer.run()
        assert got == [r.tokens for r in preqs]
    jeng = jengine.Engine(jcfg, w, jengine.EngineConfig(**kw))
    jreqs = [jeng.submit(p, max_new=6) for p in prompts]
    jeng.run()
    assert got == [r.tokens for r in jreqs]


@pytest.mark.parametrize("sd,kv", [("f32", "model"), ("int8", "int8"),
                                   ("fp8", "model"), ("f32", "int8")])
def test_state_bytes_per_slot_equal_repros(sd, kv):
    jcfg, tcfg = cfgs("moe")
    kw = dict(n_slots=2, max_seq=40, state_dtype=sd, kv_cache_dtype=kv)
    w = repro_weights("moe")
    eng = Engine(tcfg, bridge.params_from_repro(w),
                 EngineConfig(device="cpu", **kw))
    jeng = jengine.Engine(jcfg, w, jengine.EngineConfig(**kw))
    assert eng.pool.state_bytes_per_slot() == jeng.pool.state_bytes_per_slot()
    assert eng.pool.slots_per_gb() == pytest.approx(jeng.pool.slots_per_gb())


def test_full_width_slot_bytes():
    """jamba-v0.1-52b cut to one group of 8 at max_seq 576, bf16: the
    numbers chip_smoke.py checks on the card, from repro's abstract
    cache."""
    for sd, kv, want in (("f32", "model", 6373380), ("int8", "int8",
                                                     2446276)):
        jcfg = dataclasses.replace(jconfigs.get_config(ARCH), n_layers=8,
                                   state_dtype=sd, kv_cache_dtype=kv)
        leaves = jax.tree.leaves(jregistry.abstract_cache(jcfg, 4, 576))
        jbytes = sum(np.prod(a.shape) * a.dtype.itemsize
                     for a in leaves) // 4
        assert jbytes == want
        tcfg = dataclasses.replace(tconfigs.get_config(ARCH), n_layers=8,
                                   state_dtype=sd, kv_cache_dtype=kv)
        cache = tregistry.init_cache(tcfg, 1, 576, device="meta")
        assert sum(t.numel() * t.element_size()
                   for t in tregistry.tree_leaves(cache)) == want


