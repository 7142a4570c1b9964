"""xLSTM served by the port's ``Engine`` against ``repro``'s, on the CPU.

The same weights (``repro``'s xlstm-350m-smoke, bridged as numpy) go
through both engines in f32: greedy streams equal token for token under
slot churn (4 requests through 2 slots) with f32 weights and state, int8
weights with an int8 state, and an fp8 state, against ``repro``'s fused
engine (pure XLA; ``repro`` pins its megakernel streams to it), each run
once per setup; the port's megakernel engine (the plain K3) equals its
per-layer engine bit for bit, logprobs included.  Also the launch pins of
``core.dispatch_count`` and the slot bytes, at smoke size and, from
``repro``'s abstract cache, at full width.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro.runtime import engine as jengine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import dispatch_count
from repro_torch.kernels import megakernel
from repro_torch.models import registry as tregistry
from repro_torch.models import xlstm
from repro_torch.runtime.engine import Engine, EngineConfig

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-350m"
#: (weights, state) of each engine setup
SETUPS = {"f32": ("f32", "f32"), "int8_weights_int8_state": ("int8", "int8"),
          "fp8_state": ("f32", "fp8")}
KW = dict(n_slots=2, max_seq=32)


def cfgs(**kw):
    kw = {"vocab": 64, "dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.smoke_variant(
                jconfigs.get_config(ARCH)), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(ARCH)), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = cfgs()
    return jax.tree.map(np.asarray, sharding.tree_values(
        jregistry.init_params(jcfg, jax.random.key(1))))


def _prompts(n=4, seed=11, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(l,)).astype(np.int32)
            for l in rng.integers(3, 10, size=n)]


def _run(eng):
    reqs = [eng.submit(p, max_new=6) for p in _prompts()]
    eng.run()
    return reqs


@pytest.fixture(scope="module")
def repro_streams(weights):
    """repro's fused-engine greedy streams, once per setup."""
    jcfg, _ = cfgs()
    out = {}
    for name, (wd, sd) in SETUPS.items():
        eng = jengine.Engine(jcfg, weights, jengine.EngineConfig(
            step_impl="fused", weight_dtype=wd, state_dtype=sd, **KW))
        out[name] = [r.tokens for r in _run(eng)]
    return out


@pytest.mark.parametrize("setup", list(SETUPS))
def test_engine_streams_equal_repros(weights, repro_streams, setup):
    """Admission, eviction (repro's init state back, m = -1e30) and slot
    reuse: the port's per-layer and K3 engines give repro's greedy
    streams, and the K3 engine's tokens and logprobs equal the per-layer
    engine's bit for bit."""
    wd, sd = SETUPS[setup]
    _, tcfg = cfgs()
    runs = {}
    for impl in ("fused", "megakernel"):
        eng = Engine(tcfg, bridge.params_from_repro(weights), EngineConfig(
            device="cpu", step_impl=impl, weight_dtype=wd, state_dtype=sd,
            **KW))
        dispatch_count.reset()
        runs[impl] = _run(eng)
        plain = dispatch_count.snapshot()
        assert (plain["plain mlstm_stacked_run"] > 0) == (impl ==
                                                           "megakernel")
        assert [r.tokens for r in runs[impl]] == repro_streams[setup]
    for a, b in zip(runs["fused"], runs["megakernel"]):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs


def test_evicted_slot_gets_the_init_state(weights):
    _, tcfg = cfgs(state_dtype="int8")
    eng = Engine(tcfg, bridge.params_from_repro(weights),
                 EngineConfig(device="cpu", n_slots=2, max_seq=32))
    _run(eng)
    fresh = tregistry.init_cache(tcfg, 1, 32)
    got = eng.pool.read([0, 1])
    for g, f in zip(tregistry.tree_leaves(got), tregistry.tree_leaves(fresh)):
        assert torch.equal(g[:1].view(torch.uint8), f.view(torch.uint8))
    assert float(got["layers"][0]["mlstm"]["m"].max()) == float(
        np.float32(-1e30))


@pytest.mark.parametrize("conv_impl,per_layer", [("xla", {}),
                                                 ("pallas", {
                                                     "plain causal_conv1d":
                                                     7})])
def test_launches_per_token(weights, conv_impl, per_layer):
    """One decode token of 2 slots: through K3 one launch per run of
    same-kind layers (mLSTM 0-6, sLSTM 7), and no conv; per layer the
    conv of each mLSTM layer with conv_impl "pallas", nothing with "xla"
    (repro's per-layer step is pure XLA)."""
    _, tcfg = cfgs(conv_impl=conv_impl)
    tp = bridge.params_from_repro(weights)
    cache = tregistry.init_cache(tcfg, 2, 16)
    batch = {"tokens": torch.tensor([[3], [4]])}
    mega = dataclasses.replace(tcfg, step_impl="megakernel")
    got = dispatch_count.launch_counts(
        tregistry.decode_step, mega, tregistry.stack_params(mega, tp),
        cache, batch)
    assert dict(got) == {"plain mlstm_stacked_run": 1,
                         "plain slstm_stacked_run": 1}
    fused = dataclasses.replace(tcfg, step_impl="fused")
    got = dispatch_count.launch_counts(tregistry.decode_step, fused, tp,
                                       cache, batch)
    assert dict(got) == per_layer
    got = dispatch_count.launch_counts(
        tregistry.prefill, fused, tp, tregistry.init_cache(tcfg, 1, 16),
        {"tokens": torch.arange(10)[None]})
    assert dict(got) == per_layer


def test_kind_runs_of_the_full_config():
    """xlstm-350m decodes as six K3 launches a token: mLSTM 0-6, sLSTM 7,
    mLSTM 8-14, sLSTM 15, mLSTM 16-22, sLSTM 23."""
    runs = xlstm._kind_runs(tconfigs.get_config(ARCH))
    assert [(k, r[0], r[-1]) for k, r in runs] == [
        ("mlstm", 0, 6), ("slstm", 7, 7), ("mlstm", 8, 14),
        ("slstm", 15, 15), ("mlstm", 16, 22), ("slstm", 23, 23)]
    assert runs == jregistry.family(jconfigs.get_config(ARCH))._kind_runs(
        jconfigs.get_config(ARCH))


def test_run_refuses_what_k3_does_not_take(weights):
    _, tcfg = cfgs()
    tp = bridge.params_from_repro(weights)
    mlstm_rows = [tp["layers"][0]["mlstm"]]
    with pytest.raises(ValueError, match="LayerNorm"):
        megakernel.XlstmRun(dataclasses.replace(tcfg, norm="rmsnorm"),
                            "mlstm", mlstm_rows)
    with pytest.raises(ValueError, match="a run of 33 layers"):
        megakernel.XlstmRun(tcfg, "mlstm", mlstm_rows * 33)
    with pytest.raises(ValueError, match="heads of at most 512"):
        megakernel.XlstmRun(dataclasses.replace(tcfg, d_model=1024,
                                                n_heads=2), "mlstm",
                            mlstm_rows)
    with pytest.raises(ValueError, match="multiples of 4"):
        megakernel.XlstmRun(dataclasses.replace(tcfg, d_model=66, n_heads=3),
                            "slstm", [tp["layers"][7]["slstm"]])
    with pytest.raises(ValueError, match="has no wq"):
        megakernel.XlstmRun(tcfg, "mlstm",
                            [{k: v for k, v in mlstm_rows[0].items()
                              if k != "wq"}])


@pytest.mark.parametrize("sd", ["f32", "bf16", "int8", "fp8"])
def test_state_bytes_per_slot_equal_repros(weights, sd):
    jcfg, tcfg = cfgs(state_dtype=sd)
    eng = Engine(tcfg, bridge.params_from_repro(weights),
                 EngineConfig(device="cpu", **KW))
    jeng = jengine.Engine(jcfg, weights, jengine.EngineConfig(**KW))
    assert eng.pool.state_bytes_per_slot() == jeng.pool.state_bytes_per_slot()
    assert eng.pool.slots_per_gb() == pytest.approx(jeng.pool.slots_per_gb())


def test_full_width_slot_bytes():
    """xlstm-350m at full depth: the numbers chip_smoke.py checks on the
    card, from repro's abstract cache (21 mLSTM layers: C 4 x 512 x 512, n,
    m and the f32 conv tail 3 x 2048; 3 sLSTM layers: c, n, h, m 4 x 256;
    pos)."""
    for sd, want in (("f32", 88818004), ("int8", 22929748)):
        jcfg = dataclasses.replace(jconfigs.get_config(ARCH), state_dtype=sd)
        leaves = jax.tree.leaves(jregistry.abstract_cache(jcfg, 4, 576))
        jbytes = sum(np.prod(a.shape) * a.dtype.itemsize
                     for a in leaves) // 4
        assert jbytes == want
        tcfg = dataclasses.replace(tconfigs.get_config(ARCH), state_dtype=sd)
        cache = tregistry.init_cache(tcfg, 1, 576, device="meta")
        assert sum(t.numel() * t.element_size()
                   for t in tregistry.tree_leaves(cache)) == want
