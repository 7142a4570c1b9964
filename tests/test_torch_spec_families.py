"""Speculative decoding in the port, xLSTM and jamba: the block verify
windows (mLSTM, sLSTM, jamba's mamba sublayers) against repro's and
against the port's chained steps, the model windows against repro's, the
spec engine's greedy streams against the port's and repro's plain
engines, and the draft views of every family.

Tie rule for the greedy-identity checks: identical streams, or a first
difference where the reference run's top two logits are within TIE_TOL
(margins printed); on the CPU in f32 the streams come out identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import jamba as jjamba
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.parallel import sharding
from repro.runtime import engine as jengine
from repro.runtime import sampling as jsampling
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import jamba as tjamba
from repro_torch.models import registry as tregistry
from repro_torch.models import xlstm as txlstm
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_decode import DraftConfig, default_shallow_layers

from _torch_inputs import code_ordinals, tree_equal
import _torch_inputs

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
TOL = 1e-5
#: the tie rule's tolerance on the reference's top-two logit gap
TIE_TOL = 1e-4
REF = SamplingParams(logprobs=True, top_logprobs=2)


def _cfgs(arch, **kw):
    """repro's and the port's smoke configs (vocab 64, f32).  Jamba's
    expert capacity is its expert count, as in repro's spec tests: with
    capacity drops an MoE layer's output depends on what else shares the
    batch, and a spec engine's batches (live and scratch rows) are not a
    plain engine's."""
    kw = {"vocab": 64, "dtype": "float32", **kw}
    j = jconfigs.get_config(arch)
    if j.n_experts:
        kw.setdefault("capacity_factor", float(j.n_experts))
    return (dataclasses.replace(jconfigs.smoke_variant(j), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(arch)), **kw))


_MODELS = {}


def _model(arch):
    """repro's smoke weights (numpy) and the port's bridged copy."""
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jp = jax.tree.map(np.asarray, sharding.tree_values(
            jregistry.init_params(jcfg, jax.random.key(1))))
        _MODELS[arch] = (jcfg, tcfg, jp, bridge.params_from_repro(jp))
    return _MODELS[arch]


def _x(seed, b, K, d):
    return np.random.default_rng(seed).normal(size=(b, K, d)).astype(
        np.float32)


def _close(got, want, label, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(
        want, np.float32), rtol=tol, atol=tol, err_msg=label)


def _state_close(got, want, label, tol=TOL):
    """Leaf for leaf; an int8 C within one code, its scales to 1e-6."""
    for k in got:
        if got[k].dtype == torch.int8:
            assert int((code_ordinals(got[k]) - code_ordinals(want[k]))
                       .abs().max()) <= 1, (label, k)
        elif k.endswith("_scale"):
            _close(got[k], want[k], f"{label} {k}", 1e-6)
        else:
            _close(got[k], want[k], f"{label} {k}", tol)


def assert_streams_tie_equal(got, ref, label=""):
    _torch_inputs.assert_streams_tie_equal(got, ref, TIE_TOL, label)


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# Block windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_mlstm_block_verify_matches_repro_and_chained(state_dtype):
    """An mLSTM layer's window from a primed state: out and every step's
    (C, n, m, conv) against repro's mlstm_block_verify and against the
    port's chained mlstm_block_step, within 1e-5 (an int8 C within one
    code)."""
    jcfg, tcfg, jp, tp = _model("xlstm-350m")
    jcfg = dataclasses.replace(jcfg, state_dtype=state_dtype)
    tcfg = dataclasses.replace(tcfg, state_dtype=state_dtype)
    li = next(i for i in range(tcfg.n_layers)
              if not txlstm._is_slstm(tcfg, i))
    lp = tp["layers"][li]["mlstm"]
    b, K = 2, 4
    x = _x(3, b, K, tcfg.d_model)
    _, state = txlstm.mlstm_block_step(
        tcfg, lp, torch.from_numpy(x[:, :1] * 0.7),
        txlstm.mlstm_state_init(tcfg, b, CPU))
    y, st = txlstm.mlstm_block_verify(tcfg, lp, torch.from_numpy(x), state)
    jy, jst = jxlstm.mlstm_block_verify(
        jcfg, jax.tree.map(jnp.asarray, jp["layers"][li]["mlstm"]),
        jnp.asarray(x), jax.tree.map(jnp.asarray, bridge.to_numpy(state)))
    _close(y, jy, "out vs repro")
    jst = _to_torch(jst)
    chained = state
    for t in range(K):
        step = {k: v[:, t] for k, v in st.items()}
        _state_close(step, {k: v[:, t] for k, v in jst.items()},
                     f"step {t} vs repro")
        yt, chained = txlstm.mlstm_block_step(
            tcfg, lp, torch.from_numpy(x[:, t:t + 1]), chained)
        _close(y[:, t:t + 1], yt, f"out {t} vs chained")
        _state_close(step, chained, f"step {t} vs chained")


def test_slstm_block_verify_matches_repro_and_chained():
    jcfg, tcfg, jp, tp = _model("xlstm-350m")
    li = next(i for i in range(tcfg.n_layers) if txlstm._is_slstm(tcfg, i))
    lp = tp["layers"][li]["slstm"]
    b, K = 2, 4
    x = _x(4, b, K, tcfg.d_model)
    _, state = txlstm.slstm_block_step(
        tcfg, lp, torch.from_numpy(x[:, :1] * 0.7),
        txlstm.slstm_state_init(tcfg, b, CPU))
    y, st = txlstm.slstm_block_verify(tcfg, lp, torch.from_numpy(x), state)
    jy, jst = jxlstm.slstm_block_verify(
        jcfg, jax.tree.map(jnp.asarray, jp["layers"][li]["slstm"]),
        jnp.asarray(x), jax.tree.map(jnp.asarray, bridge.to_numpy(state)))
    _close(y, jy, "out vs repro")
    jst = _to_torch(jst)
    chained = state
    for t in range(K):
        step = {k: v[:, t] for k, v in st.items()}
        _state_close(step, {k: v[:, t] for k, v in jst.items()},
                     f"step {t} vs repro")
        yt, chained = txlstm.slstm_block_step(
            tcfg, lp, torch.from_numpy(x[:, t:t + 1]), chained)
        _close(y[:, t:t + 1], yt, f"out {t} vs chained")
        _state_close(step, chained, f"step {t} vs chained")


def test_jamba_sublayer_verify_matches_repro():
    """Jamba's mamba sublayer at a dense position: out and every step's
    state against repro's sublayer_verify within 1e-5 (the MoE positions
    are chained per token in verify_window, held below); the attention
    position raises."""
    jcfg, tcfg, jp, tp = _model("jamba-v0.1-52b")
    b, K = 2, 3
    rng = np.random.default_rng(5)
    state = {"h": rng.normal(size=(b, tcfg.d_inner, tcfg.d_state)),
             "conv": rng.normal(size=(b, tcfg.d_conv - 1, tcfg.d_inner))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    x = _x(6, b, K, tcfg.d_model)
    kinds = [tjamba._pos_kind(tcfg, i) for i in range(8)]
    pos = next(i for i, (a, m) in enumerate(kinds) if not a and not m)
    key = f"pos{pos}"
    y, st = tjamba.sublayer_verify(tcfg, tp["groups"][0][key], pos,
                                   torch.from_numpy(x),
                                   bridge.to_torch(state))
    jy, jst = jjamba.sublayer_verify(
        jcfg, jax.tree.map(lambda q: jnp.asarray(q[0]), jp["groups"][key]),
        pos, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    _close(y, jy, f"{key} out")
    _state_close(st, _to_torch(jst), f"{key} states")
    attn = next(i for i, (a, _) in enumerate(kinds) if a)
    with pytest.raises(NotImplementedError):
        tjamba.sublayer_verify(tcfg, tp["groups"][0][f"pos{attn}"], attn,
                               torch.from_numpy(x), bridge.to_torch(state))


# ---------------------------------------------------------------------------
# Model windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b"])
def test_verify_window_matches_repro(arch):
    """The model window over 2 prefilled slots: logits within 1e-4 of
    repro's, every step's cache leaf within 1e-4, pos exact."""
    jcfg, tcfg, jp, tp = _model(arch)
    cache = tregistry.init_cache(tcfg, 2, 32)
    for s, n in enumerate((5, 8)):
        toks = np.random.default_rng(s).integers(0, 64, size=(1, n))
        _, sub = tregistry.prefill(tcfg, tp, tregistry.init_cache(
            tcfg, 1, 32), {"tokens": torch.from_numpy(toks)})
        tregistry.scatter_slots(tcfg, cache, sub, torch.tensor([s]))
    toks = np.random.default_rng(7).integers(0, 64, size=(2, 4)).astype(
        np.int32)
    logits, caches = tregistry.verify_scan(tcfg, tp, cache,
                                           torch.from_numpy(toks).long())
    jl, jc = jregistry.verify_scan(
        jcfg, jax.tree.map(jnp.asarray, jp),
        jax.tree.map(jnp.asarray, bridge.to_numpy(cache)), jnp.asarray(toks))
    _close(logits, jl, "logits", 1e-4)
    got = tregistry.tree_leaves(tregistry.tree_zip(
        lambda ax, a, b: (a, b), tregistry.cache_slot_axes(tcfg), caches,
        _to_torch(jc)))
    for a, b in zip(got[::2], got[1::2]):
        if a.dtype == torch.int32:
            assert torch.equal(a, b.to(torch.int32))
        else:
            _close(a, b, "cache", 1e-4)


# ---------------------------------------------------------------------------
# The spec engine
# ---------------------------------------------------------------------------

def _prompts(n, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=(l,)).astype(np.int32)
            for l in rng.integers(3, 10, size=n)]


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
@pytest.mark.parametrize("arch,step_impl", [("xlstm-350m", "fused"),
                                            ("jamba-v0.1-52b", "megakernel")])
def test_greedy_spec_streams_equal_plain_engines(arch, step_impl,
                                                 state_dtype):
    """3 requests through 2 slots with the family's shallow draft (xLSTM
    half depth, jamba's one group full depth): greedy streams equal the
    port's plain engine's (and with an f32 state repro's plain engine's)
    under the tie rule, and every scratch lease comes back."""
    jcfg, tcfg, jp, tp = _model(arch)
    prompts = _prompts(3)
    base = dict(n_slots=2, max_seq=64, state_dtype=state_dtype,
                step_impl=step_impl, device=CPU)
    plain = Engine(tcfg, tp, EngineConfig(**base))
    ref = [plain.submit(p, REF, max_new=6) for p in prompts]
    plain.run()
    eng = Engine(tcfg, tp, EngineConfig(**base, draft=DraftConfig(
        k=3, layers=default_shallow_layers(tcfg))))
    got = [eng.submit(p, REF, max_new=6) for p in prompts]
    eng.run()
    assert_streams_tie_equal(got, ref, f"{arch} {state_dtype} vs port")
    if state_dtype == "f32":
        jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(n_slots=2,
                                                            max_seq=64))
        jref = [jeng.submit(p, params=jsampling.SamplingParams(
            logprobs=True, top_logprobs=2), max_new=6) for p in prompts]
        jeng.run()
        assert_streams_tie_equal(got, jref, f"{arch} vs repro")
    assert eng.stats.spec_passes > 0
    assert eng.pool.n_scratch_free == eng.pool.n_scratch == 2


# ---------------------------------------------------------------------------
# Draft views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba-130m", "xlstm-350m",
                                  "jamba-v0.1-52b"])
def test_draft_view_merge_roundtrip(arch):
    """The draft's cache view merges back bitwise; its param view leaves
    out the target's K3 view; a draft decode step on the view merges
    into a cache whose draft view is the step's cache, bitwise."""
    _, tcfg = _cfgs(arch)
    tp = tregistry.init_params(tcfg, 0)
    n = default_shallow_layers(tcfg)
    cache = tregistry.init_cache(tcfg, 3, 32)
    sub = tregistry.draft_cache(tcfg, cache, n)
    assert tree_equal(tregistry.draft_cache_merge(tcfg, cache, sub, n),
                       cache)
    dcfg = tregistry.draft_config(tcfg, n)
    dp = tregistry.draft_params(tcfg, tregistry.stack_params(tcfg, tp), n)
    assert "stack" not in dp
    logits, sub2 = tregistry.decode_step(
        dcfg, dp, sub, {"tokens": torch.zeros(3, 1, dtype=torch.int64)})
    assert logits.shape == (3, 1, tcfg.vocab)
    merged = tregistry.draft_cache_merge(tcfg, cache, sub2, n)
    assert tree_equal(tregistry.draft_cache(tcfg, merged, n), sub2)
    assert torch.equal(merged["pos"], cache["pos"] + 1)


def test_draft_config_validation():
    _, jam = _cfgs("jamba-v0.1-52b")
    with pytest.raises(ValueError):
        tregistry.draft_config(jam, (jam.attn_every or 8) - 1)
    assert tregistry.draft_config(jam, 8).n_layers == 8
    _, mam = _cfgs("mamba-130m")
    with pytest.raises(ValueError):
        tregistry.draft_config(mam, mam.n_layers + 1)
    with pytest.raises(ValueError):
        tregistry.draft_config(mam, 0)
    assert tregistry.draft_config(mam, 1).n_layers == 1
    _, tcfg = _cfgs("qwen2-7b")
    with pytest.raises(NotImplementedError):
        tregistry.draft_config(tcfg, 1)
    with pytest.raises(ValueError):
        Engine(mam, tregistry.init_params(mam, 0),
               EngineConfig(device=CPU, draft=DraftConfig(k=0)))
