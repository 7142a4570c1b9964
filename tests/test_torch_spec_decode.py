"""Speculative decoding in the port, mamba: the verify micro-scan, the
block and model verify windows, the rollback select and the greedy
acceptance against repro's on the same (bridged) weights and inputs; the
spec engine's greedy streams against the port's plain engine and repro's
plain engine; acceptance properties, fork hygiene and the full-reject
rollback within the port.

Tie rule for every greedy-identity check: the streams are identical, or
they first differ at a position where the reference run's top two
logits are within TIE_TOL (the margins are printed).  On the CPU in f32
at these sizes the streams come out identical."""
import dataclasses
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.core import selective_scan as jcss
from repro.core import state_quant as jsq
from repro.models import mamba as jmamba
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro.runtime import engine as jengine
from repro.runtime import sampling as jsampling
from repro.runtime import spec_decode as jspec
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import selective_scan as tcss
from repro_torch.core import state_quant as tsq
from repro_torch.kernels import ops
from repro_torch.models import mamba as tmamba
from repro_torch.models import registry as tregistry
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_decode import (DraftConfig, accept_tokens,
                                             default_shallow_layers)
from repro_torch.runtime.state_pool import SlotStatePool

import _torch_inputs
from _torch_inputs import code_ordinals, tree_equal

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
#: the tie rule's tolerance on the reference's top-two logit gap
TIE_TOL = 1e-4


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


def _prompts(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(l,)).astype(np.int32)
            for l in rng.integers(3, 10, size=n)]


def assert_streams_tie_equal(got, ref, label=""):
    _torch_inputs.assert_streams_tie_equal(got, ref, TIE_TOL, label)


# ---------------------------------------------------------------------------
# The micro-scan, the block window, the rollback select, greedy acceptance
# against repro
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b, K, d, n):
    rng = np.random.default_rng(seed)
    return dict(
        h=rng.normal(size=(b, d, n)).astype(np.float32) * 2,
        x=rng.normal(size=(b, K, d)).astype(np.float32),
        dt=np.abs(rng.normal(size=(b, K, d))).astype(np.float32) * 0.1,
        A=-np.abs(rng.normal(size=(d, n))).astype(np.float32),
        B=rng.normal(size=(b, K, n)).astype(np.float32),
        C=rng.normal(size=(b, K, n)).astype(np.float32),
        D=rng.normal(size=(d,)).astype(np.float32),
        z=rng.normal(size=(b, K, d)).astype(np.float32))


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_decode_scan_matches_repro(impl):
    """repro's micro-scan (its fused kernel in interpret mode, or its XLA
    step) and the port's chain of plain steps agree within 1e-5 on y and
    every step's state."""
    i = _scan_inputs(1, 2, 5, 24, 8)
    jy, jh = jcss.decode_scan(*(jnp.asarray(i[k]) for k in
                                ("h", "x", "dt", "A", "B", "C")),
                              D=jnp.asarray(i["D"]), z_seq=jnp.asarray(i["z"]),
                              impl=impl)
    t = {k: torch.from_numpy(v) for k, v in i.items()}
    ty, th = tcss.decode_scan(t["h"], t["x"], t["dt"], t["A"], t["B"],
                              t["C"], D=t["D"], z_seq=t["z"])
    assert th.shape == (2, 5, 24, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
def test_decode_scan_q_matches_repro(state_dtype):
    """The quantized micro-scan: every step's payloads within one code of
    repro's, scales within f32 rounding, y within 1e-5."""
    i = _scan_inputs(2, 2, 4, 32, 8)
    hq, hs = jsq.quantize_h(jnp.asarray(i["h"]), state_dtype)
    args = [jnp.asarray(i[k]) for k in ("x", "dt", "A", "B", "C")]
    jy, jq, js = jcss.decode_scan_q(hq, hs, *args, D=jnp.asarray(i["D"]),
                                    z_seq=jnp.asarray(i["z"]),
                                    state_dtype=state_dtype, impl="fused")
    tq0, ts0 = bridge.to_torch([np.asarray(hq), np.asarray(hs)])
    t = {k: torch.from_numpy(v) for k, v in i.items()}
    ty, tq, ts = tcss.decode_scan_q(
        tq0, ts0, t["x"], t["dt"], t["A"],
        t["B"], t["C"], D=t["D"], z_seq=t["z"], state_dtype=state_dtype)
    want_q = bridge.to_torch({"q": np.asarray(jq)})["q"]
    assert tq.dtype == tsq.storage_dtype(state_dtype)
    assert int((code_ordinals(tq) - code_ordinals(want_q)).abs().max()) <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def _block_state(tcfg, state_dtype, b, seed):
    rng = np.random.default_rng(seed)
    di, n, k = tcfg.d_inner, tcfg.d_state, tcfg.d_conv
    h0 = rng.normal(size=(b, di, n)).astype(np.float32)
    state = {"conv": rng.normal(size=(b, k - 1, di)).astype(np.float32)}
    if state_dtype == "int8":
        q, s = jsq.quantize_h(jnp.asarray(h0), "int8")
        state.update({"h": np.asarray(q), "h_scale": np.asarray(s)})
    else:
        state["h"] = h0
    return state


def _assert_state_close(got, want, quant, label):
    if quant:
        assert int((code_ordinals(got["h"]) - code_ordinals(want["h"]))
                   .abs().max()) <= 1, label
        np.testing.assert_allclose(got["h_scale"].numpy(),
                                   want["h_scale"].numpy(), rtol=1e-6,
                                   err_msg=label)
    else:
        np.testing.assert_allclose(got["h"].numpy(), want["h"].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=label)
    np.testing.assert_allclose(got["conv"].numpy(), want["conv"].numpy(),
                               rtol=1e-5, atol=1e-5, err_msg=label)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_mamba_block_verify_matches_repro_and_chained_steps(model,
                                                            state_dtype):
    """The block window against repro's (its XLA step) and against the
    port's own chained mamba_block_step: out within 1e-5, every step's
    state within 1e-5 (int8: one code, scales to f32 rounding); its conv
    tails are exactly the tails the chained conv returns."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, state_dtype=state_dtype,
                               step_impl="xla")
    tcfg = dataclasses.replace(tcfg, state_dtype=state_dtype)
    b, K = 2, 5
    state = _block_state(tcfg, state_dtype, b, 3)
    x = np.random.default_rng(4).normal(size=(b, K, tcfg.d_model)).astype(
        np.float32)
    jlayer = jax.tree.map(lambda q: q[0], jp["layers"])["mixer"]
    jy, jst = jmamba.mamba_block_verify(
        jcfg, jax.tree.map(jnp.asarray, jlayer), jnp.asarray(x),
        jax.tree.map(jnp.asarray, state))
    ty, tst = tmamba.mamba_block_verify(tcfg, tp["layers"][0]["mixer"],
                                        torch.from_numpy(x),
                                        bridge.to_torch(state))
    quant = state_dtype == "int8"
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    jst = bridge.to_torch(jax.tree.map(np.asarray, jst))
    st = bridge.to_torch(state)
    for t in range(K):
        step = {k: v[:, t] for k, v in tst.items()}
        _assert_state_close(step, {k: v[:, t] for k, v in jst.items()},
                            quant, f"repro step {t}")
        y, st = tmamba.mamba_block_step(tcfg, tp["layers"][0]["mixer"],
                                        torch.from_numpy(x[:, t:t + 1]), st)
        np.testing.assert_allclose(ty[:, t:t + 1].numpy(), y.numpy(),
                                   rtol=1e-5, atol=1e-5)
        _assert_state_close(step, st, quant, f"chained step {t}")
    # the window conv's own tail is the last per-step tail, bitwise
    lp = tp["layers"][0]["mixer"]
    x_in, _ = tmamba._project(tcfg, lp, torch.from_numpy(x))
    _, tail = ops.causal_conv1d(x_in, lp["conv_w"], lp["conv_b"],
                                x_prev=bridge.to_torch(state)["conv"])
    tails = tmamba._conv_tail_states(bridge.to_torch(state)["conv"], x_in)
    assert torch.equal(tail, tails[:, -1]) and torch.equal(
        tst["conv"], tails)


def _pool_cache(tcfg, tp, b, active):
    """A (b)-slot cache with the active slots prefilled, as the port's
    tree and as repro's."""
    tcache = tregistry.init_cache(tcfg, b, 32)
    for s, prompt in zip(np.flatnonzero(active), _prompts(tcfg, b, seed=8)):
        _, sub = tregistry.prefill(tcfg, tp, tregistry.init_cache(
            tcfg, 1, 32), {"tokens": torch.from_numpy(prompt[None]).long()})
        tregistry.scatter_slots(tcfg, tcache, sub, torch.tensor([int(s)]))
    jcache = jax.tree.map(jnp.asarray, bridge.to_numpy(tcache))
    return jcache, tcache


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_verify_scan_with_active_mask_matches_repro(model, state_dtype):
    """The model window over 3 slots (slot 1 inactive): logits within
    1e-4 of repro's, every step's cache within tolerance, the inactive
    slot frozen at every step; the select of each slot's step is
    bitwise repro's select on the same stack."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, state_dtype=state_dtype,
                               step_impl="xla")
    tcfg = dataclasses.replace(tcfg, state_dtype=state_dtype)
    active = np.array([True, False, True])
    jcache, tcache = _pool_cache(tcfg, tp, 3, active)
    toks = np.random.default_rng(6).integers(0, 64, size=(3, 5)).astype(
        np.int32)
    jl, jc = jregistry.verify_scan(jcfg, jax.tree.map(jnp.asarray, jp),
                                   jcache, jnp.asarray(toks),
                                   active=jnp.asarray(active))
    tl, tc = tregistry.verify_scan(tcfg, tp, tcache,
                                   torch.from_numpy(toks).long(),
                                   active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jc = bridge.to_torch(jax.tree.map(np.asarray, jc))
    quant = state_dtype == "int8"
    for t in range(5):
        _assert_state_close({k: v[t] for k, v in tc.items()},
                            {k: v[t] for k, v in jc.items()}, quant,
                            f"step {t}")
        assert tree_equal({k: v[t][:, 1] for k, v in tc.items()
                            if k != "pos"},
                           {k: v[:, 1] for k, v in tcache.items()
                            if k != "pos"})
    assert torch.equal(tc["pos"], jc["pos"].to(torch.int32))
    # the window against the chained decode steps it stands for (an
    # inactive slot's logits are not read: the chain feeds it its frozen
    # state, the window its own steps)
    cl, cc = tregistry.verify_chain(tcfg, tp, tcache,
                                    torch.from_numpy(toks).long(),
                                    active=torch.from_numpy(active))
    np.testing.assert_allclose(tl[active].numpy(), cl[active].numpy(),
                               rtol=1e-5, atol=1e-5)
    for t in range(5):
        _assert_state_close({k: v[t] for k, v in tc.items()},
                            {k: v[t] for k, v in cc.items()}, quant,
                            f"chained step {t}")
    # the rollback select, bitwise on one stack
    idx = np.array([3, 0, 1], np.int32)
    want = jregistry.select_step(jcfg, jax.tree.map(
        jnp.asarray, bridge.to_numpy(tc)), jnp.asarray(idx))
    got = tregistry.select_step(tcfg, tc, torch.from_numpy(idx))
    assert tree_equal(got, bridge.to_torch(jax.tree.map(np.asarray, want)))
    for leaf in tregistry.tree_leaves(got):
        assert leaf.is_contiguous()


def test_select_step_fp8_and_freeze_bitwise(model):
    """fp8 leaves go through byte views: select and freeze give the
    codes bitwise, and freeze-then-select equals select-then-mask."""
    _, tcfg, _, tp = model
    tcfg = dataclasses.replace(tcfg, state_dtype="fp8")
    cache = tregistry.init_cache(tcfg, 3, 32)
    rng = np.random.default_rng(9)
    stack = {k: torch.stack([
        torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)).to(
            v.dtype) for _ in range(4)]) for k, v in cache.items()}
    stack["pos"] = torch.arange(4, dtype=torch.int32)[:, None].repeat(1, 3)
    idx = torch.tensor([2, 0, 3])
    active = torch.tensor([True, False, True])
    a = tregistry.select_step(tcfg, tregistry._freeze_steps(
        tcfg, cache, stack, active), idx)
    b = tregistry.mask_slots(tcfg, cache, tregistry.select_step(
        tcfg, stack, idx), active)
    assert tree_equal(a, b)
    assert torch.equal(a["h"][:, 0].view(torch.uint8),
                       stack["h"][2][:, 0].view(torch.uint8))
    assert torch.equal(a["h"][:, 1].view(torch.uint8),
                       cache["h"][:, 1].view(torch.uint8))


def test_greedy_accept_tokens_match_repro_bitwise():
    """Greedy acceptance on the same logits: emit, n_acc and pending are
    repro's exactly."""
    rng = np.random.default_rng(12)
    for k, b, v in ((1, 1, 2), (3, 4, 17), (5, 3, 33)):
        drafts = rng.integers(0, v, size=(k, b)).astype(np.int32)
        tl = rng.normal(size=(k + 1, b, v)).astype(np.float32)
        # make some drafts right so that prefixes are accepted
        drafts[: k // 2] = np.argmax(tl[: k // 2], -1)
        je, jn, jpd = jspec.accept_tokens(jnp.asarray(drafts),
                                          jnp.asarray(tl), 0.0)
        te, tn, tpd = accept_tokens(torch.from_numpy(drafts).long(),
                                    torch.from_numpy(tl), 0.0)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tpd.numpy(), np.asarray(jpd))


# ---------------------------------------------------------------------------
# Acceptance properties (repro's TestAcceptanceBounds, held in the port)
# ---------------------------------------------------------------------------

class TestAcceptanceBounds:
    @given(st.integers(1, 6), st.integers(1, 5), st.integers(2, 33),
           st.integers(0, 10_000))
    @settings(max_examples=25, deadline=None)
    def test_greedy_prefix_semantics(self, k, b, vocab, seed):
        rng = np.random.default_rng(seed)
        drafts = torch.from_numpy(rng.integers(0, vocab, size=(k, b)))
        tl = torch.from_numpy(rng.normal(size=(k + 1, b, vocab)).astype(
            np.float32))
        emit, n_acc, pending = accept_tokens(drafts, tl, 0.0)
        tgt = tl.argmax(-1)
        for s in range(b):
            j = 0
            while j < k and int(drafts[j, s]) == int(tgt[j, s]):
                j += 1
            assert int(n_acc[s]) == j
            stream = [int(emit[t, s]) for t in range(j + 1)]
            assert stream[:j] == [int(drafts[t, s]) for t in range(j)]
            assert stream[-1] == int(tgt[j, s]) == int(pending[s])

    @given(st.integers(1, 6), st.integers(1, 4), st.floats(0.25, 3.0),
           st.integers(0, 10_000))
    @settings(max_examples=15, deadline=None)
    def test_sampled_identical_distributions_accept_all(self, k, b, temp,
                                                        seed):
        """p_draft == p_target: every proposal is accepted."""
        rng = np.random.default_rng(seed)
        dl = torch.from_numpy(rng.normal(size=(k, b, 16)).astype(np.float32))
        tl = torch.cat([dl, torch.from_numpy(
            rng.normal(size=(1, b, 16)).astype(np.float32))])
        drafts = torch.from_numpy(rng.integers(0, 16, size=(k, b)))
        _, n_acc, _ = accept_tokens(drafts, tl, float(temp), draft_logits=dl,
                                    seed=seed)
        assert (n_acc == k).all()

    @given(st.integers(1, 6), st.integers(1, 4), st.integers(0, 10_000))
    @settings(max_examples=15, deadline=None)
    def test_sampled_counts_in_bounds(self, k, b, seed):
        rng = np.random.default_rng(seed)
        dl = torch.from_numpy(rng.normal(size=(k, b, 8)).astype(
            np.float32) * 3)
        tl = torch.from_numpy(rng.normal(size=(k + 1, b, 8)).astype(
            np.float32) * 3)
        drafts = torch.from_numpy(rng.integers(0, 8, size=(k, b)))
        emit, n_acc, pending = accept_tokens(drafts, tl, 1.0,
                                             draft_logits=dl, seed=seed)
        assert ((0 <= n_acc) & (n_acc <= k)).all()
        assert emit.shape == (k + 1, b)
        for s in range(b):
            assert int(pending[s]) == int(emit[int(n_acc[s]), s])

    def test_sampled_marginal_matches_target(self):
        """With a skewed draft, the first emitted token's distribution
        over 4000 trials is the target's softmax (total variation under
        0.05), on a fixed seed."""
        vocab, trials = 6, 4000
        rng = np.random.default_rng(0)
        tl_row = rng.normal(size=(vocab,)).astype(np.float32)
        dl_row = rng.normal(size=(vocab,)).astype(np.float32) * 2.0
        tl = torch.from_numpy(np.tile(tl_row, (2, trials, 1)))
        dl = torch.from_numpy(np.tile(dl_row, (1, trials, 1)))
        p_d = np.exp(dl_row) / np.exp(dl_row).sum()
        drafts = torch.from_numpy(rng.choice(vocab, size=(1, trials), p=p_d))
        emit, _, _ = accept_tokens(drafts, tl, 1.0, draft_logits=dl, seed=42)
        counts = np.bincount(emit[0].numpy(), minlength=vocab) / trials
        p_t = np.exp(tl_row) / np.exp(tl_row).sum()
        tv = 0.5 * np.abs(counts - p_t).sum()
        assert tv < 0.05, (tv, counts, p_t)


# ---------------------------------------------------------------------------
# The spec engine
# ---------------------------------------------------------------------------

REF = SamplingParams(logprobs=True, top_logprobs=2)


def _run(eng, prompts, params=None, **kw):
    reqs = [eng.submit(p, params=params, **kw) for p in prompts]
    eng.run()
    return reqs


@pytest.fixture(scope="module")
def repro_streams(model):
    """repro's plain greedy engine on the churn trace, per state dtype."""
    jcfg, _, jp, _ = model
    out = {}
    for sd in ("f32", "int8"):
        eng = jengine.Engine(dataclasses.replace(jcfg, state_dtype=sd), jp,
                             jengine.EngineConfig(n_slots=2, max_seq=64))
        reqs = [eng.submit(p, params=jsampling.SamplingParams(
            logprobs=True, top_logprobs=2), max_new=7)
            for p in _prompts(jcfg, 4)]
        eng.run()
        out[sd] = reqs
    return out


@pytest.mark.parametrize("step_impl", ["fused", "megakernel"])
@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_greedy_spec_streams_equal_plain_engines(model, repro_streams,
                                                 state_dtype, step_impl):
    """4 requests through 2 slots with a half-depth draft (mostly
    rejected: rejection, correction and rollback all run): the greedy
    streams equal the port's plain engine's and repro's plain engine's
    under the tie rule; the spec counters add up; every scratch lease
    comes back."""
    _, tcfg, _, tp = model
    prompts = _prompts(tcfg, 4)
    base = dict(n_slots=2, max_seq=64, state_dtype=state_dtype,
                step_impl=step_impl, device=CPU)
    plain = Engine(tcfg, tp, EngineConfig(**base))
    ref = _run(plain, prompts, REF, max_new=7)
    draft = DraftConfig(k=3, layers=default_shallow_layers(tcfg))
    eng = Engine(tcfg, tp, EngineConfig(**base, draft=draft))
    got = _run(eng, prompts, REF, max_new=7)
    assert_streams_tie_equal(got, ref, f"{state_dtype} {step_impl} vs port")
    assert_streams_tie_equal(got, repro_streams[state_dtype],
                             f"{state_dtype} {step_impl} vs repro")
    s = eng.stats.summary()
    assert s["spec_target_passes"] > 0 and s["spec_accepted_per_pass"] >= 1
    assert sum(r.spec_passes for r in got) == eng.stats.spec_slot_passes
    assert sum(r.spec_accepted for r in got) == eng.stats.spec_accepted
    assert all(0 <= r.spec_accepted <= r.spec_passes * draft.k for r in got)
    assert eng.pool.n_scratch_free == eng.pool.n_scratch == 2
    np.testing.assert_allclose([r.cum_logprob for r in got],
                               [r.cum_logprob for r in ref], rtol=1e-4,
                               atol=1e-4)


def test_spec_engine_fp8_state_and_int8_weights(model):
    """fp8 state with int8 weights, the target per layer and the draft
    through the megakernel (``DraftConfig.step_impl``): the greedy
    streams equal the plain engine's of the same setup (tie rule)."""
    _, tcfg, _, tp = model
    prompts = _prompts(tcfg, 3, seed=7)
    base = dict(n_slots=2, max_seq=64, state_dtype="fp8",
                weight_dtype="int8", step_impl="fused", device=CPU)
    ref = _run(Engine(tcfg, tp, EngineConfig(**base)), prompts, REF,
               max_new=6)
    eng = Engine(tcfg, tp, EngineConfig(**base, draft=DraftConfig(
        k=2, layers=1, step_impl="megakernel")))
    assert eng._spec.dcfg.step_impl == "megakernel"
    assert "stack" in eng._spec.draft_params
    assert_streams_tie_equal(_run(eng, prompts, REF, max_new=6), ref, "fp8")
    assert eng.pool.n_scratch_free == eng.pool.n_scratch


def test_mixed_batch_greedy_slots_unchanged(model):
    """Greedy slots beside sampled ones in the same passes keep the plain
    engine's streams (tie rule); sampled slots emit max_new in-vocab
    tokens."""
    _, tcfg, _, tp = model
    prompts = _prompts(tcfg, 4)
    plain = Engine(tcfg, tp, EngineConfig(n_slots=2, max_seq=64, device=CPU))
    ref = _run(plain, prompts, REF, max_new=7)
    eng = Engine(tcfg, tp, EngineConfig(
        n_slots=2, max_seq=64, device=CPU,
        draft=DraftConfig(k=3, layers=default_shallow_layers(tcfg))))
    mix = [REF, SamplingParams(temperature=0.8, seed=21), REF,
           SamplingParams(temperature=1.1, top_k=8, seed=22)]
    got = [eng.submit(p, params=sp, max_new=7) for p, sp in zip(prompts, mix)]
    eng.run()
    assert_streams_tie_equal([got[0], got[2]], [ref[0], ref[2]], "mixed")
    assert all(len(r.tokens) == 7 and all(0 <= t < 64 for t in r.tokens)
               for r in got)
    assert eng.pool.n_scratch_free == eng.pool.n_scratch


def test_full_depth_draft_accepts_all_and_sampled_window_is_plain(model):
    """A full-depth draft accepts every proposal; with sampled requests
    its first window is the plain engine's sampled stream (the fork
    copies each seed verbatim and draft i draws at position base + i)."""
    _, tcfg, _, tp = model
    prompts = _prompts(tcfg, 3, seed=13)
    sps = [SamplingParams(temperature=0.9, seed=31),
           SamplingParams(temperature=1.2, top_k=8, seed=32),
           SamplingParams(temperature=0.7, top_p=0.9, seed=33)]
    k = 3
    plain = Engine(tcfg, tp, EngineConfig(n_slots=2, max_seq=64, device=CPU))
    ref = [plain.submit(p, params=sp, max_new=8)
           for p, sp in zip(prompts, sps)]
    plain.run()
    eng = Engine(tcfg, tp, EngineConfig(n_slots=2, max_seq=64, device=CPU,
                                        draft=DraftConfig(k=k, layers=0)))
    got = [eng.submit(p, params=sp, max_new=8) for p, sp in zip(prompts, sps)]
    eng.run()
    for r, g in zip(ref, got):
        assert g.tokens[:k + 1] == r.tokens[:k + 1]
    s = eng.stats.summary()
    assert s["spec_acceptance_rate"] == 1.0
    assert s["spec_accepted_per_pass"] > 1.0
    assert eng.pool.n_scratch_free == eng.pool.n_scratch


def test_adaptive_depth_drafts_fewer_with_streams_unchanged(model):
    _, tcfg, _, tp = model
    prompts = _prompts(tcfg, 3)
    layers = default_shallow_layers(tcfg)
    fixed = Engine(tcfg, tp, EngineConfig(n_slots=2, max_seq=64, device=CPU,
                                          draft=DraftConfig(k=4,
                                                            layers=layers)))
    rf = _run(fixed, prompts, REF, max_new=12)
    adap = Engine(tcfg, tp, EngineConfig(
        n_slots=2, max_seq=64, device=CPU,
        draft=DraftConfig(k=4, layers=layers, adaptive=True)))
    ra = _run(adap, prompts, REF, max_new=12)
    assert_streams_tie_equal(ra, rf, "adaptive")
    assert adap.stats.spec_drafted < fixed.stats.spec_drafted
    assert sum(r.spec_accepted for r in ra) == adap.stats.spec_accepted
    assert adap.pool.n_scratch_free == adap.pool.n_scratch
    # the scheduler's cap clamps every window, token values unchanged
    capped = Engine(tcfg, tp, EngineConfig(n_slots=2, max_seq=64,
                                           device=CPU,
                                           draft=DraftConfig(k=4,
                                                             layers=layers)))
    capped.spec_cap = 1
    rc = _run(capped, prompts, REF, max_new=12)
    assert_streams_tie_equal(rc, rf, "spec_cap")
    s = capped.stats
    assert s.spec_draft_steps == s.spec_passes


def test_eos_eviction_and_backfill(model):
    """EOS inside an accepted window trims the overshoot, evicts, and the
    queue backfills; every stream equals the plain engine's."""
    _, tcfg, _, tp = model
    prompts = _prompts(tcfg, 3, seed=9)
    first = _run(Engine(tcfg, tp, EngineConfig(n_slots=1, max_seq=64,
                                               device=CPU)),
                 prompts[:1], max_new=10)[0]
    # the first token from position 2 on that did not come earlier
    at = next(i for i in range(2, 10) if first.tokens[i]
              not in first.tokens[:i])
    eos = first.tokens[at]

    def trace(eng):
        out = [eng.submit(prompts[0], REF, max_new=10, eos_id=eos),
               eng.submit(prompts[1], REF, max_new=4),
               eng.submit(prompts[2], REF, max_new=5)]
        eng.run()
        return out

    ref = trace(Engine(tcfg, tp, EngineConfig(n_slots=1, max_seq=64,
                                              device=CPU)))
    eng = Engine(tcfg, tp, EngineConfig(n_slots=1, max_seq=64, device=CPU,
                                        draft=DraftConfig(k=3, layers=0)))
    got = trace(eng)
    assert_streams_tie_equal(got, ref, "eos")
    assert got[0].tokens[-1] == eos and len(got[0].tokens) == at + 1
    assert eng.pool.n_scratch_free == eng.pool.n_scratch


def test_fork_then_release_leaves_live_state_untouched(model):
    _, tcfg, _, tp = model
    tcfg = dataclasses.replace(tcfg, state_dtype="int8")
    pool = SlotStatePool(tcfg, n_slots=2, max_seq=32, n_scratch=2)
    prompt = torch.from_numpy(_prompts(tcfg, 1, seed=11)[0][None]).long()
    _, sub = tregistry.prefill(tcfg, tp, pool.fresh, {"tokens": prompt})
    slot = pool.alloc()
    pool.admit(slot, sub)
    pool.params.set(slot, SamplingParams(temperature=0.5), 77)
    before = pool.read([slot])
    sc = pool.lease_scratch()
    assert sc == 2 and pool.n_scratch_free == 1
    pool.fork([slot], [sc])
    assert tree_equal(pool.read([sc]), before)
    assert pool.params.seed[sc] == 77 and pool.params.temperature[sc] == 0.5
    pool.release_scratch(sc)
    assert tree_equal(pool.read([slot]), before)
    assert pool.n_scratch_free == pool.n_scratch
    with pytest.raises(ValueError):
        pool.release_scratch(sc)
    with pytest.raises(ValueError):
        pool.release_scratch(slot)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_full_reject_pass_leaves_verify_step0_state(model, monkeypatch,
                                                    state_dtype):
    """Every proposal forced wrong: the pass emits one token a slot, the
    target's own, and each live slot's pooled state is bitwise the
    verify window's step-0 state from the pass's starting cache."""
    _, tcfg, _, tp = model
    prompts = _prompts(tcfg, 2, seed=3)
    eng = Engine(tcfg, tp, EngineConfig(n_slots=2, max_seq=64, device=CPU,
                                        state_dtype=state_dtype,
                                        draft=DraftConfig(k=3, layers=0)))
    spec = eng._spec
    real_propose, real_verify = spec.propose, spec.verify
    seen = {}

    def wrong(*args):
        cache, d_toks, d_logits = real_propose(*args)
        return cache, (d_toks + 1) % tcfg.vocab, d_logits

    def verify(params, cache, x0, draft_toks, *rest):
        # x0 shares the engine's host array, which the pass then updates
        seen.update(cache=cache, x0=x0.clone(), drafts=draft_toks)
        return real_verify(params, cache, x0, draft_toks, *rest)

    monkeypatch.setattr(spec, "propose", wrong)
    monkeypatch.setattr(spec, "verify", verify)
    for p in prompts:
        eng.submit(p, max_new=4)
    while eng._ready and eng.pool.n_free:
        eng._admit(heapq.heappop(eng._ready)[2])
    live = torch.tensor(eng.pool.active_slots())
    cache0 = tregistry.tree_map(torch.clone, eng.pool.cache)
    eng._spec_pass()
    s = eng.stats.summary()
    assert s["spec_acceptance_rate"] == 0.0
    assert s["spec_accepted_per_pass"] == 1.0
    # the draft left the live rows alone
    cfg = eng.cfg
    assert tree_equal(tregistry.gather_slots(cfg, seen["cache"], live),
                       tregistry.gather_slots(cfg, cache0, live))
    logits, steps = tregistry.verify_scan(
        eng.cfg, eng.params, seen["cache"],
        torch.cat([seen["x0"], seen["drafts"].T], 1))
    step0 = {k: v[0] for k, v in steps.items()}
    assert tree_equal(tregistry.gather_slots(cfg, eng.pool.cache, live),
                       tregistry.gather_slots(cfg, step0, live))
    np.testing.assert_array_equal(eng._next_tok[live, 0],
                                  logits[live, 0].argmax(-1).numpy())
    assert eng.pool.n_scratch_free == eng.pool.n_scratch
