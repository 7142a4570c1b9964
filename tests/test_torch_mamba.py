"""The port's Mamba LM against repro's on the same weights: repro's
parameters and caches are bridged as numpy arrays, repro runs its Pallas
kernels in interpret mode (scan_impl="pallas", conv_impl="pallas",
step_impl="fused"), the port its plain versions on the CPU; with f32
weights and state, and with int8 weights and int8/fp8 state.  Also the
identities repro pins within itself (prefill + N steps == forward, the
scan resumes across a split), held in the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import state_quant as jsq
from repro.core import weight_quant as jwq
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import state_quant as tsq
from repro_torch.kernels import ops
from repro_torch.models import registry as tregistry
from repro_torch.runtime.engine import Engine, EngineConfig

from _torch_inputs import code_ordinals

jax.config.update("jax_platform_name", "cpu")

KERNEL_IMPLS = dict(scan_impl="pallas", conv_impl="pallas",
                    step_impl="fused")


def _cfgs(**kw):
    kw = {"vocab": 64, "dtype": "float32", **KERNEL_IMPLS, **kw}
    jcfg = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.get_config("mamba-130m")), **kw)
    tcfg = dataclasses.replace(
        tconfigs.smoke_variant(tconfigs.get_config("mamba-130m")), **kw)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, sharding.tree_values(tree))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return _np_tree(jregistry.init_params(jcfg, jax.random.key(0)))


def _tokens(seed, b, L, vocab=64):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, L)).astype(np.int32)


def test_configs_are_copies():
    for name in jconfigs.list_archs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
        assert j.n_params() == t.n_params(), name
    assert tconfigs.list_archs() == jconfigs.list_archs()


def test_bridge_round_trips_and_counts(weights):
    _, tcfg = _cfgs()
    p = bridge.params_from_repro(weights)
    assert len(p["layers"]) == tcfg.n_layers
    n = sum(t.numel() for t in tregistry.tree_leaves(p))
    # count_params leaves out the norms, conv bias and dt bias
    extra = ((tcfg.n_layers + 1) * tcfg.d_model
             + 2 * tcfg.n_layers * tcfg.d_inner)
    assert n == tcfg.n_params() + extra
    back = bridge.params_to_repro(p)
    assert jax.tree.structure(back) == jax.tree.structure(weights)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(weights)):
        np.testing.assert_array_equal(a, b)


def test_port_init_has_repros_layout():
    jcfg, tcfg = _cfgs()
    jp = _np_tree(jregistry.init_params(jcfg, jax.random.key(1)))
    tp = bridge.params_to_repro(tregistry.init_params(tcfg, seed=1))
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the deterministic leaves agree to f32 rounding of the log
    np.testing.assert_allclose(tp["layers"]["mixer"]["A_log"],
                               jp["layers"]["mixer"]["A_log"], rtol=1e-6)


@pytest.mark.parametrize("exp_impl,silu_impl", [("exact", "exact"),
                                                ("ours", "ours")])
def test_prefill_and_decode_match_repro(weights, exp_impl, silu_impl):
    """Bridged prefill logits and cache, then 3 decode steps, against
    repro on its Pallas kernels (interpret mode), in f32 where the point
    is the algorithm, with exact and with MARCA's approximate units."""
    tol = 1e-4
    jcfg, tcfg = _cfgs(exp_impl=exp_impl, silu_impl=silu_impl)
    b, lp, steps = 2, 11, 3
    toks = _tokens(3, b, lp + steps)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, b, 32))
    tcache = tregistry.init_cache(tcfg, b, 32)
    tp = bridge.params_from_repro(weights)
    jl, jcache = jregistry.prefill(jcfg, weights, jcache,
                                   {"tokens": jnp.asarray(toks[:, :lp])})
    tl, tcache = tregistry.prefill(tcfg, tp, tcache, {
        "tokens": torch.from_numpy(toks[:, :lp]).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    for k, v in bridge.cache_to_repro(tcache).items():
        np.testing.assert_allclose(v, np.asarray(jcache[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)
    for s in range(steps):
        t = toks[:, lp + s:lp + s + 1]
        jl, jcache = jregistry.decode_step(jcfg, weights, jcache,
                                           {"tokens": jnp.asarray(t)})
        tl, tcache = tregistry.decode_step(tcfg, tp, tcache, {
            "tokens": torch.from_numpy(t).long()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"decode step {s}")
    for k, v in bridge.cache_to_repro(tcache).items():
        np.testing.assert_allclose(v, np.asarray(jcache[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("state_dtype,weight_dtype", [
    ("f32", "int8"), ("int8", "f32"), ("fp8", "f32"), ("int8", "int8")],
    ids=["int8_weights", "int8_state", "fp8_state", "int8_weights_state"])
def test_quantized_prefill_and_decode_match_repro(weights, state_dtype,
                                                  weight_dtype):
    """Prefill + 3 decode steps in f32 with int8 weights (repro's
    quantized tree, bridged) and/or an int8/fp8 pool.  Logits at 1e-4 as
    in f32; the stored state within one code (FMA contraction in XLA can
    move a value on a rounding boundary), its scales to rtol 1e-5 (they
    are amaxes of states that already differ by f32 rounding across the
    layers), the dequantized state at 1e-4 where the codes agree."""
    tol = 1e-4
    jcfg, tcfg = _cfgs(state_dtype=state_dtype, weight_dtype=weight_dtype)
    jw = (jax.tree.map(np.asarray, jwq.quantize_tree(weights))
          if weight_dtype == "int8" else weights)
    tp = bridge.params_from_repro(jw)
    b, lp, steps = 2, 11, 3
    toks = _tokens(3, b, lp + steps)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, b, 32))
    tcache = tregistry.init_cache(tcfg, b, 32)
    jl, jcache = jregistry.prefill(jcfg, jw, jcache,
                                   {"tokens": jnp.asarray(toks[:, :lp])})
    tl, tcache = tregistry.prefill(tcfg, tp, tcache, {
        "tokens": torch.from_numpy(toks[:, :lp]).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    for s in range(steps):
        t = toks[:, lp + s:lp + s + 1]
        jl, jcache = jregistry.decode_step(jcfg, jw, jcache,
                                           {"tokens": jnp.asarray(t)})
        tl, tcache = tregistry.decode_step(tcfg, tp, tcache, {
            "tokens": torch.from_numpy(t).long()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"decode step {s}")
    jc = bridge.cache_from_repro(jax.tree.map(np.asarray, jcache))
    assert set(jc) == set(tcache)
    assert tcache["h"].dtype == tsq.storage_dtype(state_dtype)
    if state_dtype == "f32":
        np.testing.assert_allclose(tcache["h"], jc["h"], rtol=tol, atol=tol)
        return
    assert tcache["h_scale"].shape == (tcfg.n_layers, b,
                                       tsq.n_groups(tcfg.d_inner))
    np.testing.assert_allclose(tcache["h_scale"], jc["h_scale"], rtol=1e-5)
    diff = (code_ordinals(tcache["h"]) - code_ordinals(jc["h"])).abs()
    assert int(diff.max()) <= 1
    th = tsq.dequantize_h(tcache["h"], tcache["h_scale"])
    jh = np.asarray(jsq.dequantize_h(jcache["h"], jcache["h_scale"]))
    same = (diff == 0).numpy()
    np.testing.assert_allclose(th.numpy()[same], jh[same], rtol=tol,
                               atol=tol)


def test_bridge_round_trips_quantized_trees(weights):
    """repro's int8-quantized param tree and an fp8 cache with h_scale,
    made by repro's prefill, cross the bridge and back bit for bit."""
    jq = jax.tree.map(np.asarray, jwq.quantize_tree(weights))
    tp = bridge.params_from_repro(jq)
    assert tp["layers"][0]["mixer"]["A_q"].dtype == torch.int8
    back = bridge.params_to_repro(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jq)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jcfg, _ = _cfgs(state_dtype="fp8")
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 32))
    _, jcache = jregistry.prefill(jcfg, weights, jcache, {
        "tokens": jnp.asarray(_tokens(6, 2, 9))})
    jcache = jax.tree.map(np.asarray, jcache)
    tc = bridge.cache_from_repro(jcache)
    assert tc["h"].dtype == torch.float8_e4m3fn
    assert tc["h_scale"].dtype == torch.float32
    out = bridge.cache_to_repro(tc)
    for k, v in jcache.items():
        got = out[k].astype(v.dtype) if k == "h" else out[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got.view(np.uint8),
                                      v.view(np.uint8), err_msg=k)


def test_decode_from_a_bridged_cache(weights):
    """A cache made by repro continues in the port: the bridge carries
    the decode state, not just the weights."""
    jcfg, tcfg = _cfgs()
    toks = _tokens(4, 2, 9)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 32))
    _, jcache = jregistry.prefill(jcfg, weights, jcache,
                                  {"tokens": jnp.asarray(toks[:, :8])})
    tcache = bridge.cache_from_repro(_np_tree(jcache))
    jl, _ = jregistry.decode_step(jcfg, weights, jcache,
                                  {"tokens": jnp.asarray(toks[:, 8:])})
    tl, _ = tregistry.decode_step(tcfg, bridge.params_from_repro(weights),
                                  tcache, {"tokens": torch.from_numpy(
                                      toks[:, 8:]).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_prefill_plus_n_decode_steps_matches_forward():
    """repro pins this in tests/test_engine.py; the port holds it too."""
    _, tcfg = _cfgs()
    p = tregistry.init_params(tcfg, seed=2)
    b, lp, n_steps = 2, 4, 6
    toks = torch.from_numpy(_tokens(5, b, lp + n_steps)).long()
    full, _ = tregistry.forward(tcfg, p, {"tokens": toks})
    cache = tregistry.init_cache(tcfg, b, 16)
    logits, cache = tregistry.prefill(tcfg, p, cache,
                                      {"tokens": toks[:, :lp]})
    torch.testing.assert_close(logits, full[:, :lp], rtol=1e-4, atol=1e-4)
    for t in range(n_steps):
        logits, cache = tregistry.decode_step(
            tcfg, p, cache, {"tokens": toks[:, lp + t:lp + t + 1]})
        torch.testing.assert_close(logits[:, 0], full[:, lp + t], rtol=1e-4,
                                   atol=1e-4)
    assert cache["pos"].tolist() == [lp + n_steps] * b


@pytest.mark.parametrize("L1", [1, 7, 16, 17, 39])
def test_selective_scan_resumes_across_split(L1):
    """scan([0:L1]) carrying h into scan([L1:L]) == scan([0:L])."""
    rng = np.random.default_rng(11)
    b, L, d, n = 2, 40, 8, 4

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    x, dt = t(b, L, d), torch.nn.functional.softplus(t(b, L, d))
    A, B, C = -torch.exp(t(d, n) * 0.5), t(b, L, n), t(b, L, n)
    D, z = t(d), t(b, L, d)
    y_full, h_full = ops.selective_scan(x, dt, A, B, C, D=D, z=z)
    y1, h1 = ops.selective_scan(x[:, :L1], dt[:, :L1], A, B[:, :L1],
                                C[:, :L1], D=D, z=z[:, :L1])
    y2, h2 = ops.selective_scan(x[:, L1:], dt[:, L1:], A, B[:, L1:],
                                C[:, L1:], D=D, z=z[:, L1:], h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(h2, h_full, rtol=1e-4, atol=1e-4)


def test_bf16_state_pool_and_unported_families():
    """A bf16 state pool; what stays unported raises, naming its ROADMAP
    item: the cross-layer megakernel under a tensor-parallel mesh (A16;
    the mesh itself is served since A13a)."""
    _, tcfg = _cfgs(state_dtype="bf16")
    cache = tregistry.init_cache(tcfg, 2, 16)
    assert cache["h"].dtype == torch.bfloat16
    assert "h_scale" not in cache
    with pytest.raises(ValueError, match="A16"):
        Engine(tcfg, tregistry.init_params(tcfg),
               EngineConfig(device="cpu", mesh=object(),
                            step_impl="megakernel"))
