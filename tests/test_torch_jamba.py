"""Jamba in the port (``repro_torch.models.jamba``, ``moe``, the attention
and MLP blocks) against ``repro``'s, on the CPU.

The same weights (``repro``'s, bridged as numpy) and the same seeded
inputs go through both packages in f32.  Held here, at ``repro``'s
tolerances:

  1. the blocks: rope, ``_kv_quant`` (codes bitwise, scales to f32
     rounding), the decode attention, ``attention_apply`` with and
     without a cache, ``mlp_apply`` and ``moe_apply`` (also with
     capacity overflow and padded experts) at 1e-5;
  2. the model, jamba-v0.1-52b-smoke (8 layers, d 64, 4 experts, top-2),
     a GQA variant (n_kv_heads 2: the smoke config has hkv = hq) and the
     dense variant (n_experts 0): ``forward``, ``prefill`` and
     ``decode_step`` logits at 1e-4, per layer and through the plain K3
     (``ref.jamba_stacked_run``); the caches, an int8/fp8 state and an
     int8 KV cache within one code;
  3. the launch pins of ``core.dispatch_count`` and the megakernel plan.
The engines are held in tests/test_torch_jamba_engine.py.
K3's jamba instance and K7 are held against their plain versions on the
card in tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weight_quant as jwq
from repro.models import blocks as jblocks
from repro.models import jamba as jjamba
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import dispatch_count
from repro_torch.kernels import megakernel, ref
from repro_torch.models import blocks, jamba, moe
from repro_torch.models import registry as tregistry

from _torch_inputs import code_ordinals
from _torch_jamba import (ARCH, VARIANTS, cfgs, close, normal, repro_weights,
                          rng, tensor, tokens)

jax.config.update("jax_platform_name", "cpu")


# ---------------------------------------------------------------------------
# 1. Blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_repro(theta):
    x = normal(1, 2, 9, 4, 16)
    positions = rng(2).integers(0, 500, size=(2, 9)).astype(np.int32)
    want = jblocks.rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = blocks.rope(tensor(x), tensor(positions), theta)
    close(got, want, 1e-5)


def test_kv_quant_matches_repro_bitwise():
    t = normal(3, 2, 5, 64) * 3.0
    t[0, 1] = 0.0                               # an all-zero row
    t[1, 2, :4] = [127.0, 0.5, -0.5, 1.5]       # exact ties after scaling
    jq, js = jblocks._kv_quant(jnp.asarray(t))
    tq, ts = blocks._kv_quant(tensor(t))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                               atol=0)
    np.testing.assert_array_equal(
        blocks._kv_dequant(tq, ts, torch.float32).numpy(),
        np.asarray(jblocks._kv_dequant(jq, js, jnp.float32)))


def test_decode_attention_matches_repro():
    q = normal(4, 3, 1, 4, 16)
    kc, vc = normal(5, 3, 20, 2, 16), normal(6, 3, 20, 2, 16)
    pos = np.array([0, 7, 19], np.int32)
    want = jblocks.decode_attention(*map(jnp.asarray, (q, kc, vc, pos)))
    got = blocks.decode_attention(*map(tensor, (q, kc, vc, pos)))
    close(got, want, 1e-5)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_attention_apply_matches_repro(kv):
    """Prefill (return_kv) through the plain K7, then a decode token
    written into a cache at per-slot positions."""
    jcfg, tcfg = cfgs("gqa", kv_cache_dtype=kv)
    jp = repro_weights("gqa")["groups"]["pos4"]["attn"]
    jp = jax.tree.map(lambda a: a[0], jp)
    tp = bridge.to_torch(jp)
    x = normal(7, 2, 11, 64)
    positions = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    jo, jkv = jblocks.attention_apply(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(positions), return_kv=True)
    to, tkv = blocks.attention_apply(tcfg, tp, tensor(x), tensor(positions),
                                     return_kv=True)
    close(to, jo, 1e-5)
    for k in ("k", "v"):
        close(tkv[k], jkv[k], 1e-5)
    S = 16
    jcache = {k: jnp.pad(jkv[k], ((0, 0), (0, S - 11), (0, 0)))
              for k in ("k", "v")}
    if kv == "int8":
        jcache = {}
        for k in ("k", "v"):
            q8, s8 = jblocks._kv_quant(jkv[k])
            jcache[k] = jnp.pad(q8, ((0, 0), (0, S - 11), (0, 0)))
            jcache[k + "_scale"] = jnp.pad(s8, ((0, 0), (0, S - 11), (0, 0)))
    tcache = bridge.to_torch(jax.tree.map(np.asarray, jcache))
    xt = normal(8, 2, 1, 64)
    dpos = np.array([11, 5], np.int32)
    jo, jnew = jblocks.attention_apply(jcfg, jp, jnp.asarray(xt),
                                       jnp.asarray(dpos[:, None]),
                                       cache=jcache, pos=jnp.asarray(dpos))
    to, tnew = blocks.attention_apply(tcfg, tp, tensor(xt),
                                      tensor(dpos[:, None]), cache=tcache,
                                      pos=tensor(dpos))
    close(to, jo, 1e-5)
    assert set(tnew) == set(jnew)
    for k in tnew:
        if tnew[k].dtype == torch.int8:
            assert int((tnew[k].int() - tensor(np.asarray(jnew[k])).int())
                       .abs().max()) <= 1
        else:
            close(tnew[k], jnew[k], 1e-5)


@pytest.mark.parametrize("mlp,silu", [("swiglu", "exact"),
                                      ("swiglu", "ours"), ("gelu", "exact")])
def test_mlp_apply_matches_repro(mlp, silu):
    jcfg, tcfg = cfgs("dense", mlp=mlp, silu_impl=silu)
    jp = jblocks.mlp_init(jcfg, jax.random.key(3))
    jp = jax.tree.map(np.asarray, sharding.tree_values(jp))
    x = normal(9, 3, 5, 64)
    want = jblocks.mlp_apply(jcfg, jp, jnp.asarray(x))
    close(blocks.mlp_apply(tcfg, bridge.to_torch(jp), tensor(x)), want, 1e-5)


MOE_CASES = {
    "default": {},
    "overflow": {"capacity_factor": 0.5},       # some assignments dropped
    "padded": {"expert_pad_to": 8, "capacity_factor": 0.75},
    "shared": {"n_shared_experts": 1, "norm_topk": False},
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_repro(case):
    jcfg, tcfg = cfgs("moe", **MOE_CASES[case])
    jp = jax.tree.map(np.asarray, sharding.tree_values(
        jmoe.moe_init(jcfg, jax.random.key(4))))
    x = normal(10, 3, 7, 64)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_apply(tcfg, bridge.to_torch(jp), tensor(x))
    close(ty, jy, 1e-5)
    for k in ("moe_lb", "moe_z"):
        close(taux[k], jaux[k], 1e-5, k)
    if case == "overflow":
        T, k = 21, jcfg.top_k
        assert moe._capacity(tcfg, T) * jcfg.n_experts < T * k


def test_moe_ep_is_not_ported():
    _, tcfg = cfgs("moe", moe_impl="ep")
    p = moe.moe_init(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="A13"):
        moe.moe_apply(tcfg, p, torch.zeros(1, 2, 64))


# ---------------------------------------------------------------------------
# 2. The model against repro's: forward, prefill, decode; per layer and K3
# ---------------------------------------------------------------------------

def test_bridge_round_trips_the_groups():
    w = repro_weights("moe")
    tp = bridge.params_from_repro(w)
    assert len(tp["groups"]) == 1 and set(tp["groups"][0]) == {
        f"pos{i}" for i in range(8)}
    back = bridge.params_to_repro(tp)
    jax.tree.map(np.testing.assert_array_equal, back, w)
    jcfg, tcfg = cfgs("moe")
    assert tregistry.count_params(tcfg) == jregistry.count_params(jcfg)
    full = dataclasses.replace(tconfigs.get_config(ARCH), n_layers=8)
    assert tregistry.count_params(full) == 13_295_050_752
    assert tregistry.count_params(dataclasses.replace(
        full, n_experts=0)) == 2_725_142_528


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_repro(variant):
    jcfg, tcfg = cfgs(variant)
    w = repro_weights(variant)
    toks = tokens(12, 2, 13)
    jl, jaux = jregistry.forward(jcfg, w, {"tokens": jnp.asarray(toks)})
    tl, taux = tregistry.forward(tcfg, bridge.params_from_repro(w),
                                 {"tokens": tensor(toks).long()})
    close(tl, jl)
    for k in ("moe_lb", "moe_z"):
        close(taux[k], jaux[k], 1e-5, k)


DECODE_CASES = [  # variant, step_impl, state_dtype, kv_cache_dtype, weights
    ("moe", "fused", "f32", "model", "f32"),
    ("moe", "megakernel", "f32", "model", "f32"),
    ("gqa", "fused", "f32", "model", "f32"),
    ("gqa", "megakernel", "f32", "model", "f32"),
    ("dense", "fused", "f32", "model", "f32"),
    ("dense", "megakernel", "f32", "model", "f32"),
    ("moe", "fused", "int8", "int8", "f32"),
    ("dense", "megakernel", "int8", "int8", "f32"),
    ("dense", "megakernel", "fp8", "model", "f32"),
    ("dense", "megakernel", "f32", "model", "int8"),
    ("moe", "megakernel", "int8", "int8", "int8"),
]


@pytest.mark.parametrize("variant,impl,sd,kv,wd", DECODE_CASES,
                         ids=["-".join(c) for c in DECODE_CASES])
def test_prefill_and_decode_match_repro(variant, impl, sd, kv, wd):
    """repro prefills 3 slots (ragged prompts by slot: one prefill per
    slot, scattered into the pool) and both packages decode 3 tokens:
    logits at 1e-4 every step; the final caches: f32 leaves at 1e-4, an
    int8/fp8 state and an int8 KV cache within one code, scales to 1e-6
    relative.  Through K3 the plain version runs once per pure-SSM run
    and token."""
    jcfg, tcfg = cfgs(variant, step_impl=impl, state_dtype=sd,
                       kv_cache_dtype=kv, weight_dtype=wd)
    w = repro_weights(variant)
    jw = jax.tree.map(np.asarray, jwq.quantize_tree(w)) if wd == "int8" \
        else w
    tp = bridge.params_from_repro(jw)
    if impl == "megakernel":
        tp = tregistry.stack_params(tcfg, tp)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 3, 24))
    for slot, L in enumerate((9, 5, 12)):
        toks = tokens(20 + slot, 1, L)
        sub = sharding.tree_values(jregistry.init_cache(jcfg, 1, 24))
        jl, sub = jregistry.prefill(jcfg, jw, sub,
                                    {"tokens": jnp.asarray(toks)})
        tsub = tregistry.init_cache(tcfg, 1, 24)
        tl, tsub = tregistry.prefill(tcfg, tp, tsub,
                                     {"tokens": tensor(toks).long()})
        close(tl, jl, msg=f"prefill slot {slot}")
        jcache = jregistry.scatter_slots(jcfg, jcache, sub,
                                         jnp.asarray([slot]))
    tcache = bridge.cache_from_repro(jax.tree.map(np.asarray, jcache))
    ref.CALLS.clear()
    steps = tokens(30, 3, 3)
    for s in range(3):
        t = steps[:, s:s + 1]
        jl, jcache = jregistry.decode_step(jcfg, jw, jcache,
                                           {"tokens": jnp.asarray(t)})
        tl, tcache = tregistry.decode_step(tcfg, tp, tcache,
                                           {"tokens": tensor(t).long()})
        close(tl, jl, msg=f"decode step {s}")
    n_runs = len([1 for k, _ in jamba._megakernel_plan(tcfg) if k == "mega"])
    assert ref.CALLS["jamba_stacked_run"] == (
        3 * n_runs if impl == "megakernel" else 0)
    jc = bridge.cache_from_repro(jax.tree.map(np.asarray, jcache))
    assert torch.equal(tcache["pos"], jc["pos"])
    for pos, leaves in jc["layers"].items():
        assert set(tcache["layers"][pos]) == set(leaves)
        for k, want in leaves.items():
            got = tcache["layers"][pos][k]
            assert got.dtype == want.dtype, (pos, k)
            if got.dtype in (torch.int8, torch.float8_e4m3fn):
                assert int((code_ordinals(got) - code_ordinals(want)).abs()
                           .max()) <= 1, (pos, k)
            elif k.endswith("scale"):
                close(got, want, 1e-6, f"{pos} {k}")
            else:
                close(got, want, msg=f"{pos} {k}")


def test_k3_run_equals_the_per_layer_sublayers_bitwise():
    """One run of the plain K3 is its positions' per-layer sublayers bit
    for bit on the CPU (int8 state, so the requantization is in the
    chain too)."""
    _, tcfg = cfgs("dense", state_dtype="int8")
    tp = bridge.params_from_repro(repro_weights("dense"))
    cache = tregistry.init_cache(tcfg, 2, 16)
    _, cache = tregistry.prefill(tcfg, tp, tregistry.init_cache(tcfg, 2, 16),
                                 {"tokens": tensor(tokens(40, 2, 6)).long()})
    run = megakernel.JambaRun(tcfg, [tp["groups"][0][f"pos{i}"]
                                     for i in range(4)])
    x = tensor(normal(41, 2, 1, 64))
    states = [{k: v[0] for k, v in cache["layers"][f"pos{i}"].items()}
              for i in range(4)]
    outs = [{k: torch.empty_like(v) for k, v in st.items()} for st in states]
    got = megakernel.jamba_stacked_run(tcfg, x, run, states, outs)
    want = x
    dpos = cache["pos"]
    for i in range(4):
        want, ns, _ = jamba._sublayer_apply(tcfg, tp["groups"][0][f"pos{i}"],
                                            i, want, dpos[:, None],
                                            state=states[i], dpos=dpos)
        for k in ns:
            assert torch.equal(outs[i][k], ns[k]), (i, k)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# 3. Launch pins and the plan
# ---------------------------------------------------------------------------

def test_megakernel_plan_matches_repros():
    for variant in VARIANTS:
        jcfg, tcfg = cfgs(variant)
        assert jamba._megakernel_plan(tcfg) == jjamba._megakernel_plan(jcfg)
    _, moe_cfg = cfgs("moe")
    assert jamba._megakernel_plan(moe_cfg) == (
        ("mega", (0,)), ("one", 1), ("mega", (2,)), ("one", 3), ("one", 4),
        ("one", 5), ("mega", (6,)), ("one", 7))
    _, dense_cfg = cfgs("dense")
    assert jamba._megakernel_plan(dense_cfg) == (
        ("mega", (0, 1, 2, 3)), ("one", 4), ("mega", (5, 6, 7)))


@pytest.mark.parametrize("variant,k3,per_layer", [
    ("moe", {"plain jamba_stacked_run": 3, "plain causal_conv1d": 4,
             "plain selective_state_step": 4}, 14),
    ("dense", {"plain jamba_stacked_run": 2}, 14)])
def test_launches_per_token(variant, k3, per_layer):
    """One decode token of 2 slots: through K3 one launch per pure-SSM
    run plus the conv and step kernels of each MoE position's mamba
    block (3 + 8 = 11 on the MoE config, 2 on the dense one), against
    the conv and step kernels of all 7 mamba positions per layer (14).
    The attention decode is plain PyTorch, as repro leaves it to XLA."""
    _, tcfg = cfgs(variant)
    tp = bridge.params_from_repro(repro_weights(variant))
    cache = tregistry.init_cache(tcfg, 2, 16)
    batch = {"tokens": torch.tensor([[3], [4]])}
    mega = dataclasses.replace(tcfg, step_impl="megakernel")
    fused = dataclasses.replace(tcfg, step_impl="fused")
    got = dispatch_count.launch_counts(
        tregistry.decode_step, mega, tregistry.stack_params(mega, tp),
        cache, batch)
    assert dict(got) == k3
    n = dispatch_count.launch_counts(tregistry.decode_step, fused, tp,
                                     cache, batch)
    assert dict(n) == {"plain causal_conv1d": 7,
                       "plain selective_state_step": 7}
    assert sum(n.values()) == per_layer


def test_launches_per_prefill():
    """A prefill of one group: 7 scans, 7 convs and one attention."""
    _, tcfg = cfgs("moe")
    tp = bridge.params_from_repro(repro_weights("moe"))
    got = dispatch_count.launch_counts(
        tregistry.prefill, tcfg, tp, tregistry.init_cache(tcfg, 1, 16),
        {"tokens": torch.arange(10)[None]})
    assert dict(got) == {"plain selective_scan": 7,
                         "plain causal_conv1d": 7, "plain attention": 1}


def test_run_refuses_what_k3_does_not_take():
    _, tcfg = cfgs("moe")
    tp = tregistry.init_params(tcfg, seed=0)
    g = tp["groups"][0]
    with pytest.raises(ValueError, match="mamba block and an MLP"):
        megakernel.JambaRun(tcfg, [g["pos1"]])          # MoE position
    with pytest.raises(ValueError, match="mamba block and an MLP"):
        megakernel.JambaRun(tcfg, [g["pos4"]])          # attention
    with pytest.raises(ValueError, match="swiglu"):
        megakernel.JambaRun(dataclasses.replace(tcfg, mlp="gelu"),
                            [g["pos0"]])
    with pytest.raises(ValueError, match="jamba"):
        megakernel.JambaRun(dataclasses.replace(tcfg, family="mamba"),
                            [g["pos0"]])
    run = megakernel.JambaRun(tcfg, [g["pos0"], g["pos2"]])
    cache = tregistry.init_cache(tcfg, 2, 8)
    st = [{k: v[0] for k, v in cache["layers"][p].items()}
          for p in ("pos0", "pos2")]
    outs = [{k: torch.empty_like(v) for k, v in s.items()} for s in st]
    x = torch.zeros(2, 1, 64)
    with pytest.raises(ValueError, match="run of 2"):
        megakernel.jamba_stacked_run(tcfg, x, run, st[:1], outs[:1])
    with pytest.raises(ValueError, match="h_scale"):
        megakernel.jamba_stacked_run(
            dataclasses.replace(tcfg, state_dtype="int8"), x, run, st, outs)
    with pytest.raises(ValueError):
        megakernel.jamba_stacked_run(tcfg, x.double(), run, st, outs)
    with pytest.raises(ValueError, match="stacked runs"):
        jamba.stacked_step(dataclasses.replace(tcfg, step_impl="megakernel"),
                           tp, cache, {"tokens": torch.zeros(2, 1).long()})
