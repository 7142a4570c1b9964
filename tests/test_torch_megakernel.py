"""The cross-layer decode megakernel (K3) of the port on the CPU.

On the CPU K3's wrapper runs its plain version
(``kernels.ref.mamba_stacked_step``): the layer loop with
``mamba.mamba_block_megastep`` as its body.  Held here:

  1. the plain K3 against ``repro``'s ``registry.decode_step`` with
     ``step_impl="megakernel"`` (its Pallas megakernel in interpret mode),
     on repro's weights and caches bridged as numpy, mamba-130m-smoke at
     vocab 64, f32 compute: logits at 1e-4; an int8/fp8 state within one
     code and its scales to 1e-6 relative;
  2. the engine's greedy streams under slot churn (4 requests, 2 slots):
     the port's megakernel engine emits bitwise the port's fused engine's
     streams, and repro's megakernel engine's;
  3. the launch pins of ``core.dispatch_count``: 1 per decoded token for
     the megakernel, 2 x n_layers for the fused path (the conv and the
     step kernel per layer; repro's pin is n_layers, its default conv
     being XLA);
  4. ``resolve_step_impl`` / ``resolve_cell_impl`` on both devices;
  5. what the wrapper refuses.
K3 itself is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import weight_quant as jwq
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro.runtime import engine as jengine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import dispatch_count
from repro_torch.core import state_quant as tsq
from repro_torch.kernels import megakernel, ops, ref
from repro_torch.models import registry as tregistry
from repro_torch.runtime.engine import Engine, EngineConfig

from _torch_inputs import code_ordinals, stacked_inputs

jax.config.update("jax_platform_name", "cpu")


def _cfgs(**kw):
    kw = {"vocab": 64, "dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.smoke_variant(
                jconfigs.get_config("mamba-130m")), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config("mamba-130m")), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, sharding.tree_values(
        jregistry.init_params(jcfg, jax.random.key(0))))


def _tokens(seed, b, L, vocab=64):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, L)).astype(np.int32)


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


# ---------------------------------------------------------------------------
# 1. Plain K3 against repro's megakernel
# ---------------------------------------------------------------------------

CASES = [("f32", "f32"), ("f32", "int8"), ("f32", "fp8"), ("int8", "f32"),
         ("int8", "int8"), ("int8", "fp8")]


@pytest.mark.parametrize("weight_dtype,state_dtype", CASES,
                         ids=[f"{w}_weights_{s}_state" for w, s in CASES])
def test_plain_megakernel_matches_repros(weights, weight_dtype,
                                         state_dtype):
    """repro prefills 2 slots; the port takes repro's cache across the
    bridge and both decode 3 tokens through their megakernels.  Logits
    every step at 1e-4 (f32); the final caches: an f32 state and the
    conv tails at 1e-4, an int8/fp8 state within one code (a value on a
    rounding boundary may round the other way after XLA's and torch's
    f32 sums) with scales to 1e-6 relative."""
    tol = 1e-4
    jcfg, tcfg = _cfgs(step_impl="megakernel", state_dtype=state_dtype,
                       weight_dtype=weight_dtype)
    jw = (jax.tree.map(np.asarray, jwq.quantize_tree(weights))
          if weight_dtype == "int8" else weights)
    tp = tregistry.stack_params(tcfg, bridge.params_from_repro(jw))
    toks = _tokens(3, 2, 12)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 32))
    _, jcache = jregistry.prefill(jcfg, jw, jcache,
                                  {"tokens": jnp.asarray(toks[:, :9])})
    tcache = bridge.cache_from_repro(jax.tree.map(np.asarray, jcache))
    ref.CALLS.clear()
    for s in range(3):
        t = toks[:, 9 + s:10 + s]
        jl, jcache = jregistry.decode_step(jcfg, jw, jcache,
                                           {"tokens": jnp.asarray(t)})
        tl, tcache = tregistry.decode_step(tcfg, tp, tcache, {
            "tokens": torch.from_numpy(t).long()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"decode step {s}")
    assert dict(ref.CALLS) == {"mamba_stacked_step": 3}
    jc = bridge.cache_from_repro(jax.tree.map(np.asarray, jcache))
    assert set(jc) == set(tcache)
    assert tcache["h"].dtype == tsq.storage_dtype(state_dtype)
    np.testing.assert_allclose(tcache["conv"], jc["conv"], rtol=tol,
                               atol=tol)
    assert torch.equal(tcache["pos"], jc["pos"])
    if state_dtype == "f32":
        np.testing.assert_allclose(tcache["h"], jc["h"], rtol=tol, atol=tol)
        return
    np.testing.assert_allclose(tcache["h_scale"], jc["h_scale"], rtol=1e-6,
                               atol=0)
    diff = (code_ordinals(tcache["h"]) - code_ordinals(jc["h"])).abs()
    assert int(diff.max()) <= 1


def test_megastep_equals_the_per_layer_step_bitwise(weights):
    """mamba_block_megastep gives mamba_block_step's values bit for bit
    on the CPU, whatever the state dtype: one layer of the plain K3 is
    one fused per-layer step."""
    from repro_torch.models import mamba
    for sd in ("f32", "bf16", "int8", "fp8"):
        _, tcfg = _cfgs(state_dtype=sd)
        lp = bridge.params_from_repro(weights)["layers"][1]["mixer"]
        cache = tregistry.init_cache(tcfg, 3, 16)
        _, cache = tregistry.prefill(
            tcfg, bridge.params_from_repro(weights), cache,
            {"tokens": torch.from_numpy(_tokens(8, 3, 6)).long()})
        state = {k: cache[k][1] for k in cache if k != "pos"}
        x = torch.from_numpy(_tokens(9, 3, 64).astype(np.float32)
                             / 64.0)[:, None, :]
        y0, s0 = mamba.mamba_block_step(tcfg, lp, x, state)
        y1, s1 = mamba.mamba_block_megastep(tcfg, lp, x, state)
        assert torch.equal(y0, y1), sd
        assert set(s0) == set(s1)
        for k in s0:
            assert torch.equal(_bits(s0[k]), _bits(s1[k])), (sd, k)


# ---------------------------------------------------------------------------
# 2. Engine streams: megakernel == fused (port) == megakernel (repro)
# ---------------------------------------------------------------------------

def _prompts(n, seed=11, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(l,)).astype(np.int32)
            for l in rng.integers(3, 10, size=n)]


ENGINE_CASES = [("f32", "f32"), ("f32", "int8"), ("int8", "f32")]


@pytest.mark.parametrize("weight_dtype,state_dtype", ENGINE_CASES,
                         ids=[f"{w}_weights_{s}_state"
                              for w, s in ENGINE_CASES])
def test_engine_megakernel_streams_equal_fused_and_repros(
        weights, weight_dtype, state_dtype):
    """4 requests through 2 slots (admission, eviction, slot reuse): one
    launch per token changes the dispatch, never a token.  The port's
    megakernel engine's greedy streams equal its fused engine's bit for
    bit and repro's megakernel engine's token for token; its decode runs
    the plain K3 once per pooled step and the per-layer conv and step
    never."""
    jcfg, tcfg = _cfgs()
    prompts = _prompts(4)
    kw = dict(n_slots=2, max_seq=64, state_dtype=state_dtype,
              weight_dtype=weight_dtype)
    tp = bridge.params_from_repro(weights)
    streams = {}
    for impl in ("fused", "megakernel"):
        eng = Engine(tcfg, tp, EngineConfig(device="cpu", step_impl=impl,
                                            **kw))
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        ref.CALLS.clear()
        eng.run()
        streams[impl] = [r.tokens for r in reqs]
        s, L = eng.stats, tcfg.n_layers
        if impl == "megakernel":
            assert "stack" in eng.params
            assert ref.CALLS["mamba_stacked_step"] == s.decode_steps > 0
            assert ref.CALLS["causal_conv1d"] == L * s.prefill_calls
            assert "selective_state_step" not in ref.CALLS
            assert "selective_state_step_q" not in ref.CALLS
    assert streams["megakernel"] == streams["fused"]
    jeng = jengine.Engine(jcfg, weights, jengine.EngineConfig(
        step_impl="megakernel", **kw))
    jreqs = [jeng.submit(p, max_new=6) for p in prompts]
    jeng.run()
    assert streams["megakernel"] == [r.tokens for r in jreqs]


def test_engine_auto_is_fused_on_the_cpu(weights):
    """"auto" is the megakernel only for an engine on the card: on the
    CPU the engine builds no stacked view and decodes per layer."""
    _, tcfg = _cfgs(step_impl="auto")
    eng = Engine(tcfg, bridge.params_from_repro(weights),
                 EngineConfig(device="cpu", n_slots=2, max_seq=32))
    assert "stack" not in eng.params
    ref.CALLS.clear()
    eng.submit(np.arange(5), max_new=3)
    eng.run()
    assert "mamba_stacked_step" not in ref.CALLS
    assert ref.CALLS["selective_state_step"] > 0


# ---------------------------------------------------------------------------
# 3. Launch pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_launches_per_token(weights, state_dtype):
    """One decode step of 2 slots: 1 launch for the megakernel, 2 per
    layer (conv + step) for the fused path, counted by
    core.dispatch_count from the plain versions' entries on the CPU."""
    _, tcfg = _cfgs(state_dtype=state_dtype)
    tp = bridge.params_from_repro(weights)
    cache = tregistry.init_cache(tcfg, 2, 16)
    batch = {"tokens": torch.tensor([[3], [4]])}
    mega = dataclasses.replace(tcfg, step_impl="megakernel")
    fused = dataclasses.replace(tcfg, step_impl="fused")
    n_mega = dispatch_count.launch_counts(
        tregistry.decode_step, mega, tregistry.stack_params(mega, tp),
        cache, batch)
    n_fused = dispatch_count.launch_counts(tregistry.decode_step, fused, tp,
                                           cache, batch)
    assert dict(n_mega) == {"plain mamba_stacked_step": 1}
    assert sum(n_fused.values()) == 2 * tcfg.n_layers == 8
    assert n_fused["plain causal_conv1d"] == tcfg.n_layers
    assert dispatch_count.count_launches(
        tregistry.decode_step, mega, tregistry.stack_params(mega, tp),
        cache, batch) == 1


def test_dispatch_count_reset_and_snapshot():
    dispatch_count.reset()
    snap = dispatch_count.snapshot()
    assert set(snap) <= set(dispatch_count.COUNTERS)
    assert sum(snap.values()) == 0
    megakernel.launches_q = 3
    assert dispatch_count.snapshot()["mamba_stacked_step_q"] == 3
    dispatch_count.reset()
    assert megakernel.launches_q == 0


# ---------------------------------------------------------------------------
# 4. Routing
# ---------------------------------------------------------------------------

def test_resolve_step_and_cell_impl():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ops.resolve_step_impl("auto", cpu) == "fused"
    assert ops.resolve_step_impl("auto", cuda) == "megakernel"
    assert ops.resolve_step_impl("auto", "cuda:0") == "megakernel"
    for dev in (cpu, cuda):
        assert ops.resolve_step_impl("megakernel", dev) == "megakernel"
        for name in ("fused", "pallas", "xla"):
            assert ops.resolve_step_impl(name, dev) == "fused"
        for name in ("auto", "megakernel", "fused", "pallas", "xla"):
            assert ops.resolve_cell_impl(name, dev) == "fused"
        for bad in ("nope", "MEGAKERNEL", ""):
            with pytest.raises(KeyError):
                ops.resolve_step_impl(bad, dev)
            with pytest.raises(KeyError):
                ops.resolve_cell_impl(bad, dev)


def test_per_layer_sites_under_a_megakernel_config(weights):
    """A per-layer call site (one block's step) under a megakernel config
    runs the fused step, as repro's resolve_cell_impl routes it."""
    from repro_torch.models import mamba
    _, tcfg = _cfgs(step_impl="megakernel")
    lp = bridge.params_from_repro(weights)["layers"][0]["mixer"]
    state = {k: v[0] for k, v in tregistry.init_cache(tcfg, 2, 8).items()
             if k != "pos"}
    ref.CALLS.clear()
    mamba.mamba_block_step(tcfg, lp, torch.ones(2, 1, 64), state)
    assert ref.CALLS["selective_state_step"] == 1


# ---------------------------------------------------------------------------
# 5. What K3 refuses
# ---------------------------------------------------------------------------

def _stack_cfg(**kw):
    return dataclasses.replace(tconfigs.smoke_variant(
        tconfigs.get_config("mamba-130m")), vocab=64, **kw)


@pytest.mark.parametrize("what,match", [
    ("d_state", "d_state 16"), ("norm", "rmsnorm"), ("bias", "bias"),
    ("wide", "shared memory"), ("family", "mamba"),
    ("layers", "n_layers"), ("dtype", "dtype")])
def test_stack_refuses_what_k3_does_not_take(what, match):
    cfg = _stack_cfg()
    p = tregistry.init_params(cfg, seed=0)
    if what == "d_state":
        cfg = dataclasses.replace(cfg, d_state=8)
        p = tregistry.init_params(cfg, seed=0)
    elif what == "norm":
        cfg = dataclasses.replace(cfg, norm="ln")
    elif what == "bias":
        p["layers"][0]["mixer"]["x_proj"]["b"] = torch.zeros(40)
    elif what == "wide":
        cfg = dataclasses.replace(cfg, d_model=8192, n_layers=1)
        p = {"layers": [{"norm": {}, "mixer": {"A_log": None}}]}
    elif what == "family":
        cfg = dataclasses.replace(cfg, family="xlstm")
    elif what == "layers":
        p["layers"] = p["layers"][:2]
    elif what == "dtype":
        p["layers"][2]["mixer"]["D"] = p["layers"][2]["mixer"]["D"].double()
    with pytest.raises(ValueError, match=match):
        megakernel.MambaStack(cfg, p["layers"])


def test_wrapper_refuses_mismatched_calls():
    cfg = _stack_cfg(state_dtype="int8")
    p, x0, h, h_scale, conv = stacked_inputs(cfg, 3)
    st = p["stack"]
    x, h1, s1, c1 = megakernel.mamba_stacked_step(cfg, x0, st, h, h_scale,
                                                  conv)
    assert x.shape == x0.shape and h1.dtype == torch.int8
    assert s1.shape == h_scale.shape and c1.shape == conv.shape
    bad = {
        "h dtype": (cfg, x0, st, h.float(), h_scale, conv),
        "no h_scale": (cfg, x0, st, h, None, conv),
        "x0 shape": (cfg, x0[:, 0], st, h, h_scale, conv),
        "conv dtype": (cfg, x0, st, h, h_scale, conv.double()),
        "f64": (cfg, x0.double(), st, h, h_scale, conv),
        "cfg": (dataclasses.replace(cfg, d_model=32), x0, st, h, h_scale,
                conv),
        "strided h": (cfg, x0, st, h.transpose(2, 3).contiguous()
                      .transpose(2, 3), h_scale, conv),
        "exp_impl": (dataclasses.replace(cfg, exp_impl="nope"), x0, st, h,
                     h_scale, conv),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            megakernel.mamba_stacked_step(*args)
    f32 = dataclasses.replace(cfg, state_dtype="f32")
    with pytest.raises(ValueError, match="h_scale"):
        megakernel.mamba_stacked_step(f32, x0, st, h.float(), h_scale, conv)


def test_megakernel_decode_needs_the_stacked_view(weights):
    _, tcfg = _cfgs(step_impl="megakernel")
    tp = bridge.params_from_repro(weights)
    cache = tregistry.init_cache(tcfg, 2, 8)
    with pytest.raises(ValueError, match="stack_params"):
        tregistry.decode_step(tcfg, tp, cache,
                              {"tokens": torch.tensor([[1], [2]])})


def test_stack_holds_the_weights_without_copying(weights):
    """The stacked view shares every weight with the tree (no second
    copy), and outlives later edits of the caller's dicts."""
    _, tcfg = _cfgs(weight_dtype="int8")
    tp = tregistry.quantize_params(tcfg, bridge.params_from_repro(weights))
    sp = tregistry.stack_params(tcfg, tp)
    st = sp["stack"]
    assert st.int8 and st.table is None     # pointer table only on a card
    for got, lp in zip(st.layers, tp["layers"]):
        assert got["mixer"]["in_proj"]["w"] is lp["mixer"]["in_proj"]["w"]
        assert got["mixer"]["A_q"] is lp["mixer"]["A_q"]
        assert got["norm"]["scale"] is lp["norm"]["scale"]
    old = tp["layers"][0]["mixer"]["out_proj"]["w"]
    tp["layers"][0]["mixer"]["out_proj"]["w"] = old.clone()
    assert st.layers[0]["mixer"]["out_proj"]["w"] is old
    assert sp["layers"] is tp["layers"]


_MB_HEADER = (pathlib.Path(megakernel.__file__).parent.parent / "csrc"
              / "megakernel_mamba.cuh")


def _csrc_jamba_scratch(b, dm, di, nx, d_ff, g, grid):
    """csrc megakernel_mamba.cuh's jamba scratch on a ``grid``-block
    launch, read from the source: the float offset of each region
    ``scratch_of`` lays out (and of the end of its last, the scale
    groups' counters), the counters the kernel zeroes (``ncnt``), and
    the size the launch demands (``scratch_floats``)."""
    text = _MB_HEADER.read_text()
    env = {k: int(v) for k, v in
           re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    env.update(max=max, b=b, dm=dm, di=di, nx=nx, d_ff=d_ff, g=g, G=grid,
               grid=grid)

    def ev(expr):
        expr = re.sub(r"\(int64_t\)|\b[as]\.|\s+", " ", expr)
        return eval(expr.replace("/", "//"), {}, env)

    def body(signature):
        return re.search(re.escape(signature) + r"[^{]*\{(.*?)\n\}", text,
                         re.S).group(1)

    tb = body("int tile_bound(")
    for name, expr in re.findall(r"const int (\w+) = ([^;]+);", tb):
        env[name] = ev(expr)
    env["tmax"] = ev(re.search(r"return ([^;]+);", tb).group(1))
    off = {"scratch": 0}
    for field, base, expr in re.findall(
            r"s\.(\w+) = (?:reinterpret_cast<int\*>\()?(?:s\.(\w+)|"
            r"a\.scratch)(?: \+ ([^;]*?))?\)?;", body("scratch_of(")):
        off[field] = off[base or "scratch"] + (ev(expr) if expr else 0)
    ncnt = ev(re.search(r"s\.ncnt = ([^;]+);", body("scratch_of(")).group(1))
    sf = body("int64_t scratch_floats(")
    for name in re.findall(r"const int64_t (\w+) = tile_bound\(", sf):
        env[name] = env["tmax"]
    floats = ev(re.search(r"return ([^;]+);", sf).group(1))
    return off, off["grp"] + g, ncnt, floats


@pytest.mark.parametrize("slots", range(1, 10))
def test_jamba_scratch_holds_partials_and_counters_unpadded(slots):
    """The wrapper's jamba scratch is exactly what csrc's ``scratch_of``
    lays out (read from megakernel_mamba.cuh and evaluated) and what the
    launch demands, on odd grids and at jamba-v0.1's and the card tests'
    ragged widths: the hidden exactly (slots, d_ff) (no padding rows:
    w2's items stage their rows of it), room for the partial sums of
    every (block + tile) index of each GEMV at its narrowest tiles (32
    columns), and every counter zeroed."""
    for dm, di, nx, ff in ((4096, 8192, 288, 14336), (550, 1100, 67, 1000)):
        g = -(-di // 512)
        for grid in (1, 7, 132, 264):
            off, end, ncnt, floats = _csrc_jamba_scratch(slots, dm, di, nx,
                                                         ff, g, grid)
            got = megakernel.scratch_floats(slots, dm, di, nx, ff, grid)
            assert got == floats == end, (dm, grid)
            order = ("xa", "zb", "dbc", "yb", "hid", "amax", "part", "cnt",
                     "done", "grp")
            sizes = [off[b] - off[a] for a, b in zip(order, order[1:])]
            assert sizes[:6] == [slots * di, slots * di, slots * nx,
                                 slots * di, slots * ff, slots * grid]
            for n in (2 * di, nx, dm, ff):
                parts = grid + -(-n // 32) - 1
                assert off["cnt"] - off["part"] >= parts * 2 * slots * 128
            assert off["grp"] - off["cnt"] == 5 * -(-max(2 * di, nx, dm,
                                                          ff) // 32) + 1
            assert ncnt == end - off["cnt"]


@pytest.mark.parametrize("slots", range(1, 10))
def test_mamba_scratch_holds_its_vectors_and_state(slots):
    """K3's mamba scratch at mamba-130m's widths (csrc megakernel_mamba.cu
    ``scratch_floats``): x_a, z and y (slots, d_inner), (dt_low | B | C)
    (slots, dt_rank + 32), the 32-channel chunks' absmax and the f32 state
    values (slots, d_inner, 16); no grid term, no counters."""
    di, nx = 1536, 80
    want = slots * (3 * di + nx + di // 32 + 16 * di)
    assert megakernel.mamba_scratch_floats(slots, di, nx) == want


@pytest.mark.parametrize("family,d_model,d_conv,refused", [
    ("mamba", 4096, 4, None), ("mamba", 4097, 4, "d_model 4097"),
    ("mamba", 8192, 4, "shared memory"), ("mamba", 768, 5, None),
    ("mamba", 768, 6, "d_conv up to 5"), ("mamba", 768, 2, None),
    ("jamba", 4096, 4, None), ("jamba", 4097, 4, "d_model 4097"),
    ("jamba", 768, 5, "d_conv up to 4")])
def test_k3_takes_d_model_and_d_conv_up_to_its_limits(family, d_model,
                                                      d_conv, refused):
    """What the wrapper refuses by width before the card is asked: a
    d_model above ``MAX_MODEL`` (4096, the mamba instance's 8 norm scales
    a thread of 512, the jamba instance's kMaxModel) and a d_conv above
    the conv tail a thread reads (5 in the mamba instance, 4 in the
    jamba instance).  The panels and shared memory of a width are the
    card's to size (``launch_config``), and it refuses at launch what one
    block cannot take."""
    arch = "mamba-130m" if family == "mamba" else "jamba-v0.1-52b"
    cfg = dataclasses.replace(tconfigs.get_config(arch), d_model=d_model,
                              d_conv=d_conv)
    if refused is None:
        megakernel._check_cfg(cfg, family)
    else:
        with pytest.raises(ValueError, match=refused):
            megakernel._check_cfg(cfg, family)


@pytest.mark.parametrize("kind,slots,d_model,n_heads,want", [
    ("mlstm", 4, 1024, 4, 452176),     # xlstm-350m as served
    ("mlstm", 6, 96, 4, 26692),        # the card tests' ragged width
    ("mlstm", 3, 100, 2, 16350),
    ("slstm", 4, 1024, 4, 0)])
def test_xlstm_scratch_holds_the_mlstm_layout(kind, slots, d_model, n_heads,
                                             want):
    """K3's xLSTM scratch (csrc ``scratch_floats``): for the mLSTM u, the
    conv output and g (slots, 2 d_model) each; the C' items' partial sums
    of C'^T q, one per tile of 16 rows of a head, and their sums over
    groups of 8 tiles; the down items' partial sums, up to 32 row ranges
    of (slots, d_model); the same two sums of n'.q, one float per (slot,
    head, tile or group); and the arrival counters, one per (head, group)
    and per 64-column tile of down (d_model reserved).  The sLSTM needs
    none: an item keeps its four gates' input parts and pre-activations in
    shared memory and runs the cell of its columns, and phase 2 reads h'
    back from the new state to compute the group norm."""
    got = megakernel.xlstm_scratch_floats(kind, slots, d_model, n_heads)
    if kind == "mlstm":
        di = 2 * d_model
        ntile = -(-(di // n_heads) // 16)
        ngroup = -(-ntile // 8)
        parts = {"u, cv, g": 3 * slots * di,
                 "C' tiles": slots * di * ntile,
                 "C' groups": slots * di * ngroup,
                 "down splits": 32 * slots * d_model,
                 "n'.q tiles and groups": slots * n_heads * (ntile + ngroup),
                 "counters": n_heads * ngroup + d_model}
        assert got == sum(parts.values())
    assert got == want
