"""The port's logical-axis sharding (``parallel/sharding.py``,
``launch/mesh.py``, ``registry.param_axes`` / ``cache_axes``) against
``repro``'s, with no process started: ``repro``'s ``spec_for_shape`` and
``validate_divisibility`` read only a mesh's ``axis_names``, its
``shape`` dict and its ``devices`` array's shape, so a namespace stands
in for a JAX mesh, and the port's shard arithmetic reads only the axis
sizes and the rank's coordinates.

Every param and cache leaf's per-rank shard shape equals ``repro``'s
``spec_for_shape`` over its ``abstract_params`` / ``cache_axes`` (all
four families' smoke configs, tp 2, 4 and 8, f32 and int8 weights and
state), the pool's ``device_state_bytes_per_slot`` equals ``repro``'s
formula, and the fused projections' piecewise cut gives each rank the
same channels of every piece."""
import dataclasses
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import registry as rreg
from repro.parallel import sharding as rsh
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry
from repro_torch.parallel import sharding as tsh
from repro_torch.runtime.state_pool import SlotStatePool

ARCHS = ["mamba-130m", "jamba-v0.1-52b", "xlstm-350m", "qwen2-7b",
         "qwen2-moe-a2.7b"]
DTYPES = [("f32", "f32", "model"), ("int8", "int8", "int8")]


def meshes(shape, axes, coords=None):
    """(repro's stand-in, the port's stand-in) of one mesh layout."""
    r = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                              devices=np.zeros(shape))
    t = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                              coords=coords or {a: 0 for a in axes})
    return r, t


def cfgs(arch, wd, sd, kv):
    kw = dict(weight_dtype=wd, state_dtype=sd, kv_cache_dtype=kv)
    return (dataclasses.replace(rconfigs.smoke_variant(
        rconfigs.get_config(arch)), **kw),
        dataclasses.replace(tconfigs.smoke_variant(
            tconfigs.get_config(arch)), **kw))


def fused_leaves(family, int8):
    """{the last two keys of a fused leaf: its pieces}: mamba's in_proj
    [x | z], the mLSTM's up [u | g], the sLSTM's four gates and bias."""
    names = {"mamba": [("in_proj", 2)], "jamba": [("in_proj", 2)],
             "xlstm": [("up", 2), ("wx", 4)], "transformer": []}[family]
    out = {f"['{k}']['{w}']": n for k, n in names
           for w in (("w", "w_scale") if int8 else ("w",))}
    if family == "xlstm":
        out["['slstm']['b']"] = 4
    return out


LOGICAL = [None, "vocab", "embed", "heads", "kv", "ffn", "expert", "layers",
           "conv", "state", "act_batch", "act_seq", "act_ffn", "act_heads",
           "act_embed", "act_vocab", "act_expert"]
LAYOUTS = [((2,), ("model",)), ((4,), ("model",)), ((2, 2), ("data",
                                                              "model")),
           ((2, 2, 2), ("pod", "data", "model"))]
RULES = [rsh.ShardingRules(), rsh.ShardingRules(**rsh.LONG_CONTEXT_OVERRIDES),
         rsh.ShardingRules(embed=None, heads=("data", "model"))]


def port_rules(r):
    return tsh.ShardingRules(**dataclasses.asdict(r))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "x".join(
    map(str, l[0])))
def test_rules_and_specs_equal_repros(layout):
    rmesh, tmesh = meshes(*layout)
    rng = np.random.default_rng(0)
    for rr in RULES:
        tr = port_rules(rr)
        for name in LOGICAL:
            assert (tr.resolve(name, set(layout[1]))
                    == rr.resolve(name, set(layout[1]))), name
        for _ in range(200):
            nd = int(rng.integers(1, 5))
            axes = tuple(rng.choice(LOGICAL[1:], nd))
            shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16]))
                          for _ in range(nd))
            want = rsh.spec_for_shape(shape, axes, rmesh, rr)
            assert tuple(tsh.spec_for_shape(shape, axes, tmesh, tr)) == \
                tuple(want), (shape, axes)
            assert (tuple(tsh.logical_to_spec(axes, tmesh, tr))
                    == tuple(rsh.logical_to_spec(axes, rmesh, rr)))


def _repro_shard_tree(ap, rmesh, n_of):
    def shard(p):
        spec = rsh.spec_for_shape(p.value.shape, p.axes, rmesh,
                                  rsh.ShardingRules())
        return np.zeros(tuple(d // n_of(e) for d, e in
                              zip(p.value.shape, spec)), np.int8)
    return jax.tree.map(shard, ap, is_leaf=rsh.is_param)


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_equal_repros(arch, tp):
    """Every param leaf (f32 and int8 trees) and cache leaf (f32 and
    int8/fp8 state, int8 KV): the port's shard shape is repro's, and
    validate_divisibility flags the same dims."""
    rmesh, tmesh = meshes((tp,), ("model",))

    def n_of(e):
        return 1 if e is None else tp

    for dts in DTYPES:
        rc, tc = cfgs(arch, *dts)
        ap = rreg.abstract_params(rc)
        want = bridge.params_from_repro(_repro_shard_tree(ap, rmesh, n_of))
        full = bridge.params_from_repro(jax.tree.map(
            lambda p: np.zeros(p.value.shape, np.int8), ap,
            is_leaf=rsh.is_param))
        pax = registry.param_axes(tc)
        got = tsh._zip_tree(lambda t, a: tuple(tsh.shard_shape(
            t.shape, a, tmesh)), full, pax)
        assert dict(tsh._walk(got)) == dict(tsh._walk(registry.tree_map(
            lambda t: tuple(t.shape), want))), (arch, dts)
        # the fused projections, and only they, carry their piece counts
        assert {tsh.keystr(p[-2:]): tsh.parts_of(a) for p, a in
                tsh._walk(pax) if tsh.parts_of(a) > 1} == fused_leaves(
                    tc.family, dts[0] == "int8"), (arch, dts)
        bad_r = rsh.validate_divisibility(ap, rmesh, warn=lambda m: None)
        bad_t = tsh.validate_divisibility(full, pax, tmesh,
                                          warn=lambda m: None)
        assert (sorted(b[1:] for b in bad_t) == sorted(b[1:] for b in bad_r))
        # the cache, 3 slots
        ca, ac = rreg.cache_axes(rc), rsh.tree_values(
            rreg.abstract_cache(rc, 3, 16))
        wc = jax.tree.map(lambda a, v: tuple(
            d // n_of(e) for d, e in zip(v.shape, rsh.spec_for_shape(
                v.shape, a, rmesh))), ca, ac,
            is_leaf=lambda x: isinstance(x, tuple))
        tcache = registry.init_cache(tc, 3, 16, device="meta")
        gc = tsh._zip_tree(lambda t, a: tuple(tsh.shard_shape(
            t.shape, a, tmesh)), tcache, registry.cache_axes(tc))
        assert dict(tsh._walk(gc)) == dict(tsh._walk(wc)), (arch, dts)


@pytest.mark.parametrize("arch,sd", [("mamba-130m", "f32"),
                                     ("mamba-130m", "int8"),
                                     ("jamba-v0.1-52b", "int8"),
                                     ("xlstm-350m", "fp8"),
                                     ("qwen2-7b", "f32")])
def test_device_bytes_per_slot_is_repros_formula(arch, sd):
    """``repro``'s ``device_state_bytes_per_slot``: each leaf's shard
    shape times its item size, summed, over the pool's slots (3 live,
    2 scratch); the unsharded number stays ``state_bytes_per_slot``."""
    tp = 2
    rmesh, tmesh = meshes((tp,), ("model",), {"model": 1})
    kv = "int8" if arch == "jamba-v0.1-52b" else "model"
    rc, tc = cfgs(arch, "f32", sd, kv)
    ca, ac = rreg.cache_axes(rc), rsh.tree_values(
        rreg.abstract_cache(rc, 5, 32))
    want = sum(int(np.prod([d // (1 if e is None else tp) for d, e in zip(
        v.shape, rsh.spec_for_shape(v.shape, a, rmesh))])) * v.dtype.itemsize
        for a, v in zip(jax.tree.leaves(ca, is_leaf=lambda x: isinstance(
            x, tuple)), jax.tree.leaves(ac))) // 5
    full = sum(int(np.prod(v.shape)) * v.dtype.itemsize
               for v in jax.tree.leaves(ac)) // 5
    pool = SlotStatePool(tc, 3, 32, n_scratch=2, mesh=tmesh)
    assert pool.device_state_bytes_per_slot() == want
    assert pool.state_bytes_per_slot() == full
    assert pool.device_slots_per_gb() > pool.slots_per_gb()
    assert SlotStatePool(tc, 3, 32, n_scratch=2).device_state_bytes_per_slot(
    ) == full


@pytest.mark.parametrize("parts,tp", [(2, 2), (2, 4), (4, 2)])
def test_piecewise_cut(parts, tp):
    """A fused projection's columns [p_0 | ... | p_k-1]: rank r holds
    shard r of every piece, in piece order, so its output splits into
    the pieces' shards; ranks together hold every column once."""
    d_in, piece = 3, 8 * tp
    w = torch.arange(d_in * parts * piece, dtype=torch.float32).reshape(
        d_in, parts * piece)
    seen = []
    for r in range(tp):
        _, tmesh = meshes((tp,), ("model",), {"model": r})
        loc = tsh.shard_leaf(w, tsh.Fused(("embed", "ffn"), parts), tmesh)
        assert loc.shape == (d_in, parts * piece // tp)
        assert loc.is_contiguous()
        w_loc = piece // tp
        for i, chunk in enumerate(loc.chunk(parts, dim=-1)):
            lo = i * piece + r * w_loc
            assert torch.equal(chunk, w[:, lo:lo + w_loc])
        seen.append(loc)
    assert sorted(torch.cat(seen, -1)[0].tolist()) == w[0].tolist()


def test_mesh_error_paths_without_ranks():
    """Every mesh constructor refuses a world of the wrong size: no
    process group here."""
    from repro_torch.launch import mesh as mesh_lib
    with pytest.raises(ValueError):
        mesh_lib.make_serving_mesh(0)
    for fn in (lambda: mesh_lib.make_serving_mesh(2),
               lambda: mesh_lib.make_local_mesh((2, 2)),
               lambda: mesh_lib.make_production_mesh(),
               lambda: mesh_lib.make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError) as ei:
            fn()
        assert "have 0" in str(ei.value)


def test_shard_index_is_row_major():
    """A dim on ("data", "model") of a (2, 2) mesh: shard index data-major,
    as a JAX mesh orders its devices."""
    for d, m in itertools.product(range(2), range(2)):
        _, tmesh = meshes((2, 2), ("data", "model"), {"data": d, "model": m})
        assert tsh.shard_index(tmesh, ("data", "model")) == (2 * d + m, 4)
        assert tsh.shard_index(tmesh, "model") == (m, 2)
