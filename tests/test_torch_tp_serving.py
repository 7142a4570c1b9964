"""Tensor-parallel serving of the port's mamba family on the CPU: gloo
ranks started with the spawn method (``_torch_ranks.run_ranks``), each
serving through ``Engine(..., EngineConfig(mesh=make_serving_mesh(tp)))``
on its shard of the same seeded weights.

The contract (``repro``'s ``tests/test_sharded_serving.py``, whose
multi-device runs are red in the repo's CPU test runs, ROADMAP C.3, so
the references here are single-device): tp=2 and tp=4 greedy streams equal the port's
single-device engine's and ``repro``'s single-device engine's on bridged
weights, or first differ where the reference's top two logits are within
1e-4 (the row-parallel sums run in another order than one GEMM's), over
f32 and int8 state (the smoke d_inner of 128 is one scale group, cut by
every rank: the straddled requantization), with speculative decoding on
and off, with the prefix cache (a hit bitwise a cold admission), and
through streaming and a cancel that reclaims slots and leases; tp=1 is
bitwise the no-mesh engine.  The all-reduces of a decode step are pinned
between n_layers and 16 x n_layers, as ``repro`` pins its compiled
step's, and the megakernel is refused under a mesh."""
import dataclasses

import pytest
import torch

from repro import configs as jconfigs
from repro.runtime import engine as jengine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry
from repro_torch.runtime.engine import Engine, EngineConfig

from _torch_inputs import assert_streams_tie_equal
from _torch_ranks import run_ranks
from _torch_tp_cases import (CASES, KW, REF, _tp_cases, _tp_streams,
                             prompts, serve)

ARCH = "mamba-130m"
TIE_TOL = 1e-4


def cfgs(vocab=64):
    kw = {"vocab": vocab, "dtype": "float32"}
    return (dataclasses.replace(jconfigs.smoke_variant(
        jconfigs.get_config(ARCH)), **kw),
        dataclasses.replace(tconfigs.smoke_variant(
            tconfigs.get_config(ARCH)), **kw))


_REFS = {}


def references():
    """(port cfg, port weights, prompts, {state dtype: (port single-device
    streams, repro single-device streams)}), made once per process."""
    if not _REFS:
        jcfg, tcfg = cfgs()
        tp = registry.init_params(tcfg, seed=0)
        jp = bridge.params_to_repro(tp)
        ps = prompts()
        refs = {}
        for sd in (None, "int8"):
            single = serve(Engine(tcfg, tp, EngineConfig(
                device="cpu", state_dtype=sd, **KW)), ps)
            jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(
                state_dtype=sd, **KW))
            jr = [jeng.submit(p, max_new=REF.max_new) for p in ps]
            jeng.run()
            refs[sd] = (single, [r.tokens for r in jr])
        _REFS.update(tcfg=tcfg, tp=tp, ps=ps, refs=refs)
    return _REFS


def _held(got, single, repro_tokens, label):
    """got against the port's single-device streams under the tie rule,
    and the port's single-device streams against repro's the same way
    (the port's own engine tests hold those two equal)."""
    assert_streams_tie_equal(got, single, TIE_TOL, label)
    for g, s, j in zip(got, single, repro_tokens):
        if g.tokens != j:
            # where the sharded stream leaves repro's, the port's
            # single-device one must have left it at the same tie
            i = next(k for k, (a, b) in enumerate(zip(g.tokens, j)) if a != b)
            (_, v0), (_, v1) = s.top_logprobs[i][:2]
            assert v0 - v1 <= TIE_TOL, (label, i, v0 - v1)


def test_tp2_serving_equals_single_device(tmp_path):
    """tp=2 over every case of repro's identity test (f32 / int8 state x
    spec on / off), the prefix cache, streaming and cancel, the
    all-reduce pin and the megakernel refusal: one spawn of two ranks."""
    R = references()
    tcfg, tp, ps = R["tcfg"], R["tp"], R["ps"]
    res = run_ranks(_tp_cases, 2, tmp_path, tcfg, tp, ps)
    r0, r1 = res
    for case in CASES:
        key = (case[0], case[1] is not None)
        single, jtoks = R["refs"][case[0]]
        got = r0[key]["streams"]
        _held(got, single, jtoks, f"tp2 {key}")
        # every rank emitted the same streams (the broadcast tokens)
        assert ([s.tokens for s in got]
                == [s.tokens for s in r1[key]["streams"]])
        assert any(r0[key]["sharded"]), key
        full, dev = r0[key]["bytes"]
        assert dev < full, (key, full, dev)
        if case[0] == "int8":
            # d_inner 128 is one scale group: every step straddles
            assert r0[key]["counts"].get("straddled_step", 0) > 0, key
    n_ar = (r0["step_counts"].get("all_reduce_sum", 0)
            + r0["step_counts"].get("all_reduce_max", 0))
    assert tcfg.n_layers <= n_ar <= 16 * tcfg.n_layers, r0["step_counts"]
    # prefix cache: hits happened, each hit's stream bitwise a cold
    # cache-on admission's, the cache-off streams under the tie rule
    assert r0["prefix_hits"] >= 1
    for hit, cold in zip(r0["prefix"][1:], r0["prefix_cold"]):
        assert hit.tokens == cold.tokens
        assert hit.logprobs == cold.logprobs
    assert_streams_tie_equal(r0["prefix"], r0["prefix_off"], TIE_TOL,
                             "tp2 prefix")
    # cancel: the survivor's stream is the no-cancel serve's, delivered
    # whole; the victim stopped early on a prefix of its reference; every
    # slot and scratch lease back
    c, ref = r0["cancel"], r0["cancel_ref"]
    assert c["keeper"].tokens == ref[1].tokens
    assert c["delivered"] == c["keeper"].tokens
    assert c["victim"].cancelled and len(c["victim"].tokens) < 10
    assert ref[0].tokens[:len(c["victim"].tokens)] == c["victim"].tokens
    assert (c["n_active"], c["n_free"], c["scratch_free"]) == (0, 2, 2)
    assert r0["megakernel"] and "mesh" in r0["megakernel"]


def test_tp4_and_tp1(tmp_path):
    """tp=4 streams (f32, int8 state) under the tie rule against both
    single-device references; tp=1 bitwise the no-mesh engine: its
    streams, its prefill logits and one decode step's."""
    R = references()
    tcfg, tp, ps = R["tcfg"], R["tp"], R["ps"]
    r4 = run_ranks(_tp_streams, 4, tmp_path, tcfg, tp, ps)[0]
    for sd in (None, "int8"):
        single, jtoks = R["refs"][sd]
        _held(r4[sd], single, jtoks, f"tp4 {sd}")
    r1 = run_ranks(_tp_streams, 1, tmp_path, tcfg, tp, ps)[0]
    for sd in (None, "int8"):
        single, _ = R["refs"][sd]
        assert [s.tokens for s in r1[sd]] == [s.tokens for s in single]
        assert ([s.logprobs for s in r1[sd]]
                == [s.logprobs for s in single])
    eng = Engine(tcfg, tp, EngineConfig(device="cpu", **KW))
    lg, _ = registry.prefill(tcfg, eng.params, eng.pool.fresh,
                             {"tokens": torch.as_tensor(ps[0][None])})
    assert torch.equal(r1["prefill_logits"], lg)
    toks = torch.arange(eng.pool.n_total)[:, None] + 1
    lg, _ = registry.decode_step(tcfg, eng.params, eng.pool.cache,
                                 {"tokens": toks})
    assert torch.equal(r1["step_logits"], lg)
    # tp=4 prefill logits against the single-device ones at f32 rounding
    lg4 = r4["prefill_logits"]
    lg1, _ = registry.prefill(tcfg, eng.params, eng.pool.fresh,
                              {"tokens": torch.as_tensor(ps[0][None])})
    torch.testing.assert_close(lg4, lg1, rtol=1e-4, atol=1e-4)


def test_mesh_error_paths():
    """make_serving_mesh: tp < 1 raises ValueError; with no process group,
    or one of another size, a RuntimeError naming the counts."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    with pytest.raises(ValueError):
        make_serving_mesh(0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError) as ei:
        make_serving_mesh(3)
    assert "3" in str(ei.value) and "0" in str(ei.value)
