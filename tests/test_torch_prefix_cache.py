"""The port's prompt-prefix state cache on the CPU, against repro's.

- ``PrefixCache`` unit behaviour, each case run on both packages' class.
- Cached admission for mamba with an f32 and an int8 state
  (``_torch_serving.cached_admission_equal_repros``; jamba's and
  xLSTM's in ``test_torch_prefix_jamba.py``, ``test_torch_prefix_xlstm.py``).
- The suffix chain on K3's view of the prefill master
  (``step_impl="megakernel"``), an int8-weight engine's included; every
  stored snapshot in the pool's layout.
- LRU churn: every stored snapshot stays bitwise what was stored while
  later admissions and evictions write the pool.
- The host store, speculative decoding over a cached prefix, and
  serve_throughput's shared-system-prompt trace with its counts.
"""
import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import metrics as jmetrics
from repro.runtime import prefix_cache as jprefix
from repro_torch.models import registry as tregistry
from repro_torch.runtime import metrics as tmetrics
from repro_torch.runtime import prefix_cache as tprefix
from repro_torch.runtime.prefix_cache import PrefixCacheConfig
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_decode import DraftConfig

from _torch_inputs import assert_streams_tie_equal, tree_equal
from _torch_serving import (ARCHS, REF, TIE_TOL,
                            cached_admission_equal_repros, engine, model,
                            serve, shared_prefix_prompts)

# ---------------------------------------------------------------------------
# PrefixCache unit behaviour, on repro's class and on the port's
# ---------------------------------------------------------------------------

class _Pkg:
    """One package's PrefixCache, a leaf maker and the residency checks:
    repro holds a host entry as numpy and restores jnp arrays; the port
    holds a host entry on the CPU and restores to the cache's device."""

    def __init__(self, name):
        self.name = name
        self.mod = jprefix if name == "repro" else tprefix

    def cache(self, **kw):
        return self.mod.PrefixCache(self.mod.PrefixCacheConfig(**kw))

    def config(self, **kw):
        return self.mod.PrefixCacheConfig(**kw)

    def leaf(self, shape, value):
        if self.name == "repro":
            return {"x": jnp.full(shape, value, jnp.float32)}
        return {"x": torch.full(shape, float(value))}

    def on_host(self, snap):
        x = snap["x"]
        if self.name == "repro":
            return isinstance(x, np.ndarray)
        return isinstance(x, torch.Tensor) and x.device.type == "cpu"

    def restored(self, snap):
        x = snap["x"]
        if self.name == "repro":
            return isinstance(x, jnp.ndarray)
        return isinstance(x, torch.Tensor)

    def value(self, snap):
        return np.asarray(snap["x"]).reshape(-1)[0]


PKGS = ["repro", "port"]


@pytest.mark.parametrize("pkg", PKGS)
def test_boundary_is_largest_block_multiple_strictly_below_length(pkg):
    pc = _Pkg(pkg).cache(block=8)
    assert [pc.boundary(n) for n in (5, 8, 9, 16, 17, 24)] == \
        [0, 0, 8, 8, 16, 16]


@pytest.mark.parametrize("pkg", PKGS)
def test_lookup_walks_down_to_deepest_cached_boundary(pkg):
    k = _Pkg(pkg)
    pc = k.cache(block=4, max_entries=8)
    toks = np.arange(1, 20, dtype=np.int32)
    pc.insert(toks[:4], k.leaf((1, 4), 0))
    pc.insert(toks[:8], k.leaf((1, 4), 1))
    n, snap = pc.lookup(toks[:11])
    assert n == 8 and k.value(snap) == 1
    other = np.concatenate([toks[:4], toks[:4] + 30])
    n, snap = pc.lookup(np.concatenate([other, toks[:3]]))
    assert n == 4 and k.value(snap) == 0
    assert pc.hits == 2 and pc.misses == 0
    assert pc.lookup(toks[:3]) is None and pc.misses == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_lru_bounds_entries_and_bytes(pkg):
    k = _Pkg(pkg)
    pc = k.cache(block=2, max_entries=3)
    for i in range(6):
        pc.insert(np.arange(i, i + 2, dtype=np.int32), k.leaf((1, 2), i))
    assert len(pc) == 3 and pc.evictions == 3
    pc2 = k.cache(block=2, max_entries=100, max_bytes=16)
    for i in range(5):
        pc2.insert(np.arange(i, i + 2, dtype=np.int32), k.leaf((1, 2), i))
    assert pc2.n_bytes <= 16 and len(pc2) == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_host_store_defers_offload_until_flush(pkg):
    k = _Pkg(pkg)
    pc = k.cache(block=2, store="host")
    pc.insert(np.arange(2, dtype=np.int32), k.leaf((1, 2), 0))
    assert pc.has_pending()
    assert pc.flush_pending(limit=None) == 1
    assert not pc.has_pending()
    ent = next(iter(pc._entries.values()))
    assert ent.on_host and k.on_host(ent.snap)
    _, snap = pc.lookup(np.arange(3, dtype=np.int32))
    assert k.restored(snap)


@pytest.mark.parametrize("pkg", PKGS)
def test_flush_pending_dead_keys_do_not_consume_limit(pkg):
    k = _Pkg(pkg)
    pc = k.cache(block=2, store="host")
    pc.insert(np.arange(2, dtype=np.int32), k.leaf((1, 2), 0))
    pc._pending.appendleft(b"dead-1")
    pc._pending.appendleft(b"dead-0")
    assert pc.flush_pending(limit=1) == 1
    assert next(iter(pc._entries.values())).on_host
    assert not pc.has_pending()
    assert isinstance(pc._pending, collections.deque)


@pytest.mark.parametrize("pkg", PKGS)
def test_oversized_insert_refused_without_thrashing_cache(pkg):
    k = _Pkg(pkg)
    pc = k.cache(block=2, max_entries=100, max_bytes=16)
    for i in range(2):
        pc.insert(np.arange(i, i + 2, dtype=np.int32), k.leaf((1, 2), i))
    assert len(pc) == 2 and pc.n_bytes == 16
    pc.insert(np.arange(8, 10, dtype=np.int32), k.leaf((1, 6), 0))
    assert pc.rejects == 1 and pc.counters()["rejects"] == 1
    assert len(pc) == 2 and pc.n_bytes == 16 and pc.evictions == 0
    assert pc.lookup(np.arange(0, 3, dtype=np.int32)) is not None


@pytest.mark.parametrize("pkg", PKGS)
def test_config_validation(pkg):
    k = _Pkg(pkg)
    for bad in (dict(block=0), dict(max_entries=0), dict(max_bytes=0),
                dict(store="gpu")):
        with pytest.raises(ValueError):
            k.config(**bad).validate()


@pytest.mark.parametrize("stats", [jmetrics.ServeStats, tmetrics.ServeStats],
                         ids=PKGS)
def test_serve_stats_surface_prefix_rejects(stats):
    s = stats()
    s.sync_prefix({"inserts": 2, "evictions": 1, "rejects": 3, "bytes": 16})
    assert s.summary()["prefix_rejects"] == 3


def test_stored_snapshot_owns_its_memory():
    """The port's caches and pool are written in place: an entry must not
    share storage with what was handed to insert, and a host entry is a
    copy, not the stored tensor."""
    pc = tprefix.PrefixCache(PrefixCacheConfig(block=2, store="host"))
    base = torch.arange(8, dtype=torch.float32)
    snap = {"x": base[2:6].view(1, 4), "pos": torch.tensor([2])}
    pc.insert(np.arange(2, dtype=np.int32), snap)
    stored = next(iter(pc._entries.values())).snap
    base.zero_()
    snap["pos"] += 5
    assert stored["x"].tolist() == [[2.0, 3.0, 4.0, 5.0]]
    assert stored["pos"].tolist() == [2]
    assert stored["x"].untyped_storage().nbytes() == 16
    pc.flush_pending(limit=None)
    moved = next(iter(pc._entries.values())).snap
    assert moved["x"].data_ptr() != stored["x"].data_ptr()
    assert tprefix.tree_bytes(moved) == 16 + 8


# ---------------------------------------------------------------------------
# Cached admission: repro's streams and counters, hit == cold, on vs off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", [None, "int8"])
def test_cached_admission_equal_repros_mamba(state_dtype):
    cached_admission_equal_repros("mamba-130m", state_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_megakernel_chain_runs_on_the_masters_k3_view(arch):
    """With step_impl="megakernel" the suffix chain steps the prefill
    master through K3's view of it (its plain version on the CPU): an
    int8-weight engine builds that view over the f32 master (K3's
    f32-weight instance), apart from the decode tree's; the hit is
    bitwise a cold admission, and for mamba the streams are the
    per-layer engine's under the tie rule."""
    _, tcfg, _, tp = model(arch)
    prompts = shared_prefix_prompts(tcfg.vocab, n=2)
    kw = dict(n_slots=2, max_seq=64, weight_dtype="int8",
              prefix_cache=PrefixCacheConfig(block=8))
    params = dataclasses.replace(REF, max_new=4)
    eng = engine(tcfg, tp, step_impl="megakernel", **kw)
    assert "stack" in eng._chain_params and "stack" in eng.params
    assert eng._chain_params["stack"] is not eng.params["stack"]

    def runs(stack):
        return [r for g in (stack if isinstance(stack, list) else [stack])
                for r in (g if isinstance(g, list) else [g])]

    assert not any(r.int8 for r in runs(eng._chain_params["stack"]))
    assert all(r.int8 for r in runs(eng.params["stack"]))
    got = serve(eng, prompts, params)
    assert eng.stats.prefix_hits == 1
    if arch == "mamba-130m":
        ref = serve(engine(tcfg, tp, step_impl="fused", **kw), prompts,
                    params)
        assert_streams_tie_equal(got, ref, TIE_TOL, arch)
    cold = serve(engine(tcfg, tp, step_impl="megakernel", **kw),
                 prompts[1:], params)[0]
    assert cold.tokens == got[1].tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_snapshots_take_the_pools_layout(arch):
    """Every stored snapshot (the one-block prefill's and the chain's) has
    the shapes and dtypes of one pool slot, as K3 on the card requires of
    the state it steps: xLSTM's prefill hands back its conv tail in the
    model dtype (bf16 here), the pool keeps it in f32."""
    _, tcfg, _, tp = model(arch)
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    eng = engine(tcfg, tp, n_slots=1, max_seq=16,
                 prefix_cache=PrefixCacheConfig(block=4))
    serve(eng, shared_prefix_prompts(tcfg.vocab, n=2, prefix_len=8,
                                     suffix_len=3), SamplingParams(max_new=1))
    want = [(t.shape, t.dtype)
            for t in tregistry.tree_leaves(eng.pool.fresh)]
    assert eng.stats.prefix_hits == 1 and len(eng._prefix) == 2
    for ent in eng._prefix._entries.values():
        assert [(t.shape, t.dtype)
                for t in tregistry.tree_leaves(ent.snap)] == want


def test_unaligned_shared_prefix_hits_at_block_boundary():
    """Two prompts sharing 13 tokens hit at the deepest common boundary
    (12) and count what repro counts."""
    jcfg, tcfg, jp, tp = model("mamba-130m")
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 64, size=13).astype(np.int32)
    p1 = np.concatenate([shared, rng.integers(1, 64, 4).astype(np.int32)])
    p2 = np.concatenate([shared, rng.integers(1, 64, 6).astype(np.int32)])
    eng = engine(tcfg, tp, n_slots=1, max_seq=64,
                  prefix_cache=PrefixCacheConfig(block=4, max_entries=16))
    got = serve(eng, [p1, p2])
    assert eng.stats.prefix_hits == 1
    assert eng.stats.prefix_cached_tokens == 12
    ref = serve(engine(tcfg, tp, n_slots=1, max_seq=64), [p1, p2])
    assert_streams_tie_equal(got, ref, TIE_TOL, "unaligned")


@pytest.mark.parametrize("state_dtype", [None, "int8"])
def test_lru_churn_keeps_every_stored_snapshot(state_dtype):
    """A 2-entry cache cycled through 5 prefixes (each admitted twice,
    the last three times, so that its third admission hits): every
    admission's stream is its cold stream, and every snapshot the cache
    holds is, at every step and at the end, bitwise what was stored
    when it was inserted, though later admissions, decode bursts and
    evictions wrote the pool in place meanwhile."""
    _, tcfg, _, tp = model("mamba-130m")
    rng = np.random.default_rng(7)
    prefixes = [rng.integers(1, 64, size=8).astype(np.int32)
                for _ in range(5)]
    prompts = [np.concatenate([pfx, rng.integers(1, 64, 3).astype(
        np.int32)]) for pfx in prefixes * 2 + prefixes[-1:]]
    kw = dict(n_slots=2, max_seq=32, state_dtype=state_dtype)
    ref = [serve(engine(tcfg, tp, **kw,
                          prefix_cache=PrefixCacheConfig(block=8)),
                  [p], SamplingParams(max_new=4))[0] for p in prompts]
    eng = engine(tcfg, tp, **kw, prefix_cache=PrefixCacheConfig(
        block=8, max_entries=2))
    pc, stored = eng._prefix, {}
    real_insert = pc.insert

    def insert(tokens, snap):
        real_insert(tokens, snap)
        key = pc._key(tokens)
        if key in pc._entries and key not in stored:
            stored[key] = tregistry.tree_map(torch.clone,
                                             pc._entries[key].snap)

    def check():
        for key, ent in pc._entries.items():
            assert tree_equal(ent.snap, stored[key])

    pc.insert = insert
    got = [eng.submit(p, SamplingParams(max_new=4)) for p in prompts]
    while eng.step():
        check()
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert eng.stats.prefix_evictions > 0 and len(pc) <= 2
    assert eng.stats.prefix_hits > 0


def test_host_store_streams_equal_the_device_stores():
    _, tcfg, _, tp = model("mamba-130m")
    prompts = shared_prefix_prompts(tcfg.vocab)
    out = {}
    for store in ("device", "host"):
        eng = engine(tcfg, tp, n_slots=2, max_seq=64,
                      prefix_cache=PrefixCacheConfig(block=8, store=store))
        out[store] = serve(eng, prompts)
        assert eng.stats.prefix_hits > 0
        assert not eng._prefix.has_pending()
    assert all(e.on_host for e in eng._prefix._entries.values())
    assert [r.tokens for r in out["host"]] == \
        [r.tokens for r in out["device"]]
    assert [r.logprobs for r in out["host"]] == \
        [r.logprobs for r in out["device"]]


def test_spec_decode_over_cached_prefix():
    """Restore (prefix cache), fork (draft) and rollback (verify) compose:
    the spec engine's greedy streams over cached prefixes are the plain
    cache-enabled engine's under the tie rule."""
    _, tcfg, _, tp = model("mamba-130m")
    prompts = shared_prefix_prompts(tcfg.vocab)
    kw = dict(n_slots=2, max_seq=64, prefix_cache=PrefixCacheConfig(block=8))
    ref = serve(engine(tcfg, tp, **kw), prompts)
    eng = engine(tcfg, tp, **kw, draft=DraftConfig(k=3, layers=1))
    got = serve(eng, prompts)
    assert eng.stats.prefix_hits > 0 and eng.stats.spec_passes > 0
    assert_streams_tie_equal(got, ref, TIE_TOL, "spec over prefix")


def test_shared_system_prompt_trace_counts():
    """serve_throughput's prefix trace (``prefix_cache_comparison`` at
    bench_ci's arguments: mamba-130m smoke, vocab 256, 4 slots, 8
    requests, 12 new tokens, block 8, a 24-token system prompt): the
    counts of repro's recorded run (BENCH_PR10.json): 7 hits, 168 cached
    tokens, 72 prefill tokens computed on against 240 off, and 3
    distinct ranked best-of-3 branches."""
    _, tcfg, _, tp = model("mamba-130m", vocab=256)
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, tcfg.vocab, size=(24,)).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.integers(
        0, tcfg.vocab, size=(int(rng.integers(3, 9)),)).astype(np.int32)])
        for _ in range(8)]
    max_seq = 24 + 16 + 12 + 8
    params = dataclasses.replace(REF, max_new=12)
    out = {}
    for label, pcc in (("off", None),
                       ("on", PrefixCacheConfig(block=8, max_entries=32))):
        eng = engine(tcfg, tp, n_slots=4, max_seq=max_seq, prefix_cache=pcc)
        out[label] = (serve(eng, prompts, params), eng.stats.summary())
    (on, s_on), (off, s_off) = out["on"], out["off"]
    assert_streams_tie_equal(on, off, TIE_TOL, "system prompt trace")
    assert (s_on["prefix_hits"], s_on["prefix_cached_tokens"]) == (7, 168)
    assert (s_on["prefill_tokens"], s_off["prefill_tokens"]) == (72, 240)
    bo = engine(tcfg, tp, n_slots=4, max_seq=max_seq,
                 prefix_cache=PrefixCacheConfig(block=8))
    rq = bo.submit(prompts[0], SamplingParams(temperature=0.9, seed=7, n=3,
                                              max_new=12))
    bo.run()
    cums = [c.cum_logprob for c in rq.branches]
    assert len({tuple(c.tokens) for c in rq.branches}) == 3
    assert cums == sorted(cums, reverse=True)
    assert rq.tokens == rq.branches[0].tokens
