"""The transformer family in the port (``repro_torch.models.transformer``,
``blocks.chunked_causal_attention``) against ``repro``'s, on the CPU.

The same weights (``repro``'s, bridged as numpy, their norm and QKV
biases moved off their init values) and the same seeded inputs go
through both packages in f32.  Held here, at ``repro``'s tolerances:

  1. ``_grouped_scores`` and ``chunked_causal_attention`` against
     ``repro``'s and against the plain K7 (``ref.attention``) at 1e-5:
     chunks smaller than lq, ``q_offset`` (suffix queries), groups 1, 3
     and 4;
  2. ``forward`` of all 8 transformer archs at smoke size at 1e-4
     (musicgen's 4 heads on ``embeds``, phi-3-vision's image prefix,
     olmo's non-parametric LN with tied embeddings, arctic's dense
     residual, qwen2-moe's shared and padded experts), and the aux
     losses;
  3. ``prefill`` + 8 ``decode_step``s for granite (MQA), qwen2-7b (GQA +
     bias) and qwen2-moe, with an f32 and an int8 KV cache: logits at
     1e-4, the f32 cache at 1e-4, int8 codes within one and scales to
     f32 rounding;
  4. a bridge round trip, the registry's dispatch (no K3 for this
     family) and ``count_params`` at full size for all 8 archs.
The engines are held in tests/test_torch_transformer_engine.py, K7 at
the transformer head layouts on the card in tests/test_torch_cuda.py
and chip_smoke.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels import ref
from repro_torch.models import blocks, transformer
from repro_torch.models import registry as tregistry

from _torch_inputs import code_ordinals
from _torch_transformer import (ARCHS, batch, cfgs, close, repro_weights,
                                to_jax, to_torch)

jax.config.update("jax_platform_name", "cpu")


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. Chunked causal attention
# ---------------------------------------------------------------------------

def test_grouped_scores_match_repro():
    q, k = _normal(1, 2, 5, 2, 3, 16), _normal(2, 2, 9, 2, 16)
    want = jblocks._grouped_scores(jnp.asarray(q), jnp.asarray(k), 0.25)
    got = blocks._grouped_scores(torch.from_numpy(q), torch.from_numpy(k),
                                 0.25)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 3, 5, 9)
    close(got, want, 1e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (4, 1)])
@pytest.mark.parametrize("lq,lk,chunk", [(13, 13, 4), (7, 19, 3),
                                         (16, 16, 16)])
def test_chunked_causal_attention_matches_repro_and_plain(hq, hkv, lq, lk,
                                                          chunk):
    """Groups 1, 3 and 4 (hq / hkv); chunks smaller than lq (a ragged
    last one) and one chunk; lq < lk as suffix queries (q_offset = lk -
    lq), the layout ``ref.attention`` takes."""
    q = _normal(3, 2, lq, hq, 16)
    k, v = _normal(4, 2, lk, hkv, 16), _normal(5, 2, lk, hkv, 16)
    off = lk - lq
    want = jblocks.chunked_causal_attention(
        *map(jnp.asarray, (q, k, v)), chunk=chunk, q_offset=off)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = blocks.chunked_causal_attention(tq, tk, tv, chunk=chunk,
                                          q_offset=off)
    assert got.shape == (2, lq, hq, 16) and got.dtype == torch.float32
    close(got, want, 1e-5)
    close(got, ref.attention(tq, tk, tv, causal=True), 1e-5)


# ---------------------------------------------------------------------------
# 2. forward, every transformer arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_repro(arch):
    jcfg, tcfg = cfgs(arch)
    w = repro_weights(arch)
    b = batch(jcfg, 2, 11, seed=3)
    jl, jaux = jregistry.forward(jcfg, w, to_jax(b))
    tl, taux = tregistry.forward(tcfg, bridge.params_from_repro(w),
                                 to_torch(b))
    l = 11 + tcfg.img_tokens
    shape = ((2, l, tcfg.n_codebooks, 64) if tcfg.n_codebooks > 1
             else (2, l, 64))
    assert tuple(tl.shape) == shape == tuple(jl.shape)
    close(tl, jl)
    for key in ("moe_lb", "moe_z"):
        close(taux[key], jaux[key], 1e-5, key)


# ---------------------------------------------------------------------------
# 3. prefill + decode steps, f32 and int8 KV
# ---------------------------------------------------------------------------

def _assert_cache_close(tc, jc, kv):
    assert set(tc) == set(jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        if kv == "int8":
            assert tc[key].dtype == torch.int8
            apart = int((code_ordinals(tc[key]) - torch.from_numpy(
                np.asarray(jc[key]).astype(np.int32))).abs().max())
            assert apart <= 1, f"{key}: codes {apart} apart"
            np.testing.assert_allclose(tc[key + "_scale"].numpy(),
                                       np.asarray(jc[key + "_scale"]),
                                       rtol=1e-5, atol=0)
        else:
            close(tc[key], jc[key], msg=key)


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("arch", ["granite-20b", "qwen2-7b",
                                  "qwen2-moe-a2.7b"])
def test_prefill_and_decode_match_repro(arch, kv):
    """Prefill 9 tokens into a max_seq-20 cache, then 8 teacher-forced
    decode steps at 2 slots; logits and every cache leaf each step."""
    jcfg, tcfg = cfgs(arch, kv_cache_dtype=kv)
    w = repro_weights(arch)
    tp = bridge.params_from_repro(w)
    toks = batch(jcfg, 2, 17, seed=5)["tokens"]
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 20))
    tcache = tregistry.init_cache(tcfg, 2, 20)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tcache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    jl, jcache = jregistry.prefill(jcfg, w, jcache,
                                   {"tokens": jnp.asarray(toks[:, :9])})
    tl, tcache = tregistry.prefill(tcfg, tp, tcache,
                                   {"tokens": torch.from_numpy(toks[:, :9])})
    close(tl, jl, msg="prefill logits")
    _assert_cache_close(tcache, jcache, kv)
    # one compile for the 8 steps (an eager call traces its layer scan)
    jstep = jax.jit(functools.partial(jregistry.decode_step, jcfg))
    for s in range(9, 17):
        step = toks[:, s:s + 1]
        jl, jcache = jstep(w, jcache, {"tokens": jnp.asarray(step)})
        tl, tcache = tregistry.decode_step(
            tcfg, tp, tcache, {"tokens": torch.from_numpy(step)})
        close(tl, jl, msg=f"decode logits at {s}")
        _assert_cache_close(tcache, jcache, kv)


def test_verify_scan_chains_decode_steps_as_repros():
    """The speculative verify over K=3 tokens for a family without a
    batched window: decode_step chained per token, the second slot
    frozen (``active``); logits and every step's cache as repro's."""
    arch = "qwen2-7b"
    jcfg, tcfg = cfgs(arch)
    w = repro_weights(arch)
    tp = bridge.params_from_repro(w)
    toks = batch(jcfg, 2, 9, seed=7)["tokens"]
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 12))
    _, jcache = jregistry.prefill(jcfg, w, jcache,
                                  {"tokens": jnp.asarray(toks[:, :6])})
    _, tcache = tregistry.prefill(tcfg, tp, tregistry.init_cache(tcfg, 2, 12),
                                  {"tokens": torch.from_numpy(toks[:, :6])})
    active = np.array([True, False])
    # device arrays: repro's scan indexes the embedding with a tracer
    jl, jc = jregistry.verify_scan(jcfg, jax.tree.map(jnp.asarray, w),
                                   jcache, jnp.asarray(toks[:, 6:]),
                                   jnp.asarray(active))
    tl, tc = tregistry.verify_scan(tcfg, tp, tcache,
                                   torch.from_numpy(toks[:, 6:]),
                                   torch.from_numpy(active))
    assert tuple(tl.shape) == (2, 3, 64)
    close(tl, jl)
    for key in ("k", "v"):
        close(tc[key], jc[key], msg=key)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"][:, 1].tolist() == [6, 6, 6]


def test_decode_step_of_the_audio_stub_matches_repro():
    """musicgen: prefill on embeds, a decode step on one frame's
    embedding, 4 codebook heads each."""
    arch = "musicgen-large"
    jcfg, tcfg = cfgs(arch)
    w = repro_weights(arch)
    tp = bridge.params_from_repro(w)
    b = batch(jcfg, 2, 7, seed=6)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 12))
    jl, jcache = jregistry.prefill(jcfg, w, jcache, to_jax(b))
    tl, tcache = tregistry.prefill(tcfg, tp, tregistry.init_cache(
        tcfg, 2, 12), to_torch(b))
    close(tl, jl)
    e = {"embeds": _normal(8, 2, 1, tcfg.d_model)}
    jl, _ = jregistry.decode_step(jcfg, w, jcache, to_jax(e))
    tl, _ = tregistry.decode_step(tcfg, tp, tcache, to_torch(e))
    assert tuple(tl.shape) == (2, 1, 4, 64)
    close(tl, jl)


# ---------------------------------------------------------------------------
# 4. Bridge, dispatch, parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "musicgen-large",
                                  "qwen2-moe-a2.7b", "arctic-480b"])
def test_bridge_round_trip(arch):
    """repro -> port -> repro is leaf for leaf the same tree (tied
    embeddings, empty LN dicts, codebook heads, padded and shared
    experts, the dense residual), and the port's own init has repro's
    structure and shapes."""
    jcfg, tcfg = cfgs(arch)
    w = repro_weights(arch)
    tp = bridge.params_from_repro(w)
    assert len(tp["layers"]) == tcfg.n_layers
    back = bridge.params_to_repro(tp)
    assert jax.tree.structure(back) == jax.tree.structure(w)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(w)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = bridge.params_to_repro(tregistry.init_params(tcfg, seed=0))
    assert jax.tree.structure(own) == jax.tree.structure(w)
    assert [a.shape for a in jax.tree.leaves(own)] == [
        a.shape for a in jax.tree.leaves(w)]


def test_registry_serves_the_family_without_k3():
    _, tcfg = cfgs("qwen2-7b")
    assert tregistry.family(tcfg) is transformer
    assert not tregistry.supports_draft(tcfg)
    for dev in ("cpu", "cuda"):
        assert not tregistry.uses_megakernel(tcfg, dev)
        with pytest.raises(NotImplementedError, match="megakernel"):
            tregistry.uses_megakernel(
                dataclasses.replace(tcfg, step_impl="megakernel"), dev)
    p = tregistry.init_params(tcfg, seed=0)
    cache = tregistry.init_cache(tcfg, 1, 8)
    with pytest.raises(NotImplementedError, match="megakernel"):
        tregistry.decode_step(
            dataclasses.replace(tcfg, step_impl="megakernel"), p, cache,
            {"tokens": torch.zeros(1, 1, dtype=torch.int64)})


@pytest.mark.parametrize("active_only", [False, True])
def test_count_params_full_size_matches_repro(active_only):
    for arch in ARCHS:
        n = tregistry.count_params(tconfigs.get_config(arch), active_only)
        assert n == jregistry.count_params(jconfigs.get_config(arch),
                                           active_only), arch
    # qwen2-7b as published: about 7.6 B
    assert 7.5e9 < tregistry.count_params(
        tconfigs.get_config("qwen2-7b")) < 7.7e9
