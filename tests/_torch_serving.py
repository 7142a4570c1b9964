"""Shared set-up of the port's serving-front tests (prefix cache,
best-of-n, sessions, disaggregation, scheduler, front-end): repro's and
the port's smoke configs (vocab 64, f32, expert capacity = expert count,
as repro's serving tests set it), the port's seeded weights with repro's
bridged copy as numpy, made once per process, and the prompts."""
import dataclasses

import numpy as np

from repro import configs as jconfigs
from repro.runtime import engine as jengine
from repro.runtime import prefix_cache as jprefix
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.prefix_cache import PrefixCacheConfig
from repro_torch.runtime.sampling import SamplingParams

from _torch_inputs import assert_streams_tie_equal

CPU = "cpu"
ARCHS = ["mamba-130m", "jamba-v0.1-52b", "xlstm-350m"]
#: the tie rule's tolerance on the reference's top-two logit gap
TIE_TOL = 1e-4
#: greedy, with the top two logprobs the tie rule reads
REF = SamplingParams(max_new=6, logprobs=True, top_logprobs=2)


def cfgs(arch, **kw):
    kw = {"vocab": 64, "dtype": "float32", **kw}
    j = jconfigs.get_config(arch)
    kw.setdefault("capacity_factor", float(max(j.n_experts, 1)))
    return (dataclasses.replace(jconfigs.smoke_variant(j), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(arch)), **kw))


_MODELS = {}


def model(arch, vocab=64):
    """(repro cfg, port cfg, repro's weights as numpy, the port's), the
    port's made from seed 0 and bridged to repro's layout (the port's
    initializer is a copy of repro's and costs no compile)."""
    if (arch, vocab) not in _MODELS:
        jcfg, tcfg = cfgs(arch, vocab=vocab)
        tp = tregistry.init_params(tcfg, seed=0)
        _MODELS[arch, vocab] = (jcfg, tcfg, bridge.params_to_repro(tp), tp)
    return _MODELS[arch, vocab]


def shared_prefix_prompts(vocab, n=4, prefix_len=16, suffix_len=5, seed=0):
    """n prompts sharing one system-prompt-style prefix (repro's)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(
        1, vocab, size=suffix_len).astype(np.int32)]) for _ in range(n)]


def engine(tcfg, tp, **kw):
    return Engine(tcfg, tp, EngineConfig(device=CPU, **kw))


def serve(eng, prompts, params=REF):
    reqs = [eng.submit(p, params) for p in prompts]
    eng.run()
    return reqs


def cached_admission_equal_repros(arch, state_dtype, kv_cache_dtype=None):
    """Three prompts sharing a 16-token prefix through a cache-enabled
    engine (block 16: one miss, two hits): the port's greedy streams and
    prefix counters are repro's; each hit is bitwise a cold admission of
    its prompt in the port; in f32 (state and KV) the cache-off engine's
    streams agree under the tie rule."""
    jcfg, tcfg, jp, tp = model(arch)
    prompts = shared_prefix_prompts(tcfg.vocab, n=3)
    kw = dict(n_slots=2, max_seq=64, state_dtype=state_dtype,
              kv_cache_dtype=kv_cache_dtype)
    pcc = dict(block=16, max_entries=16)
    jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(
        **kw, prefix_cache=jprefix.PrefixCacheConfig(**pcc)))
    want = [jeng.submit(p, max_new=6) for p in prompts]
    jeng.run()
    eng = engine(tcfg, tp, **kw, prefix_cache=PrefixCacheConfig(**pcc))
    got = serve(eng, prompts)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    js, ts = jeng.stats.summary(), eng.stats.summary()
    for key in ("prefix_hits", "prefix_hit_rate", "prefix_cached_tokens",
                "prefill_tokens", "prefix_inserts", "prefix_bytes"):
        assert ts[key] == js[key], key
    # 21-token prompts: the miss computes all 21, each hit its 5
    assert (ts["prefix_hits"], ts["prefix_cached_tokens"],
            ts["prefill_tokens"]) == (2, 32, 21 + 2 * 5)
    for p, r in zip(prompts[1:], got[1:]):
        cold = engine(tcfg, tp, **kw, prefix_cache=PrefixCacheConfig(**pcc))
        c = serve(cold, [p])[0]
        assert cold.stats.prefix_hits == 0
        assert c.tokens == r.tokens and c.logprobs == r.logprobs
    if state_dtype is None and kv_cache_dtype is None:
        # a quantized state is quantized at other points by the chunked
        # prefill than by one full prefill (repro holds cache on against
        # off for f32 only, too)
        ref = serve(engine(tcfg, tp, **kw), prompts)
        assert_streams_tie_equal(got, ref, TIE_TOL, arch)
