"""Best-of-n and tagged forks in the port on the CPU (repro's
``test_prefix_cache.py`` best-of-n cases, case for case).

- A fork without tags copies the seed verbatim (the speculative draft's
  contract); a tagged fork gives branch b > 0 ``branch_seed(seed, b)``,
  whose draws never reuse the request's own streams (``_mix(seed,
  step)``) or the speculative pass's (``fold_tag``, tags 1-3).
- Sampled branches are distinct and ranked, branch 0 is bitwise the
  request served at n = 1, and the group runs one prefill.
- Greedy branches are identical, and the parent's stream is repro's on
  the same (bridged) weights.
- n against n_slots and stream callbacks, the head-of-line block, the
  cancel cascade, and best-of-n over a cached prefix.
"""
import dataclasses

import pytest

from repro.runtime import engine as jengine
from repro.runtime import sampling as jsampling
from repro_torch.kernels import ref
from repro_torch.runtime import sampling
from repro_torch.runtime.prefix_cache import PrefixCacheConfig
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.state_pool import SlotStatePool

from _torch_serving import engine, model, shared_prefix_prompts


def _mamba():
    return model("mamba-130m")


def test_fork_untagged_copies_seed_verbatim():
    _, tcfg, _, _ = _mamba()
    pool = SlotStatePool(tcfg, n_slots=2, max_seq=16, n_scratch=2)
    s = pool.alloc()
    pool.params.set(s, SamplingParams(temperature=0.9, seed=123), 123)
    sc = pool.lease_scratch()
    pool.fork([s], [sc])
    assert pool.params.seed[sc] == pool.params.seed[s] == 123
    assert pool.params.temperature[sc] == pool.params.temperature[s]
    pool.release_scratch(sc)


def test_fork_branch_tags_rederive_seeds_per_branch():
    _, tcfg, _, _ = _mamba()
    pool = SlotStatePool(tcfg, n_slots=4, max_seq=16)
    s = pool.alloc()
    d0, d1, d2 = pool.alloc(), pool.alloc(), pool.alloc()
    pool.params.set(s, SamplingParams(temperature=0.9, seed=5), 5)
    pool.fork([s, s, s], [d0, d1, d2], branch_tags=[0, 1, 2])
    seed = pool.params.seed
    assert seed[d0] == seed[s] == 5                 # tag 0: verbatim
    assert seed[d1] == sampling.branch_seed(5, 1)   # of the source seed
    assert seed[d2] == sampling.branch_seed(5, 2)
    assert len({int(seed[s]), int(seed[d1]), int(seed[d2])}) == 3
    assert all(pool.params.temperature[d] == pool.params.temperature[s]
               for d in (d0, d1, d2))
    with pytest.raises(ValueError):
        pool.fork([s], [d1], branch_tags=[1, 2])


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_branch_seeds_never_meet_the_requests_streams(seed):
    """A branch's generator seeds differ from every position seed of its
    request, from the speculative pass's tagged seeds and from each
    other branch's, over the first 2048 positions."""
    steps = range(2048)
    own = {sampling._mix(seed, t) for t in steps}
    own |= {sampling.fold_tag(seed, t, tag) for t in steps
            for tag in (1, 2, 3)}
    seen = set(own)
    for b in range(1, 9):
        bs = sampling.branch_seed(seed, b)
        assert bs != seed and bs not in own
        draws = {sampling._mix(bs, t) for t in steps}
        assert not draws & seen
        seen |= draws


def test_bestofn_sampled_branches_distinct_ranked_and_branch0_bitwise():
    _, tcfg, _, tp = _mamba()
    prompt = shared_prefix_prompts(tcfg.vocab, n=1)[0]
    sp = SamplingParams(temperature=0.9, seed=7, n=3, max_new=6)
    eng = engine(tcfg, tp, n_slots=4, max_seq=64)
    ref.CALLS.clear()
    parent = eng.submit(prompt, params=sp)
    eng.run()
    # one prefill for the group: the scan ran once a layer
    assert ref.CALLS["selective_scan"] == tcfg.n_layers
    assert parent.finished and len(parent.branches) == 3
    assert len({tuple(c.tokens) for c in parent.branches}) == 3
    cums = [c.cum_logprob for c in parent.branches]
    assert cums == sorted(cums, reverse=True)
    assert parent.tokens == parent.branches[0].tokens
    assert parent.cum_logprob == parent.branches[0].cum_logprob
    solo_eng = engine(tcfg, tp, n_slots=4, max_seq=64)
    solo = solo_eng.submit(prompt, params=dataclasses.replace(sp, n=1))
    solo_eng.run()
    b0 = next(c for c in parent.branches if c.branch == 0)
    assert b0.tokens == solo.tokens and b0.logprobs == solo.logprobs
    assert eng.stats.n_requests == 1
    assert eng.pool.n_free == 4 and eng._by_id == {}


def test_bestofn_greedy_branches_identical_and_equal_repros():
    """Greedy reads no seed: the branches are one stream, that of the
    request at n = 1, and the parent's stream is repro's."""
    jcfg, tcfg, jp, tp = _mamba()
    prompt = shared_prefix_prompts(tcfg.vocab, n=1)[0]
    sp = SamplingParams(n=3, max_new=5)
    eng = engine(tcfg, tp, n_slots=3, max_seq=64)
    parent = eng.submit(prompt, params=sp)
    eng.run()
    streams = {tuple(c.tokens) for c in parent.branches}
    assert len(streams) == 1
    solo_eng = engine(tcfg, tp, n_slots=3, max_seq=64)
    solo = solo_eng.submit(prompt, params=SamplingParams(max_new=5))
    solo_eng.run()
    assert parent.tokens == solo.tokens
    jeng = jengine.Engine(jcfg, jp, jengine.EngineConfig(n_slots=3,
                                                         max_seq=64))
    jparent = jeng.submit(prompt, params=jsampling.SamplingParams(
        n=3, max_new=5))
    jeng.run()
    assert parent.tokens == jparent.tokens
    assert [c.branch for c in parent.branches] == \
        [c.branch for c in jparent.branches]


def test_bestofn_needs_n_slots_and_blocks_head_of_line():
    _, tcfg, _, tp = _mamba()
    prompt = shared_prefix_prompts(tcfg.vocab, n=1)[0]
    eng = engine(tcfg, tp, n_slots=2, max_seq=64)
    with pytest.raises(ValueError):
        eng.submit(prompt, params=SamplingParams(n=3))
    with pytest.raises(ValueError):
        eng.submit(prompt, params=SamplingParams(n=2),
                   stream_cb=lambda r, t: None)
    r1 = eng.submit(prompt, max_new=8)
    r2 = eng.submit(prompt, params=SamplingParams(n=2, max_new=4,
                                                  temperature=0.5, seed=3))
    r3 = eng.submit(prompt, max_new=2)
    done = eng.run()
    assert r1.finished and r2.finished and r3.finished
    assert len(r2.branches) == 2
    # r3 did not pass the group while only one slot was free
    assert r2.t_admit <= r3.t_admit
    assert [r.req_id for r in done].index(r2.req_id) < \
        [r.req_id for r in done].index(r3.req_id)
    assert eng.pool.n_free == 2


def test_cancel_mid_fork_reclaims_every_branch_no_leak():
    _, tcfg, _, tp = _mamba()
    prompts = shared_prefix_prompts(tcfg.vocab, n=2)
    ref_eng = engine(tcfg, tp, n_slots=4, max_seq=64)
    want = ref_eng.submit(prompts[1], max_new=8)
    ref_eng.run()
    eng = engine(tcfg, tp, n_slots=4, max_seq=64, sched_quantum=2)
    parent = eng.submit(prompts[0], params=SamplingParams(
        temperature=0.8, seed=9, n=3, max_new=16))
    bystander = eng.submit(prompts[1], max_new=8,
                           stream_cb=lambda r, t: None)
    eng.step()
    eng.step()
    assert eng.pool.n_active == 4
    assert eng.cancel(parent.req_id)
    eng.run()
    assert parent.finished and parent.cancelled
    assert all(c.finished for c in parent.branches)
    assert eng.pool.n_free == 4 and eng._by_id == {}
    assert eng.stats.n_cancelled == 1 and eng.stats.n_requests == 1
    assert bystander.tokens == want.tokens
    assert float(eng.pool.params.temperature.max()) == 0.0
    assert int(eng.pool.params.seed.max()) == 0


def test_bestofn_over_cached_prefix():
    """The n-way fork rides a cache-restored admission: the branches
    still differ and branch 0 is still the request served at n = 1 by a
    cache-enabled engine."""
    _, tcfg, _, tp = _mamba()
    prompts = shared_prefix_prompts(tcfg.vocab, n=2)
    sp = SamplingParams(temperature=0.9, seed=11, n=3, max_new=5)
    kw = dict(n_slots=3, max_seq=64, prefix_cache=PrefixCacheConfig(block=8))
    eng = engine(tcfg, tp, **kw)
    eng.submit(prompts[0], max_new=4)
    eng.run()
    parent = eng.submit(prompts[1], params=sp)
    eng.run()
    assert eng.stats.prefix_hits == 1
    assert len({tuple(c.tokens) for c in parent.branches}) == 3
    solo_eng = engine(tcfg, tp, **kw)
    solo = solo_eng.submit(prompts[1], params=dataclasses.replace(sp, n=1))
    solo_eng.run()
    b0 = next(c for c in parent.branches if c.branch == 0)
    assert b0.tokens == solo.tokens
