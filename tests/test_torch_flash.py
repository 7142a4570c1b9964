"""The flash attention kernel (K7) of the port on the CPU.

On a CPU tensor K7's wrapper (``kernels.flash_attention``) and
``ops.attention`` run the plain version ``kernels.ref.attention``.  Held
here against ``repro``'s Pallas flash kernel (interpret mode) and its
oracle ``repro.kernels.ref.attention`` on the same seeded numpy inputs,
at ``repro``'s tolerances (tests/test_kernels.py: 2e-5 for the f32
kernel against the oracle, 1e-4 in its property test): GQA (hkv < hq),
lengths that are no multiple of a tile, and queries that are the suffix
of the sequence (lq < lk).  K7 itself is held against the plain version
on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, ops, ref

jax.config.update("jax_platform_name", "cpu")


def _qkv(seed, b, lq, lk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, lq, hq, dh)).astype(np.float32),
            rng.normal(size=(b, lk, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, lk, hkv, dh)).astype(np.float32))


SHAPES = [  # b, lq, lk, hq, hkv, dh
    (1, 64, 64, 4, 4, 32),
    (2, 128, 128, 8, 2, 64),
    (1, 96, 96, 8, 1, 128),
    (1, 37, 37, 4, 2, 16),      # ragged, the smoke width's head dim
    (2, 100, 100, 4, 1, 16),
    (2, 17, 100, 8, 2, 64),     # suffix: lq < lk
    (1, 1, 45, 4, 2, 16),       # one query over a cache
]


@pytest.mark.parametrize("b,lq,lk,hq,hkv,dh", SHAPES,
                         ids=[f"b{s[0]}_q{s[1]}_k{s[2]}_h{s[3]}x{s[4]}_d{s[5]}"
                              for s in SHAPES])
def test_plain_attention_matches_repros_flash_and_oracle(b, lq, lk, hq, hkv,
                                                         dh):
    q, k, v = _qkv(lq * 7 + dh, b, lq, lk, hq, hkv, dh)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_oracle = np.asarray(jref.attention(jq, jk, jv, causal=True))
    want_flash = np.asarray(jflash.flash_attention(
        jq, jk, jv, causal=True, block_q=32, block_k=32, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref.CALLS.clear()
    got = flash_attention.flash_attention(tq, tk, tv, causal=True)
    assert dict(ref.CALLS) == {"attention": 1}
    assert flash_attention.launches == 0
    np.testing.assert_allclose(got.numpy(), want_oracle, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_flash, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("impl", ["chunked", "ref", "pallas"])
def test_ops_attention_runs_the_plain_version_under_every_impl(impl):
    q, k, v = _qkv(5, 1, 20, 20, 4, 2, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = np.asarray(jref.attention(*map(jnp.asarray, (q, k, v)),
                                     causal=True))
    ref.CALLS.clear()
    got = ops.attention(tq, tk, tv, causal=True, impl=impl)
    assert dict(ref.CALLS) == {"attention": 1}
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_non_causal_and_bf16_plain_attention():
    q, k, v = _qkv(9, 2, 24, 24, 4, 2, 32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.attention(jq, jk, jv, causal=False)),
        rtol=2e-5, atol=2e-5)
    bf = [t.to(torch.bfloat16) for t in (tq, tk, tv)]
    got = flash_attention.flash_attention(*bf, causal=True)
    want = jref.attention(*(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) for t in bf), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_wrapper_refuses_what_k7_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 8, 8, 4, 2, 16))
    bad = {
        "heads": (q, k[:, :, :1].repeat(1, 1, 3, 1).contiguous(),
                  v[:, :, :1].repeat(1, 1, 3, 1).contiguous()),
        "dtype": (q, k.double(), v.double()),
        "strided": (q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
        "longer queries": (torch.cat([q, q], 1), k, v),
        "f64": (q.double(), k.double(), v.double()),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            flash_attention.flash_attention(*args, causal=True)
    with pytest.raises(KeyError):
        ops.attention(q, k, v, impl="nope")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ops_attention_refuses_names_no_config_carries(impl):
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 8, 8, 4, 2, 16))
    with pytest.raises(KeyError, match=impl):
        ops.attention(q, k, v, causal=True, impl=impl)
