"""The port's MARCA nonlinearities (repro_torch.core.approx) against
repro.core.approx on the same seeded inputs, passed as numpy arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro_torch.core import approx as tapprox

jax.config.update("jax_platform_name", "cpu")


def _inputs(seed, shape=(4, 257), scale=4.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _both(fn_name, x, dtype="float32"):
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(getattr(japprox, fn_name)(jx), np.float32)
    got = getattr(tapprox, fn_name)(tx).float().numpy()
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn_name", ["fast_exp", "our_exp"])
def test_fast_exp_matches_repro(fn_name, dtype):
    """The dt*A range (mostly [-7, 0)) plus wide values and the clamp."""
    x = np.concatenate([_inputs(1, (1000,), 3.0, -2.0),
                        np.array([-1e9, -100.0, -80.0, 0.0, 80.0, 100.0],
                                 np.float32)])
    got, want = _both(fn_name, x, dtype)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-30)


def test_fast_exp_truncates_toward_zero():
    """float -> int32 truncates as astype(int32) does: negative products
    round up, so the bit pattern is repro's exactly in f32."""
    x = _inputs(2, (4096,), 3.0, -3.0)
    got, want = _both("fast_exp", x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn_name", ["piecewise_silu",
                                     "piecewise_silu_paper"])
def test_piecewise_silu_matches_repro(fn_name, dtype):
    # every segment, including the breakpoints themselves
    breaks = np.asarray(japprox.SILU_BREAKS + (-1.5, 0.75, 12.0, -12.0),
                        np.float32)
    x = np.concatenate([_inputs(3, (2000,), 5.0), breaks])
    got, want = _both(fn_name, x, dtype)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_constants_are_copied():
    for name in ("FAST_EXP_B_SHIFT", "OUR_EXP_B_SHIFT", "OUR_EXP_C",
                 "SILU_BREAKS", "SILU_COEFS", "LN2", "_EXP_CLAMP"):
        assert getattr(tapprox, name) == getattr(japprox, name), name


@pytest.mark.parametrize("kind,names", [("exp", ("exact", "ours", "fast")),
                                        ("silu", ("exact", "ours", "paper"))])
def test_dispatch_tables_match_repro(kind, names):
    getter_t = getattr(tapprox, f"get_{kind}")
    getter_j = getattr(japprox, f"get_{kind}")
    x = _inputs(4, (512,), 2.0, -1.0)
    for name in names:
        want = np.asarray(getter_j(name)(jnp.asarray(x)))
        got = getter_t(name)(torch.from_numpy(x)).numpy()
        rtol = 5e-3 if kind == "exp" and name != "exact" else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    with pytest.raises(KeyError):
        getter_t("nope")
