"""The MARCA units standalone (the paper's EXP-RCU and SiLU-RCU modes):
the port's ``ops.exp`` / ``ops.silu`` with ``backend="pallas"`` (K8 and K9's
wrappers, their plain versions on the CPU) against ``repro``'s, whose
Pallas kernels run in interpret mode, on the same seeded inputs, at
``repro``'s own tolerances (tests/test_kernels.py:32-48).  K8 and K9 are
held bitwise against their plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import dispatch_count
from repro_torch.kernels import ops

from _torch_inputs import UNIT_IMPLS, unit_special_values

jax.config.update("jax_platform_name", "cpu")

#: ragged shapes: no multiple of the Pallas wrapper's 128-lane tiles
SHAPES = [(8,), (33,), (4, 129), (2, 3, 257), (5, 7, 11, 13)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed, scale, shift):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * scale + shift


def _both(fn, jfn, x, dtype, impl):
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(jfn(jnp.asarray(x).astype(jdt), impl, "pallas"),
                      np.float32)
    got = fn(torch.from_numpy(x).to(tdt), impl, "pallas")
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["ours", "fast"])
def test_exp_units_match_repro(impl, shape, dtype):
    got, want = _both(ops.exp, jops.exp, _inputs(shape, 1, 3.0, -2.0),
                      dtype, impl)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["ours", "paper"])
def test_silu_units_match_repro(impl, shape, dtype):
    got, want = _both(ops.silu, jops.silu, _inputs(shape, 2, 4.0, 0.0),
                      dtype, impl)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op,impl", UNIT_IMPLS)
def test_units_special_values_match_repro(op, impl, dtype):
    """+-0, +-inf, NaNs, subnormals, K8's clamp and the SiLU breaks with
    their f32 neighbours: the plain versions agree with ``repro``'s at
    its tolerances, NaN for NaN and inf for inf (XLA contracts a
    multiply-add into an FMA, so finite values may differ in the last
    bits), and exp of NaN is the same 0.0 ("fast") or c ("ours") in
    both, bit for bit; so is "ours" SiLU of NaN, 0.0."""
    x = unit_special_values(torch.float32).numpy()
    fn, jfn = (ops.exp, jops.exp) if op == "exp" else (ops.silu, jops.silu)
    got, want = _both(fn, jfn, x, dtype, impl)
    np.testing.assert_allclose(got, want, rtol=5e-3 if op == "exp" else 1e-5,
                               atol=1e-6)
    if impl != "paper":
        nan = np.isnan(x)
        np.testing.assert_array_equal(got[nan].view(np.int32),
                                      want[nan].view(np.int32))


@pytest.mark.parametrize("fn,impl", [(ops.exp, "exact"),
                                     (ops.silu, "exact")])
def test_exact_units_are_torch(fn, impl):
    x = torch.from_numpy(_inputs((3, 50), 3, 2.0, 0.0))
    want = torch.exp(x) if fn is ops.exp else torch.nn.functional.silu(x)
    assert torch.equal(fn(x, impl, "pallas"), want)
    assert torch.equal(fn(x, impl, "xla"), want)


def test_units_enter_their_plain_versions_on_the_cpu():
    x = torch.from_numpy(_inputs((100,), 4, 2.0, 0.0))
    got = dispatch_count.launch_counts(ops.exp, x, "fast", "pallas")
    assert dict(got) == {"plain fast_exp": 1}
    got = dispatch_count.launch_counts(ops.silu, x, "paper", "pallas")
    assert dict(got) == {"plain piecewise_silu": 1}
    assert dispatch_count.count_launches(ops.exp, x, "ours", "xla") == 0
    with pytest.raises(KeyError, match="backend"):
        ops.silu(x, "ours", "triton")
