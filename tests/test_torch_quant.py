"""The port's quantizers and quantized decode steps against repro's.

``core.state_quant`` and ``core.weight_quant`` must give repro's codes
and scales bit for bit on the same seeded inputs.  The plain
quantized-state step (``kernels.ref.selective_state_step_q``) is held
against repro's fused ``_step_kernel_q`` (Pallas, interpret mode) at
repro's tolerances for that kernel against its own oracle
(tests/test_state_quant.py): scales to rtol 1e-6, payloads within one
code, y within 1e-4.  The plain step with int8 A (``a_scale``) is held
against repro's fused ``_step_kernel`` with ``a_scale`` at 1e-5
(tests/test_weight_quant.py).  The wrappers' CPU route and argument
checks are here too; the CUDA kernels are held against these plain
versions in tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import state_quant as jsq
from repro.core import weight_quant as jwq
from repro.kernels import decode_step as jstep
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro_torch import bridge
from repro_torch.core import state_quant as tsq
from repro_torch.core import weight_quant as twq
from repro_torch.kernels import decode_step as tstep
from repro_torch.kernels import ref

from _torch_inputs import (VARIANTS, assert_q_close, close, np_input,
                           q_step_tensors, step_arrays, to_torch)

jax.config.update("jax_platform_name", "cpu")


def _bits(t):
    """The bytes of a torch tensor or a jax/numpy array, for bitwise
    checks (the last axis becomes itemsize times longer)."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


def _same_bits(t, j):
    np.testing.assert_array_equal(_bits(t), _bits(j))


def _to_jax(t):
    """A port tensor as repro takes it (fp8 narrowed again in JAX)."""
    if t is None:
        return None
    a = jnp.asarray(bridge.to_numpy({"t": t})["t"])
    fp8 = t.dtype == torch.float8_e4m3fn
    return a.astype(jnp.float8_e4m3fn) if fp8 else a


# ---------------------------------------------------------------------------
# Quantizers: bitwise against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("d", [128, 512, 1100])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "prev_scale"])
def test_quantize_h_equals_repros_bitwise(state_dtype, d, warm):
    """Cold start (prefill) and the running-absmax update with a previous
    scale; d=1100 has a ragged third group."""
    h = np_input(d, 4, d, 16) * 3.0
    g = tsq.n_groups(d)
    prev = np.abs(np_input(d + 1, 4, g)) * 0.05 if warm else None
    qj, sj = jsq.quantize_h(jnp.asarray(h), state_dtype,
                            None if prev is None else jnp.asarray(prev))
    qt, st = tsq.quantize_h(torch.from_numpy(h), state_dtype,
                            None if prev is None else torch.from_numpy(prev))
    assert qt.dtype == tsq.storage_dtype(state_dtype)
    assert st.shape == (4, g) and st.dtype == torch.float32
    _same_bits(qt, qj)
    _same_bits(st, sj)
    _same_bits(tsq.dequantize_h(qt, st), jsq.dequantize_h(qj, sj))


def test_state_quant_names_and_constants():
    assert tsq.STATE_DTYPES == jsq.STATE_DTYPES
    assert (tsq.D_BLOCK, tsq.EMA_DECAY, tsq.EPS_AMAX) == (
        jsq.D_BLOCK, jsq.EMA_DECAY, jsq.EPS_AMAX)
    for sd in tsq.STATE_DTYPES:
        assert tsq.is_quantized(sd) == jsq.is_quantized(sd)
    assert tsq.storage_dtype("int8") == torch.int8
    assert tsq.storage_dtype("fp8") == torch.float8_e4m3fn
    assert [tsq.n_groups(d) for d in (1, 512, 513, 1536)] == [1, 1, 2, 3]
    with pytest.raises(KeyError):
        tsq.is_quantized("int4")


def test_quantize_w_and_rows_equal_repros_bitwise():
    w = np_input(1, 768, 3072) * 0.05
    a = -np.exp(np_input(2, 1536, 16))
    for tfn, jfn, x in ((twq.quantize_w, jwq.quantize_w, w),
                        (twq.quantize_rows, jwq.quantize_rows, a)):
        qt, st = tfn(torch.from_numpy(x))
        qj, sj = jfn(jnp.asarray(x))
        _same_bits(qt, qj)
        _same_bits(st, sj)
    qt, st = twq.quantize_w(torch.from_numpy(w))
    _same_bits(twq.dequantize_w(qt, st),
               jwq.dequantize_w(*jwq.quantize_w(jnp.asarray(w))))
    assert twq.SKIP_KEYS == jwq.SKIP_KEYS and twq.QMAX == jwq.QMAX


def test_quantize_tree_equals_repros_on_the_bridged_tree():
    """mamba-130m-smoke weights made by repro, bridged, quantized by the
    port; repro quantizes the same tree: leaf for leaf, bit for bit."""
    cfg = jconfigs.smoke_variant(jconfigs.get_config("mamba-130m"))
    jp = jax.tree.map(np.asarray, sharding.tree_values(
        jregistry.init_params(cfg, jax.random.key(0))))
    tq = twq.quantize_tree(bridge.params_from_repro(jp))
    jq = jax.tree.map(np.asarray, jwq.quantize_tree(jp))
    back = bridge.params_to_repro(tq)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jq)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    mixer = tq["layers"][0]["mixer"]
    assert "A_log" not in mixer and mixer["A_q"].dtype == torch.int8
    assert mixer["in_proj"]["w"].dtype == torch.int8
    assert tq["embed"]["tok"].dtype == torch.float32     # SKIP_KEYS
    with pytest.raises(ValueError, match="already"):
        twq.quantize_tree(tq)


# ---------------------------------------------------------------------------
# Plain quantized-state step against repro's fused _step_kernel_q
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
@pytest.mark.parametrize("a8", [False, True], ids=["f32_A", "int8_A"])
@pytest.mark.parametrize("b,d", [(4, 64), (3, 1100), (2, 513)])
def test_step_q_plain_matches_repros_kernel(state_dtype, exp_impl,
                                            silu_impl, a8, b, d):
    args, kw = q_step_tensors(b, d, 16, state_dtype, seed=d, a8=a8)
    kw.update(exp_impl=exp_impl, silu_impl=silu_impl)
    got = ref.selective_state_step_q(*args, state_dtype=state_dtype, **kw)
    jargs = [_to_jax(t) for t in args]
    jkw = {k: _to_jax(v) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    yj, qj, sj = jstep.selective_state_step_q(
        *jargs, state_dtype=state_dtype, interpret=True, **jkw)
    want = (torch.tensor(np.asarray(yj)),
            bridge.to_torch({"q": np.asarray(qj)})["q"],
            torch.tensor(np.asarray(sj)))
    assert got[1].dtype == tsq.storage_dtype(state_dtype)
    assert_q_close(got, want, 1e-4, f"{state_dtype} {exp_impl}/{silu_impl}")
    # the fresh slot 0 (zero codes, zero scale) gets its own step's absmax
    h_new = ref.selective_state_step(
        tsq.dequantize_h(args[0], args[1]), *args[2:], **kw)[1]
    first = tsq.quantize_h(h_new[:1], state_dtype)[1]
    np.testing.assert_allclose(got[2][:1].numpy(), first.numpy(), rtol=1e-6)


@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
def test_step_int8_a_plain_matches_repros_fused_kernel(exp_impl, silu_impl):
    """K1's int8-A variant: the plain step dequantizes A with
    dequantize_rows, repro's kernel in its dequant phase."""
    a = step_arrays(3, 130, 16, seed=17)
    t = to_torch(a)
    A_q, a_scale = twq.quantize_rows(t["A"])
    kw = dict(exp_impl=exp_impl, silu_impl=silu_impl)
    yt, ht = ref.selective_state_step(t["h"], t["x_t"], t["dt_t"], A_q,
                                      t["B_t"], t["C_t"], D=t["D"],
                                      z_t=t["z_t"], a_scale=a_scale, **kw)
    yj, hj = jstep.selective_state_step(
        jnp.asarray(a["h"]), jnp.asarray(a["x_t"]), jnp.asarray(a["dt_t"]),
        jnp.asarray(A_q.numpy()), jnp.asarray(a["B_t"]),
        jnp.asarray(a["C_t"]), D=jnp.asarray(a["D"]),
        z_t=jnp.asarray(a["z_t"]), a_scale=jnp.asarray(a_scale.numpy()),
        block_d=64, interpret=True, **kw)
    close(yt, yj, 1e-5)
    close(ht, hj, 1e-5)
    # the same as the f32 step on the dequantized A, bit for bit
    y2, h2 = ref.selective_state_step(
        t["h"], t["x_t"], t["dt_t"], twq.dequantize_rows(A_q, a_scale),
        t["B_t"], t["C_t"], D=t["D"], z_t=t["z_t"], **kw)
    assert torch.equal(yt, y2) and torch.equal(ht, h2)


# ---------------------------------------------------------------------------
# Wrappers on the CPU
# ---------------------------------------------------------------------------

def test_q_wrapper_takes_the_plain_version_on_cpu():
    ref.CALLS.clear()
    before = (tstep.launches, tstep.launches_int8a, tstep.launches_q)
    args, kw = q_step_tensors(2, 40, 16, "fp8", a8=True)
    got = tstep.selective_state_step_q(*args, state_dtype="fp8", **kw)
    want = ref.selective_state_step_q(*args, state_dtype="fp8", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    s = to_torch(step_arrays(2, 40, 16))
    A_q, a_scale = twq.quantize_rows(s["A"])
    tstep.selective_state_step(s["h"], s["x_t"], s["dt_t"], A_q, s["B_t"],
                               s["C_t"], a_scale=a_scale)
    assert (tstep.launches, tstep.launches_int8a,
            tstep.launches_q) == before
    assert dict(ref.CALLS) == {"selective_state_step_q": 2,
                               "selective_state_step": 1}


@pytest.mark.parametrize("bad", ["payload_dtype", "state_dtype", "scale_shape",
                                 "A_dtype", "a_scale_shape", "plain_A8"])
def test_q_and_int8_a_wrappers_check_arguments(bad):
    args, kw = q_step_tensors(2, 40, 16, "int8", a8=True)
    hq, h_scale, x_t, dt_t, A, B_t, C_t = args
    sd = "int8"
    fn = tstep.selective_state_step_q
    if bad == "payload_dtype":
        hq = hq.to(torch.float8_e4m3fn)
    elif bad == "state_dtype":
        sd = "bf16"
    elif bad == "scale_shape":
        h_scale = torch.zeros(2, 2)
    elif bad == "A_dtype":
        A = A.float()
    elif bad == "a_scale_shape":
        kw["a_scale"] = kw["a_scale"][:-1]
    else:
        fn = None
    with pytest.raises(ValueError):
        if fn is None:       # int8 A codes without their scales
            tstep.selective_state_step(h_scale.new_zeros(2, 40, 16), x_t,
                                       dt_t, A, B_t, C_t)
        else:
            fn(hq, h_scale, x_t, dt_t, A, B_t, C_t, state_dtype=sd, **kw)
