"""The port's trainable kernels on the CPU: the autograd Functions over K4
(the scan), K5 (the conv) and K7 (attention), the dispatch that runs them
whenever a call trains, and the guard that makes every raw kernel entry
refuse an input that requires grad.

On the CPU each Function's forward is its wrapper's plain version and its
backward is the PyTorch code the card runs too, so these tests hold the
backward the card uses:

  1. the scan Function's gradients for x, dt, A, B and C against jax.grad
     of ``repro``'s ``selective_scan_trainable`` (Pallas in interpret mode,
     as tests/test_trainable_scan.py runs it) at that file's three shapes
     (the last with a ragged last chunk), and against torch autograd
     through the plain scan there and over a hypothesis sweep of shapes
     and chunks (L below the chunk too), within 1e-4 of each gradient's
     max-abs;
  2. the conv Function (with and without x_prev, L below and above the
     taps) and the attention Function (GQA, lq = lk and lq < lk, causal
     and not) against torch autograd through their plain versions;
  3. ``ops`` routes a training call to the Functions under every impl
     name, ``pallas_vjp`` always, D and the z gate outside the scan;
  4. the raw wrappers of K1-K5, K7, K8 and K9 raise on an input that
     requires grad under grad mode, and serve under no_grad.
The card's side is in tests/test_torch_cuda.py (``gpu``) and chip_smoke.py
phase 2g.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:            # degrade to the deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.kernels.selective_scan import (
    selective_scan_trainable as jscan_trainable)
from repro_torch import configs
from repro_torch.kernels import conv1d as tconv
from repro_torch.kernels import decode_step as tstep
from repro_torch.kernels import fast_exp, megakernel, ops, piecewise_silu, ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import selective_scan as tscan
from repro_torch.models import registry

from _torch_inputs import np_input, step_arrays, to_torch

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4


def _scan_np(b, L, d, n, seed=7):
    """x, dt, A, B, C as numpy, drawn as tests/test_trainable_scan.py
    draws them (dt softplus'd, A = -exp(0.5 N(0, 1)))."""
    return (np_input(seed, b, L, d),
            np_input(seed + 1, b, L, d, softplus=True),
            np_input(seed + 2, d, n, neg_exp=True),
            np_input(seed + 3, b, L, n), np_input(seed + 4, b, L, n))


def _leaves(arrs):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrs]


def _port_grads(fn, arrs):
    ins = _leaves(arrs)
    y, h = fn(*ins)
    loss = (y.float() ** 2).sum() + (h ** 2).sum()
    return float(loss.detach()), torch.autograd.grad(loss, ins)


def _jax_grads(arrs, chunk):
    def loss(*a):
        y, h = jscan_trainable(*a, chunk, True)
        return jnp.sum(y ** 2) + jnp.sum(h ** 2)

    js = [jnp.asarray(a) for a in arrs]
    return float(loss(*js)), jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*js)


def _assert_grads(got, want, tol=TOL, label=""):
    for name, g, w in zip("x dt A B C".split(), got, want):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) + 1e-9
        rel = float(np.abs(g.detach().float().numpy() - w).max()) / scale
        assert rel < tol, (label, name, rel)


# ---------------------------------------------------------------------------
# 1. The scan Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,L,d,n,chunk", [(1, 32, 8, 4, 8),
                                           (2, 96, 24, 8, 32),
                                           (2, 100, 16, 16, 32)])
def test_scan_function_matches_repros_trainable_scan(b, L, d, n, chunk):
    arrs = _scan_np(b, L, d, n)
    lt, gt = _port_grads(
        lambda *a: tscan.selective_scan_trainable(*a, chunk=chunk), arrs)
    lj, gj = _jax_grads(arrs, chunk)
    assert abs(lt - lj) < TOL * abs(lj)
    _assert_grads(gt, gj, label="vs repro")
    _, gp = _port_grads(lambda *a: ref.selective_scan(*a), arrs)
    _assert_grads(gt, [g.numpy() for g in gp], label="vs plain autograd")


@given(st.integers(1, 2), st.integers(4, 50), st.integers(2, 12),
       st.integers(1, 8), st.integers(3, 64))
@settings(max_examples=12, deadline=None)
def test_scan_function_property(b, L, d, n, chunk):
    """The sweep against autograd through the plain scan (the port's copy
    of repro's reference, held to it by tests/test_torch_kernels.py):
    each repro call would compile the interpret-mode kernel anew."""
    arrs = _scan_np(b, L, d, n, seed=L + 3 * d)
    _, gt = _port_grads(
        lambda *a: tscan.selective_scan_trainable(*a, chunk=chunk), arrs)
    _, gp = _port_grads(lambda *a: ref.selective_scan(*a), arrs)
    _assert_grads(gt, [g.numpy() for g in gp], label=(b, L, d, n, chunk))


def test_scan_function_bf16_grads_in_input_dtypes():
    """bf16 streams: grads come back in the inputs' dtypes (A's f32) and
    the forward is the wrapper's (the plain version, counted once, plus
    one recompute call a chunk in the backward)."""
    x, dt, A, B, C = _scan_np(2, 40, 16, 16)
    ins = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
           for a in (x, dt)] + [torch.from_numpy(A).requires_grad_()] + [
        torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
        for a in (B, C)]
    n0 = ref.CALLS["selective_scan"]
    y, h = tscan.selective_scan_trainable(*ins, chunk=16)
    assert y.dtype == torch.float32 and ref.CALLS["selective_scan"] == n0 + 1
    (y.sum() + h.sum()).backward()
    assert ref.CALLS["selective_scan"] == n0 + 1 + 3      # ceil(40 / 16)
    for t in ins:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad).all()


# ---------------------------------------------------------------------------
# 2. The conv and attention Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 2, 5, 33])
@pytest.mark.parametrize("prev", [False, True], ids=["no_prev", "x_prev"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_conv_function_matches_plain_autograd(L, prev, bias):
    b, d, k = 2, 12, 4
    # x a strided view, as the Mamba block hands it (half of in_proj's)
    xz = torch.from_numpy(np_input(1, b, L, 2 * d)).requires_grad_()
    w = torch.from_numpy(np_input(2, k, d)).requires_grad_()
    bb = torch.from_numpy(np_input(3, d)).requires_grad_() if bias else None
    xp = (torch.from_numpy(np_input(4, b, k - 1, d)).requires_grad_()
          if prev else None)
    ins = [t for t in (xz, w, bb, xp) if t is not None]
    dy = torch.from_numpy(np_input(5, b, L, d))
    dtail = torch.from_numpy(np_input(6, b, k - 1, d))

    def grads(fn):
        y, tail = fn(xz[..., :d], w, bb, xp)
        return torch.autograd.grad((y * dy).sum() + (tail * dtail).sum(),
                                   ins)

    for g, w_ in zip(grads(tconv.causal_conv1d_trainable),
                     grads(ref.causal_conv1d)):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("b,lq,lk,hq,hkv,dh", [(2, 16, 16, 4, 2, 8),
                                               (1, 5, 19, 6, 3, 4),
                                               (2, 24, 24, 4, 4, 16),
                                               (1, 7, 7, 8, 1, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_matches_plain_autograd(b, lq, lk, hq, hkv, dh,
                                                   causal):
    q, k, v = (torch.from_numpy(np_input(s, b, l, h, dh)).requires_grad_()
               for s, l, h in ((1, lq, hq), (2, lk, hkv), (3, lk, hkv)))
    do = torch.from_numpy(np_input(4, b, lq, hq, dh))
    got = torch.autograd.grad(
        tflash.flash_attention_trainable(q, k, v, causal=causal), (q, k, v),
        do)
    want = torch.autograd.grad(ref.attention(q, k, v, causal=causal),
                               (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# 3. Dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ops.SCAN_IMPLS)
def test_ops_scan_trains_through_the_function(impl):
    """Under every impl name a training call runs the Function (D and the
    z gate outside): its gradients equal autograd through the plain scan
    with D and z, and its outputs the non-training call's."""
    arrs = _scan_np(2, 20, 8, 4)
    D, z = np_input(11, 8), np_input(12, 2, 20, 8)
    ins = _leaves(arrs) + _leaves((D, z))
    y, h = ops.selective_scan(*ins[:5], D=ins[5], z=ins[6], impl=impl,
                              chunk=8)
    assert y.grad_fn is not None
    g = torch.autograd.grad((y ** 2).sum() + (h ** 2).sum(), ins)
    plain = _leaves(arrs) + _leaves((D, z))
    yp, hp = ref.selective_scan(*plain[:5], D=plain[5], z=plain[6])
    gp = torch.autograd.grad((yp ** 2).sum() + (hp ** 2).sum(), plain)
    for a, w in zip(g, gp):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) < TOL * scale
    with torch.no_grad():
        y0, _ = ops.selective_scan(*ins[:5], D=ins[5], z=ins[6],
                                   impl="pallas")
    np.testing.assert_allclose(y.detach().numpy(), y0.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ops_pallas_vjp_and_h0():
    """``pallas_vjp`` runs the trainable scan even with nothing to train
    (as ``repro``'s), and a training call from a state raises."""
    arrs = [torch.from_numpy(a) for a in _scan_np(1, 12, 8, 4)]
    n0 = ref.CALLS["selective_scan"]
    y, _ = ops.selective_scan(*arrs, impl="pallas_vjp", chunk=4)
    y0, _ = ops.selective_scan(*arrs, impl="pallas")
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)
    assert ref.CALLS["selective_scan"] == n0 + 2
    h0 = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(*arrs, h0=h0, impl="pallas_vjp")
    trained = [a.clone().requires_grad_() for a in arrs]
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(*trained, h0=h0)


def test_ops_conv_and_attention_train_through_their_functions():
    x = torch.from_numpy(np_input(1, 2, 9, 8)).requires_grad_()
    w = torch.from_numpy(np_input(2, 4, 8))
    y, _ = ops.causal_conv1d(x, w)
    assert type(y.grad_fn).__name__ == "_TrainableConvBackward"
    q = torch.from_numpy(np_input(3, 1, 6, 4, 8)).requires_grad_()
    k = torch.from_numpy(np_input(4, 1, 6, 2, 8))
    o = ops.attention(q, k, k)
    assert type(o.grad_fn).__name__ == "_TrainableAttentionBackward"
    with torch.no_grad():
        assert ops.attention(q, k, k).grad_fn is None


# ---------------------------------------------------------------------------
# 4. No silent loss of gradient
# ---------------------------------------------------------------------------

def _raw_calls():
    """(name, call) of every raw kernel entry on inputs that require
    grad: K4, K5, K7, K1, K2, K3 (mamba), K8, K9."""
    def rg(a):
        return torch.from_numpy(a).requires_grad_()

    scan = [rg(a) for a in _scan_np(1, 6, 8, 4)]
    st = to_torch(step_arrays(2, 8, 16))
    A = st["A"].requires_grad_()
    cfg = configs.smoke_variant(configs.get_config("mamba-130m"))
    params = registry.init_params(cfg, seed=0)
    stack = megakernel.MambaStack(cfg, params["layers"])
    h = torch.zeros(cfg.n_layers, 2, cfg.d_inner, cfg.d_state)
    conv = torch.zeros(cfg.n_layers, 2, cfg.d_conv - 1, cfg.d_inner)
    x0 = torch.from_numpy(np_input(9, 2, 1, cfg.d_model)).requires_grad_()
    from repro_torch.core import state_quant
    hq, hs = state_quant.quantize_h(st["h"], "int8")
    q = rg(np_input(5, 1, 4, 2, 8))
    u = rg(np_input(6, 64))
    return [
        ("selective_scan", lambda: tscan.selective_scan(*scan)),
        ("causal_conv1d", lambda: tconv.causal_conv1d(
            scan[0], torch.ones(4, 8))),
        ("flash_attention", lambda: tflash.flash_attention(q, q, q)),
        ("selective_state_step", lambda: tstep.selective_state_step(
            st["h"], st["x_t"], st["dt_t"], A, st["B_t"], st["C_t"])),
        ("selective_state_step_q", lambda: tstep.selective_state_step_q(
            hq, hs, st["x_t"], st["dt_t"], A, st["B_t"], st["C_t"])),
        ("mamba_stacked_step", lambda: megakernel.mamba_stacked_step(
            cfg, x0, stack, h, None, conv)),
        ("fast_exp", lambda: fast_exp.fast_exp(u)),
        ("piecewise_silu", lambda: piecewise_silu.piecewise_silu(u)),
    ]


@pytest.mark.parametrize("i", range(8))
def test_raw_kernel_call_on_trainable_input_raises(i):
    name, call = _raw_calls()[i]
    with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                                           f"grad"):
        call()
    with torch.no_grad():
        call()


def test_megakernel_stack_of_trainable_weights_raises():
    """K3 refuses a stack built over weights that require grad (its
    table holds their pointers) under grad mode, whatever x0 is."""
    cfg = configs.smoke_variant(configs.get_config("mamba-130m"))
    params = registry.tree_map(lambda t: t.requires_grad_(),
                               registry.init_params(cfg, seed=0))
    stack = megakernel.MambaStack(cfg, params["layers"])
    x0 = torch.zeros(1, 1, cfg.d_model)
    h = torch.zeros(cfg.n_layers, 1, cfg.d_inner, cfg.d_state)
    conv = torch.zeros(cfg.n_layers, 1, cfg.d_conv - 1, cfg.d_inner)
    with pytest.raises(RuntimeError, match="mamba_stacked_step"):
        megakernel.mamba_stacked_step(cfg, x0, stack, h, None, conv)
    with torch.no_grad():
        megakernel.mamba_stacked_step(cfg, x0, stack, h, None, conv)
