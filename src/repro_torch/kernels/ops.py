"""Dispatch from the model's implementation knobs to the kernel wrappers.

``repro`` chooses between several XLA implementations and a Pallas
kernel per op.  The port has one implementation of each op on this
path: the hand-written CUDA kernel for a tensor on the card and its
plain PyTorch version for a tensor on the CPU — the wrapper decides by
the tensor's device alone.  The impl names of ``repro``'s configs are
accepted so that one config describes both packages:

* ``scan_impl``: seq | assoc | chunked | chunked_seq | pallas | pallas_vjp
  — all run the scan kernel (``pallas`` is the name this slice is
  configured with; ``pallas_vjp``, ``repro``'s trainable path, always
  runs the trainable scan below);
* ``conv_impl``: xla | pallas — both run the conv kernel;
* ``attn_impl``: chunked | ref | pallas — all run the flash attention
  kernel (K7) at prefill (``pallas`` is the name jamba is configured
  with);

Training.  The kernels write fresh outputs that autograd cannot see
through, so with grad mode on and an input that requires grad the scan,
the conv and attention run their ``torch.autograd.Function``
(``selective_scan_trainable``, ``causal_conv1d_trainable``,
``flash_attention_trainable``): the forward is the same wrapper call (the
kernel on the card, the plain version on the CPU), the backward is
PyTorch and the same on both devices, as ``repro`` trains through its
custom VJP (``repro/kernels/ops.py:51``) and XLA autodiff.  The raw
wrappers refuse such inputs (``_lib.check_no_grad``) rather than cut the
gradient.  The trainable scan starts from h0 = 0 with exact exp; the D
skip and the z gate run outside it in tensor ops, with
``cfg.silu_impl``, as ``repro/kernels/ops.py:57-62`` does.
* ``step_impl``: "megakernel" runs the whole layer stack of a decode
  token in one launch of the cross-layer kernel (K3,
  ``kernels/megakernel.py``); fused | pallas | xla run the per-layer
  decode-step kernel; "auto" is the megakernel for a model on the card
  and "fused" on the CPU, as ``repro`` takes the megakernel where Pallas
  compiles natively (a family with no megakernel instance, the
  transformer, decodes per layer under "auto" on every device:
  ``registry.uses_megakernel``).  Per-layer call sites resolve a
  megakernel config to "fused" (``resolve_cell_impl``).  ``repro``'s
  ``REPRO_STEP_IMPL`` override of "auto" is not ported.

``exp`` and ``silu`` are the MARCA units standalone (the paper's EXP-RCU
and SiLU-RCU modes): with ``backend="pallas"`` the approximations run
the unit kernels (K8, K9), with "xla" the plain tensor functions of
``core.approx``; "exact" is ``torch.exp`` / ``F.silu`` under either.

``state_dtype`` "f32" and "bf16" store the pooled state at that width;
"int8" and "fp8" store codes with f32 group scales and decode through
``selective_state_step_q``.  The step math is f32 in every case.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import approx, state_quant
from repro_torch.kernels import conv1d as _conv_k
from repro_torch.kernels import decode_step as _step_k
from repro_torch.kernels import fast_exp as _fast_exp_k
from repro_torch.kernels import flash_attention as _flash_k
from repro_torch.kernels import piecewise_silu as _silu_k
from repro_torch.kernels import selective_scan as _scan_k

SCAN_IMPLS = ("seq", "assoc", "chunked", "chunked_seq", "pallas",
              "pallas_vjp")
CONV_IMPLS = ("xla", "pallas")
ATTN_IMPLS = ("chunked", "ref", "pallas")
STEP_IMPLS = ("auto", "megakernel", "fused", "pallas", "xla")
BACKENDS = ("xla", "pallas")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}")


def exp(x, impl: str = "exact", backend: str = "xla"):
    """impl in {exact, ours, fast}; backend in {xla, pallas}
    (``repro/kernels/ops.py:19``)."""
    _check_backend(backend)
    if impl == "exact":
        return torch.exp(x)
    if backend == "pallas":
        if impl == "ours":
            return _fast_exp_k.fast_exp(x)
        return _fast_exp_k.fast_exp(x, b_shift=approx.FAST_EXP_B_SHIFT,
                                    c=0.0)
    return approx.get_exp(impl)(x)


def silu(x, impl: str = "exact", backend: str = "xla"):
    """impl in {exact, ours, paper}; backend in {xla, pallas}
    (``repro/kernels/ops.py:30``)."""
    _check_backend(backend)
    if impl == "exact":
        return F.silu(x)
    if backend == "pallas":
        return _silu_k.piecewise_silu(x, variant=impl)
    return approx.get_silu(impl)(x)


def resolve_step_impl(name: str, device="cpu") -> str:
    """cfg.step_impl for a decode step of a model on ``device``:
    "megakernel" or "fused" (``repro/core/selective_scan.py:149``)."""
    if name not in STEP_IMPLS:
        raise KeyError(f"unknown step impl {name!r}")
    if name == "auto":
        return ("megakernel" if torch.device(device).type == "cuda"
                else "fused")
    return "megakernel" if name == "megakernel" else "fused"


def resolve_cell_impl(name: str, device="cpu") -> str:
    """cfg.step_impl at a per-layer call site (one block's step): the
    megakernel is a whole-stack launch, so there it runs the per-layer
    fused kernel (``repro/core/selective_scan.py:176``)."""
    resolve_step_impl(name, device)
    return "fused"


def storage_dtype(state_dtype: str) -> torch.dtype:
    """Torch dtype the pooled recurrent state is stored in."""
    return state_quant.storage_dtype(state_dtype)


def _trains(*tensors) -> bool:
    """Grad mode is on and an input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def selective_scan(x, dt, A, B, C, D=None, z=None, h0=None,
                   impl: str = "pallas", chunk: int = 64,
                   exp_impl: str = "exact", silu_impl: str = "exact"):
    """The scan kernel's wrapper, or, under ``impl="pallas_vjp"`` and
    whenever it trains, the trainable scan with D and the z gate outside
    (``chunk``: its backward's recompute interval)."""
    if impl not in SCAN_IMPLS:
        raise KeyError(f"unknown scan impl {impl!r}")
    if impl != "pallas_vjp" and not _trains(x, dt, A, B, C, D, z, h0):
        return _scan_k.selective_scan(x, dt, A, B, C, D=D, z=z, h0=h0,
                                      exp_impl=exp_impl,
                                      silu_impl=silu_impl)
    if h0 is not None:
        raise ValueError("the trainable scan starts from h0 = 0 "
                         "(training); a continuation runs under no_grad")
    y, h_last = _scan_k.selective_scan_trainable(x, dt, A, B, C, chunk)
    if D is not None:
        y = y + D.float()[None, None, :] * x.float()
    if z is not None:
        y = y * approx.get_silu(silu_impl)(z.float())
    return y.to(x.dtype), h_last


def causal_conv1d(x, w, b=None, x_prev=None, impl: str = "pallas"):
    if impl not in CONV_IMPLS:
        raise KeyError(f"unknown conv impl {impl!r}")
    if _trains(x, w, b, x_prev):
        return _conv_k.causal_conv1d_trainable(x, w, b=b, x_prev=x_prev)
    return _conv_k.causal_conv1d(x, w, b=b, x_prev=x_prev)


def selective_state_step(h, x_t, dt_t, A, B_t, C_t, D=None, z_t=None,
                         impl: str = "fused", exp_impl: str = "exact",
                         silu_impl: str = "exact", a_scale=None):
    resolve_cell_impl(impl, x_t.device)
    return _step_k.selective_state_step(h, x_t, dt_t, A, B_t, C_t, D=D,
                                        z_t=z_t, exp_impl=exp_impl,
                                        silu_impl=silu_impl, a_scale=a_scale)


def selective_state_step_q(hq, h_scale, x_t, dt_t, A, B_t, C_t, D=None,
                           z_t=None, state_dtype: str = "int8",
                           impl: str = "fused", exp_impl: str = "exact",
                           silu_impl: str = "exact", a_scale=None):
    resolve_cell_impl(impl, x_t.device)
    return _step_k.selective_state_step_q(
        hq, h_scale, x_t, dt_t, A, B_t, C_t, D=D, z_t=z_t,
        state_dtype=state_dtype, exp_impl=exp_impl, silu_impl=silu_impl,
        a_scale=a_scale)


def attention(q, k, v, causal: bool = True, impl: str = "pallas"):
    """Causal GQA attention of a sequence: K7 on the card, its plain
    version on the CPU, under every ``attn_impl`` name."""
    if impl not in ATTN_IMPLS:
        raise KeyError(f"unknown attention impl {impl!r}")
    if _trains(q, k, v):
        return _flash_k.flash_attention_trainable(q, k, v, causal=causal)
    return _flash_k.flash_attention(q, k, v, causal=causal)
