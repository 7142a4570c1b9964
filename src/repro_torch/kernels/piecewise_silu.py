"""Piecewise SiLU (K9, MARCA SiLU-RCU mode): wrapper over the CUDA kernel
``csrc/approx_units.cu``.

Port of ``repro/kernels/piecewise_silu.py`` (Pallas ``_silu_kernel``,
pallas_call at :41): the 6-segment "ours" or the paper's 4-segment eq. 3
element-wise over a contiguous f32 or bf16 tensor, computed in f32 and
rounded once to the input's dtype, bit for bit the plain version.  On a
CUDA tensor the kernel runs; on a CPU tensor the plain version
(``kernels.ref.piecewise_silu``) does.

Special values, on which the plain version, the kernel and ``repro``
agree (a break belongs to the segment above it for "ours"; "paper"'s
tests are ``x < -5``, ``x < -1.5``, ``x <= 0.75``):

- "ours": below -9 (-inf too) 0; above 9 (+inf too) x itself; on
  [-9, 9] one segment's quadratic; NaN 0, since every range test fails
  and the result starts at 0.
- "paper": below -5 (-inf too) -0.0135; above 0.75 1.05 x - 0.2781, so
  +inf gives +inf; NaN NaN (its bits may differ between the card, where
  f32 arithmetic returns the canonical NaN, and the CPU).
- +-0 and subnormals fall in the middle segment ("ours" 0.0058849,
  "paper" 0.048585).
- In bf16 the f32 result is rounded once to nearest even.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

#: kernel launches made by this wrapper
launches = 0

VARIANTS = ("ours", "paper")


def piecewise_silu(x, variant: str = "ours"):
    """The piecewise SiLU of every element.  Returns a new tensor of x's
    shape and dtype."""
    global launches
    _lib.require(variant in VARIANTS, f"unknown SiLU variant {variant!r}")
    _lib.check_dtype(x)
    if x.device.type == "cpu":
        return ref.piecewise_silu(x, variant)
    _lib.require(x.is_contiguous(),
                 "piecewise_silu takes a contiguous tensor")
    y = torch.empty_like(x)
    if x.numel():
        _lib.call("marca_piecewise_silu", x.device, _lib.ptr(x), _lib.ptr(y),
                  x.numel(), _lib.DTYPES[x.dtype], int(variant == "paper"))
        launches += 1
    return y
