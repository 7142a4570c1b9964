"""MARCA §5 nonlinearities as plain PyTorch tensor functions.

The port's copy of ``repro/core/approx.py``: the biased fast exponential
(Schraudolph's exponent-field trick with the paper's calibrated bias)
and the piecewise SiLU (the 6-segment refit "ours" and the paper's
4-segment eq. 3).  The constants are copied verbatim.  These are the
plain versions; the CUDA kernels carry the same arithmetic in
``csrc/common.cuh`` and select it with the same names.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LN2 = 0.6931471805599453
_S23 = float(2**23)

#: Plain Schraudolph baseline ("fast_exp" row of Table 3).
FAST_EXP_B_SHIFT = -0.065
#: Our biased exp ("Our_exp"): calibrated on the density set x = -7/n.
OUR_EXP_B_SHIFT = -0.03475
#: Final additive bias c (paper Fig. 6 "bias unit").
OUR_EXP_C = 5.6e-07
#: Hard clamp so the bit trick never leaves the normalized-float range.
_EXP_CLAMP = 80.0

SILU_BREAKS = (-9.0, -5.0, -1.5, 0.75, 2.25, 4.5, 9.0)
SILU_COEFS = (
    (-0.0026606, -0.0442494, -0.1855941),   # [-9, -5)
    (-0.0117359, -0.1503727, -0.4880836),   # [-5, -1.5)
    (0.2163049, 0.4986513, 0.0058849),      # [-1.5, 0.75]
    (0.0813905, 0.7826839, -0.1309739),     # (0.75, 2.25]
    (-0.0164214, 1.1849977, -0.5492407),    # (2.25, 4.5]
    (-0.0033375, 1.0541269, -0.2208955),    # (4.5, 9]
)


def _f32(v: float) -> float:
    """A Python float holding exactly the f32 value ``repro`` uses
    (``np.float32(v)``), so tensor ops see the same constant."""
    return float(np.float32(v))


def fast_exp(x: torch.Tensor, b_shift: float = FAST_EXP_B_SHIFT,
             c: float = 0.0) -> torch.Tensor:
    """exp(x) via the exponent-field bit trick.

    i = int32(x * 2^23/ln2 + (127 + b_shift) * 2^23);  y = bitcast_f32(i) + c

    The float -> int32 conversion truncates toward zero, as
    ``astype(int32)`` does in ``repro``; the bitcast is
    ``.view(torch.float32)``."""
    dt = x.dtype
    x32 = x.float().clamp(-_EXP_CLAMP, _EXP_CLAMP)
    i = (x32 * _f32(_S23 / LN2) + _f32((127.0 + b_shift) * _S23)).to(
        torch.int32)
    y = i.view(torch.float32) + _f32(c)
    return y.to(dt)


def our_exp(x: torch.Tensor) -> torch.Tensor:
    """The paper's biased fast exp ("Our_exp"), calibrated for dt*A."""
    return fast_exp(x, OUR_EXP_B_SHIFT, OUR_EXP_C)


def piecewise_silu(x: torch.Tensor) -> torch.Tensor:
    """Refit 6-segment SiLU: range detect + per-segment quadratic."""
    dt = x.dtype
    x32 = x.float()
    y = torch.zeros_like(x32)
    for i, (a2, a1, a0) in enumerate(SILU_COEFS):
        seg = (_f32(a2) * x32 + _f32(a1)) * x32 + _f32(a0)
        y = torch.where(x32 >= _f32(SILU_BREAKS[i]), seg, y)
    y = torch.where(x32 > _f32(SILU_BREAKS[-1]), x32, y)
    return y.to(dt)


def piecewise_silu_paper(x: torch.Tensor) -> torch.Tensor:
    """Paper eq. (3), coefficients verbatim (4 segments)."""
    dt = x.dtype
    x32 = x.float()
    mid = _f32(0.232) * (x32 + _f32(1.181)) ** 2 + _f32(-0.275)
    y = torch.where(
        x32 < -5.0, torch.full_like(x32, _f32(-0.0135)),
        torch.where(
            x32 < -1.5, _f32(-0.06244) * x32 + _f32(-0.3457),
            torch.where(x32 <= 0.75, mid,
                        _f32(1.05) * x32 + _f32(-0.2781))))
    return y.to(dt)


EXP_IMPLS = {
    "exact": torch.exp,
    "ours": our_exp,
    "fast": fast_exp,
}

SILU_IMPLS = {
    "exact": F.silu,
    "ours": piecewise_silu,
    "paper": piecewise_silu_paper,
}


def get_exp(name: str):
    return EXP_IMPLS[name]


def get_silu(name: str):
    return SILU_IMPLS[name]
