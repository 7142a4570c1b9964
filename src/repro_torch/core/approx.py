"""MARCA §5 nonlinearities as plain PyTorch tensor functions.

The port's copy of ``repro/core/approx.py``: the biased fast exponential
(Schraudolph's exponent-field trick with the paper's calibrated bias),
the piecewise SiLU (the 6-segment refit "ours" and the paper's 4-segment
eq. 3) and the 5-segment piecewise sigmoid, with the numpy helpers that
re-derive the calibrated constants.  The constants are copied verbatim.
These are the plain versions; the CUDA kernels carry the same arithmetic
in ``csrc/common.cuh`` (and K9's segment table in
``csrc/approx_units.cu``) and select it with the same names.
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

#: 5-segment quadratic sigmoid (xLSTM gates under approx mode); below -9
#: -> 0, above 9 -> 1.
SIGMOID_BREAKS = (-9.0, -4.0, -1.5, 1.5, 4.0, 9.0)
SIGMOID_COEFS = (
    (0.0011309, 0.0173485, 0.0662357),
    (0.0255878, 0.2028679, 0.4243576),
    (0.0, 0.2257178, 0.5),
    (-0.0255878, 0.2028679, 0.5756424),
    (-0.0011309, 0.0173485, 0.9337643),
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


def exp_density_set(n: int = 200) -> np.ndarray:
    """The paper's calibration distribution: x = -7/n, dense toward 0-."""
    return np.array([-7.0 / k for k in range(1, n + 1)], dtype=np.float32)


def calibrate_exp_bias(xs: np.ndarray | None = None,
                       n_grid: int = 561) -> tuple[float, float]:
    """Re-derive (OUR_EXP_B_SHIFT, OUR_EXP_C): the least mean relative
    error on xs (default: the density set) over a grid of shifts, each
    with its weighted-median final bias."""
    if xs is None:
        xs = exp_density_set()
    t = np.exp(xs.astype(np.float64))
    w = 1.0 / t

    def _raw(x, b):
        i = (np.clip(x, -_EXP_CLAMP, _EXP_CLAMP).astype(np.float32)
             * np.float32(_S23 / LN2)
             + np.float32((127.0 + b) * _S23)).astype(np.int32)
        return i.view(np.float32).astype(np.float64)

    def _weighted_median(vals, ww):
        idx = np.argsort(vals)
        cw = np.cumsum(ww[idx])
        return float(vals[idx][np.searchsorted(cw, cw[-1] / 2)])

    best = (np.inf, 0.0, 0.0)
    for b in np.linspace(-0.12, 0.02, n_grid):
        e = _raw(xs, b) - t
        c = _weighted_median(-e, w)
        m = float((np.abs(e + c) / t).mean())
        if m < best[0]:
            best = (m, float(b), c)
    return best[1], best[2]


def _piecewise_quad(x32: torch.Tensor, breaks, coefs, low_fn,
                    high_fn) -> torch.Tensor:
    """Range detector + per-segment quadratic (the SiLU-RCU datapath):
    ``low_fn`` below the first break, segment i's quadratic from break i
    on, ``high_fn`` above the last."""
    y = low_fn(x32)
    for i, (a2, a1, a0) in enumerate(coefs):
        seg = (_f32(a2) * x32 + _f32(a1)) * x32 + _f32(a0)
        y = torch.where(x32 >= _f32(breaks[i]), seg, y)
    return torch.where(x32 > _f32(breaks[-1]), high_fn(x32), y)


def piecewise_silu(x: torch.Tensor) -> torch.Tensor:
    """Refit 6-segment SiLU: range detect + per-segment quadratic."""
    y = _piecewise_quad(x.float(), SILU_BREAKS, SILU_COEFS,
                        torch.zeros_like, lambda v: v)
    return y.to(x.dtype)


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


def piecewise_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """5-segment sigmoid (the same datapath class)."""
    y = _piecewise_quad(x.float(), SIGMOID_BREAKS, SIGMOID_COEFS,
                        torch.zeros_like, torch.ones_like)
    return y.to(x.dtype)


def fit_piecewise_silu(breaks=SILU_BREAKS) -> np.ndarray:
    """Re-derive SILU_COEFS by per-segment least squares."""
    out = []
    for lo, hi in zip(breaks[:-1], breaks[1:]):
        xs = np.linspace(lo, hi, 20001)
        out.append(np.polyfit(xs, xs / (1 + np.exp(-xs)), 2))
    return np.asarray(out)


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

SIGMOID_IMPLS = {
    "exact": torch.sigmoid,
    "ours": piecewise_sigmoid,
}


def get_exp(name: str):
    return EXP_IMPLS[name]


def get_silu(name: str):
    return SILU_IMPLS[name]


def get_sigmoid(name: str):
    return SIGMOID_IMPLS[name]
