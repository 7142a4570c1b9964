"""Quantized storage for the pooled decode state (cfg.state_dtype).

The port's copy of ``repro/core/state_quant.py``: the SSM state h and
the xLSTM matrix memory C.  The slot
pool holds one ``(layers, d_inner, d_state)`` state per in-flight
sequence; stored int8 or fp8 with f32 absmax scales it takes a quarter
of the f32 bytes, while the decode math stays f32: dequantize on read,
step in f32, requantize on write.

Scales are symmetric-linear absmax (dequant is ``q * scale``), f32, kept
as cache leaves beside the payload (``h_scale``), so every slot
operation moves payload and scale together.  One scale per slot, layer
and group of ``D_BLOCK`` channels (all ``d_state`` entries of a group
share it) — the decode kernel's blocking, so a block requantizes its
group with no reduction across blocks.

The per-step scale update is a decayed running absmax::

    amax_run' = max(amax(h_new), EMA_DECAY * amax_run)

so requantization never clips and a transient near-zero state does not
collapse the scale.  ``encode`` rounds half to even (``torch.round``),
as ``jnp.round`` does; fp8 is ``float8_e4m3fn`` with round to nearest
even, as ``astype`` gives in ``repro``.
"""
from __future__ import annotations

import math

import torch

#: storage dtypes accepted by cfg.state_dtype
STATE_DTYPES = ("f32", "bf16", "int8", "fp8")

#: channel-group size for SSM h scales; the decode kernel's blocking
D_BLOCK = 512

#: decayed-running-absmax rate
EMA_DECAY = 0.99

#: absmax floor: an all-zero group (fresh slot) still gets a positive
#: scale, so requantization never divides by zero
EPS_AMAX = 1e-30

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8, "fp8": torch.float8_e4m3fn}


def is_quantized(state_dtype: str) -> bool:
    """True for the scale-carrying dtypes (int8/fp8); bf16 is a plain
    storage cast and f32 the unquantized baseline."""
    if state_dtype not in STATE_DTYPES:
        raise KeyError(
            f"unknown state_dtype {state_dtype!r}; one of {STATE_DTYPES}")
    return state_dtype in ("int8", "fp8")


def storage_dtype(state_dtype: str) -> torch.dtype:
    """Torch dtype the state payload is stored as."""
    if state_dtype not in STATE_DTYPES:
        raise KeyError(
            f"unknown state_dtype {state_dtype!r}; one of {STATE_DTYPES}")
    return _STORAGE[state_dtype]


def qmax(state_dtype: str) -> float:
    """Largest code magnitude the absmax is mapped to."""
    return {"int8": 127.0, "fp8": 448.0}[state_dtype]


def n_groups(d: int) -> int:
    """Number of channel-scale groups of a d-channel state tensor."""
    return max(1, math.ceil(d / D_BLOCK))


def encode(x, state_dtype: str):
    """f32 values already divided by their scale -> storage codes."""
    if state_dtype == "int8":
        return torch.clamp(torch.round(x), -127.0, 127.0).to(torch.int8)
    return x.to(torch.float8_e4m3fn)


def update_scale(amax, prev_scale, state_dtype: str):
    """Decayed-running-absmax scale update.  ``amax`` is this step's
    absmax per group; ``prev_scale`` (or None: cold start) the scale the
    group was last stored with.  All in f32, as ``repro`` computes it."""
    qm = qmax(state_dtype)
    if prev_scale is not None:
        amax = torch.maximum(amax, EMA_DECAY * (prev_scale * qm))
    return torch.clamp(amax, min=EPS_AMAX) / qm


def _group_h(x):
    """(..., d, n) -> (..., g, blk, n) with zero padding; blk = group."""
    *lead, d, n = x.shape
    g = n_groups(d)
    blk = min(D_BLOCK, d) if g == 1 else D_BLOCK
    pad = g * blk - d
    if pad:
        x = torch.cat([x, x.new_zeros(*lead, pad, n)], dim=-2)
    return x.reshape(*lead, g, blk, n), d


def quantize_h(h, state_dtype: str, prev_scale=None):
    """Quantize an SSM state (..., d, n) -> (payload, scale (..., g)).
    ``prev_scale`` feeds the running-absmax update; None is a cold start
    (prefill of a fresh slot) and uses the step's own absmax."""
    grouped, d = _group_h(h.float())
    amax = grouped.abs().amax(dim=(-2, -1))                  # (..., g)
    scale = update_scale(amax, prev_scale, state_dtype)
    codes = encode(grouped / scale[..., None, None], state_dtype)
    *lead, g, blk, n = codes.shape
    return codes.reshape(*lead, g * blk, n)[..., :d, :].contiguous(), scale


def dequantize_h(q, scale):
    """Inverse of quantize_h (up to rounding): (..., d, n) f32."""
    grouped, d = _group_h(q.float())
    out = grouped * scale[..., None, None]
    *lead, g, blk, n = out.shape
    return out.reshape(*lead, g * blk, n)[..., :d, :]


# ---------------------------------------------------------------------------
# Matrix memory (xLSTM C): (..., r, c) payload, (..., r) scales -- one scale
# per matrix row (``repro/core/state_quant.py:151``).  Rows of C are written
# by different keys, so their magnitudes span decades; per-row scales keep
# the relative error uniform.
# ---------------------------------------------------------------------------

def quantize_mat(x, state_dtype: str, prev_scale=None):
    """Quantize (..., r, c) -> (payload, scale (..., r)); the running
    absmax of ``update_scale`` per row."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = update_scale(amax, prev_scale, state_dtype)
    return encode(xf / scale[..., None], state_dtype), scale


def dequantize_mat(q, scale):
    """Inverse of quantize_mat (up to rounding): (..., r, c) f32."""
    return q.float() * scale[..., None]
