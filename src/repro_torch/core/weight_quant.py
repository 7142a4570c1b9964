"""Quantized weight storage (cfg.weight_dtype="int8"): W8A8 decode.

The port's copy of ``repro/core/weight_quant.py``.  Single-token decode
is memory-bound, so the dense projection matrices and mamba's A are
stored int8 with f32 absmax scales and dequantized where they are
consumed: inside the decode-step kernels for A, in ``blocks.dense`` for
the projections.  The serving engine keeps the caller's f32 tree for
prefill (compute-bound, touches the weights once per request) and
serves decode from the int8 tree.

A quantized payload's f32 scale is a sibling leaf: ``w`` gets
``w_scale``, mamba's ``A_log`` becomes ``A_q`` + ``A_scale``.  Dense
``w`` (d_in, d_out) has one scale per output column; A = -exp(A_log)
(d_inner, d_state) one per row (per d_inner channel, the decode
kernels' channel blocking).  Weights are static: one-shot absmax.
"""
from __future__ import annotations

import torch

#: storage dtypes accepted by cfg.weight_dtype
WEIGHT_DTYPES = ("f32", "int8")

#: largest int8 code magnitude the absmax is mapped to (symmetric)
QMAX = 127.0

#: absmax floor: an all-zero column still gets a positive scale
EPS_AMAX = 1e-30

#: param subtrees the quantization walk does not descend into: the
#: embeddings are consumed as raw matrices (the tied unembed transposes
#: ``embed["tok"]``), and MoE experts and the router index their dicts
SKIP_KEYS = frozenset({"embed", "unembed", "moe", "router"})


def is_quantized(weight_dtype: str) -> bool:
    """True for the scale-carrying dtypes; f32 is the baseline."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise KeyError(
            f"unknown weight_dtype {weight_dtype!r}; one of {WEIGHT_DTYPES}")
    return weight_dtype == "int8"


# ---------------------------------------------------------------------------
# Dense matrices: (..., d_in, d_out) payload, (..., d_out) scales
# ---------------------------------------------------------------------------

def quantize_w(w):
    """Per-output-channel symmetric absmax: (..., d_in, d_out) ->
    (int8 codes, f32 scale (..., d_out))."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = torch.clamp(amax, min=EPS_AMAX) / QMAX
    codes = torch.clamp(torch.round(wf / scale[..., None, :]),
                        -QMAX, QMAX).to(torch.int8)
    return codes, scale


def dequantize_w(q, scale):
    """Inverse of quantize_w (up to rounding): (..., d_in, d_out) f32."""
    return q.float() * scale[..., None, :]


# ---------------------------------------------------------------------------
# Row-scaled matrices (mamba A): (..., r, c) payload, (..., r) scales
# ---------------------------------------------------------------------------

def quantize_rows(x):
    """Per-row symmetric absmax over the last axis: (..., r, c) ->
    (int8 codes, f32 scale (..., r))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=EPS_AMAX) / QMAX
    codes = torch.clamp(torch.round(xf / scale[..., None]),
                        -QMAX, QMAX).to(torch.int8)
    return codes, scale


def dequantize_rows(q, scale):
    """Inverse of quantize_rows (up to rounding), f32.  This is the one
    scale multiply: the decode kernels' in-kernel dequant
    (``__fmul_rn(code, scale)``), the plain versions and the prefill path
    all compute exactly ``code_f32 * scale``, so every path sees
    bit-identical A values."""
    return q.float() * scale[..., None]


# ---------------------------------------------------------------------------
# Param-tree transform
# ---------------------------------------------------------------------------

def _dense_like(node):
    """A blocks.dense param dict: {"w": (..., d_in, d_out)} (+ "b")."""
    return (isinstance(node, dict) and "w" in node
            and set(node) <= {"w", "b"} and node["w"].dim() >= 2)


def quantize_tree(params):
    """Quantize every dense projection (and mamba A) of a param tree
    (nested dicts and lists of tensors).  Subtrees under ``SKIP_KEYS``
    and other leaves (norms, biases, convs) pass through at f32.  Raises
    on a tree that is already quantized: quantizing twice would destroy
    the weights."""
    def rec(node):
        if isinstance(node, dict):
            if "w_scale" in node or "A_q" in node:
                raise ValueError(
                    "param tree is already weight-quantized "
                    "(found w_scale/A_q leaves)")
            if _dense_like(node):
                q, s = quantize_w(node["w"])
                out = {"w": q, "w_scale": s}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            out = {}
            for k, v in node.items():
                if k in SKIP_KEYS:
                    out[k] = v
                elif k == "A_log":
                    out["A_q"], out["A_scale"] = quantize_rows(
                        -torch.exp(v.float()))
                else:
                    out[k] = rec(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node

    return rec(params)
