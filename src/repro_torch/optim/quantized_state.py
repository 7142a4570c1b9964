"""Blockwise 8-bit state quantization, 8-bit-Adam style (port of
``repro/optim/quantized_state.py``): symmetric codes per contiguous block
of ``BLOCK`` elements of the flattened tensor, linear or power-law, with
an f32 scale per block.  Int8 Adam moments cut optimizer memory about 4x
against f32."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 256


class QTensor:
    """int8 payload (n_blocks, BLOCK) + per-block f32 scales (n_blocks, 1);
    ``shape`` the original shape.  A checkpoint stores its two tensors
    under the keys "0" and "1", as ``repro``'s pytree node flattens."""
    __slots__ = ("q", "scale", "shape")

    def __init__(self, q, scale, shape):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)

    def __repr__(self):
        return f"QTensor(shape={self.shape}, blocks={self.q.shape[0]})"


def quantize(x: torch.Tensor, power: float = 1.0) -> QTensor:
    """power=1: linear.  power>1: power-law code — code = round(127 *
    sign(u) * |u|^(1/power)) with u = x / absmax, which resolves small
    entries ~127^(power-1) times finer (Adam's second moment spans
    decades within a block)."""
    shape = x.shape
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    absmax = torch.clamp(flat.abs().amax(dim=1, keepdim=True), min=1e-30)
    u = flat / absmax
    if power != 1.0:
        u = torch.sign(u) * u.abs() ** (1.0 / power)
    q = torch.clamp(torch.round(u * 127.0), -127, 127).to(torch.int8)
    # absmax/127 for the linear code (its decode is one multiply)
    if power == 1.0:
        return QTensor(q, absmax * float(np.float32(1 / 127.0)), shape)
    return QTensor(q, absmax, shape)


def dequantize(t: QTensor, power: float = 1.0) -> torch.Tensor:
    if power == 1.0:
        flat = t.q.float() * t.scale
    else:
        u = t.q.float() / 127.0
        flat = torch.sign(u) * u.abs() ** power * t.scale
    n = 1
    for s in t.shape:
        n *= s
    return flat.reshape(-1)[:n].reshape(t.shape)


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)
