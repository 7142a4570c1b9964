"""AdamW with selectable moment precision, f32 | bf16 | int8 (port of
``repro/optim/adamw.py``).

The math is ``repro``'s, leaf for leaf: global-norm clip, f32 moment
update, bias correction, decoupled weight decay on leaves of two or
more dimensions only, and the moments stored back in their dtype (int8
as power-law block codes, ``MU_POWER`` / ``NU_POWER``).  ``repro``'s
update is functional; here the params are updated in place under
``torch.no_grad()`` (leaves that require grad keep their identity, so
autograd and the caller's references stay valid), with the values of
the functional update, and the moments are new tensors in a new
``AdamWState``.  Trees are the port's nested dicts and lists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.registry import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import quantized_state as qs


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak lr (schedule multiplies)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # float32 | bfloat16 | int8


class AdamWState(NamedTuple):
    step: torch.Tensor               # 0-dim int32
    mu: Any
    nu: Any


MOMENT_DTYPES = ("float32", "bfloat16", "int8")

#: power-law exponents for int8 moments (8-bit-Adam style): mu is signed
#: and mildly heavy-tailed (p=2); nu spans decades (p=4).
MU_POWER = 2.0
NU_POWER = 4.0


def _encode(x, dtype, power=1.0):
    if dtype == "int8":
        return qs.quantize(x, power=power)
    return x.to(getattr(torch, dtype))


def _decode(x, power=1.0):
    if qs.is_qtensor(x):
        return qs.dequantize(x, power=power)
    return x.float()


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    if cfg.moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"unknown moment dtype {cfg.moment_dtype!r}")

    def z(power):
        return lambda p: _encode(torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device),
                                 cfg.moment_dtype, power)

    device = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(z(MU_POWER), params),
                      tree_map(z(NU_POWER), params))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global L2 norm of at most ``max_norm``, in f32;
    the norm before clipping)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_unflatten(grads, [g.float() * scale for g in leaves]), gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr_scale=1.0):
    """Returns (params, new_state, metrics); ``params`` are updated in
    place and returned."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=t.device)
    new_m, new_v = [], []
    for g, m_enc, v_enc, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                                  tree_leaves(state.nu), tree_leaves(params)):
        m = cfg.b1 * _decode(m_enc, MU_POWER) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v_enc, NU_POWER) + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:                      # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        new_m.append(_encode(m, cfg.moment_dtype, MU_POWER))
        new_v.append(_encode(v, cfg.moment_dtype, NU_POWER))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, tree_unflatten(state.mu, new_m),
                              tree_unflatten(state.nu, new_v)), metrics
