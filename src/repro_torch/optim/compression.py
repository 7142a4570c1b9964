"""Int8 error-feedback gradient compression (port of
``repro/optim/compression.py``): int8 with one per-tensor scale, the
quantization residual kept and re-added the next step (EF-SGD), which
keeps convergence.

``ef_compress_decompress`` is the lossy channel with its residual
bookkeeping over one tensor, ``ef_apply`` the same over a gradient tree.
``compressed_psum`` (quantize, int32 all-reduce, dequantize) needs a
collective across devices and waits for the port of the parallel layer
(ROADMAP A13)."""
from __future__ import annotations

import torch

from repro_torch.models.registry import tree_leaves, tree_map, tree_unflatten


def _quant(x):
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress_decompress(g, err):
    """Returns (g_hat, new_err): g_hat = Q(g + err), new_err = g + err -
    g_hat."""
    x = g.float() + err
    q, scale = _quant(x)
    g_hat = q.float() * scale
    return g_hat, x - g_hat


def ef_init(grads):
    """Zero residuals shaped as ``grads`` (a nested dict/list tree)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def ef_apply(grads, err_state):
    """Tree version: compress every leaf with error feedback.  Returns
    (g_hat tree, new residual tree)."""
    outs = [ef_compress_decompress(g, e) for g, e in
            zip(tree_leaves(grads), tree_leaves(err_state))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def compressed_psum(x, axis_name: str):
    raise NotImplementedError(
        "compressed_psum needs a collective across devices: it waits for "
        "the port of the parallel layer (ROADMAP A13)")
