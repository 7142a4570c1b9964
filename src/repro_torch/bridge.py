"""Move parameter and cache trees between ``repro`` and the port.

Both sides are plain nested dicts; the bridge takes ``repro``'s trees as
numpy arrays (``np.asarray`` of each leaf of ``sharding.tree_values``),
so it needs neither JAX nor ``repro``.  The layouts agree leaf for leaf
except the layer stack: ``repro`` stacks each layer parameter on a
leading L axis (``p["layers"][name]`` of shape (L, ...)), the port keeps
a list of per-layer dicts; jamba's ``p["groups"]["pos{i}"]`` subtrees
are stacked on a leading group axis there and are a list of per-group
dicts ``p["groups"][g]["pos{i}"]`` here.  xLSTM's ``p["layers"]`` is a
python list of ``{"mlstm": ...}`` / ``{"slstm": ...}`` dicts on both
sides (its layers differ in kind), so it maps entry for entry.  Cache
trees agree as they are, lists included.

numpy has no bfloat16 or float8_e4m3fn: a ``repro`` array of either
dtype (ml_dtypes) is widened to float32 on the way in and cast back in
torch, and on the way out such a tensor becomes a float32 array that
the caller narrows again.  Both are lossless: every bfloat16 and every
e4m3 value is exact in float32.  Quantized trees need nothing more:
int8 payloads and their f32 scale leaves (``w_scale``, ``A_q`` /
``A_scale``, the cache's ``h_scale``) map leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.registry import tree_leaves, tree_map


#: ml_dtypes names numpy lacks -> the torch dtype they arrive as
_WIDENED = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}


def _tensor(a, device):
    """A copy of ``a`` as a tensor (JAX hands out read-only arrays)."""
    a = np.asarray(a)
    if a.dtype.name in _WIDENED:
        return torch.tensor(a.astype(np.float32), device=device).to(
            _WIDENED[a.dtype.name])
    return torch.tensor(a, device=device)


def _array(t):
    t = t.detach().cpu()
    if t.dtype in _WIDENED.values():
        t = t.float()
    return t.numpy()


def to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same tree of tensors."""
    return tree_map(lambda a: _tensor(a, device), tree)


def to_numpy(tree):
    return tree_map(_array, tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


#: the keys of the stacked subtree: layers (mamba), groups (jamba)
_STACKED = ("layers", "groups")
#: the keys of a layer of a python-list stack (xLSTM's cell kinds)
_LISTED = ("mlstm", "slstm")


def _listed(layers) -> bool:
    """True for a per-layer list that ``repro`` keeps as a list too."""
    return (isinstance(layers, (list, tuple)) and len(layers) > 0
            and isinstance(layers[0], dict)
            and any(k in layers[0] for k in _LISTED))


def params_from_repro(tree, device="cpu"):
    """``repro`` param tree (numpy leaves, stacked layers or groups, or
    xLSTM's list of layers) -> port tree."""
    out = to_torch(tree, device)
    for key in _STACKED:
        if key in out and isinstance(out[key], dict):
            stacked = out[key]
            n = tree_leaves(stacked)[0].shape[0]
            out[key] = [tree_map(lambda t, i=i: t[i], stacked)
                        for i in range(n)]
    return out


def params_to_repro(params):
    """Port param tree -> ``repro``'s layout with numpy leaves."""
    out = {k: to_numpy(v) for k, v in params.items() if k not in _STACKED}
    for key in _STACKED:
        if key in params:
            layers = [to_numpy(lp) for lp in params[key]]
            out[key] = layers if _listed(params[key]) else _stack(layers)
    return out


cache_from_repro = to_torch
cache_to_repro = to_numpy
