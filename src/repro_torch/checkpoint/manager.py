"""Checkpoint manager (port of ``repro/checkpoint/manager.py``): async
save, atomic publish, keep-last-k, restore into a template tree.

Format, ``repro``'s: one directory per step, ``step_%012d/``, holding

  * ``meta.json``  — step, and per leaf path its shape and dtype name;
  * ``arrays.npz`` — the leaves as numpy arrays keyed by their path.

A path joins the keys from the root with "/": a dict's key, a list's or
tuple's index, a NamedTuple's field name (``AdamWState``'s "step", "mu",
"nu") and a ``QTensor``'s "0" (codes) and "1" (scales), as ``repro``'s
pytree paths name them.  Leaves whose dtype numpy lacks (bfloat16, the
fp8 types) are stored as raw bytes under their dtype's name and decoded
through a torch view, so neither side needs ``ml_dtypes``.

Writes go to ``<dir>/tmp.<step>`` and are renamed into place (rename is
atomic on POSIX), so readers see only complete checkpoints.  ``save``
copies the leaves to host memory before it returns; the file is written
on a worker thread, one in flight; ``wait()`` joins it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.quantized_state import QTensor

#: torch dtypes stored as raw bytes, by the name meta.json gives them
_RAW = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2}
_RAW_NAMES = {v: k for k, v in _RAW.items()}


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, QTensor):
        return [("0", node.q), ("1", node.scale)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix="") -> dict:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(template, leaf_fn, prefix=""):
    """``template``'s structure with each leaf ``leaf_fn(path, leaf)``."""
    kids = _children(template)
    if kids is None:
        return leaf_fn(prefix, template)
    vals = [_rebuild(v, leaf_fn, f"{prefix}/{k}" if prefix else k)
            for k, v in kids]
    if isinstance(template, dict):
        return dict(zip(template.keys(), vals))
    if isinstance(template, QTensor):
        return QTensor(vals[0], vals[1], template.shape)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*vals)
    return type(template)(vals)


def _to_host(t) -> tuple[np.ndarray, str, list]:
    """(the array npz stores, the dtype name and the shape meta.json
    records).  Always a copy: a CPU leaf's ``.cpu()`` would share the
    storage that the optimizer then overwrites in place while the worker
    thread writes."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype in _RAW_NAMES:
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return raw, _RAW_NAMES[t.dtype], list(t.shape)
    a = t.numpy()
    return a, str(a.dtype), list(a.shape)


def _decode(raw: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name in _RAW:
        return torch.from_numpy(raw.copy()).view(_RAW[dtype_name]).reshape(
            shape)
    return torch.from_numpy(np.array(raw, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot to host memory synchronously, write asynchronously."""
        host = {k: _to_host(v)
                for k, v in _flatten_with_paths(tree).items()}
        self.wait()                                          # one in flight
        if self.async_save and not blocking:
            self._pending = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._pending.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: dict):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:012d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _, _) in host.items()})
        meta = {"step": step,
                "leaves": {k: {"shape": shape, "dtype": name}
                           for k, (_, name, shape) in host.items()}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any,
                step: Optional[int] = None) -> tuple[Any, int]:
        """Restore into the structure of ``template``: each leaf cast to
        the template leaf's dtype, on its device, requiring grad where it
        does.  Returns (tree, step)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            def leaf(key, tmpl):
                info = meta["leaves"][key]
                t = _decode(data[key], info["dtype"], tuple(info["shape"]))
                tmpl = torch.as_tensor(tmpl)
                t = t.to(device=tmpl.device, dtype=tmpl.dtype)
                return t.requires_grad_(tmpl.requires_grad)

            tree = _rebuild(template, leaf)
        return tree, step
