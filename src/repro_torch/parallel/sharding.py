"""Logical-axis sharding for tensor-parallel serving: the port of
``repro/parallel/sharding.py`` over ``torch.distributed``.

Params and cache leaves carry *logical* axis names (``registry.param_axes``
/ ``registry.cache_axes``, the same names ``repro`` gives them); the rules
map each name onto mesh axes, and ``spec_for_shape`` keeps, dim by dim,
the greedy prefix of those mesh axes whose size divides the dim — so the
port shards exactly the leaves ``repro`` shards, at the same shard shapes.

``repro``'s mesh is single-controller: GSPMD places each leaf and inserts
the collectives.  The port is multi-controller (SPMD): every rank runs
the same engine on the same calls, holds its own shard of each sharded
leaf (``shard_params`` / ``shard_cache`` cut it from the full tree), and
the models call the collectives below where a contraction or an output
spans ranks.  Each collective is a plain function over the active mesh's
group with a per-name counter (``COUNTS``); with no mesh active (a
single-device engine) the models call none of them.

A fused projection whose output is the concatenation of ``parts``
equal pieces (mamba's in_proj ``[x | z]``, the mLSTM's up ``[u | g]``,
the sLSTM's four gates) declares its axes as ``Fused(axes, parts)`` and
is cut piecewise: rank r holds shard r of every piece, so its local
output splits into the same pieces at the local width.  The shard shape
is ``spec_for_shape``'s; only which columns a rank holds differs from a
contiguous cut.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-name -> mesh-axis mapping. None = replicated."""
    vocab: Any = "model"
    embed: Any = "data"          # FSDP; set None to replicate params over data
    heads: Any = "model"
    kv: Any = "model"
    ffn: Any = "model"
    expert: Any = "model"
    layers: Any = None
    conv: Any = None
    state: Any = None
    act_batch: Any = ("pod", "data")
    act_seq: Any = None
    act_ffn: Any = "model"
    act_heads: Any = "model"
    act_embed: Any = None
    act_vocab: Any = "model"
    act_expert: Any = "model"

    def resolve(self, name, mesh_axes) -> Any:
        """Logical name -> mesh axis (dropping axes absent from the mesh)."""
        if name is None:
            return None
        target = getattr(self, name)
        if target is None:
            return None
        if isinstance(target, (tuple, list)):
            kept = tuple(t for t in target if t in mesh_axes)
            return kept if kept else None
        return target if target in mesh_axes else None


#: Rules for long-context batch=1 decode: shard along sequence instead.
LONG_CONTEXT_OVERRIDES = dict(act_batch=None, act_seq="data")


class Fused(tuple):
    """The logical axes of a fused projection's leaf, whose sharded dim
    is the concatenation of ``parts`` equal pieces.  It equals, and is
    read everywhere as, the plain tuple of names; only ``shard_leaf``
    reads ``parts``."""

    def __new__(cls, axes, parts: int):
        self = super().__new__(cls, axes)
        self.parts = parts
        return self


def fused(axes, parts: int) -> tuple:
    """``axes`` as a ``Fused`` leaf of ``parts`` pieces (plain for 1)."""
    return Fused(axes, parts) if parts > 1 else tuple(axes)


def parts_of(axes) -> int:
    """The number of pieces of a leaf declared with ``fused`` (else 1)."""
    return getattr(axes, "parts", 1)


class Spec(tuple):
    """Per-dim placement: None (replicated), a mesh axis name, or a tuple
    of mesh axis names (major first) — ``PartitionSpec``'s entries, a
    one-axis tuple written as the axis, as ``PartitionSpec`` writes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def logical_to_spec(axes, mesh=None, rules=None) -> Spec:
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return Spec()
    mesh_axes = set(mesh.axis_names)
    return Spec(*(rules.resolve(a, mesh_axes) for a in axes))


def spec_for_shape(shape, axes, mesh, rules=None) -> Spec:
    """Shape-aware spec: for each dim keep the greedy prefix of mesh axes
    that divides it (a 4-head xLSTM param under an 8-way "model" axis
    falls back to replicated), as ``repro``'s ``spec_for_shape``."""
    rules = rules or ShardingRules()
    mesh_axes = set(mesh.axis_names)
    entries = []
    for dim, name in zip(shape, axes):
        t = rules.resolve(name, mesh_axes)
        if t is None:
            entries.append(None)
            continue
        axs = t if isinstance(t, tuple) else (t,)
        chosen, size = [], 1
        for a in axs:
            if dim % (size * mesh.shape[a]) == 0:
                chosen.append(a)
                size *= mesh.shape[a]
            else:
                break
        entries.append(tuple(chosen) if len(chosen) > 1
                       else (chosen[0] if chosen else None))
    return Spec(*entries)


def _walk(tree, path=()):
    """(path, leaf) pairs of a nested dict/list tree, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not _is_leaf_tuple(tree):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _is_leaf_tuple(x) -> bool:
    """A tuple of logical names or of dims: a leaf of an axes or shape
    tree, not a subtree."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, int, type(None))) for e in x)


def keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def validate_divisibility(shapes, axes, mesh, rules=None, warn=print):
    """Report dims not divisible by their mesh-axis size (``repro``'s
    ``validate_divisibility`` over a tree of shapes — tensors or shape
    tuples — and a congruent tree of logical axes).  Returns
    [(path, dim, logical name, shards)]."""
    rules = rules or ShardingRules()
    ax_leaves = dict(_walk(axes))
    bad = []
    for path, leaf in _walk(shapes):
        shape = tuple(getattr(leaf, "shape", leaf))
        for dim, name in zip(shape, ax_leaves[path]):
            tgt = rules.resolve(name, set(mesh.axis_names))
            if tgt is None:
                continue
            n = (math.prod(mesh.shape[t] for t in tgt)
                 if isinstance(tgt, tuple) else mesh.shape[tgt])
            if dim % n:
                bad.append((keystr(path), dim, name, int(n)))
    for b in bad:
        warn(f"[sharding] non-divisible: {b[0]} dim={b[1]} "
             f"logical={b[2]} shards={b[3]}")
    return bad


# ---------------------------------------------------------------------------
# Shards of leaves and trees
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of mesh axes (() for replicated)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_index(mesh, entry) -> tuple:
    """(this rank's shard index, shard count) along a dim placed on
    ``entry``: the mixed-radix index of its coordinates, major first."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return idx, n


def shard_shape(shape, axes, mesh, rules=None) -> tuple:
    """The per-rank shape of a leaf of ``shape`` under ``axes``."""
    spec = spec_for_shape(shape, axes, mesh, rules)
    return tuple(d // shard_index(mesh, e)[1] for d, e in zip(shape, spec))


def shard_leaf(t, axes, mesh, rules=None):
    """This rank's shard of the full tensor ``t`` (a contiguous copy that
    owns its memory, so the full tree can be freed).  ``Fused`` axes cut
    the sharded dim piecewise (see the module docstring); they apply to
    the one dim a fused projection's output lies on."""
    spec = spec_for_shape(t.shape, axes, mesh, rules)
    parts = parts_of(axes)
    out = t
    for dim, e in enumerate(spec):
        idx, n = shard_index(mesh, e)
        if n == 1:
            continue
        size = t.shape[dim]
        if parts > 1:
            if (size // parts) % n:
                raise ValueError(
                    f"a fused dim of {size} in {parts} pieces does not "
                    f"split {n} ways")
            w = size // parts // n
            pieces = out.unflatten(dim, (parts, size // parts))
            out = pieces.narrow(dim + 1, idx * w, w).flatten(dim, dim + 1)
        else:
            w = size // n
            out = out.narrow(dim, idx * w, w)
    return out.clone(memory_format=torch.contiguous_format)


def _zip_tree(fn, tree, axes):
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_tree(fn, v, axes[i]) for i, v in enumerate(tree)]
    return fn(tree, axes)


def shard_params(cfg, params, mesh, rules=None):
    """The rank's shard of a full param tree (f32 or int8 + scales), leaf
    by leaf under ``registry.param_axes``."""
    from repro_torch.models import registry
    rules = rules or ShardingRules()
    return _zip_tree(lambda t, a: shard_leaf(t, a, mesh, rules), params,
                     registry.param_axes(cfg))


def shard_cache(cfg, cache, mesh, rules=None):
    """The rank's shard of a full cache tree under ``registry.cache_axes``
    (a pooled cache, a prefill result, a snapshot)."""
    from repro_torch.models import registry
    rules = rules or ShardingRules()
    return _zip_tree(lambda t, a: shard_leaf(t, a, mesh, rules),
                     cache, registry.cache_axes(cfg))


# ---------------------------------------------------------------------------
# The active mesh: the engine installs its own around every model call
# ---------------------------------------------------------------------------

_CTX: dict = {"mesh": None, "rules": ShardingRules()}


def current_mesh():
    return _CTX["mesh"]


def current_rules() -> ShardingRules:
    return _CTX["rules"]


@contextlib.contextmanager
def use_mesh(mesh, rules=None):
    """Install (mesh, rules) for the models' collectives; ``mesh=None``
    is the single-device path, where the models call none."""
    old = (_CTX["mesh"], _CTX["rules"])
    _CTX["mesh"], _CTX["rules"] = mesh, rules or ShardingRules()
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["rules"] = old


def split_of(full: int, logical: str):
    """The spec entry a dim of size ``full`` named ``logical`` takes on
    the active mesh (None: replicated, or no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return spec_for_shape((full,), (logical,), mesh, current_rules())[0]


def local_range(full: int, logical: str) -> tuple:
    """(start, size) of this rank's slice of a dim of size ``full`` named
    ``logical``: (0, full) when it is replicated."""
    entry = split_of(full, logical)
    if entry is None:
        return 0, full
    idx, n = shard_index(current_mesh(), entry)
    return idx * (full // n), full // n


# ---------------------------------------------------------------------------
# Collectives over the active mesh, counted by name
# ---------------------------------------------------------------------------

#: collective calls by name since the last ``reset_counts``
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _group(entry):
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a collective needs an active mesh (use_mesh)")
    return mesh, mesh.group(entry_axes(entry))


def all_reduce_sum(x, entry="model"):
    """Sum of ``x`` over the ranks of ``entry``'s group (a row-parallel
    contraction's partial sums); in place on a contiguous ``x``, which
    is returned."""
    mesh, g = _group(entry)
    COUNTS["all_reduce_sum"] += 1
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def all_reduce_max(x, entry="model"):
    """Elementwise max over the group (a quantization group's absmax when
    the group straddles ranks); in place, as ``all_reduce_sum``."""
    mesh, g = _group(entry)
    COUNTS["all_reduce_max"] += 1
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


def all_gather_cat(x, dim: int = -1, entry="model"):
    """The ranks' ``x`` concatenated along ``dim`` in shard order (a
    vocab-parallel unembed's full logits)."""
    mesh, g = _group(entry)
    COUNTS["all_gather_cat"] += 1
    n = shard_index(mesh, entry)[1]
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(outs, x, group=g)
    return torch.cat(outs, dim=dim)


def broadcast(x, entry="model"):
    """``x`` as the group's first rank holds it, on every rank (the
    sampled tokens, so no rank's host state can drift); in place."""
    mesh, g = _group(entry)
    COUNTS["broadcast"] += 1
    x = x.contiguous()
    dist.broadcast(x, src=mesh.group_ranks(entry_axes(entry))[0], group=g)
    return x


def sum_partials(y, full: int, logical: str):
    """A row-parallel product's result: ``y`` holds this rank's partial
    sums over a contraction dim of ``full`` named ``logical``; where the
    active mesh splits that dim they are summed over its ranks (in f32,
    cast back to y's dtype), else ``y`` is returned as it is."""
    entry = split_of(full, logical)
    if entry is None:
        return y
    return all_reduce_sum(y.float(), entry).to(y.dtype)


def gather_cols(y, full: int, logical: str):
    """A column-parallel output made whole: ``y``'s last dim is this
    rank's slice of a dim of ``full`` named ``logical``; where the active
    mesh splits it the slices are concatenated in shard order."""
    entry = split_of(full, logical)
    if entry is None:
        return y
    return all_gather_cat(y, -1, entry)


def max_over(full: int, logical: str):
    """The elementwise-max collective over the ranks that split a dim of
    ``full`` named ``logical`` (the identity where none do): what a
    quantization group cut across ranks completes its absmax with."""
    entry = split_of(full, logical)
    if entry is None:
        return lambda x: x
    return lambda x: all_reduce_max(x, entry)
