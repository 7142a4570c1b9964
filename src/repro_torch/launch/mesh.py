"""Meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

``repro`` builds a ``jax.sharding.Mesh`` over the devices one controller
sees.  The port is multi-controller: one process per rank, each calling
the same constructor after the process group is up (``init_ranks``).
A ``Mesh`` lays the world's ranks out row-major over its axes, as
``jax.make_mesh`` lays out devices, and holds one process group per
subset of its axes (a collective over a dim placed on ("pod", "data")
runs in the group of ranks that differ only there).

It is the port's own class rather than ``torch.distributed``'s
``DeviceMesh``, which ties CUDA tensors to NCCL: two ranks sharing one
card cannot use NCCL, and run over gloo, whose ``all_reduce`` (sum and
max), ``all_gather`` and ``broadcast`` take CUDA tensors too (staged
through host memory; ``chip_smoke.py`` phase 2m checks each on the
card).

Production shapes as in ``repro``: single pod (data=16, model=16) = 256
ranks, multi-pod (pod=2, data=16, model=16) = 512.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import torch.distributed as dist


class Mesh:
    """A row-major layout of ``group``'s ranks (the default world) over
    named axes.  ``shape`` is a dict (``mesh.shape[axis]``, as
    ``sharding.spec_for_shape`` reads it), ``coords`` this rank's index
    on each axis."""

    def __init__(self, shape, axis_names, group=None):
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError("one size per axis name")
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs an initialized process group "
                "(launch.mesh.init_ranks, or torchrun)")
        self.world = group
        ranks = (list(range(dist.get_world_size())) if group is None
                 else dist.get_process_group_ranks(group))
        need = math.prod(shape)
        if len(ranks) != need:
            raise RuntimeError(
                f"mesh {dict(zip(axis_names, shape))} needs {need} ranks, "
                f"have {len(ranks)}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = need
        self.ranks = ranks
        self.backend = dist.get_backend(group)
        me = ranks.index(dist.get_rank())
        self.rank = me
        self.coords = dict(zip(axis_names, _unravel(me, shape)))
        # one group per non-empty subset of axes; every rank creates every
        # group in the same order, as new_group requires
        self._groups = {}
        self._group_ranks = {}
        for r in range(1, len(axis_names) + 1):
            for sub in itertools.combinations(axis_names, r):
                self._make_group(sub)

    def _make_group(self, sub):
        """Partition the mesh's ranks by their coordinates off ``sub``."""
        if len(sub) == len(self.axis_names):
            self._groups[sub] = self.world
            self._group_ranks[sub] = list(self.ranks)
            return
        shape = tuple(self.shape[a] for a in self.axis_names)
        buckets = {}
        for i, rank in enumerate(self.ranks):
            c = dict(zip(self.axis_names, _unravel(i, shape)))
            key = tuple(c[a] for a in self.axis_names if a not in sub)
            buckets.setdefault(key, []).append(rank)
        mine = tuple(self.coords[a] for a in self.axis_names
                     if a not in sub)
        for key in sorted(buckets):
            g = dist.new_group(buckets[key], backend=self.backend)
            if key == mine:
                self._groups[sub] = g
                self._group_ranks[sub] = buckets[key]

    def _canon(self, axes) -> tuple:
        # a dim's mesh axes (major first) name the same group as the
        # mesh-ordered subset of them
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of the ranks that differ only on ``axes``."""
        return self._groups[self._canon(axes)]

    def group_ranks(self, axes) -> list:
        """The global ranks of ``group(axes)``, in the group's order."""
        return self._group_ranks[self._canon(axes)]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, {self.backend})"


def _unravel(i, shape):
    out = []
    for s in reversed(shape):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def init_ranks(rank: int, world: int, store_path, backend: str = "gloo",
               timeout_s: float = 600.0) -> None:
    """Join a process group of ``world`` ranks through a ``FileStore`` at
    ``store_path`` (a file no other group uses; its directory must
    exist).  A file, not a TCP port: concurrent groups on one host (test
    workers) cannot collide on it."""
    store = dist.FileStore(os.fspath(store_path), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_serving_mesh(tp: int = 2, axis: str = "model",
                      group=None) -> Mesh:
    """1-D tensor-parallel mesh for the serving engine
    (``EngineConfig.mesh``): ``tp`` ranks on the "model" axis, so the
    default rules put the weights' ffn/heads/vocab dims and the pool's
    TP-interior cache leaves on it while slot axes stay replicated.
    Needs an initialized process group (``group``, else the world) of
    exactly ``tp`` ranks."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1; got {tp}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"serving mesh ({axis}={tp}) needs {tp} ranks, have 0: start "
            f"the ranks first (launch.mesh.init_ranks, or torchrun "
            f"--nproc-per-node {tp})")
    have = (dist.get_world_size() if group is None
            else len(dist.get_process_group_ranks(group)))
    if have != tp:
        raise RuntimeError(
            f"serving mesh ({axis}={tp}) needs {tp} ranks, have {have}: "
            f"start {tp} ranks (launch.mesh.init_ranks, or torchrun "
            f"--nproc-per-node {tp})")
    return Mesh((tp,), (axis,), group=group)


def make_local_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh over the world's ranks (tests)."""
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"need {need} ranks, have {have}")
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {have}; start them "
            f"with torchrun --nnodes ... --nproc-per-node ...")
    return Mesh(shape, axes)
