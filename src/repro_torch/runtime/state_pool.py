"""Slot-based decode-state pool (port of ``repro/runtime/state_pool.py``:
the scratch slots and the fork of speculative decoding, the tagged forks
of best-of-n and the pins of infinite-stream sessions).

A Mamba sequence's decode state is a fixed O(d_inner * d_state) block per
layer plus the (k-1)-tap conv tail, so a fixed-shape pool holds one slot
per in-flight sequence: admission scatters a prefilled state into a free
slot, eviction scatters the init state back, and the decode batch never
changes shape.  The pool's tensors are updated in place (``index_copy_``)
where ``repro`` rebinds functional copies, which keeps one pool's worth of
memory.  An int8/fp8 state's group scales (``h_scale``) are a cache leaf
like any other, so every slot operation moves them with their payload and
an evicted slot gets zero scales back.

Scratch slots are extra rows after the live ones (ids ``n_slots`` to
``n_total - 1``): a speculative pass leases one per live slot, forks the
live slot's state and sampling params into it, drafts there and releases
it after the verify.  They are outside the live accounting (alloc,
evict, n_free, active_*), and their ids never meet a live slot's.

A pinned slot holds an infinite-stream session's open-ended lease:
``evict`` refuses it until ``unpin``, and the SLO scheduler leaves it out
of the capacity it projects with.

Under a tensor-parallel mesh (``mesh``, ``rules``) every rank's pool holds
its shard of each cache leaf (``sharding.shard_cache``: a leaf the rules
split over the mesh at its shard shape, the others in full).  Slot axes
are never split, so every slot operation is rank-local and the same on
every rank.  ``state_bytes_per_slot`` stays the unsharded number;
``device_state_bytes_per_slot`` counts what one rank holds.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.parallel import sharding
from repro_torch.runtime import sampling


class SlotStatePool:
    """Fixed-capacity pool of per-slot decode state for one config.
    ``cache`` is a tree of tensors (flat for mamba, nested for jamba and
    xLSTM) whose slot axis (``registry.cache_slot_axes``) has ``n_total
    = n_slots + n_scratch`` entries."""

    def __init__(self, cfg, n_slots: int, max_seq: int, dtype=None,
                 device="cpu", n_scratch: int = 0, mesh=None, rules=None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if n_scratch < 0:
            raise ValueError("n_scratch must be >= 0")
        self.cfg = cfg
        self.n_slots = n_slots
        self.n_scratch = n_scratch
        self.n_total = n_slots + n_scratch
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.mesh = mesh
        self.rules = rules
        self.cache = self._local(registry.init_cache(
            cfg, self.n_total, max_seq, dtype, self.device))
        # the init state of one slot: eviction scatters this back
        self._fresh = self._local(registry.init_cache(cfg, 1, max_seq, dtype,
                                                      self.device))
        # the unsharded pool's leaves, shapes only
        self._full = registry.abstract_cache(cfg, self.n_total, max_seq,
                                             dtype)
        self.params = sampling.SlotParams(self.n_total)
        self._free: list[int] = list(range(n_slots))
        self._scratch_free: list[int] = list(range(n_slots, self.n_total))
        self._active: list[bool] = [False] * self.n_total
        self._pinned: list[bool] = [False] * self.n_total

    def _local(self, cache):
        if self.mesh is None:
            return cache
        return sharding.shard_cache(self.cfg, cache, self.mesh, self.rules)

    @property
    def fresh(self):
        """The batch-1 init-state cache (prefill scratch)."""
        return self._fresh

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def active_slots(self) -> list[int]:
        return [i for i, a in enumerate(self._active) if a]

    def active_mask(self) -> np.ndarray:
        return np.asarray(self._active, bool)

    def alloc(self) -> Optional[int]:
        """Reserve a free slot id (lowest first), or None when full."""
        if not self._free:
            return None
        slot = min(self._free)
        self._free.remove(slot)
        self._active[slot] = True
        return slot

    @property
    def n_pinned(self) -> int:
        return sum(self._pinned)

    def pin(self, slot: int) -> None:
        """Mark an active slot as an eviction-free lease (a session):
        ``evict`` refuses it until ``unpin``."""
        assert self._active[slot], f"slot {slot} not active"
        self._pinned[slot] = True

    def unpin(self, slot: int) -> None:
        self._pinned[slot] = False

    def is_pinned(self, slot: int) -> bool:
        return self._pinned[slot]

    @property
    def n_scratch_free(self) -> int:
        return len(self._scratch_free)

    def lease_scratch(self) -> Optional[int]:
        """Reserve a scratch slot id (lowest first), or None when none is
        free.  Its state is what the last lease left: fork into it before
        reading it."""
        if not self._scratch_free:
            return None
        slot = min(self._scratch_free)
        self._scratch_free.remove(slot)
        return slot

    def release_scratch(self, slot: int) -> None:
        """Return a leased scratch slot (no reset: a fork overwrites every
        leaf of it before the next lease reads it)."""
        if not self.n_slots <= slot < self.n_total:
            raise ValueError(f"{slot} is not a scratch slot id")
        if slot in self._scratch_free:
            raise ValueError(f"scratch slot {slot} is not leased")
        self._scratch_free.append(slot)

    def fork(self, src: Sequence[int], dst: Sequence[int],
             branch_tags: Optional[Sequence[Optional[int]]] = None) -> None:
        """Copy the state of slots ``src[i]`` into ``dst[i]``, in place,
        with their sampling params: payloads and their scales are all
        cache leaves, so they move together.  ``branch_tags`` (one per
        dst) re-seeds the destinations: a truthy tag t gives best-of-n
        branch t its own stream (``sampling.branch_seed``); None or 0
        copies the seed verbatim, as a speculative draft needs."""
        if len(src) != len(dst):
            raise ValueError("fork src/dst length mismatch")
        if branch_tags is not None and len(branch_tags) != len(dst):
            raise ValueError("fork branch_tags/dst length mismatch")
        if not src:
            return
        registry.scatter_slots(
            self.cfg, self.cache,
            registry.gather_slots(self.cfg, self.cache, self._ids(src)),
            self._ids(dst))
        self.params.copy(src, dst, tags=branch_tags)

    def _ids(self, slots) -> torch.Tensor:
        return torch.as_tensor(list(slots), dtype=torch.int64,
                               device=self.device)

    def admit(self, slot: int, sub_cache) -> None:
        """Scatter a batch-1 prefilled cache into ``slot`` (from alloc)."""
        assert self._active[slot], f"slot {slot} not allocated"
        registry.scatter_slots(self.cfg, self.cache, sub_cache,
                               self._ids([slot]))

    def as_slot(self, sub_cache):
        """A batch-1 cache in the pool's leaf dtypes, as ``admit`` would
        store it (xLSTM's prefill hands its conv tail back in the model
        dtype, the pool keeps it in f32): what a snapshot outside the
        pool must hold for K3 to step it."""
        return registry.tree_zip(lambda ax, t, ref: t.to(ref.dtype),
                                 registry.cache_slot_axes(self.cfg),
                                 sub_cache, self._fresh)

    def evict(self, slot: int) -> None:
        """Reset ``slot`` to the init state and free it: a later
        admission can never observe a previous request's state.  A
        pinned slot (a session's lease) is refused."""
        assert self._active[slot], f"slot {slot} not active"
        if self._pinned[slot]:
            raise RuntimeError(
                f"slot {slot} holds an eviction-free lease (pinned "
                "session): unpin before evicting")
        registry.scatter_slots(self.cfg, self.cache, self._fresh,
                               self._ids([slot]))
        self.params.clear(slot)
        self._active[slot] = False
        self._free.append(slot)

    def read(self, slots: Sequence[int]):
        """Gather a sub-cache for ``slots`` (testing/debug)."""
        return registry.gather_slots(self.cfg, self.cache, self._ids(slots))

    def commit(self, new_cache, active: Optional[np.ndarray] = None) -> None:
        """Accept a post-decode cache, keeping inactive slots frozen."""
        if active is None:
            active = self.active_mask()
        self.cache = registry.mask_slots(
            self.cfg, self.cache, new_cache,
            torch.as_tensor(active, device=self.device))

    @staticmethod
    def _bytes(cache) -> int:
        return sum(t.numel() * t.element_size()
                   for t in registry.tree_leaves(cache))

    def state_bytes_per_slot(self) -> int:
        """Device bytes one slot occupies across every cache leaf:
        quantized payloads at their storage width, their f32 scales
        included (jamba's KV strips at max_seq).  Under a mesh, the
        unsharded number (the whole slot, over all ranks' shards)."""
        return self._bytes(self._full) // self.n_total

    def device_state_bytes_per_slot(self) -> int:
        """The bytes one slot occupies on one rank: a leaf the mesh
        splits at its shard shape, a replicated one in full
        (``repro``'s per-device count).  Without a mesh it equals
        ``state_bytes_per_slot``."""
        return self._bytes(self.cache) // self.n_total

    def device_slots_per_gb(self) -> float:
        """Slot capacity per GiB of one rank's decode-state memory."""
        return (1 << 30) / max(1, self.device_state_bytes_per_slot())

    def slots_per_gb(self) -> float:
        """Slot capacity per GiB of decode-state memory (the capacity
        axis cfg.state_dtype multiplies)."""
        return (1 << 30) / max(1, self.state_bytes_per_slot())
