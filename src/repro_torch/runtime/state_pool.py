"""Slot-based decode-state pool (port of ``repro/runtime/state_pool.py``
with the scratch slots and the fork of speculative decoding; the pins of
infinite-stream sessions and the tagged forks of best-of-n are not
ported yet, ROADMAP A7).

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
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.runtime import sampling


class SlotStatePool:
    """Fixed-capacity pool of per-slot decode state for one config.
    ``cache`` is a tree of tensors (flat for mamba, nested for jamba and
    xLSTM) whose slot axis (``registry.cache_slot_axes``) has ``n_total
    = n_slots + n_scratch`` entries."""

    def __init__(self, cfg, n_slots: int, max_seq: int, dtype=None,
                 device="cpu", n_scratch: int = 0):
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
        self.cache = registry.init_cache(cfg, self.n_total, max_seq, dtype,
                                         self.device)
        # the init state of one slot: eviction scatters this back
        self._fresh = registry.init_cache(cfg, 1, max_seq, dtype,
                                          self.device)
        self.params = sampling.SlotParams(self.n_total)
        self._free: list[int] = list(range(n_slots))
        self._scratch_free: list[int] = list(range(n_slots, self.n_total))
        self._active: list[bool] = [False] * self.n_total

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

    def fork(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """Copy the state of slots ``src[i]`` into ``dst[i]``, in place,
        with their sampling params: payloads and their scales are all
        cache leaves, so they move together."""
        if len(src) != len(dst):
            raise ValueError("fork src/dst length mismatch")
        if not src:
            return
        registry.scatter_slots(
            self.cfg, self.cache,
            registry.gather_slots(self.cfg, self.cache, self._ids(src)),
            self._ids(dst))
        self.params.copy(src, dst)

    def _ids(self, slots) -> torch.Tensor:
        return torch.as_tensor(list(slots), dtype=torch.int64,
                               device=self.device)

    def admit(self, slot: int, sub_cache) -> None:
        """Scatter a batch-1 prefilled cache into ``slot`` (from alloc)."""
        assert self._active[slot], f"slot {slot} not allocated"
        registry.scatter_slots(self.cfg, self.cache, sub_cache,
                               self._ids([slot]))

    def evict(self, slot: int) -> None:
        """Reset ``slot`` to the init state and free it: a later
        admission can never observe a previous request's state."""
        assert self._active[slot], f"slot {slot} not active"
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

    def state_bytes_per_slot(self) -> int:
        """Device bytes one slot occupies across every cache leaf:
        quantized payloads at their storage width, their f32 scales
        included (jamba's KV strips at max_seq)."""
        return sum(t.numel() * t.element_size()
                   for t in registry.tree_leaves(self.cache)) // self.n_total

    def slots_per_gb(self) -> float:
        """Slot capacity per GiB of decode-state memory (the capacity
        axis cfg.state_dtype multiplies)."""
        return (1 << 30) / max(1, self.state_bytes_per_slot())
