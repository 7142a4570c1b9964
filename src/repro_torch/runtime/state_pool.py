"""Slot-based decode-state pool (port of ``repro/runtime/state_pool.py``,
without the scratch slots, pins and forks that speculative decoding,
best-of-n and sessions add there).

A Mamba sequence's decode state is a fixed O(d_inner * d_state) block per
layer plus the (k-1)-tap conv tail, so a fixed-shape pool holds one slot
per in-flight sequence: admission scatters a prefilled state into a free
slot, eviction scatters the init state back, and the decode batch never
changes shape.  The pool's tensors are updated in place (``index_copy_``)
where ``repro`` rebinds functional copies, which keeps one pool's worth of
memory.  An int8/fp8 state's group scales (``h_scale``) are a cache leaf
like any other, so every slot operation moves them with their payload and
an evicted slot gets zero scales back.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.runtime import sampling


class SlotStatePool:
    """Fixed-capacity pool of per-slot decode state for one config.
    ``cache`` is a tree of tensors (flat for mamba, nested for jamba)
    whose slot axis (``registry.cache_slot_axes``) has ``n_slots``
    entries."""

    def __init__(self, cfg, n_slots: int, max_seq: int, dtype=None,
                 device="cpu"):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.cache = registry.init_cache(cfg, n_slots, max_seq, dtype,
                                         self.device)
        # the init state of one slot: eviction scatters this back
        self._fresh = registry.init_cache(cfg, 1, max_seq, dtype,
                                          self.device)
        self.params = sampling.SlotParams(n_slots)
        self._free: list[int] = list(range(n_slots))
        self._active: list[bool] = [False] * n_slots

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
                   for t in registry.tree_leaves(self.cache)) // self.n_slots

    def slots_per_gb(self) -> float:
        """Slot capacity per GiB of decode-state memory (the capacity
        axis cfg.state_dtype multiplies)."""
        return (1 << 30) / max(1, self.state_bytes_per_slot())
