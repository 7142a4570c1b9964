"""Prompt-prefix state cache (port of ``repro/runtime/prefix_cache.py``).

A recurrent slot's whole decode state is a fixed block (plus the conv
tail, the group scales of a quantized state and the stream position),
so a cached prompt prefix is a batch-1 cache tree captured at a token
boundary, restored into any free slot with one scatter.  Payload, scales
and position are leaves of one tree and move together.

Keys are the exact prefix token bytes (int32 ``tobytes``).  Snapshots
are taken at multiples of ``block`` tokens; a lookup walks the
boundaries deepest first, strictly below the prompt's length, so an
admission always computes at least one suffix token.  A cold admission
inserts a snapshot at every boundary it crosses.  The store is an LRU
bounded by ``max_entries`` and ``max_bytes``; a snapshot larger than
``max_bytes`` is refused and counted.

Every stored snapshot owns its memory (``insert`` copies each leaf): the
port's pool and caches are tensors written in place, and an entry that
shared storage with one would change under the cache.

``store="device"`` keeps snapshots on the engine's device (a restore
reads them where they are); ``store="host"`` moves them to the CPU, but
that copy synchronizes, so inserts are queued and ``flush_pending``
drains them at the engine's existing host syncs.  A restore copies a
host entry back to the device.

Exactness: a hit emits the tokens a cold admission of the same prompt
emits, bitwise, for any state dtype: both chain the same suffix from the
same snapshot (cold: a one-block prefill, then the chain; hit: the
restored snapshot, then the chain).  Cache on against cache off is not
bitwise in the port: the chunked prefill and the per-token chain sum in
other orders than one full prefill, so those streams agree up to ties.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import registry


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """block: snapshot granularity in prompt tokens.  max_entries /
    max_bytes: LRU bounds (max_bytes None: no byte bound).  store:
    "device" or "host" (inserts deferred to flush_pending)."""
    block: int = 8
    max_entries: int = 32
    max_bytes: Optional[int] = None
    store: str = "device"

    def validate(self) -> None:
        if self.block < 1:
            raise ValueError(f"block must be >= 1; got {self.block}")
        if self.max_entries < 1:
            raise ValueError(f"max_entries must be >= 1; "
                             f"got {self.max_entries}")
        if self.max_bytes is not None and self.max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1; "
                             f"got {self.max_bytes}")
        if self.store not in ("device", "host"):
            raise ValueError(f"store must be 'device' or 'host'; "
                             f"got {self.store!r}")


@dataclasses.dataclass
class _Entry:
    snap: object          # batch-1 cache tree (on the device or the CPU)
    n_tokens: int         # prefix length the snapshot encodes
    nbytes: int
    on_host: bool


def tree_bytes(tree) -> int:
    """Total bytes of a cache or snapshot tree: quantized payloads at
    their storage width, scales included."""
    return sum(t.numel() * t.element_size()
               for t in registry.tree_leaves(tree))


def snapshot_to_host(snap):
    """A copy of every leaf on the CPU (synchronizes on the card)."""
    return registry.tree_map(lambda t: t.to("cpu", copy=True), snap)


def snapshot_to_device(snap, device):
    """Every leaf on ``device`` (the leaf itself where it is there)."""
    return registry.tree_to(snap, device)


def _owned(snap):
    return registry.tree_map(
        lambda t: t.clone(memory_format=torch.contiguous_format), snap)


class PrefixCache:
    """Bounded LRU store of prompt-prefix state snapshots.  Host-side
    bookkeeping only: the engine does every pool scatter.  Counters
    (hits, misses, inserts, evictions, rejects, bytes) feed ServeStats."""

    def __init__(self, pcfg: PrefixCacheConfig, device="cpu"):
        pcfg.validate()
        self.cfg = pcfg
        self.device = torch.device(device)
        self._entries: "collections.OrderedDict[bytes, _Entry]" = \
            collections.OrderedDict()
        self._pending: "collections.deque[bytes]" = collections.deque()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.rejects = 0
        self._bytes = 0

    @staticmethod
    def _key(tokens) -> bytes:
        return np.asarray(tokens, np.int32).tobytes()

    def boundary(self, length: int) -> int:
        """Deepest boundary usable for a prompt of ``length`` tokens: the
        largest multiple of ``block`` strictly below ``length``, or 0."""
        p = ((length - 1) // self.cfg.block) * self.cfg.block
        return p if p >= self.cfg.block else 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_bytes(self) -> int:
        return self._bytes

    def lookup(self, prompt):
        """(n_tokens, snap) of the deepest cached block-boundary prefix
        of ``prompt``, ``snap`` on the cache's device, or None.  A hit
        refreshes its recency; each call counts one hit or one miss.  The
        returned tree is the stored one (or, from the host store, a copy
        on the device): callers read it and never write into it."""
        prompt = np.asarray(prompt, np.int32)
        p = self.boundary(len(prompt))
        while p >= self.cfg.block:
            key = self._key(prompt[:p])
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                snap = ent.snap
                if ent.on_host:
                    snap = snapshot_to_device(snap, self.device)
                return ent.n_tokens, snap
            p -= self.cfg.block
        self.misses += 1
        return None

    def insert(self, prefix_tokens, snap) -> None:
        """Store a copy of ``snap`` (batch-1 cache tree) as the state after
        ``prefix_tokens``.  An existing entry is refreshed, not replaced:
        snapshots of one exact prefix are interchangeable."""
        key = self._key(prefix_tokens)
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        nbytes = tree_bytes(snap)
        if self.cfg.max_bytes is not None and nbytes > self.cfg.max_bytes:
            # a snapshot that can never fit would evict every entry and
            # then itself: refuse it and count the refusal
            self.rejects += 1
            return
        self._entries[key] = _Entry(snap=_owned(snap),
                                    n_tokens=len(prefix_tokens),
                                    nbytes=nbytes, on_host=False)
        self._bytes += nbytes
        self.inserts += 1
        if self.cfg.store == "host":
            self._pending.append(key)
        self._evict_over_bound()

    def _evict_over_bound(self) -> None:
        def over_bytes():
            return (self.cfg.max_bytes is not None
                    and self._bytes > self.cfg.max_bytes)

        while self._entries and (len(self._entries) > self.cfg.max_entries
                                 or over_bytes()):
            key, ent = self._entries.popitem(last=False)
            self._bytes -= ent.nbytes
            self.evictions += 1
            if key in self._pending:
                self._pending.remove(key)

    def has_pending(self) -> bool:
        """Host-store snapshots still wait for their copy to the CPU: the
        burst scheduler keeps its bursts quantum-capped meanwhile."""
        return bool(self._pending)

    def flush_pending(self, limit: Optional[int] = 1) -> int:
        """Move up to ``limit`` pending snapshots to the CPU (None: all),
        at a sync the engine makes anyway.  A dead key (its entry evicted
        since) or an entry already moved is skipped without counting
        against the limit.  Returns the number moved."""
        done = 0
        while self._pending and (limit is None or done < limit):
            ent = self._entries.get(self._pending.popleft())
            if ent is None or ent.on_host:
                continue
            ent.snap = snapshot_to_host(ent.snap)
            ent.on_host = True
            done += 1
        return done

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "inserts": self.inserts, "evictions": self.evictions,
                "rejects": self.rejects,
                "entries": len(self._entries), "bytes": self._bytes}
