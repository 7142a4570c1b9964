"""Deterministic, shardable data pipeline: the port's copy of
``repro/data/pipeline.py`` (numpy only, the same batches for the same
seed).

  * ``SyntheticLM`` is stateless: ``batch_at(step, shard, num_shards)``
    is a pure function of its arguments, so a resumed run needs only the
    step counter from its checkpoint.  The corpus has learnable structure
    (a Zipf unigram and an order-2 mixing rule), so a small model's loss
    falls within a few hundred steps.
  * ``ShardedLoader`` iterates one shard's batches from a start step.
  * ``Prefetcher`` assembles batches on a background thread into a
    bounded queue, overlapping the host's work with the step.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Order-2 synthetic language: next = f(prev, prev2) with noise."""

    def __init__(self, vocab: int, seq_len: int, seed: int = 0,
                 noise: float = 0.1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        # deterministic order-2 transition table (the learnable structure)
        self.table = rng.integers(0, vocab, size=(vocab,), dtype=np.int64)
        self.mix = rng.integers(1, vocab, size=(), dtype=np.int64)
        # Zipf-ish unigram for the noise tokens
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def sample(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        L = self.seq_len + 1
        out = np.empty((batch, L), dtype=np.int64)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        out[:, 1] = rng.integers(0, self.vocab, size=batch)
        noise_mask = rng.random((batch, L)) < self.noise
        noise_tok = rng.choice(self.vocab, size=(batch, L), p=self.unigram)
        for t in range(2, L):
            nxt = self.table[(out[:, t - 1] + self.mix * out[:, t - 2])
                             % self.vocab]
            out[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return out

    def batch_at(self, step: int, shard: int, num_shards: int,
                 batch_per_shard: int) -> dict:
        """Pure function of (step, shard): deterministic + resumable."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard * 2_654_435_761
            % (2 ** 63))
        toks = self.sample(rng, batch_per_shard)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class ShardedLoader:
    """Iterator over deterministic global batches for one data shard."""

    def __init__(self, dataset: SyntheticLM, global_batch: int,
                 shard: int = 0, num_shards: int = 1, start_step: int = 0):
        if global_batch % num_shards:
            raise ValueError(f"global batch {global_batch} over "
                             f"{num_shards} shards")
        self.ds = dataset
        self.bps = global_batch // num_shards
        self.shard = shard
        self.num_shards = num_shards
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.ds.batch_at(self.step, self.shard, self.num_shards,
                             self.bps)
        self.step += 1
        return b


class Prefetcher:
    """Background-thread prefetch with a bounded queue.  The thread is a
    daemon that blocks on the full queue once its consumer stops."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = object()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                self.q.put(item)
        finally:
            self.q.put(self.done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self.done:
            raise StopIteration
        return item


def make_train_iterator(cfg, global_batch: int, seq_len: int,
                        start_step: int = 0, seed: int = 0,
                        prefetch: int = 2):
    """Synthetic corpus sized to cfg.vocab -> (prefetched) iterator of
    numpy batches {"tokens", "labels"} (b, seq_len) int32."""
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, seed=seed)
    loader = ShardedLoader(ds, global_batch, start_step=start_step)
    return Prefetcher(loader, depth=prefetch) if prefetch else loader
