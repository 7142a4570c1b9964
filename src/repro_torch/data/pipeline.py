"""Synthetic request/corpus source: the port's copy of ``SyntheticLM``
from ``repro/data/pipeline.py`` (numpy only, same streams for the same
seed)."""
from __future__ import annotations

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
