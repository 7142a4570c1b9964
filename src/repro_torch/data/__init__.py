"""Data pipeline of the port: the synthetic structured corpus, the
deterministic sharded loader and its background prefetch."""
from repro_torch.data.pipeline import (Prefetcher, ShardedLoader, SyntheticLM,
                                       make_train_iterator)

__all__ = ["Prefetcher", "ShardedLoader", "SyntheticLM",
           "make_train_iterator"]
