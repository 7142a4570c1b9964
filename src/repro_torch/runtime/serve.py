"""Batched serving: thin wrapper over the continuous-batching Engine (port
of ``repro/runtime/serve.py``).

``Server.generate`` keeps the static-batch API — same-length prompts,
b <= batch_slots, (b, <=max_new) output — and submits each row as an
independent request to the engine.  With an ``eos_id`` each row stops at
its own EOS and is right-padded with it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.sampling import SamplingParams


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 4
    max_seq: int = 256
    # engine-wide sampling defaults applied to every generate() row
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # pooled recurrent-state storage dtype override:
    # "f32" | "bf16" | "int8" | "fp8"
    state_dtype: Optional[str] = None
    device: str = "cuda"


class Server:
    def __init__(self, cfg, params, scfg: ServeConfig):
        self.cfg = cfg
        self.scfg = scfg
        self.engine = Engine(cfg, params, EngineConfig(
            n_slots=scfg.batch_slots, max_seq=scfg.max_seq,
            seed=scfg.seed, state_dtype=scfg.state_dtype,
            device=scfg.device))

    def generate(self, prompts: np.ndarray, max_new: int = 32,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """prompts (b, Lp) int32 -> (b, <=max_new) generated ids."""
        b = prompts.shape[0]
        if b > self.scfg.batch_slots:
            raise ValueError(f"batch {b} > batch_slots "
                             f"{self.scfg.batch_slots}")
        sp = SamplingParams(temperature=self.scfg.temperature,
                            top_k=self.scfg.top_k, top_p=self.scfg.top_p,
                            max_new=max_new)
        reqs = [self.engine.submit(row, params=sp, eos_id=eos_id)
                for row in np.asarray(prompts)]
        self.engine.run()
        width = max(len(r.tokens) for r in reqs)
        pad = eos_id if eos_id is not None else 0
        out = np.full((b, width), pad, np.int32)
        for i, r in enumerate(reqs):
            out[i, :len(r.tokens)] = r.tokens
        return out
