"""Per-request sampling parameters as data (port of
``repro/runtime/sampling.py``).

Every knob lives in per-slot arrays (``SlotParams``), so one decode loop
serves a batch that mixes greedy and sampled requests.  Greedy
(temperature <= 0) is an exact argmax of the f32 logits.  A sampled
token at stream position ``i`` of a request seeded ``s`` is drawn with a
``torch.Generator`` seeded from ``(s, i)`` — the counterpart of
``repro``'s ``fold_in(key(s), i)``: a sampled stream does not depend on
slot placement or on what else shares the batch.  The draws are not
JAX's threefry bits, so sampled streams differ from ``repro``'s.

Speculative decoding draws from further streams of the same request:
``fold_tag`` derives the generator seed of tag t at a stream position
(the counterpart of ``repro``'s ``fold_tag``), and ``sample_dist`` is
the filtered, temperature-scaled distribution the draft proposes from
and the acceptance ratio reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: alternatives the step functions compute per emitted token
TOP_LOGPROBS = 5

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs (``Engine.submit(prompt, params)``);
    the fields and their meaning are ``repro``'s.  ``n > 1`` (best-of-n)
    is not ported yet and the engine refuses it."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop: tuple = ()
    stop_seqs: tuple = ()
    max_new: int = 32
    n: int = 1
    logprobs: bool = False
    top_logprobs: int = 0

    def validate(self) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0; "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables); "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {self.top_p}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1; got {self.max_new}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1; got {self.n}")
        for s in self.stop_seqs:
            if len(tuple(s)) < 1:
                raise ValueError("stop_seqs entries must be non-empty")
        if not 0 <= self.top_logprobs <= TOP_LOGPROBS:
            raise ValueError(f"top_logprobs must be in [0, {TOP_LOGPROBS}]"
                             f"; got {self.top_logprobs}")



class SlotParams:
    """Per-slot sampling parameters over a pool's rows, host-side:
    set on admission, cleared on eviction."""

    FIELDS = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, n: int):
        self.n = n
        self.temperature = np.zeros((n,), np.float32)
        self.top_k = np.zeros((n,), np.int64)
        self.top_p = np.ones((n,), np.float32)
        self.seed = np.zeros((n,), np.int64)

    def set(self, slot: int, sp: SamplingParams, seed: int) -> None:
        self.temperature[slot] = sp.temperature
        self.top_k[slot] = sp.top_k
        self.top_p[slot] = sp.top_p
        self.seed[slot] = seed

    def clear(self, slot: int) -> None:
        """Reset a row to greedy: a freed slot never leaks its request's
        temperature or seed into the next admission."""
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        self.seed[slot] = 0

    def copy(self, src, dst) -> None:
        """Mirror a state fork: rows ``dst`` take rows ``src``'s params,
        the seed verbatim, so a draft fork continues its request's exact
        stream of draws."""
        src, dst = list(src), list(dst)
        for f in self.FIELDS:
            a = getattr(self, f)
            a[dst] = a[src]

    def rows(self, slots=None) -> dict:
        """Copies of the given rows (all rows for None)."""
        idx = slice(None) if slots is None else list(slots)
        return {f: getattr(self, f)[idx].copy() for f in self.FIELDS}


def _mix(seed: int, step: int) -> int:
    """Seed of the generator for stream position ``step`` of a request
    seeded ``seed``: a splitmix64 round over the pair."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def fold_tag(seed: int, step: int, tag: int) -> int:
    """Seed of the generator for tag ``tag`` at stream position ``step``
    of a request seeded ``seed``: a second splitmix64 round over the
    position's seed and the tag.  The speculative pass draws its
    acceptance uniforms (tag 1), residual tokens (2) and bonus token (3)
    from these streams, never from a proposal's ``_mix(seed, step)``."""
    return _mix(_mix(seed, step), (1 << 62) + int(tag))


def token_logprobs(logits, tok):
    """(b, V) raw logits + (b,) chosen ids -> (chosen logprob (b,),
    top values (b, K), top ids (b, K)), K = min(TOP_LOGPROBS, V), from
    the log-softmax of the raw f32 logits."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = lp.gather(-1, tok[:, None].long())[:, 0]
    tv, ti = torch.topk(lp, min(TOP_LOGPROBS, lp.shape[-1]), dim=-1)
    return chosen, tv, ti


def filter_logits(scaled, top_k, top_p):
    """Vectorized per-row top-k + top-p masking (``repro``'s rule: ties at
    either threshold are kept, the token crossing top_p is kept, at least
    one token survives).  scaled (b, V) f32; top_k (b,) int (0 disables);
    top_p (b,) f32.  Masked entries become -inf."""
    v = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, v), torch.full_like(top_k, v))
    kth = srt.gather(-1, k[:, None] - 1)
    probs = torch.softmax(srt, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    n_keep = ((csum - probs) < top_p[:, None]).sum(-1).clamp(min=1)
    pth = srt.gather(-1, n_keep[:, None] - 1)
    keep = (scaled >= kth) & (scaled >= pth)
    return torch.where(keep, scaled, torch.full_like(scaled, -float("inf")))


def sample_dist(logits, sp: dict) -> torch.Tensor:
    """(b, V) raw logits -> the logits of each row's sampling
    distribution: scaled by the row's temperature (1 for a greedy row)
    and top-k / top-p filtered (``repro`` sampling.py:269).  ``sp`` holds
    host arrays of b rows.  The draft's proposals and the acceptance
    ratio both read it."""
    lg = logits.float()
    dev = lg.device
    temp = torch.as_tensor(np.where(sp["temperature"] > 0,
                                    sp["temperature"], 1.0)
                           .astype(np.float32), device=dev)
    return filter_logits(lg / temp[:, None],
                         torch.as_tensor(sp["top_k"], device=dev),
                         torch.as_tensor(sp["top_p"], device=dev))


def sample(logits, sp: dict, step) -> torch.Tensor:
    """(b, V) logits -> (b,) int64 tokens on the logits' device.

    ``sp`` holds host arrays of b rows (``SlotParams.rows``); ``step``
    (b,) host ints are each row's stream position.  Greedy rows take the
    argmax; sampled rows draw from their temperature-scaled, filtered
    distribution with a generator seeded from (seed, step).  An
    all-greedy batch costs one argmax and no host sync."""
    lg = logits.float()
    tok = torch.argmax(lg, dim=-1)
    rows = np.flatnonzero(sp["temperature"] > 0)
    if rows.size == 0:
        return tok
    dev = lg.device
    idx = torch.as_tensor(rows, device=dev)
    probs = torch.softmax(sample_dist(lg[idx], {f: sp[f][rows] for f in
                                                ("temperature", "top_k",
                                                 "top_p")}), dim=-1)
    for j, r in enumerate(rows):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_mix(sp["seed"][r], step[r]))
        tok[r] = torch.multinomial(probs[j], 1, generator=gen)[0]
    return tok
