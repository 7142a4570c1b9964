"""Metrics logging (jsonl) + straggler detection + serving counters.

StragglerDetector: per-step wall time EMA/EMVar; a step whose time exceeds
mean + z*std is flagged.  On a real multi-host deployment the same detector
runs per host on heartbeat files and feeds the microbatch re-balancer; here
it logs and counts (tests inject artificial delays).

ServeStats: throughput/latency counters for the continuous-batching
engine — prefill/decode token counts and wall time, slot occupancy, and
per-request TTFT/TPOT/latency distributions, with per-tenant breakdowns
and SLO-violation / load-shed counters for the front-end scheduler
(runtime/scheduler.py).  Cancelled requests stay out of every
percentile; TPOT (time per OUTPUT token, the decode-side SLO axis) is
measured from first token to completion over the tokens after the
first, so a one-token request has no TPOT sample rather than a zero.

The port's own copy of ``repro/runtime/metrics.py``, unchanged in
behaviour: the counters are host-side and framework-free."""
from __future__ import annotations

import json
import math
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, **kv):
        kv.setdefault("t", time.time())
        line = json.dumps(kv)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            show = {k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in kv.items() if k != "t"}
            print(f"[metrics] {show}", file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()


def _percentile(sorted_xs: list, q: float) -> float:
    if not sorted_xs:
        return 0.0
    i = min(len(sorted_xs) - 1, max(0, int(round(q * (len(sorted_xs) - 1)))))
    return sorted_xs[i]


class ServeStats:
    """Counters for the serving engine (host-side, cheap per step).

    "useful" tokens are tokens delivered to a live request: one per
    prefill (the first sampled token) and one per active slot per decode
    step — masked/idle slots never count, so tokens_per_s reflects work a
    client actually received."""

    def __init__(self):
        self.prefill_calls = 0
        self.prefill_tokens = 0        # prompt tokens consumed
        self.prefill_time = 0.0
        self.decode_steps = 0
        self.decode_time = 0.0
        self.useful_tokens = 0
        self.slot_steps = 0            # n_slots summed over decode steps
        self.active_steps = 0          # active slots summed (occupancy)
        self.n_requests = 0
        self.n_cancelled = 0           # requests retired via cancel()
        # speculative decoding (deterministic counters — the bench gate
        # diffs these, never wall-clock)
        self.spec_passes = 0           # target verify passes
        self.spec_slot_passes = 0      # sum of active slots over passes
        self.spec_drafted = 0          # draft tokens proposed
        self.spec_accepted = 0         # draft tokens accepted
        self.spec_emitted = 0          # tokens delivered by spec passes
        self.spec_draft_steps = 0      # draft decode steps over the pool
        # prefix cache (deterministic counters; the bench gate asserts
        # hits > 0 and strictly fewer prefilled tokens than no-cache)
        self.prefix_hits = 0           # admissions restored from cache
        self.prefix_misses = 0         # admissions that ran cold
        self.prefix_cached_tokens = 0  # prompt tokens skipped via restore
        self.prefix_inserts = 0        # snapshots stored
        self.prefix_evictions = 0      # snapshots LRU-evicted
        self.prefix_rejects = 0        # snapshots refused (> max_bytes)
        self.prefix_bytes = 0          # bytes currently resident
        # front-end scheduler (runtime/scheduler.py) + disaggregation
        # (runtime/disagg.py) — all deterministic counts
        self.n_shed = 0                # requests rejected by load shedding
        self.n_degraded = 0            # requests admitted with shrunk n
        self.n_slo_ttft_violations = 0
        self.n_slo_tpot_violations = 0
        self.n_callback_errors = 0     # stream_cb raised (request cancelled)
        self.snapshot_admits = 0       # slots admitted from a shipped
        self.snapshot_tokens = 0       #   prefill snapshot (disagg decode
        self.snapshot_bytes = 0        #   side); bytes = transfer payload
        self._ttft: list[float] = []
        self._tpot: list[float] = []
        self._latency: list[float] = []
        self._tenants: dict[str, dict] = {}
        self._t0: Optional[float] = None
        self.wall = 0.0

    def _tenant(self, name: str) -> dict:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = {
                "requests": 0, "shed": 0, "degraded": 0,
                "slo_ttft_violations": 0, "slo_tpot_violations": 0,
                "ttft": [], "tpot": [],
            }
        return t

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.wall += time.perf_counter() - self._t0
            self._t0 = None

    def record_prefill(self, n_tokens: int, dt: float):
        self.prefill_calls += 1
        self.prefill_tokens += n_tokens
        self.prefill_time += dt
        self.useful_tokens += 1        # the token sampled off the prefill

    def record_decode(self, n_active: int, n_slots: int, dt: float,
                      n_steps: int = 1, n_tokens: Optional[int] = None):
        """One decode burst of ``n_steps`` pooled steps.  ``n_tokens`` is
        the count actually delivered (EOS overshoot trimmed); defaults to
        n_active * n_steps."""
        self.decode_steps += n_steps
        self.decode_time += dt
        self.useful_tokens += (n_tokens if n_tokens is not None
                               else n_active * n_steps)
        self.active_steps += n_active * n_steps
        self.slot_steps += n_slots * n_steps

    def record_spec(self, n_active: int, n_drafted: int, n_accepted: int,
                    n_emitted: int, n_draft_steps: int = 0):
        """One speculative pass: ``n_drafted`` proposals over
        ``n_active`` slots, ``n_accepted`` of them accepted,
        ``n_emitted`` tokens delivered (accepted + per-slot correction/
        bonus tokens, after EOS/budget trim), in ``n_draft_steps`` draft
        decode steps over the pool."""
        self.spec_passes += 1
        self.spec_slot_passes += n_active
        self.spec_drafted += n_drafted
        self.spec_accepted += n_accepted
        self.spec_emitted += n_emitted
        self.spec_draft_steps += n_draft_steps

    def record_prefix(self, hit: bool, n_cached: int):
        """One admission's prefix-cache outcome: ``n_cached`` prompt
        tokens restored from a snapshot instead of prefilled (0 on a
        miss).  Restored tokens are deliberately NOT added to
        prefill_tokens — that counter stays the honest compute count,
        which is what the bench gate diffs against the no-cache run."""
        if hit:
            self.prefix_hits += 1
            self.prefix_cached_tokens += n_cached
        else:
            self.prefix_misses += 1

    def sync_prefix(self, counters: dict):
        """Adopt the PrefixCache's own insert/eviction/bytes counters
        (the cache is the source of truth for its storage accounting)."""
        self.prefix_inserts = counters["inserts"]
        self.prefix_evictions = counters["evictions"]
        self.prefix_rejects = counters.get("rejects", 0)
        self.prefix_bytes = counters["bytes"]

    def record_request(self, ttft: float, latency: float,
                       n_tokens: int = 0, tenant: Optional[str] = None):
        self.n_requests += 1
        self._ttft.append(ttft)
        self._latency.append(latency)
        tpot = None
        if n_tokens > 1:
            tpot = (latency - ttft) / (n_tokens - 1)
            self._tpot.append(tpot)
        if tenant is not None:
            t = self._tenant(tenant)
            t["requests"] += 1
            t["ttft"].append(ttft)
            if tpot is not None:
                t["tpot"].append(tpot)

    def record_shed(self, tenant: Optional[str] = None):
        """A request rejected at admission control — it never entered the
        engine, so it touches no throughput or latency counter."""
        self.n_shed += 1
        if tenant is not None:
            self._tenant(tenant)["shed"] += 1

    def record_degraded(self, tenant: Optional[str] = None):
        """A request admitted with a shrunk sampling budget (best-of-n
        collapsed to 1) instead of being shed."""
        self.n_degraded += 1
        if tenant is not None:
            self._tenant(tenant)["degraded"] += 1

    def record_slo_violation(self, kind: str,
                             tenant: Optional[str] = None):
        """A completed request that blew its wall-clock SLO budget;
        ``kind`` is "ttft" or "tpot".  Decision-making never reads these
        (admission control uses deterministic projected-wait proxies) —
        they are accounting for dashboards and the serve report."""
        if kind == "ttft":
            self.n_slo_ttft_violations += 1
        elif kind == "tpot":
            self.n_slo_tpot_violations += 1
        else:
            raise ValueError(f"unknown SLO kind: {kind!r}")
        if tenant is not None:
            self._tenant(tenant)[f"slo_{kind}_violations"] += 1

    def record_snapshot_admit(self, n_tokens: int, nbytes: int):
        """Decode-side disaggregated admission: a prefill snapshot
        (state block + scales + stream position + first-token surface)
        restored into a slot with one scatter.  ``n_tokens`` is the
        prompt length the prefill worker consumed on our behalf —
        deliberately NOT added to prefill_tokens, which stays the honest
        local compute count.  The first token shipped with the snapshot
        is delivered to the client, hence useful_tokens += 1 (mirroring
        record_prefill)."""
        self.snapshot_admits += 1
        self.snapshot_tokens += n_tokens
        self.snapshot_bytes += nbytes
        self.useful_tokens += 1

    def record_cancelled(self):
        """A cancelled request: its slot time already counted in the
        decode counters, but it never completed — kept out of the
        TTFT/latency distributions so cancellations can't flatter the
        percentiles."""
        self.n_cancelled += 1

    def summary(self) -> dict:
        wall = self.wall if self.wall > 0 else (
            self.prefill_time + self.decode_time)
        ttft = sorted(self._ttft)
        tpot = sorted(self._tpot)
        lat = sorted(self._latency)
        per_tenant = {}
        for name in sorted(self._tenants):
            t = self._tenants[name]
            tt = sorted(t["ttft"])
            tp = sorted(t["tpot"])
            per_tenant[name] = {
                "requests": t["requests"],
                "shed": t["shed"],
                "degraded": t["degraded"],
                "slo_ttft_violations": t["slo_ttft_violations"],
                "slo_tpot_violations": t["slo_tpot_violations"],
                "ttft_p95_s": _percentile(tt, 0.95),
                "tpot_p95_s": _percentile(tp, 0.95),
            }
        return {
            "requests": self.n_requests,
            "cancelled": self.n_cancelled,
            "useful_tokens": self.useful_tokens,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.decode_steps,
            "wall_s": wall,
            "tokens_per_s": self.useful_tokens / wall if wall > 0 else 0.0,
            "occupancy": (self.active_steps / self.slot_steps
                          if self.slot_steps else 0.0),
            "ttft_mean_s": sum(ttft) / len(ttft) if ttft else 0.0,
            "ttft_p95_s": _percentile(ttft, 0.95),
            "tpot_mean_s": sum(tpot) / len(tpot) if tpot else 0.0,
            "tpot_p95_s": _percentile(tpot, 0.95),
            "latency_mean_s": sum(lat) / len(lat) if lat else 0.0,
            "latency_p95_s": _percentile(lat, 0.95),
            # front-end scheduler + disaggregation (deterministic counts)
            "n_shed": self.n_shed,
            "n_degraded": self.n_degraded,
            "slo_ttft_violations": self.n_slo_ttft_violations,
            "slo_tpot_violations": self.n_slo_tpot_violations,
            "callback_errors": self.n_callback_errors,
            "snapshot_admits": self.snapshot_admits,
            "snapshot_tokens": self.snapshot_tokens,
            "snapshot_bytes": self.snapshot_bytes,
            "per_tenant": per_tenant,
            # speculative decode: tokens delivered per slot per target
            # pass (1.0 = plain decode; upper bound draft k + 1) and
            # the draft-token acceptance fraction
            "spec_target_passes": self.spec_passes,
            "spec_draft_steps": self.spec_draft_steps,
            "spec_accepted_per_pass": (
                self.spec_emitted / self.spec_slot_passes
                if self.spec_slot_passes else 0.0),
            "spec_acceptance_rate": (
                self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0),
            # prefix cache: hit rate over admissions that consulted the
            # cache, and prompt tokens restored instead of prefilled
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (
                self.prefix_hits / (self.prefix_hits + self.prefix_misses)
                if (self.prefix_hits + self.prefix_misses) else 0.0),
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "prefix_inserts": self.prefix_inserts,
            "prefix_evictions": self.prefix_evictions,
            "prefix_rejects": self.prefix_rejects,
            "prefix_bytes": self.prefix_bytes,
        }


class StragglerDetector:
    """EMA-based step-time anomaly detector (z-score threshold)."""

    def __init__(self, alpha: float = 0.1, z: float = 3.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.z = z
        self.warmup = warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # prime the EMA
            self.mean = (self.mean * (self.n - 1) + dt) / self.n
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        # var == 0 after a constant-time warmup is legitimate, not a
        # "not enough data" signal: an inf std would make the detector
        # blind forever (the first genuine straggler passes unflagged
        # AND corrupts the EMA mean/var).  Floor the std relative to
        # the mean instead, so a step several times the steady rate
        # always trips the z-threshold.
        std = math.sqrt(self.var)
        floor = max(1e-9, 0.05 * abs(self.mean))
        is_straggler = dt > self.mean + self.z * max(std, floor)
        if is_straggler:
            self.flagged.append((step, dt))
        else:
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler
