"""K-step verify micro-scan for speculative decoding: the port of
``decode_scan`` and ``decode_scan_q`` in ``repro/core/selective_scan.py``
(:267, :293).

Verifying K drafted tokens runs the target's per-token SSM step K times
from a known state and keeps every intermediate state: the accepted
prefix is known only after the pass, and the rollback restores the state
after exactly that many steps.  Each step is the same call a decode
burst makes (``ops.selective_state_step`` / ``selective_state_step_q``):
the decode-step kernel K1 (K2 for an int8/fp8 state) on a CUDA tensor,
its plain version on a CPU one.  ``repro`` chains the step in
``lax.scan``; the port chains it in a Python loop, one launch a step.

``repro``'s other scans here (``selective_scan_assoc``,
``selective_scan_chunked``) are not ported: every ``scan_impl`` runs the
scan kernel K4 (``kernels/ops.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def decode_scan(h, x_seq, dt_seq, A, B_seq, C_seq, D=None, z_seq=None,
                impl: str = "fused", exp_impl: str = "exact",
                silu_impl: str = "exact", a_scale=None):
    """Chain the decode step over a K-token window.

    h (b, d, n) f32 start state; x_seq, dt_seq (b, K, d); B_seq, C_seq
    (b, K, n); z_seq (b, K, d) or None; the sequences may be strided
    views (unit stride on the last axis).  Returns (y_seq (b, K, d),
    h_all (b, K, d, n) f32), h_all[:, t] the state after token t: the
    f32 state of each step feeds the next, as in ``repro``."""
    ys, hs = [], []
    for t in range(x_seq.shape[1]):
        y, h = ops.selective_state_step(
            h, x_seq[:, t], dt_seq[:, t], A, B_seq[:, t], C_seq[:, t], D=D,
            z_t=None if z_seq is None else z_seq[:, t], impl=impl,
            exp_impl=exp_impl, silu_impl=silu_impl, a_scale=a_scale)
        ys.append(y)
        hs.append(h)
    return torch.stack(ys, 1), torch.stack(hs, 1)


def decode_scan_q(hq, h_scale, x_seq, dt_seq, A, B_seq, C_seq, D=None,
                  z_seq=None, state_dtype: str = "int8", impl: str = "fused",
                  exp_impl: str = "exact", silu_impl: str = "exact",
                  a_scale=None):
    """Quantized-state micro-scan: each step dequantizes on read and
    requantizes on write, as in serving, so the payloads and the group
    scales of every step come back stacked together (a rollback to step
    t restores both).

    Returns (y_seq (b, K, d), hq_all (b, K, d, n) in the storage dtype,
    scale_all (b, K, g) f32)."""
    ys, qs, ss = [], [], []
    for t in range(x_seq.shape[1]):
        y, hq, h_scale = ops.selective_state_step_q(
            hq, h_scale, x_seq[:, t], dt_seq[:, t], A, B_seq[:, t],
            C_seq[:, t], D=D, z_t=None if z_seq is None else z_seq[:, t],
            state_dtype=state_dtype, impl=impl, exp_impl=exp_impl,
            silu_impl=silu_impl, a_scale=a_scale)
        ys.append(y)
        qs.append(hq)
        ss.append(h_scale)
    return torch.stack(ys, 1), torch.stack(qs, 1), torch.stack(ss, 1)
