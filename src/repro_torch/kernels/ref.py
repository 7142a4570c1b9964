"""Plain PyTorch versions of the port's kernels, in ``repro``'s layouts.

Each CUDA kernel's wrapper runs the function here for a tensor on the
CPU; the tests hold these against ``repro``'s Pallas kernels, and
``chip_smoke.py`` holds each kernel against them on the card.  They are
device-agnostic tensor code, so they run on a CUDA tensor when called
directly.

Layouts are ``repro``'s public ones (``repro/kernels/ref.py``): h is
``(b, d, n)`` and the conv state is ``(b, k-1, d)``.

``CALLS`` counts entries into each plain version, so a run on the card
can show that the serving path never took one.  Each version counts
only its own entry: the plain K3 (``mamba_stacked_step``,
``jamba_stacked_run``, ``xlstm_stacked_run``) runs the conv and the step
through the uncounted bodies ``conv_math``, ``step_math`` and
``step_q_math``, as the TPU kernel runs them inline.  The xLSTM cells
(``mlstm_cell``, ``slstm_cell``) are model math that ``repro`` runs in
XLA on its per-layer path; they count nothing.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from repro_torch.core import approx, state_quant, weight_quant

CALLS: collections.Counter = collections.Counter()


def selective_scan(x, dt, A, B, C, D=None, z=None, h0=None,
                   exp_impl: str = "exact", silu_impl: str = "exact"):
    """Sequential selective-SSM recurrence (``repro/kernels/ref.py:39``).

    x, dt (b, L, d) with dt already softplus'd; A (d, n); B, C (b, L, n);
    D (d,)|None; z (b, L, d)|None; h0 (b, d, n)|None.
    Returns (y (b, L, d) in x.dtype, h_last (b, d, n) f32).

      h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t^T
      y_t = h_t C_t + D * x_t ;  out_t = y_t * silu(z_t)
    """
    CALLS["selective_scan"] += 1
    exp = approx.get_exp(exp_impl)
    silu = approx.get_silu(silu_impl)
    bsz, L, d = x.shape
    n = A.shape[1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    h = (torch.zeros(bsz, d, n, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(L):
        dA = exp(dtf[:, t, :, None] * Af)                    # (b, d, n)
        dBx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1)                               # (b, L, d)
    if D is not None:
        y = y + D.float()[None, None, :] * xf
    if z is not None:
        y = y * silu(z.float())
    return y.to(x.dtype), h


def selective_state_step(h, x_t, dt_t, A, B_t, C_t, D=None, z_t=None,
                         exp_impl: str = "exact", silu_impl: str = "exact",
                         a_scale=None):
    """One decode step (``repro/kernels/ref.py:86``).  h (b, d, n) f32;
    x_t, dt_t (b, d); B_t, C_t (b, n).  ``a_scale`` (d,) marks A as int8
    codes, dequantized first with ``weight_quant.dequantize_rows`` (as
    ``repro/core/selective_scan.py:205`` does on its XLA path).  Returns
    (y (b, d) in x_t.dtype, h_new (b, d, n) f32)."""
    CALLS["selective_state_step"] += 1
    return step_math(h, x_t, dt_t, A, B_t, C_t, D, z_t, exp_impl, silu_impl,
                     a_scale)


def step_math(h, x_t, dt_t, A, B_t, C_t, D, z_t, exp_impl, silu_impl,
              a_scale):
    """The body of ``selective_state_step``, uncounted."""
    exp = approx.get_exp(exp_impl)
    silu = approx.get_silu(silu_impl)
    if a_scale is not None:
        A = weight_quant.dequantize_rows(A, a_scale)
    xf, dtf = x_t.float(), dt_t.float()
    dA = exp(dtf[..., None] * A.float())
    dBx = (dtf * xf)[..., None] * B_t.float()[:, None, :]
    h = dA * h.float() + dBx
    y = torch.einsum("bdn,bn->bd", h, C_t.float())
    if D is not None:
        y = y + D.float()[None, :] * xf
    if z_t is not None:
        y = y * silu(z_t.float())
    return y.to(x_t.dtype), h


def selective_state_step_q(hq, h_scale, x_t, dt_t, A, B_t, C_t, D=None,
                           z_t=None, state_dtype: str = "int8",
                           exp_impl: str = "exact",
                           silu_impl: str = "exact", a_scale=None):
    """Quantized-state decode step (``repro/kernels/ref.py:104``): hq
    (b, d, n) int8/fp8 payload and h_scale (b, g) f32 group scales are
    dequantized, stepped in f32 and requantized with the running-absmax
    update; the f32 state exists only in between.  Returns
    (y (b, d), hq_new, scale_new (b, g))."""
    CALLS["selective_state_step_q"] += 1
    return step_q_math(hq, h_scale, x_t, dt_t, A, B_t, C_t, D, z_t,
                       state_dtype, exp_impl, silu_impl, a_scale)


def step_q_math(hq, h_scale, x_t, dt_t, A, B_t, C_t, D, z_t, state_dtype,
                exp_impl, silu_impl, a_scale):
    """The body of ``selective_state_step_q``, uncounted."""
    h = state_quant.dequantize_h(hq, h_scale)
    y, h_new = step_math(h, x_t, dt_t, A, B_t, C_t, D, z_t, exp_impl,
                         silu_impl, a_scale)
    hq_new, scale_new = state_quant.quantize_h(h_new, state_dtype,
                                               prev_scale=h_scale)
    return y, hq_new, scale_new


def causal_conv1d(x, w, b=None, x_prev=None):
    """Causal depthwise conv (``repro/kernels/ref.py:128``).  x (b, L, d);
    w (k, d); b (d,)|None; x_prev (b, k-1, d)|None.  Returns
    (y (b, L, d) in x.dtype, new_state (b, k-1, d))."""
    CALLS["causal_conv1d"] += 1
    return conv_math(x, w, b, x_prev)


def conv_math(x, w, b=None, x_prev=None):
    """The body of ``causal_conv1d``, uncounted."""
    bsz, L, d = x.shape
    k = w.shape[0]
    if x_prev is None:
        x_prev = torch.zeros(bsz, k - 1, d, dtype=x.dtype, device=x.device)
    xp = torch.cat([x_prev, x], dim=1)                        # (b, L+k-1, d)
    y = torch.zeros(bsz, L, d, dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xp[:, i:i + L, :].float() * w[i].float()
    if b is not None:
        y = y + b.float()
    # the tail a contiguous tensor of its own, as the kernel writes it
    return y.to(x.dtype), xp[:, L:, :].contiguous()


def mamba_stacked_step(cfg, x0, layers, h, h_scale, conv):
    """The whole Mamba layer stack for one decode token
    (``repro/models/mamba_lm.py:140`` ``stacked_step``'s kernel, the
    mamba body of ``repro/kernels/decode_step.py:413``): for each layer
    l, norm -> ``mamba.mamba_block_megastep`` -> residual, on the
    stacked state.

    x0 (b, 1, d_model) in cfg.dtype; ``layers`` the per-layer param
    dicts ({"norm", "mixer"}); h (L, b, d_inner, n) in the state's
    storage dtype, h_scale (L, b, g) f32 for an int8/fp8 state (else
    None), conv (L, b, k-1, d_inner).  Returns (x (b, 1, d_model), h,
    h_scale or None, conv), the state stacked again."""
    from repro_torch.models import blocks, mamba   # models import kernels
    CALLS["mamba_stacked_step"] += 1
    x = x0
    hs, ss, cs = [], [], []
    for l, lp in enumerate(layers):
        state = {"h": h[l], "conv": conv[l]}
        if h_scale is not None:
            state["h_scale"] = h_scale[l]
        xn = blocks.apply_norm(cfg, lp["norm"], x)
        y, ns = mamba.mamba_block_megastep(cfg, lp["mixer"], xn, state)
        x = x + y
        hs.append(ns["h"])
        cs.append(ns["conv"])
        if h_scale is not None:
            ss.append(ns["h_scale"])
    return (x, torch.stack(hs), torch.stack(ss) if ss else None,
            torch.stack(cs))


def jamba_stacked_run(cfg, x0, rows, states):
    """One run of pure-SSM jamba positions for one decode token: the body
    of ``repro/models/jamba.py:305`` (``stacked_step``'s ``run_mega``,
    launched through ``repro/kernels/decode_step.py:413``), for each
    position of the run in order: norm1 -> ``mamba.mamba_block_megastep``
    -> residual -> norm2 -> MLP -> residual.

    x0 (b, 1, d_model) in cfg.dtype; ``rows`` the positions' param dicts
    ({"norm1", "mamba", "norm2", "mlp"}); ``states`` one state dict per
    position ({"h", "conv"} + "h_scale" for an int8/fp8 state).  Returns
    (x (b, 1, d_model), the new state dicts)."""
    from repro_torch.models import blocks, mamba   # models import kernels
    CALLS["jamba_stacked_run"] += 1
    x = x0
    out = []
    for lp, state in zip(rows, states):
        xn = blocks.apply_norm(cfg, lp["norm1"], x)
        y, ns = mamba.mamba_block_megastep(cfg, lp["mamba"], xn, state)
        x = x + y
        xn = blocks.apply_norm(cfg, lp["norm2"], x)
        x = x + blocks.mlp_apply(cfg, lp["mlp"], xn)
        out.append(ns)
    return x, out


def attention(q, k, v, causal: bool = True, scale=None):
    """Causal GQA attention, the oracle of the flash kernel K7
    (``repro/kernels/ref.py:152``).  q (b, lq, hq, dh); k/v (b, lk, hkv,
    dh); GQA by head repetition; in f32 with the scores materialized;
    with ``causal`` query i attends to keys j <= i + lk - lq (the queries
    are the suffix of the sequence).  Returns (b, lq, hq, dh) in q's
    dtype."""
    CALLS["attention"] += 1
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# xLSTM cells (repro/kernels/decode_step.py:142 mlstm_cell, :170 slstm_cell)
# and the plain K3 xLSTM instance.  The stabilisers pin the exact exp and
# log-sigmoid: the MARCA approximations enter the mLSTM block only through
# its front end's SiLU.
# ---------------------------------------------------------------------------

def mlstm_cell(C, n, m, q, k, v, i, f, dh):
    """One stabilised mLSTM step, all f32.  C (..., dh, dh), n (..., dh),
    m (...); q, k, v (..., dh); i, f (...) the gate pre-activations.

      m' = max(log_sigmoid(f) + m, i);  i' = exp(i - m');
      f' = exp(log_sigmoid(f) + m - m')
      C' = f' C + i' k v^T;  n' = f' n + i' k
      h = C'^T (q / sqrt(dh)) / max(|n' . q / sqrt(dh)|, 1)

    Returns (h (..., dh), (C', n', m'))."""
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    i_p = torch.exp(i - m_new)
    f_p = torch.exp(logf + m - m_new)
    kv = k[..., :, None] * v[..., None, :]
    C = f_p[..., None, None] * C + i_p[..., None, None] * kv
    n = f_p[..., None] * n + i_p[..., None] * k
    qn = q * (dh ** -0.5)
    num = torch.matmul(qn[..., None, :], C)[..., 0, :]
    den = torch.abs((n * qn).sum(-1))
    return num / torch.clamp(den, min=1.0)[..., None], (C, n, m_new)


def slstm_cell(c, n, m, g):
    """One stabilised sLSTM step, all f32.  c, n, m (..., nh, dh); g
    (..., 4, nh, dh) the combined pre-activations [z, i, f, o].  Returns
    (h (..., nh, dh), (c', n', m'))."""
    z = torch.tanh(g[..., 0, :, :])
    i = g[..., 1, :, :]
    logf = F.logsigmoid(g[..., 2, :, :])
    m_new = torch.maximum(logf + m, i)
    i_p = torch.exp(i - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    o = torch.sigmoid(g[..., 3, :, :])
    return o * c_new / torch.clamp(n_new, min=1.0), (c_new, n_new, m_new)


def xlstm_stacked_run(cfg, x0, kind, rows, states):
    """One run of same-kind xLSTM layers for one decode token: the body of
    ``repro/models/xlstm.py:575`` (``stacked_step``, launched through
    ``repro/kernels/decode_step.py:413``), for each layer of the run in
    order: x = x + block_step(x), the mLSTM block with its conv run inline
    (``conv_impl="xla"``, as ``repro``'s body forces).

    x0 (b, 1, d_model) in cfg.dtype; ``kind`` "mlstm" or "slstm"; ``rows``
    the layers' block params; ``states`` one state dict per layer.
    Returns (x (b, 1, d_model), the new state dicts)."""
    from repro_torch.models import xlstm   # models import kernels
    CALLS[f"{kind}_stacked_run"] += 1
    x = x0
    out = []
    for lp, state in zip(rows, states):
        if kind == "mlstm":
            y, ns = xlstm.mlstm_block_step(cfg, lp, x, state,
                                           conv_impl="xla")
        else:
            y, ns = xlstm.slstm_block_step(cfg, lp, x, state)
        x = x + y
        out.append(ns)
    return x, out


# ---------------------------------------------------------------------------
# The MARCA units standalone (K8, K9): the kernels' plain versions
# ---------------------------------------------------------------------------

def fast_exp(x, b_shift, c):
    """``repro/kernels/fast_exp.py:26``'s body: the biased fast exp of
    every element (``core.approx.fast_exp``), in x's dtype."""
    CALLS["fast_exp"] += 1
    return approx.fast_exp(x, b_shift, c)


def piecewise_silu(x, variant: str = "ours"):
    """``repro/kernels/piecewise_silu.py:26``'s body: the piecewise SiLU
    ("ours" or "paper") of every element, in x's dtype."""
    CALLS["piecewise_silu"] += 1
    if variant == "paper":
        return approx.piecewise_silu_paper(x)
    return approx.piecewise_silu(x)
