"""Mamba block (Gu & Dao 2023): the port of ``repro/models/mamba.py``
(block apply :103, step :131, megastep :173, the speculative verify
window :222-278, state init :280), with f32 or int8 weights and f32,
bf16, int8 or fp8 pooled state.

Per block: in_proj -> [x | z] -> causal depthwise conv (CUDA kernel) ->
SiLU -> x_proj -> (dt, B, C) -> softplus(dt_proj) -> selective scan at
prefill / fused decode step per token (CUDA kernels) -> out_proj.

x_in and z are views of one in_proj output, and dt_low, B and C views
of one x_proj output (as ``jnp.split`` gives in repro); the kernels take
their row strides, so no copy is made.

With int8 weights (``A_q``/``A_scale`` in place of ``A_log``) the decode
step hands the codes and scales to the kernel, which dequantizes A
itself; prefill dequantizes A up front with the same multiply.  With an
int8/fp8 state the step runs the quantized-state kernel, and prefill
quantizes its final state from a cold start.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import approx, selective_scan, state_quant
from repro_torch.core import weight_quant
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks


def mamba_block_init(cfg, gen):
    d, di, n, k, r = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv,
                      cfg.dt_rank)
    # S4D-real initialization for A; dt bias init for softplus range
    a_init = torch.arange(1, n + 1, dtype=torch.float32)[None, :].repeat(di, 1)
    dt_init = torch.exp(torch.rand(di, generator=gen, device=gen.device)
                        * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return {
        "in_proj": blocks.dense_init(gen, d, 2 * di),
        "conv_w": torch.randn(k, di, generator=gen, device=gen.device)
        * (1.0 / k),
        "conv_b": torch.zeros(di),
        "x_proj": blocks.dense_init(gen, di, r + 2 * n),
        "dt_proj": blocks.dense_init(gen, r, di, scale=r ** -0.5),
        "dt_bias": dt_bias,
        "A_log": torch.log(a_init),
        "D": torch.ones(di),
        "out_proj": blocks.dense_init(gen, di, d),
    }


def _project(cfg, p, x):
    """in_proj -> (x_in, z), two views of one (b, l, 2*di) output."""
    xz = blocks.dense(p["in_proj"], x, x.dtype)
    return xz.chunk(2, dim=-1)


def _ssm_inputs(cfg, p, x_a):
    """x_a (b, l, di) -> dt (b, l, di), B (b, l, n), C (b, l, n)."""
    n, r = cfg.d_state, cfg.dt_rank
    cdt = x_a.dtype
    dbc = blocks.dense(p["x_proj"], x_a, cdt)
    dt_low, B, C = dbc.split([r, n, n], dim=-1)
    dt = blocks.dense(p["dt_proj"], dt_low, cdt)
    dt = F.softplus(dt.float() + p["dt_bias"]).to(cdt)
    return dt, B, C


def _a_and_scale(p):
    """A as the step consumes it: (A, a_scale).  f32 weights recompute
    A = -exp(A_log) and carry no scale; int8 weights give the stored
    codes and their per-channel scales, dequantized where consumed."""
    if "A_q" in p:
        return p["A_q"], p["A_scale"]
    return -torch.exp(p["A_log"]), None


def read_state_h(cfg, state):
    """The stored state as the f32 the scan and step take: a cast for an
    f32/bf16 pool, a dequantization with the group scales
    (``state["h_scale"]``) for an int8/fp8 one."""
    if state_quant.is_quantized(cfg.state_dtype):
        return state_quant.dequantize_h(state["h"], state["h_scale"])
    return state["h"].float()


def write_state_h(cfg, h, prev_state=None):
    """The {"h"} (+ "h_scale") leaves storing the f32 state ``h``.
    ``prev_state`` gives the previous scales to the running-absmax
    update; None is a cold start (prefill)."""
    if state_quant.is_quantized(cfg.state_dtype):
        prev = None if prev_state is None else prev_state["h_scale"]
        q, scale = state_quant.quantize_h(h, cfg.state_dtype,
                                          prev_scale=prev)
        return {"h": q, "h_scale": scale}
    return {"h": h.to(ops.storage_dtype(cfg.state_dtype))}


def mamba_block_apply(cfg, p, x, state=None):
    """Full-sequence path.  state (continuation) is a dict with 'h'
    (b, di, n) and 'conv' (b, k-1, di); returns (y, new_state)."""
    silu = approx.get_silu(cfg.silu_impl)
    x_in, z = _project(cfg, p, x)
    conv_state = None if state is None else state["conv"]
    x_c, new_conv = ops.causal_conv1d(x_in, p["conv_w"], p["conv_b"],
                                      x_prev=conv_state, impl=cfg.conv_impl)
    x_a = silu(x_c)
    dt, B, C = _ssm_inputs(cfg, p, x_a)
    A, a_scale = _a_and_scale(p)
    if a_scale is not None:
        # prefill is compute-bound: dequantize A up front, with the
        # multiply the decode kernels run in their dequant phase
        A = weight_quant.dequantize_rows(A, a_scale)
    h0 = None if state is None else read_state_h(cfg, state)
    y, h_last = ops.selective_scan(x_a, dt, A, B, C, D=p["D"], z=z, h0=h0,
                                   impl=cfg.scan_impl,
                                   exp_impl=cfg.exp_impl,
                                   silu_impl=cfg.silu_impl)
    out = blocks.dense(p["out_proj"], y, x.dtype)
    return out, {**write_state_h(cfg, h_last, prev_state=state),
                 "conv": new_conv}


def mamba_block_step(cfg, p, x_t, state):
    """Single-token decode over the slot pool.  x_t (b, 1, d); state as
    above.  The conv tail update is the L=1 case of the conv kernel; the
    SSM step is one launch of the fused decode-step kernel."""
    silu = approx.get_silu(cfg.silu_impl)
    x_in, z = _project(cfg, p, x_t)                       # (b, 1, di)
    x_c, new_conv = ops.causal_conv1d(x_in, p["conv_w"], p["conv_b"],
                                      x_prev=state["conv"],
                                      impl=cfg.conv_impl)
    x_a = silu(x_c)
    dt, B, C = _ssm_inputs(cfg, p, x_a)
    A, a_scale = _a_and_scale(p)
    if state_quant.is_quantized(cfg.state_dtype):
        # dequant on read and requant on write stay inside the kernel:
        # the pooled h never reaches device memory at f32
        y, hq, scale = ops.selective_state_step_q(
            state["h"], state["h_scale"], x_a[:, 0], dt[:, 0], A, B[:, 0],
            C[:, 0], D=p["D"], z_t=z[:, 0], state_dtype=cfg.state_dtype,
            impl=cfg.step_impl, exp_impl=cfg.exp_impl,
            silu_impl=cfg.silu_impl, a_scale=a_scale)
        out = blocks.dense(p["out_proj"], y[:, None, :], x_t.dtype)
        return out, {"h": hq, "h_scale": scale, "conv": new_conv}
    y, h = ops.selective_state_step(
        read_state_h(cfg, state), x_a[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
        D=p["D"], z_t=z[:, 0], impl=cfg.step_impl, exp_impl=cfg.exp_impl,
        silu_impl=cfg.silu_impl, a_scale=a_scale)
    out = blocks.dense(p["out_proj"], y[:, None, :], x_t.dtype)
    return out, {**write_state_h(cfg, h), "conv": new_conv}


def mamba_block_megastep(cfg, p, x_t, state):
    """``mamba_block_step`` as the body of the cross-layer megakernel's
    plain version (``kernels.ref.mamba_stacked_step``): the same
    signature and the same values, bit for bit on the CPU, with the conv
    tail and the S6 step run inline through the plain versions' uncounted
    bodies, as ``repro``'s megastep runs its reference conv and cell
    inside the launch.  K3 (``csrc/megakernel_mamba.cu``) computes this
    chain on the card."""
    silu = approx.get_silu(cfg.silu_impl)
    x_in, z = _project(cfg, p, x_t)                       # (b, 1, di)
    x_c, new_conv = ref.conv_math(x_in, p["conv_w"], p["conv_b"],
                                  x_prev=state["conv"])
    x_a = silu(x_c)
    dt, B, C = _ssm_inputs(cfg, p, x_a)
    A, a_scale = _a_and_scale(p)
    step = (x_a[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], p["D"], z[:, 0])
    if state_quant.is_quantized(cfg.state_dtype):
        y, hq, scale = ref.step_q_math(
            state["h"], state["h_scale"], *step, cfg.state_dtype,
            cfg.exp_impl, cfg.silu_impl, a_scale)
        new_state = {"h": hq, "h_scale": scale}
    else:
        y, h = ref.step_math(read_state_h(cfg, state), *step, cfg.exp_impl,
                             cfg.silu_impl, a_scale)
        new_state = write_state_h(cfg, h)
    out = blocks.dense(p["out_proj"], y[:, None, :], x_t.dtype)
    return out, {**new_state, "conv": new_conv}


def _conv_tail_states(conv_state, x_in):
    """Per-step conv tails over a K-token window: conv_state (b, k-1, di)
    the tail entering the window, x_in (b, K, di) the window's raw conv
    inputs.  Returns (b, K, k-1, di), entry t the tail the conv returns
    after tokens 0..t, so a rollback to step t restores the tail a
    per-token decode would hold."""
    k1, K = conv_state.shape[1], x_in.shape[1]
    full = torch.cat([conv_state, x_in.to(conv_state.dtype)], dim=1)
    idx = (torch.arange(K, device=full.device)[:, None]
           + torch.arange(k1, device=full.device)[None, :] + 1)
    return full[:, idx]


def mamba_block_verify(cfg, p, x, state):
    """K-token verify window (speculative decoding): K chained
    ``mamba_block_step`` calls in meaning, with the front end
    (projections, one conv launch over the window with the tail passed
    in, dt/B/C) run over the whole window and only the SSM recurrence
    chained, as the micro-scan ``core.selective_scan.decode_scan`` (one
    decode-step launch a token) that returns every intermediate state.

    x (b, K, d_model); state as in ``mamba_block_step``.  Returns (out
    (b, K, d_model), states), each state leaf stacked per step on axis 1
    (states[:, t] the state after token t).  A megakernel config runs
    the per-layer step kernels here (``ops.resolve_cell_impl``)."""
    silu = approx.get_silu(cfg.silu_impl)
    x_in, z = _project(cfg, p, x)                         # (b, K, di)
    x_c, _ = ops.causal_conv1d(x_in, p["conv_w"], p["conv_b"],
                               x_prev=state["conv"], impl=cfg.conv_impl)
    conv_all = _conv_tail_states(state["conv"], x_in)
    x_a = silu(x_c)
    dt, B, C = _ssm_inputs(cfg, p, x_a)
    A, a_scale = _a_and_scale(p)
    impl = ops.resolve_cell_impl(cfg.step_impl, x.device)
    common = dict(D=p["D"], z_seq=z, impl=impl, exp_impl=cfg.exp_impl,
                  silu_impl=cfg.silu_impl, a_scale=a_scale)
    if state_quant.is_quantized(cfg.state_dtype):
        y, hq_all, scale_all = selective_scan.decode_scan_q(
            state["h"], state["h_scale"], x_a, dt, A, B, C,
            state_dtype=cfg.state_dtype, **common)
        out = blocks.dense(p["out_proj"], y, x.dtype)
        return out, {"h": hq_all, "h_scale": scale_all, "conv": conv_all}
    y, h_all = selective_scan.decode_scan(read_state_h(cfg, state), x_a, dt,
                                          A, B, C, **common)
    out = blocks.dense(p["out_proj"], y, x.dtype)
    return out, {"h": h_all.to(ops.storage_dtype(cfg.state_dtype)),
                 "conv": conv_all}


def mamba_state_init(cfg, batch, dtype, device):
    di, n, k = cfg.d_inner, cfg.d_state, cfg.d_conv
    out = {
        "h": torch.zeros(batch, di, n, dtype=ops.storage_dtype(
            cfg.state_dtype), device=device),
        "conv": torch.zeros(batch, k - 1, di, dtype=dtype, device=device),
    }
    if state_quant.is_quantized(cfg.state_dtype):
        # zero scales decode the zero state exactly; the first write
        # (prefill quantize or step requant) sets real scales
        out["h_scale"] = torch.zeros(batch, state_quant.n_groups(di),
                                     dtype=torch.float32, device=device)
    return out
