"""Mamba inference op graph: op class, FLOPs, reads/writes per op.

This is the workload description that drives the MARCA cycle model, the
CPU/GPU baselines, the buffer-management simulator (Fig. 10) and the
compute-intensity / read-write-ratio analysis (Figs. 1 & 7).

Op classes follow the paper (§2.2, §6.1):
  linear — matmul/conv with a reduction dim (MM-RCU; intra-op input sharing)
  ew1    — element-wise map over equal-shaped operands (EW-RCU; no sharing):
           reads ~2N, writes N
  ew2    — element-wise *outer product* (EW-RCU): reads 2N, writes N^2
  exp / silu / softplus — nonlinear element-wise (EXP-/SiLU-RCU)
  norm   — RMSNorm (normalization unit)
  update — the L-step recurrent h update (the inter-op-BM target)

The port's own copy of ``repro/core/op_graph.py`` (pure Python, no
framework): the same ops, FLOPs and bytes for the same config.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

BYTES = 4          # the paper computes in 32-bit fixed point


@dataclasses.dataclass
class Op:
    name: str
    cls: str                   # linear | ew1 | ew2 | exp | silu | softplus | norm | update
    flops: float
    read: float                # bytes from memory hierarchy (pre-policy)
    write: float
    #: tensors produced/consumed for the buffer-manager simulation
    inputs: tuple = ()
    outputs: tuple = ()
    #: recurrence length: >1 marks the sequential h-update (baseline
    #: platforms execute it as `steps` separate dispatches; MARCA streams it)
    steps: int = 1
    #: output rows of a linear op (GEMM M-dim; drives utilization ramp)
    rows: int = 0

    @property
    def intensity(self) -> float:
        return self.flops / max(self.read + self.write, 1)

    @property
    def rw_ratio(self) -> float:
        return self.read / max(self.write, 1)


def t(name, *dims):
    """Tensor descriptor: (name, n_elements)."""
    n = 1
    for d in dims:
        n *= d
    return (name, n)


def mamba_block_ops(cfg, L: int, layer: int = 0) -> list:
    """One Mamba block forward at sequence length L (batch 1)."""
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.d_state
    r = cfg.dt_rank
    k = cfg.d_conv
    p = f"L{layer}."
    ops = []

    def add(name, cls, flops, inputs, outputs, steps=1):
        read = sum(x[1] for x in inputs) * BYTES
        write = sum(x[1] for x in outputs) * BYTES
        ops.append(Op(p + name, cls, flops, read, write,
                      tuple(inputs), tuple(outputs), steps,
                      rows=L if cls == "linear" else 0))

    x = t(p + "x", L, d)
    add("norm", "norm", 4 * L * d, [x], [t(p + "xn", L, d)])
    add("in_proj", "linear", 2 * L * d * 2 * di,
        [t(p + "xn", L, d), t(p + "Win", d, 2 * di)],
        [t(p + "xz", L, 2 * di)])
    add("conv1d", "linear", 2 * L * di * k,
        [t(p + "xz_x", L, di), t(p + "Wc", k, di)],
        [t(p + "xc", L, di)])
    add("silu_conv", "silu", 2 * L * di,
        [t(p + "xc", L, di)], [t(p + "xa", L, di)])
    add("x_proj", "linear", 2 * L * di * (r + 2 * n),
        [t(p + "xa", L, di), t(p + "Wx", di, r + 2 * n)],
        [t(p + "dbc", L, r + 2 * n)])
    add("dt_proj", "linear", 2 * L * r * di,
        [t(p + "dt_low", L, r), t(p + "Wdt", r, di)],
        [t(p + "dt_pre", L, di)])
    add("softplus", "softplus", 4 * L * di,
        [t(p + "dt_pre", L, di)], [t(p + "dt", L, di)])
    # dA = exp(dt (x) A): element-wise outer product then exp (EW2 + EXP)
    add("dA_outer", "ew2", L * di * n,
        [t(p + "dt", L, di), t(p + "A", di, n)],
        [t(p + "dA_pre", L, di, n)])
    add("dA_exp", "exp", 4 * L * di * n,
        [t(p + "dA_pre", L, di, n)], [t(p + "dA", L, di, n)])
    # dBx = (dt * x) (x) B  (EW1 then EW2)
    add("dtx", "ew1", L * di,
        [t(p + "dt", L, di), t(p + "xa", L, di)], [t(p + "dtx", L, di)])
    add("dBx_outer", "ew2", L * di * n,
        [t(p + "dtx", L, di), t(p + "B", L, n)],
        [t(p + "dBx", L, di, n)])
    # recurrent update h = dA*h + dBx over L steps (EW1 chain, the
    # inter-op-BM target: h + per-step slices of dA/dBx)
    add("h_update", "update", 2 * L * di * n,
        [t(p + "dA", L, di, n), t(p + "dBx", L, di, n),
         t(p + "h", di, n)],
        [t(p + "hs", L, di, n)], steps=L)
    # y = h . C (reduction over n=16 -> linear class, tiny K)
    add("yC", "linear", 2 * L * di * n,
        [t(p + "hs", L, di, n), t(p + "C", L, n)], [t(p + "y", L, di)])
    add("D_skip", "ew1", 2 * L * di,
        [t(p + "y", L, di), t(p + "xa", L, di), t(p + "D", di)],
        [t(p + "yd", L, di)])
    add("silu_z", "silu", 2 * L * di,
        [t(p + "xz_z", L, di)], [t(p + "zg", L, di)])
    add("gate", "ew1", L * di,
        [t(p + "yd", L, di), t(p + "zg", L, di)], [t(p + "yg", L, di)])
    add("out_proj", "linear", 2 * L * di * d,
        [t(p + "yg", L, di), t(p + "Wo", di, d)], [t(p + "out", L, d)])
    add("residual", "ew1", L * d,
        [t(p + "out", L, d), x], [t(p + "x_next", L, d)])
    return ops


def mamba_model_ops(cfg, L: int) -> list:
    """Full model forward (all layers + embed/unembed)."""
    ops = []
    ops.append(Op("embed", "linear", 0, L * 4, L * cfg.d_model * BYTES,
                  (t("tokens", L),), (t("emb", L, cfg.d_model),)))
    for i in range(cfg.n_layers):
        ops.extend(mamba_block_ops(cfg, L, i))
    ops.append(Op("lm_head", "linear", 2 * L * cfg.d_model * cfg.vocab,
                  cfg.d_model * cfg.vocab * BYTES + L * cfg.d_model * BYTES,
                  L * cfg.vocab * BYTES,
                  (t("xf", L, cfg.d_model), t("Wemb", cfg.vocab,
                                              cfg.d_model)),
                  (t("logits", L, cfg.vocab),), rows=L))
    return ops


CLASS_GROUPS = {
    "linear": ("linear",),
    "element-wise": ("ew1", "ew2", "update"),
    "nonlinear": ("exp", "silu", "softplus"),
    "other": ("norm",),
}


def group_of(cls: str) -> str:
    for g, members in CLASS_GROUPS.items():
        if cls in members:
            return g
    return "other"


def summarize(ops: Iterable[Op]) -> dict:
    out: dict = {}
    for op in ops:
        g = group_of(op.cls)
        d = out.setdefault(g, {"flops": 0.0, "read": 0.0, "write": 0.0,
                               "count": 0})
        d["flops"] += op.flops
        d["read"] += op.read
        d["write"] += op.write
        d["count"] += 1
    return out
