"""Cycle-approximate performance/energy models: MARCA, CPU, GPU (§7).

MARCA (Table 2): 32 RCUs x (16x16 RPEs) @ 1 GHz, 24 MB buffer, HBM1.0
256 GB/s, 10.44 W core power + 7 pJ/bit HBM energy.  Per op:
``cycles = max(compute_cycles, hbm_bytes/256B-per-cycle)`` with HBM bytes
from the buffer-management policy (buffer_manager.simulate).

Compute rates per mode (paper §4.3/§5.3):
  MM-RCU   16x16 MACs/RCU/cycle       -> 8192 MAC/cyc  = 16.4 TFLOP/s
  EW-RCU   1 op/RPE/cycle             -> 8192 op/cyc   =  8.2 Top/s
  EXP-RCU  4 cycles/element            (fast biased exp, Fig. 6)
  SiLU-RCU ~2.5 cycles/element         (0/2/4 EW ops per segment, eq. 3)

CPU (Xeon 8358P): 32c x 2.6 GHz x AVX-512 (2x16 f32 FMA) = 5.3 TFLOP/s
peak, 136.5 GB/s DDR4, ~10 us/op dispatch overhead (eager framework),
230 W package. GPU (A100): 19.5 TFLOP/s CUDA-core f32 for element-wise,
156 TFLOP/s effective TF32 tensor core for linears, 2039 GB/s HBM2e,
~5 us/kernel launch, 400 W.  Baselines run UNFUSED (policy "none"), which
is what the paper's Mamba-GPU measurement (pre-fused-kernel era) reflects.

These constants reproduce the paper's Fig. 9 speedups to within ~2x; the
calibration is documented in benchmarks/fig9_speedup.py and EXPERIMENTS.md.

The port's own copy of ``repro/core/marca_model.py`` (pure Python): the
paper's analytic model of MARCA and its baselines, not a measurement of
this port on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core import buffer_manager as bm
from repro_torch.core.op_graph import Op


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    linear_flops: float          # FLOP/s for reduction ops
    ew_flops: float              # FLOP/s for element-wise ops
    exp_flops: float             # FLOP/s for exp-class ops
    mem_bw: float                # B/s
    op_overhead_s: float         # per-op dispatch/launch overhead
    power_w: float               # core power
    hbm_pj_per_bit: float        # memory energy
    intra: bool                  # buffer policies in effect
    inter: bool
    #: reference-implementation sequential scan: the h-recurrence runs as
    #: `steps x scan_ops_per_step` separate dispatches (Mamba's
    #: selective_scan_ref loops over L in Python)
    sequential_scan: bool = False
    scan_ops_per_step: int = 6
    #: GEMM M-dim needed to saturate the linear unit (dataflow ~ a tile;
    #: GPU/CPU need hundreds of rows to fill SMs/cores)
    linear_sat_rows: int = 1


MARCA = Platform(
    name="MARCA",
    linear_flops=16.4e12,        # 8192 MAC/cyc * 2 * 1 GHz
    ew_flops=8.2e12,             # 8192 op/cyc (1 elem/RPE/cyc)
    exp_flops=8.2e12,            # EXP-RCU: 4-cycle latency, pipelined
    mem_bw=256e9,                # HBM1.0
    op_overhead_s=0.1e-6,        # decoded-instruction issue, no host
    power_w=10.44,               # Table 4
    hbm_pj_per_bit=7.0,          # [31]
    intra=True, inter=True,
    linear_sat_rows=16)          # systolic tile fills immediately

# Baseline derates calibrated against the paper's Fig. 9 envelope (the
# paper does not specify its software baselines beyond "Mamba-CPU" /
# "Mamba-GPU"; the reference Mamba release runs the scan as unfused eager
# element-wise ops, which is what these constants model — see
# EXPERIMENTS.md "Fig. 9 calibration").
CPU = Platform(
    name="Mamba-CPU",
    linear_flops=1.0e12,         # fp32 eager GEMM at bs=1 (no TF32 on CPU)
    ew_flops=0.15e12,            # eager EW chains: alloc+dispatch bound
    exp_flops=0.08e12,           # libm exp
    mem_bw=136.5e9 / 2,          # eager temporaries double the traffic
    op_overhead_s=60e-6,         # torch-CPU eager dispatch+alloc
    power_w=230.0,
    hbm_pj_per_bit=15.0,         # DDR4
    intra=True, inter=False,     # BLAS tiles; no cross-op fusion
    sequential_scan=True,        # selective_scan_ref: python loop over L
    linear_sat_rows=256)

GPU = Platform(
    name="Mamba-GPU",
    linear_flops=6.0e12,         # fp32 eager (TF32 off), bs=1 utilization
    ew_flops=9.7e12,             # CUDA cores, f32
    exp_flops=4.8e12,            # SFU
    mem_bw=2039e9,
    op_overhead_s=4e-6,          # kernel launch + framework
    power_w=400.0,
    hbm_pj_per_bit=7.0,
    intra=True, inter=False,     # cuBLAS tiles; unfused element-wise
    sequential_scan=True,        # selective_scan_ref: python loop over L
    linear_sat_rows=128)

#: Tensor-Core-only ablation (Fig. 10 top-left): element-wise ops forced
#: through the reduction array at 1/16 of the EW rate (paper §1/§4.1) and
#: no element-wise output-buffer policy (a TC pipeline has no EW residency).
TENSOR_CORE_ONLY = dataclasses.replace(
    MARCA, name="TensorCore-only", ew_flops=MARCA.ew_flops / 16,
    exp_flops=MARCA.ew_flops / 16, inter=False)


_CLS_RATE = {
    "linear": "linear_flops",
    "norm": "ew_flops",
    "ew1": "ew_flops",
    "ew2": "ew_flops",
    "update": "ew_flops",
    "exp": "exp_flops",
    "softplus": "exp_flops",
    "silu": "ew_flops",
}


def op_time(op: Op, plat: Platform, mem_bytes: float) -> float:
    rate = getattr(plat, _CLS_RATE.get(op.cls, "ew_flops"))
    if op.cls == "silu" and plat.name == "MARCA":
        rate = plat.ew_flops / 2.5 * 2.0     # ~2.5 cyc/elem on 2-op basis
    if op.cls == "linear" and op.rows and plat.linear_sat_rows > 1:
        rate = rate * min(1.0, op.rows / plat.linear_sat_rows)
    t_compute = op.flops / rate
    t_mem = mem_bytes / plat.mem_bw
    n_dispatch = 1
    if op.cls == "update" and plat.sequential_scan:
        n_dispatch = op.steps * plat.scan_ops_per_step
    return max(t_compute, t_mem) + plat.op_overhead_s * n_dispatch


def model_time(ops: Iterable[Op], plat: Platform) -> dict:
    """Returns dict with total seconds + per-class-group breakdown."""
    from repro_torch.core.op_graph import group_of
    ops = list(ops)
    total = 0.0
    by_group: dict = {}
    energy_j = 0.0
    for op, read, write in bm.per_op_traffic(ops, plat.intra, plat.inter):
        mem = read + write
        dt = op_time(op, plat, mem)
        total += dt
        g = group_of(op.cls)
        by_group[g] = by_group.get(g, 0.0) + dt
        energy_j += dt * plat.power_w + mem * 8 * plat.hbm_pj_per_bit * 1e-12
    return {"seconds": total, "by_group": by_group, "energy_j": energy_j,
            "platform": plat.name}


def speedup(ops, base: Platform, target: Platform = MARCA) -> float:
    return model_time(ops, base)["seconds"] / \
        model_time(ops, target)["seconds"]


def energy_ratio(ops, base: Platform, target: Platform = MARCA) -> float:
    return model_time(ops, base)["energy_j"] / \
        model_time(ops, target)["energy_j"]
