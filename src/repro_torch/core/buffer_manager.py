"""Intra-/inter-operation buffer management simulator (MARCA §6, Fig. 10).

Counts HBM traffic for the op stream from ``op_graph`` under the paper's two
policies.  The dataflow is tiled along the sequence dim (the RCUs stream
L-tiles), so "inter-op" residency is an *edge* property: a tensor produced
by an element-wise-class op is consumed tile-by-tile out of the on-chip
buffer and never round-trips HBM (dA, dBx, h in Fig. 8); capacity is
checked on the per-tile working set, not the full tensor.

  intra=True   linear ops are input-tiled: each operand read from HBM once.
  intra=False  the stationary operand (weights) is re-fetched once per
               output row-tile, bounded by a cache-absorption cap (the
               baseline platforms still have caches): refetch =
               min(ceil(rows/TILE), REFETCH_CAP).
  inter=True   EW-produced tensors stay on chip (fused chain).
  inter=False  every intermediate round-trips HBM (unfused baseline).

The port's own copy of ``repro/core/buffer_manager.py`` (pure Python).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core.op_graph import Op, BYTES

BUFFER_BYTES = 24 * 1024 * 1024      # MARCA on-chip buffer (Table 2)
TILE = 16                            # RCU tile edge (16x16 PEs)
REFETCH_CAP = 4                      # baseline cache absorption bound

EW_CLASSES = {"ew1", "ew2", "exp", "silu", "softplus", "norm", "update"}


@dataclasses.dataclass
class Traffic:
    read: float = 0.0
    write: float = 0.0

    @property
    def total(self) -> float:
        return self.read + self.write


def per_op_traffic(ops: Iterable[Op], intra: bool, inter: bool,
                   buffer_bytes: int = BUFFER_BYTES):
    """Yields (op, read_bytes, write_bytes) under the policy."""
    producer_cls: dict[str, str] = {}
    out = []
    for op in ops:
        read = write = 0.0
        is_linear = op.cls == "linear"
        n_out = sum(e for _, e in op.outputs)
        for i, (name, elems) in enumerate(op.inputs):
            nbytes = elems * BYTES
            # per-L-tile slice of an EW-produced tensor stays on chip
            if inter and producer_cls.get(name) in EW_CLASSES \
                    and nbytes / max(op.steps, TILE) * TILE < buffer_bytes:
                continue
            if is_linear and not intra and i > 0 and op.inputs:
                # stationary operand (weights) re-fetched per output
                # row-tile: rows = sqrt(elems_act * n_out / elems_w)
                e0 = op.inputs[0][1]
                rows = math.sqrt(max(e0 * n_out / max(elems, 1), 1.0))
                refetch = min(max(1.0, rows / TILE), REFETCH_CAP)
                read += nbytes * refetch
            else:
                read += nbytes
        for name, elems in op.outputs:
            producer_cls[name] = op.cls
            nbytes = elems * BYTES
            if inter and op.cls in EW_CLASSES \
                    and nbytes / max(op.steps, TILE) * TILE < buffer_bytes:
                continue                 # consumed downstream from buffer
            write += nbytes
        if op.cls == "update" and not inter and op.inputs:
            # unfused sequential recurrence: h round-trips HBM every step
            h_bytes = op.inputs[-1][1] * BYTES
            read += op.steps * h_bytes
            write += op.steps * h_bytes
        out.append((op, read, write))
    return out


def simulate(ops: Iterable[Op], intra: bool = True, inter: bool = True,
             buffer_bytes: int = BUFFER_BYTES) -> Traffic:
    tr = Traffic()
    for _, r, w in per_op_traffic(list(ops), intra, inter, buffer_bytes):
        tr.read += r
        tr.write += w
    return tr


def policy_table(ops) -> dict:
    ops = list(ops)
    return {
        "none": simulate(ops, intra=False, inter=False),
        "intra": simulate(ops, intra=True, inter=False),
        "inter": simulate(ops, intra=False, inter=True),
        "both": simulate(ops, intra=True, inter=True),
    }
