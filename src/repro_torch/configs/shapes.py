"""Assigned input-shape sets (LM-family: seq_len x global_batch).

  train_4k     seq 4,096   batch 256   -> lowers train_step
  prefill_32k  seq 32,768  batch 32    -> lowers prefill forward
  decode_32k   cache 32,768 batch 128  -> lowers serve_step (1 new token)
  long_500k    cache 524,288 batch 1   -> serve_step; SSM/hybrid only
                                          (sub-quadratic rule, DESIGN.md §5)

The port's own copy of ``repro/configs/shapes.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: Families with O(1)-state token mixing (sub-quadratic): run long_500k.
SUBQUADRATIC_FAMILIES = ("mamba", "xlstm", "jamba")


def applicable_shapes(cfg) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        out.append("long_500k")
    return out


def skip_reason(cfg, shape_name: str):
    if shape_name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return ("full-attention arch: O(L^2) at 524k; skipped per "
                "assignment rule (DESIGN.md §5)")
    return None
