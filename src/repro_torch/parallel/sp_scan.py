"""Sequence-parallel selective scan (port of ``repro/parallel/sp_scan.py``).

The selective-SSM recurrence is an affine monoid, so a sequence split
over the ranks of a mesh axis scans in two local passes and one small
exchange of segment summaries:

  pass 1 (local):  one scan-kernel launch (K4 on the card) over the
                   rank's chunk from h0 = 0, with no D and no z ->
                   y_local and the summary (A_seg, b_seg): A_seg =
                   exp(A * sum_t dt_t), b_seg = the chunk's h_last.
  exchange:        all-gather of the (b, d, n) summaries, then the
                   exclusive prefix-combine of the ranks before this one
                   (h0 = A_i h0 + b_i in rank order), in PyTorch.
  pass 2 (local):  the correction y_t += C_t . (exp(A * cumsum(dt)_t) h0)
                   in PyTorch, then D x and the SiLU(z) gate.

``h_last`` is the last rank's state, on every rank.  Semantics are
``kernels.ref.selective_scan``'s over the whole sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel import sharding


def sp_selective_scan(mesh, x, dt, A, B, C, D=None, z=None,
                      axis_name: str = "sp"):
    """x/dt/z (b, l, d) and B/C (b, l, n): this rank's chunk of a
    sequence split over ``axis_name`` in rank order; A (d, n), D (d,)
    replicated.  Returns (y (b, l, d) in x's dtype, h_last (b, d, n) f32
    of the whole sequence)."""
    S = mesh.shape[axis_name]
    idx = mesh.coords[axis_name]
    # pass 1: one kernel launch from zero, no D, no z
    y_local, b_seg = ops.selective_scan(x, dt, A, B, C)
    dtf = dt.float()
    A_seg = torch.exp(dtf.sum(1)[..., None] * A[None])        # (b, d, n)

    with sharding.use_mesh(mesh):
        A_all = sharding.all_gather_cat(A_seg[None], 0, axis_name)
        b_all = sharding.all_gather_cat(b_seg[None], 0, axis_name)
    h0 = torch.zeros_like(b_seg)
    for i in range(idx):
        h0 = A_all[i] * h0 + b_all[i]

    # pass 2: y_t += C_t . (Acum_t * h0), Acum_t = exp(A * cumsum(dt)_t)
    acum = torch.exp(torch.cumsum(dtf, dim=1)[..., None] * A[None, None])
    corr = torch.einsum("bldn,bdn,bln->bld", acum, h0, C.float())
    y = y_local.float() + corr
    # h_last: the last rank's, on every rank (a sum with one nonzero term)
    h_mine = A_seg * h0 + b_seg
    with sharding.use_mesh(mesh):
        h_last = sharding.all_reduce_sum(
            h_mine if idx == S - 1 else torch.zeros_like(h_mine),
            axis_name)
    if D is not None:
        y = y + D[None, None, :] * x.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), h_last
