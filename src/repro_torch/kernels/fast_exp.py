"""Fast biased exponential (K8, MARCA EXP-RCU mode): wrapper over the CUDA
kernel ``csrc/approx_units.cu``.

Port of ``repro/kernels/fast_exp.py`` (Pallas ``_fast_exp_kernel``,
pallas_call at :41): ``core.approx.fast_exp`` element-wise over a
contiguous f32 or bf16 tensor, computed in f32 and rounded once to the
input's dtype, bit for bit the plain version.  On a CUDA tensor the
kernel runs; on a CPU tensor the plain version (``kernels.ref.fast_exp``)
does.

Special values, on which the plain version, the kernel and ``repro``
agree:

- x is clamped to [-80, 80] first, so -inf and everything below -80 give
  the value at -80 (1.8289e-35 with the "fast" bias and c = 0, c itself,
  5.6e-07, with "ours"), and +inf and everything above 80 the value at 80
  (5.61e34 "fast", 5.74e34 "ours"): the result is always finite.
- NaN survives the clamp (as in ``torch.clamp`` / ``jnp.clip``), and the
  truncating cast of NaN gives 0 on the card and in ``repro`` (INT_MIN,
  whose bits are -0.0, on the CPU), so the result is +0.0 + c: 0.0 with
  "fast", c with "ours".  It is never NaN.
- +-0 and subnormals give the value at 0 (0.9675 "fast", 0.9826 "ours").
- In bf16 the f32 result is rounded once to nearest even.
"""
from __future__ import annotations

import torch

from repro_torch.core import approx
from repro_torch.kernels import _lib, ref

#: kernel launches made by this wrapper
launches = 0


def fast_exp(x, b_shift: float = approx.OUR_EXP_B_SHIFT,
             c: float = approx.OUR_EXP_C):
    """exp(x) by the exponent-field trick with bias ``b_shift`` and final
    add ``c`` (defaults: the paper's "Our_exp").  Returns a new tensor of
    x's shape and dtype."""
    global launches
    _lib.check_no_grad("fast_exp", x)
    _lib.check_dtype(x)
    if x.device.type == "cpu":
        return ref.fast_exp(x, b_shift, c)
    _lib.require(x.is_contiguous(), "fast_exp takes a contiguous tensor")
    y = torch.empty_like(x)
    if x.numel():
        _lib.call("marca_fast_exp", x.device, _lib.ptr(x), _lib.ptr(y),
                  x.numel(), _lib.DTYPES[x.dtype],
                  approx._f32((127.0 + b_shift) * approx._S23),
                  approx._f32(c))
        launches += 1
    return y
