"""Kernel launches per call, from the kernel wrappers' own counters.

The port's counterpart of ``repro/core/dispatch_count.py``, which counts
``pallas_call`` equations in a traced jaxpr.  PyTorch runs eagerly, so
here the call is made once and the counters are read around it: on the
card each wrapper adds one to its count where it launches its kernel; on
the CPU the wrappers take the plain versions, which count their entries
in ``kernels.ref.CALLS``.  The megakernel path (K3) is one launch per
decoded token.  The per-layer fused path is two per layer: ``repro``'s
pin is n_layers because its default conv is XLA, while in the port the
conv is a kernel (K5) under every ``conv_impl``, beside the step kernel.

Jamba's pins per decoded token (one group of 8, attention at position 4,
which is plain PyTorch at decode): through K3, one launch per pure-SSM
run plus the conv and step kernels of each mamba position with MoE --
3 + 4 x 2 = 11 on the MoE config, 2 on the dense variant -- against
7 x 2 = 14 per layer; ``repro`` pins 7 and 2 against 7.  A prefill
launches per group 7 scans, 7 convs and one flash attention (K7).
"""
from __future__ import annotations

import collections

from repro_torch.kernels import conv1d, decode_step, fast_exp
from repro_torch.kernels import flash_attention, megakernel, piecewise_silu
from repro_torch.kernels import ref, selective_scan

#: every kernel launch counter: name -> (wrapper module, attribute)
COUNTERS = {
    "selective_scan": (selective_scan, "launches"),
    "causal_conv1d": (conv1d, "launches"),
    "decode_step": (decode_step, "launches"),
    "decode_step_int8a": (decode_step, "launches_int8a"),
    "decode_step_q": (decode_step, "launches_q"),
    "mamba_stacked_step": (megakernel, "launches"),
    "mamba_stacked_step_int8a": (megakernel, "launches_int8a"),
    "mamba_stacked_step_q": (megakernel, "launches_q"),
    "mamba_stacked_step_q_int8a": (megakernel, "launches_q_int8a"),
    "jamba_stacked_run": (megakernel, "jamba_launches"),
    "jamba_stacked_run_int8a": (megakernel, "jamba_launches_int8a"),
    "jamba_stacked_run_q": (megakernel, "jamba_launches_q"),
    "jamba_stacked_run_q_int8a": (megakernel, "jamba_launches_q_int8a"),
    "mlstm_stacked_run": (megakernel, "mlstm_launches"),
    "mlstm_stacked_run_int8w": (megakernel, "mlstm_launches_int8w"),
    "mlstm_stacked_run_q": (megakernel, "mlstm_launches_q"),
    "mlstm_stacked_run_q_int8w": (megakernel, "mlstm_launches_q_int8w"),
    "slstm_stacked_run": (megakernel, "slstm_launches"),
    "slstm_stacked_run_int8w": (megakernel, "slstm_launches_int8w"),
    "flash_attention": (flash_attention, "launches"),
    "fast_exp": (fast_exp, "launches"),
    "piecewise_silu": (piecewise_silu, "launches"),
}


def snapshot() -> collections.Counter:
    """Every kernel's launch count by name, and every plain version's
    entries as ``"plain " + name``."""
    out = collections.Counter({name: getattr(mod, attr)
                               for name, (mod, attr) in COUNTERS.items()})
    out.update({"plain " + k: v for k, v in ref.CALLS.items()})
    return out


def reset() -> None:
    """Set every launch count and every plain-version count to 0."""
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    ref.CALLS.clear()


def launch_counts(fn, *args, **kwargs) -> collections.Counter:
    """What one call ``fn(*args, **kwargs)`` launched, by name (kernels
    on the card, ``"plain ..."`` entries on the CPU)."""
    before = snapshot()
    fn(*args, **kwargs)
    after = snapshot()
    after.subtract(before)
    return +after


def count_launches(fn, *args, **kwargs) -> int:
    """The number of kernel launches (on the card) or plain-version
    entries (on the CPU) one call of ``fn`` makes."""
    return sum(launch_counts(fn, *args, **kwargs).values())
