#!/usr/bin/env python3
"""K8 (fast exp) and K9 (piecewise SiLU) alone on the card.

Builds only ``approx_units.cu`` (seconds, where the whole library takes
half a minute), prints the compiler's register and spill report and each
instantiation's 128-bit global loads and stores (and FMUL, FADD, FFMA,
LDS and all instructions) from ``cuobjdump -sass``, holds both kernels against their plain
versions bit for bit over every bf16 and every f32 bit pattern, the
special values and the SiLU breaks, ragged sizes and offset views
(``chip_smoke.check_unit_values``), then times the eight rows (K8 "ours"
and "fast", K9 "ours" and "paper", f32 and bf16, 16 M elements) beside
``torch.exp`` / ``F.silu`` with ``chip_smoke.py``'s CUDA-graph harness.
Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_k8_k9.py [--quick]

``--quick`` skips the f32 sweep (16 chunks of 2^28 bit patterns).  It
exits non-zero if a check fails.
"""
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

ENTRIES = ("marca_fast_exp", "marca_piecewise_silu")


def build():
    """Build and load a library of approx_units.cu alone (its own hash);
    returns its path."""
    from repro_torch.kernels import _lib
    _lib.SOURCES = ("approx_units.cu",)
    _lib.BUILDS = {}
    _lib._SIGNATURES = {k: v for k, v in _lib._SIGNATURES.items()
                        if k in ENTRIES}
    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    cs.log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    cs.log(_lib.build_log())
    return so


def timing(dev):
    """The eight rows at 16 M elements: chip_smoke's ``measure`` (device
    time of a graph of 20 calls, eager time, device kernels a call, the
    plain version, the library call, the bound)."""
    for name, impl, kern, plain, lib in cs.unit_cases():
        for dt, eb in ((torch.float32, 4), (torch.bfloat16, 2)):
            x = cs.unit_input(cs.UNIT_N, dt, cs.SEED + 320, dev)
            tag = "f32" if dt == torch.float32 else "bf16"
            ops_per = 4 if name == "fast_exp" else 8
            row = cs.measure(
                name, f"n=16777216 {tag}, {impl}",
                lambda x=x, kern=kern: kern(x),
                lambda x=x, plain=plain: plain(x),
                lambda x=x, lib=lib: lib(x),
                (2 * cs.UNIT_N * eb, ops_per * cs.UNIT_N), 20)
            cs.log(f"    {name} {impl} {tag}: {row['ms'] * 1e3:.2f} us, "
                   f"library {row['library_ms'] * 1e3:.2f} us "
                   f"({row['ms'] / row['library_ms']:.3f}x), bound "
                   f"{row['bound_ms'] * 1e3:.2f} us "
                   f"({row['bound_ms'] / row['ms']:.0%} reached)")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k8_k9: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.log(cs.card_line())
    so = build()
    cs.check_unit_sass(so)
    t0 = time.perf_counter()
    cs.check_unit_values(dev, sweep="--quick" not in sys.argv)
    cs.log(f"checks took {time.perf_counter() - t0:.1f} s")
    timing(dev)
    cs.log(f"failures: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
