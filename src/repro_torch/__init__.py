"""PyTorch + CUDA port of the MARCA serving path (``repro`` is the JAX
reference beside it).

The port imports ``torch`` and never ``jax`` or ``repro``.  Every TPU
kernel on a ported path is a CUDA C++ kernel for Hopper (``csrc/``,
built with ``nvcc`` for ``sm_90a`` on first use); each kernel's wrapper
takes the kernel's plain PyTorch version only for a tensor on the CPU.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and no card is present — the
    port never falls back to the CPU on its own.

    On CUDA it also turns TF32 off for matrix products and convolutions:
    the GEMMs the port leaves to ``torch.matmul`` then run in full f32,
    as ``repro`` leaves them to XLA, and f32 results can be held against
    the plain versions at f32 tolerances."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
