"""Build, load and call the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` have a plain C interface.  On
first use they are compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc``
per source (per set of defines, for a source in ``BUILDS``), all started
together — and linked into one shared library under ``<repo>/build/``,
named by a hash of the sources and flags so an edited source rebuilds.  The library is loaded with ``ctypes``; every C
entry point returns ``cudaGetLastError()`` and ``call`` raises if it is
not 0.  Nothing here runs at import: this module is imported on
machines without ``nvcc`` or a card, where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("selective_scan.cu", "conv1d.cu", "decode_step.cu",
           "decode_step_q.cu", "megakernel_mamba.cu",
           "megakernel_mamba_inst.cu", "megakernel_xlstm.cu",
           "megakernel_xlstm_inst.cu", "flash_attention.cu",
           "approx_units.cu")
#: the sources built more than once, each time with other -D defines: K3's
#: mamba/jamba and xLSTM instances' kernels once per (compute type, weight
#: type) pair, so the four of each compile in parallel
BUILDS = {"megakernel_mamba_inst.cu": tuple(
    (f"MB_ACT={a}", f"MB_W={w}") for a in (0, 1) for w in (0, 1)),
          "megakernel_xlstm_inst.cu": tuple(
    (f"XL_ACT={a}", f"XL_W={w}") for a in (0, 1) for w in (0, 1))}
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

# numbering shared with csrc/common.cuh
EXP_IMPLS = {"exact": 0, "ours": 1, "fast": 2}
SILU_IMPLS = {"exact": 0, "ours": 1, "paper": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float32: 2,
                torch.bfloat16: 3}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "marca_selective_scan": [_P] * 10 + [_I] * 4 + [_L] * 10
    + [_I] * 3 + [_P],
    "marca_causal_conv1d": [_P] * 6 + [_I] * 4 + [_L] * 2 + [_I, _P],
    "marca_decode_step": [_P] * 11 + [_I] * 3 + [_L] * 5 + [_I] * 3 + [_P],
    "marca_decode_step_shape": [_I, _I, _P],
    "marca_decode_step_q": [_P] * 13 + [_I] * 4 + [_L] * 5 + [_I] * 4
    + [_P],
    "marca_decode_step_q_shape": [_I, _I, _P],
    "marca_mamba_stacked_step": [_P] * 2 + [_I] + [_P] * 9 + [_L]
    + [_I] * 12 + [_P],
    "marca_mamba_stack_maps": [_P] + [_I] * 5 + [_P] * 2,
    "marca_mamba_stacked_grid": [_I] * 6 + [_P],
    "marca_jamba_stacked_run": [_P] * 5 + [_L] + [_I] * 13 + [_P],
    "marca_flash_attention": [_P] * 4 + [_I] * 6 + [_F, _I, _I, _P],
    "marca_xlstm_stacked_run": [_P] * 5 + [_L] + [_I] * 10 + [_F, _P],
    "marca_xlstm_stacked_grid": [_I] * 4 + [_P],
    "marca_fast_exp": [_P, _P, _L, _I, _F, _F, _P],
    "marca_piecewise_silu": [_P, _P, _L, _I, _I, _P],
}

_lib = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr((SOURCES, BUILDS)).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD / f"libmarca_{_digest()}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists.
    Returns the library's path; the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it
    in a ``.log`` file."""
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD))
    cc = nvcc()
    units = [(src, defs) for src in SOURCES
             for defs in BUILDS.get(src, ((),))]
    objs = [tmp / ("_".join([src[:-3], *defs]).replace("=", "") + ".o")
            for src, defs in units]
    procs = [subprocess.Popen(
        [cc, *NVCC_FLAGS, *(f"-D{d}" for d in defs), "-I", str(CSRC), "-c",
         str(CSRC / src), "-o", str(obj)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for (src, defs), obj in zip(units, objs)]
    log = []
    for (src, defs), p in zip(units, procs):
        out, _ = p.communicate()
        log.append(f"== nvcc {' '.join([src, *defs])} (exit {p.returncode})"
                   f"\n{out}")
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + "\n".join(log))
    tmp_so = tmp / so.name
    link = subprocess.run([cc, *ARCH, "-shared", "-o", str(tmp_so),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    so.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp_so, so)
    shutil.rmtree(tmp, ignore_errors=True)
    return so


def build_log() -> str:
    return library_path().with_suffix(".log").read_text()


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


# the current stream's handle as an int without building a Stream object
# (torch's own generated code reads it so), else through the public API
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def call(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device``'s current stream; raise on a CUDA
    error reported right after the launch.  The device is made current
    only where it is not already: switching costs the eager caller more
    than the launch."""
    fn = getattr(lib(), name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        rc = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _stream(index))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Argument checks shared by the wrappers.  They run on every launch, so a
# message is formatted only when a check fails.
# ---------------------------------------------------------------------------

def ptr(t):
    return None if t is None else t.data_ptr()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_same_device(device, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_rows(name, t, dtype, shape) -> None:
    """A token-stream input: given dtype and shape, unit stride on the
    last axis (any row strides, so strided views pass uncopied)."""
    if t is None:
        return
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride on its last axis")


def check_dense(name, t, dtype, shape) -> None:
    """A parameter or state input: given dtype and shape, contiguous."""
    if t is None:
        return
    check_rows(name, t, dtype, shape)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(nbytes: int, **tensors) -> None:
    """Each tensor starts on an ``nbytes`` boundary (a kernel that moves
    it in vectors of that size needs it)."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % nbytes:
            raise ValueError(f"{name} must start on a {nbytes}-byte "
                             f"boundary")


def check_impls(exp_impl: str, silu_impl: str) -> None:
    if exp_impl not in EXP_IMPLS:
        raise ValueError(f"unknown exp_impl {exp_impl!r}")
    if silu_impl not in SILU_IMPLS:
        raise ValueError(f"unknown silu_impl {silu_impl!r}")


def check_a(A, a_scale, d, n) -> None:
    """The SSM A of a decode step: f32 (d, n), or int8 codes (d, n) with
    their per-row f32 scales a_scale (d,)."""
    check_dense("A", A, torch.float32 if a_scale is None else torch.int8,
                (d, n))
    check_dense("a_scale", a_scale, torch.float32, (d,))


def check_no_grad(kernel: str, *tensors, trainable: bool = False) -> None:
    """Refuse a raw kernel call that autograd would cut: with grad mode on,
    an input that requires grad (or ``trainable``, the flag of a weight
    table built over such inputs) would get no gradient through the
    kernel's fresh output.  The kernels with a backward run under their
    ``torch.autograd.Function`` (``kernels.ops``), where grad mode is off
    inside forward and backward; serving runs under ``torch.no_grad()``
    or on weights that do not require grad."""
    if not torch.is_grad_enabled():
        return
    if trainable or any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad and the kernel has no "
            f"backward of its own; call it under torch.no_grad(), or "
            f"through kernels.ops, whose autograd Function carries the "
            f"gradient")


def check_dtype(t) -> None:
    if t.dtype not in DTYPES:
        raise ValueError(f"kernels take float32 or bfloat16 inputs, got "
                         f"{t.dtype}")
