"""The port's kernels: the plain versions (repro_torch.kernels.ref) against
repro's Pallas kernels run in interpret mode on the same seeded numpy
inputs; the wrappers' CPU route, argument checks and launch counts; the
ctypes signatures against the C entry points; and, on a machine with a
card, each CUDA kernel against its plain version (marked ``gpu``).

Tolerances are repro's own for these kernels (tests/test_kernels.py,
tests/test_decode_step.py): scan 5e-4, conv 1e-5, decode step 1e-5 in
f32; bf16 outputs round once more, at repro's bf16 tolerances.
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv1d as jconv
from repro.kernels import decode_step as jstep
from repro.kernels import selective_scan as jscan
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels import conv1d as tconv
from repro_torch.kernels import decode_step as tstep
from repro_torch.kernels import selective_scan as tscan

from _torch_inputs import (STREAM, VARIANTS, close, np_input, scan_arrays,
                           scan_call, step_arrays, to_torch)

jax.config.update("jax_platform_name", "cpu")


def to_jax(arrs, dtype="float32"):
    return {k: None if v is None else
            jnp.asarray(v).astype(dtype if k in STREAM else "float32")
            for k, v in arrs.items()}


# ---------------------------------------------------------------------------
# Plain versions vs repro's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,L,d,n,h0", [(1, 16, 32, 16, True),
                                        (2, 37, 40, 16, True),
                                        (3, 21, 24, 8, False)])
def test_scan_plain_matches_pallas(b, L, d, n, h0):
    """block_l=16, block_d=32 put a padded tail on L and d."""
    a = scan_arrays(b, L, d, n, seed=b, h0=h0)
    yj, hj = jscan.selective_scan(**to_jax(a), block_d=32, block_l=16)
    yt, ht = ref.selective_scan(**to_torch(a))
    close(yt, yj, 5e-4)
    close(ht, hj, 5e-4)


@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
def test_scan_plain_matches_pallas_approx(exp_impl, silu_impl):
    a = scan_arrays(2, 24, 32, 16, seed=11)
    kw = dict(exp_impl=exp_impl, silu_impl=silu_impl)
    yj, hj = jscan.selective_scan(**to_jax(a), block_d=32, block_l=8, **kw)
    yt, ht = ref.selective_scan(**to_torch(a), **kw)
    close(yt, yj, 5e-4)
    close(ht, hj, 5e-4)


def test_scan_plain_matches_pallas_bf16():
    a = scan_arrays(2, 20, 32, 16, seed=13)
    yj, hj = jscan.selective_scan(**to_jax(a, "bfloat16"), block_d=32,
                                  block_l=8)
    yt, ht = ref.selective_scan(**to_torch(a, "bfloat16"))
    assert yt.dtype == torch.bfloat16 and ht.dtype == torch.float32
    close(yt, np.asarray(yj, np.float32), 2e-2)
    close(ht, hj, 1e-3)


@pytest.mark.parametrize("b,L,d,k,prev", [(1, 16, 8, 4, True),
                                          (2, 37, 40, 4, True),
                                          (3, 5, 17, 3, False),
                                          (4, 1, 24, 4, True),
                                          # L < k-1: the tail keeps
                                          # x_prev's rows, shifted by L
                                          (2, 2, 40, 4, True),
                                          (2, 2, 40, 4, False),
                                          # with x_prev, x a strided view
                                          # as the Mamba block's xz split
                                          (2, 5, 40, 4, "strided")])
def test_conv_plain_matches_pallas(b, L, d, k, prev):
    a = dict(x=np_input(b, b, L, d), w=np_input(b + 1, k, d), b=np_input(b + 2, d),
             x_prev=np_input(b + 3, b, k - 1, d) if prev else None)
    yj, sj = jconv.causal_conv1d(**to_jax(a), block_d=16, block_l=16)
    t = to_torch(a)
    if prev == "strided":
        xz = torch.zeros(b, L, 2 * d)
        xz[..., :d] = t["x"]
        t["x"] = xz[..., :d]
        assert not t["x"].is_contiguous()
    yt, st = ref.causal_conv1d(**t)
    close(yt, yj, 1e-5)
    np.testing.assert_array_equal(np.asarray(st), np.asarray(sj))


@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
@pytest.mark.parametrize("b,d,n", [(4, 64, 16), (3, 130, 16)])
def test_step_plain_matches_fused_pallas(b, d, n, exp_impl, silu_impl):
    a = step_arrays(b, d, n, seed=d)
    kw = dict(exp_impl=exp_impl, silu_impl=silu_impl)
    yj, hj = jstep.selective_state_step(**to_jax(a), block_d=64, **kw)
    yt, ht = ref.selective_state_step(**to_torch(a), **kw)
    close(yt, yj, 1e-5)
    close(ht, hj, 1e-5)


def test_step_is_the_one_token_scan():
    a = step_arrays(2, 32, 16, seed=5)
    t = to_torch(a)
    y1, h1 = ref.selective_state_step(**t)
    ys, hs = ref.selective_scan(t["x_t"][:, None], t["dt_t"][:, None],
                                t["A"], t["B_t"][:, None], t["C_t"][:, None],
                                D=t["D"], z=t["z_t"][:, None], h0=t["h"])
    close(y1, ys[:, 0], 1e-6)
    close(h1, hs, 1e-6)


# ---------------------------------------------------------------------------
# Wrappers on the CPU: the plain version, argument checks, launch counts
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_versions_on_cpu_tensors():
    ref.CALLS.clear()
    before = (tscan.launches, tconv.launches, tstep.launches)
    t = to_torch(scan_arrays(1, 5, 32, 16))
    y, h = scan_call(tscan.selective_scan, t)
    y0, h0 = ref.selective_scan(**t)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    tconv.causal_conv1d(t["x"], torch.ones(4, 32))
    s = to_torch(step_arrays(2, 32, 16))
    tstep.selective_state_step(s["h"], s["x_t"], s["dt_t"], s["A"],
                               s["B_t"], s["C_t"], D=s["D"], z_t=s["z_t"])
    assert (tscan.launches, tconv.launches, tstep.launches) == before
    assert dict(ref.CALLS) == {"selective_scan": 2, "causal_conv1d": 1,
                               "selective_state_step": 1}


def test_wrappers_accept_the_blocks_strided_views():
    """x/z from one in_proj output and B/C from one x_proj output, as the
    Mamba block hands them over: same result as contiguous copies."""
    b, L, d, n, r = 2, 6, 32, 16, 4
    xz = torch.randn(b, L, 2 * d, generator=torch.Generator().manual_seed(0))
    dbc = torch.randn(b, L, r + 2 * n,
                      generator=torch.Generator().manual_seed(1))
    x, z = xz.chunk(2, dim=-1)
    _, B, C = dbc.split([r, n, n], dim=-1)
    assert not x.is_contiguous() and not B.is_contiguous()
    dt = torch.rand(b, L, d)
    A = -torch.rand(d, n)
    y1, h1 = tscan.selective_scan(x, dt, A, B, C, z=z)
    y0, h0 = tscan.selective_scan(x.contiguous(), dt, A, B.contiguous(),
                                  C.contiguous(), z=z.contiguous())
    assert torch.equal(y1, y0) and torch.equal(h1, h0)
    yc1, _ = tconv.causal_conv1d(x, torch.ones(4, d))
    yc0, _ = tconv.causal_conv1d(x.contiguous(), torch.ones(4, d))
    assert torch.equal(yc1, yc0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "A_layout", "impl",
                                 "device", "last_stride"])
def test_scan_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = to_torch(scan_arrays(1, 4, 32, 16))
    kw = {}
    if bad == "dtype":
        t["x"] = t["x"].half()
    elif bad == "shape":
        t["z"] = t["z"][:, :2]
    elif bad == "A_layout":
        t["A"] = t["A"].t().contiguous().t()
    elif bad == "impl":
        kw["exp_impl"] = "taylor"
    elif bad == "device":
        t["A"] = t["A"].to("meta")
    else:
        t["dt"] = t["dt"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        scan_call(tscan.selective_scan, t, **kw)


def test_step_and_conv_wrappers_check_arguments():
    s = to_torch(step_arrays(2, 32, 16))
    with pytest.raises(ValueError):
        tstep.selective_state_step(s["h"][:1], s["x_t"], s["dt_t"], s["A"],
                                   s["B_t"], s["C_t"])
    with pytest.raises(ValueError):
        tstep.selective_state_step(s["h"].to(torch.bfloat16), s["x_t"],
                                   s["dt_t"], s["A"], s["B_t"], s["C_t"])
    x = torch.randn(2, 5, 8)
    with pytest.raises(ValueError):
        tconv.causal_conv1d(x, torch.ones(4, 8), x_prev=torch.zeros(2, 2, 8))
    with pytest.raises(ValueError):
        tconv.causal_conv1d(x, torch.ones(4, 8, dtype=torch.float64))


@pytest.mark.parametrize("offset,ok", [(0, True), (4, True), (1, False),
                                       (2, False), (3, False)])
def test_check_aligned_takes_only_16_byte_starts(offset, ok):
    """The decode step's alignment check: h, A and h' move in 16-byte
    words on the card, so a tensor starting off a 16-byte boundary is
    refused (offset counted in f32 elements of a fresh tensor)."""
    base = torch.zeros(64)
    assert base.data_ptr() % 16 == 0
    t = base[offset:offset + 32]
    if ok:
        _lib.check_aligned(16, h=t, A=None)
    else:
        with pytest.raises(ValueError, match="h must start on a 16-byte"):
            _lib.check_aligned(16, h=t, A=None)


def test_ops_dispatch_names_and_unported_impls():
    assert ops.resolve_step_impl("auto") == "fused"
    for name in ("fused", "pallas", "xla"):
        assert ops.resolve_step_impl(name) == "fused"
    # the cross-layer megakernel (K3) is ported: it resolves, never raises
    assert ops.resolve_step_impl("megakernel") == "megakernel"
    assert ops.storage_dtype("int8") == torch.int8
    assert ops.storage_dtype("fp8") == torch.float8_e4m3fn
    assert ops.storage_dtype("bf16") == torch.bfloat16
    with pytest.raises(KeyError):
        ops.storage_dtype("int4")
    with pytest.raises(KeyError):
        ops.resolve_step_impl("nope")
    t = to_torch(scan_arrays(1, 3, 16, 16))
    with pytest.raises(KeyError):
        ops.selective_scan(t["x"], t["dt"], t["A"], t["B"], t["C"],
                           impl="nope")
    with pytest.raises(KeyError):
        ops.causal_conv1d(t["x"], torch.ones(4, 16), impl="nope")


# ---------------------------------------------------------------------------
# The C interface as the ctypes bindings see it
# ---------------------------------------------------------------------------

def _c_prototypes():
    out = {}
    for src in _lib.SOURCES:
        text = (_lib.CSRC / src).read_text()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     text):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                kinds.append(ctypes.c_void_p if "*" in arg else
                             ctypes.c_int64 if arg.startswith("int64_t") else
                             ctypes.c_int if arg.startswith("int ") else
                             ctypes.c_float if arg.startswith("float ") else
                             None)
            out[name] = kinds
    return out


def test_ctypes_signatures_match_the_c_entry_points():
    """Every pointer and the stream bind as c_void_p, every int64_t as
    c_int64, every float as c_float: a mismatch would cut a pointer or
    shift every argument."""
    protos = _c_prototypes()
    assert set(protos) == set(_lib._SIGNATURES)
    for name, kinds in protos.items():
        assert None not in kinds, name
        assert kinds == _lib._SIGNATURES[name], name


def test_build_is_lazy_and_needs_nvcc():
    """Importing the kernels built nothing; the build names its .so by a
    hash of the sources, under the repo's build/ directory."""
    assert _lib._lib is None or torch.cuda.is_available()
    path = _lib.library_path()
    assert path.parent.name == "build" and path.suffix == ".so"
    assert (Path(_lib.CSRC) / "common.cuh").exists()
