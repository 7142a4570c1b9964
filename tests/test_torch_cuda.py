"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  The kernels have no CPU mode: without a card every test here skips
itself.  The file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import conv1d as tconv
from repro_torch.kernels import decode_step as tstep
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as tscan

from _torch_inputs import (VARIANTS, close, np_input, scan_arrays,
                           scan_call, step_arrays, to_torch)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 5e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
def test_cuda_scan_matches_plain(cuda, dtype, tol, exp_impl, silu_impl):
    t = to_torch(scan_arrays(2, 130, 96, 16, seed=3), dtype, cuda)
    kw = dict(exp_impl=exp_impl, silu_impl=silu_impl)
    n0 = tscan.launches
    y1, h1 = scan_call(tscan.selective_scan, t, **kw)
    y0, h0 = ref.selective_scan(**t, **kw)
    torch.cuda.synchronize()
    assert tscan.launches == n0 + 1
    close(y1.cpu(), y0.cpu().float().numpy(), tol)
    close(h1.cpu(), h0.cpu().numpy(), 5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("b,L", [(4, 1), (1, 300)])
def test_cuda_conv_matches_plain(cuda, dtype, tol, b, L):
    a = dict(x=np_input(1, b, L, 200), w=np_input(2, 4, 200), b=np_input(3, 200),
             x_prev=np_input(4, b, 3, 200))
    t = to_torch(a, dtype, cuda)
    y1, s1 = tconv.causal_conv1d(t["x"], t["w"], t["b"], t["x_prev"])
    y0, s0 = ref.causal_conv1d(t["x"], t["w"], t["b"], t["x_prev"])
    torch.cuda.synchronize()
    close(y1.cpu(), y0.cpu().float().numpy(), tol)
    assert torch.equal(s1, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
def test_cuda_step_matches_plain(cuda, dtype, tol, exp_impl, silu_impl):
    s = to_torch(step_arrays(4, 1536, 16, seed=9), dtype, cuda)
    kw = dict(D=s["D"], z_t=s["z_t"], exp_impl=exp_impl, silu_impl=silu_impl)
    args = (s["h"], s["x_t"], s["dt_t"], s["A"], s["B_t"], s["C_t"])
    y1, h1 = tstep.selective_state_step(*args, **kw)
    y0, h0 = ref.selective_state_step(*args, **kw)
    torch.cuda.synchronize()
    close(y1.cpu(), y0.cpu().float().numpy(), tol)
    close(h1.cpu(), h0.cpu().numpy(), 1e-5)
