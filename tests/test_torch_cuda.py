"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  The kernels have no CPU mode: without a card every test here skips
itself.  The file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import collections

import pytest
import torch

from repro_torch.core import weight_quant
from repro_torch.kernels import conv1d as tconv
from repro_torch.kernels import decode_step as tstep
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as tscan

from _torch_inputs import (UNIT_IMPLS, VARIANTS, assert_q_close,
                           assert_streams_tie_equal, close,
                           code_ordinals, graph_kernels, graph_launches,
                           jamba_run_inputs,
                           np_input, q_step_tensors, scan_arrays, scan_call,
                           stacked_inputs, step_arrays, to_torch,
                           unit_value_mismatches, xlstm_run_inputs)


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


# K4's segment edges: around its 32 time segments and the longest prompt
K4_LENGTHS = (1, 2, 31, 32, 33, 127, 300, 512, 576)


def _strided_scan(b, L, d, r, dtype, device, seed, h0):
    """A scan's inputs as the Mamba block hands them over: x and z halves
    of one (b, L, 2d) tensor, B and C inside one (b, L, r + 32) tensor
    after dt_rank r columns (r 48: 16-byte rows; 35: no)."""
    dt_ = getattr(torch, dtype)
    xz = torch.from_numpy(np_input(seed, b, L, 2 * d)).to(device, dt_)
    dbc = torch.from_numpy(np_input(seed + 1, b, L, r + 32)).to(device, dt_)
    x, z = xz[..., :d], xz[..., d:]
    return dict(
        x=x, z=z, B=dbc[..., r:r + 16], C=dbc[..., r + 16:],
        dt=torch.from_numpy(np_input(seed + 2, b, L, d, softplus=True)).to(
            device, dt_),
        A=torch.from_numpy(np_input(seed + 3, d, 16, neg_exp=True)).to(
            device),
        D=torch.from_numpy(np_input(seed + 4, d)).to(device),
        h0=torch.from_numpy(np_input(seed + 5, b, d, 16)).to(device)
        if h0 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("L", K4_LENGTHS)
@pytest.mark.parametrize("b,d", [(1, 198), (3, 1536)])
@pytest.mark.parametrize("r", [48, 35])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zero"])
@pytest.mark.parametrize("dtype,tol", [("float32", 5e-4), ("bfloat16", 2e-2)])
def test_cuda_scan_segments_match_plain_and_repeat(cuda, L, b, d, r, h0,
                                                   dtype, tol):
    """K4's chunked scan at lengths around its segment edges (one step,
    segments of one and two steps, a ragged last segment, 576), one
    sequence of 198 channels (32 segments, a ragged last block of
    channels) and 3 of 1536 (16 segments: a call wider than the card holds
    at once), on the strided views of the Mamba block with B and C read in
    16-byte words (dt_rank 48) or element by element (35), from h0 or
    zero: the plain version's y within tol and h_last within 5e-4, each
    launch repeated bit for bit, one device kernel a call."""
    from _torch_inputs import graph_kernels
    t = _strided_scan(b, L, d, r, dtype, cuda, 40 + L, h0)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
    kw = dict(D=t["D"], z=t["z"], h0=t["h0"])
    y1, h1 = tscan.selective_scan(*args, **kw)
    y2, h2 = tscan.selective_scan(*args, **kw)
    y0, hr = ref.selective_scan(*args, **kw)
    torch.cuda.synchronize()
    close(y1.cpu(), y0.cpu().float().numpy(), tol)
    close(h1.cpu(), hr.cpu().numpy(), 5e-4)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert graph_kernels(lambda: tscan.selective_scan(*args, **kw)) == 1


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


def _conv_tensors(cuda, dtype, b, L, d, prev, strided):
    """x as the Mamba block hands it over (a strided view of its (b, L,
    2d) in_proj output) or dense; w, bias f32; x_prev or None."""
    dt = getattr(torch, dtype)
    xz = torch.from_numpy(np_input(d + L, b, L, 2 * d)).to(cuda, dt)
    x = xz[..., :d] if strided else xz[..., :d].contiguous()
    w = torch.from_numpy(np_input(2, 4, d)).to(cuda)
    bias = torch.from_numpy(np_input(3, d)).to(cuda)
    x_prev = (torch.from_numpy(np_input(4, b, 3, d)).to(cuda, dt) if prev
              else None)
    return x, w, bias, x_prev


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("d", [200, 1536])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 300])
@pytest.mark.parametrize("prev", [True, False], ids=["x_prev", "no_prev"])
@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
def test_cuda_conv_writes_its_tail(cuda, dtype, tol, d, L, prev, strided):
    """K5 writes y and the new tail in one launch: the tail bitwise the
    plain version's and a fresh tensor, x_prev's rows shifted by L where
    L < k-1; d 200 takes the kernel's one-channel path, d 1536 its
    8-channel path."""
    x, w, bias, x_prev = _conv_tensors(cuda, dtype, 3, L, d, prev, strided)
    n0 = tconv.launches
    y1, s1 = tconv.causal_conv1d(x, w, bias, x_prev)
    y0, s0 = ref.causal_conv1d(x, w, bias, x_prev)
    torch.cuda.synchronize()
    assert tconv.launches == n0 + 1
    close(y1.cpu(), y0.cpu().float().numpy(), tol)
    assert torch.equal(s1, s0)
    assert x_prev is None or s1.data_ptr() != x_prev.data_ptr()


@pytest.mark.gpu
@pytest.mark.parametrize("b,L,prev", [(4, 1, True), (1, 512, True),
                                      (4, 2, False)])
def test_cuda_conv_is_one_device_kernel(cuda, b, L, prev):
    """One wrapper call runs one device kernel (no concatenation, zeros or
    copy beside it), counted in a CUDA graph of the call, and repeats bit
    for bit."""
    x, w, bias, x_prev = _conv_tensors(cuda, "bfloat16", b, L, 1536, prev,
                                       True)
    names = [name for name, _, _ in graph_launches(
        lambda: tconv.causal_conv1d(x, w, bias, x_prev))]
    assert len(names) == 1 and "causal_conv1d_kernel" in names[0], names
    y1, s1 = tconv.causal_conv1d(x, w, bias, x_prev)
    y2, s2 = tconv.causal_conv1d(x, w, bias, x_prev)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


# K1's shapes: mamba-130m's width at 1, 4 and 16 slots, a ragged last
# block of 12 channels (1100), one of a single channel (513) at 9 slots,
# and jamba's width (8192)
K1_SHAPES = [(4, 1536), (1, 1536), (4, 1100), (9, 513), (16, 1536),
             (4, 8192)]


def _step_tensors(slots, d, dtype, device, seed):
    """step_arrays as tensors, B_t and C_t columns of one wider x_proj row
    after dt_rank ceil(d / 32) columns, as the Mamba block passes them
    (rows that start 2-byte aligned where that rank is odd)."""
    s = to_torch(step_arrays(slots, d, 16, seed=seed), dtype, device)
    r = -(-d // 32)
    dbc = torch.from_numpy(np_input(seed + 8, slots, r + 32)).to(
        device, getattr(torch, dtype))
    dbc[:, r:r + 16] = s["B_t"]
    dbc[:, r + 16:] = s["C_t"]
    s["B_t"], s["C_t"] = dbc[:, r:r + 16], dbc[:, r + 16:]
    return s


def _check_step_launch(cuda, slots, d, args, kw, got):
    """A second launch repeats ``got`` bit for bit, and one call is one
    device kernel at the grid and block ``launch_shape`` reports."""
    again = tstep.selective_state_step(*args, **kw)
    torch.cuda.synchronize()
    assert _same_bits(got, again)
    launches = graph_launches(
        lambda: tstep.selective_state_step(*args, **kw))
    shape = tstep.launch_shape(slots, d)
    assert len(launches) == 1 and "decode_step_kernel" in launches[0][0]
    assert launches[0][1:] == ((*shape["grid"], 1), (shape["threads"], 1, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
@pytest.mark.parametrize("slots,d", K1_SHAPES)
def test_cuda_step_matches_plain(cuda, dtype, tol, exp_impl, silu_impl,
                                 slots, d):
    """K1 (f32 A) against its plain version on strided B and C rows; a
    second launch equal bit for bit; one device kernel a call, at the
    launch ``launch_shape`` reports."""
    s = _step_tensors(slots, d, dtype, cuda, seed=9)
    kw = dict(D=s["D"], z_t=s["z_t"], exp_impl=exp_impl, silu_impl=silu_impl)
    args = (s["h"], s["x_t"], s["dt_t"], s["A"], s["B_t"], s["C_t"])
    n0 = (tstep.launches, tstep.launches_int8a)
    y1, h1 = tstep.selective_state_step(*args, **kw)
    y0, h0 = ref.selective_state_step(*args, **kw)
    torch.cuda.synchronize()
    assert (tstep.launches, tstep.launches_int8a) == (n0[0] + 1, n0[1])
    close(y1.cpu(), y0.cpu().float().numpy(), tol)
    close(h1.cpu(), h0.cpu().numpy(), 1e-5)
    _check_step_launch(cuda, slots, d, args, kw, (y1, h1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS)
@pytest.mark.parametrize("slots,d", K1_SHAPES)
def test_cuda_step_int8_a_matches_plain(cuda, dtype, tol, exp_impl,
                                        silu_impl, slots, d):
    """K1's int8-A variant: A as int8 codes + per-row scales, as the f32-A
    test holds it."""
    s = _step_tensors(slots, d, dtype, cuda, seed=19)
    A_q, a_scale = weight_quant.quantize_rows(s["A"])
    kw = dict(D=s["D"], z_t=s["z_t"], exp_impl=exp_impl, silu_impl=silu_impl,
              a_scale=a_scale)
    args = (s["h"], s["x_t"], s["dt_t"], A_q, s["B_t"], s["C_t"])
    n0 = (tstep.launches, tstep.launches_int8a)
    y1, h1 = tstep.selective_state_step(*args, **kw)
    y0, h0 = ref.selective_state_step(*args, **kw)
    torch.cuda.synchronize()
    assert (tstep.launches, tstep.launches_int8a) == (n0[0], n0[1] + 1)
    close(y1.cpu(), y0.cpu().float().numpy(), tol)
    close(h1.cpu(), h0.cpu().numpy(), 1e-5)
    _check_step_launch(cuda, slots, d, args, kw, (y1, h1))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["h", "A", "A_int8"])
def test_cuda_step_misaligned_raises(cuda, which):
    """K1 moves h and A in 16-byte words: an h or A that starts off a
    16-byte boundary raises before any launch (no fallback)."""
    s = _step_tensors(4, 1536, "float32", cuda, seed=29)
    a_scale = None
    if which == "A_int8":
        s["A"], a_scale = weight_quant.quantize_rows(s["A"])
    key = "h" if which == "h" else "A"
    t = s[key]
    shifted = torch.empty(t.numel() + 4, dtype=t.dtype, device=cuda)
    s[key] = shifted[1:1 + t.numel()].view(t.shape)
    s[key].copy_(t)
    n0 = (tstep.launches, tstep.launches_int8a)
    with pytest.raises(ValueError, match="16-byte"):
        tstep.selective_state_step(s["h"], s["x_t"], s["dt_t"], s["A"],
                                   s["B_t"], s["C_t"], a_scale=a_scale)
    assert (tstep.launches, tstep.launches_int8a) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("a8", [False, True], ids=["f32_A", "int8_A"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d", [1536, 1100])
def test_cuda_step_q_matches_plain(cuda, state_dtype, a8, dtype, tol, d):
    """K2 at 4 slots: 3 channel groups at d=1536, a ragged third at
    d=1100; slot 0 is a fresh slot (zero codes and scale)."""
    for exp_impl, silu_impl in VARIANTS:
        args, kw = q_step_tensors(4, d, 16, state_dtype, seed=d, a8=a8,
                                  dtype=dtype, device=cuda)
        kw.update(exp_impl=exp_impl, silu_impl=silu_impl)
        n0 = tstep.launches_q
        got = tstep.selective_state_step_q(*args, state_dtype=state_dtype,
                                           **kw)
        want = ref.selective_state_step_q(*args, state_dtype=state_dtype,
                                          **kw)
        torch.cuda.synchronize()
        assert tstep.launches_q == n0 + 1
        assert_q_close(got, want, tol, f"{exp_impl}/{silu_impl}")


def _same_bits(a, b):
    """Whether two results ((y, h') or (y, payload, scales)) hold the same
    bits."""
    def raw(t):
        return t.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[t.dtype.itemsize])
    return all(torch.equal(raw(u), raw(v)) for u, v in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("slots", [1, 4, 9])
@pytest.mark.parametrize("d", [512, 513, 1536, 1100, 8192])
def test_cuda_step_q_clusters_match_plain_and_repeat(cuda, d, slots,
                                                     state_dtype):
    """K2 runs one thread-block cluster per (slot, 512-channel group) and
    meets the group's absmax in distributed shared memory: one group
    (512), a ragged group of one channel (513: seven of its eight blocks
    own no channel), mamba-130m's 3 groups, a ragged third (1100) and
    jamba's 16 (8192), by 1, 4 and 9 slots, f32 and int8 A, f32 and
    bf16.  Each is held to the plain version, repeats bit for bit, and is
    one device kernel a call."""
    for a8 in (False, True):
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
            args, kw = q_step_tensors(slots, d, 16, state_dtype,
                                      seed=d + slots, a8=a8, dtype=dtype,
                                      device=cuda)
            kw["state_dtype"] = state_dtype
            n0 = tstep.launches_q
            got = tstep.selective_state_step_q(*args, **kw)
            again = tstep.selective_state_step_q(*args, **kw)
            want = ref.selective_state_step_q(*args, **kw)
            torch.cuda.synchronize()
            assert tstep.launches_q == n0 + 2
            label = f"d={d} slots={slots} a8={a8} {dtype}"
            assert_q_close(got, want, tol, label)
            assert _same_bits(got, again), label
            assert graph_kernels(
                lambda: tstep.selective_state_step_q(*args, **kw)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
def test_cuda_step_q_encodes_as_torch(cuda, state_dtype):
    """The kernel's encode against torch's on values spanning the whole
    code range, rounding ties included: from a fresh slot with dt = 1 and
    B = 1 the new state is x itself, and with max |x| = qmax its scale is
    exactly 1, so the payload must be torch's encoding of x bit for bit
    (int8: round half to even and clip; fp8: e4m3 round to nearest even)."""
    from repro_torch.core import state_quant
    x = encode_sweep(state_dtype, 4, 1536).to(cuda)
    ones = torch.ones_like(x)
    A = -torch.ones(1536, 16, device=cuda)
    hq = torch.zeros(4, 1536, 16, device=cuda).to(
        state_quant.storage_dtype(state_dtype))
    h_scale = torch.zeros(4, 3, device=cuda)
    B = torch.ones(4, 16, device=cuda)
    _, q, scale = tstep.selective_state_step_q(
        hq, h_scale, x, ones, A, B, B, state_dtype=state_dtype)
    torch.cuda.synchronize()
    assert bool((scale == 1.0).all())
    want = state_quant.encode(x[..., None].expand(4, 1536, 16),
                              state_dtype)
    assert torch.equal(q.view(torch.uint8), want.view(torch.uint8))


def encode_sweep(state_dtype, slots, d):
    """(slots, d) f32 values over [-qmax, qmax]: every code, every tie
    between neighbouring codes, and seeded values between (d a multiple
    of the channel group)."""
    from repro_torch.core import state_quant
    qm = state_quant.qmax(state_dtype)
    if state_dtype == "int8":
        codes = torch.arange(-127, 128, dtype=torch.float32)
    else:
        codes = torch.arange(256, dtype=torch.uint8).view(
            torch.float8_e4m3fn).float()
        codes = codes[torch.isfinite(codes)].unique() + 0.0   # no -0
    ties = (codes[1:] + codes[:-1]) / 2
    fill = (torch.rand(slots * d, generator=torch.Generator().manual_seed(0))
            * 2 - 1) * qm
    vals = torch.cat([codes, ties, fill])[:slots * d].reshape(slots, d)
    # every (slot, group) holds qmax, so every scale is exactly 1
    vals[:, state_quant.D_BLOCK - 1::state_quant.D_BLOCK] = qm
    return vals


# ---------------------------------------------------------------------------
# K3, the cross-layer megakernel, against its plain version
# ---------------------------------------------------------------------------

def _mega_cfg(d_model, n_layers, dtype, weight_dtype, state_dtype,
              exp_impl="exact", silu_impl="exact"):
    """mamba-130m's structure at another width: d_model 64 (the smoke
    width) or 550 (d_inner 1100 and dt_rank 35: no multiple of 32 and a
    ragged third scale group)."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(
        configs.get_config("mamba-130m"), n_layers=n_layers,
        d_model=d_model, dt_rank=-(-d_model // 16), vocab=64, dtype=dtype,
        weight_dtype=weight_dtype, state_dtype=state_dtype,
        exp_impl=exp_impl, silu_impl=silu_impl)


def _mega_close(cfg, got, want, tol, label):
    """K3 against its plain version.  f32: x, the conv tail and an f32
    state within ``tol``, a bf16 state within a bf16 step (8e-3), an
    int8/fp8 state within one code with its scales to 1e-5 relative (the
    sums over d_inner run in another order, so a value on a rounding
    boundary moves one code, and a group's absmax by a few f32 ulps over
    the layers).  bf16: a rounding that falls the other way moves what
    follows by a bf16 step, and the error of x + y is one of the larger
    operand, so values are held to ``tol`` of themselves plus ``tol`` of
    the largest value; an int8/fp8 state's scales to 3e-2 and its
    dequantized values as the others plus one code (1/127 of the largest
    value for int8, one e4m3 step, 1/8 of the value, for fp8)."""
    (x1, h1, s1, c1), (x0, h0, s0, c0) = got, want
    bf16 = cfg.dtype == "bfloat16"

    def near(a, b, t):
        b = b.cpu().float()
        at = t * float(b.abs().max()) if bf16 else t
        torch.testing.assert_close(a.cpu().float(), b, rtol=t, atol=at,
                                   msg=lambda m: f"{label}: {m}")

    near(x1, x0, tol)
    near(c1, c0, tol)
    if cfg.state_dtype == "f32":
        near(h1, h0, tol)
    elif cfg.state_dtype == "bf16":
        near(h1, h0, max(tol, 8e-3))
    elif bf16:
        from repro_torch.core import state_quant
        rel = ((s1 - s0).abs() / s0.abs().clamp_min(1e-30)).max()
        assert float(rel) <= 3e-2, f"{label}: scales {float(rel):.2e}"
        d1 = state_quant.dequantize_h(h1, s1).cpu()
        d0 = state_quant.dequantize_h(h0, s0).cpu()
        top = float(d0.abs().max())
        fp8 = cfg.state_dtype == "fp8"
        torch.testing.assert_close(
            d1, d0, rtol=tol + (0.125 if fp8 else 0.0),
            atol=tol * top + (0.0 if fp8 else top / 127),
            msg=lambda m: f"{label}: {m}")
    else:
        rel = ((s1 - s0).abs() / s0.abs().clamp_min(1e-30)).max()
        assert float(rel) <= 1e-5, f"{label}: scales {float(rel):.2e}"
        apart = (code_ordinals(h1.cpu()) - code_ordinals(h0.cpu())).abs()
        assert int(apart.max()) <= 1, f"{label}: codes {int(apart.max())}"


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d_model,slots", [(64, 3), (550, 6)])
def test_cuda_megakernel_matches_plain(cuda, state_dtype, weight_dtype,
                                       dtype, tol, d_model, slots):
    """K3 at 2-4 layers against ref.mamba_stacked_step on the card; 6
    slots take two passes of the kernel's 4-slot staging."""
    from repro_torch.core import dispatch_count
    from repro_torch.kernels import megakernel
    cfg = _mega_cfg(d_model, 4 if d_model == 64 else 2, dtype,
                    weight_dtype, state_dtype)
    p, x0, h, h_scale, conv = stacked_inputs(cfg, slots, seed=d_model,
                                             device=cuda)
    counts = dispatch_count.launch_counts(
        megakernel.mamba_stacked_step, cfg, x0, p["stack"], h, h_scale,
        conv)
    assert sum(counts.values()) == 1 and not any(
        k.startswith("plain") for k in counts), counts
    got = megakernel.mamba_stacked_step(cfg, x0, p["stack"], h, h_scale,
                                        conv)
    want = ref.mamba_stacked_step(cfg, x0, p["stack"].layers, h, h_scale,
                                  conv)
    torch.cuda.synchronize()
    _mega_close(cfg, got, want, tol, f"{dtype} {weight_dtype} "
                f"{state_dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("exp_impl,silu_impl", VARIANTS[1:])
def test_cuda_megakernel_approx_variants(cuda, exp_impl, silu_impl):
    """MARCA's fast exp and piecewise SiLU inside K3, f32 (they run in
    the S6 step, the conv epilogue's SiLU and the gate)."""
    from repro_torch.kernels import megakernel
    for sd in ("f32", "int8"):
        cfg = _mega_cfg(64, 3, "float32", "f32", sd, exp_impl, silu_impl)
        p, x0, h, h_scale, conv = stacked_inputs(cfg, 4, seed=5,
                                                 device=cuda)
        got = megakernel.mamba_stacked_step(cfg, x0, p["stack"], h,
                                            h_scale, conv)
        want = ref.mamba_stacked_step(cfg, x0, p["stack"].layers, h,
                                      h_scale, conv)
        torch.cuda.synchronize()
        _mega_close(cfg, got, want, 1e-4, f"{exp_impl}/{silu_impl} {sd}")


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_cuda_megakernel_repeats_bitwise(cuda, state_dtype):
    """No float atomics and sums in a fixed order: the same inputs give
    the same bits, launch after launch."""
    from repro_torch.kernels import megakernel
    cfg = _mega_cfg(550, 2, "bfloat16", "int8", state_dtype)
    p, x0, h, h_scale, conv = stacked_inputs(cfg, 5, seed=1, device=cuda)
    a = megakernel.mamba_stacked_step(cfg, x0, p["stack"], h, h_scale, conv)
    b = megakernel.mamba_stacked_step(cfg, x0, p["stack"], h, h_scale, conv)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert (u is None and v is None) or torch.equal(
            u.view(torch.uint8), v.view(torch.uint8))


# ---------------------------------------------------------------------------
# K7: flash attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [  # b, lq, lk, hq, hkv, dh
    (2, 37, 37, 4, 2, 16),      # ragged, the smoke width's head dim
    (1, 17, 100, 8, 2, 64),     # suffix: lq < lk
    (1, 1, 45, 4, 4, 16),
    (1, 64, 64, 32, 8, 128),    # jamba-v0.1's heads
    (1, 127, 127, 32, 8, 128),
    (1, 512, 512, 32, 8, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,dh", FLASH_SHAPES)
def test_cuda_flash_matches_plain(cuda, dtype, tol, b, lq, lk, hq, hkv, dh):
    """K7 against ref.attention on the card, at repro's flash tolerances
    (2e-5 f32, 3e-2 bf16: the output rounds to bf16)."""
    from repro_torch.core import dispatch_count
    from repro_torch.kernels import flash_attention
    dt = getattr(torch, dtype)
    q = torch.from_numpy(np_input(lq, b, lq, hq, dh)).to(cuda, dt)
    k = torch.from_numpy(np_input(lk + 1, b, lk, hkv, dh)).to(cuda, dt)
    v = torch.from_numpy(np_input(lk + 2, b, lk, hkv, dh)).to(cuda, dt)
    counts = dispatch_count.launch_counts(flash_attention.flash_attention,
                                          q, k, v)
    assert dict(counts) == {"flash_attention": 1}, counts
    got = flash_attention.flash_attention(q, k, v, causal=True)
    want = ref.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)


FLASH_TC_SHAPES = [  # b, lq, lk, hq, hkv, dh: bf16, on the tensor cores
    (1, 65, 65, 32, 8, 128),    # ragged against the 64-row tile
    (1, 129, 129, 32, 8, 128),
    (1, 200, 200, 32, 8, 128),
    (1, 37, 300, 32, 8, 128),   # a ragged suffix
    (2, 300, 300, 32, 8, 128),  # ragged against the 128-row tile
    (1, 500, 700, 32, 8, 128),  # a suffix on the 128-row tile
    (2, 70, 70, 8, 8, 64),      # hq == hkv: one head a block
    (2, 45, 45, 4, 2, 16),      # dh 16, padded to 64 by the copies
    (1, 100, 100, 6, 2, 96),    # 3 heads a KV head: a block takes 1
]


def _flash_tensors(cuda, b, lq, lk, hq, hkv, dh, dtype=torch.bfloat16):
    q = torch.from_numpy(np_input(lq, b, lq, hq, dh)).to(cuda, dtype)
    k = torch.from_numpy(np_input(lk + 1, b, lk, hkv, dh)).to(cuda, dtype)
    v = torch.from_numpy(np_input(lk + 2, b, lk, hkv, dh)).to(cuda, dtype)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,hq,hkv,dh", FLASH_TC_SHAPES)
def test_cuda_flash_bf16_ragged_matches_plain(cuda, b, lq, lk, hq, hkv, dh):
    """K7's bf16 (tensor-core) kernel at lengths that are no multiple of
    its row or key tiles, at the bf16 tolerance of 3e-2."""
    from repro_torch.kernels import flash_attention
    q, k, v = _flash_tensors(cuda, b, lq, lk, hq, hkv, dh)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    want = ref.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("lq", [512, 200])
def test_cuda_flash_bf16_repeats_bitwise(cuda, lq):
    """No atomics and no split of the key walk: a launch repeats bit for
    bit (128-row tiles at 512, 64-row tiles at 200)."""
    from repro_torch.kernels import flash_attention
    q, k, v = _flash_tensors(cuda, 1, lq, lq, 32, 8, 128)
    a = flash_attention.flash_attention(q, k, v, causal=True)
    b = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 24, 136])
def test_cuda_flash_bf16_refuses_other_head_dims(cuda, dh):
    """bf16 takes dh a multiple of 16 up to 128, and raises otherwise:
    no fall back to the f32 kernel or the plain version."""
    from repro_torch.kernels import flash_attention
    q, k, v = _flash_tensors(cuda, 1, 16, 16, 4, 2, dh)
    n0 = flash_attention.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention.flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == n0


@pytest.mark.gpu
def test_cuda_flash_non_causal(cuda):
    from repro_torch.kernels import flash_attention
    q = torch.from_numpy(np_input(1, 2, 33, 4, 32)).to(cuda)
    k = torch.from_numpy(np_input(2, 2, 50, 2, 32)).to(cuda)
    v = torch.from_numpy(np_input(3, 2, 50, 2, 32)).to(cuda)
    got = flash_attention.flash_attention(q, k, v, causal=False)
    want = ref.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# K7 at the zoo's transformer head layouts; a transformer served on the card
# ---------------------------------------------------------------------------

TRANSFORMER_FLASH = [  # hq, hkv, dh
    (28, 4, 128),     # qwen2-7b: 7 query heads a KV head, one a block
    (48, 1, 128),     # granite-20b: MQA, 16 query heads a block
    (16, 16, 128),    # olmo-1b, qwen2-moe-a2.7b
    (32, 32, 64),     # musicgen-large: the 64-wide instantiation
    (32, 32, 96),     # phi-3-vision: padded into the 128-wide one
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("lq,lk", [(64, 64), (127, 127), (512, 512),
                                   (64, 512)])
@pytest.mark.parametrize("hq,hkv,dh", TRANSFORMER_FLASH)
def test_cuda_flash_transformer_layouts(cuda, dtype, tol, lq, lk, hq, hkv,
                                        dh):
    """K7 against ref.attention at each transformer head layout: one
    launch counted, repro's flash tolerances, repeated bit for bit, one
    device kernel a call."""
    from repro_torch.core import dispatch_count
    from repro_torch.kernels import flash_attention
    q, k, v = _flash_tensors(cuda, 1, lq, lk, hq, hkv, dh,
                             getattr(torch, dtype))
    counts = dispatch_count.launch_counts(flash_attention.flash_attention,
                                          q, k, v)
    assert dict(counts) == {"flash_attention": 1}, counts
    got = flash_attention.flash_attention(q, k, v, causal=True)
    again = flash_attention.flash_attention(q, k, v, causal=True)
    want = ref.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)
    assert graph_kernels(
        lambda: flash_attention.flash_attention(q, k, v, causal=True)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-20b"])
def test_cuda_transformer_engine_launches_k7_once_a_layer(cuda, arch):
    """A smoke-width transformer served on the card with step_impl "auto"
    (the per-layer step: no K3 for this family): K7 once a layer an
    admission and in no decode step, no plain version, every slot back,
    and the CPU engine's greedy streams on the same f32 weights under the
    tie rule."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import dispatch_count
    from repro_torch.models import registry
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.sampling import SamplingParams
    cfg = dataclasses.replace(configs.smoke_variant(configs.get_config(
        arch)), vocab=256, dtype="float32")
    p = registry.init_params(cfg, seed=0)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).numpy()
               for n in (5, 9, 14, 7)]
    sp = SamplingParams(max_new=6, logprobs=True, top_logprobs=2)
    eng = Engine(cfg, p, EngineConfig(n_slots=2, max_seq=32,
                                      device=str(cuda)))
    assert "stack" not in eng.params
    dispatch_count.reset()
    reqs = [eng.submit(x, sp) for x in prompts]
    eng.run()
    torch.cuda.synchronize()
    snap = dispatch_count.snapshot()
    assert eng.stats.prefill_calls == len(prompts)
    assert eng.stats.decode_steps > 0
    assert snap["flash_attention"] == cfg.n_layers * len(prompts)
    assert sum(snap.values()) == snap["flash_attention"], +snap
    assert eng.pool.n_free == 2
    cpu = Engine(cfg, p, EngineConfig(n_slots=2, max_seq=32, device="cpu"))
    want = [cpu.submit(x, sp) for x in prompts]
    cpu.run()
    assert_streams_tie_equal(reqs, want, 1e-4, arch)


# ---------------------------------------------------------------------------
# K3, jamba instance
# ---------------------------------------------------------------------------

def _jamba_cfg(d_model, d_ff, dtype, weight_dtype, state_dtype,
               dt_rank=None):
    import dataclasses
    from repro_torch import configs
    base = configs.get_config("jamba-v0.1-52b")
    return dataclasses.replace(
        base, n_layers=8, d_model=d_model, d_ff=d_ff,
        dt_rank=dt_rank or -(-d_model // 16), dtype=dtype,
        weight_dtype=weight_dtype, state_dtype=state_dtype)


def _jamba_close(cfg, x1, outs1, x0, outs0, tol, label):
    for i, (a, b) in enumerate(zip(outs1, outs0)):
        _mega_close(cfg, (x1, a["h"], a.get("h_scale"), a["conv"]),
                    (x0, b["h"], b.get("h_scale"), b["conv"]), tol,
                    f"{label} position {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d_model,d_ff,n_pos,slots", [
    (64, 128, 1, 3), (64, 128, 4, 4), (550, 1000, 3, 6)])
def test_cuda_jamba_run_matches_plain(cuda, state_dtype, weight_dtype,
                                      dtype, tol, d_model, d_ff, n_pos,
                                      slots):
    """K3's jamba instance against ref.jamba_stacked_run on the card: a
    one-position run and multi-position runs, a ragged width (d_inner
    1100, d_ff 1000), 6 slots in two passes of the 4-slot staging."""
    from repro_torch.core import dispatch_count
    from repro_torch.kernels import megakernel
    cfg = _jamba_cfg(d_model, d_ff, dtype, weight_dtype, state_dtype)
    run, x0, states, outs = jamba_run_inputs(cfg, n_pos, slots, seed=d_model,
                                             device=cuda)
    counts = dispatch_count.launch_counts(
        megakernel.jamba_stacked_run, cfg, x0, run, states, outs)
    assert sum(counts.values()) == 1 and not any(
        k.startswith("plain") for k in counts), counts
    x1 = megakernel.jamba_stacked_run(cfg, x0, run, states, outs)
    x0r, want = ref.jamba_stacked_run(cfg, x0, run.rows, states)
    torch.cuda.synchronize()
    _jamba_close(cfg, x1, outs, x0r, want, tol,
                 f"{dtype} {weight_dtype} {state_dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("weight_dtype,state_dtype", [("f32", "f32"),
                                                      ("int8", "int8")])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_cuda_jamba_run_full_width(cuda, weight_dtype, state_dtype, dtype,
                                   tol):
    """jamba-v0.1's widths (d_model 4096, d_inner 8192, dt_rank 256,
    d_ff 14336: 16 scale groups, x_proj 288 columns), one position, 4
    slots."""
    from repro_torch.kernels import megakernel
    cfg = _jamba_cfg(4096, 14336, dtype, weight_dtype, state_dtype)
    run, x0, states, outs = jamba_run_inputs(cfg, 1, 4, seed=7, device=cuda)
    x1 = megakernel.jamba_stacked_run(cfg, x0, run, states, outs)
    x0r, want = ref.jamba_stacked_run(cfg, x0, run.rows, states)
    torch.cuda.synchronize()
    _jamba_close(cfg, x1, outs, x0r, want, tol, f"full width {dtype}")


@pytest.mark.gpu
def test_cuda_jamba_run_repeats_bitwise(cuda):
    from repro_torch.kernels import megakernel
    cfg = _jamba_cfg(550, 1000, "bfloat16", "int8", "int8")
    run, x0, states, outs = jamba_run_inputs(cfg, 2, 5, seed=3, device=cuda)
    a = megakernel.jamba_stacked_run(cfg, x0, run, states, outs)
    first = [{k: v.clone() for k, v in o.items()} for o in outs]
    b = megakernel.jamba_stacked_run(cfg, x0, run, states, outs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    for u, v in zip(first, outs):
        for k in u:
            assert torch.equal(u[k].view(torch.uint8), v[k].view(torch.uint8))


# ---------------------------------------------------------------------------
# K3's mamba kernel: its split-K items, counters and S6 chunks at the
# shapes that stress them
# ---------------------------------------------------------------------------

def _k3_case(cuda, instance, d_model, n, slots, dtype, wd, sd, seed):
    """(cfg, launch, plain, outs) of one K3 call: a mamba stack of n layers
    or a jamba run of n positions; ``outs`` the jamba outputs' dicts, or
    the mamba stack."""
    from repro_torch.kernels import megakernel
    if instance == "mamba":
        cfg = _mega_cfg(d_model, n, dtype, wd, sd)
        p, x0, h, h_scale, conv = stacked_inputs(cfg, slots, seed=seed,
                                                 device=cuda)
        return (cfg, lambda: megakernel.mamba_stacked_step(
            cfg, x0, p["stack"], h, h_scale, conv),
            lambda: ref.mamba_stacked_step(cfg, x0, p["stack"].layers, h,
                                           h_scale, conv), p["stack"])
    cfg = _jamba_cfg(d_model, {64: 128, 550: 1000}[d_model], dtype, wd, sd)
    run, x0, states, outs = jamba_run_inputs(cfg, n, slots, seed=seed,
                                             device=cuda)
    return (cfg, lambda: megakernel.jamba_stacked_run(cfg, x0, run, states,
                                                      outs),
            lambda: ref.jamba_stacked_run(cfg, x0, run.rows, states), outs)


def _k3_bits(instance, x, outs):
    """A K3 call's results as bytes: (x, h, h_scale, conv) or x and the
    jamba outputs' tensors."""
    if instance == "mamba":
        return [t.view(torch.uint8).clone() for t in x if t is not None]
    return [x.view(torch.uint8).clone()] + [
        o[k].view(torch.uint8).clone() for o in outs for k in sorted(o)]


def _k3_check(cfg, instance, got, outs, want, label):
    if instance == "mamba":
        _mega_close(cfg, got, want, 1e-4, label)
    else:
        _jamba_close(cfg, got, outs, *want, 1e-4, label)


@pytest.mark.gpu
@pytest.mark.parametrize("instance,d_model,n,slots,wd,sd", [
    ("mamba", 64, 2, 1, "int8", "int8"), ("mamba", 64, 2, 5, "f32", "f32"),
    ("mamba", 64, 2, 8, "int8", "int8"), ("mamba", 550, 2, 3, "int8", "int8"),
    ("mamba", 768, 24, 3, "int8", "int8"),
    ("jamba", 64, 1, 1, "int8", "int8"), ("jamba", 64, 2, 5, "f32", "f32"),
    ("jamba", 64, 8, 8, "int8", "int8"), ("jamba", 550, 3, 3, "int8", "int8"),
])
def test_cuda_k3_split_items_match_plain_and_repeat(cuda, instance, d_model,
                                                    n, slots, wd, sd):
    """K3's streamed GEMVs and S6 chunks at 1, 3, 5 and 8 slots (the 4-slot
    passes and their partial sums), a run of MAX_RUN positions, the ragged
    width (d_model 550: rows of 1100 and 2200 int8 codes, no multiple of
    16) and mamba-130m's 24 layers with an int8 state: f32 against the
    plain version, a bf16 launch repeated bit for bit."""
    cfg, launch, plain, outs = _k3_case(cuda, instance, d_model, n, slots,
                                        "float32", wd, sd, seed=11)
    got = launch()
    want = plain()
    torch.cuda.synchronize()
    _k3_check(cfg, instance, got, outs, want,
              f"{instance} {d_model} n={n} slots={slots} {wd}/{sd}")
    _, launch, _, outs = _k3_case(cuda, instance, d_model, n, slots,
                                  "bfloat16", wd, sd, seed=12)
    first = _k3_bits(instance, launch(), outs)
    again = _k3_bits(instance, launch(), outs)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("instance", ["mamba", "jamba"])
def test_cuda_k3_runs_of_other_lengths_back_to_back(cuda, instance):
    """K3's arrival counters live in each call's scratch and the kernel
    zeroes them itself: runs of 3, 1, 5 and 2 layers (positions) launched
    in turn each match the plain version (f32), and in bf16 each gives the
    bits it gave when launched first in another order."""
    lengths = (3, 1, 5, 2)
    for n in lengths:
        cfg, launch, plain, outs = _k3_case(cuda, instance, 64, n, 3,
                                            "float32", "int8", "int8",
                                            seed=20 + n)
        got = launch()
        want = plain()
        torch.cuda.synchronize()
        _k3_check(cfg, instance, got, outs, want, f"{instance} run of {n}")
    cases = {n: _k3_case(cuda, instance, 64, n, 3, "bfloat16", "int8",
                         "int8", seed=30 + n) for n in lengths}
    first = {n: _k3_bits(instance, cases[n][1](), cases[n][3])
             for n in lengths}
    for n in reversed(lengths):
        again = _k3_bits(instance, cases[n][1](), cases[n][3])
        assert all(torch.equal(u, v) for u, v in zip(first[n], again)), n


@pytest.mark.gpu
@pytest.mark.parametrize("d_model", [550, 2560], ids=["ragged", "2.8b"])
@pytest.mark.parametrize("slots", [1, 3, 5, 8])
@pytest.mark.parametrize("wd,sd", [("int8", "int8"), ("int8", "fp8"),
                                   ("f32", "f32")])
def test_cuda_k3_stream_widths_match_plain_and_repeat(cuda, d_model, slots,
                                                      wd, sd):
    """K3-mamba's weight stream at the ragged width (every int8 weight and
    the f32 x_proj and out_proj by the copy path, no TMA) and at
    mamba-2.8b's widths (in_proj panels of more items than the ring has
    slots: the stream wraps inside a phase), at 1, 3, 5 and 8 slots (one
    or two 4-slot passes over each panel), an int8, fp8 or f32 state: f32
    against the plain version, a bf16 launch repeated bit for bit.  The
    stack chose each weight's path by its stride, and the card's panels
    cover each weight's columns once in one round."""
    from repro_torch.kernels import megakernel
    cfg, launch, plain, stack = _k3_case(cuda, "mamba", d_model, 2, slots,
                                         "float32", wd, sd, seed=50 + slots)
    got = launch()
    want = plain()
    torch.cuda.synchronize()
    _k3_check(cfg, "mamba", got, None, want,
              f"mamba {d_model} slots={slots} {wd}/{sd}")
    _, launch, _, _ = _k3_case(cuda, "mamba", d_model, 2, slots, "bfloat16",
                               wd, sd, seed=60 + slots)
    first = _k3_bits("mamba", launch(), None)
    again = _k3_bits("mamba", launch(), None)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))
    assert stack.tma == (0b111 if d_model == 2560 else 0b001 if wd == "f32"
                         else 0)
    lc = megakernel.launch_config(cfg, torch.float32, wd == "int8", cuda)
    assert lc["ring_slots"] >= 2 and stack.map_grid == lc["grid"]
    widths = (2 * cfg.d_inner, cfg.dt_rank + 2 * cfg.d_state, cfg.d_model)
    for w, n in zip(megakernel.STREAMED, widths):
        p = lc["panels"][w]
        cols = [j for b in range(p["blocks"])
                for j in range(b * p["cols"], min(n, (b + 1) * p["cols"]))]
        assert cols == list(range(n)) and p["blocks"] <= lc["grid"], w
        assert p["cols"] * (1 if wd == "int8" else 4) % 16 == 0, w
    if d_model == 2560:
        assert lc["panels"]["in_proj"]["items"] > lc["ring_slots"]


@pytest.mark.gpu
@pytest.mark.parametrize("d_model", [550, 2560], ids=["ragged", "2.8b"])
@pytest.mark.parametrize("sd", ["int8", "fp8"])
def test_cuda_k3_stream_runs_back_to_back(cuda, d_model, sd):
    """K3-mamba's ring starts empty at every launch: stacks of 3, 1, 5 and
    2 layers launched in turn each match the plain version (f32), and in
    bf16 each gives the bits it gave when launched first in another
    order."""
    lengths = (3, 1, 5, 2)
    for n in lengths:
        cfg, launch, plain, _ = _k3_case(cuda, "mamba", d_model, n, 3,
                                         "float32", "int8", sd, seed=70 + n)
        got = launch()
        want = plain()
        torch.cuda.synchronize()
        _k3_check(cfg, "mamba", got, None, want, f"{d_model} run of {n}")
    cases = {n: _k3_case(cuda, "mamba", d_model, n, 3, "bfloat16", "int8",
                         sd, seed=80 + n) for n in lengths}
    first = {n: _k3_bits("mamba", cases[n][1](), None) for n in lengths}
    for n in reversed(lengths):
        again = _k3_bits("mamba", cases[n][1](), None)
        assert all(torch.equal(u, v) for u, v in zip(first[n], again)), n


# ---------------------------------------------------------------------------
# K3's xLSTM instances against their plain version; K8 and K9 bitwise
# ---------------------------------------------------------------------------

def _xlstm_cfg(d_model, n_heads, dtype, weight_dtype, state_dtype,
               silu_impl="exact"):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(
        configs.get_config("xlstm-350m"), d_model=d_model, n_heads=n_heads,
        vocab=64, dtype=dtype, weight_dtype=weight_dtype,
        state_dtype=state_dtype, silu_impl=silu_impl)


def _xlstm_close(cfg, kind, x1, outs1, x0, outs0, tol, label):
    """chip_smoke.py's K3-xLSTM rules: f32 values within ``tol``, a bf16
    C within a bf16 step, an int8/fp8 C within one code with its scales to
    1e-5 of themselves plus 1e-5 of the largest (a near-zero k_d carries
    the f32 dot's absolute error as a large relative one); bf16 (one
    layer at a time) values to ``tol`` of themselves plus ``tol`` of the
    largest, an int8/fp8 C dequantized as the others plus one code, its
    scales to 3e-2 of themselves plus 3e-2 of the largest."""
    from repro_torch.core import state_quant
    bf16 = cfg.dtype == "bfloat16"

    def near(a, b, t, what):
        b = b.cpu().float()
        at = t * float(b.abs().max()) if bf16 else t
        torch.testing.assert_close(a.cpu().float(), b, rtol=t, atol=at,
                                   msg=lambda m: f"{label} {what}: {m}")

    near(x1, x0, tol, "x")
    for i, (a, b) in enumerate(zip(outs1, outs0)):
        for key in a:
            if key not in ("C", "C_scale"):
                near(a[key], b[key], tol, f"[{i}] {key}")
        if kind == "slstm" or cfg.state_dtype == "f32":
            if kind == "mlstm":
                near(a["C"], b["C"], tol, f"[{i}] C")
            continue
        if cfg.state_dtype == "bf16":
            near(a["C"], b["C"], max(tol, 8e-3), f"[{i}] C")
            continue
        st = 3e-2 if bf16 else 1e-5
        near_s = b["C_scale"].cpu()
        torch.testing.assert_close(
            a["C_scale"].cpu(), near_s, rtol=st,
            atol=st * float(near_s.abs().max()),
            msg=lambda m: f"{label} [{i}] C_scale: {m}")
        if bf16:
            d1 = state_quant.dequantize_mat(a["C"], a["C_scale"]).cpu()
            d0 = state_quant.dequantize_mat(b["C"], b["C_scale"]).cpu()
            top = float(d0.abs().max())
            fp8 = cfg.state_dtype == "fp8"
            torch.testing.assert_close(
                d1, d0, rtol=tol + (0.125 if fp8 else 0.0),
                atol=tol * top + (0.0 if fp8 else top / 127),
                msg=lambda m: f"{label} [{i}] C: {m}")
        else:
            apart = (code_ordinals(a["C"].cpu())
                     - code_ordinals(b["C"].cpu())).abs()
            assert int(apart.max()) <= 1, f"{label}: codes {int(apart.max())}"


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n_layers,state_dtype", [
    ("mlstm", 3, "f32"), ("mlstm", 3, "bf16"), ("mlstm", 3, "int8"),
    ("mlstm", 3, "fp8"), ("slstm", 2, "f32")])
@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d_model,n_heads,slots", [(256, 4, 4),
                                                   (96, 4, 6)])
def test_cuda_xlstm_run_matches_plain(cuda, kind, n_layers, state_dtype,
                                      weight_dtype, dtype, tol, d_model,
                                      n_heads, slots):
    """K3's xLSTM instances against ref.xlstm_stacked_run on the card: a
    multi-layer run in f32, one layer in bf16 (the rounding steps a bf16
    run amplifies from layer to layer are held one layer at a time); a
    ragged width (heads of 48 and 24: no multiple of the 32 lanes) with 6
    slots in two passes of the 4-slot staging."""
    from repro_torch.core import dispatch_count
    from repro_torch.kernels import megakernel
    if dtype == "bfloat16":
        n_layers = 1
    cfg = _xlstm_cfg(d_model, n_heads, dtype, weight_dtype, state_dtype)
    run, x0, states, outs = xlstm_run_inputs(cfg, kind, n_layers, slots,
                                             seed=d_model, device=cuda)
    counts = dispatch_count.launch_counts(
        megakernel.xlstm_stacked_run, cfg, x0, run, states, outs)
    assert sum(counts.values()) == 1 and not any(
        k.startswith("plain") for k in counts), counts
    x1 = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    x0r, want = ref.xlstm_stacked_run(cfg, x0, kind, run.rows, states)
    torch.cuda.synchronize()
    _xlstm_close(cfg, kind, x1, outs, x0r, want, tol,
                 f"{kind} {dtype} {weight_dtype} {state_dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("silu_impl", ["ours", "paper"])
def test_cuda_xlstm_run_silu_variants(cuda, silu_impl):
    from repro_torch.kernels import megakernel
    cfg = _xlstm_cfg(256, 4, "float32", "f32", "int8", silu_impl)
    run, x0, states, outs = xlstm_run_inputs(cfg, "mlstm", 2, 4, seed=5,
                                             device=cuda)
    x1 = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    x0r, want = ref.xlstm_stacked_run(cfg, x0, "mlstm", run.rows, states)
    torch.cuda.synchronize()
    _xlstm_close(cfg, "mlstm", x1, outs, x0r, want, 1e-4, silu_impl)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cuda_xlstm_run_is_its_layers_in_turn(cuda, kind):
    """A bf16 run's one launch equals its layers launched one by one, bit
    for bit, and a repeated launch repeats its bits."""
    from repro_torch.kernels import megakernel
    cfg = _xlstm_cfg(96, 4, "bfloat16", "int8", "int8")
    run, x0, states, outs = xlstm_run_inputs(cfg, kind, 3, 5, seed=3,
                                             device=cuda)
    a = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    first = [{k: v.clone() for k, v in o.items()} for o in outs]
    b = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    x, chain = x0, []
    for row, st in zip(run.rows, states):
        out = {k: torch.empty_like(v) for k, v in st.items()}
        x = megakernel.xlstm_stacked_run(
            cfg, x, megakernel.XlstmRun(cfg, kind, [row]), [st], [out])
        chain.append(out)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, x)
    for u, v, w in zip(first, outs, chain):
        for k in u:
            assert torch.equal(u[k].view(torch.uint8), v[k].view(torch.uint8))
            assert torch.equal(u[k].view(torch.uint8), w[k].view(torch.uint8))


# K3-slstm's phase-1 items take a tile of one head's columns for all four
# gates, the narrowest tile that gives each of the card's blocks at most
# one item: on an H100 (132 SMs) 8 columns at d_model 1040 (heads of 260:
# a last tile of 4) with the tiles resident in shared memory, 16 at 1552
# (heads of 388: a last tile of 4) streamed through one buffer; held to
# the plain version in f32 over two layers, and in bf16 a launch repeats
# bit for bit and equals its layers launched in turn.
@pytest.mark.gpu
@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("d_model", [1040, 1552])
def test_cuda_slstm_ragged_items_match_plain_and_repeat(cuda, d_model,
                                                       slots, weight_dtype):
    from repro_torch.kernels import megakernel
    cfg = _xlstm_cfg(d_model, 4, "float32", weight_dtype, "f32")
    run, x0, states, outs = xlstm_run_inputs(cfg, "slstm", 2, slots,
                                             seed=d_model + slots,
                                             device=cuda)
    x1 = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    x0r, want = ref.xlstm_stacked_run(cfg, x0, "slstm", run.rows, states)
    torch.cuda.synchronize()
    label = f"slstm {d_model} x{slots} {weight_dtype}"
    _xlstm_close(cfg, "slstm", x1, outs, x0r, want, 1e-4, label)
    cfg = _xlstm_cfg(d_model, 4, "bfloat16", weight_dtype, "f32")
    run, x0, states, outs = xlstm_run_inputs(cfg, "slstm", 2, slots,
                                             seed=d_model + slots,
                                             device=cuda)
    a = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    first = [{k: v.clone() for k, v in o.items()} for o in outs]
    b = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    x, chain = x0, []
    for row, st in zip(run.rows, states):
        out = {k: torch.empty_like(v) for k, v in st.items()}
        x = megakernel.xlstm_stacked_run(
            cfg, x, megakernel.XlstmRun(cfg, "slstm", [row]), [st], [out])
        chain.append(out)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, x), label
    for u, v, w in zip(first, outs, chain):
        for k in u:
            assert torch.equal(u[k], v[k]) and torch.equal(u[k], w[k]), label


# K3-mlstm's items split C by (head, 16-row tile) over every slot, and the
# down projection by (64-column tile, row range), each summed by the last
# block to arrive at a counter the launch zeroes itself: slot counts off
# the 4-slot staging, heads no multiple of the 16-row tile (52 at d_model
# 104; 100 at d_model 100, whose int8 rows are no multiple of 8 bytes),
# held to the plain version in f32 and bitwise to their layers in bf16.
MLSTM_SPLITS = [(256, 4, 1), (256, 4, 3), (256, 4, 5), (256, 4, 8),
                (104, 4, 4), (100, 2, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("weight_dtype,state_dtype", [
    ("f32", "f32"), ("int8", "int8"), ("f32", "fp8")])
@pytest.mark.parametrize("d_model,n_heads,slots", MLSTM_SPLITS)
def test_cuda_mlstm_items_match_plain(cuda, d_model, n_heads, slots,
                                      weight_dtype, state_dtype):
    from repro_torch.kernels import megakernel
    cfg = _xlstm_cfg(d_model, n_heads, "float32", weight_dtype, state_dtype)
    run, x0, states, outs = xlstm_run_inputs(cfg, "mlstm", 3, slots,
                                             seed=d_model + slots,
                                             device=cuda)
    x1 = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    x0r, want = ref.xlstm_stacked_run(cfg, x0, "mlstm", run.rows, states)
    torch.cuda.synchronize()
    _xlstm_close(cfg, "mlstm", x1, outs, x0r, want, 1e-4,
                 f"mlstm {d_model}/{n_heads} x{slots} {weight_dtype} "
                 f"{state_dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_heads,slots", MLSTM_SPLITS)
def test_cuda_mlstm_items_are_their_layers_in_turn(cuda, d_model, n_heads,
                                                   slots):
    from repro_torch.kernels import megakernel
    cfg = _xlstm_cfg(d_model, n_heads, "bfloat16", "int8", "int8")
    run, x0, states, outs = xlstm_run_inputs(cfg, "mlstm", 3, slots,
                                             seed=d_model + slots,
                                             device=cuda)
    a = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    first = [{k: v.clone() for k, v in o.items()} for o in outs]
    b = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
    x, chain = x0, []
    for row, st in zip(run.rows, states):
        out = {k: torch.empty_like(v) for k, v in st.items()}
        x = megakernel.xlstm_stacked_run(
            cfg, x, megakernel.XlstmRun(cfg, "mlstm", [row]), [st], [out])
        chain.append(out)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, x)
    for u, v, w in zip(first, outs, chain):
        for k in u:
            assert torch.equal(u[k].view(torch.uint8), v[k].view(torch.uint8))
            assert torch.equal(u[k].view(torch.uint8), w[k].view(torch.uint8))


@pytest.mark.gpu
def test_cuda_mlstm_counters_start_at_zero(cuda):
    """Launches of different run lengths back to back, each against the
    plain version: a counter left over from the launch before would make
    the wrong block sum a tile's partials."""
    from repro_torch.kernels import megakernel
    cfg = _xlstm_cfg(256, 4, "float32", "int8", "int8")
    for n in (3, 1, 5, 2):
        run, x0, states, outs = xlstm_run_inputs(cfg, "mlstm", n, 4,
                                                 seed=40 + n, device=cuda)
        x1 = megakernel.xlstm_stacked_run(cfg, x0, run, states, outs)
        x0r, want = ref.xlstm_stacked_run(cfg, x0, "mlstm", run.rows, states)
        torch.cuda.synchronize()
        _xlstm_close(cfg, "mlstm", x1, outs, x0r, want, 1e-4,
                     f"mlstm run of {n}")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000003, 1 << 22])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,impl", [("exp", "ours"), ("exp", "fast"),
                                     ("silu", "ours"), ("silu", "paper")])
def test_cuda_units_match_plain_bitwise(cuda, op, impl, dtype, n):
    """K8 and K9 (``ops.exp`` / ``ops.silu`` with backend "pallas")
    against their plain versions: equal bit for bit, and launched once."""
    from repro_torch.core import dispatch_count
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(n)
    x = (torch.randn(n, generator=gen) * 4.0 - 1.0).to(cuda, dtype)
    fn = getattr(ops, op)
    counts = dispatch_count.launch_counts(fn, x, impl, "pallas")
    assert dict(counts) == {"fast_exp" if op == "exp" else
                            "piecewise_silu": 1}
    got = fn(x, impl, "pallas")
    want = fn(x.cpu(), impl, "pallas")
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.cpu().view(bits), want.view(bits))


# K8 and K9 over the values and shapes the random inputs above miss, held
# bit for bit; a NaN result matches any NaN (``unit_mismatches``: f32
# arithmetic on the card returns the canonical NaN, the CPU keeps the
# input's payload).  ``unit_value_mismatches`` lists the checks: every
# bf16 pattern, the special values and SiLU breaks, K8's answer for NaN
# (``repro``'s 0.0 with "fast"), sizes 1-17 and 1,000,003 with one launch
# each and a bitwise repeat, views at each offset, one device kernel a
# call.  ``chip_smoke.py`` phase 2u runs the same checks.

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,impl", UNIT_IMPLS)
def test_cuda_units_values_and_shapes(cuda, op, impl, dtype):
    assert unit_value_mismatches(op, impl, dtype, cuda) == []


# ---------------------------------------------------------------------------
# Speculative decoding: the verify micro-scan, the verify window and a
# small spec engine on the card
# ---------------------------------------------------------------------------

def _scan_window(b, K, d, dtype, device, seed):
    """A K-token window's step inputs as the Mamba block hands them over
    (x and z halves of one tensor, B and C inside the x_proj output)."""
    t = _strided_scan(b, K, d, 48, dtype, device, seed, True)
    return t.pop("h0"), t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,d", [(8, 1536), (3, 1100)])
def test_cuda_decode_scan_matches_plain(cuda, dtype, tol, b, d):
    """The K-step micro-scan: one K1 launch a token, y and every step's
    state against the plain chain on the CPU."""
    from repro_torch.core import selective_scan as css
    from repro_torch.core import dispatch_count
    h, t = _scan_window(b, 5, d, dtype, cuda, 40)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
    counts = dispatch_count.launch_counts(css.decode_scan, h, *args,
                                          D=t["D"], z_seq=t["z"])
    assert counts == {"decode_step": 5}, counts
    y1, h1 = css.decode_scan(h, *args, D=t["D"], z_seq=t["z"])
    cpu = [v.cpu() for v in (h, *args)]
    y0, h0 = css.decode_scan(*cpu, D=t["D"].cpu(), z_seq=t["z"].cpu())
    torch.cuda.synchronize()
    assert h1.shape == (b, 5, d, 16)
    close(y1.cpu(), y0.float().numpy(), tol)
    close(h1.cpu(), h0.numpy(), 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("a8", [False, True], ids=["f32_A", "int8_A"])
def test_cuda_decode_scan_q_matches_plain(cuda, state_dtype, a8):
    """The quantized micro-scan: one K2 launch a token; each step held
    at its own input (the state the micro-scan's previous step wrote)
    against the plain step, as K2's own test holds one step: a code one
    apart at step s changes step s + 1's input by a whole code (1/16 to
    1/8 of a value in fp8), so a chain run twice is not compared."""
    from repro_torch.core import selective_scan as css
    from repro_torch.core import dispatch_count, state_quant
    h, t = _scan_window(8, 5, 1536, "float32", cuda, 41)
    hq, hs = state_quant.quantize_h(h, state_dtype)
    A, a_scale = t["A"], None
    if a8:
        A, a_scale = weight_quant.quantize_rows(A)
    args = (hq, hs, t["x"], t["dt"], A, t["B"], t["C"])
    kw = dict(D=t["D"], z_seq=t["z"], state_dtype=state_dtype,
              a_scale=a_scale)
    counts = dispatch_count.launch_counts(css.decode_scan_q, *args, **kw)
    assert counts == {"decode_step_q": 5}, counts
    y, q, sc = css.decode_scan_q(*args, **kw)
    for s in range(5):
        prev = (hq, hs) if s == 0 else (q[:, s - 1], sc[:, s - 1])
        want = ref.selective_state_step_q(
            *prev, t["x"][:, s], t["dt"][:, s], A, t["B"][:, s],
            t["C"][:, s], D=t["D"], z_t=t["z"][:, s],
            state_dtype=state_dtype, a_scale=a_scale)
        torch.cuda.synchronize()
        assert_q_close((y[:, s], q[:, s], sc[:, s]), want, 1e-4,
                       f"step {s}")


def _spec_model(state_dtype, weight_dtype="f32", device="cpu"):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get_config("mamba-130m")), vocab=64,
        dtype="float32", scan_impl="pallas", conv_impl="pallas",
        weight_dtype=weight_dtype, state_dtype=state_dtype)
    return cfg, registry.init_params(cfg, seed=7, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype,tol", [("f32", 1e-4), ("int8", 1e-3)])
def test_cuda_verify_window_matches_cpu(cuda, state_dtype, tol):
    """The model's verify window over 6 prefilled slots (K5 once a layer
    over 5 tokens with the tail passed in, K1/K2 5 times a layer): logits
    and every step's state against the CPU's window from the same state;
    K5's tail is the last per-step tail, bitwise."""
    from repro_torch.core import dispatch_count, state_quant
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, mamba, registry
    cfg, p = _spec_model(state_dtype, "int8" if state_dtype == "int8"
                         else "f32", cuda)
    toks = torch.randint(0, 64, (6, 17), generator=torch.Generator()
                         .manual_seed(3)).to(cuda)
    _, cache = registry.prefill(cfg, p, registry.init_cache(
        cfg, 6, 32, device=cuda), {"tokens": toks[:, :12]})
    win = toks[:, 12:]
    counts = dispatch_count.launch_counts(registry.verify_scan, cfg, p,
                                          cache, win)
    L = cfg.n_layers
    step = "decode_step_q" if state_dtype == "int8" else "decode_step"
    assert counts == {"causal_conv1d": L, step: 5 * L}, counts
    logits, steps = registry.verify_scan(cfg, p, cache, win)
    cpu = torch.device("cpu")
    lc, sc = registry.verify_scan(cfg, registry.tree_to(p, cpu),
                                  registry.tree_to(cache, cpu), win.cpu())
    torch.cuda.synchronize()
    close(logits.cpu(), lc.numpy(), tol)
    close(steps["conv"].cpu(), sc["conv"].numpy(), tol)
    if state_dtype == "int8":
        apart = (code_ordinals(steps["h"].cpu())
                 - code_ordinals(sc["h"])).abs()
        assert int(apart.max()) <= 1
        close(state_quant.dequantize_h(steps["h"], steps["h_scale"]).cpu(),
              state_quant.dequantize_h(sc["h"], sc["h_scale"]).numpy(), tol)
    else:
        close(steps["h"].cpu(), sc["h"].numpy(), tol)
    lp = p["layers"][0]
    x_in, _ = mamba._project(cfg, lp["mixer"], blocks.apply_norm(
        cfg, lp["norm"], blocks.embed_apply(cfg, p["embed"], win,
                                            torch.float32)))
    _, tail = ops.causal_conv1d(x_in, lp["mixer"]["conv_w"],
                                lp["mixer"]["conv_b"],
                                x_prev=cache["conv"][0])
    assert torch.equal(tail, mamba._conv_tail_states(cache["conv"][0],
                                                     x_in)[:, -1])


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["f32", "int8", "fp8"])
def test_cuda_spec_engine_launch_counts(cuda, state_dtype):
    """A spec engine on the card (step_impl "auto": the half-depth draft
    through its own K3 view, the window per layer): every launch is one
    the engine's counters imply, no plain version runs, every scratch
    lease comes back, and the greedy streams equal the plain engine's
    (tie rule at 1e-4)."""
    from repro_torch.core import dispatch_count
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.spec_decode import DraftConfig
    wd = "int8" if state_dtype == "int8" else "f32"
    cfg, p = _spec_model("f32")
    common = dict(n_slots=2, max_seq=64, weight_dtype=wd,
                  state_dtype=state_dtype, device=str(cuda))
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 64, (int(n),), generator=gen).numpy()
               for n in (5, 9, 7)]
    sp = SamplingParams(max_new=9, logprobs=True, top_logprobs=2)
    plain = Engine(cfg, p, EngineConfig(**common))
    ref_reqs = [plain.submit(q, sp) for q in prompts]
    plain.run()
    eng = Engine(cfg, p, EngineConfig(**common, draft=DraftConfig(
        k=3, layers=2)))
    dispatch_count.reset()
    reqs = [eng.submit(q, sp) for q in prompts]
    eng.run()
    torch.cuda.synchronize()
    got = +dispatch_count.snapshot()
    s = eng.stats
    L, A, P, D = cfg.n_layers, s.prefill_calls, s.spec_passes, \
        s.spec_draft_steps
    S = s.decode_steps - D - P
    quant = state_dtype != "f32"
    k3 = "mamba_stacked_step" + ("_q" if quant else "") + (
        "_int8a" if wd == "int8" else "")
    step = "decode_step_q" if quant else (
        "decode_step_int8a" if wd == "int8" else "decode_step")
    want = {"selective_scan": L * A, "causal_conv1d": L * (A + P),
            step: L * (D + P), k3: D + S}
    assert P > 0 and D > 0
    assert got == {k: v for k, v in want.items() if v}, (got, want)
    assert eng.pool.n_scratch_free == eng.pool.n_scratch == 2
    assert_streams_tie_equal(reqs, ref_reqs, 1e-4, state_dtype)


# ---------------------------------------------------------------------------
# The serving front on the card: K3 at one row (the prefix cache's suffix
# chain), hit == cold, disaggregated == monolithic, the master's K3 view
# ---------------------------------------------------------------------------

def _one_row(tree):
    """Row 1 of a two-slot input, as its own contiguous one-slot input
    (row 0 of the inputs ``_torch_inputs`` makes is a fresh slot:
    zero state)."""
    from repro_torch.models import registry
    return registry.tree_map(lambda t: t[1:].contiguous(), tree)


@pytest.mark.gpu
@pytest.mark.parametrize("wd,sd", [("f32", "f32"), ("int8", "int8")])
@pytest.mark.parametrize("instance", ["mamba", "jamba", "mlstm", "slstm"])
def test_cuda_k3_one_row_matches_plain_and_repeats(cuda, instance, wd, sd):
    """Each K3 instance at one slot, a used state in it: mamba-130m's 24
    layers at full width, a jamba run of 3 positions at the ragged width,
    a 7-layer mLSTM run and an sLSTM layer at xlstm-350m's widths; f32
    against the plain version, a bf16 launch repeated bit for bit."""
    from repro_torch.kernels import megakernel

    def case(dtype, seed):
        if instance == "mamba":
            cfg = _mega_cfg(768, 24, dtype, wd, sd)
            p, x0, h, h_scale, conv = stacked_inputs(cfg, 2, seed=seed,
                                                     device=cuda)
            h, conv = h[:, 1:].contiguous(), conv[:, 1:].contiguous()
            h_scale = (None if h_scale is None
                       else h_scale[:, 1:].contiguous())
            x0 = x0[1:].contiguous()
            return (cfg, lambda: megakernel.mamba_stacked_step(
                cfg, x0, p["stack"], h, h_scale, conv),
                lambda: ref.mamba_stacked_step(cfg, x0, p["stack"].layers, h,
                                               h_scale, conv), None)
        if instance == "jamba":
            cfg = _jamba_cfg(550, 1000, dtype, wd, sd)
            run, x0, states, outs = jamba_run_inputs(cfg, 3, 2, seed=seed,
                                                     device=cuda)
            plain = ref.jamba_stacked_run
            launch_fn = megakernel.jamba_stacked_run
            rows = run.rows
        else:
            cfg = _xlstm_cfg(1024, 4, dtype, wd,
                             sd if instance == "mlstm" else "f32")
            run, x0, states, outs = xlstm_run_inputs(
                cfg, instance, 7 if instance == "mlstm" else 1, 2,
                seed=seed, device=cuda)
            rows = run.rows

            def plain(c, x, r, s):
                return ref.xlstm_stacked_run(c, x, instance, r, s)

            launch_fn = megakernel.xlstm_stacked_run
        x0, states, outs = (x0[1:].contiguous(), _one_row(states),
                            _one_row(outs))
        return (cfg, lambda: launch_fn(cfg, x0, run, states, outs),
                lambda: plain(cfg, x0, rows, states), outs)

    cfg, launch, plain, outs = case("float32", 41)
    got = launch()
    want = plain()
    torch.cuda.synchronize()
    label = f"{instance} one row {wd}/{sd}"
    if instance == "mamba":
        _mega_close(cfg, got, want, 1e-4, label)
    elif instance == "jamba":
        _jamba_close(cfg, got, outs, *want, 1e-4, label)
    else:
        _xlstm_close(cfg, instance, got, outs, *want, 1e-4, label)
    _, launch, _, outs = case("bfloat16", 42)

    def bits(x):
        if instance == "mamba":
            return [t.view(torch.uint8).clone() for t in x if t is not None]
        return [x.view(torch.uint8).clone()] + [
            o[k].view(torch.uint8).clone() for o in outs for k in sorted(o)]

    first = bits(launch())
    again = bits(launch())
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))


def _front_prompts(n=4, shared=16, suffix=5, seed=3):
    import numpy as np
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 64, size=shared).astype(np.int32)
    return [np.concatenate([pre, rng.integers(1, 64, size=suffix).astype(
        np.int32)]) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("wd,sd", [("f32", "f32"), ("int8", "int8"),
                                   ("f32", "fp8")])
def test_cuda_prefix_hit_equals_cold(cuda, wd, sd):
    """A cache-enabled engine on the card (step_impl "auto": the suffix
    chain through K3 on the prefill master's view): each hit's stream and
    logprobs are bitwise a cold admission's of its prompt, K3 launches
    once a chain step and once a decode step, K4 and K5 once a layer a
    one-block prefill, no plain version runs; the cache-off engine's
    greedy streams agree under the tie rule (f32 state)."""
    from repro_torch.core import dispatch_count
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.prefix_cache import PrefixCacheConfig
    from repro_torch.runtime.sampling import SamplingParams
    cfg, p = _spec_model("f32")
    common = dict(n_slots=2, max_seq=64, weight_dtype=wd, state_dtype=sd,
                  device=str(cuda))
    pcc = PrefixCacheConfig(block=8)
    prompts = _front_prompts()
    sp = SamplingParams(max_new=7, logprobs=True, top_logprobs=2)
    eng = Engine(cfg, p, EngineConfig(**common, prefix_cache=pcc))
    dispatch_count.reset()
    reqs = [eng.submit(q, sp) for q in prompts]
    eng.run()
    torch.cuda.synchronize()
    got = +dispatch_count.snapshot()
    s = eng.stats
    assert s.prefix_hits == 3 and s.prefix_misses == 1
    chain = s.prefill_tokens - pcc.block * s.prefix_misses
    quant = "_q" if sd != "f32" else ""
    k3_chain = "mamba_stacked_step" + quant
    k3_decode = k3_chain + ("_int8a" if wd == "int8" else "")
    L = cfg.n_layers
    want = collections.Counter({"selective_scan": L * s.prefix_misses,
                                "causal_conv1d": L * s.prefix_misses})
    want[k3_chain] += chain
    want[k3_decode] += s.decode_steps
    assert got == want, (got, want)
    for q, r in zip(prompts, reqs):
        cold = Engine(cfg, p, EngineConfig(**common, prefix_cache=pcc))
        c = cold.submit(q, sp)
        cold.run()
        assert c.tokens == r.tokens and c.logprobs == r.logprobs
    if sd == "f32":
        off = Engine(cfg, p, EngineConfig(**common))
        ref_reqs = [off.submit(q, sp) for q in prompts]
        off.run()
        assert_streams_tie_equal(reqs, ref_reqs, 1e-4, f"{wd}/{sd}")


@pytest.mark.gpu
@pytest.mark.parametrize("wd,sd", [("f32", "f32"), ("int8", "int8")])
def test_cuda_disagg_equals_monolithic(cuda, wd, sd):
    """DisaggPipeline on one card (a 1-slot worker, a 2-slot decode
    engine): greedy and sampled streams and cumulative logprobs bitwise
    the monolithic engine's, each snapshot a slot's bytes, on the CPU."""
    import numpy as np
    from repro_torch.models import registry
    from repro_torch.runtime.disagg import DisaggConfig, DisaggPipeline
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.sampling import SamplingParams
    cfg, p = _spec_model("f32")
    common = dict(n_slots=2, max_seq=48, seed=11, weight_dtype=wd,
                  state_dtype=sd, device=str(cuda))
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, 60, size=int(rng.integers(4, 12))),
             SamplingParams(max_new=6) if i % 2 == 0 else
             SamplingParams(temperature=0.9, top_k=12, max_new=6))
            for i in range(5)]
    mono = Engine(cfg, p, EngineConfig(**common))
    for q, sp in reqs:
        mono.submit(q, sp)
    ref_out = {r.req_id: (r.tokens, r.cum_logprob) for r in mono.run()}
    pipe = DisaggPipeline(cfg, p, EngineConfig(**common),
                          DisaggConfig(queue_depth=3))
    items = [pipe.submit(q, sp) for q, sp in reqs]
    pipe.run()
    assert pipe.worker.engine.device.type == "cuda"
    assert pipe.decode.stats.prefill_tokens == 0
    for i, item in enumerate(items):
        assert (item.req.tokens, item.req.cum_logprob) == ref_out[i], i
        assert item.snap.nbytes == mono.pool.state_bytes_per_slot()
        assert all(t.device.type == "cpu"
                   for t in registry.tree_leaves(item.snap.state))


@pytest.mark.gpu
@pytest.mark.parametrize("sd", ["f32", "int8"])
def test_cuda_int8_engine_chain_runs_on_the_masters_k3_view(cuda, sd):
    """An int8-weight engine on the card with the prefix cache: decode
    launches K3's int8-weight instance, the suffix chain its f32-weight
    instance on the view built over the f32 master (the decode tree's
    view would be int8, the master's unstacked tree has none)."""
    from repro_torch.core import dispatch_count
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.prefix_cache import PrefixCacheConfig
    from repro_torch.runtime.sampling import SamplingParams
    cfg, p = _spec_model("f32")
    eng = Engine(cfg, p, EngineConfig(
        n_slots=2, max_seq=64, weight_dtype="int8", state_dtype=sd,
        step_impl="megakernel", prefix_cache=PrefixCacheConfig(block=8),
        device=str(cuda)))
    assert not eng._chain_params["stack"].int8 and eng.params["stack"].int8
    assert eng._chain_params["layers"] is eng.prefill_params["layers"]
    dispatch_count.reset()
    reqs = [eng.submit(q, SamplingParams(max_new=5))
            for q in _front_prompts(3)]
    eng.run()
    torch.cuda.synchronize()
    got = +dispatch_count.snapshot()
    s = eng.stats
    quant = "_q" if sd != "f32" else ""
    chain = s.prefill_tokens - 8 * s.prefix_misses
    assert got["mamba_stacked_step" + quant] == chain > 0
    assert got["mamba_stacked_step" + quant + "_int8a"] == s.decode_steps
    assert all(r.finished and len(r.tokens) == 5 for r in reqs)


# ---------------------------------------------------------------------------
# Training: the autograd Functions over K4, K5 and K7, the Trainer's step
# ---------------------------------------------------------------------------

#: (kind, shape) of each Function case: the scan at mamba-130m's d_inner
#: and d_state (dt_rank 48), L 512 and a ragged 33, chunk 64; the conv with
#: and without x_prev; K7 at qwen2-7b's 28/4 and olmo-1b's 16/16 heads,
#: lq = lk and lq < lk
TRAIN_CASES = [("scan", (2, 512, 1536, 16, 48, 64)),
               ("scan", (2, 33, 1536, 16, 48, 64)),
               ("conv", (2, 512, 1536, 4, False)),
               ("conv", (2, 33, 1536, 4, True)),
               ("attention", (1, 256, 256, 28, 4, 128)),
               ("attention", (1, 100, 256, 16, 16, 128))]


def _train_launches(kind, shape):
    if kind == "scan":
        return {"selective_scan": 1 + -(-shape[1] // shape[5])}
    return {"causal_conv1d" if kind == "conv" else "flash_attention": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", TRAIN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_trainable_function_matches_plain_autograd(cuda, kind, shape,
                                                         dtype):
    """A training call through ``kernels.ops`` runs the kernel's Function
    (the forward one launch; the scan's backward one more a chunk) and no
    plain version; its f32 gradients equal autograd through the plain
    version on the card within 5e-4 of each gradient's max-abs (K4's own
    forward tolerance), its bf16 ones are finite."""
    from _torch_inputs import trainable_case
    res = trainable_case(kind, shape, getattr(torch, dtype), cuda)
    assert dict(res["launches"]) == _train_launches(kind, shape), \
        res["launches"]
    assert res["finite"]
    if dtype == "float32":
        for name, err, scale in res["errs"]:
            assert err <= 5e-4 * scale, (name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba-130m", "olmo-1b"])
def test_cuda_trainer_step(cuda, arch, tmp_path):
    """One Trainer step of a smoke model on the card: a finite loss, a
    nonzero gradient in every f32 leaf, the scan and the conv (mamba) or
    K7 (the transformer) launched through their Functions at the counts
    the layer count gives, and no plain version."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import dispatch_count
    from repro_torch.models import registry
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    cfg = dataclasses.replace(configs.smoke_variant(configs.get_config(
        arch)), vocab=256)
    tcfg = TrainConfig(total_steps=1, warmup_steps=0, global_batch=4,
                       seq_len=40, grad_accum=2, ckpt_every=0,
                       ckpt_dir=str(tmp_path), device=str(cuda))
    dispatch_count.reset()
    params, _, losses = Trainer(cfg, tcfg).run(resume=False)
    torch.cuda.synchronize()
    got = +dispatch_count.snapshot()
    L = cfg.n_layers * tcfg.grad_accum
    if cfg.family == "mamba":
        want = {"selective_scan": L * (1 + -(-tcfg.seq_len
                                               // cfg.scan_chunk)),
                "causal_conv1d": L}
    else:
        want = {"flash_attention": L}
    assert dict(got) == want, got
    assert len(losses) == 1 and torch.isfinite(torch.tensor(losses)).all()
    for p in registry.tree_leaves(params):
        assert p.is_cuda and p.grad is not None
        assert bool(p.grad.abs().sum() > 0)


@pytest.mark.gpu
def test_cuda_decode_step_on_trainable_params_raises(cuda):
    """The per-layer decode step (K1) on weights that require grad, under
    grad mode, raises instead of cutting the gradient; under no_grad it
    serves."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.smoke_variant(configs.get_config(
        "mamba-130m")), step_impl="fused", dtype="float32")
    p = registry.tree_map(lambda t: t.requires_grad_(),
                          registry.init_params(cfg, seed=0, device=cuda))
    cache = registry.init_cache(cfg, 2, 16, device=cuda)
    tok = {"tokens": torch.zeros(2, 1, dtype=torch.int32, device=cuda)}
    with pytest.raises(RuntimeError, match="selective_state_step: an input "
                                           "requires grad"):
        registry.decode_step(cfg, p, cache, tok)
    with torch.no_grad():
        logits, _ = registry.decode_step(cfg, p, cache, tok)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Tensor-parallel serving's pieces on the card: two gloo ranks on the one
# card (``_torch_ranks.run_ranks``), or rank 0 alone in an NCCL group
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 5e-4), ("bfloat16", 3e-2)])
def test_cuda_sp_scan_matches_one_launch(cuda, dtype, tol, tmp_path):
    """The sequence-parallel scan, half of L a rank, one K4 launch a rank,
    against one K4 launch over the whole sequence: y within ``tol`` plus
    ``tol`` of its magnitude, h_last within 5e-4."""
    from _torch_ranks import run_ranks
    from _torch_tp_cases import _cuda_sp_scan
    for launches, y_err, h_err in run_ranks(_cuda_sp_scan, 2, tmp_path,
                                            dtype, tol):
        assert launches == 1
        assert y_err <= tol and h_err <= 5e-4, (y_err, h_err)


@pytest.mark.gpu
@pytest.mark.parametrize("sd", ["int8", "fp8"])
def test_cuda_straddled_step_matches_k2(cuda, sd, tmp_path):
    """A rank whose channels cut a scale group: K1 on the dequantized
    shard, the absmax exchanged, against the single-device K2 step —
    codes within one, scales to f32 rounding."""
    from _torch_ranks import run_ranks
    from _torch_tp_cases import _cuda_straddle
    for k1, k2, codes, rel, y_err in run_ranks(_cuda_straddle, 2, tmp_path,
                                               sd):
        assert (k1, k2) == (1, 0)
        assert codes <= 1 and rel <= 1e-5 and y_err <= 1e-4, (codes, rel,
                                                              y_err)


@pytest.mark.gpu
def test_cuda_tp1_over_nccl_is_bitwise(cuda, tmp_path):
    """tp=1 over NCCL: the served streams and logprobs bitwise the no-mesh
    engine's."""
    from _torch_ranks import run_ranks
    from _torch_tp_cases import _cuda_nccl_tp1
    single, tp1 = run_ranks(_cuda_nccl_tp1, 2, tmp_path)[0]
    assert single == tp1
