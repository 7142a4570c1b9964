"""Seeded numpy inputs for the port's kernel tests, and their conversion
to tensors: the same arrays feed repro (as JAX arrays) and the port."""
import numpy as np
import torch

VARIANTS = [("exact", "exact"), ("ours", "ours"), ("fast", "paper")]

# token-stream inputs take the compute dtype; A, D and the state stay f32
STREAM = ("x", "dt", "B", "C", "z", "x_t", "dt_t", "B_t", "C_t", "z_t",
          "x_prev")


def np_input(seed, *shape, softplus=False, neg_exp=False):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if softplus:
        a = np.log1p(np.exp(a)).astype(np.float32)
    if neg_exp:
        a = -np.exp(0.5 * a).astype(np.float32)
    return a


def scan_arrays(b, L, d, n, seed=0, h0=True):
    """x, dt, A, B, C, D, z, h0 (dt softplus'd, A < 0)."""
    return dict(x=np_input(seed, b, L, d),
                dt=np_input(seed + 1, b, L, d, softplus=True),
                A=np_input(seed + 2, d, n, neg_exp=True),
                B=np_input(seed + 3, b, L, n), C=np_input(seed + 4, b, L, n),
                D=np_input(seed + 5, d), z=np_input(seed + 6, b, L, d),
                h0=np_input(seed + 7, b, d, n) if h0 else None)


def step_arrays(b, d, n, seed=0):
    """h, x_t, dt_t, A, B_t, C_t, D, z_t of one pooled decode step."""
    return dict(h=np_input(seed, b, d, n), x_t=np_input(seed + 1, b, d),
                dt_t=np_input(seed + 2, b, d, softplus=True),
                A=np_input(seed + 3, d, n, neg_exp=True),
                B_t=np_input(seed + 4, b, n), C_t=np_input(seed + 5, b, n),
                D=np_input(seed + 6, d), z_t=np_input(seed + 7, b, d))


def to_torch(arrs, dtype="float32", device="cpu"):
    return {k: None if v is None else torch.from_numpy(v).to(
        device, getattr(torch, dtype) if k in STREAM else torch.float32)
        for k, v in arrs.items()}


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def device_kernels(fn):
    """The names of the device kernels one call of ``fn`` runs on the
    card, from torch.profiler's CUDA activity."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_launches(fn):
    """(name, grid, block) of each device kernel one call of ``fn`` runs
    on the card, from torch.profiler's trace (its kernel events carry the
    launch's grid and block as [x, y, z])."""
    import json
    import os
    import tempfile
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [(e["name"], tuple(e["args"]["grid"]), tuple(e["args"]["block"]))
            for e in events if e.get("cat") == "kernel"]


def graph_kernels(fn) -> int:
    """The number of device kernels one call of ``fn`` launches: the
    kernel nodes of a CUDA graph that captures the call, read through the
    driver (``cuGraphGetNodes``, ``cuGraphNodeGetType``).  Unlike
    ``device_kernels`` it does not depend on the tracer's state (late in
    a long process the profiler was seen to record no kernel at all)."""
    import ctypes
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:                      # a torch without keep_graph
        graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = ctypes.c_int()
    kernels = 0
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kinds)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kinds.value == 0         # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def scan_call(fn, t, **kw):
    """Call a scan (wrapper or plain version) on a to_torch() dict."""
    return fn(t["x"], t["dt"], t["A"], t["B"], t["C"], D=t["D"], z=t["z"],
              h0=t["h0"], **kw)


def q_step_tensors(b, d, n, state_dtype, seed=0, a8=False, dtype="float32",
                   device="cpu"):
    """A quantized-state decode step's inputs as tensors: step_arrays with
    h stored as codes + group scales by the port's quantize_h (slot 0 a
    fresh slot: zero codes, zero scales) and, with ``a8``, A as int8 codes
    + per-row scales.  Returns (hq, h_scale, x_t, dt_t, A, B_t, C_t) and
    dict(D=, z_t=, a_scale=)."""
    from repro_torch.core import state_quant, weight_quant
    t = to_torch(step_arrays(b, d, n, seed=seed), dtype)
    hq, h_scale = state_quant.quantize_h(t["h"] * 4.0, state_dtype)
    hq[0] = 0
    h_scale[0] = 0.0
    A, a_scale = t["A"], None
    if a8:
        A, a_scale = weight_quant.quantize_rows(A)
    args = tuple(v.to(device) for v in (hq, h_scale, t["x_t"], t["dt_t"], A,
                                        t["B_t"], t["C_t"]))
    kw = dict(D=t["D"].to(device), z_t=t["z_t"].to(device),
              a_scale=None if a_scale is None else a_scale.to(device))
    return args, kw


def code_ordinals(q):
    """Storage codes as integers in value order, so adjacent codes differ
    by 1: int8 as they are, e4m3 by sign and magnitude bits (+0 and -0
    both 0)."""
    if q.dtype == torch.int8:
        return q.to(torch.int32)
    bits = q.view(torch.uint8).to(torch.int32)
    mag = bits & 0x7F
    return torch.where(bits >= 0x80, -mag, mag)


def assert_q_close(got, want, y_tol, label=""):
    """The repro tolerances for a quantized-state step between two
    implementations: y within ``y_tol``, scales to rtol 1e-6, payloads
    within one code (FMA contraction can move a value that sits on a
    rounding boundary)."""
    (y1, q1, s1), (y0, q0, s0) = got, want
    close(y1.cpu(), np.asarray(y0.cpu().float()), y_tol)
    np.testing.assert_allclose(s1.cpu().numpy(), s0.cpu().numpy(),
                               rtol=1e-6, atol=0, err_msg=label)
    assert q1.dtype == q0.dtype and q1.shape == q0.shape, label
    diff = (code_ordinals(q1.cpu()) - code_ordinals(q0.cpu())).abs()
    apart = int(diff.max())
    assert apart <= 1, f"{label}: payloads {apart} codes apart"


def stacked_inputs(cfg, slots, seed=0, device="cpu"):
    """One K3 call's inputs at cfg's shapes: the weights made from
    ``seed`` (int8 when cfg.weight_dtype is) with their stacked view, x0
    (slots, 1, d_model) in cfg.dtype, the stacked state h (+ h_scale for
    an int8/fp8 state) and conv tail.  Slot 0 is a fresh slot: zero
    state, zero scales.  Returns (params, x0, h, h_scale or None, conv)."""
    from repro_torch.core import state_quant
    from repro_torch.models import registry
    params = registry.stack_params(
        cfg, registry.init_params(cfg, seed=seed, device=device))
    dt = getattr(torch, cfg.dtype)
    L, di, n, k = cfg.n_layers, cfg.d_inner, cfg.d_state, cfg.d_conv
    x0 = torch.from_numpy(np_input(seed + 1, slots, 1, cfg.d_model))
    h = torch.from_numpy(np_input(seed + 2, L, slots, di, n)) * 0.5
    h[:, 0] = 0.0
    conv = torch.from_numpy(np_input(seed + 3, L, slots, k - 1, di))
    h_scale = None
    if state_quant.is_quantized(cfg.state_dtype):
        h, h_scale = state_quant.quantize_h(h, cfg.state_dtype)
        h_scale[:, 0] = 0.0
        h_scale = h_scale.to(device)
    else:
        h = h.to(state_quant.storage_dtype(cfg.state_dtype))
    return (params, x0.to(device, dt), h.to(device), h_scale,
            conv.to(device, dt))


def jamba_run_inputs(cfg, n_pos, slots, seed=0, device="cpu"):
    """One call of K3's jamba instance at cfg's shapes: ``n_pos`` mamba +
    MLP positions drawn from ``seed`` on ``device`` (int8 when
    cfg.weight_dtype is) as a ``megakernel.JambaRun``, x0 (slots, 1,
    d_model) in cfg.dtype, one state dict per position (h, conv, + h_scale
    for an int8/fp8 state; slot 0 a fresh slot) and output dicts to write
    into.  Returns (run, x0, states, outs)."""
    from repro_torch.core import state_quant, weight_quant
    from repro_torch.kernels import megakernel
    from repro_torch.models import jamba, registry
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = registry.tree_to([jamba._sublayer_init(cfg, gen, 0)
                             for _ in range(n_pos)], device)
    if weight_quant.is_quantized(cfg.weight_dtype):
        rows = weight_quant.quantize_tree(rows)
    dt = getattr(torch, cfg.dtype)
    di, n, k = cfg.d_inner, cfg.d_state, cfg.d_conv
    x0 = torch.from_numpy(np_input(seed + 1, slots, 1, cfg.d_model))
    states = []
    for i in range(n_pos):
        h = torch.from_numpy(np_input(seed + 2 + i, slots, di, n)) * 0.5
        h[0] = 0.0
        st = {"conv": torch.from_numpy(np_input(seed + 20 + i, slots, k - 1,
                                                di)).to(device, dt)}
        if state_quant.is_quantized(cfg.state_dtype):
            h, scale = state_quant.quantize_h(h, cfg.state_dtype)
            scale[0] = 0.0
            st["h_scale"] = scale.to(device)
        else:
            h = h.to(state_quant.storage_dtype(cfg.state_dtype))
        st["h"] = h.to(device)
        states.append(st)
    outs = [{key: torch.empty_like(v) for key, v in st.items()}
            for st in states]
    return megakernel.JambaRun(cfg, rows), x0.to(device, dt), states, outs


def xlstm_run_inputs(cfg, kind, n_layers, slots, seed=0, device="cpu"):
    """One call of K3's xLSTM instance at cfg's shapes: ``n_layers``
    blocks of ``kind`` ("mlstm" or "slstm") drawn from ``seed`` on
    ``device`` (int8 when cfg.weight_dtype is) as a
    ``megakernel.XlstmRun``, x0 (slots, 1, d_model) in cfg.dtype, one
    state dict per layer at cfg.state_dtype (slot 0 a fresh slot: zero
    state and scales, m = -1e30) and output dicts to write into.  A bf16
    model's conv tails hold bf16 values, as its cache does.  Returns
    (run, x0, states, outs)."""
    from repro_torch.core import state_quant, weight_quant
    from repro_torch.kernels import megakernel
    from repro_torch.models import registry, xlstm
    gen = torch.Generator(device=device).manual_seed(seed)
    init = (xlstm.mlstm_block_init if kind == "mlstm"
            else xlstm.slstm_block_init)
    rows = registry.tree_to([init(cfg, gen) for _ in range(n_layers)],
                            device)
    if weight_quant.is_quantized(cfg.weight_dtype):
        rows = weight_quant.quantize_tree(rows)
    dt = getattr(torch, cfg.dtype)
    d, nh = cfg.d_model, cfg.n_heads
    x0 = torch.from_numpy(np_input(seed + 1, slots, 1, d))
    states = []
    for i in range(n_layers):
        s = seed + 10 * (i + 2)
        if kind == "slstm":
            dh = d // nh
            st = {"c": np_input(s, slots, nh, dh),
                  "n": np.abs(np_input(s + 1, slots, nh, dh)) + 1.0,
                  "h": 0.5 * np_input(s + 2, slots, nh, dh),
                  "m": np_input(s + 3, slots, nh, dh)}
            st = {k: torch.from_numpy(v) for k, v in st.items()}
            for k in ("c", "n", "h"):
                st[k][0] = 0.0
            st["m"][0] = -1e30
        else:
            di = 2 * d
            dh = di // nh
            C = torch.from_numpy(np_input(s, slots, nh, dh, dh)) * 0.5
            st = {"n": torch.from_numpy(np_input(s + 1, slots, nh, dh)),
                  "m": torch.from_numpy(np_input(s + 2, slots, nh)),
                  "conv": torch.from_numpy(np_input(s + 3, slots,
                                                    cfg.d_conv - 1, di))
                  .to(dt).float()}
            C[0] = 0.0
            st["n"][0] = 0.0
            st["m"][0] = -1e30
            st["conv"][0] = 0.0
            if state_quant.is_quantized(cfg.state_dtype):
                C, scale = state_quant.quantize_mat(C, cfg.state_dtype)
                scale[0] = 0.0
                st["C_scale"] = scale
            else:
                C = C.to(state_quant.storage_dtype(cfg.state_dtype))
            st["C"] = C
        states.append({k: v.to(device) for k, v in st.items()})
    outs = [{key: torch.empty_like(v) for key, v in st.items()}
            for st in states]
    return (megakernel.XlstmRun(cfg, kind, rows), x0.to(device, dt), states,
            outs)


# ---------------------------------------------------------------------------
# The MARCA units standalone (K8 fast exp, K9 piecewise SiLU)
# ---------------------------------------------------------------------------

#: (op, impl) of each approximate unit: K8's "ours" and "fast" biases, K9's
#: "ours" and "paper" segments
UNIT_IMPLS = (("exp", "ours"), ("exp", "fast"), ("silu", "ours"),
              ("silu", "paper"))
#: the breaks of K9's "ours" segments ("paper"'s are -5, -1.5 and 0.75)
SILU_BREAKS = (-9.0, -5.0, -1.5, 0.75, 2.25, 4.5, 9.0)


def _exp_args(impl):
    from repro_torch.core import approx
    if impl == "ours":
        return approx.OUR_EXP_B_SHIFT, approx.OUR_EXP_C
    return approx.FAST_EXP_B_SHIFT, 0.0


def unit_fns(op, impl):
    """(the kernel's wrapper, its plain version) of one unit."""
    from repro_torch.kernels import fast_exp, piecewise_silu, ref
    if op == "exp":
        a = _exp_args(impl)
        return (lambda x: fast_exp.fast_exp(x, *a),
                lambda x: ref.fast_exp(x, *a))
    return (lambda x: piecewise_silu.piecewise_silu(x, impl),
            lambda x: ref.piecewise_silu(x, impl))


def unit_raw(op, impl, x, y):
    """The unit's C entry on x into y exactly as given, views at any
    offset included (the wrapper always writes a fresh, aligned y)."""
    from repro_torch.core import approx
    from repro_torch.kernels import _lib
    args = (x.data_ptr(), y.data_ptr(), x.numel(), _lib.DTYPES[x.dtype])
    if op == "exp":
        b, c = _exp_args(impl)
        _lib.call("marca_fast_exp", x.device, *args,
                  approx._f32((127.0 + b) * approx._S23), approx._f32(c))
    else:
        _lib.call("marca_piecewise_silu", x.device, *args,
                  int(impl == "paper"))


def unit_special_values(dtype, device="cpu"):
    """+-0, +-inf, NaNs of several signs and payloads, subnormals, the
    largest finite values, K8's clamp at +-80 and every SiLU break, each
    of the last with its f32 neighbours (``torch.nextafter``), in
    ``dtype``."""
    bits = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                     0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                     0x7FFFFFFF, 0xFFFFFFFF, 0x00000001, 0x80000001,
                     0x00400000, 0x007FFFFF, 0x807FFFFF, 0x7F7FFFFF,
                     0xFF7FFFFF], np.uint32).view(np.float32)
    pts = torch.tensor(SILU_BREAKS + (-80.0, 80.0))
    inf = torch.full_like(pts, float("inf"))
    x = torch.cat([torch.from_numpy(bits.copy()), pts,
                   torch.nextafter(pts, inf), torch.nextafter(pts, -inf)])
    return x.to(device, dtype)


def every_bf16(device="cpu"):
    """All 65,536 bf16 bit patterns, NaNs included."""
    return torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).to(device)


def unit_mismatches(got, want) -> int:
    """The elements whose bits differ, a NaN matching any NaN: f32
    arithmetic on the card returns the canonical NaN whatever the input's
    payload, where the CPU keeps it, so the bits of a NaN result are not
    compared (only that it is NaN)."""
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(((got.view(bits) != want.view(bits)) & ~both_nan).sum())


def unit_value_mismatches(op, impl, dtype, device):
    """One unit (K8 or K9, a variant, f32 or bf16) on the card against its
    plain version over the values and shapes random inputs miss.  Returns
    one line for each check that failed, so empty when all hold.  Each
    result is held bit for bit, a NaN matching any NaN
    (``unit_mismatches``):

    - every bf16 bit pattern (bf16 only);
    - ``unit_special_values``, against the plain version on the card and
      on the CPU;
    - K8's answer for NaN is ``repro``'s: the clamp keeps the NaN and the
      truncating cast makes it 0, so 0.0 + c (0.0 with "fast", c with
      "ours"), not the value at -80 that a clamp dropping the NaN gives;
    - sizes 1-17 and 1,000,003, each one launch (the wrapper's count) and
      repeated bit for bit;
    - a view at each offset within a 16-byte vector, beside a fresh output
      (the scalar loop) and into an output at the same offset (head,
      vectors, tail);
    - one device kernel a call.
    """
    from repro_torch.core import approx
    from repro_torch.kernels import fast_exp, piecewise_silu
    mod = fast_exp if op == "exp" else piecewise_silu
    kern, plain = unit_fns(op, impl)
    bad = []

    def hold(what, got, want):
        n = unit_mismatches(got, want)
        if n:
            bad.append(f"{what}: {n} elements differ")

    if dtype == torch.bfloat16:
        x = every_bf16(device)
        hold("every bf16 pattern", kern(x), plain(x))
    x = unit_special_values(dtype, device)
    got = kern(x)
    hold("special values and breaks", got, plain(x))
    hold("special values and breaks, CPU plain", got.cpu(), plain(x.cpu()))
    if op == "exp":
        nan = torch.full((9,), float("nan"), device=device, dtype=dtype)
        c = 0.0 if impl == "fast" else approx._f32(approx.OUR_EXP_C)
        hold("exp(NaN) is repro's", kern(nan).cpu(),
             torch.full((9,), c, dtype=dtype))
    gen = torch.Generator().manual_seed(17)
    base = (torch.randn(1000003 + 16, generator=gen) * 4.0 - 1.0).to(device,
                                                                     dtype)
    for n in [*range(1, 18), 1000003]:
        x = base[:n]
        n0 = mod.launches
        got = kern(x)
        if mod.launches != n0 + 1:
            bad.append(f"n={n}: {mod.launches - n0} launches a call")
        hold(f"n={n}", got, plain(x))
        hold(f"n={n} repeated", kern(x), got)
    for k in range(1, 16 // base.element_size()):
        x = base[k:k + 1000003]
        hold(f"x[{k}:]", kern(x), plain(x))
        y = torch.empty_like(base)[k:k + 1000003]
        unit_raw(op, impl, x, y)
        hold(f"x[{k}:] into y[{k}:]", y, plain(x))
    n_k = graph_kernels(lambda: kern(base[:1000003]))
    if n_k != 1:
        bad.append(f"{n_k} device kernels a call")
    return bad


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def tree_equal(a, b) -> bool:
    """Bitwise equality of two trees of tensors, dict entries matched by
    key (fp8 leaves compared as bytes)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(tree_equal, a, b))
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def first_difference(got, ref):
    """Position of the first token where two streams differ, or None."""
    return next((t for t, (a, b) in enumerate(zip(got, ref)) if a != b),
                None)


def assert_streams_tie_equal(got, ref, tol, label=""):
    """The speculative tie rule: each request of ``got`` has the stream of
    its counterpart in ``ref`` (run with top_logprobs >= 2), or the two
    first differ at a position where ref's top two logits are within
    ``tol`` (the margin printed)."""
    for g, r in zip(got, ref):
        i = first_difference(g.tokens, r.tokens)
        if i is None:
            assert len(g.tokens) == len(r.tokens), label
            continue
        (_, v0), (_, v1) = r.top_logprobs[i][:2]
        print(f"{label} req {r.req_id}: first differing token at {i}, "
              f"reference top-two margin {v0 - v1:.3e}")
        assert v0 - v1 <= tol, (label, r.req_id, i, v0 - v1)
