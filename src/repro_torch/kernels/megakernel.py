"""Cross-layer decode megakernel (K3): wrappers over the CUDA kernels
``csrc/megakernel_mamba.cu`` (the mamba instance),
``csrc/megakernel_mamba.cuh`` (the jamba instance) and
``csrc/megakernel_xlstm.cuh``.

Port of ``repro/kernels/decode_step.py:413`` ``stacked_layer_launch``
(pallas_call at :488) with four of its bodies:

* the mamba instance (``repro/models/mamba_lm.py:160``): one launch per
  decoded token runs every layer (norm -> ``mamba.mamba_block_megastep``
  -> residual) for the whole slot pool (``mamba_stacked_step``);
* the jamba instance (``repro/models/jamba.py:305``): one launch per run
  of pure-SSM positions of a group adds norm2 -> swiglu MLP -> residual
  after each position's mamba block (``jamba_stacked_run``);
* the xLSTM instances ``marca_megakernel_mlstm`` and
  ``marca_megakernel_slstm`` (``repro/models/xlstm.py:575``): one launch
  per run of same-kind layers runs each layer's block step and residual
  (``xlstm_stacked_run``).

On a CUDA tensor the kernel runs; on a CPU tensor its plain version
(``kernels.ref.mamba_stacked_step``, ``kernels.ref.jamba_stacked_run``,
``kernels.ref.xlstm_stacked_run``) does.

``repro`` stacks each layer parameter on a leading L axis; the port keeps
a list of per-layer dicts.  ``MambaStack`` gives K3 its view of them
without a copy: a table of the layers' device pointers, built once per
engine (``registry.stack_params``), which also holds a reference to every
tensor it points at.  The mamba state is stacked as in the decode cache:
h (L, slots, d_inner, 16), h_scale (L, slots, g), conv (L, slots, k-1,
d_inner).  ``JambaRun`` is the same view of one run of jamba positions;
their states live in different cache leaves, so each launch hands the
kernel one pointer per position and state tensor, and no cache is
stacked or copied.  ``XlstmRun`` is the same view of one run of xLSTM
layers, whose states are handed over in the same way.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import state_quant
from repro_torch.kernels import _lib, ref

#: kernel launches made by ``mamba_stacked_step``, one count per variant:
#: f32 or int8 weights (f32 A or int8 A) x an f32/bf16 or int8/fp8 state
launches = 0
launches_int8a = 0
launches_q = 0
launches_q_int8a = 0
#: the same four counts for ``jamba_stacked_run``
jamba_launches = 0
jamba_launches_int8a = 0
jamba_launches_q = 0
jamba_launches_q_int8a = 0
#: ``xlstm_stacked_run``'s launches: mLSTM runs by f32 or int8 weights x
#: an f32/bf16 or int8/fp8 C, sLSTM runs (whose state is always f32) by
#: weights
mlstm_launches = 0
mlstm_launches_int8w = 0
mlstm_launches_q = 0
mlstm_launches_q_int8w = 0
slstm_launches = 0
slstm_launches_int8w = 0

#: the columns of the per-layer pointer table, in the order of
#: ``WeightColumn`` in csrc/megakernel_mamba.cu: a path into the layer's
#: dict, "A" being ``A_log`` for f32 weights and ``A_q`` for int8 ones; a
#: ``*_scale`` column exists only for int8 weights
TABLE_COLUMNS = (
    ("norm", "scale"), ("mixer", "in_proj", "w"),
    ("mixer", "in_proj", "w_scale"), ("mixer", "conv_w"),
    ("mixer", "conv_b"), ("mixer", "x_proj", "w"),
    ("mixer", "x_proj", "w_scale"), ("mixer", "dt_proj", "w"),
    ("mixer", "dt_proj", "w_scale"), ("mixer", "dt_bias"), ("mixer", "A"),
    ("mixer", "A_scale"), ("mixer", "D"), ("mixer", "out_proj", "w"),
    ("mixer", "out_proj", "w_scale"))
#: the jamba instance's further columns (``W_NORM2`` on): norm2 and the
#: swiglu MLP; its mamba columns read "norm1" for "norm" and "mamba" for
#: "mixer" (``JAMBA_NAMES``)
MLP_COLUMNS = (
    ("norm2", "scale"), ("mlp", "w1", "w"), ("mlp", "w1", "w_scale"),
    ("mlp", "w3", "w"), ("mlp", "w3", "w_scale"), ("mlp", "w2", "w"),
    ("mlp", "w2", "w_scale"))
JAMBA_NAMES = {"norm": "norm1", "mixer": "mamba"}
_TABLE_WIDTH = 24
#: the most positions one jamba launch takes (one group less its
#: attention position)
MAX_RUN = 8

_TILE = 128      # columns of a GEMV tile (csrc kCW)
_PHASES = 5      # GEMV phases with tile counters (csrc kPhases)
#: the widest d_model K3's mamba and jamba instances take (csrc
#: megakernel_mamba.cu kNormPer x kMThreads, megakernel_mamba.cuh
#: kMaxModel) and the widest d_conv the jamba instance takes (kMaxConv;
#: the mamba instance's is one more)
MAX_MODEL = 4096
MAX_CONV = 4


def _shapes(cfg, int8: bool, mlp: bool) -> dict:
    """The shape and dtype of each table column for one layer (with
    ``mlp``, a jamba position's, in the mamba instance's names)."""
    dm, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank,
                       cfg.d_conv)
    w = torch.int8 if int8 else torch.float32
    f = torch.float32
    nx = r + 2 * n
    out = {
        ("norm", "scale"): ((dm,), f),
        ("mixer", "in_proj", "w"): ((dm, 2 * di), w),
        ("mixer", "conv_w"): ((k, di), f),
        ("mixer", "conv_b"): ((di,), f),
        ("mixer", "x_proj", "w"): ((di, nx), w),
        ("mixer", "dt_proj", "w"): ((r, di), w),
        ("mixer", "dt_bias"): ((di,), f),
        ("mixer", "A"): ((di, n), w),
        ("mixer", "D"): ((di,), f),
        ("mixer", "out_proj", "w"): ((di, dm), w),
    }
    if int8:
        out.update({
            ("mixer", "in_proj", "w_scale"): ((2 * di,), f),
            ("mixer", "x_proj", "w_scale"): ((nx,), f),
            ("mixer", "dt_proj", "w_scale"): ((di,), f),
            ("mixer", "A_scale"): ((di,), f),
            ("mixer", "out_proj", "w_scale"): ((dm,), f),
        })
    if mlp:
        ff = cfg.d_ff
        out.update({("norm2", "scale"): ((dm,), f),
                    ("mlp", "w1", "w"): ((dm, ff), w),
                    ("mlp", "w3", "w"): ((dm, ff), w),
                    ("mlp", "w2", "w"): ((ff, dm), w)})
        if int8:
            out.update({("mlp", "w1", "w_scale"): ((ff,), f),
                        ("mlp", "w3", "w_scale"): ((ff,), f),
                        ("mlp", "w2", "w_scale"): ((dm,), f)})
    return out


def _leaf(layer, path, int8, names=None):
    node = layer
    for i, key in enumerate(path):
        if key == "A":
            key = "A_q" if int8 else "A_log"
        if i == 0 and names:
            key = names.get(key, key)
        if key not in node:
            raise ValueError(f"layer has no {'.'.join(path)} for K3")
        node = node[key]
    return node


def _copy_dicts(row):
    """The row's dict structure (two levels) over the same tensors."""
    return {k: ({kk: dict(vv) if isinstance(vv, dict) else vv
                 for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in row.items()}


def _check_cfg(cfg, family):
    _lib.require(cfg.family == family,
                 f"K3 runs the {family} family here, not {cfg.family!r}")
    _lib.require(cfg.d_state == 16,
                 f"K3 takes d_state 16, got {cfg.d_state}")
    _lib.require(cfg.norm == "rmsnorm",
                 f"K3 takes rmsnorm, got norm {cfg.norm!r}")
    if family == "mamba":
        _lib.require(cfg.d_conv <= MAX_CONV + 1,
                     f"K3's mamba instance takes d_conv up to "
                     f"{MAX_CONV + 1}, not {cfg.d_conv}")
        _lib.require(cfg.d_model <= MAX_MODEL,
                     f"K3 stages 4 slots' rows in shared memory and holds "
                     f"8 norm scales a thread: d_model {cfg.d_model} > "
                     f"{MAX_MODEL}")
        return
    _lib.require(cfg.d_model <= MAX_MODEL,
                 f"K3 copies 4 slots' residual rows into shared memory: "
                 f"d_model {cfg.d_model} > {MAX_MODEL}")
    _lib.require(cfg.d_conv <= MAX_CONV,
                 f"K3 takes d_conv up to {MAX_CONV}, not {cfg.d_conv}")


def _table(rows, columns, shapes, denses, width, leaf):
    """Check every weight of ``rows`` that K3 reads at ``columns`` (shape
    and dtype from ``shapes``, which leaves out the columns a row does
    not have: a 0 pointer; contiguity, one device, no bias on the dense
    layers ``denses``), reading a row's entry with ``leaf(row, path)``,
    and return (device, the ``(len(rows), width)`` int64 table of their
    device pointers on a card, else None)."""
    table = []
    for row in rows:
        for path in denses:
            extra = set(leaf(row, path)) - {"w", "w_scale"}
            _lib.require(not extra,
                         f"K3 takes no dense bias ({path[-1]}: {extra})")
        tensors = []
        for path in columns:
            if path not in shapes:
                tensors.append(None)
                continue
            t = leaf(row, path)
            _lib.check_dense(".".join(path), t, shapes[path][1],
                             shapes[path][0])
            tensors.append(t)
        table.append(tensors)
    device = table[0][0].device
    for tensors in table:
        _lib.check_same_device(device, **{
            ".".join(p): t for p, t in zip(columns, tensors)})
    if device.type != "cuda":
        return device, None
    ptrs = [[_lib.ptr(t) or 0 for t in tensors]
            + [0] * (width - len(tensors)) for tensors in table]
    return device, torch.tensor(ptrs, dtype=torch.int64, device=device)


def _pointer_table(cfg, rows, int8, mlp):
    """``_table`` of the mamba rows (``mlp``: jamba positions) K3's mamba
    instance reads."""
    names = JAMBA_NAMES if mlp else None
    denses = [("mixer", d) for d in ("in_proj", "x_proj", "dt_proj",
                                     "out_proj")]
    if mlp:
        denses += [("mlp", d) for d in ("w1", "w3", "w2")]
    return _table(rows, TABLE_COLUMNS + (MLP_COLUMNS if mlp else ()),
                  _shapes(cfg, int8, mlp), denses, _TABLE_WIDTH,
                  lambda row, path: _leaf(row, path, int8, names))


#: the dense weights K3's mamba instance streams through its ring, in the
#: order of ``StreamedWeight`` in csrc/megakernel_mamba.cu
STREAMED = ("in_proj", "x_proj", "out_proj")


class MambaStack:
    """The per-layer weights of a Mamba stack as K3 reads them.

    Built once per engine, never per token.  Checks every weight
    (shape, dtype, contiguity, one device, f32 or int8 throughout) and
    refuses what K3 does not take: a d_state other than 16, a norm other
    than rmsnorm, dense biases, a d_model above ``MAX_MODEL`` and a d_conv
    above ``MAX_CONV`` + 1; the card refuses, at launch, a width whose
    panels or shared memory one block cannot take (``launch_config``
    reports the layout it sizes).  On the card it writes a ``(L, 24)``
    int64 table of
    the weights' device pointers and ``maps``, the ``(L, 3)`` TMA tensor
    maps (128 bytes each) of the streamed weights ``STREAMED`` over the
    panels each block fetches; ``tma`` is the mask of the weights TMA can
    read (bit w: every layer's base and row stride a multiple of 16
    bytes; the others take the kernel's copy path) and ``map_grid`` the
    grid the panels were cut for.  ``layers`` keeps a copy of the layer
    dicts' structure over the same tensors, so the tensors the table and
    maps point at live as long as the stack, whatever the caller later
    does with its own dicts.  No weight is copied."""

    def __init__(self, cfg, layers):
        _check_cfg(cfg, "mamba")
        _lib.require(len(layers) == cfg.n_layers and len(layers) > 0,
                     f"{len(layers)} layers for n_layers {cfg.n_layers}")
        self.int8 = "A_q" in layers[0]["mixer"]
        self.dims = _dims(cfg)
        self.device, self.table = _pointer_table(cfg, layers, self.int8,
                                                 mlp=False)
        self.layers = [_copy_dicts(lp) for lp in layers]
        self.maps, self.tma, self.map_grid = None, 0, None
        if self.table is not None:
            self._encode_maps(cfg)

    def _encode_maps(self, cfg):
        L = len(self.layers)
        ptrs = (ctypes.c_int64 * (L * len(STREAMED)))(*[
            _lib.ptr(lp["mixer"][w]["w"]) for lp in self.layers
            for w in STREAMED])
        buf = torch.zeros(L * len(STREAMED) * 128, dtype=torch.uint8)
        info = (ctypes.c_int * 2)()
        with torch.cuda.device(self.device):
            rc = _lib.lib().marca_mamba_stack_maps(
                ctypes.cast(ptrs, ctypes.c_void_p), L, cfg.d_model,
                cfg.d_inner, cfg.dt_rank, int(self.int8),
                ctypes.c_void_p(buf.data_ptr()),
                ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"marca_mamba_stack_maps: CUDA error {rc}")
        self.maps = buf.to(self.device)
        self.tma, self.map_grid = info[0], info[1]


def _dims(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.d_state,
            cfg.dt_rank, cfg.d_conv)


def mamba_scratch_floats(slots: int, d_inner: int, nx: int) -> int:
    """f32 scratch of one launch of K3's mamba instance (csrc
    megakernel_mamba.cu ``scratch_floats``): x_a, z, (dt_low | B | C), y,
    the 32-channel chunks' absmax and the f32 state values."""
    nchunks = -(-d_inner // 32)
    return slots * (3 * d_inner + nx + nchunks + 16 * d_inner)


def scratch_floats(slots: int, d_model: int, d_inner: int, nx: int,
                   d_ff: int, grid: int) -> int:
    """f32 scratch of one launch of K3's jamba instance on a grid of
    ``grid`` blocks (csrc megakernel_mamba.cuh ``scratch_floats``): x_a,
    z, (dt_low | B | C), y, the MLP hidden, the S6 chunks' absmax (one a
    slot and block), the GEMV items' partial sums (at most grid + tiles of
    them, each 2 matrices x slots x a 128-column tile; a GEMV has at most
    one tile per 32 columns of its widest weight), then the int counters:
    5 phases' tile counters, x_proj's done count and one a scale group.
    The hidden holds exactly the slots' rows: w2's items stage their rows
    of it in shared memory."""
    tiles = -(-max(2 * d_inner, nx, d_model, d_ff) // 32)
    groups = state_quant.n_groups(d_inner)
    return (slots * (3 * d_inner + nx + d_ff + grid)
            + (grid + tiles) * 2 * slots * _TILE + _PHASES * tiles + 1
            + groups)


def _grid(view, cfg, dtype, device) -> int:
    """K3's grid on ``device`` for the weights of ``view`` (a JambaRun),
    asked of the card once per dtype and device."""
    key = (dtype, device.index)
    if key not in view.grids:
        view.grids[key] = launch_config(cfg, dtype, view.int8,
                                        device)["grid"]
    return view.grids[key]


def mamba_stacked_step(cfg, x0, stack: MambaStack, h, h_scale, conv):
    """One decode token through every layer of the stack.

    x0 (slots, 1, d_model) float32 or bfloat16 (the compute dtype);
    h (L, slots, d_inner, 16) in cfg.state_dtype's storage dtype; h_scale
    (L, slots, g) f32 for an int8/fp8 state, else None; conv
    (L, slots, d_conv-1, d_inner) in x0's dtype.  Returns new tensors
    (x (slots, 1, d_model), h, h_scale or None, conv): masking inactive
    slots stays with the caller."""
    global launches, launches_int8a, launches_q, launches_q_int8a
    _lib.check_dtype(x0)
    L, dm, di, n, r, k = _dims(cfg)
    _lib.require(_dims(cfg) == stack.dims,
                 "cfg does not describe the stacked weights")
    slots = x0.shape[0]
    quant = state_quant.is_quantized(cfg.state_dtype)
    _lib.check_same_device(x0.device, stack=stack.layers[0]["norm"]["scale"],
                           h=h, h_scale=h_scale, conv=conv)
    _lib.check_dense("x0", x0, x0.dtype, (slots, 1, dm))
    _lib.check_dense("h", h, state_quant.storage_dtype(cfg.state_dtype),
                     (L, slots, di, n))
    if quant:
        _lib.require(h_scale is not None,
                     f"a {cfg.state_dtype} state needs its h_scale")
        _lib.check_dense("h_scale", h_scale, torch.float32,
                         (L, slots, state_quant.n_groups(di)))
    else:
        _lib.require(h_scale is None,
                     f"a {cfg.state_dtype} state has no h_scale")
    _lib.check_dense("conv", conv, x0.dtype, (L, slots, k - 1, di))
    _lib.check_impls(cfg.exp_impl, cfg.silu_impl)
    if x0.device.type == "cpu":
        return ref.mamba_stacked_step(cfg, x0, stack.layers, h, h_scale,
                                      conv)
    x = torch.empty_like(x0)
    h_out = torch.empty_like(h)
    scale_out = torch.empty_like(h_scale) if quant else None
    conv_out = torch.empty_like(conv)
    scratch = torch.empty(mamba_scratch_floats(slots, di, r + 2 * n),
                          dtype=torch.float32, device=x0.device)
    _lib.call("marca_mamba_stacked_step", x0.device,
              _lib.ptr(stack.table), _lib.ptr(stack.maps), stack.tma,
              _lib.ptr(x0), _lib.ptr(x), _lib.ptr(h),
              _lib.ptr(h_scale), _lib.ptr(conv), _lib.ptr(h_out),
              _lib.ptr(scale_out), _lib.ptr(conv_out), _lib.ptr(scratch),
              scratch.numel(), L, slots, dm, di, n, r, k,
              _lib.DTYPES[x0.dtype], int(stack.int8),
              _lib.STATE_DTYPES[h.dtype], _lib.EXP_IMPLS[cfg.exp_impl],
              _lib.SILU_IMPLS[cfg.silu_impl])
    if quant and stack.int8:
        launches_q_int8a += 1
    elif quant:
        launches_q += 1
    elif stack.int8:
        launches_int8a += 1
    else:
        launches += 1
    return x, h_out, scale_out, conv_out


class JambaRun:
    """One run of pure-SSM jamba positions of one group as K3 reads them:
    the positions' weights (norm1, the mamba block, norm2, the swiglu
    MLP) in a ``(positions, 24)`` device table of pointers, built once
    per engine (``registry.stack_params``) over the same tensors.  Checks
    and refuses as ``MambaStack``, and a position that is not a mamba
    block with a swiglu MLP, a d_model above ``MAX_MODEL`` or a d_conv
    above ``MAX_CONV``; the card refuses, at the first launch, a dt_rank
    and d_inner whose S6 item needs more shared memory than a block
    gets."""

    def __init__(self, cfg, rows):
        _check_cfg(cfg, "jamba")
        _lib.require(cfg.mlp == "swiglu",
                     f"K3's jamba instance takes a swiglu MLP, not "
                     f"{cfg.mlp!r}")
        _lib.require(0 < len(rows) <= MAX_RUN,
                     f"a run of {len(rows)} positions (1 to {MAX_RUN})")
        for row in rows:
            _lib.require("mamba" in row and "mlp" in row,
                         "K3 runs positions with a mamba block and an MLP: "
                         f"got {sorted(row)}")
        self.int8 = "A_q" in rows[0]["mamba"]
        self.dims = _jamba_dims(cfg)
        self.device, self.table = _pointer_table(cfg, rows, self.int8,
                                                 mlp=True)
        self.rows = [_copy_dicts(row) for row in rows]
        self.grids = {}


def _jamba_dims(cfg):
    return (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv,
            cfg.d_ff)


#: the per-position state pointers of a jamba launch, in the order of
#: ``StateRows`` in csrc/megakernel_mamba.cu
_STATE_PARTS = ("h", "h_scale", "conv")


def jamba_stacked_run(cfg, x0, run: JambaRun, states, outs):
    """One decode token through a run of jamba positions.

    x0 (slots, 1, d_model) in the compute dtype; ``states`` one dict per
    position of the run, {"h" (slots, d_inner, 16), "conv" (slots,
    d_conv-1, d_inner)} + "h_scale" (slots, g) for an int8/fp8 state,
    each contiguous (a group's entry of a cache leaf); ``outs`` dicts of
    the same tensors' shapes that the new states are written into (a
    group's entry of the new cache's leaves).  Returns the new residual
    stream x (slots, 1, d_model)."""
    global jamba_launches, jamba_launches_int8a, jamba_launches_q
    global jamba_launches_q_int8a
    _lib.check_dtype(x0)
    dm, di, n, r, k, ff = _jamba_dims(cfg)
    _lib.require(_jamba_dims(cfg) == run.dims,
                 "cfg does not describe the run's weights")
    _lib.require(len(states) == len(outs) == len(run.rows),
                 f"{len(states)} states and {len(outs)} outputs for a run "
                 f"of {len(run.rows)}")
    slots = x0.shape[0]
    quant = state_quant.is_quantized(cfg.state_dtype)
    keys = ("h", "h_scale", "conv") if quant else ("h", "conv")
    shapes = {"h": ((slots, di, n), state_quant.storage_dtype(
                  cfg.state_dtype)),
              "h_scale": ((slots, state_quant.n_groups(di)), torch.float32),
              "conv": ((slots, k - 1, di), x0.dtype)}
    _lib.check_same_device(x0.device, run=run.rows[0]["norm1"]["scale"])
    _lib.check_dense("x0", x0, x0.dtype, (slots, 1, dm))
    for i, (st, out) in enumerate(zip(states, outs)):
        for part in (st, out):
            _lib.require(set(part) == set(keys),
                         f"position {i} of the run: state {sorted(part)}, "
                         f"a {cfg.state_dtype} state has {sorted(keys)}")
            for key in keys:
                _lib.check_same_device(x0.device, **{key: part[key]})
                _lib.check_dense(key, part[key], shapes[key][1],
                                 shapes[key][0])
    _lib.check_impls(cfg.exp_impl, cfg.silu_impl)
    if x0.device.type == "cpu":
        x, new = ref.jamba_stacked_run(cfg, x0, run.rows, states)
        for ns, out in zip(new, outs):
            for key in keys:
                out[key].copy_(ns[key])
        return x
    x = torch.empty_like(x0)
    scratch = torch.empty(
        scratch_floats(slots, dm, di, r + 2 * n, ff,
                       _grid(run, cfg, x0.dtype, x0.device)),
        dtype=torch.float32, device=x0.device)
    ptrs = (ctypes.c_int64 * (2 * len(_STATE_PARTS) * MAX_RUN))()
    for c, part in enumerate(_STATE_PARTS):
        for i, (st, out) in enumerate(zip(states, outs)):
            ptrs[c * MAX_RUN + i] = _lib.ptr(st.get(part)) or 0
            ptrs[(c + len(_STATE_PARTS)) * MAX_RUN + i] = (
                _lib.ptr(out.get(part)) or 0)
    _lib.call("marca_jamba_stacked_run", x0.device,
              _lib.ptr(run.table), _lib.ptr(x0), _lib.ptr(x),
              ctypes.cast(ptrs, ctypes.c_void_p), _lib.ptr(scratch),
              scratch.numel(), len(run.rows), slots, dm, di, n, r, k, ff,
              _lib.DTYPES[x0.dtype], int(run.int8),
              _lib.STATE_DTYPES[states[0]["h"].dtype],
              _lib.EXP_IMPLS[cfg.exp_impl], _lib.SILU_IMPLS[cfg.silu_impl])
    if quant and run.int8:
        jamba_launches_q_int8a += 1
    elif quant:
        jamba_launches_q += 1
    elif run.int8:
        jamba_launches_int8a += 1
    else:
        jamba_launches += 1
    return x


def launch_config(cfg, dtype, int8: bool, device="cuda") -> dict:
    """The grid K3 takes on ``device`` for this model (its jamba instance
    for a jamba config): blocks per SM, blocks, dynamic shared memory
    bytes and threads per block; for the mamba instance also its weight
    ring's slots and, for each weight of ``STREAMED``, its panels as the
    card cuts them: columns a block, blocks with a panel and ring items
    a panel.  A configuration whose panels or shared memory the card
    cannot give one block is refused here (and at launch)."""
    out = (ctypes.c_int * 14)()
    with torch.cuda.device(device):
        rc = _lib.lib().marca_mamba_stacked_grid(
            cfg.d_model, cfg.d_inner, cfg.dt_rank, _lib.DTYPES[dtype],
            int(int8), int(cfg.family == "jamba"),
            ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"marca_mamba_stacked_grid: CUDA error {rc}")
    got = {"blocks_per_sm": out[0], "grid": out[1], "smem_bytes": out[2],
           "threads": out[3]}
    if cfg.family != "jamba":
        got["ring_slots"] = out[4]
        got["panels"] = {w: {"cols": out[5 + 3 * i], "blocks": out[6 + 3 * i],
                             "items": out[7 + 3 * i]}
                         for i, w in enumerate(STREAMED)}
    return got


# ---------------------------------------------------------------------------
# K3's xLSTM instances (csrc/megakernel_xlstm.cuh)
# ---------------------------------------------------------------------------

#: the columns of an xLSTM run's pointer table, in the order of
#: ``MlstmColumn`` / ``SlstmColumn`` in csrc/megakernel_xlstm.cuh; a
#: ``w_scale`` column exists only for int8 weights (the per-head wq, wk and
#: sLSTM r are no dense layers and stay f32 under int8 weights, as in repro)
XLSTM_COLUMNS = {
    "mlstm": (("norm", "scale"), ("norm", "bias"), ("up", "w"),
              ("up", "w_scale"), ("conv_w",), ("wq",), ("wk",), ("wi",),
              ("wf",), ("bi",), ("bf",), ("gn_scale",), ("down", "w"),
              ("down", "w_scale")),
    "slstm": (("norm", "scale"), ("norm", "bias"), ("wx", "w"),
              ("wx", "w_scale"), ("r",), ("b",), ("gn_scale",),
              ("out", "w"), ("out", "w_scale")),
}
_XLSTM_TABLE_WIDTH = 16
#: the state tensors of a layer, in the order of the kernel's state parts
XLSTM_PARTS = {"mlstm": ("C", "C_scale", "n", "m", "conv"),
               "slstm": ("c", "n", "h", "m")}
_XLSTM_NPARTS = 5
#: the most layers one xLSTM launch takes
MAX_XLSTM_RUN = 32
#: the widest head: a C row is one warp's 16 columns a lane, the cell's
#: reduction holds 16 warps x dh floats, and D's work a thread a column
MAX_XLSTM_HEAD = 512
#: the widest d_model of an xLSTM run: the mLSTM's E stages 4 slots' rows
#: of y for its row range in shared memory beside its weight tile, the
#: sLSTM stages 4 slots' inputs beside its weight buffer (csrc kMaxXModel)
MAX_XLSTM_MODEL = 4096
_XLSTM_ROWS = 16     # rows of C per C' item (csrc kTileRows)
_XLSTM_GROUP = 8     # C' tiles summed by one block (kGroupTiles)
_XLSTM_MAX_SPLIT = 32  # K splits of the down projection, at most (kMaxSplit)


def _xlstm_dims(cfg, kind):
    """(d_model, n_heads, head width, inner width) of a block."""
    d, nh = cfg.d_model, cfg.n_heads
    di = 2 * d if kind == "mlstm" else d
    return d, nh, di // nh, di


def _xlstm_shapes(cfg, kind, int8):
    d, nh, dh, di = _xlstm_dims(cfg, kind)
    w = torch.int8 if int8 else torch.float32
    f = torch.float32
    if kind == "mlstm":
        out = {("norm", "scale"): ((d,), f), ("norm", "bias"): ((d,), f),
               ("up", "w"): ((d, 2 * di), w),
               ("conv_w",): ((cfg.d_conv, di), f),
               ("wq",): ((nh, dh, dh), f), ("wk",): ((nh, dh, dh), f),
               ("wi",): ((nh, dh), f), ("wf",): ((nh, dh), f),
               ("bi",): ((nh,), f), ("bf",): ((nh,), f),
               ("gn_scale",): ((di,), f), ("down", "w"): ((di, d), w)}
        if int8:
            out.update({("up", "w_scale"): ((2 * di,), f),
                        ("down", "w_scale"): ((d,), f)})
        return out
    out = {("norm", "scale"): ((d,), f), ("norm", "bias"): ((d,), f),
           ("wx", "w"): ((d, 4 * d), w), ("r",): ((4, nh, dh, dh), f),
           ("b",): ((4 * d,), f), ("gn_scale",): ((d,), f),
           ("out", "w"): ((d, d), w)}
    if int8:
        out.update({("wx", "w_scale"): ((4 * d,), f),
                    ("out", "w_scale"): ((d,), f)})
    return out


def _xlstm_state_shapes(cfg, kind, slots):
    """Each state tensor's shape and dtype for ``slots`` slots."""
    d, nh, dh, di = _xlstm_dims(cfg, kind)
    f = torch.float32
    if kind == "slstm":
        return {k: ((slots, nh, dh), f) for k in XLSTM_PARTS["slstm"]}
    out = {"C": ((slots, nh, dh, dh),
                 state_quant.storage_dtype(cfg.state_dtype)),
           "n": ((slots, nh, dh), f), "m": ((slots, nh), f),
           "conv": ((slots, cfg.d_conv - 1, di), f)}
    if state_quant.is_quantized(cfg.state_dtype):
        out["C_scale"] = ((slots, nh, dh), f)
    return out


class XlstmRun:
    """One run of same-kind xLSTM layers as K3 reads them: the blocks'
    weights in a ``(layers, 16)`` device table of pointers, built once per
    engine (``registry.stack_params``) over the same tensors.  Checks
    every weight (shape, dtype, contiguity, one device, f32 or int8
    throughout) and refuses what K3 does not take: a norm other than
    LayerNorm with a bias, dense biases, a head wider than 512, a head or
    d_model no multiple of 4, a d_model above 4096, or more than 32
    layers."""

    def __init__(self, cfg, kind, rows):
        _lib.require(cfg.family == "xlstm",
                     f"K3's xLSTM instance runs the xlstm family, not "
                     f"{cfg.family!r}")
        _lib.require(kind in XLSTM_COLUMNS, f"unknown xLSTM kind {kind!r}")
        _lib.require(cfg.norm == "ln",
                     f"K3's xLSTM instance takes LayerNorm ('ln'), not "
                     f"{cfg.norm!r}")
        _lib.require(0 < len(rows) <= MAX_XLSTM_RUN,
                     f"a run of {len(rows)} layers (1 to {MAX_XLSTM_RUN})")
        _, nh, dh, di = _xlstm_dims(cfg, kind)
        _lib.require(nh * dh == di and dh <= MAX_XLSTM_HEAD
                     and dh % 4 == 0 and cfg.d_model % 4 == 0,
                     f"K3 takes heads of at most {MAX_XLSTM_HEAD} and "
                     f"widths that are multiples of 4 (its tiles load 4 "
                     f"columns a thread): {di} over {nh} heads, d_model "
                     f"{cfg.d_model}")
        _lib.require(cfg.d_model <= MAX_XLSTM_MODEL,
                     f"K3's xLSTM instances take d_model up to "
                     f"{MAX_XLSTM_MODEL}, not {cfg.d_model}")
        dense = ("up", "down") if kind == "mlstm" else ("wx", "out")
        self.kind = kind
        self.int8 = "w_scale" in _leaf(rows[0], (dense[0],), False)
        self.dims = (cfg.d_model, nh, cfg.d_conv)
        self.device, self.table = _table(
            rows, XLSTM_COLUMNS[kind], _xlstm_shapes(cfg, kind, self.int8),
            [(name,) for name in dense], _XLSTM_TABLE_WIDTH,
            lambda row, path: _leaf(row, path, False))
        self.rows = [_copy_dicts(row) for row in rows]


def xlstm_scratch_floats(kind, slots, d_model, n_heads) -> int:
    """f32 scratch of one launch (csrc ``scratch_floats``): mLSTM u, the
    conv output and g, the C' items' partial sums of C'^T q (one per tile
    of 16 rows) and their sums over groups of 8 tiles, the down items'
    partial sums (up to 32 row ranges), the same two sums of n'.q, and the
    arrival counters (a group of tiles, a 64-column tile of down).  The
    sLSTM needs none: its items keep the gates in shared memory and read
    h' back from the new state."""
    if kind == "slstm":
        return 0
    di = 2 * d_model
    ntile = -(-(di // n_heads) // _XLSTM_ROWS)
    ngroup = -(-ntile // _XLSTM_GROUP)
    return (slots * di * (3 + ntile + ngroup)
            + _XLSTM_MAX_SPLIT * slots * d_model
            + slots * n_heads * (ntile + ngroup) + n_heads * ngroup
            + d_model)


def xlstm_stacked_run(cfg, x0, run: XlstmRun, states, outs):
    """One decode token through a run of same-kind xLSTM layers.

    x0 (slots, 1, d_model) in the compute dtype; ``states`` one dict per
    layer of the run, each contiguous (a layer's cache leaves): mLSTM
    {"C" (slots, nh, dh, dh) in cfg.state_dtype's storage, "n" (slots,
    nh, dh), "m" (slots, nh), "conv" (slots, d_conv-1, 2 d_model) f32}
    + "C_scale" (slots, nh, dh) for an int8/fp8 C; sLSTM {"c", "n", "h",
    "m"} (slots, nh, dh) f32.  ``outs`` dicts of the same tensors' shapes
    that the new states are written into.  Returns the new residual
    stream x (slots, 1, d_model)."""
    global mlstm_launches, mlstm_launches_int8w, mlstm_launches_q
    global mlstm_launches_q_int8w, slstm_launches, slstm_launches_int8w
    _lib.check_dtype(x0)
    kind = run.kind
    _lib.require((cfg.d_model, cfg.n_heads, cfg.d_conv) == run.dims,
                 "cfg does not describe the run's weights")
    _lib.require(len(states) == len(outs) == len(run.rows),
                 f"{len(states)} states and {len(outs)} outputs for a run "
                 f"of {len(run.rows)}")
    slots = x0.shape[0]
    d, nh, dh, _ = _xlstm_dims(cfg, kind)
    shapes = _xlstm_state_shapes(cfg, kind, slots)
    _lib.check_same_device(x0.device, run=run.rows[0]["norm"]["scale"])
    _lib.check_dense("x0", x0, x0.dtype, (slots, 1, d))
    for i, (st, out) in enumerate(zip(states, outs)):
        for part in (st, out):
            _lib.require(set(part) == set(shapes),
                         f"layer {i} of the run: state {sorted(part)}, "
                         f"expected {sorted(shapes)}")
            for key, (shape, dtype) in shapes.items():
                _lib.check_same_device(x0.device, **{key: part[key]})
                _lib.check_dense(key, part[key], dtype, shape)
    _lib.check_impls(cfg.exp_impl, cfg.silu_impl)
    if x0.device.type == "cpu":
        x, new = ref.xlstm_stacked_run(cfg, x0, kind, run.rows, states)
        for ns, out in zip(new, outs):
            for key in shapes:
                out[key].copy_(ns[key])
        return x
    x = torch.empty_like(x0)
    scratch = torch.empty(xlstm_scratch_floats(kind, slots, d, nh),
                          dtype=torch.float32, device=x0.device)
    ptrs = (ctypes.c_int64 * (2 * _XLSTM_NPARTS * MAX_XLSTM_RUN))()
    for c, part in enumerate(XLSTM_PARTS[kind]):
        for i, (st, out) in enumerate(zip(states, outs)):
            ptrs[c * MAX_XLSTM_RUN + i] = _lib.ptr(st.get(part)) or 0
            ptrs[(c + _XLSTM_NPARTS) * MAX_XLSTM_RUN + i] = (
                _lib.ptr(out.get(part)) or 0)
    quant = kind == "mlstm" and state_quant.is_quantized(cfg.state_dtype)
    c_dtype = shapes["C"][1] if kind == "mlstm" else torch.float32
    _lib.call("marca_xlstm_stacked_run", x0.device,
              _lib.ptr(run.table), _lib.ptr(x0), _lib.ptr(x),
              ctypes.cast(ptrs, ctypes.c_void_p), _lib.ptr(scratch),
              scratch.numel(), int(kind == "slstm"), len(run.rows), slots,
              d, nh, cfg.d_conv, _lib.DTYPES[x0.dtype], int(run.int8),
              _lib.STATE_DTYPES[c_dtype], _lib.SILU_IMPLS[cfg.silu_impl],
              float(dh ** -0.5))
    if kind == "slstm":
        if run.int8:
            slstm_launches_int8w += 1
        else:
            slstm_launches += 1
    elif quant and run.int8:
        mlstm_launches_q_int8w += 1
    elif quant:
        mlstm_launches_q += 1
    elif run.int8:
        mlstm_launches_int8w += 1
    else:
        mlstm_launches += 1
    return x


def xlstm_launch_config(cfg, kind, dtype, int8: bool,
                        device="cuda") -> dict:
    """The grid K3's xLSTM instance takes on ``device``: blocks per SM,
    blocks, dynamic shared memory bytes and threads per block."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = _lib.lib().marca_xlstm_stacked_grid(
            int(kind == "slstm"), cfg.d_model, _lib.DTYPES[dtype], int(int8),
            ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"marca_xlstm_stacked_grid: CUDA error {rc}")
    return {"blocks_per_sm": out[0], "grid": out[1], "smem_bytes": out[2],
            "threads": out[3]}
