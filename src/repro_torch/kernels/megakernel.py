"""Cross-layer decode megakernel (K3): wrapper over the CUDA kernel
``csrc/megakernel_mamba.cu``.

Port of ``repro/kernels/decode_step.py:413`` ``stacked_layer_launch``
(pallas_call at :488) with two of its bodies:

* the mamba instance (``repro/models/mamba_lm.py:160``): one launch per
  decoded token runs every layer (norm -> ``mamba.mamba_block_megastep``
  -> residual) for the whole slot pool (``mamba_stacked_step``);
* the jamba instance (``repro/models/jamba.py:305``): one launch per run
  of pure-SSM positions of a group adds norm2 -> swiglu MLP -> residual
  after each position's mamba block (``jamba_stacked_run``).

On a CUDA tensor the kernel runs; on a CPU tensor its plain version
(``kernels.ref.mamba_stacked_step``, ``kernels.ref.jamba_stacked_run``)
does.

``repro`` stacks each layer parameter on a leading L axis; the port keeps
a list of per-layer dicts.  ``MambaStack`` gives K3 its view of them
without a copy: a table of the layers' device pointers, built once per
engine (``registry.stack_params``), which also holds a reference to every
tensor it points at.  The mamba state is stacked as in the decode cache:
h (L, slots, d_inner, 16), h_scale (L, slots, g), conv (L, slots, k-1,
d_inner).  ``JambaRun`` is the same view of one run of jamba positions;
their states live in different cache leaves, so each launch hands the
kernel one pointer per position and state tensor, and no cache is
stacked or copied.
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

#: what a block of 512 threads stages in shared memory: 4 slots of the
#: widest vector, the tile reduction (4 columns a thread in the jamba
#: instance, one in the mamba instance) and the norm partials (f32);
#: Hopper gives one block at most 227 KB
_SMEM_LIMIT = 232448
_CHUNK = 32     # channels of one phase-C item


def smem_bytes(d_model: int, d_inner: int, mlp: bool) -> int:
    return 4 * (4 * max(d_model, d_inner) + 16 * 4 * 32 * (4 if mlp else 1)
                + 16 * 4)


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
    need = smem_bytes(cfg.d_model, cfg.d_inner, cfg.family == "jamba")
    _lib.require(need <= _SMEM_LIMIT,
                 f"K3 stages 4 slots of d_inner {cfg.d_inner} in shared "
                 f"memory: {need} bytes > {_SMEM_LIMIT}")


def _pointer_table(cfg, rows, int8, mlp):
    """Check every weight of ``rows`` that K3 reads (shape, dtype,
    contiguity, one device, no dense bias) and return (device, the
    ``(len(rows), 24)`` int64 table of their device pointers on a card,
    else None).  ``mlp``: the rows are jamba positions."""
    shapes = _shapes(cfg, int8, mlp)
    columns = TABLE_COLUMNS + (MLP_COLUMNS if mlp else ())
    names = JAMBA_NAMES if mlp else None
    denses = [("mixer", d) for d in ("in_proj", "x_proj", "dt_proj",
                                     "out_proj")]
    if mlp:
        denses += [("mlp", d) for d in ("w1", "w3", "w2")]
    table = []
    for row in rows:
        for path in denses:
            extra = set(_leaf(row, path, int8, names)) - {"w", "w_scale"}
            _lib.require(not extra,
                         f"K3 takes no dense bias ({path[-1]}: {extra})")
        tensors = []
        for path in columns:
            if path not in shapes:
                tensors.append(None)
                continue
            t = _leaf(row, path, int8, names)
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
            + [0] * (_TABLE_WIDTH - len(tensors)) for tensors in table]
    return device, torch.tensor(ptrs, dtype=torch.int64, device=device)


class MambaStack:
    """The per-layer weights of a Mamba stack as K3 reads them.

    Built once per engine, never per token.  Checks every weight
    (shape, dtype, contiguity, one device, f32 or int8 throughout) and
    refuses what K3 does not take: a d_state other than 16, a norm other
    than rmsnorm, dense biases, and a d_inner too wide for one block's
    shared memory.  On the card it writes a ``(L, 24)`` int64 table of
    the weights' device pointers; ``layers`` keeps a copy of the layer
    dicts' structure over the same tensors, so the tensors the table
    points at live as long as the stack, whatever the caller later does
    with its own dicts.  No weight is copied."""

    def __init__(self, cfg, layers):
        _check_cfg(cfg, "mamba")
        _lib.require(len(layers) == cfg.n_layers and len(layers) > 0,
                     f"{len(layers)} layers for n_layers {cfg.n_layers}")
        self.int8 = "A_q" in layers[0]["mixer"]
        self.dims = _dims(cfg)
        self.device, self.table = _pointer_table(cfg, layers, self.int8,
                                                 mlp=False)
        self.layers = [_copy_dicts(lp) for lp in layers]


def _dims(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.d_state,
            cfg.dt_rank, cfg.d_conv)


def scratch_floats(slots: int, d_inner: int, nx: int, d_ff: int = 0) -> int:
    """f32 scratch of one launch: x_a, z, (dt_low | B | C), y, the
    chunks' absmax, the f32 state values and (jamba) the MLP hidden
    (csrc scratch_floats)."""
    nchunks = -(-d_inner // _CHUNK)
    return slots * (3 * d_inner + nx + nchunks + 16 * d_inner + d_ff)


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
    scratch = torch.empty(scratch_floats(slots, di, r + 2 * n),
                          dtype=torch.float32, device=x0.device)
    _lib.call("marca_mamba_stacked_step", x0.device,
              _lib.ptr(stack.table), _lib.ptr(x0), _lib.ptr(x), _lib.ptr(h),
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
    block with a swiglu MLP."""

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
    scratch = torch.empty(scratch_floats(slots, di, r + 2 * n, ff),
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
    bytes per block."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = _lib.lib().marca_mamba_stacked_grid(
            cfg.d_model, cfg.d_inner, _lib.DTYPES[dtype], int(int8),
            int(cfg.family == "jamba"), ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"marca_mamba_stacked_grid: CUDA error {rc}")
    return {"blocks_per_sm": out[0], "grid": out[1], "smem_bytes": out[2]}
