"""Cross-layer Mamba decode megakernel (K3): wrapper over the CUDA kernel
``csrc/megakernel_mamba.cu``.

Port of ``repro/kernels/decode_step.py:413`` ``stacked_layer_launch``
(pallas_call at :488) with the mamba body of
``repro/models/mamba_lm.py:160``: one launch per decoded token runs every
layer (norm -> ``mamba.mamba_block_megastep`` -> residual) for the whole
slot pool.  On a CUDA tensor the kernel runs; on a CPU tensor its plain
version ``kernels.ref.mamba_stacked_step`` does.

``repro`` stacks each layer parameter on a leading L axis; the port keeps
a list of per-layer dicts.  ``MambaStack`` gives K3 its view of them
without a copy: a table of the layers' device pointers, built once per
engine (``registry.stack_params``), which also holds a reference to every
tensor it points at.  The state is stacked as in the decode cache:
h (L, slots, d_inner, 16), h_scale (L, slots, g), conv (L, slots, k-1,
d_inner).
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
_TABLE_WIDTH = 16

#: what a block of 512 threads stages in shared memory: 4 slots of the
#: widest vector, the tile reduction and the norm partials (f32); Hopper
#: gives one block at most 227 KB
_SMEM_LIMIT = 232448
_CHUNK = 32     # channels of one phase-C item


def smem_bytes(d_model: int, d_inner: int) -> int:
    return 4 * (4 * max(d_model, d_inner) + 16 * 4 * 32 + 16 * 4)


def _shapes(cfg, int8: bool) -> dict:
    """The shape and dtype of each table column for one layer."""
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
    return out


def _leaf(layer, path, int8):
    node = layer
    for key in path:
        if key == "A":
            key = "A_q" if int8 else "A_log"
        if key not in node:
            raise ValueError(f"layer has no {'.'.join(path)} for K3")
        node = node[key]
    return node


class MambaStack:
    """The per-layer weights of a Mamba stack as K3 reads them.

    Built once per engine, never per token.  Checks every weight
    (shape, dtype, contiguity, one device, f32 or int8 throughout) and
    refuses what K3 does not take: a d_state other than 16, a norm other
    than rmsnorm, dense biases, and a d_inner too wide for one block's
    shared memory.  On the card it writes a ``(L, 16)`` int64 table of
    the weights' device pointers; ``layers`` keeps a copy of the layer
    dicts' structure over the same tensors, so the tensors the table
    points at live as long as the stack, whatever the caller later does
    with its own dicts.  No weight is copied."""

    def __init__(self, cfg, layers):
        _lib.require(cfg.family == "mamba",
                     f"K3 runs the mamba family, not {cfg.family!r}")
        _lib.require(cfg.d_state == 16,
                     f"K3 takes d_state 16, got {cfg.d_state}")
        _lib.require(cfg.norm == "rmsnorm",
                     f"K3 takes rmsnorm, got norm {cfg.norm!r}")
        _lib.require(len(layers) == cfg.n_layers and len(layers) > 0,
                     f"{len(layers)} layers for n_layers {cfg.n_layers}")
        need = smem_bytes(cfg.d_model, cfg.d_inner)
        _lib.require(need <= _SMEM_LIMIT,
                     f"K3 stages 4 slots of d_inner {cfg.d_inner} in shared "
                     f"memory: {need} bytes > {_SMEM_LIMIT}")
        self.int8 = "A_q" in layers[0]["mixer"]
        self.dims = _dims(cfg)
        shapes = _shapes(cfg, self.int8)
        self.layers = []
        rows = []
        for lp in layers:
            for dense in ("in_proj", "x_proj", "dt_proj", "out_proj"):
                extra = set(lp["mixer"][dense]) - {"w", "w_scale"}
                _lib.require(not extra,
                             f"K3 takes no dense bias ({dense}: {extra})")
            row = []
            for path in TABLE_COLUMNS:
                if path not in shapes:
                    row.append(None)
                    continue
                t = _leaf(lp, path, self.int8)
                _lib.check_dense(".".join(path), t, shapes[path][1],
                                 shapes[path][0])
                row.append(t)
            rows.append(row)
            self.layers.append({"norm": dict(lp["norm"]),
                                "mixer": {k: dict(v) if isinstance(v, dict)
                                          else v
                                          for k, v in lp["mixer"].items()}})
        self.device = rows[0][0].device
        for row in rows:
            _lib.check_same_device(self.device, **{
                ".".join(p): t for p, t in zip(TABLE_COLUMNS, row)})
        self.table = None
        if self.device.type == "cuda":
            ptrs = [[_lib.ptr(t) or 0 for t in row]
                    + [0] * (_TABLE_WIDTH - len(row)) for row in rows]
            self.table = torch.tensor(ptrs, dtype=torch.int64,
                                      device=self.device)


def _dims(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.d_state,
            cfg.dt_rank, cfg.d_conv)


def scratch_floats(slots: int, d_inner: int, nx: int) -> int:
    """f32 scratch of one launch: x_a, z, (dt_low | B | C), y, the
    chunks' absmax and the f32 state values (csrc scratch_floats)."""
    nchunks = -(-d_inner // _CHUNK)
    return slots * (3 * d_inner + nx + nchunks + 16 * d_inner)


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


def launch_config(cfg, dtype, int8: bool, device="cuda") -> dict:
    """The grid K3 takes on ``device`` for this model: blocks per SM,
    blocks, dynamic shared memory bytes per block."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = _lib.lib().marca_mamba_stacked_grid(
            cfg.d_model, cfg.d_inner, _lib.DTYPES[dtype], int(int8),
            ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"marca_mamba_stacked_grid: CUDA error {rc}")
    return {"blocks_per_sm": out[0], "grid": out[1], "smem_bytes": out[2]}
