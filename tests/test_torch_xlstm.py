"""xLSTM in the port (``repro_torch.models.xlstm``, the matrix-memory
quantizers, the group norm and the plain cells) against ``repro``'s, on the
CPU.

The same weights (``repro``'s xlstm-350m-smoke: 8 layers, d 64, 4 heads,
vocab 64, f32, bridged as numpy) and the same seeded inputs go through both
packages.  Held here:

  1. ``quantize_mat`` / ``dequantize_mat`` bitwise; ``group_norm`` and the
     plain cells against ``repro``'s cell skeletons at 1e-5;
  2. the blocks' apply (L = 21, no multiple of scan_chunk 16: ``repro``'s
     padding steps) and step, the model's ``forward``, ``prefill`` and
     per-layer ``decode_step`` (each step from ``repro``'s state) at 1e-4,
     with f32, int8 and fp8 state and int8 weights; caches at 1e-4, an int8/fp8 C within one code and its
     scales to 1e-6 relative in a block, 1e-4 in the model;
  3. one decode step of the plain K3 (``ref.xlstm_stacked_run``, through
     ``step_impl="megakernel"``) against ``repro``'s ``stacked_step`` in
     interpret mode (int8 weights, int8 C), at the same tolerances.
The engines are held in tests/test_torch_xlstm_engine.py; K3's xLSTM
instances against their plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import state_quant as jsq
from repro.core import weight_quant as jwq
from repro.kernels import decode_step as dsk
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.parallel import sharding
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import state_quant, weight_quant
from repro_torch.kernels import ref
from repro_torch.models import blocks, xlstm
from repro_torch.models import registry as tregistry

from _torch_inputs import code_ordinals

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-350m"
TOL = 1e-4


def cfgs(**kw):
    kw = {"vocab": 64, "dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.smoke_variant(
                jconfigs.get_config(ARCH)), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(ARCH)), **kw))


@pytest.fixture(scope="module")
def weights():
    """repro's initialized smoke weights as numpy (f32), made once."""
    jcfg, _ = cfgs()
    return jax.tree.map(np.asarray, sharding.tree_values(
        jregistry.init_params(jcfg, jax.random.key(1))))


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def tokens(seed, b, L):
    return np.random.default_rng(seed).integers(
        0, 64, size=(b, L)).astype(np.int32)


def tensor(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


#: C_scale tolerances: 1e-6 relative where both sides step from the same
#: inputs (a block); in a model the residual stream reaching every layer
#: after the first already differs by f32 rounding, compounded over the
#: layers and the prompt, and a row's absmax scale moves with it: there
#: it is held as the logits are, to TOL
BLOCK_SCALE_RTOL, MODEL_SCALE_RTOL = 1e-6, TOL


def assert_tree_close(got, want, path="cache", scale_rtol=BLOCK_SCALE_RTOL):
    """A port cache tree against repro's (numpy leaves, same structure):
    floats at TOL, int8/fp8 payloads within one code, their scales
    (``C_scale``) to ``scale_rtol`` relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], f"{path}.{k}", scale_rtol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{path}[{i}]", scale_rtol)
        return
    w = bridge.to_torch(np.asarray(want))
    assert tuple(got.shape) == tuple(w.shape), path
    if got.dtype in (torch.int8, torch.float8_e4m3fn):
        assert w.dtype == got.dtype, path
        apart = int((code_ordinals(got) - code_ordinals(w)).abs().max())
        assert apart <= 1, f"{path}: codes {apart} apart"
    elif path.endswith("C_scale"):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=scale_rtol,
                                   atol=0, err_msg=path)
    else:
        assert got.dtype == w.dtype, (path, got.dtype, w.dtype)
        close(got, w.float(), msg=path)


# ---------------------------------------------------------------------------
# 1. Quantizers, group norm, cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sd", ["int8", "fp8"])
def test_quantize_mat_matches_repro_bitwise(sd):
    x = normal(1, 2, 4, 8, 16) * 3.0
    x[0, 1, 2] = 0.0                          # an all-zero row
    prev = np.abs(normal(2, 2, 4, 8)) * 0.05
    for p in (None, prev):
        jq, js = jsq.quantize_mat(jnp.asarray(x), sd, prev_scale=None
                                  if p is None else jnp.asarray(p))
        tq, ts = state_quant.quantize_mat(
            tensor(x), sd, prev_scale=None if p is None else tensor(p))
        assert tq.dtype == state_quant.storage_dtype(sd)
        assert torch.equal(tq.view(torch.uint8),
                           bridge.to_torch(np.asarray(jq)).view(torch.uint8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            state_quant.dequantize_mat(tq, ts).numpy(),
            np.asarray(jsq.dequantize_mat(jq, js)))


def test_group_norm_matches_repro():
    x = normal(3, 2, 5, 64) * 2.0 + 0.5
    scale = normal(4, 64)
    close(blocks.group_norm(tensor(x), tensor(scale), 4),
          jblocks.group_norm(jnp.asarray(x), jnp.asarray(scale), 4), 1e-5)


def test_mlstm_cell_matches_repro():
    b, nh, dh = 3, 4, 16
    C, n = normal(5, b, nh, dh, dh), normal(6, b, nh, dh)
    m = normal(7, b, nh)
    m[0] = -1e30                              # a fresh slot
    q, k, v = (normal(8 + i, b, nh, dh) for i in range(3))
    i, f = normal(11, b, nh) * 2.0, normal(12, b, nh) * 2.0 + 1.0
    jh, (jC, jn, jm) = dsk.mlstm_cell(dh)(
        tuple(map(jnp.asarray, (C, n, m))),
        dict(zip("qkvif", map(jnp.asarray, (q, k, v, i, f)))))
    th, (tC, tn, tm) = ref.mlstm_cell(*map(tensor, (C, n, m, q, k, v, i, f)),
                                      dh)
    for got, want in ((th, jh), (tC, jC), (tn, jn), (tm, jm)):
        close(got, want, 1e-5)


def test_slstm_cell_matches_repro():
    b, nh, dh = 3, 4, 16
    c, n = normal(13, b, nh, dh), np.abs(normal(14, b, nh, dh)) + 0.5
    m = normal(15, b, nh, dh)
    m[0] = -1e30
    g = normal(16, b, 4, nh, dh) * 2.0
    jh, (jc, jn, jm) = dsk.slstm_cell()(
        tuple(map(jnp.asarray, (c, n, m))), {"g": jnp.asarray(g)})
    th, (tc, tn, tm) = ref.slstm_cell(*map(tensor, (c, n, m, g)))
    for got, want in ((th, jh), (tc, jc), (tn, jn), (tm, jm)):
        close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# 2. Blocks and model on bridged weights
# ---------------------------------------------------------------------------

#: (weights, state) of the block and model cases
SETUPS = [("f32", "f32"), ("f32", "int8"), ("int8", "int8"), ("f32", "fp8")]


def _setup(weights, wd, sd):
    """(jcfg, tcfg, repro tree, port tree), quantized per ``wd``."""
    jcfg, tcfg = cfgs(weight_dtype=wd, state_dtype=sd)
    w = weights
    if wd == "int8":
        w = jax.tree.map(np.asarray, jwq.quantize_tree(weights))
    return jcfg, tcfg, w, bridge.params_from_repro(w)


def _state(tree):
    """A repro state or cache (JAX arrays) as the port's tensors: each
    side continues from the same state, so a code that rounded the other
    way is not carried on."""
    return bridge.cache_from_repro(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("wd,sd", SETUPS)
def test_block_apply_and_step_match_repro(weights, kind, wd, sd):
    """Apply from the init state over 21 tokens (repro pads to 32), then
    one step from repro's state: outputs at 1e-4, states as
    ``assert_tree_close`` holds them."""
    jcfg, tcfg, w, tp = _setup(weights, wd, sd)
    layer = 7 if kind == "slstm" else 0
    jp, lp = w["layers"][layer][kind], tp["layers"][layer][kind]
    x = normal(20, 2, 21, 64)
    jy, js = getattr(jxlstm, f"{kind}_block_apply")(jcfg, jp, jnp.asarray(x))
    ty, ts = getattr(xlstm, f"{kind}_block_apply")(tcfg, lp, tensor(x))
    close(ty, jy)
    assert_tree_close(ts, jax.tree.map(np.asarray, js))
    x1 = normal(22, 2, 1, 64)
    jy, js1 = getattr(jxlstm, f"{kind}_block_step")(jcfg, jp,
                                                    jnp.asarray(x1), js)
    ty, ts1 = getattr(xlstm, f"{kind}_block_step")(tcfg, lp, tensor(x1),
                                                   _state(js))
    close(ty, jy)
    assert_tree_close(ts1, jax.tree.map(np.asarray, js1))


def test_forward_matches_repro(weights):
    jcfg, tcfg, w, tp = _setup(weights, "f32", "f32")
    toks = tokens(30, 2, 21)
    jl, _ = jregistry.forward(jcfg, w, {"tokens": jnp.asarray(toks)})
    tl, _ = tregistry.forward(tcfg, tp, {"tokens": tensor(toks).long()})
    close(tl, jl)


@pytest.mark.parametrize("wd,sd", [("f32", "f32"), ("int8", "int8"),
                                   ("f32", "fp8")])
def test_model_matches_repro(weights, wd, sd):
    """prefill over 21 tokens, then two per-layer decode steps, each from
    repro's cache: logits at 1e-4 and the caches."""
    jcfg, tcfg, w, tp = _setup(weights, wd, sd)
    toks = tokens(30, 2, 21)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 32))
    jl, jc = jregistry.prefill(jcfg, w, jcache,
                               {"tokens": jnp.asarray(toks)})
    tl, tc = tregistry.prefill(tcfg, tp, tregistry.init_cache(tcfg, 2, 32),
                               {"tokens": tensor(toks).long()})
    close(tl, jl)
    assert_tree_close(tc, jax.tree.map(np.asarray, jc),
                      scale_rtol=MODEL_SCALE_RTOL)
    jf = dataclasses.replace(jcfg, step_impl="fused")
    for s in range(2):
        t = tokens(31 + s, 2, 1)
        tl, tc = tregistry.decode_step(tcfg, tp, _state(jc),
                                       {"tokens": tensor(t).long()})
        jl, jc = jregistry.decode_step(jf, w, jc, {"tokens": jnp.asarray(t)})
        close(tl, jl)
        assert_tree_close(tc, jax.tree.map(np.asarray, jc),
                          scale_rtol=MODEL_SCALE_RTOL)


def test_bridge_keeps_the_layer_list(weights):
    """xLSTM's layers are a list on both sides: the bridge maps them
    entry for entry and back."""
    tp = bridge.params_from_repro(weights)
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 8
    assert [next(iter(lp)) for lp in tp["layers"]] == ["mlstm"] * 7 + [
        "slstm"]
    back = bridge.params_to_repro(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(weights)):
        np.testing.assert_array_equal(a, b)


def test_quantize_tree_matches_repro(weights):
    """int8 weights quantize the dense up/down/wx/out and leave the
    per-head wq, wk and r f32, as repro does, code for code."""
    want = jax.tree.map(np.asarray, jwq.quantize_tree(weights))
    got = weight_quant.quantize_tree(bridge.params_from_repro(weights))
    assert "w_scale" in got["layers"][0]["mlstm"]["up"]
    assert got["layers"][0]["mlstm"]["wq"].dtype == torch.float32
    assert_tree_close(got, want, "params")


# ---------------------------------------------------------------------------
# 3. The plain K3 against repro's stacked_step (interpret mode)
# ---------------------------------------------------------------------------

def test_plain_k3_step_matches_repro_stacked_step(weights):
    """From repro's cache after a prefill of 9 tokens, one decode step
    with int8 weights and an int8 C through the plain K3 (two runs:
    mLSTM 0-6, sLSTM 7) against repro's megakernel step."""
    jcfg, tcfg, w, tp = _setup(weights, "int8", "int8")
    toks = tokens(40, 2, 9)
    jcache = sharding.tree_values(jregistry.init_cache(jcfg, 2, 16))
    _, jc = jregistry.prefill(jcfg, w, jcache, {"tokens": jnp.asarray(toks)})
    tcm = dataclasses.replace(tcfg, step_impl="megakernel")
    tc = _state(jc)
    t = tokens(41, 2, 1)
    jl, jc = jregistry.decode_step(
        dataclasses.replace(jcfg, step_impl="megakernel"), w, jc,
        {"tokens": jnp.asarray(t)})
    ref.CALLS.clear()
    tl, tc = tregistry.decode_step(tcm, tregistry.stack_params(tcm, tp), tc,
                                   {"tokens": tensor(t).long()})
    assert ref.CALLS["mlstm_stacked_run"] == ref.CALLS[
        "slstm_stacked_run"] == 1
    close(tl, jl)
    assert_tree_close(tc, jax.tree.map(np.asarray, jc),
                      scale_rtol=MODEL_SCALE_RTOL)
