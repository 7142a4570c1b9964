"""The port's training substrate against ``repro``'s on the CPU: the int8
block codes, one AdamW step per moment dtype, the schedules, the error-
feedback compression, the data loader, and the checkpoint manager (the
checkpoint tests of tests/test_substrate.py, on the port).

Held here: int8 codes within one code of ``repro``'s and their scales to
f32 rounding (1e-6); three AdamW steps within 1e-6 of ``repro``'s for f32,
bf16 and int8 moments (params and f32 moments; bf16 moments to bf16
rounding; int8 moments within one code); the schedules and the EF channel
to f32 rounding; the loader's batches equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro import optim as joptim
from repro.optim import compression as jcomp
from repro.optim import quantized_state as jqs
from repro_torch import configs, data
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, clip_by_global_norm,
                               compression, cosine_schedule, linear_schedule)
from repro_torch.optim import quantized_state as qs

from _torch_inputs import np_input

jax.config.update("jax_platform_name", "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# Int8 block codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (300,), (17, 40), (4, 256)])
@pytest.mark.parametrize("power", [1.0, 2.0, 4.0])
def test_quantize_matches_repro(shape, power):
    x = np_input(sum(shape), *shape) * 3.0
    x[..., 0] = 0.0
    got = qs.quantize(torch.from_numpy(x), power=power)
    want = jqs.quantize(jnp.asarray(x), power=power)
    assert got.shape == want.shape and got.q.dtype == torch.int8
    diff = np.abs(got.q.numpy().astype(np.int32)
                  - np.asarray(want.q).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6, atol=0)
    # decode the same codes on both sides
    same = jqs.QTensor(jnp.asarray(got.q.numpy()),
                       jnp.asarray(got.scale.numpy()), shape)
    np.testing.assert_allclose(_np(qs.dequantize(got, power)),
                               _np(jqs.dequantize(same, power)),
                               rtol=1e-6, atol=1e-7)


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np_input(3, 4, 600))
    y = qs.dequantize(qs.quantize(x))
    assert y.shape == x.shape
    assert float((y - x).abs().max()) <= float(x.abs().max()) / 127 + 1e-6


# ---------------------------------------------------------------------------
# AdamW, schedules, clip, compression
# ---------------------------------------------------------------------------

def _tree(seed):
    """A param-like tree: 2-D leaves (decayed), 1-D leaves (not), a list."""
    return {"w": np_input(seed, 24, 40), "b": np_input(seed + 1, 40),
            "layers": [{"m": np_input(seed + 2 + i, 8, 300),
                        "s": np_input(seed + 5 + i, 300)} for i in range(2)]}


def _to_jax(t):
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_jax(v) for v in t]
    return jnp.asarray(t)


def _to_torch(t):
    if isinstance(t, dict):
        return {k: _to_torch(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_torch(v) for v in t]
    return torch.from_numpy(t.copy())


def _pairs(a, b, path=""):
    """(path, port leaf, repro leaf) over two trees of one structure."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, a, b


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_steps_match_repro(moment_dtype):
    cfg_kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=1.0,
                  moment_dtype=moment_dtype)
    tcfg, jcfg = AdamWConfig(**cfg_kw), joptim.AdamWConfig(**cfg_kw)
    p0 = _tree(0)
    tp = _to_torch(p0)
    jp = _to_jax(p0)
    ts, js = adamw_init(tp, tcfg), joptim.adamw_init(jp, jcfg)
    jupdate = jax.jit(joptim.adamw_update, static_argnums=(3,))
    for step in range(3):
        g = _tree(10 * (step + 1))
        scale = 0.5 if step == 1 else 3.0         # clipped and not
        g = {**g, "w": g["w"] * scale}
        tp, ts, tm = adamw_update(_to_torch(g), ts, tp, tcfg,
                                  cosine_schedule(ts.step, 1, 10))
        jp, js, jm = jupdate(_to_jax(g), js, jp, jcfg,
                             joptim.cosine_schedule(js.step, 1, 10))
        np.testing.assert_allclose(_np(tm["grad_norm"]), _np(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(tm["lr"]), _np(jm["lr"]), rtol=1e-6)
        for path, a, b in _pairs(tp, jp):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6,
                                       err_msg=path)
        assert int(ts.step) == int(js.step) == step + 1
        for path, a, b in _pairs(ts.mu, js.mu):
            if moment_dtype == "int8":
                assert np.abs(a.q.numpy().astype(int)
                              - np.asarray(b.q).astype(int)).max() <= 1
            else:
                tol = 1e-6 if moment_dtype == "float32" else 8e-3
                np.testing.assert_allclose(_np(a), _np(b), rtol=tol,
                                           atol=1e-7, err_msg=path)


def test_adamw_in_place_on_leaves_that_require_grad():
    """The update keeps each param tensor (autograd's leaves) and decays
    only leaves of two or more dimensions."""
    p = {"w": torch.ones(4, 4, requires_grad=True),
         "b": torch.ones(4, requires_grad=True)}
    ids = {k: id(v) for k, v in p.items()}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    st = adamw_init(p, cfg)
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    p2, st, _ = adamw_update(zeros, st, p, cfg)
    assert {k: id(v) for k, v in p2.items()} == ids
    assert p["w"].requires_grad and float(p["w"][0, 0].detach()) < 1.0
    assert float(p["b"][0].detach()) == 1.0


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges_quadratic(moment_dtype):
    target = torch.from_numpy(np_input(0, 8, 8))
    p = {"w": torch.zeros(8, 8, requires_grad=True)}
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, moment_dtype=moment_dtype)
    st = adamw_init(p, cfg)
    for _ in range(300):
        loss = ((p["w"] - target) ** 2).sum()
        g, = torch.autograd.grad(loss, [p["w"]])
        p, st, _ = adamw_update({"w": g}, st, p, cfg)
    assert float(((p["w"].detach() - target) ** 2).sum()) < 0.05
    if moment_dtype == "int8":
        q = st.mu["w"]
        assert qs.is_qtensor(q) and q.q.dtype == torch.int8


def test_schedules_equal_repro():
    steps = np.arange(0, 130)
    for tf, jf in ((cosine_schedule, joptim.cosine_schedule),
                   (linear_schedule, joptim.schedule.linear_schedule)):
        for warm, total in ((10, 100), (0, 50), (5, 5)):
            got = np.array([float(tf(int(s), warm, total)) for s in steps])
            want = np.array([float(jf(int(s), warm, total)) for s in steps])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_clip_global_norm():
    g = {"a": torch.full((10,), 100.0), "b": [torch.ones(3)]}
    clipped, gn = clip_by_global_norm(g, 1.0)
    total = torch.sqrt(sum((x ** 2).sum() for x in
                           (clipped["a"], clipped["b"][0])))
    assert abs(float(total) - 1.0) < 1e-5
    assert abs(float(gn) - float(np.sqrt(1e5 + 3))) < 1e-2


def test_ef_compression_matches_repro():
    err_t = torch.zeros(64)
    err_j = jnp.zeros((64,), jnp.float32)
    for step in range(5):
        g = np_input(step, 64)
        gt, err_t = compression.ef_compress_decompress(torch.from_numpy(g),
                                                       err_t)
        gj, err_j = jcomp.ef_compress_decompress(jnp.asarray(g), err_j)
        np.testing.assert_allclose(_np(gt), _np(gj), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(err_t), _np(err_j), rtol=1e-6,
                                   atol=1e-7)
    tree = _tree(3)
    got, gerr = compression.ef_apply(_to_torch(tree), compression.ef_init(
        _to_torch(tree)))
    # eager, as the step runs it: under jit XLA divides by the scale as a
    # multiply by its reciprocal, which moves the residual's last bits
    want, werr = jcomp.ef_apply(_to_jax(tree), jcomp.ef_init(_to_jax(tree)))
    for (path, a, b), (_, c, d) in zip(_pairs(got, want), _pairs(gerr, werr)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                   err_msg=path)
        np.testing.assert_allclose(_np(c), _np(d), rtol=1e-6, atol=1e-7,
                                   err_msg=path)
    with pytest.raises(NotImplementedError, match="A13"):
        compression.compressed_psum(torch.ones(2), "pod")


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,prefetch", [(0, 2), (5, 0)])
def test_train_iterator_matches_repro(start, prefetch):
    cfg = configs.smoke_variant(configs.get_config("mamba-130m"))
    jcfg = jconfigs.smoke_variant(jconfigs.get_config("mamba-130m"))
    it = data.make_train_iterator(cfg, 4, 16, start_step=start, seed=3,
                                  prefetch=prefetch)
    jit = jdata.make_train_iterator(jcfg, 4, 16, start_step=start, seed=3,
                                    prefetch=prefetch)
    for _ in range(3):
        a, b = next(it), next(jit)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_sharded_loader_shards_and_resumes():
    ds = data.SyntheticLM(vocab=32, seq_len=8, seed=1)
    jds = jdata.SyntheticLM(vocab=32, seq_len=8, seed=1)
    for shard in (0, 1):
        a = next(data.ShardedLoader(ds, 4, shard=shard, num_shards=2,
                                    start_step=3))
        b = next(jdata.ShardedLoader(jds, 4, shard=shard, num_shards=2,
                                     start_step=3))
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    l1 = data.ShardedLoader(ds, global_batch=4)
    batches = [next(l1) for _ in range(5)]
    l2 = data.ShardedLoader(ds, global_batch=4, start_step=3)
    np.testing.assert_array_equal(next(l2)["tokens"], batches[3]["tokens"])
    with pytest.raises(ValueError):
        data.ShardedLoader(ds, global_batch=5, num_shards=2)


def test_prefetch_preserves_order_and_terminates():
    assert list(data.Prefetcher(iter(range(20)), depth=3)) == list(range(20))


# ---------------------------------------------------------------------------
# Checkpoint manager (tests/test_substrate.py's, on the port)
# ---------------------------------------------------------------------------

def _ck_tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(
        2, 3), "b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
        "step": torch.tensor(5, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _ck_tree()
    mgr.save(10, tree, blocking=True)
    got, step = mgr.restore(tree)
    assert step == 10
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["b"], tree["params"]["b"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 5
    assert sorted(os.listdir(tmp_path / "step_000000000010")) == [
        "arrays.npz", "meta.json"]


def test_checkpoint_async_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _ck_tree()
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4


def test_checkpoint_async_save_snapshots_at_the_call(tmp_path):
    """An async save writes the values the tree held when ``save`` was
    called: leaves overwritten in place before the worker thread writes
    (as ``adamw_update`` overwrites the params) restore as they were, bit
    for bit."""
    import threading
    mgr = CheckpointManager(str(tmp_path))
    go = threading.Event()
    write = mgr._write

    def held(step, host):
        go.wait()
        write(step, host)

    mgr._write = held
    tree = _ck_tree()
    tree["params"]["w"].requires_grad_()

    def leaves(t):
        return [t["params"]["w"], t["params"]["b"], t["step"]]

    want = [t.detach().clone() for t in leaves(tree)]
    mgr.save(1, tree)
    with torch.no_grad():
        for t in leaves(tree):
            t.copy_(t + 1)
    go.set()
    mgr.wait()
    got, _ = mgr.restore(tree)
    for g, w in zip(leaves(got), want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_checkpoint_latest_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _ck_tree()
    mgr.save(1, tree, blocking=True)
    tree2 = {"params": {k: v + 1 for k, v in tree["params"].items()},
             "step": tree["step"] + 1}
    mgr.save(7, tree2, blocking=True)
    got, step = mgr.restore(tree)
    assert step == 7 and int(got["step"]) == 6


def test_checkpoint_no_partial_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "tmp.99")          # simulated torn write
    assert mgr.all_steps() == [] and mgr.latest_step() is None


def test_checkpoint_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in [1, 2, 3]:
        mgr.save(s, {"x": torch.ones(3) * s}, blocking=True)
    got, step = mgr.restore({"x": torch.ones(3)}, step=2)
    assert step == 2 and torch.equal(got["x"], 2 * torch.ones(3))


def test_checkpoint_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.ones(1)})


def test_checkpoint_dtype_cast_on_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(4)}, blocking=True)
    got, _ = mgr.restore({"x": torch.ones(4, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16


def test_checkpoint_optimizer_state_paths(tmp_path):
    """An AdamWState of int8 moments round-trips: the NamedTuple's fields
    and the QTensor's codes and scales get repro's path keys, and the
    restored leaves keep requires_grad as the template's."""
    import json
    p = {"layers": [{"w": torch.from_numpy(np_input(1, 4, 300))
                     .requires_grad_()}]}
    st = adamw_init(p, AdamWConfig(moment_dtype="int8"))
    st = AdamWState(st.step + 3, st.mu, {"layers": [{"w": qs.quantize(
        torch.from_numpy(np_input(2, 4, 300)), power=4.0)}]})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, (p, st), blocking=True)
    meta = json.loads((tmp_path / "step_000000000003" / "meta.json")
                      .read_text())
    assert set(meta["leaves"]) == {
        "0/layers/0/w", "1/step", "1/mu/layers/0/w/0", "1/mu/layers/0/w/1",
        "1/nu/layers/0/w/0", "1/nu/layers/0/w/1"}
    (p2, st2), _ = mgr.restore((p, adamw_init(p, AdamWConfig(
        moment_dtype="int8"))))
    assert p2["layers"][0]["w"].requires_grad
    assert torch.equal(p2["layers"][0]["w"], p["layers"][0]["w"])
    assert int(st2.step) == 3 and isinstance(st2, AdamWState)
    got, want = st2.nu["layers"][0]["w"], st.nu["layers"][0]["w"]
    assert got.shape == want.shape and torch.equal(got.q, want.q)
    assert torch.equal(got.scale, want.scale)
