"""Training's loss and gradients in the port against ``repro``'s on the
CPU, for every family: ``registry.loss_fn`` and every gradient leaf
against ``jax.value_and_grad(repro.models.registry.loss_fn)`` on the same
bridged weights (``bridge.params_from_repro``) and batch, in f32, at the
smoke variants of mamba-130m, qwen2-7b, jamba-v0.1 (MoE capacity = expert
count, as repro's tests set it, so no assignment drops; in
tests/test_torch_train_hybrids.py), xlstm-350m (there too),
musicgen-large (4 codebook heads on frame embeddings) and phi-3-vision
(an image prefix that carries no loss).

The loss within 1e-5 relative; each gradient leaf within 1e-4 of its
max-abs, that scale floored at 1e-4 of the largest gradient of the model:
a leaf whose true gradient is zero shows only each side's rounding (the
mLSTM input-gate bias, whose exp(i - m) is 1 wherever the stabiliser's
max picks i, so its gradient cancels exactly; about 1e-10 on both sides).
The scan, the conv and attention run their autograd Functions here (the
plain versions forward, the card's backward code).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels import ref
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["mamba-130m", "qwen2-7b", "musicgen-large", "phi-3-vision-4.2b"]


def _cfgs(arch):
    j = jconfigs.get_config(arch)
    kw = {"vocab": 64, "dtype": "float32"}
    if j.n_experts:
        kw["capacity_factor"] = float(j.n_experts)
    return (dataclasses.replace(jconfigs.smoke_variant(j), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(arch)), **kw))


def _batch(cfg, b, l, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_stub":
        out["embeds"] = rng.normal(size=(b, l, cfg.d_model)).astype(
            np.float32)
        out["labels"] = rng.integers(0, cfg.vocab, size=(
            b, l, cfg.n_codebooks)).astype(np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(b, l)).astype(
            np.int32)
        out["labels"] = rng.integers(0, cfg.vocab, size=(b, l)).astype(
            np.int32)
    if cfg.frontend == "vision_stub":
        out["img_embeds"] = rng.normal(
            size=(b, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return out


def _trainable(params):
    return registry.tree_map(lambda t: t.clone().requires_grad_(), params)


def check_loss_and_grads(arch):
    """The loss, the metrics and every gradient leaf of ``arch``'s smoke
    variant against repro's, as the module docstring states."""
    jcfg, tcfg = _cfgs(arch)
    w = jax.tree.map(np.asarray, sharding.tree_values(
        jregistry.init_params(jcfg, jax.random.key(1))))
    batch = _batch(jcfg, 2, 24)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jregistry.loss_fn(jcfg, p, jb), has_aux=True))(
        jax.tree.map(jnp.asarray, w))

    p = _trainable(bridge.params_from_repro(w))
    calls = dict(ref.CALLS)
    loss, metrics = registry.loss_fn(
        tcfg, p, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        got, want = float(metrics[k].detach()), float(jm[k])
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3), (k, got, want)
    # a leaf the loss does not reach (the audio stub's token embedding)
    # has no .grad; jax.grad gives it zeros, as the Trainer does
    grads = registry.tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, p)
    got_leaves = jax.tree.leaves(bridge.params_to_repro(grads))
    want_flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(got_leaves) == len(want_flat)
    floor = 1e-4 * max(float(np.abs(np.asarray(g)).max())
                       for _, g in want_flat)
    for (path, want), got in zip(want_flat, got_leaves):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), floor)
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)
    if tcfg.family in ("mamba", "jamba"):
        # the scan trained through its Function: one forward a layer, plus
        # the backward's recompute a chunk
        assert ref.CALLS["selective_scan"] > calls.get("selective_scan", 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["mamba-130m", "musicgen-large",
                                  "phi-3-vision-4.2b"])
def test_make_batch_shapes_match_repros(arch):
    jcfg, tcfg = _cfgs(arch)
    want = jregistry.make_batch(jcfg, 3, 10)
    got = registry.make_batch(tcfg, 3, 10, torch.Generator().manual_seed(4))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        if got[k].dtype == torch.int32:
            assert int(got[k].min()) >= 0 and int(got[k].max()) < tcfg.vocab
    again = registry.make_batch(tcfg, 3, 10, torch.Generator().manual_seed(4))
    assert all(torch.equal(got[k], again[k]) for k in got)
    loss, _ = registry.loss_fn(tcfg, registry.init_params(tcfg), got)
    assert torch.isfinite(loss)
