"""The port's training loop on the CPU: ``make_train_step`` against
``repro``'s, the ``Trainer``'s identities as tests/test_train_integration.py
holds ``repro``'s, and the training CLI in process.

  1. three steps of ``make_train_step`` from bridged weights on the same
     ``SyntheticLM`` batches as ``repro``'s jitted step: the loss and the
     grad norm of each step within 1e-4 relative (mamba, in two
     microbatches; the transformer's loss and gradients are held in
     tests/test_torch_train_families.py);
  2. the loss falls for mamba and the transformer; a resumed run repeats
     the uninterrupted one's losses bit for bit; crash recovery; a torn or
     missing checkpoint falls back to an older intact one, then to fresh
     init; grad_accum=2 equals the full batch; compression and int8
     moments train; SIGUSR1 flushes a checkpoint and stops;
  3. after one step every f32 leaf has a nonzero ``.grad``;
  4. ``launch.train.main`` trains and resumes, asks for the card unless
     told otherwise, and refuses a mesh.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import make_train_iterator as jmake_train_iterator
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro.runtime import train_loop as jtrain
from repro_torch import bridge, configs
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.train_loop import (TrainConfig, Trainer,
                                            make_train_step)

jax.config.update("jax_platform_name", "cpu")


def _tiny(mod, name="mamba-130m", **kw):
    """tests/test_train_integration.py's tiny config of ``name``, from the
    configs module ``mod`` (repro's or the port's)."""
    cfg = mod.smoke_variant(mod.get_config(name))
    return dataclasses.replace(cfg, vocab=64, n_layers=2, d_model=32,
                               dt_rank=4, **kw)


def _tcfg(tmp, **kw):
    base = dict(total_steps=60, warmup_steps=5, global_batch=8, seq_len=32,
                ckpt_every=20, ckpt_dir=str(tmp), log_every=1000,
                optimizer=AdamWConfig(lr=3e-3, weight_decay=0.01),
                device="cpu")
    base.update(kw)
    return TrainConfig(**base)


# ---------------------------------------------------------------------------
# 1. The step against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,accum", [("mamba-130m", 2)])
def test_train_steps_match_repro(name, accum):
    opt = dict(lr=3e-3, weight_decay=0.01)
    kw = dict(total_steps=10, warmup_steps=2, global_batch=4, seq_len=16,
              grad_accum=accum)
    jcfg, tcfg = _tiny(jconfigs, name), _tiny(configs, name)
    jt = jtrain.TrainConfig(optimizer=joptim.AdamWConfig(**opt), **kw)
    tt = TrainConfig(optimizer=AdamWConfig(**opt), device="cpu", **kw)
    jp = sharding.tree_values(jregistry.init_params(jcfg, jax.random.key(0)))
    tp = registry.tree_map(lambda t: t.clone().requires_grad_(),
                           bridge.params_from_repro(
                               jax.tree.map(np.asarray, jp)))
    js, ts = joptim.adamw_init(jp, jt.optimizer), adamw_init(tp, tt.optimizer)
    je = jax.tree.map(lambda _: jnp.zeros((), jnp.float32), jp)
    te = registry.tree_map(lambda _: torch.zeros(()), tp)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jt))
    tstep = make_train_step(tcfg, tt)
    it = jmake_train_iterator(jcfg, 4, 16, prefetch=0)
    for _ in range(3):
        b = next(it)
        jp, js, je, jm = jstep(jp, js, je,
                               {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, te, tm = tstep(tp, ts, te,
                               {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            got, want = float(tm[k]), float(jm[k])
            assert abs(got - want) <= 1e-4 * abs(want), (k, got, want)


# ---------------------------------------------------------------------------
# 2. The Trainer
# ---------------------------------------------------------------------------

def test_loss_decreases_mamba(tmp_path):
    _, _, losses = Trainer(_tiny(configs), _tcfg(tmp_path)).run(resume=False)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_loss_decreases_transformer(tmp_path):
    t = Trainer(_tiny(configs, "olmo-1b"), _tcfg(tmp_path))
    _, _, losses = t.run(resume=False)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_resume_bitwise_equivalent(tmp_path):
    """Train 40 straight vs 20 + resume + 20: the same losses, bit for bit
    on the CPU."""
    cfg = _tiny(configs)
    _, _, straight = Trainer(cfg, _tcfg(tmp_path / "a", total_steps=40)).run(
        resume=False)
    Trainer(cfg, _tcfg(tmp_path / "b", total_steps=40)).run(
        resume=False, max_steps=20)
    _, _, resumed = Trainer(cfg, _tcfg(tmp_path / "b", total_steps=40)).run(
        resume=True)
    np.testing.assert_array_equal(straight[20:], resumed)


def test_crash_recovery(tmp_path):
    cfg = _tiny(configs)
    with pytest.raises(RuntimeError, match="injected failure"):
        Trainer(cfg, _tcfg(tmp_path, total_steps=30)).run(
            resume=False, fail_at_step=12)
    _, _, losses = Trainer(cfg, _tcfg(tmp_path, total_steps=30)).run(
        resume=True)
    assert len(losses) == 18 and np.isfinite(losses).all()   # steps 12..29


def test_resume_with_no_checkpoint_falls_back_to_fresh(tmp_path):
    t = Trainer(_tiny(configs), _tcfg(tmp_path / "never_written",
                                      total_steps=3))
    _, _, losses = t.run(resume=True)
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("damage", ["missing_npz", "corrupt_npz"])
def test_resume_with_torn_checkpoint_falls_back_to_fresh(tmp_path, damage):
    torn = tmp_path / "step_000000000010"
    torn.mkdir(parents=True)
    (torn / "meta.json").write_text("{\"step\": 10, \"leaves\": {}}")
    if damage == "corrupt_npz":
        (torn / "arrays.npz").write_bytes(b"not a zip archive")
    _, _, losses = Trainer(_tiny(configs), _tcfg(tmp_path, total_steps=3)
                           ).run(resume=True)
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_resume_falls_back_to_older_intact_checkpoint(tmp_path):
    cfg = _tiny(configs)
    t = Trainer(cfg, _tcfg(tmp_path, total_steps=20, ckpt_every=10))
    t.run(resume=False)
    steps = t.ckpt.all_steps()
    assert len(steps) >= 2
    (tmp_path / f"step_{steps[-1]:012d}" / "arrays.npz").write_bytes(
        b"garbage")
    _, _, losses = Trainer(cfg, _tcfg(tmp_path, total_steps=25,
                                      ckpt_every=10)).run(resume=True)
    assert len(losses) == 25 - steps[-2]


def test_grad_accum_matches_full_batch(tmp_path):
    cfg = _tiny(configs)
    _, _, l1 = Trainer(cfg, _tcfg(tmp_path / "a", total_steps=3)).run(
        resume=False)
    _, _, l2 = Trainer(cfg, _tcfg(tmp_path / "b", total_steps=3,
                                  grad_accum=2)).run(resume=False)
    np.testing.assert_allclose(l1, l2, rtol=1e-3, atol=1e-3)


def test_grad_compression_trains(tmp_path):
    _, _, losses = Trainer(_tiny(configs), _tcfg(
        tmp_path, grad_compression=True)).run(resume=False)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_int8_optimizer_trains(tmp_path):
    _, _, losses = Trainer(_tiny(configs), _tcfg(
        tmp_path, optimizer=AdamWConfig(lr=3e-3, weight_decay=0.01,
                                        moment_dtype="int8"))).run(
        resume=False)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


class _SignalAt:
    """A metrics logger that sends this process SIGUSR1 at one step."""

    def __init__(self, step):
        self.step = step

    def log(self, **kv):
        if kv["step"] == self.step:
            os.kill(os.getpid(), signal.SIGUSR1)


def test_preemption_flushes_a_checkpoint_and_stops(tmp_path):
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        t = Trainer(_tiny(configs), _tcfg(tmp_path, total_steps=10,
                                          log_every=1, ckpt_every=0))
        t.metrics = _SignalAt(3)
        _, _, losses = t.run(resume=False)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert len(losses) == 4 and t.ckpt.all_steps() == [4]


def test_no_checkpoint_with_ckpt_every_zero(tmp_path):
    t = Trainer(_tiny(configs), _tcfg(tmp_path, total_steps=3, ckpt_every=0))
    t.run(resume=False)
    assert t.ckpt.all_steps() == [] and len(t.step_times) == 3


# ---------------------------------------------------------------------------
# 3. No parameter without a gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba-130m", "olmo-1b"])
def test_every_leaf_gets_a_nonzero_grad(tmp_path, name):
    t = Trainer(_tiny(configs, name), _tcfg(tmp_path, total_steps=1,
                                            ckpt_every=0))
    params, _, _ = t.run(resume=False)
    leaves = registry.tree_leaves(params)
    assert leaves and all(p.dtype == torch.float32 and p.requires_grad
                          for p in leaves)
    for p in leaves:
        assert p.grad is not None and bool(p.grad.abs().sum() > 0)


def test_trainer_refuses_a_mesh_and_int8_weights(tmp_path):
    with pytest.raises(NotImplementedError, match="A13"):
        Trainer(_tiny(configs), _tcfg(tmp_path), mesh=object())
    with pytest.raises(ValueError, match="f32 weights"):
        Trainer(_tiny(configs, weight_dtype="int8"), _tcfg(tmp_path))


# ---------------------------------------------------------------------------
# 4. The CLI, in process
# ---------------------------------------------------------------------------

def _cli_arch(monkeypatch):
    """A tiny mamba the CLI resolves under an arch id of its own, so the
    CLI, which takes only registered archs, runs at test size.  The
    lookup is patched for this test only: the registry stays the zoo's
    (other tests hold it to repro's)."""
    cfg = dataclasses.replace(_tiny(configs), name="mamba-cli-test",
                              dtype="float32")
    lookup = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda name: (
        cfg if name == cfg.name else lookup(name)))
    return cfg.name


def test_train_cli_trains_and_resumes(tmp_path, capsys, monkeypatch):
    arch = _cli_arch(monkeypatch)
    common = ["--arch", arch, "--device", "cpu", "--seq", "16",
              "--global-batch", "2", "--ckpt-every", "2", "--ckpt-dir",
              str(tmp_path), "--log-every", "100"]
    losses = train_cli.main(common + ["--steps", "4", "--no-resume"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert f"[launch.train] {arch}" in capsys.readouterr().out
    losses = train_cli.main(common + ["--steps", "6", "--grad-accum", "2"])
    assert len(losses) == 2
    assert "resumed from step 4" in capsys.readouterr().out


def test_train_cli_asks_for_the_card_and_refuses_a_mesh(tmp_path,
                                                         monkeypatch):
    arch = _cli_arch(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", arch, "--steps", "1", "--ckpt-dir",
                        str(tmp_path)])
    with pytest.raises(NotImplementedError, match="A13"):
        train_cli.main(["--arch", arch, "--device", "cpu", "--mesh",
                        "local", "--ckpt-dir", str(tmp_path)])
