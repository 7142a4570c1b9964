"""Training loop of the port (``repro/runtime/train_loop.py``): an eager
step with gradient accumulation and optional int8 error-feedback
gradient compression, auto-resume that falls back through older intact
checkpoints, async checkpointing, preemption handling, straggler
detection.

Params are the port's nested dict trees with every leaf an f32 tensor
that requires grad (the master weights; ``cfg.dtype`` is the compute
dtype the layers cast to).  A step runs ``registry.loss_fn`` forward,
``backward()`` into each leaf's ``.grad`` and ``optim.adamw_update`` in
place; there is no ``jit``.  The scan, the conv and attention run their
kernels under autograd Functions (``kernels.ops``).  A mesh (FSDP x TP
under pjit in ``repro``) waits for the port of the parallel layer
(ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
import signal
import time
import zipfile
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import make_train_iterator
from repro_torch.models import registry
from repro_torch.models.registry import tree_leaves, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compression, cosine_schedule)
from repro_torch.runtime.metrics import MetricsLogger, StragglerDetector


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    warmup_steps: int = 10
    global_batch: int = 8
    seq_len: int = 64
    #: a checkpoint every this many steps and at the end; 0 writes none
    #: but the preemption flush (a run timed at a size whose state takes
    #: minutes to write)
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0
    grad_accum: int = 1
    grad_compression: bool = False     # int8 EF on the gradient
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    device: str = "cuda"               # "cpu" runs the plain versions


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns step(params, opt_state, ef_err, batch) -> (params,
    opt_state, ef_err, metrics), params updated in place.

    Gradient accumulation: the batch's leading dim is grad_accum *
    microbatch; each microbatch's backward accumulates into the leaves'
    f32 ``.grad``, divided by grad_accum before the update.  The metrics
    are the mean over microbatches: each is a mean over its rows, so with
    equal microbatches that is the full batch's statistic (``repro``
    train_loop.py:75-80).  A leaf the loss does not reach gets a zero
    gradient, as under ``jax.grad``."""
    ocfg = tcfg.optimizer
    k = tcfg.grad_accum

    def step(params, opt_state, ef_err, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        rows = next(iter(batch.values())).shape[0] // k
        ms = []
        for i in range(k):
            mb = ({key: v[i * rows:(i + 1) * rows] for key, v in batch.items()}
                  if k > 1 else batch)
            loss, m = registry.loss_fn(cfg, params, mb)
            loss.backward()
            ms.append({key: v.detach().float() for key, v in m.items()})
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif k > 1:
                p.grad.div_(k)
        metrics = (ms[0] if k == 1 else
                   {key: torch.stack([m[key] for m in ms]).mean(0)
                    for key in ms[0]})
        grads = tree_map(lambda p: p.grad, params)
        if tcfg.grad_compression:
            grads, ef_err = compression.ef_apply(grads, ef_err)
        lr_scale = cosine_schedule(opt_state.step, tcfg.warmup_steps,
                                   tcfg.total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params, ocfg,
                                             lr_scale)
        metrics.update(om)
        return params, opt_state, ef_err, metrics

    return step


class Trainer:
    """Orchestrates the fault-tolerant loop on ``tcfg.device``."""

    def __init__(self, cfg, tcfg: TrainConfig, mesh=None, rules=None):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "a sharded Trainer (mesh, rules) is not ported to "
                "repro_torch yet (ROADMAP A13)")
        if cfg.weight_dtype != "f32":
            raise ValueError(f"training takes f32 weights, not "
                             f"{cfg.weight_dtype!r}")
        if tcfg.global_batch % tcfg.grad_accum:
            raise ValueError(f"global batch {tcfg.global_batch} in "
                             f"{tcfg.grad_accum} microbatches")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(tcfg.device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        self.metrics = MetricsLogger()
        self.straggler = StragglerDetector()
        #: wall seconds of each step of the last ``run``, the loss read
        #: back (a sync) included
        self.step_times: list[float] = []
        self._preempted = False

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGUSR1, handler)
        except ValueError:
            pass                                   # non-main thread (tests)

    # ------------------------------------------------------------------

    def init_state(self):
        """Fresh (params, opt_state, ef_err): the weights drawn from
        ``tcfg.seed`` by a generator on the training device, every leaf
        requiring grad."""
        params = tree_map(lambda t: t.requires_grad_(), registry.init_params(
            self.cfg, seed=self.tcfg.seed, device=self.device,
            draw_device=self.device))
        opt_state = adamw_init(params, self.tcfg.optimizer)
        ef_err = (compression.ef_init(params)
                  if self.tcfg.grad_compression else
                  tree_map(lambda p: torch.zeros((), device=p.device),
                           params))
        return params, opt_state, ef_err

    def _resume(self, state):
        """(state, start step): the newest readable checkpoint, falling
        back through older intact ones, else ``state`` from step 0.  A
        crash or disk fault can leave the latest directory torn (a
        missing or truncated arrays.npz, a meta.json without the needed
        leaves); one bad directory must not wedge every restart."""
        for step in reversed(self.ckpt.all_steps()):
            try:
                state, start = self.ckpt.restore(state, step=step)
                print(f"[trainer] resumed from step {start}")
                return state, start
            except (OSError, EOFError, KeyError, ValueError,
                    zipfile.BadZipFile) as e:
                print(f"[trainer] checkpoint step {step} in "
                      f"{self.tcfg.ckpt_dir} is unreadable "
                      f"({type(e).__name__}: {e}); trying older")
        if self.ckpt.all_steps():
            print("[trainer] no readable checkpoint; starting from fresh "
                  "init")
        return state, 0

    def run(self, resume: bool = True, max_steps: Optional[int] = None,
            fail_at_step: Optional[int] = None):
        """Train until total_steps (or max_steps), resuming from the latest
        checkpoint.  ``fail_at_step`` injects a crash (fault-tolerance
        tests).  Returns (params, opt_state, losses)."""
        self._install_preemption_handler()
        tcfg = self.tcfg
        state = self.init_state()
        start_step = 0
        if resume:
            state, start_step = self._resume(state)
        params, opt_state, ef_err = state
        step_fn = make_train_step(self.cfg, tcfg)
        it = make_train_iterator(self.cfg, tcfg.global_batch, tcfg.seq_len,
                                 start_step=start_step, seed=tcfg.seed)
        end = min(tcfg.total_steps, max_steps or tcfg.total_steps)
        losses = []
        self.step_times = []
        for step in range(start_step, end):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in next(it).items()}
            t0 = time.perf_counter()
            params, opt_state, ef_err, m = step_fn(params, opt_state,
                                                   ef_err, batch)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
            self.straggler.record(step, dt)
            self.step_times.append(dt)
            losses.append(loss)
            if step % tcfg.log_every == 0 or step == end - 1:
                self.metrics.log(step=step, loss=loss,
                                 grad_norm=float(m["grad_norm"]),
                                 step_time=dt)
            next_step = step + 1
            state = (params, opt_state, ef_err)
            if fail_at_step is not None and next_step == fail_at_step:
                self.ckpt.save(next_step, state, blocking=True)
                raise RuntimeError(f"injected failure at step {next_step}")
            if self._preempted or (tcfg.ckpt_every and (
                    next_step % tcfg.ckpt_every == 0 or next_step == end)):
                self.ckpt.save(next_step, state, blocking=self._preempted)
            if self._preempted:
                print(f"[trainer] preempted at step {next_step}; "
                      "checkpoint flushed")
                break
        self.ckpt.wait()
        return params, opt_state, losses
