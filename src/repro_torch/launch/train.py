"""Training launcher CLI (port of ``repro/launch/train.py``): the same
flags, plus ``--device`` (the card unless asked for the CPU).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba-130m \
      --steps 100                                   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba-130m \
      --device cpu --steps 4 --seq 16 --global-batch 2 --dtype float32 \
      --no-resume --ckpt-dir /tmp/ck                # plain versions, CPU

A rerun with the same ``--ckpt-dir`` resumes from its newest readable
checkpoint.  ``--mesh`` other than ``none`` waits for the port of the
parallel layer (ROADMAP A13).
"""
import argparse
import dataclasses

from repro_torch import configs
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-decay", type=float, default=0.1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi", "local"])
    ap.add_argument("--scan-impl", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported to "
            f"repro_torch yet (ROADMAP A13)")

    cfg = configs.get_config(args.arch)
    over = {}
    if args.scan_impl:
        over["scan_impl"] = args.scan_impl
    if args.dtype:
        over["dtype"] = args.dtype
    if over:
        cfg = dataclasses.replace(cfg, **over)

    tcfg = TrainConfig(
        total_steps=args.steps, warmup_steps=args.warmup,
        global_batch=args.global_batch, seq_len=args.seq,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        log_every=args.log_every, grad_accum=args.grad_accum,
        grad_compression=args.grad_compression,
        optimizer=AdamWConfig(lr=args.lr, weight_decay=args.weight_decay,
                              moment_dtype=args.moment_dtype),
        device=args.device)
    trainer = Trainer(cfg, tcfg)
    _, _, losses = trainer.run(resume=not args.no_resume)
    if losses:
        print(f"[launch.train] {args.arch}: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} ({len(losses)} steps)")
    else:
        print(f"[launch.train] {args.arch}: no step left to run")
    return losses


if __name__ == "__main__":
    main()
