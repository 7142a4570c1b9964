#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves on the card.

Serves a few greedy requests with ``repro_torch`` (``--arch`` at full
width, mamba-130m by default, bf16, random weights from a seed, the
kernel path) once without and once under ``torch.profiler``, then prints
the untraced and traced throughput (their difference is the tracer's
cost), the device busy and idle shares of the traced run, and the
kernels that took the most device time.  Run from the repository root
on a machine with a CUDA card:

    python3 scripts/torch_serve_profile.py [--arch mamba-130m]
        [--requests 4 --prompt-len 127 --max-new 32 --slots 4 --seed 0]
        [--trace build/serve_trace.json]
        [--weight-dtype f32|int8 --state-dtype f32|bf16|int8|fp8]
        [--kv-cache-dtype model|int8] [--step-impl auto|megakernel|fused]

``--step-impl`` picks the decode path: "megakernel" is one launch of the
cross-layer kernel per token (for jamba one per pure-SSM run of a
group), "fused" the per-layer conv and step kernels, "auto" (the
default) what an engine on the card takes, the megakernel (for xLSTM one
launch per run of same-kind layers, six a token at xlstm-350m).
jamba-v0.1-52b (32 layers, 52 B parameters) does not fit one card, so it
is cut to one group of 8 layers, whose weights (53 GB in f32) are drawn
on the card from a CUDA generator; prefill attention runs the flash
kernel.  A transformer (``--arch qwen2-7b``: 28 layers, 30.5 GB in f32)
runs at full width and depth, its weights drawn on the card too; its
decode step is per layer under "auto" and "fused", and it refuses
"megakernel" (the family has no cross-layer kernel).  xlstm-350m runs
at full width and full depth (24 layers), its prefill recurrence a
per-token loop of plain tensor code.
"""
import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def serve(eng, prompts, max_new):
    """Submit every prompt, run the engine to the end; (tokens, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    return sum(len(r.tokens) for r in reqs), time.perf_counter() - t0


def device_self_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba-130m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=127)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled run here")
    ap.add_argument("--weight-dtype", default="f32", choices=["f32", "int8"])
    ap.add_argument("--state-dtype", default="f32",
                    choices=["f32", "bf16", "int8", "fp8"])
    ap.add_argument("--step-impl", default="auto",
                    choices=["auto", "megakernel", "fused"])
    ap.add_argument("--kv-cache-dtype", default="model",
                    choices=["model", "int8"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.runtime.engine import Engine, EngineConfig

    cfg = dataclasses.replace(configs.get_config(args.arch),
                              scan_impl="pallas", conv_impl="pallas",
                              attn_impl="pallas", step_impl=args.step_impl)
    jamba = cfg.family == "jamba"
    layers = 8 if jamba else cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    on_card = jamba or cfg.family == "transformer"
    params = registry.init_params(cfg, seed=args.seed, device="cuda",
                                  draw_device="cuda" if on_card else "cpu")
    engine = Engine(cfg, params,
                    EngineConfig(n_slots=args.slots,
                                 max_seq=args.prompt_len + args.max_new + 8,
                                 weight_dtype=args.weight_dtype,
                                 state_dtype=args.state_dtype,
                                 kv_cache_dtype=args.kv_cache_dtype,
                                 device="cuda"))
    prompts = SyntheticLM(cfg.vocab, args.prompt_len, seed=args.seed + 1) \
        .batch_at(0, 0, 1, args.requests)["tokens"]
    serve(engine, prompts[:1], 4)                       # library set-up
    n_plain, t_plain = serve(engine, prompts, args.max_new)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n_traced, t_traced = serve(engine, prompts, args.max_new)
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_self_us(e) for e in kernels)
    wall_us = t_traced * 1e6
    print(f"card: {card()}")
    print(f"{cfg.name} ({layers} layers) bf16, {args.weight_dtype} weights, "
          f"{args.state_dtype} state, {args.kv_cache_dtype} kv, step_impl "
          f"{args.step_impl}, "
          f"{args.requests} requests x prompt "
          f"{args.prompt_len} + {args.max_new} new, {args.slots} slots")
    print(f"untraced: {n_plain} tokens in {t_plain:.4f} s = "
          f"{n_plain / t_plain:.1f} tok/s")
    print(f"traced:   {n_traced} tokens in {t_traced:.4f} s = "
          f"{n_traced / t_traced:.1f} tok/s")
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall: busy share {busy_us / wall_us:.4f}, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    print(f"{'device ms':>10} {'share':>7} {'calls':>7}  kernel")
    for e in sorted(kernels, key=device_self_us, reverse=True)[:args.top]:
        us = device_self_us(e)
        print(f"{us / 1e3:10.3f} {us / busy_us:7.4f} {e.count:7d}  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
