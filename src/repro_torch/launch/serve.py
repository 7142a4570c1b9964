"""Serving launcher CLI: fresh weights from a seed, batched generation
over a synthetic request stream (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba-130m \
      --requests 8 --max-new 32                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba-130m \
      --smoke --device cpu                      # plain versions, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba-130m \
      --smoke --device cpu --state-dtype int8   # int8 pooled state
"""
import argparse
import dataclasses
import time

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import registry
from repro_torch.runtime.serve import ServeConfig, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--state-dtype", default=None,
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="pooled decode-state storage dtype")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.smoke_variant(cfg)
        cfg = dataclasses.replace(cfg, vocab=256, dtype="float32")
    params = registry.init_params(cfg, seed=0)
    srv = Server(cfg, params, ServeConfig(
        batch_slots=args.batch_slots,
        max_seq=args.prompt_len + args.max_new + 8,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        state_dtype=args.state_dtype, device=args.device))

    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.prompt_len, seed=1)
    done = 0
    t0 = time.perf_counter()
    batch_idx = 0
    while done < args.requests:
        n = min(args.batch_slots, args.requests - done)
        prompts = ds.batch_at(batch_idx, 0, 1, n)["tokens"]
        out = srv.generate(prompts, max_new=args.max_new)
        done += n
        batch_idx += 1
        print(f"[serve] batch {batch_idx}: {n} requests -> "
              f"{out.shape[1]} tokens each")
    dt = time.perf_counter() - t0
    total = done * args.max_new
    print(f"[serve] {done} requests, {total} tokens, {dt:.2f}s "
          f"({total / dt:.1f} tok/s) on {srv.engine.device}")


if __name__ == "__main__":
    main()
