#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi``), torch and CUDA versions; build the
   kernels from ``src/repro_torch/csrc`` with ``nvcc`` for sm_90a and print
   the compiler's ``-Xptxas -v`` report;
2. hold each kernel against its plain PyTorch version on the card at the
   serving shapes of mamba-130m, in f32 and bf16, for every exp/SiLU
   variant, within the printed tolerances;
3. run mamba-130m at full width in f32 (prefill + 8 decode steps) through
   the kernel path on the card and through the plain path on the CPU, on
   the same weights, and compare the logits;
4. serve 9 requests at bf16 through ``Server``/``Engine`` (4 slots, prompt
   lengths 64/127/256/512, 32 new tokens, 8 greedy + 1 sampled) and check
   the launch counts of every kernel, that no plain version ran, and the
   slot size;
5. time each kernel on the card (device time from a CUDA graph replay, and
   eager per-call time) beside its bound, its plain version
   and (for the conv) ``F.conv1d``, then print one JSON line of kernels.

The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "mamba-130m"
SEED = 0

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# exp on the special-function units, printed beside the scan's bound as
# the floor of its exponentials: 16 results / clock / SM on compute
# capability 9.0 (NVIDIA's CUDA C++ documentation, arithmetic
# instruction throughput), 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9

FAILURES = []


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(name, got, want, rtol, atol) -> float:
    """allclose on the card; records a failure and returns max |got-want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.abs()).all())
    max_err = float(err.max())
    log(f"  {name:<52} max_abs_err {max_err:.3e}  "
        f"(atol {atol:g} rtol {rtol:g})  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(name)
    return max_err


# ---------------------------------------------------------------------------
# Inputs at the slice's shapes, made on the CPU from a seed, moved to the card
# ---------------------------------------------------------------------------

def scan_inputs(b, L, d, n, r, dtype, gen, dev, h0=True):
    """x, z are views of one (b, L, 2d) tensor and B, C views of one
    (b, L, r + 2n) tensor, as the Mamba block hands them to the kernel."""
    def rn(*s):
        return torch.randn(*s, generator=gen)
    xz = rn(b, L, 2 * d).to(dev, dtype)
    x, z = xz.chunk(2, dim=-1)
    dt = torch.nn.functional.softplus(rn(b, L, d)).to(dev, dtype)
    dbc = rn(b, L, r + 2 * n).to(dev, dtype)
    _, B, C = dbc.split([r, n, n], dim=-1)
    A = (-torch.exp(0.5 * rn(d, n))).to(dev)
    D = rn(d).to(dev)
    hinit = rn(b, d, n).to(dev) if h0 else None
    return x, dt, A, B, C, D, z, hinit


def conv_inputs(b, L, d, k, dtype, gen, dev):
    xz = torch.randn(b, L, 2 * d, generator=gen).to(dev, dtype)
    x = xz[..., :d]
    w = torch.randn(k, d, generator=gen).to(dev)
    bias = torch.randn(d, generator=gen).to(dev)
    x_prev = torch.randn(b, k - 1, d, generator=gen).to(dev, dtype)
    return x, w, bias, x_prev


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _lib
    log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    log(f"built {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log(_lib.build_log())


VARIANTS = [("exact", "exact"), ("ours", "ours"), ("fast", "paper")]


def phase_kernels(cfg, dev):
    """Each kernel against its plain version on the card.  Returns the max
    abs error at the serving configuration (bf16, exact exp and SiLU) per
    kernel."""
    from repro_torch.kernels import conv1d, decode_step, ref, selective_scan
    d, n, r, k = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    gen = torch.Generator().manual_seed(SEED)
    serving = {}
    tol = {torch.float32: dict(scan=(5e-4, 5e-4), conv=(1e-5, 1e-5),
                               step=(1e-5, 1e-5)),
           torch.bfloat16: dict(scan=(2e-2, 2e-2), conv=(3e-2, 3e-2),
                                step=(2e-2, 2e-2))}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        t = tol[dtype]
        for L in (1, 127, 512):
            for ei, si in VARIANTS:
                x, dt, A, B, C, D, z, h0 = scan_inputs(1, L, d, n, r, dtype,
                                                       gen, dev)
                kw = dict(D=D, z=z, h0=h0, exp_impl=ei, silu_impl=si)
                y1, h1 = selective_scan.selective_scan(x, dt, A, B, C, **kw)
                y0, h0r = ref.selective_scan(x, dt, A, B, C, **kw)
                torch.cuda.synchronize()
                name = f"scan {tag} b=1 L={L} exp={ei} silu={si}"
                e = check(name + " y", y1, y0, *t["scan"])
                check(name + " h_last", h1, h0r, 5e-4, 5e-4)
                if dtype == torch.bfloat16 and L == 512 and ei == "exact":
                    serving["selective_scan"] = e
        for L, b in ((1, 4), (512, 1)):
            x, w, bias, x_prev = conv_inputs(b, L, d, k, dtype, gen, dev)
            y1, s1 = conv1d.causal_conv1d(x, w, bias, x_prev)
            y0, s0 = ref.causal_conv1d(x, w, bias, x_prev)
            torch.cuda.synchronize()
            name = f"conv {tag} b={b} L={L}"
            e = check(name + " y", y1, y0, *t["conv"])
            check(name + " tail", s1, s0, 0.0, 0.0)
            if dtype == torch.bfloat16 and L == 1:
                serving["causal_conv1d"] = e
        for ei, si in VARIANTS:
            x, dt, A, B, C, D, z, h = scan_inputs(4, 1, d, n, r, dtype, gen,
                                                  dev)
            args = (h, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
            kw = dict(D=D, z_t=z[:, 0], exp_impl=ei, silu_impl=si)
            y1, h1 = decode_step.selective_state_step(*args, **kw)
            y0, h0r = ref.selective_state_step(*args, **kw)
            torch.cuda.synchronize()
            name = f"step {tag} slots=4 exp={ei} silu={si}"
            e = check(name + " y", y1, y0, *t["step"])
            check(name + " h_new", h1, h0r, *tol[torch.float32]["step"])
            if dtype == torch.bfloat16 and ei == "exact":
                serving["decode_step"] = e
    return serving


def phase_model(cfg, dev):
    """Full-width f32 model: kernel path on the card vs plain path on the
    CPU, same weights, same tokens (teacher-forced)."""
    import dataclasses
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    cfg = dataclasses.replace(cfg, dtype="float32")
    lp, steps = 127, 8
    params = registry.init_params(cfg, seed=SEED)
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, lp + steps, seed=2)
                           .batch_at(0, 0, 1, 1)["tokens"], dtype=torch.int64)
    runs = []
    for where in (dev, torch.device("cpu")):
        p = registry.tree_to(params, where)
        t = toks.to(where)
        cache = registry.init_cache(cfg, 1, lp + steps, device=where)
        t0 = time.perf_counter()
        logits, cache = registry.prefill(cfg, p, cache,
                                         {"tokens": t[:, :lp]})
        out = [logits[0]]
        for s in range(steps):
            logits, cache = registry.decode_step(
                cfg, p, cache, {"tokens": t[:, lp + s:lp + s + 1]})
            out.append(logits[0])
        out = torch.cat(out).cpu()
        log(f"  {where.type}: prefill {lp} + {steps} decode steps in "
            f"{time.perf_counter() - t0:.2f} s")
        runs.append((out, {k: v.cpu() for k, v in cache.items()}))
    (lg, cg), (lc, cc) = runs
    check("model f32 logits (card kernels vs CPU plain)", lg, lc, 2e-3,
          2e-3)
    check("model f32 final h (card vs CPU)", cg["h"], cc["h"], 2e-3, 2e-3)
    check("model f32 final conv tail (card vs CPU)", cg["conv"], cc["conv"],
          2e-3, 2e-3)
    agree = float((lg.argmax(-1) == lc.argmax(-1)).float().mean())
    log(f"  greedy token agreement over {lg.shape[0]} positions: {agree:.4f}")


def phase_serve(cfg, dev, card):
    """bf16 serving through Server/Engine with launch counts."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import conv1d, decode_step, ref, selective_scan
    from repro_torch.models import registry
    from repro_torch.runtime.metrics import ServeStats
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.serve import ServeConfig, Server
    max_new, lens = 32, (64, 127, 256, 512)
    params = registry.init_params(cfg, seed=SEED)
    srv = Server(cfg, params, ServeConfig(batch_slots=4,
                                          max_seq=max(lens) + max_new + 8,
                                          device="cuda"))
    warm = SyntheticLM(cfg.vocab, 16, seed=3).batch_at(0, 0, 1, 2)["tokens"]
    srv.generate(warm, max_new=4)                  # cuBLAS and library init
    eng = srv.engine
    eng.stats = ServeStats()
    prompts = [SyntheticLM(cfg.vocab, L, seed=4).batch_at(0, 0, 1, 2)
               ["tokens"][i] for L in lens for i in range(2)]
    selective_scan.launches = conv1d.launches = decode_step.launches = 0
    ref.CALLS.clear()
    torch.cuda.synchronize()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    reqs.append(eng.submit(prompts[3], SamplingParams(
        temperature=0.8, top_k=40, seed=1234, max_new=max_new)))
    eng.run()
    torch.cuda.synchronize()
    counts = {"selective_scan": selective_scan.launches,
              "causal_conv1d": conv1d.launches,
              "decode_step": decode_step.launches}
    s = eng.stats
    L = cfg.n_layers
    want = {"selective_scan": L * s.prefill_calls,
            "causal_conv1d": L * (s.prefill_calls + s.decode_steps),
            "decode_step": L * s.decode_steps}
    log(f"  admissions {s.prefill_calls}, pooled decode steps "
        f"{s.decode_steps}")
    for name in counts:
        ok = counts[name] == want[name] and counts[name] > 0
        log(f"  launches {name:<16} {counts[name]:>6} (expected "
            f"{want[name]})  {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"launch count {name}")
    plain = sum(ref.CALLS.values())
    log(f"  plain-version calls during serving: {plain}  "
        f"{'ok' if plain == 0 else 'FAIL'}")
    if plain:
        FAILURES.append("plain versions ran on the card")
    spb = eng.pool.state_bytes_per_slot()
    log(f"  state_bytes_per_slot {spb} (expected 2580484)  "
        f"{'ok' if spb == 2580484 else 'FAIL'}")
    if spb != 2580484:
        FAILURES.append("state_bytes_per_slot")
    good = all(r.finished and len(r.tokens) == max_new
               and all(0 <= t < cfg.vocab for t in r.tokens) for r in reqs)
    log(f"  9 requests finished with {max_new} in-vocab tokens each: "
        f"{'ok' if good else 'FAIL'}")
    if not good:
        FAILURES.append("serve outputs")
    smry = s.summary()
    log(f"  serve bf16 on {card}: {smry['useful_tokens']} tokens in "
        f"{smry['wall_s']:.3f} s = {smry['tokens_per_s']:.1f} tok/s; TTFT "
        f"mean {smry['ttft_mean_s'] * 1e3:.1f} ms, p95 "
        f"{smry['ttft_p95_s'] * 1e3:.1f} ms; TPOT mean "
        f"{smry['tpot_mean_s'] * 1e3:.2f} ms")
    return counts


def time_ms(fn, iters):
    """Wall time of one call on the card's clock, launches issued from the
    host one by one: what the eager serving loop pays per call, the
    host's launch overhead included when it exceeds the device work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, reps):
    """Device time of one call: ``reps`` calls captured in one CUDA graph
    and replayed, so no host launch overhead is in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 20) / reps


def bound_ms(nbytes, ops):
    """Least time for the work: the bytes over the HBM rate against the
    operations over the f32 peak; returns (ms, "bytes"|"operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def s6_work(b, L, d, n, in_bytes, h0):
    """Bytes, operations and exponentials of one S6 scan/step call: x, dt,
    z (b,L,d) and B, C (b,L,n) in; A (d,n), D (d,) f32; optional h0 in;
    y out in the input type, h out f32.  Per (t, d, n): dt*A, exp, da*h,
    dt*x*B (shared dt*x), +, h*C and the sum: 7 operations; per (t, d):
    dt*x, D*x, +, the SiLU (exp, add, divide, multiply) and the gate
    multiply: 8."""
    nbytes = (3 * b * L * d + 2 * b * L * n) * in_bytes + (d * n + d) * 4
    nbytes += b * L * d * in_bytes + b * d * n * 4
    if h0:
        nbytes += b * d * n * 4
    ops = 7 * b * L * d * n + 8 * b * L * d
    return nbytes, ops, b * L * d * n + b * L * d


def conv_work(b, L, d, k, in_bytes):
    """x and x_prev in, y and the (b, k-1, d) tail out, w and bias f32;
    k multiply-adds and the bias add per output."""
    nbytes = (2 * b * L * d + 2 * b * (k - 1) * d) * in_bytes
    nbytes += (k * d + d) * 4
    return nbytes, 2 * k * b * L * d + b * L * d


def measure(name, shape, kernel, plain, library, work, reps):
    """One timing row: the kernel's device time (CUDA graph replay) and
    eager per-call time, its plain version's and the library call's
    device times, and the bound from ``work`` = (bytes, operations)."""
    bms, by = bound_ms(*work)
    row = dict(shape=shape, ms=device_ms(kernel, reps),
               eager_ms=time_ms(kernel, 10 * reps),
               plain_ms=device_ms(plain, 1 if reps <= 10 else 10),
               bound_ms=bms, bound_by=by,
               library_ms=None if library is None else device_ms(library,
                                                                 reps))
    lib_txt = "-" if library is None else f"{row['library_ms']:.4f}"
    log(f"  {name:<15} {row['ms']:.4f} ms (eager {row['eager_ms']:.4f})  bound "
        f"{bms:.4f} ms ({by})  plain {row['plain_ms']:.4f} ms  library "
        f"{lib_txt} ms  [{shape}]")
    return row


def phase_timing(cfg, dev, counts, errs):
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d, decode_step, ref, selective_scan
    d, n, r, k = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {}

    # scan at prefill: b=1, L=512, h0=None (prefill starts from zero state)
    x, dt, A, B, C, D, z, _ = scan_inputs(1, 512, d, n, r, bf, gen, dev,
                                          h0=False)
    nbytes, ops, exps = s6_work(1, 512, d, n, 2, False)
    log(f"  selective_scan: its exponentials alone at the SFU rate take "
        f"{1e3 * exps / SFU_PER_S:.4f} ms")
    rows["selective_scan"] = [measure(
        "selective_scan", "b=1 L=512 d=1536 n=16 bf16, h0=None (prefill)",
        lambda: selective_scan.selective_scan(x, dt, A, B, C, D=D, z=z),
        lambda: ref.selective_scan(x, dt, A, B, C, D=D, z=z), None,
        (nbytes, ops), 10)]

    # conv at decode (4 slots, L=1) and at prefill (b=1, L=512); the
    # library call is F.conv1d(groups=d) on the history-padded input in
    # PyTorch's (b, d, L) layout, made once outside the timing
    rows["causal_conv1d"] = []
    for b, L, label in ((4, 1, "decode"), (1, 512, "prefill")):
        xc, w, bias, x_prev = conv_inputs(b, L, d, k, bf, gen, dev)
        xp = torch.cat([x_prev, xc], 1).transpose(1, 2).contiguous()
        wl, bl = w.t().contiguous().unsqueeze(1).to(bf), bias.to(bf)
        rows["causal_conv1d"].append(measure(
            "causal_conv1d", f"b={b} L={L} d=1536 k=4 bf16 ({label})",
            lambda: conv1d.causal_conv1d(xc, w, bias, x_prev),
            lambda: ref.causal_conv1d(xc, w, bias, x_prev),
            lambda: F.conv1d(xp, wl, bl, groups=d),
            conv_work(b, L, d, k, 2), 50))

    # decode step at 4 slots
    x, dt, A, B, C, D, z, h = scan_inputs(4, 1, d, n, r, bf, gen, dev)
    args = (h, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    rows["decode_step"] = [measure(
        "decode_step", "slots=4 d=1536 n=16 bf16, f32 state",
        lambda: decode_step.selective_state_step(*args, D=D, z_t=z[:, 0]),
        lambda: ref.selective_state_step(*args, D=D, z_t=z[:, 0]), None,
        s6_work(4, 1, d, n, 2, True)[:2], 50)]

    meta = {
        "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                           "src/repro/kernels/selective_scan.py:43"),
        "causal_conv1d": ("src/repro_torch/csrc/conv1d.cu",
                          "src/repro/kernels/conv1d.py:21"),
        "decode_step": ("src/repro_torch/csrc/decode_step.cu",
                        "src/repro/kernels/decode_step.py:223"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        main_row, *more = rows[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": counts[name],
                 "max_abs_err": errs[name], **main_row}
        if more:
            entry["other_shapes"] = more
        kernels.append(entry)
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch import configs, resolve_device
    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}")
    cfg = configs.get_config(ARCH)
    import dataclasses
    cfg = dataclasses.replace(cfg, scan_impl="pallas", conv_impl="pallas",
                              step_impl="fused")
    t_start = time.perf_counter()
    log("== phase 1: build")
    phase_build()
    log("== phase 2: kernels vs plain versions on the card")
    errs = phase_kernels(cfg, dev)
    log("== phase 3: mamba-130m f32, kernel path (card) vs plain path (CPU)")
    phase_model(cfg, dev)
    log("== phase 4: serve mamba-130m bf16")
    counts = phase_serve(cfg, dev, card)
    log("== phase 5: kernel timing (CUDA events)")
    kernels = phase_timing(cfg, dev, counts, errs)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if FAILURES:
        log(f"FAILED: {FAILURES}")
        return 1
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
