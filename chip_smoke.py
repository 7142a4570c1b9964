#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi``), torch and CUDA versions; build the
   kernels from ``src/repro_torch/csrc`` with ``nvcc`` for sm_90a, print
   the compiler's ``-Xptxas -v`` report, and count the tensor-core
   (HGMMA) and TMA (UTMALDG) instructions in K7's bf16 kernels' SASS
   (``cuobjdump -sass``), failing where HGMMA is missing, and the 128-bit
   loads and stores (and FMUL, FADD, FFMA, LDS) of K8's and K9's,
   failing where those loads or stores are missing; record each K3-xLSTM
   and each K3 mamba/jamba instantiation's registers and spill bytes from
   the build log (phases 5, 5x and 5j's kernels lines carry them);
2. hold each kernel against its plain PyTorch version on the card at the
   serving shapes of mamba-130m, in f32 and bf16, for every exp/SiLU
   variant, within the printed tolerances: the scan (also at lengths 1,
   2, 31, 32, 33, 127, 300, 512 and 576 around its time segments, b 1
   and 3, with and without h0, each launch repeated bit for bit and one
   device kernel a call), the conv (one
   launch that writes y and its tail, which is held bitwise; also at L 2
   and 3, with and without x_prev; each launch repeated bit for bit and
   one device kernel a call), the
   decode step with f32 A and with int8 A (K1, its launch shape printed)
   and the quantized-state step (K2) with int8 and fp8 state, f32 and
   int8 A, each at d 1536 and 1100;
   K2's
   encoding against torch's over the whole code range; the fp8 slot
   operations (byte views) against exact fp8 results; the cross-layer
   megakernel (K3) at 4 slots in f32 and bf16 with f32 or int8 weights and
   an f32, bf16, int8 or fp8 state, at full width (24 layers), at
   mamba-2.8b's widths (whose in_proj panels wrap the weight ring) and at
   a ragged width (d_model 550, whose weights take the copy path, not
   TMA) with 2 layers, each width's streaming paths checked against the
   weights' strides and the panels the card cuts against the columns
   they must cover once, and one launch repeated bit for bit; K3 at one
   slot holding a used state (the prefix cache's suffix chain steps one
   request at a time) at full width, f32 and bf16, f32/f32 and int8/int8,
   each bf16 launch repeated bit for bit and timed beside 4 slots;
3. run mamba-130m at full width in f32 (prefill + 8 decode steps) through
   the kernel path on the card, per layer and through K3, and through the
   plain path on the CPU, on the same weights, and compare the logits:
   f32 weights and state, int8 weights, int8 weights with int8 state, and
   fp8 state;
3s. speculative decoding's verify window in f32 (f32 weights and state:
   K1; int8 weights and state: K2): after a 127-token prefill on 4 slots,
   one window of 5 tokens from 3 starting states, held to phase 3's
   tolerance against the CPU's window, the card's chained per-layer
   decode steps and the rollback select of one step per slot (logits,
   every step's h and conv; an int8 payload within one code), with the
   tie rule's greedy agreement; K5's tail over the window bitwise the
   last per-step tail; and K3 at the spec pool's 8 slots at full width
   (24 layers and the draft's 12) against its plain version;
4. serve 9 requests at bf16 (4 slots, prompt lengths 64/127/256/512, 32
   new tokens, 8 greedy + 1 sampled) five times: per layer with f32
   weights and state through ``Server``, int8 weights with int8 state and
   int8 weights with f32 state through ``Engine``; then through K3 with
   f32 weights and state through ``Server`` (``step_impl="auto"``, the
   default path on the card) and int8 weights with int8 state through
   ``Engine``; each run checks the launch counts of every kernel, that no
   plain version ran, and the slot size, and a K3 run prints its token
   agreement with the per-layer run of its setup;
4s. speculative serving through ``Engine(..., EngineConfig(draft=
   DraftConfig(k=4, layers=12)))``, step_impl "auto" (the draft through
   its own K3 view of 12 layers over the 8-row pool, the verify window per
   layer): 8 requests on 4 slots (prompts 64 and 127, 32 new tokens, 6
   greedy and 2 sampled), f32 weights and state, int8 weights and state,
   and a full-depth draft (layers 24) whose greedy rejections must all be
   ties; each run checks every kernel's launches against the engine's
   counters (K3 = draft steps + plain steps, K1/K2 = 24 x verified
   tokens, K5 = 24 a pass + 24 an admission), that no plain version ran,
   that every scratch lease came back and the slot size, and prints tok/s
   beside the plain engine's on the same traffic, tokens per pass, the
   acceptance rate and the greedy agreement; then the device time of one
   verify pass against 5 plain decode steps;
4p. the prefix cache (``PrefixCacheConfig(block=64, max_entries=32)``,
   step_impl "auto"): 8 requests sharing one 256-token prefix, suffixes
   of 16/32/48/64 tokens (two each), 32 new tokens, 6 greedy and 2
   sampled, f32 weights and state through ``Server`` and int8/int8
   through ``Engine``; each run holds every launch to the engine's
   counters (K4 and K5 once a layer a one-block prefill, K3 once a chain
   step on the prefill master's view and once a decode step), no plain
   version, every slot back, the bytes a slot, the prefix counters, every
   stream bitwise a cold cache-on admission's, and (f32 state) the
   cache-off engine's greedy streams under the tie rule; TTFT of cold,
   hit and cache-off admissions printed side by side; then a host-store
   run whose streams are the device store's, bitwise;
4b. best-of-4 (one prefill: 24 K4 launches; 4 distinct ranked branches;
   branch 0 bitwise the request at n=1), best-of-4 greedy (one stream),
   a session past max_seq (640 tokens, slot pinned, bytes a slot and
   leaves constant) ended by cancel and one ended by its stop id, and a
   best-of-4 over a cached prefix;
4d. ``DisaggPipeline`` (a 1-slot worker, a 4-slot decode engine) against
   the monolithic engine on 8 requests, f32/f32 and int8/int8: streams and
   cumulative logprobs bitwise, each snapshot a slot's bytes, launches
   from the counters, the snapshot's transfer timed; then
   ``AsyncFrontend`` over ``SLOScheduler`` whose streams are
   ``Engine.run``'s, its sheds and degradations printed;
5. time each kernel on the card (the scan at L 512, 64, 127 and 256 and
   at jamba's d_inner 8192, its bound the larger of its bytes and its
   exponentials at the SFU rate; device time from a CUDA graph replay,
   eager per-call time, and the device kernels one wrapper call runs:
   the kernel nodes of a graph that captures it) beside its bound, its
   plain version
   and (for the conv) ``F.conv1d``, and the whole decode step through K3
   against the per-layer one;

then xlstm-350m at full width and full depth (24 layers: mLSTM, sLSTM
at 7, 15 and 23; 246.8 M parameters drawn on the card) and the MARCA
units:

2x. K3's mLSTM instance (a 7-layer run) and sLSTM instance (one layer)
   against their plain version at full width, 4 slots, f32 and bf16, f32
   or int8 weights, f32, bf16, int8 or fp8 state, every SiLU variant, a
   ragged pool of 3 slots (f32 over the whole run; bf16 layer by layer,
   the run's one launch bitwise equal to its layers launched in turn);
   one launch repeated bit for bit; both at one slot holding a used
   state, f32/f32 and int8 weights (an int8 C), f32 and bf16, each bf16
   launch repeated bit for bit;
2u. the units' main path (``ops.exp`` / ``ops.silu`` with backend
   "pallas", K8 and K9) driven with the counts at 0, then each kernel
   against its plain version, bitwise, at 1,000,003 and 16 M elements,
   f32 and bf16; over every bf16 bit pattern and every f32 bit pattern
   (16 chunks of 2^28); +-0, +-inf, NaNs, subnormals, K8's clamp and the
   SiLU breaks with their f32 neighbours; sizes 1-17; views at every
   offset within a 16-byte vector; each launch repeated; one device
   kernel a call; K8's answer for NaN against ``repro``'s;
3x. xlstm-350m cut to 12 of its 24 layers (sLSTM at 7) in f32, prefill
   127 + 8 decode steps, per layer and
   through K3 on the card against the CPU: f32, int8 weights with int8
   state, fp8 state; its verify window (f32) against the CPU's, layer
   0's mLSTM state at every step;
4x. serve it with phase 4's traffic and checks three times: per layer
   (f32) and through K3 (``"auto"``, f32) via ``Server``, through K3 via
   ``Engine`` (int8 weights, int8 state): 21 conv launches per admission,
   21 per decode step per layer, 3 K3-mlstm and 3 K3-slstm per step
   through K3;
4xs. one spec serve run as phase 4s's (f32, draft of 12 layers: 2
   K3-mlstm and 1 K3-slstm a draft step), 8 prompts of 64 tokens;
4xp. one prefix-cache run as phase 4p's (f32, block 64): 4 prompts of a
   shared 64 tokens + 16, 16 new tokens, served one at a time, each
   stream bitwise a cold admission's;
5x. time K3-mlstm, K3-slstm, K8 and K9 (beside ``torch.exp`` /
   ``F.silu``), the whole decode step through K3 against per layer, and
   the prefill loop per prompt token;

then the same for jamba-v0.1-52b at full width (d_model 4096, 16
experts) with its depth cut from 32 layers to one group of 8, whose
weights (53 GB in f32) are drawn on the card from a seeded CUDA
generator:

2j. the flash attention kernel (K7: bf16 on the tensor cores, f32 on the
   SIMT pipes) against its plain version at b=1, 32 query and 8 KV heads
   of 128, L 64/127/512 and a suffix case, f32 and bf16, and in bf16 at
   ragged lengths (65, 200, 37 over 300, 500 over 700), each launch
   repeated bit for bit and one device kernel a call; K3's jamba
   instance (mamba block + MLP per position) at
   full width, 4 slots, one and four positions, f32 and bf16, f32 or
   int8 weights, f32, int8 or fp8 state, its inputs made by the card
   tests' builder (``tests/_torch_inputs.py``); one launch repeated bit
   for bit; one position at one slot holding a used state, f32/f32 and
   int8/int8, f32 and bf16, each bf16 launch repeated bit for bit;
3j. the dense variant (n_experts 0, 8 layers) in f32, prefill 127 + 8
   decode steps, on the card per layer and through K3 against the CPU,
   f32 and int8 weights with int8 state and int8 KV; its verify window
   (f32) against the CPU's, position 0's state at every step;
4j. serve the 16-expert model three times with mamba's traffic and
   phase 4's checks: per layer (f32) and through K3 (``"auto"``, f32)
   via ``Server``, through K3 via ``Engine`` (int8 weights, int8 state,
   int8 KV);
4js. one spec serve run as phase 4s's with the full-depth draft (one
   group: the target's K3 runs), 8 prompts of 64 tokens; its acceptance
   is printed (expert capacity drops make an MoE layer's output depend
   on the batch, and the draft's batch is not the verify's);
4jp. one prefix-cache run as phase 4xp's with an int8 KV cache and 8 new
   tokens, served one at a time (capacity drops would make a slot's
   decode depend on what shares the batch);
5j. time K7 beside SDPA and its bound (and its device kernels a call),
   K3-jamba, and the whole jamba decode step through K3 against the
   per-layer one;

then the transformers, after jamba's weights are freed: qwen2-7b at
full width and full depth (28 layers, 7.6 B parameters, 30.5 GB in f32
drawn on the card) and qwen2-moe-a2.7b at full width cut from 24 layers
to 8 (22 GB); step_impl "auto" decodes them per layer (the family has
no K3 instance) and K7 runs once a layer an admission:

2t. K7 against its plain version at the zoo's transformer head layouts
   (hq/hkv x dh: qwen2-7b 28/4 x 128, where one query head fills a
   block; granite-20b 48/1 x 128, MQA, 16 heads a block; olmo-1b and
   qwen2-moe 16/16 x 128; musicgen 32/32 x 64, the 64-wide
   instantiation; phi-3-vision 32/32 x 96, padded into the 128-wide
   one), f32 and bf16, L 64/127/512 and a suffix (64 over 512), each
   launch counted once, repeated bit for bit and one device kernel a
   call;
3t. qwen2-7b at full width with 2 layers (QKV bias, rope theta 1e6,
   152064 words) in f32, prefill 127 + 8 decode steps on the card
   against the CPU on the same weights: f32 weights and KV, and int8
   weights with an int8 KV cache (codes within one, layer 0's scales to
   f32 rounding); then qwen2-moe-a2.7b at 1 layer with f32 weights and
   KV (60 routed experts padded to 64, top-4, 4 shared; capacity =
   expert count, so no assignment drops by batch);
4t. serve qwen2-7b with phase 4's traffic twice: f32 weights and KV
   through ``Server``, int8 weights with an int8 KV cache through
   ``Engine`` (the f32 master kept for prefill: 38 GB); each run holds
   K7 to 28 launches an admission and none a decode step, no plain
   version, every slot back, the bytes a slot computed from the config;
   the int8 run's greedy agreement with the f32 run printed;
4tp. one prefix-cache run as phase 4p's (f32, block 64, 8 requests
   sharing a 256-token prefix) on qwen2-7b at full width with its depth
   cut to 4 layers (a chain step is a batch-1 eager decode step, 72 ms
   at 28 layers, and the cold admissions every stream is held to chain
   about 1,850 of them): every stream bitwise a cold cache-on
   admission's, TTFT of cold, hit and cache off printed;
5t. time K7 at qwen2-7b's and granite's layouts (L 64/127/512, bf16)
   beside SDPA and the bound, the qwen2-7b decode step at 4 slots (CUDA
   graph; f32 and int8 weights), its prefill per prompt token and phase
   4t's untraced serving throughput;
4tm. serve qwen2-moe-a2.7b (8 layers) once through ``Server`` with phase
   4's traffic: launches, no plain version, every slot back;

then training, K4, K5 and K7 under their autograd Functions
(``kernels.ops``: the kernel forward, a PyTorch backward):

2g. each Function on the card against autograd through its plain version
   on the card, on the same leaves from a seed: the scan at mamba-130m's
   d_inner 1536 and d_state 16 (dt_rank 48, chunk 64), b 2, L 512 and a
   ragged 33, with D and the z gate outside it; the conv with and
   without x_prev; K7 at qwen2-7b's 28/4 and olmo-1b's 16/16 heads, lq =
   lk and lq < lk; f32 gradients within 5e-4 of each one's max-abs, bf16
   ones printed and finite; the launches counted (the scan's backward
   one more a chunk) and no plain version run;
3g. model gradients card against CPU on the same f32 weights and batch:
   mamba-130m at full width with 2 layers (b 2, L 128) and olmo-1b at
   full width with 2 layers (b 1, L 128); the loss within 1e-5 relative,
   every gradient leaf within 1e-3 of its max-abs (printed);
4g. the Trainer at full width and full depth, bf16 compute, f32 master
   weights and moments: mamba-130m (24 layers, global batch 8 in two
   microbatches, seq 512, 8 steps, a checkpoint every 4, then a resume
   from step 4 whose losses repeat the straight run's bit for bit) and
   olmo-1b (16 layers, 1,176,764,416 parameters, global batch 4, seq
   512, 6 steps, no checkpoint); each loss finite and falling, the
   launches a step the layer count gives, no plain version; step time,
   tokens/s, peak memory printed;
5g. one mamba-130m step of 4g split into forward, backward and
   optimizer: wall time and device time (the kernels torch.profiler
   records) of each;

then tensor-parallel serving, two ranks spawned on the one card and
joined over gloo through a ``FileStore`` under ``build/`` (NCCL refuses
two ranks on one device; rank 0 prints, a rank's failure fails the
run):

2m. which collectives gloo takes on CUDA tensors (all_reduce sum and
   max, broadcast, all_gather); the sequence-parallel scan at
   mamba-2.8b's d_inner 5120, L 1024 as two chunks of 512, f32 and bf16,
   with D and z, one K4 launch a rank, against one K4 launch over the
   whole sequence; the straddled-group step at mamba-130m's d_inner
   (768 channels a rank cut the middle scale group), int8 and fp8: K1 on
   the dequantized shard and the group absmax exchanged, against the
   single-device K2 step;
3m. mamba-2.8b at full width and depth (64 layers, random weights from
   seed 0 drawn on the card by each rank, f32, TF32 off): prefill 127 +
   8 decode steps at tp=2 against one device's per-layer path on the
   card, the all-reduces of a decode step counted; tp=1 over NCCL
   (mamba-130m) bitwise the no-mesh engine; qwen2-7b at full width cut to
   2 layers and xlstm-350m at full width and depth at tp=2 against one
   device;
4m. mamba-2.8b served at tp=2 through ``Engine(cfg, params,
   EngineConfig(mesh=make_serving_mesh(2)))`` on both ranks with phase
   4's traffic (max_seq 576): f32 weights and state, int8 weights with
   int8 state (f32 compute), each against the single-device per-layer
   engine under the tie rule, and f32 in bf16 for tok/s only; each run's
   launches on each rank against the engine's counters, no plain
   version, the bytes a slot on a rank; tok/s beside one device's (two
   ranks sharing one card over gloo: not a tensor-parallel speedup), a
   pooled decode step's wall time; then one ``all_reduce_sum`` alone at
   the step's shapes, timed;
5m. K4, K5, K1, K2 at mamba-2.8b's shard width (d_inner 2560) and K7 at
   qwen2-7b's 14/2 heads, timed (rank 0);

each new phase printing its seconds, and print one JSON line of every
kernel (K5's and K7's with their designs, K7's with its SASS counts,
each with its launches in the speculative serve runs and in the
prefix-cache runs; K7's with its launches in 4t, 4tp and 4tm, its
largest bf16 error at each transformer layout and its 5t rows; K4's, K5's
and K7's with their launches a training step and a microbatch in 4g and
their largest f32 gradient error in 2g; each kernel's launches on rank 0
in 2m and 4m, ``tp_launches``, and its 5m row).

``python3 chip_smoke.py --tp-only`` builds the kernels and runs phases
2m-5m alone (it prints their results, not the run's result line).

The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
import collections
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

# K7's bf16 instantiations, whose products must run on the tensor cores
K7_TC = "flash_attention_tc"
SASS = {}
# K8's and K9's kernels (approx_units.cu): their 16-byte loads and stores,
# and the f32 arithmetic that shows one quadratic an element (FFMA would
# be a contraction that changes bits)
UNIT_KERNEL = "unit_kernel"
UNIT_SASS_OPS = {"LDG.128": r"\bLDG\.[\w.]*128\b",
                 "STG.128": r"\bSTG\.[\w.]*128\b", "FMUL": r"\bFMUL\b",
                 "FADD": r"\bFADD\b", "FFMA": r"\bFFMA\b",
                 "LDS": r"\bLDS\b",
                 "instructions": r"/\*[0-9a-f]{4,}\*/\s+[A-Z@]"}
UNIT_SASS = {}


def phase_build():
    from repro_torch.kernels import _lib
    log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    log(f"built {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log(_lib.build_log())
    check_k7_sass(so)
    check_unit_sass(so)
    check_xlstm_registers(_lib.build_log())
    check_mamba_registers(_lib.build_log())


def sass_counts(so, match, ops):
    """{kernel: {op: lines}} over the kernels of the library's SASS
    (``cuobjdump -sass``) whose mangled name holds ``match``: for each op
    the number of instructions matching its regex."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if match in m.group(1) else None
            if fn:
                out[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op, rx in ops.items():
                out[fn][op] += bool(re.search(rx, line))
    return out


def check_k7_sass(so):
    """Count the warpgroup tensor-core instructions (HGMMA) and TMA loads
    (UTMALDG) in each of K7's bf16 kernels in the built library's SASS;
    a kernel without HGMMA fails."""
    SASS.update(sass_counts(so, K7_TC, {op: rf"\b{op}\b"
                                        for op in ("HGMMA", "UTMALDG")}))
    for fn, n in SASS.items():
        log(f"  K7 bf16 SASS {fn}: {n['HGMMA']} HGMMA, {n['UTMALDG']} "
            f"UTMALDG  {'ok' if n['HGMMA'] else 'FAIL'}")
    if not SASS or not all(n["HGMMA"] for n in SASS.values()):
        FAILURES.append("K7 bf16 without HGMMA")


def unit_kernel_name(fn):
    """'<unit> <dtype>' of an instantiation of approx_units.cu's
    unit_kernel<T, kOp> from its mangled name."""
    op = {"Li0E": "fast_exp", "Li1E": "silu ours", "Li2E": "silu paper"}
    unit = next((v for k, v in op.items() if k in fn), fn)
    return f"{unit} {'bf16' if 'bfloat16' in fn else 'f32'}"


def check_unit_sass(so):
    """K8's and K9's instantiations: each must hold 128-bit global loads
    and stores; the counts of FMUL / FADD (2 a quadratic), FFMA, LDS (K9
    "ours"' table reads) and of all instructions are printed."""
    UNIT_SASS.update({unit_kernel_name(fn): n for fn, n in sass_counts(
        so, UNIT_KERNEL, UNIT_SASS_OPS).items()})
    for name, n in sorted(UNIT_SASS.items()):
        ok = n["LDG.128"] > 0 and n["STG.128"] > 0
        log(f"  K8/K9 SASS {name}: " + ", ".join(
            f"{v} {k}" for k, v in n.items()) + f"  {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{name} without 128-bit loads and stores")
    if len(UNIT_SASS) != 6:
        FAILURES.append(f"{len(UNIT_SASS)} K8/K9 instantiations in the SASS "
                        f"(expected 6)")


def xlstm_kernel_name(fn):
    """'mlstm bf16 act, int8 w' of an instantiation of
    megakernel_xlstm.cuh's mlstm_megakernel<T, TW> or
    slstm_megakernel<T, TW> (an older build's xlstm_megakernel<T, TW,
    kSlstm> by its flag) from its mangled name."""
    import re
    m = re.search(r"([xms])lstm_megakernelI(f|13__nv_bfloat16)(f|a)"
                  r"(?:Lb([01]))?E", fn)
    if not m:
        return fn
    act = "f32" if m.group(2) == "f" else "bf16"
    w = "f32" if m.group(3) == "f" else "int8"
    slstm = m.group(1) == "s" or m.group(4) == "1"
    return f"{'slstm' if slstm else 'mlstm'} {act} act, {w} w"


def is_xlstm_kernel(fn) -> bool:
    """Whether a mangled name is one of K3's xLSTM kernels."""
    import re
    return re.search(r"[xms]lstm_megakernelI", fn) is not None


def mamba_kernel_name(fn):
    """'jamba bf16 act, int8 w' of an instantiation of K3's
    mamba_megakernel<T, TW> from its mangled name (the mamba instance's,
    marca::, in megakernel_mamba.cu; the jamba instance's, marca::mb::, in
    megakernel_mamba.cuh; an older build's mamba_megakernel<T, TW, kMlp>
    by its flag), else None."""
    import re
    m = re.search(r"(2mb)?16mamba_megakernelI(f|13__nv_bfloat16)(f|a)"
                  r"(?:Lb([01]))?E", fn)
    if not m:
        return None
    act = "f32" if m.group(2) == "f" else "bf16"
    w = "f32" if m.group(3) == "f" else "int8"
    jamba = m.group(1) or m.group(4) == "1"
    return f"{'jamba' if jamba else 'mamba'} {act} act, {w} w"


def kernel_registers(build_log, name):
    """{instantiation: {"registers", "spill_stores", "spill_loads"}} of the
    kernels ``name`` (mangled name -> label, or None to skip) names, from
    the ``-Xptxas -v`` report in the build log (each kernel reported once:
    the units build disjoint sets)."""
    import re
    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for '\w+')?$", line.strip())
        if m:
            fn = name(m.group(1))
            if fn:
                out.setdefault(fn, {"registers": None, "spill_stores": 0,
                                    "spill_loads": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def xlstm_registers(build_log):
    """kernel_registers of K3's xLSTM kernels."""
    return kernel_registers(build_log, lambda f: xlstm_kernel_name(f)
                            if is_xlstm_kernel(f) else None)


# K3's xLSTM instantiations' registers and spills (xlstm_registers)
XLSTM_REGS = {}


def check_xlstm_registers(build_log):
    """Record and print the registers and spill bytes of every K3-xLSTM
    instantiation (eight: mLSTM and sLSTM, f32 and bf16 compute, f32 and
    int8 weights)."""
    XLSTM_REGS.update(xlstm_registers(build_log))
    for name, r in sorted(XLSTM_REGS.items()):
        log(f"  K3-xLSTM {name}: {r['registers']} registers, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
            f"loads")
    if len(XLSTM_REGS) != 8:
        FAILURES.append(f"{len(XLSTM_REGS)} K3-xLSTM instantiations in the "
                        f"build log (expected 8)")


# K3's mamba and jamba instantiations' registers and spills
MAMBA_REGS = {}


def check_mamba_registers(build_log):
    """Record and print the registers and spill bytes of every
    mamba_megakernel instantiation (eight: the mamba and jamba instances,
    f32 and bf16 compute, f32 and int8 weights); phases 5 and 5j's kernels
    line carries them."""
    MAMBA_REGS.update(kernel_registers(build_log, mamba_kernel_name))
    for name, r in sorted(MAMBA_REGS.items()):
        log(f"  K3 {name}: {r['registers']} registers, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
            f"loads")
    if len(MAMBA_REGS) != 8:
        FAILURES.append(f"{len(MAMBA_REGS)} K3 mamba/jamba instantiations "
                        f"in the build log (expected 8)")


VARIANTS = [("exact", "exact"), ("ours", "ours"), ("fast", "paper")]


def code_ordinals(q):
    """Storage codes as integers in value order (adjacent codes differ by
    1): int8 as they are, e4m3 by sign and magnitude bits."""
    if q.dtype == torch.int8:
        return q.to(torch.int32)
    bits = q.view(torch.uint8).to(torch.int32)
    mag = bits & 0x7F
    return torch.where(bits >= 0x80, -mag, mag)


def check_q(name, got, want, y_tol) -> float:
    """A quantized-state step against its plain version: y within
    ``y_tol``, scales to rtol 1e-6, payloads within one code (nvcc
    contracts exp(dt*A)*h + dt*x*B into an FMA, the plain version does
    not, so a value on a rounding boundary may land one code apart).
    Returns y's max abs error."""
    (y1, q1, s1), (y0, q0, s0) = got, want
    ey = float((y1.float() - y0.float()).abs().max())
    es = float(((s1 - s0).abs() / s0.abs().clamp_min(1e-30)).max())
    codes = int((code_ordinals(q1) - code_ordinals(q0)).abs().max())
    moved = float((q1.view(torch.uint8) != q0.view(torch.uint8)).float()
                  .mean())
    ok = (bool(torch.isfinite(y1.float()).all()) and q1.dtype == q0.dtype
          and bool((((y1.float() - y0.float()).abs())
                    <= y_tol + y_tol * y0.float().abs()).all())
          and es <= 1e-6 and codes <= 1)
    log(f"  {name:<52} y {ey:.3e} (tol {y_tol:g})  scale rel {es:.1e} "
        f"(tol 1e-6)  codes apart {codes} (tol 1, share moved "
        f"{moved:.1e})  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(name)
    return ey


def q_state(h, state_dtype):
    """A pooled quantized state from f32 ``h`` (slots, d, n): codes and
    group scales, slot 0 a fresh slot (zero codes, zero scales)."""
    from repro_torch.core import state_quant
    hq, scale = state_quant.quantize_h(4.0 * h, state_dtype)
    hq[0] = 0
    scale[0] = 0.0
    return hq, scale


def encode_sweep(state_dtype, slots, d):
    """(slots, d) f32 over [-qmax, qmax]: every code, every tie between
    neighbouring codes, seeded values between, and qmax in every group."""
    from repro_torch.core import state_quant
    qm = state_quant.qmax(state_dtype)
    if state_dtype == "int8":
        codes = torch.arange(-127, 128, dtype=torch.float32)
    else:
        codes = torch.arange(256, dtype=torch.uint8).view(
            torch.float8_e4m3fn).float()
        codes = codes[torch.isfinite(codes)].unique() + 0.0   # no -0
    fill = (torch.rand(slots * d, generator=torch.Generator().manual_seed(
        SEED)) * 2 - 1) * qm
    vals = torch.cat([codes, (codes[1:] + codes[:-1]) / 2, fill])
    vals = vals[:slots * d].reshape(slots, d)
    vals[:, state_quant.D_BLOCK - 1::state_quant.D_BLOCK] = qm
    return vals


def check_k2_clusters(dev):
    """K2 where its clusters meet the edges: a ragged group of one channel
    (d 513: seven of the group's eight blocks own none) and jamba's 16
    groups (d 8192), by 1 and 9 slots, bf16, int8 A: each against the
    plain version and repeated bit for bit, with the launch it made."""
    from repro_torch.core import weight_quant
    from repro_torch.kernels import decode_step, ref
    gen = torch.Generator().manual_seed(SEED + 60)
    for dd in (513, 8192):
        for slots in (1, 9):
            for sd in ("int8", "fp8"):
                x, dt, A, B, C, D, z, h = scan_inputs(
                    slots, 1, dd, 16, 48, torch.bfloat16, gen, dev)
                hq, h_scale = q_state(h, sd)
                A, a_scale = weight_quant.quantize_rows(A)
                args = (hq, h_scale, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
                kw = dict(D=D, z_t=z[:, 0], state_dtype=sd, a_scale=a_scale)
                got = decode_step.selective_state_step_q(*args, **kw)
                again = decode_step.selective_state_step_q(*args, **kw)
                want = ref.selective_state_step_q(*args, **kw)
                torch.cuda.synchronize()
                name = f"step_q bf16 {sd} d={dd} slots={slots} int8 A"
                check_q(name, got, want, 2e-2)
                same = all(torch.equal(u.view(torch.uint8), v.view(
                    torch.uint8)) for u, v in zip(got, again))
                s = decode_step.q_launch_shape(slots, dd)
                log(f"    repeated {'bitwise equal' if same else 'FAIL'}; "
                    f"grid {s['grid']} x {s['threads']}, clusters of "
                    f"{s['cluster']}")
                if not same:
                    FAILURES.append(name + " repeat")


def check_encoding(dev):
    """K2's encode against torch's, bit for bit: from a fresh slot with
    dt = 1 and B = 1 the new state is x, and with qmax in every group
    every scale is exactly 1, so the payload is the encoding of x."""
    from repro_torch.core import state_quant
    from repro_torch.kernels import decode_step
    slots, d = 4, 1536
    for sd in ("int8", "fp8"):
        x = encode_sweep(sd, slots, d).to(dev)
        hq = torch.zeros(slots, d, 16, device=dev).to(
            state_quant.storage_dtype(sd))
        h_scale = torch.zeros(slots, state_quant.n_groups(d), device=dev)
        ones = torch.ones(slots, 16, device=dev)
        _, q, scale = decode_step.selective_state_step_q(
            hq, h_scale, x, torch.ones_like(x), -torch.ones(d, 16, device=dev),
            ones, ones, state_dtype=sd)
        want = state_quant.encode(x[..., None].expand(slots, d, 16), sd)
        torch.cuda.synchronize()
        n_codes = len(torch.unique(q.view(torch.uint8)))
        ok = bool((scale == 1.0).all()) and torch.equal(
            q.view(torch.uint8), want.view(torch.uint8))
        log(f"  K2 {sd} encode vs torch over {x.numel()} values "
            f"({n_codes} distinct codes, ties included): "
            f"{'bitwise equal' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"K2 {sd} encoding")


def check_fp8_slot_ops(dev):
    """The registry moves fp8 pool leaves through uint8 views: on the card
    the views must give the bytes of the fp8 operation, which for
    ``where`` is the fp8 op itself and for ``index_copy_`` (no fp8 kernel
    in PyTorch on the CPU or the card) the same copy in f32, exact for
    every e4m3 value."""
    gen = torch.Generator().manual_seed(SEED)
    fp8, u8 = torch.float8_e4m3fn, torch.uint8
    pool = torch.randn(3, 4, 64, 16, generator=gen).to(dev, fp8)
    new = torch.randn(3, 4, 64, 16, generator=gen).to(dev, fp8)
    ids = torch.tensor([2, 0], device=dev)
    active = torch.tensor([True, False, True, False],
                          device=dev)[None, :, None, None]
    checks = {
        "index_copy_": (
            pool.clone().view(u8).index_copy_(1, ids, new[:, :2].view(u8)),
            pool.float().index_copy_(1, ids, new[:, :2].float()).to(fp8)),
        "where": (torch.where(active, new.view(u8), pool.view(u8)),
                  torch.where(active, new, pool)),
    }
    for op, (got, want) in checks.items():
        ok = torch.equal(got, want.view(u8))
        log(f"  fp8 {op} on the card: byte view == fp8 result: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"fp8 {op}")


# K3's activation/weight/state setups and its tolerances against its plain
# version on the card.  f32: x (the residual stream out), the conv tails
# and an f32 state to 1e-4, a bf16 state within a bf16 step (8e-3); an
# int8/fp8 state's codes within one and its scales to 1e-5 relative (the
# sums run in another order, so a value on a rounding boundary moves one
# code, and each layer's absmax by f32 ulps).  bf16: a rounding that
# falls the other way moves what follows by a bf16 step (2^-8), over 24
# layers by up to 2% of the largest value, and the error of x + y is one
# of the larger operand, not of the result, so values are held to 2e-2 of
# themselves plus 2e-2 of the largest value; an int8/fp8 state's scales to
# 3e-2 relative and its dequantized values as the others, plus one code
# (1/127 of the largest value for int8, one e4m3 step, 1/8 of the value,
# for fp8).
K3_STATES = ("f32", "bf16", "int8", "fp8")
K3_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (label, d_model, layers, dt_rank): mamba-130m at full depth, mamba-2.8b's
# widths and a ragged width (d_inner 1100, dt_rank 35: no multiple of 32,
# a ragged third scale group) at 2 layers
K3_WIDTHS = (("130m", 768, 24, 48), ("2.8b widths", 2560, 2, 160),
             ("ragged", 550, 2, 35))
_PARAMS = {}
# K3's launch counters (core/dispatch_count.py names) by (weights, state)
K3_KERNEL = {("f32", "f32"): "mamba_stacked_step",
             ("int8", "int8"): "mamba_stacked_step_q_int8a"}


def k3_params(cfg, weight_dtype, dev):
    """The decode weights of ``cfg`` (seeded, f32 or int8) on the card with
    K3's stacked view, made once per width and weight type."""
    from repro_torch.models import registry
    key = (cfg.n_layers, cfg.d_model, cfg.dt_rank, weight_dtype)
    if key not in _PARAMS:
        import dataclasses
        c = dataclasses.replace(cfg, weight_dtype=weight_dtype)
        _PARAMS[key] = registry.stack_params(
            c, registry.init_params(c, seed=SEED, device=dev))
    return _PARAMS[key]


def k3_inputs(cfg, slots, gen, dev):
    """x0 (slots, 1, d_model) in cfg.dtype and a stacked state at cfg's
    state dtype: h (+ h_scale) and conv tails, slot 0 a fresh slot."""
    from repro_torch.core import state_quant
    dt = getattr(torch, cfg.dtype)
    L, di, k = cfg.n_layers, cfg.d_inner, cfg.d_conv
    x0 = torch.randn(slots, 1, cfg.d_model, generator=gen).to(dev, dt)
    h = torch.randn(L, slots, di, 16, generator=gen) * 0.5
    h[:, 0] = 0.0
    conv = torch.randn(L, slots, k - 1, di, generator=gen).to(dev, dt)
    h_scale = None
    if state_quant.is_quantized(cfg.state_dtype):
        h, h_scale = state_quant.quantize_h(h, cfg.state_dtype)
        h_scale[:, 0] = 0.0
        h_scale = h_scale.to(dev)
    else:
        h = h.to(state_quant.storage_dtype(cfg.state_dtype))
    return x0, h.to(dev), h_scale, conv


def check_k3(name, cfg, got, want) -> float:
    """K3 against its plain version (tolerances above K3_STATES); returns
    x's max abs error."""
    (x1, h1, s1, c1), (x0, h0, s0, c0) = got, want
    tol = K3_TOL[cfg.dtype]
    bf16 = cfg.dtype == "bfloat16"

    def near(tag, a, b, t):
        at = t * float(b.float().abs().max()) if bf16 else t
        return check(f"{name} {tag}", a, b, t, at)

    e = near("x", x1, x0, tol)
    near("conv tail", c1, c0, tol)
    if cfg.state_dtype == "f32":
        near("h", h1, h0, tol)
    elif cfg.state_dtype == "bf16":
        near("h (bf16 step)", h1, h0, max(tol, 8e-3))
    else:
        rel = float(((s1 - s0).abs() / s0.abs().clamp_min(1e-30)).max())
        codes = int((code_ordinals(h1) - code_ordinals(h0)).abs().max())
        moved = float((h1.view(torch.uint8) != h0.view(torch.uint8)).float()
                      .mean())
        ok = rel <= (3e-2 if bf16 else 1e-5) and (bf16 or codes <= 1)
        log(f"  {name + ' h':<52} scale rel {rel:.1e} (tol "
            f"{3e-2 if bf16 else 1e-5:.0e})  codes apart {codes} (tol "
            f"{'-' if bf16 else 1}, share moved {moved:.1e})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(name)
        if bf16:
            from repro_torch.core import state_quant
            d1 = state_quant.dequantize_h(h1, s1)
            d0 = state_quant.dequantize_h(h0, s0)
            top = float(d0.abs().max())
            fp8 = cfg.state_dtype == "fp8"
            check(f"{name} h dequantized", d1, d0,
                  tol + (0.125 if fp8 else 0.0),
                  tol * top + (0.0 if fp8 else top / 127))
    return e


def check_k3_stream(label, cfg, wd, stack, dev):
    """The path K3's mamba instance streams each dense weight by at this
    width, as the stack chose it per stride (TMA where a row is a
    multiple of 16 bytes, else the copy path), and its layout as the card
    sizes it (``megakernel.launch_config``): each weight's panels, a
    multiple of 16 bytes wide, cover its columns once in one round of the
    grid the stack's tensor maps were cut for; the ring's slots against a
    panel's items (a panel with more items than slots wraps the ring)."""
    from repro_torch.kernels import megakernel
    esize = 1 if wd == "int8" else 4
    widths = (2 * cfg.d_inner, cfg.dt_rank + 2 * cfg.d_state, cfg.d_model)
    want = sum(1 << w for w, n in enumerate(widths) if n * esize % 16 == 0)
    lc = megakernel.launch_config(cfg, torch.bfloat16, wd == "int8", dev)
    panels = [lc["panels"][w] for w in megakernel.STREAMED]
    cover = all(p["cols"] * esize % 16 == 0 and p["blocks"] <= lc["grid"]
                and (p["blocks"] - 1) * p["cols"] < n <= p["blocks"]
                * p["cols"] and p["items"] >= 1
                for p, n in zip(panels, widths))
    items = [p["items"] for p in panels]
    paths = ", ".join(f"{w} {'TMA' if stack.tma >> i & 1 else 'copy'}"
                      for i, w in enumerate(megakernel.STREAMED))
    ok = (stack.tma == want and cover and lc["ring_slots"] >= 2
          and stack.map_grid == lc["grid"])
    log(f"  K3 {label} {wd} w stream: {paths} (want mask {want:03b}); "
        f"panels {[p['cols'] for p in panels]} columns on "
        f"{[p['blocks'] for p in panels]} of {lc['grid']} blocks"
        f"{'' if cover else ' (do not cover)'}; ring {lc['ring_slots']} "
        f"slots, items a panel {items}"
        f"{' (wraps)' if max(items) > lc['ring_slots'] else ''}; "
        f"{lc['smem_bytes']} B shared  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"K3 {label} {wd} stream")


def check_megakernel(cfg, dev, serving):
    """K3 against ref.mamba_stacked_step on the card, 4 slots, every
    activation x weight x state setup at each of K3_WIDTHS; then one launch
    repeated, bit for bit."""
    import dataclasses
    from repro_torch.kernels import megakernel, ref
    gen = torch.Generator().manual_seed(SEED + 3)
    for label, dm, layers, r in K3_WIDTHS:
        base = dataclasses.replace(cfg, n_layers=layers, d_model=dm,
                                   dt_rank=r)
        for wd in ("f32", "int8"):
            p = k3_params(base, wd, dev)
            check_k3_stream(label, base, wd, p["stack"], dev)
            for dtype in ("float32", "bfloat16"):
                for sd in K3_STATES:
                    c = dataclasses.replace(base, dtype=dtype,
                                            weight_dtype=wd, state_dtype=sd)
                    x0, h, h_scale, conv = k3_inputs(c, 4, gen, dev)
                    got = megakernel.mamba_stacked_step(
                        c, x0, p["stack"], h, h_scale, conv)
                    want = ref.mamba_stacked_step(c, x0, p["stack"].layers,
                                                  h, h_scale, conv)
                    torch.cuda.synchronize()
                    act = "f32" if dtype == "float32" else "bf16"
                    e = check_k3(f"K3 {label} L={layers} {act} {wd} w "
                                 f"{sd} state", c, got, want)
                    if label == "130m" and dtype == "bfloat16" and (
                            (wd, sd) in (("f32", "f32"), ("int8", "int8"))):
                        serving[K3_KERNEL[wd, sd]] = e
    c = dataclasses.replace(cfg, dtype="bfloat16", weight_dtype="int8",
                            state_dtype="int8")
    p = k3_params(c, "int8", dev)
    args = (c, *k3_inputs(c, 4, gen, dev))
    a = megakernel.mamba_stacked_step(args[0], args[1], p["stack"], *args[2:])
    b = megakernel.mamba_stacked_step(args[0], args[1], p["stack"], *args[2:])
    torch.cuda.synchronize()
    same = all(torch.equal(u.view(torch.uint8), v.view(torch.uint8))
               for u, v in zip(a, b))
    log(f"  K3 130m bf16 int8 w int8 state, one launch repeated: "
        f"{'bitwise equal' if same else 'FAIL'}")
    if not same:
        FAILURES.append("K3 repeat")


def phase_kernels(cfg, dev):
    """Each kernel against its plain version on the card.  Returns the max
    abs error at the serving configuration (bf16, exact exp and SiLU) per
    kernel."""
    from repro_torch.core import weight_quant
    from repro_torch.kernels import conv1d, decode_step, ref, selective_scan
    d, n, r, k = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    gen = torch.Generator().manual_seed(SEED)
    serving = {}
    tol = {torch.float32: dict(scan=(5e-4, 5e-4), conv=(1e-5, 1e-5),
                               step=(1e-5, 1e-5), step_q=1e-4),
           torch.bfloat16: dict(scan=(2e-2, 2e-2), conv=(3e-2, 3e-2),
                                step=(2e-2, 2e-2), step_q=2e-2)}
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
        # decode and prefill as served; then L < k-1 (the tail keeps
        # x_prev's rows, shifted by L) and no x_prev (zeros before t = 0)
        for L, b, prev in ((1, 4, True), (512, 1, True), (2, 4, True),
                           (3, 4, False)):
            x, w, bias, x_prev = conv_inputs(b, L, d, k, dtype, gen, dev)
            x_prev = x_prev if prev else None
            y1, s1 = conv1d.causal_conv1d(x, w, bias, x_prev)
            y0, s0 = ref.causal_conv1d(x, w, bias, x_prev)
            y2, s2 = conv1d.causal_conv1d(x, w, bias, x_prev)
            torch.cuda.synchronize()
            name = f"conv {tag} b={b} L={L}" + ("" if prev else " no x_prev")
            e = check(name + " y", y1, y0, *t["conv"])
            check(name + " tail", s1, s0, 0.0, 0.0)
            same = torch.equal(y1, y2) and torch.equal(s1, s2)
            nk = shared_inputs().graph_kernels(
                lambda: conv1d.causal_conv1d(x, w, bias, x_prev))
            log(f"  {name} repeated: {'bitwise equal' if same else 'FAIL'};"
                f" {nk} device kernel(s) a call  {'ok' if nk == 1 else 'FAIL'}")
            if not same or nk != 1:
                FAILURES.append(f"{name} repeat / one kernel")
            if dtype == torch.bfloat16 and L == 1:
                serving["causal_conv1d"] = e
        for dd in (d, 1100):
            if dtype == torch.float32:
                shp = decode_step.launch_shape(4, dd)
                log(f"  step launch at slots=4 d={dd}: grid {shp['grid']} x "
                    f"{shp['threads']}")
            for a8 in (False, True):
                key = "decode_step_int8a" if a8 else "decode_step"
                for ei, si in VARIANTS:
                    x, dt, A, B, C, D, z, h = scan_inputs(4, 1, dd, n, r,
                                                          dtype, gen, dev)
                    a_scale = None
                    if a8:
                        A, a_scale = weight_quant.quantize_rows(A)
                    args = (h, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
                    kw = dict(D=D, z_t=z[:, 0], exp_impl=ei, silu_impl=si,
                              a_scale=a_scale)
                    y1, h1 = decode_step.selective_state_step(*args, **kw)
                    y0, h0r = ref.selective_state_step(*args, **kw)
                    torch.cuda.synchronize()
                    name = (f"step {tag} slots=4 d={dd} "
                            f"{'int8' if a8 else 'f32'} A exp={ei} silu={si}")
                    e = check(name + " y", y1, y0, *t["step"])
                    check(name + " h_new", h1, h0r,
                          *tol[torch.float32]["step"])
                    if dtype == torch.bfloat16 and dd == d and ei == "exact":
                        serving[key] = e
        for sd in ("int8", "fp8"):
            for dd in (d, 1100):
                for a8 in (False, True):
                    for ei, si in VARIANTS:
                        x, dt, A, B, C, D, z, h = scan_inputs(
                            4, 1, dd, n, r, dtype, gen, dev)
                        hq, h_scale = q_state(h, sd)
                        a_scale = None
                        if a8:
                            A, a_scale = weight_quant.quantize_rows(A)
                        args = (hq, h_scale, x[:, 0], dt[:, 0], A, B[:, 0],
                                C[:, 0])
                        kw = dict(D=D, z_t=z[:, 0], state_dtype=sd,
                                  exp_impl=ei, silu_impl=si, a_scale=a_scale)
                        got = decode_step.selective_state_step_q(*args, **kw)
                        want = ref.selective_state_step_q(*args, **kw)
                        torch.cuda.synchronize()
                        aname = "int8" if a8 else "f32"
                        e = check_q(f"step_q {tag} {sd} d={dd} {aname} A "
                                    f"exp={ei} silu={si}", got, want,
                                    t["step_q"])
                        if (dtype == torch.bfloat16 and sd == "int8"
                                and dd == d and a8 and ei == "exact"):
                            serving["decode_step_q"] = e
    check_scan_edges(d, n, r, dev)
    check_k2_clusters(dev)
    check_encoding(dev)
    check_fp8_slot_ops(dev)
    check_megakernel(cfg, dev, serving)
    return serving


# K4's segment edges: lengths around its 32 segments (1, a segment of 1, of
# 2, a ragged last one) and the longest prompt the serve phases admit
SCAN_LENGTHS = (1, 2, 31, 32, 33, 127, 300, 512, 576)


def check_scan_edges(d, n, r, dev):
    """K4 at SCAN_LENGTHS, b 1 and 3, with h0 and without, on the strided
    x/z and B/C views the Mamba block passes, f32 and bf16, exact exp:
    against its plain version (y 5e-4 f32 / 2e-2 bf16, h_last 5e-4), each
    launch repeated bit for bit, one device kernel a call."""
    from repro_torch.kernels import ref, selective_scan
    gen = torch.Generator().manual_seed(SEED + 7)
    kernels = shared_inputs().graph_kernels
    bad, n_cases = [], 0
    for dtype, tol in ((torch.float32, 5e-4), (torch.bfloat16, 2e-2)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for L in SCAN_LENGTHS:
            for b in (1, 3):
                for h0 in (True, False):
                    x, dt, A, B, C, D, z, hi = scan_inputs(b, L, d, n, r,
                                                           dtype, gen, dev,
                                                           h0=h0)
                    kw = dict(D=D, z=z, h0=hi)
                    y1, h1 = selective_scan.selective_scan(x, dt, A, B, C,
                                                           **kw)
                    y2, h2 = selective_scan.selective_scan(x, dt, A, B, C,
                                                           **kw)
                    y0, hr = ref.selective_scan(x, dt, A, B, C, **kw)
                    nk = kernels(lambda: selective_scan.selective_scan(
                        x, dt, A, B, C, **kw))
                    torch.cuda.synchronize()
                    ey = (y1.float() - y0.float()).abs()
                    eh = (h1 - hr).abs()
                    ok = (bool(torch.isfinite(y1.float()).all())
                          and bool((ey <= tol + tol * y0.float().abs()).all())
                          and bool((eh <= 5e-4 + 5e-4 * hr.abs()).all())
                          and torch.equal(y1, y2) and torch.equal(h1, h2)
                          and nk == 1)
                    n_cases += 1
                    if not ok:
                        bad.append(f"{tag} L={L} b={b} h0={h0}")
                    if L in (1, 33, 576) and b == 3:
                        same = torch.equal(y1, y2)
                        log(f"  scan edge {tag} L={L} b={b} h0={h0}: y err "
                            f"{float(ey.max()):.3e}, h_last err "
                            f"{float(eh.max()):.3e}, repeated "
                            f"{'bitwise equal' if same else 'differs'}"
                            f", {nk} device kernel(s) a call  "
                            f"{'ok' if ok else 'FAIL'}")
    log(f"  scan edges: {n_cases} cases (L {SCAN_LENGTHS}, b 1/3, h0 or "
        f"none, strided views, f32/bf16), {len(bad)} failed {bad}  "
        f"{'ok' if not bad else 'FAIL'}")
    if bad:
        FAILURES.append("scan edges")


# (weights, state, kv cache, logits tolerance, why): each run of phase 3
MODEL_RUNS = (
    ("f32", "f32", "model", 2e-3,
     "f32 throughout; the kernels sum in another order and nvcc contracts "
     "multiply-adds, over 24 layers"),
    ("int8", "f32", "model", 2e-3,
     "as f32: the weights are quantized once and moved, so both paths read "
     "the same codes and dequantize with the same multiply"),
    ("int8", "int8", "model", 2e-2,
     "a state value on a rounding boundary may land one code (1/127 of its "
     "group's absmax) apart on the card, and that code feeds every later "
     "step and layer"),
    ("f32", "fp8", "model", 2e-2,
     "as int8 state, with e4m3 codes (a step of 1/16 to 1/8 of the value)"),
)


def phase_model(name, cfg, p32, runs, dev, ssm_state, lp=127,
                dequant=None):
    """A full-width f32 model: the kernel path on the card, per layer and
    through K3, against the plain path on the CPU, on the same weights
    (``p32`` quantized per run, then copied to each side) and tokens
    (teacher-forced): prefill ``lp`` + 8 decode steps, for each (weights,
    state, kv cache, tolerance, why) of ``runs``.  ``ssm_state(cache)``
    is the final recurrent state compared, as {"h", "conv"} + "h_scale"
    (mamba: every layer; jamba: position 0; xLSTM: layer 0's C), and
    ``dequant(h, h_scale)`` decodes an int8/fp8 one (default
    ``state_quant.dequantize_h``).  Both card rows, per layer and K3,
    must also agree on every greedy token, or, for a run whose sixth
    entry ``ties`` is True, on every one but where the CPU's top two
    logits lie within the run's tolerance."""
    import dataclasses
    from repro_torch.core import state_quant
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    dequant = dequant or state_quant.dequantize_h
    steps = 8
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, lp + steps, seed=2)
                           .batch_at(0, 0, 1, 1)["tokens"], dtype=torch.int64)
    cpu = torch.device("cpu")
    for wd, sd, kv, tol, why, *rest in runs:
        ties = bool(rest) and rest[0]
        c = dataclasses.replace(cfg, dtype="float32", weight_dtype=wd,
                                state_dtype=sd, kv_cache_dtype=kv)
        p_dev = registry.tree_to(registry.quantize_params(c, p32), dev)
        p_cpu = registry.tree_to(p_dev, cpu)
        out_of = {}
        for side, where, impl, p in (("card", dev, "fused", p_dev),
                                     ("card", dev, "megakernel", p_dev),
                                     ("cpu", cpu, "fused", p_cpu)):
            ci = dataclasses.replace(c, step_impl=impl)
            if impl == "megakernel":
                p = registry.stack_params(ci, p)
            t = toks.to(where)
            cache = registry.init_cache(ci, 1, lp + steps, device=where)
            t0 = time.perf_counter()
            logits, cache = registry.prefill(ci, p, cache,
                                             {"tokens": t[:, :lp]})
            out = [logits[0]]
            for s in range(steps):
                logits, cache = registry.decode_step(
                    ci, p, cache, {"tokens": t[:, lp + s:lp + s + 1]})
                out.append(logits[0])
            out = torch.cat(out).cpu()
            log(f"  {name} {wd} weights, {sd} state, {kv} kv, {side} "
                f"{impl}: prefill {lp} + {steps} decode steps in "
                f"{time.perf_counter() - t0:.2f} s")
            out_of[side, impl] = (
                out, ssm_state(registry.tree_to(cache, cpu)))
        lc, cc = out_of["cpu", "fused"]
        log(f"  {name} {wd} weights {sd} state {kv} kv: logits held to "
            f"{tol:g}: {why}")
        for impl, suffix in (("fused", ""), ("megakernel", " K3")):
            lg, cg = out_of["card", impl]
            tag = f"{name} {wd} w {sd} state {kv} kv{suffix}"
            check(f"{tag} logits (card vs CPU)", lg, lc, tol, tol)
            if state_quant.is_quantized(sd):
                hg = dequant(cg["h"], cg["h_scale"])
                hc = dequant(cc["h"], cc["h_scale"])
                same = float((cg["h"].view(torch.uint8) == cc["h"].view(
                    torch.uint8)).float().mean())
                rel = float(((cg["h_scale"] - cc["h_scale"]).abs()
                             / cc["h_scale"].clamp_min(1e-30)).max())
                log(f"  {tag}: final payload codes equal {same:.6f}, "
                    f"scales max rel diff {rel:.3e}, dequantized h max abs "
                    f"diff {float((hg - hc).abs().max()):.3e} (printed)")
            else:
                check(f"{tag} final h (card vs CPU)", cg["h"], cc["h"], tol,
                      tol)
            check(f"{tag} final conv tail (card vs CPU)", cg["conv"],
                  cc["conv"], tol, tol)
            differ = lg.argmax(-1) != lc.argmax(-1)
            agree = 1.0 - float(differ.float().mean())
            top2 = lc.topk(2, dim=-1).values
            margins = (top2[:, 0] - top2[:, 1])[differ]
            ok = agree == 1.0 or (ties and bool((margins <= tol).all()))
            rule = ("must be 1" if not ties else
                    f"a differing token only where the CPU's top two logits "
                    f"are within {tol:g}; margins {margins.tolist()}")
            log(f"  {tag}: greedy token agreement over {lg.shape[0]} "
                f"positions: {agree:.4f}  ({rule})  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"{tag} greedy agreement")
        del p_dev, p_cpu, out_of


# The launches a served model makes: each of its "ssm" sublayers runs
# the scan ("scan" of them, where given) and the prefill conv, each
# "attn" sublayer K7, once per admission; a decode step runs the conv and
# step kernels of every SSM sublayer per layer (the step kernel where the
# run names one), or through K3 "k3" launches of each K3 kernel the run
# names plus the conv and step kernels of the "k3_rest" SSM positions K3
# leaves per sublayer (jamba-v0.1's plan: 3 runs, and the 4 MoE
# positions).
MAMBA = {"name": "mamba-130m", "ssm": 24, "attn": 0, "k3": 1, "k3_rest": 0}
SERVE_MAX_SEQ = 576

# (weights, state, kv cache, expected state_bytes_per_slot, the per-layer
# decode kernel, the K3 kernel(s) or None, step_impl): each run of phase 4;
# bytes per slot at mamba-130m, 24 layers: h 24 x 1536 x 16 x 4 (f32) or
# x 1 (int8) + h_scale 24 x 3 x 4 (int8) + conv 24 x 3 x 1536 x 2 (bf16)
# + pos 4.  The f32 runs go through Server (whose ServeConfig has no
# weight or step switch, as in repro), so their step_impl is the model
# config's: "auto" is K3 on the card.
SERVE_RUNS = (
    ("f32", "f32", "model", 2580484, "decode_step", None, "fused"),
    ("int8", "int8", "model", 811300, "decode_step_q", None, "fused"),
    ("int8", "f32", "model", 2580484, "decode_step_int8a", None, "fused"),
    ("f32", "f32", "model", 2580484, "decode_step", "mamba_stacked_step",
     "auto"),
    ("int8", "int8", "model", 811300, "decode_step_q",
     "mamba_stacked_step_q_int8a", "megakernel"))


def phase_serve(model, cfg, params, run, dev, card):
    """bf16 serving of ``model`` with launch counts: 9 requests on 4
    slots, the f32 setup through ``Server``, the others through
    ``Engine``; every kernel count is set to 0 just before the measured
    run and read just after, and held to ``model``'s launches per
    admission and decode step; every slot must come back.  Returns the
    counts, the requests' tokens and the run's ``ServeStats`` summary."""
    import dataclasses
    from repro_torch.core import dispatch_count
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.metrics import ServeStats
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.serve import ServeConfig, Server
    wd, sd, kv, want_spb, step_k, k3_k, impl = run
    name = model["name"]
    max_new, lens = 32, (64, 127, 256, 512)
    if (wd, sd, kv) == ("f32", "f32", "model"):
        eng = Server(dataclasses.replace(cfg, step_impl=impl), params,
                     ServeConfig(batch_slots=4, max_seq=SERVE_MAX_SEQ,
                                 device=str(dev))).engine
    else:
        eng = Engine(cfg, params, EngineConfig(
            n_slots=4, max_seq=SERVE_MAX_SEQ, weight_dtype=wd,
            state_dtype=sd, kv_cache_dtype=kv, step_impl=impl,
            device=str(dev)))
    warm = SyntheticLM(cfg.vocab, 16, seed=3).batch_at(0, 0, 1, 2)["tokens"]
    for row in warm:                               # cuBLAS and library init
        eng.submit(row, max_new=4)
    eng.run()
    eng.stats = ServeStats()
    prompts = [SyntheticLM(cfg.vocab, L, seed=4).batch_at(0, 0, 1, 2)
               ["tokens"][i] for L in lens for i in range(2)]
    dispatch_count.reset()
    torch.cuda.synchronize()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    reqs.append(eng.submit(prompts[3], SamplingParams(
        temperature=0.8, top_k=40, seed=1234, max_new=max_new)))
    eng.run()
    torch.cuda.synchronize()
    snap = dispatch_count.snapshot()
    counts = {k: snap[k] for k in dispatch_count.COUNTERS}
    s = eng.stats
    n_step = model["ssm" if k3_k is None else "k3_rest"] * s.decode_steps
    want = {k: 0 for k in counts}
    want["selective_scan"] = model.get("scan", model["ssm"]) * s.prefill_calls
    want["flash_attention"] = model["attn"] * s.prefill_calls
    want["causal_conv1d"] = model["ssm"] * s.prefill_calls + n_step
    if step_k:
        want[step_k] = n_step
    for k in (k3_k,) if isinstance(k3_k, str) else k3_k or ():
        want[k] = model["k3"] * s.decode_steps
    setup = f"{wd} weights, {sd} state, {kv} kv, step_impl {impl!r}"
    log(f"  {name}, {setup}: admissions {s.prefill_calls}, pooled decode "
        f"steps {s.decode_steps}")
    for k in counts:
        ok = counts[k] == want[k]
        log(f"  launches {k:<26} {counts[k]:>6} (expected {want[k]})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{name} launch count {k} ({setup})")
    if s.decode_steps == 0:
        FAILURES.append(f"{name}: no decode step ran")
    plain = sum(v for k, v in snap.items() if k.startswith("plain "))
    log(f"  plain-version calls during serving: {plain}  "
        f"{'ok' if plain == 0 else 'FAIL'}")
    if plain:
        FAILURES.append(f"{name}: plain versions ran on the card")
    spb = eng.pool.state_bytes_per_slot()
    ok = spb == want_spb
    log(f"  state_bytes_per_slot {spb} (expected {want_spb}), slots per GiB "
        f"{eng.pool.slots_per_gb():.1f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{name} state_bytes_per_slot ({setup})")
    good = all(r.finished and len(r.tokens) == max_new
               and all(0 <= t < cfg.vocab for t in r.tokens) for r in reqs)
    log(f"  9 requests finished with {max_new} in-vocab tokens each: "
        f"{'ok' if good else 'FAIL'}")
    if not good:
        FAILURES.append(f"{name} serve outputs ({setup})")
    back = eng.pool.n_free == 4 and eng.pool.n_pinned == 0
    log(f"  every slot back ({eng.pool.n_free} of 4 free): "
        f"{'ok' if back else 'FAIL'}")
    if not back:
        FAILURES.append(f"{name} slots back ({setup})")
    smry = s.summary()
    log(f"  serve {name} bf16, {setup} on {card}: {smry['useful_tokens']} "
        f"tokens in {smry['wall_s']:.3f} s = {smry['tokens_per_s']:.1f} "
        f"tok/s; TTFT mean {smry['ttft_mean_s'] * 1e3:.1f} ms, p95 "
        f"{smry['ttft_p95_s'] * 1e3:.1f} ms; TPOT mean "
        f"{smry['tpot_mean_s'] * 1e3:.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return counts, [r.tokens for r in reqs], smry


def phase_serves(num, model, cfg, params, runs, dev, card, counts) -> bool:
    """Phase ``num``: each serve run of ``runs``.  Keeps in ``counts`` each
    kernel's launches from the first run that launched it (the run that
    serves it), prints each K3 run's token agreement with the per-layer
    run of its setup, and stops at the first failed run."""
    streams = {}
    for i, run in enumerate(runs):
        wd, sd, kv, impl = run[0], run[1], run[2], run[6]
        log(f"== phase {num}.{i + 1}: serve {model['name']} bf16, {wd} "
            f"weights, {sd} state, {kv} kv, step_impl {impl!r}")
        got, streams[wd, sd, kv, impl], _ = phase_serve(model, cfg, params,
                                                        run, dev, card)
        torch.cuda.empty_cache()
        for k, v in got.items():
            if v and not counts.get(k):
                counts[k] = v
        fused = streams.get((wd, sd, kv, "fused"))
        if impl != "fused" and fused:
            mega = streams[wd, sd, kv, impl]
            same = sum(a == b for f, m in zip(fused, mega)
                       for a, b in zip(f, m))
            total = sum(len(f) for f in fused)
            log(f"  token agreement with the per-layer run of this setup: "
                f"{same}/{total} = {same / total:.4f} (printed; greedy "
                f"streams in bf16 diverge after the first differing token)")
        if not phase_ok():
            return False
    return True


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


def bound_ms(nbytes, ops, flops=F32_FLOPS):
    """Least time for the work: the bytes over the HBM rate against the
    operations over the peak of their type (f32 unless ``flops`` says);
    returns (ms, "bytes"|"operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
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


def q_step_work(b, d, n, in_bytes):
    """Bytes and operations of one quantized-state step with int8 A: the
    payload in and out at one byte per state element, the (b, g) scales in
    and out, x, dt, z, B, C in and y out in the input type, A int8 with
    its (d,) scales, D f32.  Per (d, n) element the step's 7 operations
    plus the dequant multiply, the A dequant, |h'|, the max, the divide
    and the rounding: 13; per (b, d) the gate's 8."""
    g = -(-d // 512)
    nbytes = 2 * b * d * n + 2 * b * g * 4
    nbytes += (4 * b * d + 2 * b * n) * in_bytes + d * n + 2 * d * 4
    return nbytes, 13 * b * d * n + 8 * b * d


def conv_work(b, L, d, k, in_bytes):
    """x and x_prev in, y and the (b, k-1, d) tail out, w and bias f32;
    k multiply-adds and the bias add per output."""
    nbytes = (2 * b * L * d + 2 * b * (k - 1) * d) * in_bytes
    nbytes += (k * d + d) * 4
    return nbytes, 2 * k * b * L * d + b * L * d


def device_time(fn, reps):
    """(ms, method): the device time of one call from a CUDA graph replay
    ("graph"), or, where stream capture refuses the call, from CUDA events
    around back-to-back calls ("events", which holds the host's launch
    cost too where that exceeds the device work)."""
    try:
        return device_ms(fn, reps), "graph"
    except RuntimeError as e:
        log(f"  stream capture refused ({str(e).splitlines()[0][:120]}): "
            f"timed with events")
        torch.cuda.synchronize()
        return time_ms(fn, 10 * reps), "events"


def measure(name, shape, kernel, plain, library, work, reps,
            flops=F32_FLOPS):
    """One timing row: the kernel's device time (CUDA graph replay, or
    events where capture is refused: ``timing`` says which), eager
    per-call time and device kernels a call (``graph_kernels`` of the
    card tests' helpers), its
    plain version's and the library call's device times,
    and the bound from ``work`` = (bytes, operations) with the
    operations at ``flops``."""
    bms, by = bound_ms(*work, flops)
    ms, how = device_time(kernel, reps)
    row = dict(shape=shape, ms=ms, timing=how,
               device_kernels=(shared_inputs().graph_kernels(kernel)
                               if how == "graph" else None),
               eager_ms=time_ms(kernel, 10 * reps),
               plain_ms=device_time(plain, 1 if reps <= 10 else 10)[0],
               bound_ms=bms, bound_by=by,
               library_ms=None if library is None else device_ms(library,
                                                                 reps))
    lib_txt = "-" if library is None else f"{row['library_ms']:.4f}"
    log(f"  {name:<15} {row['ms']:.4f} ms ({how}; eager "
        f"{row['eager_ms']:.4f}; {row['device_kernels']} device kernels "
        f"a call)  bound {bms:.4f} ms ({by})  plain "
        f"{row['plain_ms']:.4f} ms  library {lib_txt} ms  [{shape}]")
    return row


# the designs of the kernels rebuilt under rule 2, named in the kernels line
DESIGNS = {
    "causal_conv1d": "one launch writes y and the (b, k-1, d) tail; 8 "
    "channels (16-byte loads) and up to 8 time steps a thread, the taps, "
    "bias and a sliding window of the k-1 previous inputs in registers",
    "flash_attention": "bf16 on the tensor cores: wgmma for Q.K^T (smem "
    "operands) and P.V (P from registers, V through the transpose bit), a "
    "producer warp's TMA ring of 3 K/V stages, the softmax of S(t) "
    "overlapping P.V(t-1); 64-row query tiles of (position, head) pairs "
    "over the query heads of one KV head, a light and a heavy tile paired "
    "in a block; f32 the SIMT kernel",
    "fast_exp": "16-byte vectors (4 f32 or 8 bf16), 2 a thread loaded "
    "before either is computed, streaming loads and stores, one block a "
    "chunk of 256 x 2 vectors, at most 32 registers (8 blocks an SM); the "
    "unaligned head, the tail and a differently aligned x and y in a "
    "scalar loop of the same launch",
    "mlstm_stacked_run": "3 grid barriers a layer in blocks of 256 "
    "threads (255 registers): A LayerNorm + up column tiles of 32, no "
    "split, the conv and SiLU in the epilogue; C' one item per (head, "
    "16-row tile of C) for all slots, its wq/wk columns and C rows staged "
    "in shared memory by cp.async, q and k for its rows, the gates, the "
    "cell (int8/fp8 C requantized per row, the quotient from the scale's "
    "reciprocal and one fused correction), the tile's partials, the last "
    "of 8 tiles summing them; E each (64-column tile, row range) item "
    "computes the y of its rows from the 4 group sums (D's work) while its "
    "down tile comes in, the last range sums the partials in order and "
    "adds the residual; arrival counters zeroed in A, no float atomics",
    "piecewise_silu": "K8's memory design; the range detected first: the "
    "count of breaks at or below x picks one row of a coefficient table in "
    "shared memory (three 4-byte reads) and one quadratic is evaluated "
    "('paper': its segment's constants by selects, one evaluation)",
}


DESIGNS["mlstm_stacked_run_q_int8w"] = DESIGNS["mlstm_stacked_run"]
DESIGNS["decode_step_q"] = (
    "one thread-block cluster of 8 blocks per (slot, 512-channel scale "
    "group), launched with cudaLaunchKernelEx: 64 channels a block, 512 "
    "threads, 16 lanes a channel, 2 passes; each warp's absmax of h' by "
    "shuffles, pushed into the 8 blocks' shared memory (mapa, "
    "st.shared::cluster: 128 remote stores a block), one cluster barrier, "
    "then each warp takes the max of the 128 from its own shared memory "
    "and every thread computes s_out with update_scale and encodes its "
    "block's channels; a relaxed arrival at launch makes sure every peer "
    "has started before the stores; each value's arithmetic as the "
    "12-block design's, so its bits")
DESIGNS["decode_step"] = (
    "4 lanes a channel, 4 consecutive states a lane, 32 channels a block of "
    "128 threads, one block a (slot, 32 channels): one 16-byte load of h, "
    "one 16-byte load of f32 A (4 bytes of int8 codes and the channel's "
    "scale), one 16-byte store of h'; x, dt, z and D one broadcast load for "
    "the 4 lanes, B and C 4 scalar loads a lane, every load issued before "
    "the first arithmetic (one trip to memory); the sum over the states in "
    "the order of the 16-lane butterfly (2 shuffle exchanges of 4 values, "
    "2 adds in the lane), the rounding pinned to that design's, so y and h' "
    "keep its bits")
DESIGNS["decode_step_int8a"] = DESIGNS["decode_step"]
DESIGNS["slstm_stacked_run"] = (
    "its own kernel: blocks of 256 threads, all of an SM's shared memory, "
    "Args __grid_constant__, 2 grid barriers a layer, no scratch, no "
    "counters; every block puts its own loads in flight (x, the norm's "
    "scale and bias, h, its cells' inputs), then issues its items' R and "
    "wx strips (one cp.async group) and out tile (another), the next "
    "layer's as soon as this layer's are read; phase 1 items (head, tile "
    "of 8 columns) for all four gates: LN(x), the four wx and R column "
    "strips, pre = round(gx) + R h + bias, the cell of those columns; "
    "phase 2 items (8-column tiles of out): the group norm of h' (a warp a "
    "(slot, head), fixed order), out's columns and the residual; weights "
    "decoded and rounded on the integer pipes; where the tiles do not fit, "
    "each GEMV streams them through one buffer")
DESIGNS["slstm_stacked_run_int8w"] = DESIGNS["slstm_stacked_run"]
DESIGNS["selective_scan"] = (
    "a chunked scan in one launch: time cut into 32 segments (16 for calls "
    "wider than the card holds at once), one thread a (channel, segment) "
    "with the channel's 16 states in registers; every segment but the last "
    "folds its steps into (prod dA, h from zero), each segment combines "
    "the pairs before it in order from h0 and reruns its steps writing y "
    "and the gate; each step's dA the same exp_impl(dt A) in both passes; "
    "B and C in 16-byte words where the rows allow")
DESIGNS["mamba_stacked_step"] = (
    "one block of 512 threads an SM, 4 grid barriers a layer (5 with an "
    "int8/fp8 state), phases A-D as the first design's; each dense weight "
    "one panel of columns a block (the grid's share rounded up to 16 "
    "bytes, one round), streamed into a ring of 32 KB shared-memory slots "
    "by 2-D TMA (a tensor map a weight and layer, encoded once a stack), "
    "thread 0 refilling each slot as soon as it is read with the item a "
    "ring further on, across phases and layers; weights whose rows are no "
    "multiple of 16 bytes take a copy path into the same ring; the GEMV "
    "rows read their 4 slots' inputs in one 16-byte load, int8 codes and "
    "bf16 rounding on the integer and FMA pipes; norm scales read beside "
    "the rows, conv taps and the residual while the rows are summed")
DESIGNS["mamba_stacked_step_q_int8a"] = DESIGNS["mamba_stacked_step"]
DESIGNS["jamba_stacked_run"] = (
    "one block of 384 threads (168 registers) an SM, 5 grid barriers a "
    "position and one a launch: every dense layer a GEMV over (tile, row) "
    "units, whole tiles where they fill the grid (in_proj), else split "
    "over the blocks in one round (x_proj, out_proj, w1|w3, w2); 16-byte "
    "f32 loads (4 a lane), 8-byte int8 loads (8 codes a lane), in ping-pong "
    "batches, no bounds "
    "test in the loop, int8 codes and bf16 rounding on the integer pipes, "
    "the scales in registers; each block's inputs copied into shared "
    "memory at once; partial sums to scratch, the last block of a tile at "
    "an integer counter sums them in block order and runs the epilogue "
    "(conv + SiLU, rounding, SiLU(w1 x) * (w3 x), residual); x_proj's "
    "finishers count themselves done and the S6 items (a chunk of channels "
    "for all slots, dt_proj's columns, A's rows and the state staged by "
    "cp.async while they wait) take dt (each weight read once), the step "
    "and the gate; an int8/fp8 state's chunks meet at a counter per scale "
    "group and each encodes its own channels; counters zeroed in the "
    "launch, no float atomics")
DESIGNS["jamba_stacked_run_q_int8a"] = DESIGNS["jamba_stacked_run"]


def k3_work(cfg, b, int8, state_dtype, act_bytes):
    """Bytes and operations of one K3 call: every layer's weights read once
    at their storage width (int8 codes and their f32 scales), the state in
    and out (payload and scales), the conv tails in and out, x in and out;
    per layer and slot two operations per dense weight, 13 per state
    element (the step's 7 with the A dequant or exp, the quantized state's
    dequant, |h|, max, divide and rounding), the conv's 2 per tap and
    channel, 12 per channel (softplus, D skip, the SiLUs and gate) and 4
    per d_model entry (the norm and the residual add)."""
    from repro_torch.core import state_quant
    L, dm, di, n, r, k = (cfg.n_layers, cfg.d_model, cfg.d_inner,
                          cfg.d_state, cfg.dt_rank, cfg.d_conv)
    nx = r + 2 * n
    dense = dm * 2 * di + di * nx + r * di + di * dm
    wb = 1 if int8 else 4
    layer = (dense + di * n) * wb + (k * di + 3 * di + dm) * 4
    if int8:
        layer += (2 * di + nx + di + dm + di) * 4
    sb = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}[state_dtype]
    state = 2 * b * di * n * sb + 2 * b * (k - 1) * di * act_bytes
    if state_quant.is_quantized(state_dtype):
        state += 2 * b * state_quant.n_groups(di) * 4
    nbytes = L * (layer + state) + 2 * b * dm * act_bytes
    ops = L * b * (2 * dense + 13 * di * n + 2 * k * di + 12 * di + 4 * dm)
    return nbytes, ops


def phase_timing(cfg, dev, counts, errs):
    import torch.nn.functional as F
    from repro_torch.core import weight_quant
    from repro_torch.kernels import conv1d, decode_step, ref, selective_scan
    d, n, r, k = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {}

    # scan at prefill: b=1, h0=None (prefill starts from zero state), L=512
    # then the served prompt lengths 64, 127, 256 and jamba's d_inner 8192;
    # its bound is the larger of its bytes and its exponentials at the SFU
    # rate
    rows["selective_scan"] = []
    for L, ds in ((512, d), (64, d), (127, d), (256, d), (512, 8192)):
        x, dt, A, B, C, D, z, _ = scan_inputs(1, L, ds, n, r, bf, gen, dev,
                                              h0=False)
        nbytes, ops, exps = s6_work(1, L, ds, n, 2, False)
        row = measure(
            "selective_scan",
            f"b=1 L={L} d={ds} n=16 bf16, h0=None (prefill)",
            lambda: selective_scan.selective_scan(x, dt, A, B, C, D=D, z=z),
            lambda: ref.selective_scan(x, dt, A, B, C, D=D, z=z), None,
            (nbytes, ops), 10)
        t_exp = 1e3 * exps / SFU_PER_S
        if t_exp > row["bound_ms"]:
            row["bound_ms"], row["bound_by"] = t_exp, "operations"
            row["bound_note"] = "its exponentials at the SFU rate"
        log(f"  selective_scan L={L} d={ds}: bound {row['bound_ms']:.4f} ms "
            f"(exponentials at the SFU rate {t_exp:.4f} ms)")
        rows["selective_scan"].append(row)

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

    # decode step at 4 slots, f32 A and int8 A
    x, dt, A, B, C, D, z, h = scan_inputs(4, 1, d, n, r, bf, gen, dev)
    args = (h, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    rows["decode_step"] = [measure(
        "decode_step", "slots=4 d=1536 n=16 bf16, f32 state, f32 A",
        lambda: decode_step.selective_state_step(*args, D=D, z_t=z[:, 0]),
        lambda: ref.selective_state_step(*args, D=D, z_t=z[:, 0]), None,
        s6_work(4, 1, d, n, 2, True)[:2], 50)]
    A_q, a_scale = weight_quant.quantize_rows(A)
    args8 = (h, x[:, 0], dt[:, 0], A_q, B[:, 0], C[:, 0])
    kw8 = dict(D=D, z_t=z[:, 0], a_scale=a_scale)
    nbytes, ops, _ = s6_work(4, 1, d, n, 2, True)
    rows["decode_step_int8a"] = [measure(
        "decode_step_int8a", "slots=4 d=1536 n=16 bf16, f32 state, int8 A",
        lambda: decode_step.selective_state_step(*args8, **kw8),
        lambda: ref.selective_state_step(*args8, **kw8), None,
        (nbytes - 3 * d * n, ops + d * n), 50)]

    # quantized-state step at 4 slots: int8 state with int8 A as served,
    # then fp8 state
    rows["decode_step_q"] = []
    for sd in ("int8", "fp8"):
        hq, h_scale = q_state(h, sd)
        argsq = (hq, h_scale, x[:, 0], dt[:, 0], A_q, B[:, 0], C[:, 0])
        kwq = dict(D=D, z_t=z[:, 0], state_dtype=sd, a_scale=a_scale)
        shape = decode_step.q_launch_shape(4, d)
        rows["decode_step_q"].append(measure(
            "decode_step_q",
            f"slots=4 d=1536 n=16 bf16, {sd} state, int8 A; grid "
            f"{shape['grid']} x {shape['threads']}, clusters of "
            f"{shape['cluster']}",
            lambda: decode_step.selective_state_step_q(*argsq, **kwq),
            lambda: ref.selective_state_step_q(*argsq, **kwq), None,
            q_step_work(4, d, n, 2), 50))

    # K3 at 4 slots, full width, bf16, as served in phase 4; then the
    # whole decode step (embed -> K3 -> norm_f -> unembed) against the
    # per-layer fused one on the same weights and cache
    import dataclasses
    from repro_torch.kernels import megakernel
    from repro_torch.models import registry
    gen = torch.Generator().manual_seed(SEED + 2)
    for (wd, sd), name in K3_KERNEL.items():
        c = dataclasses.replace(cfg, dtype="bfloat16", weight_dtype=wd,
                                state_dtype=sd)
        p = k3_params(c, wd, dev)
        x0, h, h_scale, conv = k3_inputs(c, 4, gen, dev)
        lc = megakernel.launch_config(c, torch.bfloat16, wd == "int8", dev)
        shape = (f"slots=4 L=24 d_model=768 bf16, {wd} weights, {sd} state; "
                 f"grid {lc['grid']} x {lc['threads']}, {lc['smem_bytes']} B "
                 f"shared")
        row = measure(
            name, shape,
            lambda: megakernel.mamba_stacked_step(c, x0, p["stack"], h,
                                                  h_scale, conv),
            lambda: ref.mamba_stacked_step(c, x0, p["stack"].layers, h,
                                           h_scale, conv), None,
            k3_work(c, 4, wd == "int8", sd, 2), 5)
        cache = registry.init_cache(c, 4, 64, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}
        for impl in ("megakernel", "fused"):
            ci = dataclasses.replace(c, step_impl=impl)
            step = (lambda ci=ci: registry.decode_step(ci, p, cache, batch))
            ms, how = device_time(step, 5)
            eager = time_ms(step, 20)
            tag = "whole_step" if impl == "megakernel" else "fused_step"
            row[tag + "_ms"], row[tag + "_timing"] = ms, how
            row[tag + "_eager_ms"] = eager
            log(f"  decode step at 4 slots, {wd} weights, {sd} state, "
                f"{impl}: {ms:.4f} ms device ({how}), {eager:.4f} ms eager")
        rows[name] = [row]

    meta = {
        "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                           "src/repro/kernels/selective_scan.py:43"),
        "causal_conv1d": ("src/repro_torch/csrc/conv1d.cu",
                          "src/repro/kernels/conv1d.py:21"),
        "decode_step": ("src/repro_torch/csrc/decode_step.cu",
                        "src/repro/kernels/decode_step.py:223"),
        "decode_step_int8a": ("src/repro_torch/csrc/decode_step.cu",
                              "src/repro/kernels/decode_step.py:223"),
        "decode_step_q": ("src/repro_torch/csrc/decode_step_q.cu",
                          "src/repro/kernels/decode_step.py:234"),
        "mamba_stacked_step": ("src/repro_torch/csrc/megakernel_mamba.cu",
                               "src/repro/kernels/decode_step.py:413"),
        "mamba_stacked_step_q_int8a": (
            "src/repro_torch/csrc/megakernel_mamba.cu",
            "src/repro/kernels/decode_step.py:413"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        main_row, *more = rows[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": counts[name],
                 "max_abs_err": errs[name], **main_row}
        if name in DESIGNS:
            entry["design"] = DESIGNS[name]
        if name == "decode_step_q":
            entry["launch"] = decode_step.q_launch_shape(4, d)
        elif name.startswith("decode_step"):
            entry["launch"] = decode_step.launch_shape(4, d)
        if "stacked" in name:
            instance = name.split("_")[0]
            entry["registers"] = {k: v for k, v in MAMBA_REGS.items()
                                  if k.startswith(instance)}
        if more:
            entry["other_shapes"] = more
        kernels.append(entry)
    return kernels


# ---------------------------------------------------------------------------
# xLSTM: xlstm-350m at full width and full depth
# ---------------------------------------------------------------------------

XLSTM = "xlstm-350m"
# K3-xLSTM's launch counters (core/dispatch_count.py names) by (kind,
# weights, state); the sLSTM state is f32 under every state_dtype
XLSTM_KERNEL = {("mlstm", "f32", "f32"): "mlstm_stacked_run",
                ("mlstm", "int8", "int8"): "mlstm_stacked_run_q_int8w",
                ("slstm", "f32", "f32"): "slstm_stacked_run",
                ("slstm", "int8", "int8"): "slstm_stacked_run_int8w"}
_XLSTM = {}


def xlstm_cfg(**kw):
    """xlstm-350m (24 layers, d_model 1024, 4 heads, vocab 50304) at full
    width and full depth, the conv through K5 (conv_impl "pallas")."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(XLSTM), conv_impl="pallas",
                               **kw)


def xlstm_params(dev):
    """The seeded f32 weights (246.8 M parameters), made once on the card."""
    from repro_torch.models import registry
    if "p" not in _XLSTM:
        t0 = time.perf_counter()
        _XLSTM["p"] = registry.init_params(xlstm_cfg(), seed=SEED,
                                           device=dev, draw_device=dev)
        torch.cuda.synchronize()
        log(f"  xlstm weights: {registry.count_params(xlstm_cfg())} "
            f"parameters drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
    return _XLSTM["p"]


# K3-xLSTM's tolerances against its plain version on the card.  f32, over
# the whole run: x, the f32 states and the conv tails to 1e-4, a bf16 C
# within a bf16 step (8e-3); an int8/fp8 C's codes within one, its scales
# to 1e-5 of themselves plus 1e-5 of the largest scale: a row's scale is
# its absmax, |i' k_d| max|v| for a fresh slot, and k_d is a 512-term f32
# dot summed in another order, whose absolute error a near-zero k_d
# carries as a large relative one; over a 7-layer run the residual stream
# reaching each layer differs by f32 ulps too.  bf16, layer by layer: a
# rounding that falls the other way moves what follows by a bf16 step, and
# the mLSTM block amplifies such a step from layer to layer (its h is
# normalised twice, by max(|n' q|, 1) and the group norm), so each layer
# of a run is held at its own input, the x the kernel's launch of the
# layers before it gave, by K3-mamba's bf16 rule: values to 2e-2 of
# themselves plus 2e-2 of the largest value; an int8/fp8 C dequantized as
# the others plus one code (1/127 of the largest value for int8, one e4m3
# step, 1/8 of the value, for fp8), its scales to 3e-2 of themselves plus
# 3e-2 of the largest (the sign and size of a small k_d move with a bf16
# rounding, and a row's codes with them).  The run's one launch is held bitwise to its
# layers launched one by one, and its end-to-end difference from the
# plain run is printed.
XLSTM_SCALE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def check_xlstm_run(name, cfg, kind, x1, outs, xr, want) -> float:
    """K3-xLSTM against ref.xlstm_stacked_run; returns x's max abs error."""
    from repro_torch.core import state_quant
    tol = K3_TOL[cfg.dtype]
    bf16 = cfg.dtype == "bfloat16"

    def near(tag, a, b, t):
        at = t * float(b.float().abs().max()) if bf16 else t
        return check(f"{name} {tag}", a, b, t, at)

    e = near("x", x1, xr, tol)
    for i, (a, b) in enumerate(zip(outs, want)):
        for key in sorted(a):
            if key in ("C", "C_scale"):
                continue
            near(f"[{i}] {key}", a[key], b[key], tol)
        if kind == "slstm":
            continue
        if cfg.state_dtype == "f32":
            near(f"[{i}] C", a["C"], b["C"], tol)
        elif cfg.state_dtype == "bf16":
            near(f"[{i}] C (bf16 step)", a["C"], b["C"], max(tol, 8e-3))
        else:
            st = XLSTM_SCALE_TOL[cfg.dtype]
            check(f"{name} [{i}] C_scale", a["C_scale"], b["C_scale"], st,
                  st * float(b["C_scale"].abs().max()))
            if bf16:
                d1 = state_quant.dequantize_mat(a["C"], a["C_scale"])
                d0 = state_quant.dequantize_mat(b["C"], b["C_scale"])
                top = float(d0.abs().max())
                fp8 = cfg.state_dtype == "fp8"
                check(f"{name} [{i}] C dequantized", d1, d0,
                      tol + (0.125 if fp8 else 0.0),
                      tol * top + (0.0 if fp8 else top / 127))
            else:
                codes = int((code_ordinals(a["C"]) - code_ordinals(b["C"]))
                            .abs().max())
                moved = float((a["C"].view(torch.uint8) != b["C"].view(
                    torch.uint8)).float().mean())
                ok = codes <= 1
                log(f"  {name + f' [{i}] C':<52} codes apart {codes} (tol "
                    f"1, share moved {moved:.1e})  {'ok' if ok else 'FAIL'}")
                if not ok:
                    FAILURES.append(f"{name} [{i}] C")
    return e


def check_xlstm_layers(name, cfg, kind, run, x0, states, x1, outs) -> float:
    """A bf16 run layer by layer: its layers launched one by one must give
    the run's one launch bit for bit, and each one-layer launch is held
    against the plain layer at the same input; returns x's largest max
    abs error over the layers."""
    from repro_torch.kernels import megakernel, ref
    xs, chain = [x0], []
    for row, st in zip(run.rows, states):
        one = megakernel.XlstmRun(cfg, kind, [row])
        out = {k: torch.empty_like(v) for k, v in st.items()}
        xs.append(megakernel.xlstm_stacked_run(cfg, xs[-1], one, [st],
                                               [out]))
        chain.append(out)
    torch.cuda.synchronize()
    same = torch.equal(xs[-1], x1) and all(
        torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))
        for a, b in zip(chain, outs) for k in a)
    log(f"  {name}: its {len(chain)} layers launched one by one give the "
        f"run's launch: {'bitwise equal' if same else 'FAIL'}")
    if not same:
        FAILURES.append(f"{name} one launch vs layer by layer")
    e = 0.0
    for i, (row, st) in enumerate(zip(run.rows, states)):
        xr, want = ref.xlstm_stacked_run(cfg, xs[i], kind, [row], [st])
        e = max(e, check_xlstm_run(f"{name} layer {i}", cfg, kind,
                                   xs[i + 1], [chain[i]], xr, want))
    return e


def check_xlstm_kernels(dev, serving):
    """Phase 2x: K3's mLSTM instance (a 7-layer run) and sLSTM instance (1
    layer) against ref.xlstm_stacked_run on the card at xlstm-350m's
    widths, 4 slots, f32 and bf16, f32 or int8 weights, every state type,
    every SiLU variant, a ragged pool of 3 slots; one launch repeated bit
    for bit."""
    from repro_torch.kernels import megakernel, ref
    xlstm_run_inputs = shared_inputs().xlstm_run_inputs
    seed = SEED + 200
    cases = []
    for kind, n in (("mlstm", 7), ("slstm", 1)):
        states = K3_STATES if kind == "mlstm" else ("f32",)
        for wd in ("f32", "int8"):
            for dtype in ("float32", "bfloat16"):
                cases += [(kind, n, 4, wd, dtype, sd, "exact")
                          for sd in states]
    cases += [("mlstm", 7, 4, "f32", dtype, "int8", silu)
              for silu in ("ours", "paper")
              for dtype in ("float32", "bfloat16")]
    cases += [("mlstm", 7, 3, "int8", "bfloat16", "int8", "exact"),
              ("slstm", 1, 3, "int8", "bfloat16", "f32", "exact")]
    for kind, n, slots, wd, dtype, sd, silu in cases:
        c = xlstm_cfg(dtype=dtype, weight_dtype=wd, state_dtype=sd,
                      silu_impl=silu)
        seed += 1
        run, x0, states, outs = xlstm_run_inputs(c, kind, n, slots,
                                                 seed=seed, device=dev)
        x1 = megakernel.xlstm_stacked_run(c, x0, run, states, outs)
        xr, want = ref.xlstm_stacked_run(c, x0, kind, run.rows, states)
        torch.cuda.synchronize()
        act = "f32" if dtype == "float32" else "bf16"
        name = (f"K3-{kind} L={n} slots={slots} {act} {wd} w {sd} state"
                + ("" if silu == "exact" else f" silu {silu}"))
        if act == "f32":
            e = check_xlstm_run(name, c, kind, x1, outs, xr, want)
        else:
            e = check_xlstm_layers(name, c, kind, run, x0, states, x1, outs)
            log(f"  {name}: the whole run against the plain run: x max_abs "
                f"{float((x1.float() - xr.float()).abs().max()):.3e} of "
                f"max {float(xr.float().abs().max()):.3e} (printed)")
        key = (kind, wd, "int8" if kind == "slstm" and wd == "int8" else sd)
        if (act == "bf16" and slots == 4 and silu == "exact"
                and key in XLSTM_KERNEL):
            serving[XLSTM_KERNEL[key]] = e
        del run, states, outs, want
    c = xlstm_cfg(dtype="bfloat16", weight_dtype="int8", state_dtype="int8")
    run, x0, states, outs = xlstm_run_inputs(c, "mlstm", 7, 4, seed=seed + 1,
                                             device=dev)
    a = megakernel.xlstm_stacked_run(c, x0, run, states, outs)
    first = [{k: v.clone() for k, v in o.items()} for o in outs]
    b = megakernel.xlstm_stacked_run(c, x0, run, states, outs)
    torch.cuda.synchronize()
    same = torch.equal(a, b) and all(
        torch.equal(u[k].view(torch.uint8), v[k].view(torch.uint8))
        for u, v in zip(first, outs) for k in u)
    log(f"  K3-mlstm L=7 bf16 int8 w int8 state, one launch repeated: "
        f"{'bitwise equal' if same else 'FAIL'}")
    if not same:
        FAILURES.append("K3-xLSTM repeat")


# the MARCA units' main path: ops.exp / ops.silu with backend "pallas" at
# every approximate variant, f32 and bf16, on 16 M elements
UNIT_N = 1 << 24
# the f32 sweep's chunk: 2^28 bit patterns, 1 GB
UNIT_SWEEP = 1 << 28


def unit_input(n, dtype, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(n, generator=gen) * 4.0 - 1.0).to(dev, dtype)


def unit_cases():
    """(counter name, variant, the kernel's wrapper, its plain version,
    the library call) of each approximate unit: K8's "ours" and "fast"
    biases, K9's "ours" and "paper" segments."""
    import torch.nn.functional as F
    ti = shared_inputs()
    return [("fast_exp" if op == "exp" else "piecewise_silu", impl,
             *ti.unit_fns(op, impl), torch.exp if op == "exp" else F.silu)
            for op, impl in ti.UNIT_IMPLS]


def check_unit_values(dev, sweep=True):
    """K8 and K9 against their plain versions on the card, bit for bit (a
    NaN against any NaN): the card tests' checks
    (``tests/_torch_inputs.py`` ``unit_value_mismatches``: every bf16
    bit pattern, +-0, +-inf, NaNs, subnormals, K8's clamp and each SiLU
    break with its f32 neighbours, K8's answer for NaN is ``repro``'s,
    sizes 1-17 and 1,000,003, views at each offset within a 16-byte
    vector, repeats, one device kernel a call), then every f32 bit
    pattern in chunks of 2^28 (``sweep``).  Prints K8's answer for NaN
    (0.0 with "fast", c with "ours")."""
    ti = shared_inputs()
    t0 = time.perf_counter()
    n0 = len(FAILURES)
    for op, impl in ti.UNIT_IMPLS:
        kern, _ = ti.unit_fns(op, impl)
        name = f"{'K8' if op == 'exp' else 'K9'} {impl}"
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            for line in ti.unit_value_mismatches(op, impl, dt, dev):
                log(f"  {name} {tag} {line}  FAIL")
                FAILURES.append(f"{name} {tag} {line}")
            if op == "exp":
                nan = torch.full((1,), float("nan"), device=dev, dtype=dt)
                log(f"  {name} {tag} exp(NaN) = {float(kern(nan)[0]):.6e}")
    log(f"  K8/K9: every bf16 pattern, special values, breaks, sizes "
        f"1-17 and 1000003, offsets, repeats: "
        f"{'bitwise equal' if len(FAILURES) == n0 else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not sweep:
        return
    t0 = time.perf_counter()
    cases = [(op, impl, *ti.unit_fns(op, impl)) for op, impl in ti.UNIT_IMPLS]
    ramp = torch.arange(UNIT_SWEEP, dtype=torch.int32, device=dev)
    bad = dict.fromkeys(ti.UNIT_IMPLS, 0)
    for c in range((1 << 32) // UNIT_SWEEP):
        start = c * UNIT_SWEEP - (1 << 32 if c * UNIT_SWEEP >= 1 << 31
                                  else 0)
        x = (ramp + start).view(torch.float32)
        for op, impl, kern, plain in cases:
            bad[op, impl] += ti.unit_mismatches(kern(x), plain(x))
        del x
    del ramp
    torch.cuda.empty_cache()
    for (op, impl), n in bad.items():
        name = f"{'K8' if op == 'exp' else 'K9'} {impl}"
        log(f"  {name} f32: every one of the 2^32 bit patterns "
            f"{'bitwise equal' if not n else f'{n} differ  FAIL'}")
        if n:
            FAILURES.append(f"{name} f32 sweep")
    log(f"  the f32 sweep took {time.perf_counter() - t0:.1f} s")


def check_units(dev, counts, serving):
    """Phase 2u: the main path of K8 and K9 (``ops.exp`` / ``ops.silu``
    with backend "pallas") driven once with the counts at 0, then each
    kernel held against its plain version, bitwise, at a ragged size and
    at 16 M elements, f32 and bf16, and over the values and shapes of
    ``check_unit_values``."""
    from repro_torch.core import dispatch_count
    from repro_torch.kernels import ops
    xs = [unit_input(UNIT_N, dt, SEED + 300 + i, dev)
          for i, dt in enumerate((torch.float32, torch.bfloat16))]
    torch.cuda.synchronize()
    dispatch_count.reset()
    for x in xs:
        for op, impl in shared_inputs().UNIT_IMPLS:
            getattr(ops, op)(x, impl, "pallas")
    torch.cuda.synchronize()
    snap = dispatch_count.snapshot()
    for name in ("fast_exp", "piecewise_silu"):
        counts[name] = snap[name]
        ok = snap[name] == 4
        log(f"  ops.exp/ops.silu backend 'pallas' main path: {name} "
            f"launches {snap[name]} (expected 4)  {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{name} launches on its main path")
    plain = sum(v for k, v in snap.items() if k.startswith("plain "))
    if plain:
        FAILURES.append("plain versions ran on the units' main path")
    worst = {"fast_exp": 0.0, "piecewise_silu": 0.0}
    for n in (1000003, UNIT_N):
        for i, dt in enumerate((torch.float32, torch.bfloat16)):
            x = unit_input(n, dt, SEED + 310 + i, dev)
            for name, impl, kern, plain_fn, _ in unit_cases():
                got, want = kern(x), plain_fn(x)
                torch.cuda.synchronize()
                bits = torch.int32 if dt == torch.float32 else torch.int16
                same = torch.equal(got.view(bits), want.view(bits))
                err = float((got.float() - want.float()).abs().max())
                worst[name] = max(worst[name], err)
                tag = "f32" if dt == torch.float32 else "bf16"
                log(f"  {name} {impl} n={n} {tag}: "
                    f"{'bitwise equal' if same else 'FAIL'} "
                    f"(max_abs_err {err:.3e})")
                if not same:
                    FAILURES.append(f"{name} {impl} n={n} {tag}")
    serving.update(worst)
    check_unit_values(dev)


# (weights, state, kv cache, logits tolerance, why, ties): each card-vs-CPU
# run of phase 3x.  With an int8/fp8 C the logits move by up to the
# tolerance, so greedy tokens may differ where the CPU's top two logits
# lie within it (ties True); f32 must agree on every token.
#: phase 3x's depth: at 24 layers the whole run took 1101 s on the H100
#: (the CPU references 60 s of it); 12 layers keep the sLSTM layer (7)
#: between two K3-mlstm runs (0-6, 8-11)
XLSTM_MODEL_LAYERS = 12
XLSTM_MODEL_RUNS = (
    ("f32", "f32", "model", 1e-3,
     "12 layers of f32 GEMVs and a 127-token f32 recurrence summed in "
     "another order on each side: the logits' difference grows with depth "
     "(3.2e-4 at 12 layers, 7.2e-4 at 24), so 24 layers' 2e-3 halved",
     False),
    ("int8", "int8", "model", 1e-1,
     "int8 weights dequantized the same way on both sides; a C value on a "
     "rounding boundary lands one code (1/127 of its row's absmax) apart, "
     "and h sums 512 such values a head, at every later step and layer; "
     "set by a code's size, not the depth (6.3e-2 at 12 layers, 7.7e-2 "
     "at 24)", True),
    ("f32", "fp8", "model", 3e-1,
     "as int8, with e4m3 codes: one code is 1/16 to 1/8 of a value (1.4e-1 "
     "at 12 layers, 2.1e-1 at 24)", True))
XLSTM_PROMPT = 127

# the launches of xlstm-350m served: each admission runs the conv (K5) of
# its 21 mLSTM layers, no scan and no attention; a decode step runs the 21
# convs per layer, or 3 launches of K3-mlstm and 3 of K3-slstm
XLSTM_SERVED = {"name": "xlstm-350m", "ssm": 21, "scan": 0, "attn": 0,
                "k3": 3, "k3_rest": 0}
# each serve run of phase 4x, as SERVE_RUNS; bytes per slot from repro's
# abstract cache (tests/test_torch_xlstm_engine.py): 21 mLSTM layers of C
# 4 x 512 x 512 (f32 or int8 + its f32 row scales 4 x 512), n 4 x 512,
# m 4, conv 3 x 2048 f32; 3 sLSTM layers of c, n, h, m 4 x 256 f32; pos
XLSTM_SERVE_RUNS = (
    ("f32", "f32", "model", 88818004, None, None, "fused"),
    ("f32", "f32", "model", 88818004, None,
     ("mlstm_stacked_run", "slstm_stacked_run"), "auto"),
    ("int8", "int8", "model", 22929748, None,
     ("mlstm_stacked_run_q_int8w", "slstm_stacked_run_int8w"),
     "megakernel"))


def xlstm_run_work(cfg, kind, n_layers, b, int8, state_dtype, act_bytes):
    """Bytes and operations of one K3-xLSTM call: every layer's weights
    read once at their storage width (int8 codes and their f32 scales for
    up/down or wx/out; wq, wk, R, the gates, norms and conv f32), the
    states in and out, x in and out.  Per layer and slot two operations
    per weight; mLSTM 6 per C element (f' C, k v, i' k v, the add, the
    multiply-add of C'^T q) and 5 more for an int8/fp8 C (dequant, |C'|,
    max, divide, round), 2 per conv tap and channel and 18 per channel
    (gate dots, SiLUs, group norm, gate, h); sLSTM 25 per channel (the
    cell and group norm); 6 per d_model entry (the norm, the residual)."""
    d, nh, k = cfg.d_model, cfg.n_heads, cfg.d_conv
    wb = 1 if int8 else 4
    sb = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}[state_dtype]
    if kind == "mlstm":
        di = 2 * d
        dh = di // nh
        dense = d * 2 * di + di * d
        f32w = 2 * nh * dh * dh + k * di + 2 * nh * dh + 2 * nh + di + 2 * d
        layer = dense * wb + f32w * 4 + ((2 * di + d) * 4 if int8 else 0)
        state = 2 * b * (nh * dh * dh * sb + di * 4 + nh * 4
                         + (k - 1) * di * 4)
        if state_dtype in ("int8", "fp8"):
            state += 2 * b * nh * dh * 4
        per_c = 6 + (5 if state_dtype in ("int8", "fp8") else 0)
        ops = b * (2 * (dense + 2 * nh * dh * dh) + per_c * nh * dh * dh
                   + (2 * k + 18) * di + 6 * d)
    else:
        dh = d // nh
        dense = d * 4 * d + d * d
        f32w = 4 * nh * dh * dh + 4 * d + d + 2 * d
        layer = dense * wb + f32w * 4 + ((4 * d + d) * 4 if int8 else 0)
        state = 2 * b * 4 * d * 4
        ops = b * (2 * (dense + 4 * nh * dh * dh) + 25 * d + 6 * d)
    nbytes = n_layers * (layer + state) + 2 * b * d * act_bytes
    return nbytes, n_layers * ops


def phase_xlstm_timing(dev, counts, errs):
    """Phase 5x: K3-mlstm (a 7-layer run) and K3-slstm beside their bounds
    and plain versions at 4 slots, bf16, as served; K8 and K9 beside
    torch.exp / F.silu on 16 M elements; the whole xLSTM decode step
    through K3 against the per-layer one; the per-token prefill loop."""
    import dataclasses
    from repro_torch.kernels import megakernel, ref
    from repro_torch.models import registry, xlstm
    xlstm_run_inputs = shared_inputs().xlstm_run_inputs
    rows = {}
    params = xlstm_params(dev)
    for (kind, wd, sd), name in XLSTM_KERNEL.items():
        n = 7 if kind == "mlstm" else 1
        c = xlstm_cfg(dtype="bfloat16", weight_dtype=wd, state_dtype=sd)
        run, x0, states, outs = xlstm_run_inputs(c, kind, n, 4,
                                                 seed=SEED + 400, device=dev)
        lc = megakernel.xlstm_launch_config(c, kind, torch.bfloat16,
                                            wd == "int8", dev)
        row = measure(
            name, f"{n} {kind} layer(s), slots=4, d_model=1024 bf16, {wd} "
            f"weights, {sd} state; grid {lc['grid']} x {lc['threads']}, "
            f"{lc['smem_bytes']} B shared",
            lambda: megakernel.xlstm_stacked_run(c, x0, run, states, outs),
            lambda: ref.xlstm_stacked_run(c, x0, kind, run.rows, states),
            None, xlstm_run_work(c, kind, n, 4, wd == "int8", sd, 2), 5)
        rows[name] = [row]
        del run, states, outs
        if kind == "slstm":
            continue
        p = registry.quantize_params(c, params)
        cache = registry.init_cache(c, 4, 64, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}
        # the K3 runs and the tied unembed's f32 (vocab, d_model) read
        nbytes = sum(xlstm_run_work(c, k, len(r), 4, wd == "int8", sd, 2)[0]
                     for k, r in xlstm._kind_runs(c))
        row["whole_step_bound_ms"] = bound_ms(
            nbytes + c.vocab * c.d_model * 4, 0)[0]
        for impl in ("megakernel", "fused"):
            ci = dataclasses.replace(c, step_impl=impl)
            pi = registry.stack_params(ci, p) if impl == "megakernel" else p
            step = (lambda ci=ci, pi=pi: registry.decode_step(ci, pi, cache,
                                                              batch))
            ms, how = device_time(step, 3)
            eager = time_ms(step, 10)
            tag = "whole_step" if impl == "megakernel" else "fused_step"
            row[tag + "_ms"], row[tag + "_timing"] = ms, how
            row[tag + "_eager_ms"] = eager
            log(f"  xlstm-350m decode step at 4 slots, {wd} weights, {sd} "
                f"state, {impl}: {ms:.4f} ms device ({how}), {eager:.4f} ms "
                f"eager (bound {row['whole_step_bound_ms']:.4f} ms)")
        del p, cache
    # the plain per-token prefill loop, bf16 as served, one prompt of 127
    c = xlstm_cfg()
    toks = torch.arange(XLSTM_PROMPT, device=dev)[None] % c.vocab
    cache = registry.init_cache(c, 1, XLSTM_PROMPT, device=dev)
    registry.prefill(c, params, cache, {"tokens": toks[:, :8]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    registry.prefill(c, params, cache, {"tokens": toks})
    torch.cuda.synchronize()
    per_tok = 1e3 * (time.perf_counter() - t0) / XLSTM_PROMPT
    rows["mlstm_stacked_run"][0]["prefill_ms_per_token"] = per_tok
    log(f"  xlstm-350m prefill of {XLSTM_PROMPT} tokens (bf16, plain "
        f"per-token recurrence loop, K5 conv): {per_tok:.3f} ms per token")
    # K8 and K9 on 16 M elements, f32 and bf16, beside torch.exp / F.silu
    for name, impl, kern, plain_fn, lib in unit_cases():
        for dt, eb in ((torch.float32, 4), (torch.bfloat16, 2)):
            x = unit_input(UNIT_N, dt, SEED + 320, dev)
            tag = "f32" if dt == torch.float32 else "bf16"
            ops_per = 4 if name == "fast_exp" else 8
            rows.setdefault(name, []).append(measure(
                name, f"n=16777216 {tag}, {impl}",
                lambda x=x, kern=kern: kern(x),
                lambda x=x, plain_fn=plain_fn: plain_fn(x),
                lambda x=x, lib=lib: lib(x),
                (2 * UNIT_N * eb, ops_per * UNIT_N), 20))
    meta = {
        "mlstm_stacked_run": "marca_megakernel_mlstm",
        "mlstm_stacked_run_q_int8w": "marca_megakernel_mlstm",
        "slstm_stacked_run": "marca_megakernel_slstm",
        "slstm_stacked_run_int8w": "marca_megakernel_slstm",
    }
    kernels = []
    for name in meta:
        main_row, *more = rows[name]
        kind = name.split("_")[0]
        extra = {"design": DESIGNS[name],
                 "registers": {k: v for k, v in XLSTM_REGS.items()
                               if k.startswith(kind)}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/megakernel_xlstm.cuh",
            "replaces": "src/repro/kernels/decode_step.py:413",
            "launches": counts[name], "max_abs_err": errs[name],
            **main_row, **extra})
    for name, rep in (("fast_exp", "src/repro/kernels/fast_exp.py:26"),
                      ("piecewise_silu",
                       "src/repro/kernels/piecewise_silu.py:26")):
        main_row, *more = rows[name]
        unit = "fast_exp" if name == "fast_exp" else "silu"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/approx_units.cu",
            "replaces": rep, "launches": counts[name],
            "max_abs_err": errs[name], **main_row, "other_shapes": more,
            "design": DESIGNS[name],
            "sass": {k: v for k, v in UNIT_SASS.items()
                     if k.startswith(unit)}})
    return kernels


# ---------------------------------------------------------------------------
# Jamba: jamba-v0.1-52b at full width, one group of 8 layers
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"
BF16_FLOPS = 989e12
_JAMBA = {}
# K3-jamba's launch counters (core/dispatch_count.py names) by (weights,
# state)
JAMBA_KERNEL = {("f32", "f32"): "jamba_stacked_run",
                ("int8", "int8"): "jamba_stacked_run_q_int8a"}


def jamba_cfg(**kw):
    """jamba-v0.1-52b cut from 32 layers to one group of 8 (the 16
    experts and every width kept), prefill attention through K7."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(JAMBA), n_layers=8,
                               scan_impl="pallas", conv_impl="pallas",
                               attn_impl="pallas", **kw)


def jamba_params(dense: bool, dev):
    """The seeded weights of the MoE model (53 GB in f32) or of its dense
    variant (n_experts 0, 10.9 GB), drawn on the card from a CUDA
    generator, made once."""
    from repro_torch.models import registry
    key = "dense" if dense else "moe"
    if key not in _JAMBA:
        cfg = jamba_cfg(n_experts=0) if dense else jamba_cfg()
        t0 = time.perf_counter()
        _JAMBA[key] = registry.init_params(cfg, seed=SEED, device=dev,
                                           draw_device=dev)
        torch.cuda.synchronize()
        log(f"  {key} weights: {registry.count_params(cfg)} parameters "
            f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    return _JAMBA[key]


def jamba_free(key):
    import gc
    _JAMBA.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()


def shared_inputs():
    """The card tests' input builders and helpers
    (``tests/_torch_inputs.py``)."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import _torch_inputs
    return _torch_inputs


def check_k7_case(name, hq, hkv, dh, lq, lk, dtype, tol, gen, dev) -> float:
    """K7 against ref.attention on the card at b=1, random q, k, v from
    ``gen``, within ``tol``; the launch counted once, repeated bit for
    bit, one device kernel a call.  Returns the largest error."""
    from repro_torch.kernels import flash_attention, ref
    q = torch.randn(1, lq, hq, dh, generator=gen).to(dev, dtype)
    k = torch.randn(1, lk, hkv, dh, generator=gen).to(dev, dtype)
    v = torch.randn(1, lk, hkv, dh, generator=gen).to(dev, dtype)
    n0 = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=True)
    launched = flash_attention.launches - n0
    want = ref.attention(q, k, v, causal=True)
    again = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    e = check(name, got, want, tol, tol)
    same = torch.equal(got, again)
    nk = shared_inputs().graph_kernels(
        lambda: flash_attention.flash_attention(q, k, v, causal=True))
    ok = same and nk == 1 and launched == 1
    log(f"  {name}: {launched} launch counted, repeated "
        f"{'bitwise equal' if same else 'DIFFERENT'}, {nk} device kernel(s) "
        f"a call  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{name} count / repeat / one kernel")
    return e


def check_jamba_kernels(dev, serving):
    """K7 against ref.attention and K3's jamba instance against
    ref.jamba_stacked_run on the card, at jamba-v0.1's widths."""
    from repro_torch.kernels import megakernel, ref
    jamba_run_inputs = shared_inputs().jamba_run_inputs
    gen = torch.Generator().manual_seed(SEED + 5)
    # K7: b=1, 32 query heads over 8 kv heads of 128, as jamba's prefill;
    # repro's flash tolerances (2e-5 f32, 3e-2 bf16: the output rounds)
    # (bf16 on the tensor cores: also lengths no multiple of its 64-key
    # and 16-position tiles, on one and two warpgroups a block, each
    # launch repeated bit for bit)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        ragged = (((65, 65), (200, 200), (37, 300), (500, 700))
                  if tag == "bf16" else ())
        for lq, lk in ((64, 64), (127, 127), (512, 512), (64, 512),
                       *ragged):
            what = "suffix " if lq < lk else ""
            e = check_k7_case(f"K7 {tag} {what}lq={lq} lk={lk} hq=32 hkv=8 "
                              f"dh=128", 32, 8, 128, lq, lk, dtype, tol, gen,
                              dev)
            if tag == "bf16" and lq == lk == 512:
                serving["flash_attention"] = e
    # K3's jamba instance: one position, or four (the length of the dense
    # plan's first run), each a mamba block + MLP drawn on the card, 4
    # slots
    seed = SEED + 100
    for wd in ("f32", "int8"):
        for n_pos in (1, 4):
            for dtype in ("float32", "bfloat16"):
                for sd in ("f32", "int8", "fp8"):
                    c = jamba_cfg(n_experts=0, dtype=dtype, weight_dtype=wd,
                                  state_dtype=sd)
                    seed += 1
                    run, x0, states, outs = jamba_run_inputs(
                        c, n_pos, 4, seed=seed, device=dev)
                    x1 = megakernel.jamba_stacked_run(c, x0, run, states,
                                                      outs)
                    xr, want = ref.jamba_stacked_run(c, x0, run.rows, states)
                    torch.cuda.synchronize()
                    act = "f32" if dtype == "float32" else "bf16"
                    name = (f"K3-jamba {n_pos} pos {act} {wd} w {sd} "
                            f"state")
                    for i, (a, b) in enumerate(zip(outs, want)):
                        e = check_k3(f"{name} [{i}]", c,
                                     (x1, a["h"], a.get("h_scale"),
                                      a["conv"]),
                                     (xr, b["h"], b.get("h_scale"),
                                      b["conv"]))
                    if (n_pos == 1 and act == "bf16"
                            and (wd, sd) in JAMBA_KERNEL):
                        serving[JAMBA_KERNEL[wd, sd]] = e
                    del run, states, outs, want
    c = jamba_cfg(n_experts=0, dtype="bfloat16", weight_dtype="int8",
                  state_dtype="int8")
    run, x0, states, outs = jamba_run_inputs(c, 4, 4, seed=seed + 1,
                                             device=dev)
    a = megakernel.jamba_stacked_run(c, x0, run, states, outs)
    first = [{k: v.clone() for k, v in o.items()} for o in outs]
    b = megakernel.jamba_stacked_run(c, x0, run, states, outs)
    torch.cuda.synchronize()
    same = torch.equal(a, b) and all(
        torch.equal(u[k].view(torch.uint8), v[k].view(torch.uint8))
        for u, v in zip(first, outs) for k in u)
    log(f"  K3-jamba 4 pos bf16 int8 w int8 state, one launch repeated: "
        f"{'bitwise equal' if same else 'FAIL'}")
    if not same:
        FAILURES.append("K3-jamba repeat")


# (weights, state, kv cache, logits tolerance, why): the dense variant's
# card-vs-CPU runs
JAMBA_MODEL_RUNS = (
    ("f32", "f32", "model", 2e-3,
     "f32 throughout; the kernels sum in another order and nvcc contracts "
     "multiply-adds, over 8 layers at d_model 4096"),
    ("int8", "int8", "int8", 2e-2,
     "as mamba's int8 state: a value on a rounding boundary may land one "
     "code apart on the card, and feeds every later step"),
)

JAMBA_SERVED = {"name": "jamba-v0.1-52b (8 layers)", "ssm": 7, "attn": 1,
                "k3": 3, "k3_rest": 4}
# each serve run of jamba's 16-expert model, as SERVE_RUNS; bytes per
# slot at max_seq 576 from repro's abstract_cache: 7 x (h 8192 x 16 x 4 +
# conv 3 x 8192 x 2) + k, v 576 x 1024 x 2 + pos 4 (f32 state, bf16 KV),
# or 7 x (8192 x 16 + 16 x 4 + 49152) + 2 x 576 x (1024 + 4) + 4 (int8)
JAMBA_SERVE_RUNS = (
    ("f32", "f32", "model", 6373380, "decode_step", None, "fused"),
    ("f32", "f32", "model", 6373380, "decode_step", "jamba_stacked_run",
     "auto"),
    ("int8", "int8", "int8", 2446276, "decode_step_q",
     "jamba_stacked_run_q_int8a", "megakernel"),
)


def flash_work(b, lq, lk, hq, hkv, dh, in_bytes):
    """Bytes (q, k, v in, o out) and operations of one causal call: per
    (query, key) pair the causal mask keeps and per head, 2 dh for q.k,
    2 dh for p.v and 4 for the softmax (scale, max, exp, sum)."""
    nbytes = (2 * b * lq * hq * dh + 2 * b * lk * hkv * dh) * in_bytes
    pairs = sum(min(lk, i + lk - lq + 1) for i in range(lq))
    return nbytes, b * hq * pairs * (4 * dh + 4)


def jamba_run_work(cfg, n_pos, b, int8, state_dtype, act_bytes):
    """Bytes and operations of one K3-jamba call: k3_work's mamba layers
    plus each position's norm2 and MLP (w1, w3, w2 at their storage width,
    their scales), two operations per MLP weight and slot, 6 per hidden
    unit (SiLU, product) and 4 per d_model entry (norm2, residual)."""
    import dataclasses
    nbytes, ops = k3_work(dataclasses.replace(cfg, n_layers=n_pos), b, int8,
                          state_dtype, act_bytes)
    dm, ff = cfg.d_model, cfg.d_ff
    mlp = 3 * dm * ff
    nbytes += n_pos * (mlp * (1 if int8 else 4) + dm * 4
                       + ((2 * ff + dm) * 4 if int8 else 0))
    ops += n_pos * b * (2 * mlp + 6 * ff + 4 * dm)
    return nbytes, ops


def phase_jamba_timing(dev, counts, errs):
    """K7 and K3-jamba beside their bounds, K7 beside SDPA, and the whole
    jamba decode step (MoE, 16 experts) per layer and through K3."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, megakernel, ref
    from repro_torch.models import registry
    gen = torch.Generator().manual_seed(SEED + 6)
    rows = {"flash_attention": []}
    for L in (512, 127, 64):
        q = torch.randn(1, L, 32, 128, generator=gen).to(dev, torch.bfloat16)
        k = torch.randn(1, L, 8, 128, generator=gen).to(dev, torch.bfloat16)
        v = torch.randn(1, L, 8, 128, generator=gen).to(dev, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row = measure(
            "flash_attention", f"b=1 L={L} hq=32 hkv=8 dh=128 bf16 "
            "(prefill)",
            lambda: flash_attention.flash_attention(q, k, v, causal=True),
            lambda: ref.attention(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            flash_work(1, L, L, 32, 8, 128, 2), 20, flops=BF16_FLOPS)
        rows["flash_attention"].append(row)

    params = jamba_params(False, dev)
    jamba_run_inputs = shared_inputs().jamba_run_inputs
    for (wd, sd), name in JAMBA_KERNEL.items():
        c = jamba_cfg(dtype="bfloat16", weight_dtype=wd, state_dtype=sd,
                      kv_cache_dtype="int8" if sd == "int8" else "model")
        p = registry.quantize_params(c, params)
        run, x0, states, outs = jamba_run_inputs(c, 1, 4, seed=SEED + 6,
                                                 device=dev)
        lc = megakernel.launch_config(c, torch.bfloat16, wd == "int8", dev)
        row = measure(
            name, f"1 position (mamba + MLP), slots=4, d_model=4096 bf16, "
            f"{wd} weights, {sd} state; grid {lc['grid']} x {lc['threads']}, "
            f"{lc['smem_bytes']} B shared",
            lambda: megakernel.jamba_stacked_run(c, x0, run, states, outs),
            lambda: ref.jamba_stacked_run(c, x0, run.rows, states), None,
            jamba_run_work(c, 1, 4, wd == "int8", sd, 2), 5)
        cache = registry.init_cache(c, 4, 576, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}
        for impl in ("megakernel", "fused"):
            ci = dataclasses.replace(c, step_impl=impl)
            pi = registry.stack_params(ci, p) if impl == "megakernel" else p
            step = (lambda ci=ci, pi=pi: registry.decode_step(ci, pi, cache,
                                                              batch))
            ms, how = device_time(step, 2)
            eager = time_ms(step, 5)
            tag = "whole_step" if impl == "megakernel" else "fused_step"
            row[tag + "_ms"], row[tag + "_timing"] = ms, how
            row[tag + "_eager_ms"] = eager
            log(f"  jamba decode step at 4 slots (MoE, 16 experts), {wd} "
                f"weights, {sd} state, {impl}: {ms:.4f} ms device ({how}), "
                f"{eager:.4f} ms eager")
        rows[name] = [row]
        del p
    meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:27"),
        "jamba_stacked_run": ("src/repro_torch/csrc/megakernel_mamba.cuh",
                              "src/repro/kernels/decode_step.py:413"),
        "jamba_stacked_run_q_int8a": (
            "src/repro_torch/csrc/megakernel_mamba.cuh",
            "src/repro/kernels/decode_step.py:413"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        main_row, *more = rows[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": counts[name],
                 "max_abs_err": errs[name], **main_row}
        if name in DESIGNS:
            entry["design"] = DESIGNS[name]
        if "stacked" in name:
            instance = name.split("_")[0]
            entry["registers"] = {k: v for k, v in MAMBA_REGS.items()
                                  if k.startswith(instance)}
        if name == "flash_attention":
            entry["sass"] = SASS
        if more:
            entry["other_shapes"] = more
        kernels.append(entry)
    return kernels


# ---------------------------------------------------------------------------
# Transformers: qwen2-7b at full width and full depth, qwen2-moe-a2.7b at
# full width with its depth cut, and K7 at the family's head layouts
# ---------------------------------------------------------------------------

QWEN = "qwen2-7b"
QWEN_MOE = "qwen2-moe-a2.7b"
_TRANSFORMER = {}
# (archs, hq, hkv, dh): the zoo's transformer head layouts.  K7 packs P
# query heads of one KV head into a block, P the largest power of two
# dividing hq / hkv: 1 at qwen2-7b's group of 7, 16 at granite's MQA, 1
# with hq == hkv; dh 64 takes the 64-wide instantiation, dh 96 the
# 128-wide one padded
TRANSFORMER_LAYOUTS = (("qwen2-7b", 28, 4, 128), ("granite-20b", 48, 1, 128),
                       ("olmo-1b, qwen2-moe", 16, 16, 128),
                       ("musicgen-large", 32, 32, 64),
                       ("phi-3-vision", 32, 32, 96))
# the launches a served transformer makes: K7 once a layer an admission,
# no kernel in a decode step (its attention over the KV cache and every
# GEMM are plain PyTorch, as repro leaves them to XLA)
QWEN_SERVED = {"name": "qwen2-7b", "ssm": 0, "attn": 28, "k3": 0,
               "k3_rest": 0}
QWEN_MOE_SERVED = {"name": "qwen2-moe-a2.7b (8 layers)", "ssm": 0,
                   "attn": 8, "k3": 0, "k3_rest": 0}
# the prefix-cache run's depth (phase 4tp)
PREFIX_LAYERS = 4
QWEN_PREFIX_SERVED = {"name": f"qwen2-7b ({PREFIX_LAYERS} layers)", "ssm": 0,
                      "attn": PREFIX_LAYERS, "k3": 0, "k3_rest": 0}

# (weights, kv cache, logits tolerance, why): each card-vs-CPU run of 3t
TRANSFORMER_MODEL_RUNS = (
    ("f32", "model", 2e-3,
     "f32 throughout; cuBLAS and the CPU sum in another order, K7 against "
     "the plain attention, d_model 3584 (2048) and a 152064-word (151936) "
     "unembed"),
    ("int8", "int8", 2e-2,
     "an int8 KV code on a rounding boundary may land one code (1/127 of "
     "its position's absmax) apart on the card, and feeds every later "
     "position and layer"),
)


def transformer_cfg(arch, **kw):
    """``arch`` at full width, its other fields the zoo's but ``kw``; the
    prefill attention runs K7 under repro's default attn_impl
    ("chunked"), as under every name."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch), **kw)


def transformer_params(arch, n_layers, dev):
    """Seeded weights of ``arch`` cut to ``n_layers``, drawn on the card
    from a CUDA generator, made once (qwen2-7b's 28 layers: 30.5 GB in
    f32)."""
    from repro_torch.models import registry
    key = (arch, n_layers)
    if key not in _TRANSFORMER:
        cfg = transformer_cfg(arch, n_layers=n_layers)
        t0 = time.perf_counter()
        _TRANSFORMER[key] = registry.init_params(cfg, seed=SEED, device=dev,
                                                 draw_device=dev)
        torch.cuda.synchronize()
        log(f"  {arch} ({n_layers} layers): {registry.count_params(cfg)} "
            f"parameters drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
    return _TRANSFORMER[key]


def transformer_free():
    import gc
    _TRANSFORMER.clear()
    gc.collect()
    torch.cuda.empty_cache()


def layer_view(params, n):
    """The first ``n`` layers of a model tree whose ``layers`` is a list
    (a transformer's, xLSTM's); no weight copied."""
    return {**params, "layers": params["layers"][:n]}


def kv_slot_bytes(cfg, kv, max_seq=SERVE_MAX_SEQ):
    """A transformer slot's bytes from its config: k and v of L x max_seq
    positions x hkv * dh at the model dtype's width, or one byte each
    plus an f32 scale a position for an int8 KV cache; and pos."""
    width = cfg.n_kv_heads * cfg.head_dim
    per_pos = (width + 4 if kv == "int8" else
               width * torch.finfo(getattr(torch, cfg.dtype)).bits // 8)
    return 2 * cfg.n_layers * max_seq * per_pos + 4


def phase_seconds(num, t0):
    log(f"  phase {num}: {time.perf_counter() - t0:.1f} s")


def check_transformer_k7(dev):
    """K7 against ref.attention on the card at each transformer head
    layout, f32 and bf16, L 64/127/512 and a suffix (64 over 512), at
    repro's flash tolerances (``check_k7_case``).  Returns each layout's
    largest bf16 error."""
    gen = torch.Generator().manual_seed(SEED + 7)
    errs = {}
    for label, hq, hkv, dh in TRANSFORMER_LAYOUTS:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            tag = "f32" if dtype == torch.float32 else "bf16"
            for lq, lk in ((64, 64), (127, 127), (512, 512), (64, 512)):
                what = "suffix " if lq < lk else ""
                e = check_k7_case(f"K7 {tag} {what}{lq}/{lk} {hq}/{hkv}x{dh} "
                                  f"{label}", hq, hkv, dh, lq, lk, dtype, tol,
                                  gen, dev)
                if tag == "bf16":
                    errs[label] = max(errs.get(label, 0.0), e)
    return errs


def phase_transformer_model(name, cfg, p32, runs, dev, lp=127):
    """A full-width f32 transformer: the kernel path on the card against
    the plain path on the CPU, on the same weights (``p32`` on the card,
    quantized per run, then copied to the CPU) and tokens
    (teacher-forced): prefill ``lp`` + 8 decode steps, for each (weights,
    kv cache, tolerance, why) of ``runs``.  Held: the logits; the final
    f32 KV cache to the tolerance; an int8 one's codes within one of the
    CPU's, layer 0's scales (computed from the same embeddings) to f32
    rounding and every layer's to the tolerance; the positions; greedy
    tokens equal but where the CPU's top two logits lie within the
    tolerance."""
    import dataclasses
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    steps = 8
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, lp + steps, seed=2)
                           .batch_at(0, 0, 1, 1)["tokens"], dtype=torch.int64)
    cpu = torch.device("cpu")
    for wd, kv, tol, why in runs:
        c = dataclasses.replace(cfg, dtype="float32", weight_dtype=wd,
                                kv_cache_dtype=kv)
        p_dev = registry.quantize_params(c, p32)
        p_cpu = registry.tree_to(p_dev, cpu)
        out_of = {}
        for side, where, p in (("card", dev, p_dev), ("cpu", cpu, p_cpu)):
            t = toks.to(where)
            cache = registry.init_cache(c, 1, lp + steps, device=where)
            t0 = time.perf_counter()
            logits, cache = registry.prefill(c, p, cache,
                                             {"tokens": t[:, :lp]})
            out = [logits[0]]
            for s in range(steps):
                logits, cache = registry.decode_step(
                    c, p, cache, {"tokens": t[:, lp + s:lp + s + 1]})
                out.append(logits[0])
            out = torch.cat(out).cpu()
            log(f"  {name} {wd} weights, {kv} kv, {side}: prefill {lp} + "
                f"{steps} decode steps in {time.perf_counter() - t0:.2f} s")
            out_of[side] = (out, registry.tree_to(cache, cpu))
        (lg, cg), (lc, cc) = out_of["card"], out_of["cpu"]
        tag = f"{name} {wd} w {kv} kv"
        log(f"  {tag}: logits held to {tol:g}: {why}")
        check(f"{tag} logits (card vs CPU)", lg, lc, tol, tol)
        for key in ("k", "v"):
            if kv != "int8":
                check(f"{tag} final {key} cache (card vs CPU)", cg[key],
                      cc[key], tol, tol)
                continue
            apart = int((cg[key].int() - cc[key].int()).abs().max())
            same = float((cg[key] == cc[key]).float().mean())
            note(f"{tag} {key} codes within one of the CPU's (max {apart} "
                 f"apart, {same:.6f} equal)", apart <= 1)
            sg, sc = cg[key + "_scale"], cc[key + "_scale"]
            rel = (sg - sc).abs() / sc.clamp_min(1e-30)
            first, every = float(rel[0].max()), float(rel.max())
            note(f"{tag} {key}_scale: layer 0 max rel diff {first:.3e} "
                 f"(<= 1e-5), every layer {every:.3e} (<= {tol:g})",
                 first <= 1e-5 and every <= tol)
        note(f"{tag} positions {cg['pos'].tolist()} equal the CPU's",
             torch.equal(cg["pos"], cc["pos"]))
        differ = lg.argmax(-1) != lc.argmax(-1)
        top2 = lc.topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1])[differ]
        note(f"{tag}: greedy token agreement over {lg.shape[0]} positions "
             f"{1.0 - float(differ.float().mean()):.4f}, a differing token "
             f"only where the CPU's top two logits are within {tol:g} "
             f"(margins {margins.tolist()})", bool((margins <= tol).all()))
        del p_dev, p_cpu, out_of


def phase_transformer_serves(num, model, cfg, params, runs, dev, card,
                             counts):
    """Phase ``num``: ``phase_serve`` for each (weights, kv cache) of
    ``runs`` (f32/model through ``Server``, the others through
    ``Engine``), step_impl "auto" (the per-layer step: no K3 for this
    family), the bytes a slot from the config (``kv_slot_bytes``); each
    engine freed before the next.  Prints each later run's greedy
    agreement with the first.  Returns (ok, each run's summary)."""
    import gc
    streams, summaries = [], []
    for i, (wd, kv) in enumerate(runs):
        t0 = time.perf_counter()
        via = "Server" if (wd, kv) == ("f32", "model") else "Engine"
        log(f"== phase {num}.{i + 1}: serve {model['name']} bf16, {wd} "
            f"weights, {kv} kv, step_impl 'auto' ({via})")
        run = (wd, "f32", kv, kv_slot_bytes(cfg, kv), None, None, "auto")
        got, toks, smry = phase_serve(model, cfg, params, run, dev, card)
        streams.append(toks)
        summaries.append(smry)
        gc.collect()
        torch.cuda.empty_cache()
        counts[num, wd, kv] = got["flash_attention"]
        if i:
            same = sum(a == b for f, m in zip(streams[0], toks)
                       for a, b in zip(f, m))
            total = sum(len(f) for f in streams[0])
            log(f"  greedy agreement with the {runs[0][0]} weights, "
                f"{runs[0][1]} kv run: {same}/{total} = {same / total:.4f} "
                f"(printed; streams diverge after the first differing "
                f"token)")
        phase_seconds(f"{num}.{i + 1}", t0)
        if not phase_ok():
            return False, summaries
    return True, summaries


def phase_transformer_timing(dev, summaries):
    """K7 at qwen2-7b's and granite's head layouts beside SDPA and the
    bound (CUDA-graph replay); the qwen2-7b decode step at 4 slots (CUDA
    graph, f32 weights and bf16 KV, int8 weights and int8 KV); the
    prefill per prompt token (events); phase 4t's untraced serving
    throughput.  Returns K7's rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models import registry
    gen = torch.Generator().manual_seed(SEED + 8)
    rows = []
    for label, hq, hkv in ((QWEN, 28, 4), ("granite-20b", 48, 1)):
        for L in (512, 127, 64):
            q = torch.randn(1, L, hq, 128, generator=gen).to(dev,
                                                            torch.bfloat16)
            k = torch.randn(1, L, hkv, 128, generator=gen).to(dev,
                                                             torch.bfloat16)
            v = torch.randn(1, L, hkv, 128, generator=gen).to(dev,
                                                             torch.bfloat16)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            rows.append(measure(
                "flash_attention", f"b=1 L={L} hq={hq} hkv={hkv} dh=128 bf16 "
                f"({label} prefill)",
                lambda: flash_attention.flash_attention(q, k, v, causal=True),
                lambda: ref.attention(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                flash_work(1, L, L, hq, hkv, 128, 2), 20, flops=BF16_FLOPS))
    params = transformer_params(QWEN, 28, dev)
    for wd, kv in (("f32", "model"), ("int8", "int8")):
        c = transformer_cfg(QWEN, weight_dtype=wd, kv_cache_dtype=kv)
        p = registry.quantize_params(c, params)
        cache = registry.init_cache(c, 4, SERVE_MAX_SEQ, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}

        def step(c=c, p=p, cache=cache, batch=batch):
            return registry.decode_step(c, p, cache, batch)

        ms, how = device_time(step, 2)
        eager = time_ms(step, 5)
        log(f"  {QWEN} decode step at 4 slots, bf16, {wd} weights, {kv} kv, "
            f"max_seq {SERVE_MAX_SEQ} (per layer): {ms:.4f} ms device "
            f"({how}), {eager:.4f} ms eager")
        del p, cache
    c = transformer_cfg(QWEN)
    for L in (512, 127):
        cache = registry.init_cache(c, 1, SERVE_MAX_SEQ, device=dev)
        toks = {"tokens": torch.randint(0, c.vocab, (1, L), generator=gen)
                .to(dev)}
        ms = time_ms(lambda: registry.prefill(c, params, cache, toks), 3)
        log(f"  {QWEN} prefill of {L} tokens, bf16, f32 weights: {ms:.3f} ms "
            f"(events), {ms / L:.4f} ms a prompt token")
    for (wd, kv), smry in zip((("f32", "model"), ("int8", "int8")),
                              summaries):
        log(f"  {QWEN} serving (phase 4t, untraced), {wd} weights, {kv} kv: "
            f"{smry['tokens_per_s']:.1f} tok/s")
    return rows


# ---------------------------------------------------------------------------
# Speculative decoding (phases 3s, 4s, 4xs, 4js; the windows of 3x and 3j)
# ---------------------------------------------------------------------------

SPEC_K = 4
# (weights, state, tolerance) of each verify-window run: phase 3's
SPEC_WINDOW_RUNS = (("f32", "f32", 2e-3), ("int8", "int8", 2e-2))
# the tie rule's tolerance on a bf16 served run's logits: a bf16 rounding
# step is 2^-8 of a value, and a full-depth draft through K3 and the
# target's per-layer window sum 24 layers' GEMVs and residuals in
# another order, so a draft and the target may rank two tokens whose
# logits lie this close either way
SPEC_BF16_TIE = 0.25


def tie_agreement(tag, got, want, tol) -> float:
    """Greedy agreement of two (positions, V) logit sets under the tie
    rule: a differing argmax only where ``want``'s top two logits are
    within ``tol`` (margins printed).  Returns the agreement."""
    differ = got.argmax(-1) != want.argmax(-1)
    agree = 1.0 - float(differ.float().mean())
    top2 = want.topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1])[differ]
    ok = bool((margins <= tol).all())
    log(f"  {tag}: greedy agreement over {differ.numel()} positions "
        f"{agree:.4f} (a differing token only where the reference's top two "
        f"logits are within {tol:g}; margins {margins.tolist()})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{tag} greedy agreement")
    return agree


def check_spec_state(tag, got, want, tol, dequant):
    """One verify step's state ({"h"} + "h_scale" + "conv", or any state
    leaves) against a reference: an int8/fp8 payload within one code and
    its scales to ``tol`` of themselves (max printed), the dequantized
    state and every other leaf within ``tol``."""
    for k in got:
        if k.endswith("_scale"):
            continue
        if got[k].dtype in (torch.int8, torch.float8_e4m3fn):
            s = k + "_scale"
            codes = int((code_ordinals(got[k]) - code_ordinals(want[k]))
                        .abs().max())
            rel = float(((got[s] - want[s]).abs()
                         / want[s].abs().clamp_min(1e-30)).max())
            ok = codes <= 1 and rel <= tol
            log(f"  {tag + ' ' + k:<52} codes apart {codes} (tol 1), scales "
                f"max rel diff {rel:.3e} (tol {tol:g})  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"{tag} {k}")
            check(f"{tag} {k} dequantized", dequant(got[k], got[s]),
                  dequant(want[k], want[s]), tol, tol)
        else:
            check(f"{tag} {k}", got[k], want[k], tol, tol)


def phase_spec_window(name, cfg, p32, runs, dev, state_of, dequant=None,
                      lp=127, slots=4, starts=(0, 3, 6), chained=False):
    """The verify window of ``name`` at full width in f32: prefill ``lp``
    tokens on ``slots`` slots on the card, then from each start (the
    state after that many teacher-forced decode steps) one window of
    SPEC_K + 1 tokens, held against the CPU's window from the same state
    (logits, and every step's ``state_of(cache)``); with ``chained``
    also against the card's chained per-layer decode steps (logits,
    every step's whole cache) and the rollback select of one step per
    slot against the chained cache of that step; with the tie rule's
    greedy agreement printed and held.  ``runs``: (weights, state,
    tolerance)."""
    import dataclasses
    from repro_torch.core import state_quant
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    dequant = dequant or state_quant.dequantize_h
    K1 = SPEC_K + 1
    total = lp + max(starts) + K1
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, total, seed=7).batch_at(
        0, 0, 1, slots)["tokens"], dtype=torch.int64).to(dev)
    cpu = torch.device("cpu")
    for wd, sd, tol in runs:
        c = dataclasses.replace(cfg, dtype="float32", weight_dtype=wd,
                                state_dtype=sd, step_impl="fused")
        p = registry.tree_to(registry.quantize_params(c, p32), dev)
        p_cpu = registry.tree_to(p, cpu)
        _, cache = registry.prefill(c, p, registry.init_cache(
            c, slots, total, device=dev), {"tokens": toks[:, :lp]})
        done = 0
        for start in starts:
            for s in range(done, start):
                _, cache = registry.decode_step(
                    c, p, cache, {"tokens": toks[:, lp + s:lp + s + 1]})
            done = start
            win = toks[:, lp + start:lp + start + K1]
            tag = f"{name} {wd} w {sd} state, start {start}"
            t0 = time.perf_counter()
            logits, steps = registry.verify_scan(c, p, cache, win)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            lc, sc = registry.verify_scan(c, p_cpu, registry.tree_to(
                cache, cpu), win.cpu())
            log(f"  {tag}: window of {K1} tokens on {slots} slots, card "
                f"{ms:.1f} ms; held to {tol:g} (phase 3's)")
            logits = logits.cpu()
            check(f"{tag} window logits (card vs CPU)", logits, lc, tol, tol)
            for t in range(K1):
                check_spec_state(
                    f"{tag} step {t} (card vs CPU)",
                    state_of(registry.tree_to(
                        registry.tree_map(lambda v: v[t], steps), cpu)),
                    state_of(registry.tree_map(lambda v: v[t], sc)),
                    tol, dequant)
            tie_agreement(f"{tag} window vs CPU window", logits, lc, tol)
            if not chained:
                continue
            lch, sch = registry.verify_chain(c, p, cache, win)
            lch = lch.cpu()
            check(f"{tag} window logits (vs chained steps)", logits, lch,
                  tol, tol)
            for t in range(K1):
                check_spec_state(
                    f"{tag} step {t} (vs chained steps)",
                    registry.tree_to(registry.tree_map(
                        lambda v: v[t], steps), cpu),
                    registry.tree_to(registry.tree_map(
                        lambda v: v[t], sch), cpu), tol, dequant)
            tie_agreement(f"{tag} window vs chained steps", logits, lch, tol)
            idx = torch.arange(slots, device=dev) % K1
            sel = registry.tree_to(registry.select_step(c, steps, idx), cpu)
            want = registry.tree_to(registry.tree_zip(
                lambda ax, v: torch.stack([
                    v[int(i)].select(ax, s) for s, i in enumerate(idx)], ax),
                registry.cache_slot_axes(c), sch), cpu)
            check_spec_state(f"{tag} select_step {idx.tolist()} (vs chained)",
                             sel, want, tol, dequant)
            # the window's conv (K5 with the tail passed in) writes the
            # last per-step tail, bitwise
            check_window_tail(tag, c, p, cache, win)
        del p, p_cpu, cache, steps, sc


def check_window_tail(tag, c, p, cache, win):
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, mamba
    lp = p["layers"][0]
    x = blocks.embed_apply(c, p["embed"], win, torch.float32)
    x_in, _ = mamba._project(c, lp["mixer"], blocks.apply_norm(
        c, lp["norm"], x))
    _, tail = ops.causal_conv1d(x_in, lp["mixer"]["conv_w"],
                                lp["mixer"]["conv_b"],
                                x_prev=cache["conv"][0])
    want = mamba._conv_tail_states(cache["conv"][0], x_in)[:, -1]
    same = torch.equal(tail, want)
    log(f"  {tag}: K5's tail over the window == the last per-step tail: "
        f"{'bitwise equal' if same else 'FAIL'}")
    if not same:
        FAILURES.append(f"{tag} window conv tail")


def check_k3_eight(cfg, dev):
    """K3 at the spec pool's 8 rows (4 live + 4 scratch), full width: the
    target's 24 layers and the draft's view of the first 12 (its own
    MambaStack), f32 and bf16, f32 weights and state and int8 weights with
    an int8 state, against the plain version on the card."""
    import dataclasses
    from repro_torch.kernels import megakernel, ref
    from repro_torch.models import registry
    gen = torch.Generator().manual_seed(SEED + 9)
    for wd, sd in (("f32", "f32"), ("int8", "int8")):
        p = k3_params(cfg, wd, dev)
        for layers in (cfg.n_layers, SPEC_LAYERS):
            c = dataclasses.replace(cfg, weight_dtype=wd, state_dtype=sd)
            stack = p["stack"]
            if layers < cfg.n_layers:
                c = registry.draft_config(c, layers)
                stack = registry.stack_params(
                    c, registry.draft_params(cfg, p, layers))["stack"]
            for dtype in ("float32", "bfloat16"):
                ci = dataclasses.replace(c, dtype=dtype)
                x0, h, h_scale, conv = k3_inputs(ci, 8, gen, dev)
                got = megakernel.mamba_stacked_step(ci, x0, stack, h,
                                                    h_scale, conv)
                want = ref.mamba_stacked_step(ci, x0, stack.layers, h,
                                              h_scale, conv)
                torch.cuda.synchronize()
                act = "f32" if dtype == "float32" else "bf16"
                check_k3(f"K3 8 slots L={layers} {act} {wd} w {sd} state",
                         ci, got, want)


# (weights, state, draft layers, decode-step kernel, K3 kernel, bytes per
# slot): each run of phase 4s, all with step_impl "auto" (K3 drafts on
# the card, the verify window runs per layer)
SPEC_LAYERS = 12
SPEC_RUNS = (
    ("f32", "f32", SPEC_LAYERS, "decode_step", "mamba_stacked_step",
     2580484),
    ("int8", "int8", SPEC_LAYERS, "decode_step_q",
     "mamba_stacked_step_q_int8a", 811300),
    ("f32", "f32", 24, "decode_step", "mamba_stacked_step", 2580484))
XLSTM_SPEC_RUNS = (
    ("f32", "f32", SPEC_LAYERS, None,
     ("mlstm_stacked_run", "slstm_stacked_run"), 88818004),)
JAMBA_SPEC_RUNS = (
    ("f32", "f32", 8, "decode_step", "jamba_stacked_run", 6373380),)


def spec_want(cfg, dcfg, s, step_k, k3_k):
    """The launches a spec serve run must make, from the engine's own
    counters: A admissions, P passes, D draft steps (the sum of the
    passes' windows k_eff), W = D + P verified tokens, S plain decode
    steps (a burst where every slot needs one token).  Everything runs
    under step_impl "auto": a draft step and a plain step through K3 (a
    jamba MoE position through its conv and step kernels per token), the
    verify per layer: a mamba block's window is one conv and W / P step
    launches, a jamba MoE position chains both per token, an mLSTM
    block's window one conv and its recurrence in PyTorch."""
    A, P, D = s.prefill_calls, s.spec_passes, s.spec_draft_steps
    W = D + P
    S = s.decode_steps - W
    want = collections.Counter()
    if cfg.family == "mamba":
        L = cfg.n_layers
        want["selective_scan"] = L * A
        want["causal_conv1d"] = L * A + L * P
        want[step_k] = L * W
        want[k3_k] = D + S
    elif cfg.family == "xlstm":
        from repro_torch.models import xlstm
        M = sum(1 for i in range(cfg.n_layers) if not xlstm._is_slstm(cfg, i))
        want["causal_conv1d"] = M * A + M * P
        for kind, name in zip(("mlstm", "slstm"), k3_k):
            want[name] = sum(k == kind for k, _ in xlstm._kind_runs(dcfg)) * D
            want[name] += sum(k == kind for k, _ in xlstm._kind_runs(cfg)) * S
    else:
        from repro_torch.models import jamba
        kinds = [jamba._pos_kind(cfg, i) for i in range(jamba._period(cfg))]
        G = jamba._n_groups(cfg)
        ssm = sum(not a for a, _ in kinds)
        pure = sum(not a and not m for a, m in kinds)
        moe = sum(not a and m for a, m in kinds)
        runs = sum(k == "mega" for k, _ in jamba._megakernel_plan(cfg))
        want["selective_scan"] = G * ssm * A
        want["flash_attention"] = G * (len(kinds) - ssm) * A
        want["causal_conv1d"] = G * (ssm * A + moe * (D + S) + pure * P
                                     + moe * W)
        want[step_k] = G * (moe * (D + S) + (pure + moe) * W)
        want[k3_k] = G * runs * (D + S)
    return want


def spec_prompts(cfg, lens):
    """8 prompts, as many of each length in ``lens``, 32 new tokens each;
    the 4th and 7th sampled (temperature 0.8, top_k 40), the others greedy
    with their top two logprobs kept for the tie rule."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.sampling import SamplingParams
    per = 8 // len(lens)
    prompts = [row for L in lens for row in SyntheticLM(
        cfg.vocab, L, seed=4).batch_at(0, 0, 1, per)["tokens"]]
    return [(p, SamplingParams(temperature=0.8, top_k=40, seed=1234 + i,
                               max_new=32) if i in (3, 6) else
             SamplingParams(max_new=32, logprobs=True, top_logprobs=2))
            for i, p in enumerate(prompts)]


def spec_serve_one(eng, cfg, traffic):
    """Warm ``eng`` up, then serve ``traffic`` with every launch count at 0
    just before and read just after.  Returns (requests, counts, stats)."""
    from repro_torch.core import dispatch_count
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.metrics import ServeStats
    warm = SyntheticLM(cfg.vocab, 16, seed=3).batch_at(0, 0, 1, 2)["tokens"]
    for row in warm:
        eng.submit(row, max_new=6)
    eng.run()
    eng.stats = ServeStats()
    dispatch_count.reset()
    torch.cuda.synchronize()
    reqs = [eng.submit(p, sp) for p, sp in traffic]
    eng.run()
    torch.cuda.synchronize()
    return reqs, dispatch_count.snapshot(), eng.stats


def spec_full_depth_ties(tag, passes, tol):
    """A full-depth draft accepts every greedy proposal but at ties: each
    rejected greedy draft token's target logprob lies within ``tol`` of
    the target's best (a token outside the target's top 5 fails)."""
    margins, sampled_rej = [], 0
    for p in passes:
        for s in p["live"]:
            i = int(p["n_acc"][s])
            if i >= int(p["limit"][s]):
                continue
            if p["temperature"][s] > 0:
                sampled_rej += 1
                continue
            d = int(p["drafts"][i, s])
            ids = p["ti"][i, s].tolist()
            tv = p["tv"][i, s]
            margins.append(float(tv[0] - tv[ids.index(d)]) if d in ids
                           else float("inf"))
    ok = all(m <= tol for m in margins)
    log(f"  {tag}: full-depth draft, greedy rejections {len(margins)} with "
        f"target margins {margins} (each must be a tie, within {tol:g}); "
        f"sampled rejections {sampled_rej} (printed)  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{tag} full-depth acceptance")


def phase_spec_serves(num, cfg, params, runs, lens, dev, card, spec_counts):
    """Phase ``num``: for each run, the plain engine and the spec engine
    (DraftConfig(k=SPEC_K, layers)) of one setup on the same traffic (8
    requests on 4 slots, prompts of ``lens``), bf16, step_impl "auto".
    The spec run's launches are held to ``spec_want``, no plain version
    may run, every scratch lease must come back and the bytes a slot
    must be the run's; tok/s of both, tokens per pass, the acceptance
    rate and the greedy agreement with the plain run are printed.
    Keeps in ``spec_counts`` each kernel's launches from the first spec
    run that launched it."""
    import dataclasses
    import numpy as np
    from repro_torch.core import dispatch_count
    from repro_torch.models import registry
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.spec_decode import DraftConfig
    name = f"{cfg.name} (L={cfg.n_layers})"
    traffic = spec_prompts(cfg, lens)
    for i, (wd, sd, layers, step_k, k3_k, want_spb) in enumerate(runs):
        setup = (f"{wd} weights, {sd} state, draft k={SPEC_K} "
                 f"layers={layers}")
        log(f"== phase {num}.{i + 1}: spec serve {name} bf16, {setup}, "
            f"step_impl 'auto'")
        common = dict(n_slots=4, max_seq=SERVE_MAX_SEQ, weight_dtype=wd,
                      state_dtype=sd, step_impl="auto", device=str(dev))
        plain = Engine(cfg, params, EngineConfig(**common))
        preqs, _, ps = spec_serve_one(plain, cfg, traffic)
        del plain
        eng = Engine(cfg, params, EngineConfig(
            **common, draft=DraftConfig(k=SPEC_K, layers=layers)))
        passes, real = [], eng._spec.verify

        def verify(prm, cache, x0, d_toks, d_logits, active, sp, step, lim,
                   real=real, passes=passes):
            out = real(prm, cache, x0, d_toks, d_logits, active, sp, step,
                       lim)
            passes.append({"live": np.flatnonzero(active), "drafts": d_toks,
                           "n_acc": out[1], "limit": lim, "tv": out[5],
                           "ti": out[6], "temperature": sp["temperature"]})
            return out

        eng._spec.verify = verify
        reqs, snap, s = spec_serve_one(eng, cfg, traffic)
        passes = passes[len(passes) - s.spec_passes:]
        want = spec_want(eng.cfg, eng._spec.dcfg, s, step_k, k3_k)
        plain_steps = s.decode_steps - s.spec_passes - s.spec_draft_steps
        log(f"  {name}, {setup}: admissions {s.prefill_calls}, passes "
            f"{s.spec_passes}, draft steps {s.spec_draft_steps}, decode "
            f"steps {s.decode_steps} ({plain_steps} in plain bursts)")
        for k in dispatch_count.COUNTERS:
            ok = snap[k] == want[k]
            if snap[k] or want[k] or not ok:
                log(f"  launches {k:<26} {snap[k]:>6} (expected {want[k]})  "
                    f"{'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"{name} spec launch count {k} ({setup})")
            if snap[k] and not spec_counts.get(k):
                spec_counts[k] = snap[k]
        if s.spec_passes == 0 or s.spec_draft_steps == 0:
            FAILURES.append(f"{name} ({setup}): no speculative pass ran")
        plain_calls = sum(v for k, v in snap.items() if k.startswith("plain "))
        scratch = eng.pool.n_scratch_free == eng.pool.n_scratch == 4
        spb = eng.pool.state_bytes_per_slot()
        good = all(r.finished and len(r.tokens) == 32
                   and all(0 <= t < cfg.vocab for t in r.tokens) for r in reqs)
        for label, ok in (
                (f"plain-version calls {plain_calls}", plain_calls == 0),
                (f"scratch leases back ({eng.pool.n_scratch_free} of "
                 f"{eng.pool.n_scratch} free)", scratch),
                (f"state_bytes_per_slot {spb} (expected {want_spb})",
                 spb == want_spb),
                (f"{len(reqs)} requests finished with 32 in-vocab tokens",
                 good)):
            log(f"  {label}  {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"{name} spec {label.split(' (')[0]} "
                                f"({setup})")
        if layers == cfg.n_layers and cfg.family == "mamba":
            spec_full_depth_ties(f"{name} {setup}", passes, SPEC_BF16_TIE)
        same = sum(a == b for r, q in zip(reqs, preqs)
                   if r.params.temperature == 0
                   for a, b in zip(r.tokens, q.tokens))
        n = sum(len(q.tokens) for q in preqs if q.params.temperature == 0)
        sp_, pp_ = s.summary(), ps.summary()
        log(f"  serve {name} bf16, {setup} on {card}: spec "
            f"{sp_['useful_tokens']} tokens in {sp_['wall_s']:.3f} s = "
            f"{sp_['tokens_per_s']:.1f} tok/s against plain "
            f"{pp_['tokens_per_s']:.1f} tok/s ({pp_['wall_s']:.3f} s); "
            f"accepted per pass {sp_['spec_accepted_per_pass']:.3f}, "
            f"acceptance rate {sp_['spec_acceptance_rate']:.3f}; TTFT mean "
            f"{sp_['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
            f"{sp_['tpot_mean_s'] * 1e3:.2f} ms; greedy agreement with the "
            f"plain run {same}/{n} (printed: bf16)")
        del eng
        torch.cuda.empty_cache()
        if not phase_ok():
            return False
    return True


def time_verify(cfg, params, dev):
    """Device time of one verify pass (the window of SPEC_K + 1 tokens over
    the spec pool's 8 rows, per layer) against SPEC_K + 1 plain decode
    steps through K3 and through the per-layer path, bf16, f32 weights
    and state, on one cache."""
    import dataclasses
    from repro_torch.models import registry
    c = dataclasses.replace(cfg, dtype="bfloat16")
    p = registry.stack_params(c, registry.tree_to(params, dev))
    cache = registry.init_cache(c, 8, 64, device=dev)
    win = torch.arange(8 * (SPEC_K + 1), device=dev).reshape(8, -1) % c.vocab
    out = {}

    def chain(ci):
        cc = cache
        for t in range(SPEC_K + 1):
            _, cc = registry.decode_step(ci, p, cc,
                                         {"tokens": win[:, t:t + 1]})

    for label, fn in (
            ("verify window", lambda: registry.verify_scan(c, p, cache, win)),
            ("plain K3 steps", lambda: chain(dataclasses.replace(
                c, step_impl="megakernel"))),
            ("plain per-layer steps", lambda: chain(dataclasses.replace(
                c, step_impl="fused")))):
        ms, how = device_time(fn, 3)
        out[label] = (ms, time_ms(fn, 10), how)
        log(f"  {label} ({SPEC_K + 1} tokens, 8 rows, bf16): {ms:.4f} ms "
            f"device ({how}), {out[label][1]:.4f} ms eager")
    return out


# ---------------------------------------------------------------------------
# The serving front: K3 at one row (the prefix cache's suffix chain and the
# prefill worker step one request at a time), the prefix cache, best-of-n,
# sessions, disaggregation, the SLO scheduler and the async front-end
# ---------------------------------------------------------------------------

def _row1(tree):
    """Row 1 of a two-slot input as its own one-slot input (row 0 of the
    kernel checks' inputs is a fresh slot: zero state)."""
    from repro_torch.models import registry
    return registry.tree_map(lambda t: t[1:].contiguous(), tree)


def _same_bits(a, b) -> bool:
    from repro_torch.models import registry
    return all(torch.equal(u.view(torch.uint8), v.view(torch.uint8))
               for u, v in zip(registry.tree_leaves(a),
                               registry.tree_leaves(b)) if u is not None)


def log_repeat(name, a, b):
    same = _same_bits(a, b)
    log(f"  {name}, one launch repeated: "
        f"{'bitwise equal' if same else 'FAIL'}")
    if not same:
        FAILURES.append(f"{name} repeat")


def check_k3_one(cfg, dev):
    """K3-mamba at one slot holding a used state, 24 layers at full width,
    f32 and bf16, f32 weights and state and int8 weights with an int8
    state, against its plain version (phase 2's tolerances); each bf16
    launch repeated bit for bit and timed beside 4 slots."""
    import dataclasses
    from repro_torch.kernels import megakernel, ref
    gen = torch.Generator().manual_seed(SEED + 11)
    for wd, sd in (("f32", "f32"), ("int8", "int8")):
        p = k3_params(cfg, wd, dev)
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype, weight_dtype=wd,
                                    state_dtype=sd)
            x0, h, h_scale, conv = k3_inputs(c, 2, gen, dev)
            x0 = x0[1:].contiguous()
            h, conv = h[:, 1:].contiguous(), conv[:, 1:].contiguous()
            h_scale = None if h_scale is None else h_scale[:, 1:].contiguous()
            got = megakernel.mamba_stacked_step(c, x0, p["stack"], h,
                                                h_scale, conv)
            want = ref.mamba_stacked_step(c, x0, p["stack"].layers, h,
                                          h_scale, conv)
            torch.cuda.synchronize()
            act = "f32" if dtype == "float32" else "bf16"
            name = f"K3 1 slot L={cfg.n_layers} {act} {wd} w {sd} state"
            check_k3(name, c, got, want)
            if act == "bf16":
                again = megakernel.mamba_stacked_step(c, x0, p["stack"], h,
                                                      h_scale, conv)
                torch.cuda.synchronize()
                log_repeat(name, got, again)
                times = {}
                for slots in (1, 4):
                    xi, hi, si, ci = k3_inputs(c, slots, gen, dev)
                    times[slots], how = device_time(
                        lambda: megakernel.mamba_stacked_step(
                            c, xi, p["stack"], hi, si, ci), 20)
                log(f"  K3 L={cfg.n_layers} bf16 {wd} w {sd} state: "
                    f"{times[1]:.4f} ms at 1 slot, {times[4]:.4f} ms at 4 "
                    f"slots (device, {how})")


def check_k3_one_xlstm(dev):
    """K3-mlstm (a 7-layer run) and K3-slstm (one layer) at one slot
    holding a used state, xlstm-350m's widths, f32 and bf16, f32/f32 and
    int8 weights (an int8 C for the mLSTM): phase 2x's rules (f32 over the
    run; bf16 layer by layer); each bf16 launch repeated bit for bit."""
    from repro_torch.kernels import megakernel, ref
    xlstm_run_inputs = shared_inputs().xlstm_run_inputs
    seed = SEED + 300
    for kind, n in (("mlstm", 7), ("slstm", 1)):
        for wd, sd in (("f32", "f32"), ("int8", "int8")):
            sd = sd if kind == "mlstm" else "f32"
            for dtype in ("float32", "bfloat16"):
                c = xlstm_cfg(dtype=dtype, weight_dtype=wd, state_dtype=sd)
                seed += 1
                run, x0, states, outs = xlstm_run_inputs(c, kind, n, 2,
                                                         seed=seed,
                                                         device=dev)
                x0, states, outs = (x0[1:].contiguous(), _row1(states),
                                    _row1(outs))
                x1 = megakernel.xlstm_stacked_run(c, x0, run, states, outs)
                torch.cuda.synchronize()
                act = "f32" if dtype == "float32" else "bf16"
                name = f"K3-{kind} L={n} 1 slot {act} {wd} w {sd} state"
                if act == "f32":
                    xr, want = ref.xlstm_stacked_run(c, x0, kind, run.rows,
                                                     states)
                    check_xlstm_run(name, c, kind, x1, outs, xr, want)
                    continue
                first = [x1.clone()] + [{k: v.clone() for k, v in o.items()}
                                        for o in outs]
                check_xlstm_layers(name, c, kind, run, x0, states, x1, outs)
                again = [megakernel.xlstm_stacked_run(c, x0, run, states,
                                                      outs)] + outs
                torch.cuda.synchronize()
                log_repeat(name, first, again)


def check_k3_one_jamba(dev):
    """K3-jamba at one slot holding a used state, one position at
    jamba-v0.1's widths, f32 and bf16, f32/f32 and int8/int8, against its
    plain version (phase 2j's rules); each bf16 launch repeated bit for
    bit."""
    from repro_torch.kernels import megakernel, ref
    jamba_run_inputs = shared_inputs().jamba_run_inputs
    seed = SEED + 400
    for wd, sd in (("f32", "f32"), ("int8", "int8")):
        for dtype in ("float32", "bfloat16"):
            c = jamba_cfg(n_experts=0, dtype=dtype, weight_dtype=wd,
                          state_dtype=sd)
            seed += 1
            run, x0, states, outs = jamba_run_inputs(c, 1, 2, seed=seed,
                                                     device=dev)
            x0, states, outs = (x0[1:].contiguous(), _row1(states),
                                _row1(outs))
            x1 = megakernel.jamba_stacked_run(c, x0, run, states, outs)
            xr, want = ref.jamba_stacked_run(c, x0, run.rows, states)
            torch.cuda.synchronize()
            act = "f32" if dtype == "float32" else "bf16"
            name = f"K3-jamba 1 pos 1 slot {act} {wd} w {sd} state"
            for i, (a, b) in enumerate(zip(outs, want)):
                check_k3(f"{name} [{i}]", c,
                         (x1, a["h"], a.get("h_scale"), a["conv"]),
                         (xr, b["h"], b.get("h_scale"), b["conv"]))
            if act == "bf16":
                first = [x1.clone()] + [{k: v.clone() for k, v in o.items()}
                                        for o in outs]
                again = [megakernel.jamba_stacked_run(c, x0, run, states,
                                                      outs)] + outs
                torch.cuda.synchronize()
                log_repeat(name, first, again)
            del run, states, outs, want


def front_traffic(cfg, shared, suffixes, sampled, max_new, seed=5):
    """Prompts of one shared ``shared``-token prefix (a system prompt) and
    a suffix each of ``suffixes``; the requests at ``sampled`` sampled
    (temperature 0.8, top_k 40, a seed each), the others greedy with their
    top two logprobs kept for the tie rule."""
    import numpy as np
    from repro_torch.runtime.sampling import SamplingParams
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab, size=shared).astype(np.int32)
    out = []
    for i, n in enumerate(suffixes):
        prompt = np.concatenate([pre, rng.integers(
            0, cfg.vocab, size=n).astype(np.int32)])
        out.append((prompt, SamplingParams(
            temperature=0.8, top_k=40, seed=4321 + i, max_new=max_new)
            if i in sampled else SamplingParams(
                max_new=max_new, logprobs=True, top_logprobs=2)))
    return out


def note(label, ok):
    log(f"  {label}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(label)
    return ok


def served_well(reqs, max_new, vocab):
    return all(r.finished and len(r.tokens) == max_new
               and all(0 <= t < vocab for t in r.tokens) for r in reqs)


def warm(eng, cfg):
    """cuBLAS and library init on short prompts (no cache boundary), then
    fresh stats."""
    from repro_torch.runtime.metrics import ServeStats
    for L in (16, 12):
        eng.submit(torch.arange(L).numpy() % cfg.vocab, max_new=4)
    eng.run()
    eng.stats = ServeStats()


def prefix_want(model, s, block, chain_k, decode_k, step_k):
    """The launches of a prefix-cache serve run, from the engine's
    counters: each cold admission prefills one block (the scan, conv and
    attention kernels of an admission), then every chain step and every
    decode step launches the K3 kernels (``model["k3"]`` of each) and the
    conv and step kernels of the positions K3 leaves."""
    chain = s.prefill_tokens - block * s.prefix_misses
    miss, rest = s.prefix_misses, model["k3_rest"]
    want = collections.Counter()
    want["selective_scan"] = model.get("scan", model["ssm"]) * miss
    want["flash_attention"] = model["attn"] * miss
    want["causal_conv1d"] = (model["ssm"] * miss
                             + rest * (chain + s.decode_steps))
    if rest:
        want[step_k] = rest * (chain + s.decode_steps)
    for k in chain_k:
        want[k] += model["k3"] * chain
    for k in decode_k:
        want[k] += model["k3"] * s.decode_steps
    return want, chain


def phase_prefix(num, model, cfg, params, runs, traffic, block, dev, card,
                 front_counts, tie_tol=None, sequential=False,
                 host_store=False):
    """Phase ``num``: prefix-cache serve runs of ``traffic`` (one shared
    prefix), bf16, step_impl "auto", ``PrefixCacheConfig(block, 32)``.
    Each run checks: every launch against the counters (``prefix_want``),
    no plain version, every slot back, the bytes a slot; the prefix
    counters; each request's stream and logprobs bitwise those of a cold
    admission of its prompt on a fresh cache-enabled engine; with
    ``tie_tol`` the cache-off engine's greedy streams under the tie rule
    (margins printed).  TTFT of cold, hit and cache-off admissions printed
    side by side.  ``sequential`` serves one request at a time (an MoE's
    capacity makes a slot's decode depend on what shares the batch).
    With ``host_store`` a last run with ``store="host"`` must give the
    device store's streams bitwise."""
    import dataclasses
    import statistics
    from repro_torch.core import dispatch_count
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.prefix_cache import (PrefixCache,
                                                  PrefixCacheConfig)
    from repro_torch.runtime.serve import ServeConfig, Server
    name = model["name"]
    pcc = PrefixCacheConfig(block=block, max_entries=32)
    shared = min(int(p.size) for p, _ in traffic)
    probe = PrefixCache(pcc)
    want_cached = sum(min(probe.boundary(int(p.size)),
                          (shared // block) * block)
                      for p, _ in traffic[1:])
    lens = [int(p.size) for p, _ in traffic]
    max_new = traffic[0][1].max_new
    first_streams = None
    for i, (wd, sd, kv, want_spb, step_k, chain_k, decode_k, via) in \
            enumerate(runs):
        setup = (f"{wd} weights, {sd} state, {kv} kv, block {block}, "
                 f"{'Server' if via else 'Engine'}")
        log(f"== phase {num}.{i + 1}: prefix-cache serve {name} bf16, "
            f"{setup}")

        def make(prefix_cache, store="device", via=via, wd=wd, sd=sd,
                 kv=kv):
            pc = (None if prefix_cache is None
                  else dataclasses.replace(prefix_cache, store=store))
            if via:
                return Server(dataclasses.replace(cfg, step_impl="auto"),
                              params, ServeConfig(
                                  batch_slots=4, max_seq=SERVE_MAX_SEQ,
                                  prefix_cache=pc, device=str(dev))).engine
            return Engine(cfg, params, EngineConfig(
                n_slots=4, max_seq=SERVE_MAX_SEQ, weight_dtype=wd,
                state_dtype=sd, kv_cache_dtype=kv, step_impl="auto",
                prefix_cache=pc, device=str(dev)))

        def serve(eng):
            if not sequential:
                reqs = [eng.submit(p, sp) for p, sp in traffic]
                eng.run()
                return reqs
            reqs = []
            for p, sp in traffic:
                reqs.append(eng.submit(p, sp))
                eng.run()
            return reqs

        eng = make(pcc)
        warm(eng, cfg)
        dispatch_count.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = serve(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = dispatch_count.snapshot()
        s = eng.stats
        want, chain = prefix_want(model, s, block, chain_k, decode_k, step_k)
        log(f"  {name}, {setup}: admissions {s.prefill_calls} (hits "
            f"{s.prefix_hits}, misses {s.prefix_misses}), chain steps "
            f"{chain}, pooled decode steps {s.decode_steps}")
        for k in dispatch_count.COUNTERS:
            ok = snap[k] == want[k]
            if snap[k] or want[k] or not ok:
                log(f"  launches {k:<26} {snap[k]:>6} (expected {want[k]})"
                    f"  {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"{name} prefix launch count {k} ({setup})")
            if snap[k] and not front_counts.get(k):
                front_counts[k] = snap[k]
        plain = sum(v for k, v in snap.items() if k.startswith("plain "))
        n = len(traffic)
        note(f"plain-version calls {plain}", plain == 0)
        note(f"slots back ({eng.pool.n_free} of 4 free, "
             f"{eng.pool.n_pinned} pinned)",
             eng.pool.n_free == 4 and eng.pool.n_pinned == 0)
        note(f"state_bytes_per_slot {eng.pool.state_bytes_per_slot()} "
             f"(expected {want_spb})",
             eng.pool.state_bytes_per_slot() == want_spb)
        note(f"{n} requests finished with {max_new} in-vocab tokens",
             served_well(reqs, max_new, cfg.vocab))
        note(f"prefix hits {s.prefix_hits} (expected {n - 1}), cached tokens "
             f"{s.prefix_cached_tokens} (expected {want_cached}), prefill "
             f"tokens {s.prefill_tokens} (expected "
             f"{sum(lens) - want_cached})",
             (s.prefix_hits, s.prefix_cached_tokens, s.prefill_tokens)
             == (n - 1, want_cached, sum(lens) - want_cached))
        admit = {"hit": [r.t_first - r.t_admit for r in reqs[1:]]}
        cold_ok, admit["cold"] = True, []
        for (p, sp), r in zip(traffic, reqs):
            cold = make(pcc)
            c = cold.submit(p, sp)
            cold.run()
            admit["cold"].append(c.t_first - c.t_admit)
            cold_ok &= (c.tokens == r.tokens and c.logprobs == r.logprobs
                        and c.cum_logprob == r.cum_logprob)
            del cold
        note(f"every stream bitwise a cold cache-on admission's of its "
             f"prompt ({n - 1} hits, 1 miss)", cold_ok)
        off = make(None)
        warm(off, cfg)
        oreqs = serve(off)
        admit["off"] = [r.t_first - r.t_admit for r in oreqs]
        note(f"cache-off prefill tokens {off.stats.prefill_tokens} (expected "
             f"{sum(lens)})", off.stats.prefill_tokens == sum(lens))
        if tie_tol is not None and sd == "f32":
            # a quantized state is quantized at other points by the
            # chunked prefill than by one full prefill: printed only
            tie_check(f"{name} {setup} cache on vs off", reqs, oreqs,
                      tie_tol)
        same = sum(a == b for r, q in zip(reqs, oreqs)
                   for a, b in zip(r.tokens, q.tokens))
        log(f"  token agreement with the cache-off run {same}/"
            f"{sum(len(q.tokens) for q in oreqs)} (printed: bf16)")
        ms = {k: 1e3 * statistics.mean(v) for k, v in admit.items()}
        log(f"  prefix {name} bf16, {setup} on {card}: admission to first "
            f"token (prompts {min(lens)}-{max(lens)}) mean cold "
            f"{ms['cold']:.2f} ms (a fresh cache: one-block prefill + "
            f"{min(lens) - block}-{max(lens) - block} chain steps), hit "
            f"{ms['hit']:.2f} ms (restore + chain), cache off "
            f"{ms['off']:.2f} ms (one prefill); TTFT mean on "
            f"{s.summary()['ttft_mean_s'] * 1e3:.1f} ms, off "
            f"{off.stats.summary()['ttft_mean_s'] * 1e3:.1f} ms; serve "
            f"wall {wall:.3f} s on, {off.stats.summary()['wall_s']:.3f} s "
            f"off")
        del off
        if i == 0:
            first_streams = [(r.tokens, r.logprobs) for r in reqs]
        del eng
        torch.cuda.empty_cache()
        if not phase_ok():
            return False
    if host_store:
        log(f"== phase {num}.h: host store (store='host'), first setup")
        wd, sd, kv, via = runs[0][0], runs[0][1], runs[0][2], runs[0][7]
        eng = Engine(cfg, params, EngineConfig(
            n_slots=4, max_seq=SERVE_MAX_SEQ, weight_dtype=wd,
            state_dtype=sd, kv_cache_dtype=kv, step_impl="auto",
            prefix_cache=dataclasses.replace(pcc, store="host"),
            device=str(dev)))
        reqs = serve(eng)
        on_host = all(e.on_host for e in eng._prefix._entries.values())
        note(f"host store: {eng.stats.prefix_hits} hits, every entry on the "
             f"CPU after the run ({len(eng._prefix)} entries), streams and "
             f"logprobs bitwise the device store's",
             on_host and eng.stats.prefix_hits == len(traffic) - 1
             and [(r.tokens, r.logprobs) for r in reqs] == first_streams)
        del eng
        torch.cuda.empty_cache()
    return phase_ok()


def tie_check(tag, got, ref, tol):
    """The tie rule over greedy requests: ``got`` equals ``ref`` (run with
    top-two logprobs) or first differs where ref's top two logits are
    within ``tol``; margins printed."""
    margins, ok = [], True
    for g, r in zip(got, ref):
        if r.params.temperature > 0:
            continue
        i = next((t for t, (a, b) in enumerate(zip(g.tokens, r.tokens))
                  if a != b), None)
        if i is None:
            continue
        (_, v0), (_, v1) = r.top_logprobs[i][:2]
        margins.append((r.req_id, i, round(v0 - v1, 6)))
        ok &= v0 - v1 <= tol
    note(f"{tag}: greedy first differences (req, position, reference "
         f"top-two margin) {margins}, each a tie within {tol:g}", ok)


def phase_best_of_n(num, cfg, params, dev, card):
    """Phase ``num``: best-of-n and sessions, mamba-130m bf16, f32 weights
    and state, step_impl "auto", 4 slots."""
    import dataclasses
    from repro_torch.core import dispatch_count
    from repro_torch.models import registry
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.prefix_cache import PrefixCacheConfig
    from repro_torch.runtime.sampling import SamplingParams

    def make(**kw):
        return Engine(cfg, params, EngineConfig(
            n_slots=4, max_seq=SERVE_MAX_SEQ, step_impl="auto",
            device=str(dev), **kw))

    traffic = front_traffic(cfg, 256, (16, 32), (), 32)
    prompt = traffic[1][0]
    sp = SamplingParams(temperature=0.8, top_k=40, seed=77, n=4, max_new=32)
    log(f"== phase {num}.1: best-of-4 sampled on 4 slots, then greedy")
    eng = make()
    warm(eng, cfg)
    dispatch_count.reset()
    parent = eng.submit(prompt, sp)
    eng.run()
    torch.cuda.synchronize()
    k4 = dispatch_count.snapshot()["selective_scan"]
    streams = [tuple(c.tokens) for c in parent.branches]
    cums = [c.cum_logprob for c in parent.branches]
    solo_eng = make()
    solo = solo_eng.submit(prompt, dataclasses.replace(sp, n=1))
    solo_eng.run()
    b0 = next(c for c in parent.branches if c.branch == 0)
    note(f"one prefill for the group: K4 launches {k4} (expected "
         f"{cfg.n_layers})", k4 == cfg.n_layers)
    note(f"{len(set(streams))} distinct branches of 4, ranked by cumulative "
         f"logprob {[round(c, 3) for c in cums]}",
         len(set(streams)) == 4 and cums == sorted(cums, reverse=True))
    note("branch 0 bitwise the request served at n=1",
         b0.tokens == solo.tokens and b0.cum_logprob == solo.cum_logprob)
    note(f"every slot back ({eng.pool.n_free} of 4), one request retired",
         eng.pool.n_free == 4 and eng.stats.n_requests == 1)
    greedy = eng.submit(prompt, SamplingParams(n=4, max_new=32))
    one = eng.submit(prompt, SamplingParams(max_new=32))
    eng.run()
    note("best-of-4 greedy: the four streams identical, the request's at "
         "n=1", len({tuple(c.tokens) for c in greedy.branches}) == 1
         and greedy.tokens == one.tokens)
    del eng, solo_eng
    log(f"== phase {num}.2: sessions past max_seq ({SERVE_MAX_SEQ})")
    eng = make()
    leaves0 = [(t.shape, t.dtype) for t in
               registry.tree_leaves(eng.pool.cache)]
    spb = eng.pool.state_bytes_per_slot()
    t0 = time.perf_counter()
    sess = eng.submit(prompt, session=True)
    steady = True
    while len(sess.tokens) < 640:
        eng.step()
        slot = eng._slot_req.index(sess)
        steady &= (eng.pool.is_pinned(slot) and eng.pool.n_pinned == 1
                   and eng.pool.state_bytes_per_slot() == spb
                   and [(t.shape, t.dtype) for t in registry.tree_leaves(
                       eng.pool.cache)] == leaves0)
    dt = time.perf_counter() - t0
    eng.cancel(sess.req_id)
    eng.step()
    note(f"session of {len(sess.tokens)} tokens past max_seq "
         f"{SERVE_MAX_SEQ} (prompt {prompt.size}): slot pinned and bytes a "
         f"slot ({spb}) and leaves constant at every sync; ended by cancel, "
         f"slot unpinned and free ({len(sess.tokens) / dt:.1f} tok/s on "
         f"{card})",
         steady and sess.finished and sess.cancelled
         and eng.pool.n_pinned == 0 and eng.pool.n_free == 4)
    stop = sess.tokens[600]
    ended = eng.submit(prompt, session=True, eos_id=stop)
    eng.run()
    note(f"session with stop id {stop}: ended on it after "
         f"{len(ended.tokens)} tokens, the first session's stream up to it",
         ended.finished and not ended.cancelled
         and ended.tokens == sess.tokens[:sess.tokens.index(stop) + 1]
         and eng.pool.n_pinned == 0)
    del eng
    log(f"== phase {num}.3: best-of-4 over a cached prefix")
    pcc = PrefixCacheConfig(block=64)
    eng = make(prefix_cache=pcc)
    eng.submit(traffic[0][0], max_new=4)
    eng.run()
    parent = eng.submit(prompt, sp)
    eng.run()
    solo_eng = make(prefix_cache=pcc)
    solo = solo_eng.submit(prompt, dataclasses.replace(sp, n=1))
    solo_eng.run()
    b0 = next(c for c in parent.branches if c.branch == 0)
    note(f"prefix hits {eng.stats.prefix_hits} (expected 1), "
         f"{len({tuple(c.tokens) for c in parent.branches})} distinct "
         f"branches of 4, branch 0 bitwise the n=1 request on a cold "
         f"cache", eng.stats.prefix_hits == 1
         and len({tuple(c.tokens) for c in parent.branches}) == 4
         and b0.tokens == solo.tokens and eng.pool.n_free == 4)
    del eng, solo_eng
    torch.cuda.empty_cache()
    return phase_ok()


def phase_disagg(num, cfg, params, runs, dev, card):
    """Phase ``num``: for each (weights, state, bytes a slot, decode K3
    kernel) of ``runs``, ``DisaggPipeline`` (a 1-slot prefill worker, a
    4-slot decode engine, queue depth 4) on one card against the
    monolithic engine on the same 8 requests (prompts 64 and 127, 32 new
    tokens, 6 greedy and 2 sampled), bf16, "auto": streams and cumulative
    logprobs bitwise, each snapshot a slot's bytes, the launches the
    worker's and the decode engine's counters imply, the transfer timed;
    then ``AsyncFrontend`` over ``SLOScheduler`` on the same traffic
    against ``Engine.run``."""
    import asyncio
    from repro_torch.core import dispatch_count
    from repro_torch.runtime.disagg import DisaggConfig, DisaggPipeline
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.frontend import AsyncFrontend
    from repro_torch.runtime.prefix_cache import (snapshot_to_device,
                                                  snapshot_to_host)
    from repro_torch.runtime.scheduler import (SchedConfig, SLOClass,
                                               SLOScheduler)
    traffic = spec_prompts(cfg, (64, 127))
    L = cfg.n_layers
    for i, (wd, sd, want_spb, k3_k) in enumerate(runs):
        setup = f"{wd} weights, {sd} state"
        log(f"== phase {num}.{i + 1}: disaggregated serve mamba-130m bf16, "
            f"{setup}, step_impl 'auto'")
        ecfg = EngineConfig(n_slots=4, max_seq=SERVE_MAX_SEQ, seed=3,
                            weight_dtype=wd, state_dtype=sd,
                            step_impl="auto", device=str(dev))
        mono = Engine(cfg, params, ecfg)
        warm(mono, cfg)
        ref = [mono.submit(p, sp) for p, sp in traffic]
        mono.run()
        pipe = DisaggPipeline(cfg, params, ecfg, DisaggConfig(queue_depth=4))
        warm(pipe.decode, cfg)
        dispatch_count.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = [pipe.submit(p, sp) for p, sp in traffic]
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = dispatch_count.snapshot()
        w, s = pipe.worker.engine.stats, pipe.decode.stats
        want = collections.Counter({"selective_scan": L * w.prefill_calls,
                                    "causal_conv1d": L * w.prefill_calls,
                                    k3_k: s.decode_steps})
        for k in dispatch_count.COUNTERS:
            ok = snap[k] == want[k]
            if snap[k] or want[k] or not ok:
                log(f"  launches {k:<26} {snap[k]:>6} (expected {want[k]})"
                    f"  {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"disagg launch count {k} ({setup})")
        plain = sum(v for k, v in snap.items() if k.startswith("plain "))
        note(f"plain-version calls {plain}", plain == 0)
        same = all(it.req.tokens == ref[j].tokens
                   and it.req.cum_logprob == ref[j].cum_logprob
                   for j, it in enumerate(items))
        c = pipe.counters()
        note(f"8 disaggregated streams and cumulative logprobs bitwise the "
             f"monolithic engine's; {c['transfers']} transfers, "
             f"{c['transfer_bytes'] // max(1, c['transfers'])} B each "
             f"(expected {want_spb}), queue peak {c['max_queue_depth']} of "
             f"4; decode-side prefill tokens {s.prefill_tokens}",
             same and c["transfers"] == 8
             and all(it.snap.nbytes == want_spb for it in items)
             and s.prefill_tokens == 0 and s.snapshot_admits == 8)
        note("8 requests finished with 32 in-vocab tokens",
             served_well([it.req for it in items], 32, cfg.vocab))
        eng = pipe.worker.engine
        slot = eng.pool.alloc()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = snapshot_to_host(eng.pool.read([slot]))
            t1 = time.perf_counter()
            back = snapshot_to_device(host, dev)
            torch.cuda.synchronize()
            times.append((t1 - t0, time.perf_counter() - t1))
        eng.pool.evict(slot)
        del back
        out_ms = 1e3 * min(t for t, _ in times)
        in_ms = 1e3 * min(t for _, t in times)
        log(f"  transfer of one {want_spb} B snapshot on {card} (best of 5, "
            f"host clock): gather + to the CPU {out_ms:.3f} ms "
            f"({want_spb / out_ms / 1e6:.2f} GB/s), back to the card "
            f"{in_ms:.3f} ms ({want_spb / in_ms / 1e6:.2f} GB/s)")
        log(f"  disagg mamba-130m bf16, {setup} on {card}: "
            f"{s.summary()['useful_tokens']} tokens in {wall:.3f} s, TTFT "
            f"mean {s.summary()['ttft_mean_s'] * 1e3:.1f} ms; monolithic "
            f"{mono.stats.summary()['tokens_per_s']:.1f} tok/s")
        del pipe, mono
        torch.cuda.empty_cache()
        if not phase_ok():
            return False
        log(f"== phase {num}.{i + 1}f: AsyncFrontend over SLOScheduler, "
            f"{setup}")
        eng = Engine(cfg, params, ecfg)
        warm(eng, cfg)
        sched = SLOScheduler(eng, SchedConfig(
            weights={"a": 1.0, "b": 2.0},
            classes=(SLOClass(ttft_budget=100_000),)))

        async def front():
            async with AsyncFrontend(eng, sched) as fe:
                hs = [await fe.submit(p, sp, tenant="ab"[j % 2])
                      for j, (p, sp) in enumerate(traffic)]
                streams = [[t async for t in h.tokens()] for h in hs]
                done = [await h.result() for h in hs]
            return hs, streams, done

        hs, streams, done = asyncio.run(asyncio.wait_for(front(), 600))
        cnt = sched.counters()
        good = all(d is not None and d.tokens == st == ref[j].tokens
                   for j, (d, st) in enumerate(zip(done, streams)))
        note(f"front-end streams equal Engine.run's (8 requests, tenants "
             f"a/b at weights 1/2): admitted {cnt['admitted']}, shed "
             f"{cnt['shed']}, degraded {cnt['degraded']}, starvation bound "
             f"{cnt['starvation_bound']}, order {sched.admitted_order}",
             good and cnt["admitted"] == 8 and eng.pool.n_free == 4)
        del eng, sched
        torch.cuda.empty_cache()
        if not phase_ok():
            return False
    return True


# (weights, state, kv cache, bytes a slot, the per-position step kernel,
# the K3 kernels of the suffix chain, those of a decode step, through
# Server): each prefix-cache run.  The chain steps the f32 prefill master,
# so an int8-weight engine's chain launches K3's f32-weight instance.
PREFIX_RUNS = (
    ("f32", "f32", "model", 2580484, None, ("mamba_stacked_step",),
     ("mamba_stacked_step",), True),
    ("int8", "int8", "model", 811300, None, ("mamba_stacked_step_q",),
     ("mamba_stacked_step_q_int8a",), False))
XLSTM_PREFIX_RUNS = (
    ("f32", "f32", "model", 88818004, None,
     ("mlstm_stacked_run", "slstm_stacked_run"),
     ("mlstm_stacked_run", "slstm_stacked_run"), False),)
# jamba with an f32 state and int8 KV strips: 7 x (h 8192 x 16 x 4 + conv
# 3 x 8192 x 2) + 2 x 576 x (1024 + 4) + pos 4 bytes a slot
JAMBA_PREFIX_RUNS = (
    ("f32", "f32", "int8", 5198340, "decode_step", ("jamba_stacked_run",),
     ("jamba_stacked_run",), False),)
# (weights, state, bytes a slot, the decode K3 kernel): each run of 4d
DISAGG_RUNS = (("f32", "f32", 2580484, "mamba_stacked_step"),
               ("int8", "int8", 811300, "mamba_stacked_step_q_int8a"))


# ---------------------------------------------------------------------------
# Training (phases 2g, 3g, 4g, 5g): K4, K5 and K7 under their autograd
# Functions, the model's gradients, the Trainer, one step split
# ---------------------------------------------------------------------------

#: (kind, shape) of each 2g case, as tests/test_torch_cuda.py's
#: TRAIN_CASES: scan (b, L, d, n, dt_rank, chunk), conv (b, L, d, k,
#: x_prev), attention (b, lq, lk, hq, hkv, dh)
TRAIN_CASES = (("scan", (2, 512, 1536, 16, 48, 64)),
               ("scan", (2, 33, 1536, 16, 48, 64)),
               ("conv", (2, 512, 1536, 4, False)),
               ("conv", (2, 33, 1536, 4, True)),
               ("attention", (1, 256, 256, 28, 4, 128)),
               ("attention", (1, 512, 512, 16, 16, 128)),
               ("attention", (1, 100, 256, 16, 16, 128)))
TRAIN_KERNEL = {"scan": "selective_scan", "conv": "causal_conv1d",
                "attention": "flash_attention"}
#: f32 gradients of a Function against its plain version's, of max-abs
FUNCTION_GRAD_TOL = 5e-4
#: f32 gradients of the model on the card against the CPU's, of max-abs
MODEL_GRAD_TOL = 1e-3
#: (arch, layers, batch, length) of each 3g run
TRAIN_MODEL_RUNS = (("mamba-130m", 2, 2, 128), ("olmo-1b", 2, 1, 128))
#: (arch, TrainConfig fields, steps after which the run resumes) of each
#: 4g run; bf16 compute (the zoo's dtype), f32 master weights and moments
TRAIN_RUNS = (
    ("mamba-130m", dict(total_steps=8, warmup_steps=2, global_batch=8,
                        seq_len=512, grad_accum=2, ckpt_every=4), 4),
    ("olmo-1b", dict(total_steps=6, warmup_steps=2, global_batch=4,
                     seq_len=512, grad_accum=1, ckpt_every=0), None))
TRAIN_LR = 1e-3


def train_launches_expected(cfg, tcfg) -> dict:
    """K4, K5 and K7 launches of one training step of ``cfg``: each
    microbatch runs the scan forward once a mamba layer plus the
    backward's recompute once a chunk, the conv once a mamba layer and K7
    once an attention layer."""
    mb = tcfg.grad_accum
    if cfg.family == "mamba":
        chunks = -(-tcfg.seq_len // cfg.scan_chunk)
        return {"selective_scan": mb * cfg.n_layers * (1 + chunks),
                "causal_conv1d": mb * cfg.n_layers}
    return {"flash_attention": mb * cfg.n_layers}


def phase_train_functions(dev) -> dict:
    """2g.  Returns each kernel's largest f32 gradient error over its
    cases, as a share of the gradient's max-abs."""
    worst = {}
    for kind, shape in TRAIN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            res = shared_inputs().trainable_case(kind, shape, dtype, dev,
                                                 seed=SEED)
            if kind == "scan":
                want = {"selective_scan": 1 + -(-shape[1] // shape[5])}
            else:
                want = {TRAIN_KERNEL[kind]: 1}
            got = dict(res["launches"])
            tag = f"{kind} {shape} {str(dtype)[6:]}"
            ok = got == want and res["finite"]
            f32 = dtype == torch.float32
            parts = []
            for name, err, scale in res["errs"]:
                rel = err / max(scale, 1e-30)
                parts.append(f"{name} {rel:.2e}")
                if f32:
                    ok &= rel <= FUNCTION_GRAD_TOL
                    key = TRAIN_KERNEL[kind]
                    worst[key] = max(worst.get(key, 0.0), rel)
            log(f"  {tag:<44} launches {got}  grad err/max-abs: "
                f"{', '.join(parts)}"
                f"{f' (tol {FUNCTION_GRAD_TOL:g})' if f32 else ''}  "
                f"finite {res['finite']}  {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"2g {tag}")
    return worst


def phase_train_model(arch, n_layers, b, L, dev):
    """3g: one loss and backward of ``arch`` (full width, ``n_layers``,
    f32) on the card and on the CPU, the same weights and batch."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.core import dispatch_count
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=n_layers,
                              dtype="float32")
    params = registry.init_params(cfg, seed=SEED)
    batch = registry.make_batch(cfg, b, L,
                                torch.Generator().manual_seed(SEED + 1))
    out = {}
    for device in ("cpu", dev):
        p = registry.tree_map(
            lambda t: t.detach().to(device, copy=True).requires_grad_(),
            params)
        dispatch_count.reset()
        loss, _ = registry.loss_fn(
            cfg, p, {k: v.to(device) for k, v in batch.items()})
        loss.backward()
        grads = [t.grad.cpu() for t in registry.tree_leaves(p)]
        out[str(device)] = (float(loss.detach()), grads,
                            +dispatch_count.snapshot())
        del p
    (l_c, g_c, _), (l_d, g_d, counts) = out["cpu"], out[str(dev)]
    want = {"selective_scan": n_layers * (1 + -(-L // cfg.scan_chunk)),
            "causal_conv1d": n_layers} if cfg.family == "mamba" else {
        "flash_attention": n_layers}
    ok = dict(counts) == want
    rel = abs(l_d - l_c) / abs(l_c)
    ok &= rel <= 1e-5
    log(f"  {arch} ({n_layers} layers) f32 b {b} L {L}: loss card {l_d:.7f}"
        f" cpu {l_c:.7f} (rel {rel:.2e}, tol 1e-5); launches {dict(counts)}")
    names = list(_flatten_with_paths(params))
    worst = 0.0
    for name, gc, gd in zip(names, g_c, g_d):
        scale = float(gc.abs().max())
        r = float((gd - gc).abs().max()) / max(scale, 1e-30)
        worst = max(worst, r)
        good = r <= MODEL_GRAD_TOL and bool(torch.isfinite(gd).all())
        ok &= good
        log(f"    {name:<34} grad err/max-abs {r:.2e} (max-abs "
            f"{scale:.3e}, tol {MODEL_GRAD_TOL:g})  "
            f"{'ok' if good else 'FAIL'}")
    log(f"  {arch}: {len(names)} gradient leaves, the largest error "
        f"{worst:.2e} of max-abs  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"3g {arch}")


def phase_train_run(arch, fields, resume_at, dev, card):
    """4g: one Trainer run of ``arch`` at full width and depth, and with
    ``resume_at`` a second run resumed from that step's checkpoint.
    Returns (the summary, the trained state for 5g)."""
    import math
    import shutil
    import tempfile
    from repro_torch import configs
    from repro_torch.core import dispatch_count
    from repro_torch.models import registry
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    cfg = configs.get_config(arch)
    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="train_", dir=ROOT / "build")
    tcfg = TrainConfig(ckpt_dir=ckdir, log_every=1000, device=str(dev),
                       optimizer=AdamWConfig(lr=TRAIN_LR), **fields)
    try:
        trainer = Trainer(cfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch_count.reset()
        t0 = time.perf_counter()
        params, opt_state, losses = trainer.run(resume=False)
        wall = time.perf_counter() - t0
        counts = +dispatch_count.snapshot()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times = trainer.step_times
        steady = sorted(times[1:])[len(times[1:]) // 2]
        tokens = tcfg.global_batch * tcfg.seq_len
        n_params = registry.count_params(cfg)
        want = {k: v * tcfg.total_steps
                for k, v in train_launches_expected(cfg, tcfg).items()}
        ok = dict(counts) == want
        ok &= all(map(math.isfinite, losses)) and losses[-1] < losses[0]
        log(f"  {arch}: {cfg.n_layers} layers, {n_params} parameters, "
            f"global batch {tcfg.global_batch} ({tcfg.grad_accum} "
            f"microbatches) x seq {tcfg.seq_len}, {cfg.dtype} compute, f32 "
            f"weights and moments, lr {TRAIN_LR:g} ({card})")
        log(f"  losses {[round(x, 4) for x in losses]}  (first {losses[0]:.4f}"
            f" -> last {losses[-1]:.4f})")
        log(f"  step time first {times[0]:.3f} s, median of the rest "
            f"{steady:.3f} s ({tokens / steady:.0f} tokens/s); run {wall:.1f}"
            f" s; peak memory {peak:.2f} GiB")
        log(f"  launches {dict(counts)} (want {want}: a step "
            f"{train_launches_expected(cfg, tcfg)})  {'ok' if ok else 'FAIL'}")
        summary = {"arch": arch, "losses": losses, "step_s": times,
                   "median_step_s": steady, "tokens_per_s": tokens / steady,
                   "peak_gib": peak, "launches": dict(counts),
                   "steps": tcfg.total_steps, "grad_accum": tcfg.grad_accum}
        if not ok:
            FAILURES.append(f"4g {arch}")
        if resume_at is not None:
            keep = trainer.ckpt.all_steps()
            for step in keep:
                if step > resume_at:
                    shutil.rmtree(Path(ckdir) / f"step_{step:012d}")
            t2 = Trainer(cfg, tcfg)
            _, _, resumed = t2.run(resume=True)
            diff = max(abs(a - b) for a, b in zip(resumed,
                                                  losses[resume_at:]))
            same = resumed == losses[resume_at:]
            good = len(resumed) == len(losses) - resume_at and same
            log(f"  resumed from step {resume_at} (checkpoints {keep}): "
                f"losses {[round(x, 4) for x in resumed]}; "
                f"{'bitwise equal to' if same else 'max |diff| '}"
                f"{'' if same else f'{diff:.3e} from'} the straight run's  "
                f"{'ok' if good else 'FAIL'}")
            summary["resume_max_abs_diff"] = diff
            summary["resume_bitwise"] = same
            if not good:
                FAILURES.append(f"4g {arch} resume")
        return summary, (cfg, tcfg, params, opt_state)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def _device_ms(fn):
    """(fn's result, ms of device kernels torch.profiler records in one
    call, the number of those kernels); (result, None, 0) when the trace
    holds no kernel."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    return out, (busy if evs else None), len(evs)


def phase_train_split(state, dev):
    """5g: one step of the 4g mamba run's configuration on its trained
    state, split into forward (every microbatch's loss), backward and
    optimizer; a warm step, then each part timed on the host clock (a
    synchronize closing it) and, in a third step, its device kernels
    (torch.profiler)."""
    from repro_torch.data import make_train_iterator
    from repro_torch.models import registry
    from repro_torch.optim import adamw_update, cosine_schedule
    cfg, tcfg, params, opt_state = state
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        make_train_iterator(cfg, tcfg.global_batch, tcfg.seq_len,
                            prefetch=0)).items()}
    k = tcfg.grad_accum
    rows = tcfg.global_batch // k
    mbs = [{n: v[i * rows:(i + 1) * rows] for n, v in batch.items()}
           for i in range(k)]
    leaves = registry.tree_leaves(params)
    box = {"opt": opt_state}

    def forward():
        for p in leaves:
            p.grad = None
        return [registry.loss_fn(cfg, params, mb)[0] for mb in mbs]

    def backward(losses):
        for loss in losses:
            loss.backward()

    def optimizer():
        grads = registry.tree_map(lambda p: p.grad / k, params)
        lr = cosine_schedule(box["opt"].step, tcfg.warmup_steps,
                             tcfg.total_steps)
        _, box["opt"], _ = adamw_update(grads, box["opt"], params,
                                        tcfg.optimizer, lr)

    backward(forward())
    optimizer()
    torch.cuda.synchronize()
    wall = {}
    t0 = time.perf_counter()
    losses = forward()
    torch.cuda.synchronize()
    wall["forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    backward(losses)
    torch.cuda.synchronize()
    wall["backward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    optimizer()
    torch.cuda.synchronize()
    wall["optimizer"] = time.perf_counter() - t0
    dev_ms, kernels = {}, {}
    losses, dev_ms["forward"], kernels["forward"] = _device_ms(forward)
    _, dev_ms["backward"], kernels["backward"] = _device_ms(
        lambda: backward(losses))
    _, dev_ms["optimizer"], kernels["optimizer"] = _device_ms(optimizer)
    rows_out = {}
    for part in ("forward", "backward", "optimizer"):
        d = dev_ms[part]
        share = None if d is None else 1 - d / (1e3 * wall[part])
        rows_out[part] = {"wall_ms": 1e3 * wall[part], "device_ms": d,
                          "device_kernels": kernels[part],
                          "idle_share": share}
        d_txt = "not measured (no kernel in the trace)" if d is None else \
            f"{d:.2f} ms in {kernels[part]} kernels (device idle " \
            f"{100 * share:.1f}% of the wall time)"
        log(f"  {part:<9} wall {1e3 * wall[part]:9.2f} ms  device {d_txt}")
    total = sum(wall.values())
    log(f"  step wall {1e3 * total:.2f} ms ({tcfg.global_batch} x "
        f"{tcfg.seq_len} tokens, {tcfg.grad_accum} microbatches)")
    return rows_out


# ---------------------------------------------------------------------------
# Tensor-parallel serving (2m, 3m, 4m): two gloo ranks sharing the one card
# ---------------------------------------------------------------------------

TP = 2
TP_ARCH = "mamba-2.8b"
#: the sequence-parallel scan's shape (b, L, d_inner, d_state): mamba-2.8b's
#: d_inner, a 1024-token sequence as two chunks of 512
TP_SCAN = (1, 1024, 5120, 16)
#: y's tolerance by dtype (h_last is f32 in both): f32 the scan's; bf16
#: two roundings of y (pass 1's output and the corrected sum) against one
TP_SCAN_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
#: the straddled-group step at mamba-130m's widths (d_inner 1536 at tp=2:
#: 768 channels a rank, so scale group 1 of 3 is cut): codes within one,
#: scales to f32 rounding of the group absmax, y at f32
TP_STRADDLE = dict(slots=4, scale_rtol=1e-5, y_tol=1e-4)
TP_PROMPT = 127
TP_STEPS = 8
#: 3m's logits tolerance, tp=2 against one device on the card, written
#: before the first run: f32 with TF32 off; the row-parallel products of
#: each layer (x_proj, out_proj: two a mamba layer, 128 at mamba-2.8b)
#: sum their halves in another order than one GEMM, an f32 ulp of each
#: output, and 64 layers carry it through the residual stream
TP_LOGITS_TOL = {"mamba-2.8b": 2e-3, "qwen2-7b": 2e-3, "xlstm-350m": 2e-3}
#: 4m's tie rule: greedy streams agree token for token, or first differ
#: where the single-device run's top two logits lie within this (f32);
#: an int8 state moves a code where a value sits on a rounding boundary,
#: and the code feeds every later step (phase 3's int8-state tolerance)
TP_TIE = {("f32", "f32"): 2e-3, ("int8", "int8"): 2e-2}
TP_XLSTM_PROMPT = 32
#: calls a shape of 4m's timing of one all-reduce alone
TP_COLLECTIVE_CALLS = 200
#: seconds a rank may wait in a collective, and the parent for the ranks
TP_GLOO_TIMEOUT = 300
TP_TIMEOUT = 900
#: the kernels phase 2m's sharded calls launch on this rank (its
#: single-device comparisons not counted)
LAUNCHES_2M = collections.Counter()


def tp_cfg(arch, **kw):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch), scan_impl="pallas",
                               conv_impl="pallas", step_impl="fused", **kw)


def tp_probe(mesh, dev):
    """Each collective the models call, on CUDA tensors over the mesh's
    gloo group, held against its exact result."""
    import torch.distributed as dist
    r, n = mesh.rank, mesh.size
    out = {}
    cases = {
        "all_reduce_sum": (lambda t: dist.all_reduce(t),
                           lambda: torch.full((4,), float(r + 1), device=dev),
                           lambda t: t == sum(range(1, n + 1))),
        "all_reduce_max": (lambda t: dist.all_reduce(t, dist.ReduceOp.MAX),
                           lambda: torch.full((4,), float(r), device=dev),
                           lambda t: t == n - 1),
        "broadcast": (lambda t: dist.broadcast(t, 0),
                      lambda: torch.full((4,), float(r + 7), device=dev,
                                         dtype=torch.float64),
                      lambda t: t == 7),
    }
    for name, (op, make, good) in cases.items():
        t = make()
        try:
            op(t)
            out[name] = "ok" if bool(good(t).all()) else "wrong result"
        except RuntimeError as e:
            out[name] = f"refused: {str(e).splitlines()[0][:100]}"
    t = torch.full((4,), float(r), device=dev)
    outs = [torch.empty_like(t) for _ in range(n)]
    try:
        dist.all_gather(outs, t)
        good = all(bool((o == i).all()) for i, o in enumerate(outs))
        out["all_gather"] = "ok" if good else "wrong result"
    except RuntimeError as e:
        out["all_gather"] = f"refused: {str(e).splitlines()[0][:100]}"
    for name, res in out.items():
        log(f"  gloo {name} on CUDA tensors: {res}")
        if res != "ok":
            FAILURES.append(f"gloo {name} on CUDA tensors")
    return out


def tp_scan(mesh, dev):
    """2m: ``sp_selective_scan`` over the rank's half of L against one K4
    launch over the whole sequence, f32 and bf16, with D and z; one K4
    launch a rank."""
    from repro_torch.kernels import ops, selective_scan
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.parallel.sp_scan import sp_selective_scan
    sp = make_serving_mesh(TP, axis="sp")
    b, L, d, n = TP_SCAN
    lo, hi = mesh.rank * L // TP, (mesh.rank + 1) * L // TP
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(SEED + 31)
        x, dt, A, B, C, D, z, _ = scan_inputs(b, L, d, n, 160, dtype, gen,
                                              dev, h0=False)
        y_ref, h_ref = ops.selective_scan(x, dt, A, B, C, D=D, z=z)
        before = selective_scan.launches
        y, h = sp_selective_scan(sp, x[:, lo:hi], dt[:, lo:hi], A,
                                 B[:, lo:hi], C[:, lo:hi], D=D,
                                 z=z[:, lo:hi], axis_name="sp")
        torch.cuda.synchronize()
        launches[str(dtype)] = selective_scan.launches - before
        LAUNCHES_2M["selective_scan"] += launches[str(dtype)]
        tag = f"sp scan rank {mesh.rank} {str(dtype)[6:]} L {L} as {TP}x"
        tol = TP_SCAN_TOL[dtype]
        check(f"{tag} y", y, y_ref[:, lo:hi], tol, tol)
        check(f"{tag} h_last", h, h_ref, 5e-4, 5e-4)
        ok = launches[str(dtype)] == 1
        log(f"  {tag}: K4 launches on this rank {launches[str(dtype)]} "
            f"(expected 1)  {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{tag} K4 launches")
    return launches


def tp_straddle(mesh, dev):
    """2m: the quantized-state step of a rank whose channels cut a scale
    group (mamba-130m's d_inner 1536 at tp=2), int8 and fp8: K1 on the
    dequantized shard and a requantization on the group absmax taken over
    the ranks, against the single-device K2 step on the whole state."""
    import dataclasses
    from repro_torch.core import dispatch_count, state_quant
    from repro_torch.kernels import ops
    from repro_torch.models import mamba
    from repro_torch.parallel import sharding
    s = TP_STRADDLE
    base = tp_cfg("mamba-130m")
    slots, d, n = s["slots"], base.d_inner, base.d_state
    loc = d // TP
    lo, hi = mesh.rank * loc, (mesh.rank + 1) * loc
    out = {}
    for sd in ("int8", "fp8"):
        gen = torch.Generator().manual_seed(SEED + 41)
        x, dt, A, B, C, D, z, h = scan_inputs(slots, 1, d, n, base.dt_rank,
                                              torch.float32, gen, dev)
        hq, scale = q_state(h, sd)
        y_ref, hq_ref, s_ref = ops.selective_state_step_q(
            hq, scale, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D=D,
            z_t=z[:, 0], state_dtype=sd)
        cfg = dataclasses.replace(base, state_dtype=sd)
        before = dispatch_count.snapshot()
        sharding.reset_counts()
        with sharding.use_mesh(mesh):
            y, hq_loc, s_loc = mamba._step_q(
                cfg, hq[:, lo:hi].contiguous(), scale, x[:, 0, lo:hi],
                dt[:, 0, lo:hi], A[lo:hi].contiguous(), B[:, 0], C[:, 0],
                D[lo:hi].contiguous(), z[:, 0, lo:hi], "fused", None)
        torch.cuda.synchronize()
        snap = dispatch_count.snapshot()
        snap.subtract(before)
        LAUNCHES_2M.update(+snap)
        tag = f"straddled step rank {mesh.rank} {sd} d {d}/{TP}"
        check(f"{tag} y", y, y_ref[:, lo:hi], s["y_tol"], s["y_tol"])
        codes = int((code_ordinals(hq_loc)
                     - code_ordinals(hq_ref[:, lo:hi])).abs().max())
        rel = float(((s_loc - s_ref).abs()
                     / s_ref.abs().clamp_min(1e-30)).max())
        ok = codes <= 1 and rel <= s["scale_rtol"]
        counts = (snap["decode_step"], snap["decode_step_q"],
                  sharding.COUNTS["straddled_step"],
                  sharding.COUNTS["all_reduce_max"])
        ok = ok and counts == (1, 0, 1, 1)
        log(f"  {tag}: codes within {codes}, scales max rel diff {rel:.2e} "
            f"(rtol {s['scale_rtol']:g}); K1/K2 launches, straddled steps, "
            f"absmax exchanges {counts} (expected (1, 0, 1, 1))  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(tag)
        out[sd] = dict(codes=codes, scale_rel=rel)
    return out


def tp_checksum(mesh, params):
    """The ranks drew the same bits: a few leaves' f64 sums, max and min
    over the ranks."""
    from repro_torch.models import registry
    from repro_torch.parallel import sharding
    leaves = registry.tree_leaves(params)
    t = torch.stack([leaves[i].double().sum() for i in
                     (0, len(leaves) // 2, len(leaves) - 1)])
    with sharding.use_mesh(mesh):
        hi = sharding.all_reduce_max(t.clone())
        lo = -sharding.all_reduce_max(-t)
    same = bool(torch.equal(hi, lo))
    log(f"  both ranks drew the same weights (3 leaves' sums): "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        FAILURES.append("ranks drew different weights")


def tp_forward(cfg, params, dev, lp, mesh=None):
    """Teacher-forced prefill ``lp`` + TP_STEPS decode steps at one slot;
    returns the logits (lp's last + each step's, (TP_STEPS + 1, V)) and
    the all-reduces of the last step, on ``params`` (the rank's shard
    under ``mesh``)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.parallel import sharding
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, lp + TP_STEPS, seed=2)
                           .batch_at(0, 0, 1, 1)["tokens"],
                           dtype=torch.int64, device=dev)
    cache = registry.init_cache(cfg, 1, lp + TP_STEPS, device=dev)
    if mesh is not None:
        cache = sharding.shard_cache(cfg, cache, mesh)
    with sharding.use_mesh(mesh):
        logits, cache = registry.prefill(cfg, params, cache,
                                         {"tokens": toks[:, :lp]})
        out = [logits[0, -1]]
        for s in range(TP_STEPS):
            sharding.reset_counts()
            logits, cache = registry.decode_step(
                cfg, params, cache, {"tokens": toks[:, lp + s:lp + s + 1]})
            out.append(logits[0, -1])
    torch.cuda.synchronize()
    return torch.stack(out), dict(sharding.COUNTS)


def tp_hold_logits(tag, got, want, tol):
    """3m's comparison of rank 0's logits with one device's: within
    ``tol``, and every greedy token equal or, where not, the reference's
    top two logits within ``tol``."""
    check(f"{tag} logits (tp={TP} vs one device)", got, want, tol, tol)
    differ = got.argmax(-1) != want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1])[differ]
    ok = bool((margins <= tol).all())
    log(f"  {tag}: greedy agreement over {got.shape[0]} positions "
        f"{1 - float(differ.float().mean()):.4f}, differing margins "
        f"{margins.tolist()}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{tag} greedy agreement")


def tp_model(mesh, dev, arch, cfg, lp, full_cb=None):
    """3m for one model: the full tree drawn on the card from one seed on
    both ranks; rank 0 runs the single-device per-layer path on it (and
    ``full_cb(params)``, the single-device serving references, while it
    holds the full tree), then both ranks cut their shards and run
    ``tp_forward``.  Returns (all-reduces of a decode step, full_cb's
    result)."""
    import gc
    from repro_torch.models import registry
    from repro_torch.parallel import sharding
    t0 = time.perf_counter()
    full = registry.init_params(cfg, seed=SEED, device=dev, draw_device=dev)
    torch.cuda.synchronize()
    log(f"  {arch}: {registry.count_params(cfg)} parameters drawn on the "
        f"card on each rank in {time.perf_counter() - t0:.1f} s")
    tp_checksum(mesh, full)
    want, extra = None, None
    if mesh.rank == 0:
        want, _ = tp_forward(cfg, full, dev, lp)
        if full_cb is not None:
            extra = full_cb(full)
    local = sharding.shard_params(cfg, full, mesh)
    if full_cb is None:
        del full
    else:
        extra = (extra, full)
    gc.collect()
    torch.cuda.empty_cache()
    got, counts = tp_forward(cfg, local, dev, lp, mesh)
    n_ar = counts.get("all_reduce_sum", 0) + counts.get("all_reduce_max", 0)
    L = cfg.n_layers
    ok = L <= n_ar <= 16 * L
    log(f"  {arch}: collectives of one decode step on a rank {counts} "
        f"(all-reduces {n_ar}, expected within [{L}, {16 * L}])  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{arch} all-reduces a step")
    if mesh.rank == 0:
        tp_hold_logits(f"{arch} f32 prefill {lp} + {TP_STEPS}", got.float(),
                       want.float(), TP_LOGITS_TOL[arch])
    del local
    return n_ar, extra


def tp_traffic(cfg):
    """Phase 4's traffic: 8 greedy prompts of 64/127/256/512 tokens (two
    each) and one sampled request, 32 new tokens, the greedy ones with
    their top two logprobs for the tie rule."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.sampling import SamplingParams
    prompts = [SyntheticLM(cfg.vocab, L, seed=4).batch_at(0, 0, 1, 2)
               ["tokens"][i] for L in (64, 127, 256, 512) for i in range(2)]
    greedy = SamplingParams(max_new=32, logprobs=True, top_logprobs=2)
    sampled = SamplingParams(temperature=0.8, top_k=40, seed=1234, max_new=32)
    return [(p, greedy) for p in prompts] + [(prompts[3], sampled)]


def tp_serve(cfg, params, run, dev, mesh=None):
    """One 4m run through ``Engine``: warm-up, the counts at 0, the
    traffic, the counts read.  Returns (streams, counts, stats summary,
    engine facts)."""
    import gc
    import dataclasses
    from repro_torch.core import dispatch_count
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.parallel import sharding
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.metrics import ServeStats
    wd, sd, dtype = run
    c = dataclasses.replace(cfg, dtype=dtype)
    eng = Engine(c, params, EngineConfig(
        n_slots=4, max_seq=SERVE_MAX_SEQ, weight_dtype=wd, state_dtype=sd,
        device=str(dev), mesh=mesh))
    for row in SyntheticLM(c.vocab, 16, seed=3).batch_at(0, 0, 1, 2)[
            "tokens"]:
        eng.submit(row, max_new=4)
    eng.run()
    eng.stats = ServeStats()
    dispatch_count.reset()
    sharding.reset_counts()
    torch.cuda.synchronize()
    reqs = [eng.submit(p, sp) for p, sp in tp_traffic(c)]
    eng.run()
    torch.cuda.synchronize()
    snap = dispatch_count.snapshot()
    facts = dict(spb=eng.pool.state_bytes_per_slot(),
                 dspb=eng.pool.device_state_bytes_per_slot(),
                 local_bytes=sum(t.numel() * t.element_size() for t in
                                 registry.tree_leaves(eng.pool.cache))
                 // eng.pool.n_total,
                 back=eng.pool.n_free == 4, collectives=dict(sharding.COUNTS),
                 straddled=sharding.COUNTS.get("straddled_step", 0),
                 decode_s=eng.stats.decode_time)
    smry = eng.stats.summary()
    s = eng.stats
    streams = [(r.tokens, r.top_logprobs) for r in reqs]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return streams, snap, smry, facts, (s.prefill_calls, s.decode_steps)


def tp_hold_streams(tag, got, want, tol):
    """4m's tie rule over the greedy requests (the sampled one printed)."""
    bad, diverged = [], 0
    for i, ((g, _), (w, wtop)) in enumerate(zip(got[:-1], want[:-1])):
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            if len(g) != len(w):
                bad.append((i, "length"))
            continue
        diverged += 1
        (_, v0), (_, v1) = wtop[j][:2]
        log(f"  {tag} request {i}: first differing token at {j}, the "
            f"single-device run's top-two margin {v0 - v1:.3e}")
        if v0 - v1 > tol:
            bad.append((i, j, v0 - v1))
    same = got[-1][0] == want[-1][0]
    log(f"  {tag}: {8 - diverged}/8 greedy streams identical, {diverged} "
        f"first differ within the tie rule ({tol:g}); sampled stream "
        f"{'identical' if same else 'differs (printed)'}  "
        f"{'ok' if not bad else 'FAIL ' + str(bad)}")
    if bad:
        FAILURES.append(f"{tag} tie rule")


TP_SERVE_RUNS = (("f32", "f32", "float32"), ("int8", "int8", "float32"),
                 ("f32", "f32", "bfloat16"))


def tp_hold_serve(tag, cfg, sd, snap, facts, steps, want_dspb):
    """4m's checks of one tp run on this rank: each kernel's launches
    against the engine's counters, no plain version, the bytes a slot,
    every slot back."""
    from repro_torch.core import dispatch_count
    admits, dsteps = steps
    L = cfg.n_layers
    step_k = "decode_step_q" if sd == "int8" else "decode_step"
    want = {k: 0 for k in dispatch_count.COUNTERS}
    want["selective_scan"] = L * admits
    want["causal_conv1d"] = L * (admits + dsteps)
    want[step_k] = L * dsteps
    got = {k: snap[k] for k in dispatch_count.COUNTERS}
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    plain = sum(v for k, v in snap.items() if k.startswith("plain "))
    log(f"  {tag}: admissions {admits}, pooled decode steps {dsteps}; "
        f"launches on this rank K4 {got['selective_scan']}, K5 "
        f"{got['causal_conv1d']}, {step_k} {got[step_k]} (expected "
        f"{want['selective_scan']}, {want['causal_conv1d']}, "
        f"{want[step_k]}); others {'0' if not bad else bad}; plain "
        f"versions {plain}  {'ok' if not bad and not plain else 'FAIL'}")
    if bad or plain:
        FAILURES.append(f"{tag} launches")
    ok = (facts["dspb"] == facts["local_bytes"] == want_dspb
          and facts["dspb"] < facts["spb"] and facts["back"]
          and facts["straddled"] == 0)
    log(f"  {tag}: device_state_bytes_per_slot {facts['dspb']} (the rank's "
        f"leaves {facts['local_bytes']}, expected {want_dspb}) < "
        f"state_bytes_per_slot {facts['spb']}; every slot back "
        f"{facts['back']}; straddled steps {facts['straddled']} (whole "
        f"groups at d_inner {cfg.d_inner}/{TP})  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{tag} pool")


def tp_collective_ms(mesh, dev, cfg, dtype):
    """4m: one ``sharding.all_reduce_sum`` alone, at the shapes a decode
    step of 4 slots sums (out_proj's and the embedding's (4, d_model),
    x_proj's (4, dt_rank + 2 n)), on CUDA tensors over gloo between the
    two ranks on the card: wall ms a call (the stream synchronised before
    each), median and mean of ``TP_COLLECTIVE_CALLS`` after 20 warm-ups."""
    import statistics
    from repro_torch.parallel import sharding
    out = {}
    dt = getattr(torch, dtype)
    with sharding.use_mesh(mesh):
        for width in (cfg.d_model, cfg.dt_rank + 2 * cfg.d_state):
            t = torch.ones(4, width, device=dev, dtype=dt)
            times = []
            for i in range(20 + TP_COLLECTIVE_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sharding.all_reduce_sum(t)
                if i >= 20:
                    times.append((time.perf_counter() - t0) * 1e3)
            out[f"(4, {width}) {dtype}"] = dict(
                median_ms=statistics.median(times),
                mean_ms=statistics.fmean(times))
    return out


def tp_dspb(cfg, sd, dtype):
    """mamba-2.8b's bytes a slot on one rank: h (L, d_inner/tp, 16) at its
    storage width (+ its replicated (L, g) f32 scales), conv (L, 3,
    d_inner/tp) in the compute dtype, pos 4."""
    from repro_torch.core import state_quant
    L, d = cfg.n_layers, cfg.d_inner // TP
    h = L * d * 16 * (1 if state_quant.is_quantized(sd) else 4)
    if state_quant.is_quantized(sd):
        h += L * state_quant.n_groups(cfg.d_inner) * 4
    return h + L * 3 * d * (4 if dtype == "float32" else 2) + 4


def tp_single_serves(cfg, dev):
    """Rank 0's single-device references of 4m on the full tree."""
    def run(full):
        out = {}
        for run in TP_SERVE_RUNS:
            out[run] = tp_serve(cfg, full, run, dev)
            smry = out[run][2]
            log(f"  4m one device {run}: {smry['tokens_per_s']:.1f} tok/s")
        return out
    return run


def tp_families(mesh, dev):
    """3m's other models at tp=2: qwen2-7b at full width cut to 2 layers
    (28/4 heads of 128: 14/2 a rank; vocab 152064) and xlstm-350m at full
    width and depth (4 heads: 2 a rank)."""
    import gc
    qcfg = transformer_cfg(QWEN, n_layers=2, dtype="float32")
    tp_model(mesh, dev, "qwen2-7b", qcfg, TP_PROMPT)
    gc.collect()
    torch.cuda.empty_cache()
    xcfg = xlstm_cfg(dtype="float32", step_impl="fused")
    tp_model(mesh, dev, "xlstm-350m", xcfg, TP_XLSTM_PROMPT)
    gc.collect()
    torch.cuda.empty_cache()


def tp_nccl_one(dev):
    """tp=1 over NCCL (rank 0 alone in an NCCL group): mamba-130m's
    prefill and decode logits and its served streams bitwise the no-mesh
    engine's."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import registry
    from repro_torch.runtime.engine import Engine, EngineConfig
    group = dist.new_group([0], backend="nccl")
    if dist.get_rank() != 0:
        return None
    mesh = make_serving_mesh(1, group=group)
    cfg = tp_cfg("mamba-130m", dtype="float32")
    params = registry.init_params(cfg, seed=SEED, device=dev, draw_device=dev)
    a, _ = tp_forward(cfg, params, dev, TP_PROMPT)
    b, _ = tp_forward(cfg, params, dev, TP_PROMPT, mesh)
    same_logits = bool(torch.equal(a, b))
    streams = []
    for m in (None, mesh):
        eng = Engine(cfg, params, EngineConfig(
            n_slots=4, max_seq=SERVE_MAX_SEQ, device=str(dev), mesh=m))
        reqs = [eng.submit(p, sp) for p, sp in tp_traffic(cfg)[:4]]
        eng.run()
        streams.append([(r.tokens, r.logprobs) for r in reqs])
    same = same_logits and streams[0] == streams[1]
    log(f"  tp=1 over NCCL ({mesh.backend}), mamba-130m f32: prefill and "
        f"decode logits bitwise {same_logits}, 4 served streams and their "
        f"logprobs bitwise {streams[0] == streams[1]}  "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        FAILURES.append("tp=1 over NCCL bitwise")
    return same


def tp_timing(dev):
    """The kernels at their shard widths (rank 0, after the tp runs):
    mamba-2.8b's d_inner 5120/2 for K4 (prefill, L 512), K5 (decode and
    prefill), K1 and K2 (4 slots); qwen2-7b's 14/2 heads of 128 for K7
    (L 512), bf16."""
    from repro_torch.core import weight_quant
    from repro_torch.kernels import conv1d, decode_step, flash_attention
    from repro_torch.kernels import ref, selective_scan
    import torch.nn.functional as F
    bf = torch.bfloat16
    d, n, r, k = 5120 // TP, 16, 160, 4
    gen = torch.Generator().manual_seed(SEED + 51)
    rows = {}
    x, dt, A, B, C, D, z, _ = scan_inputs(1, 512, d, n, r, bf, gen, dev,
                                          h0=False)
    nb, ops_, _ = s6_work(1, 512, d, n, 2, False)
    rows["selective_scan"] = measure(
        "selective_scan", f"b=1 L=512 d={d} (5120/{TP}) n=16 bf16",
        lambda: selective_scan.selective_scan(x, dt, A, B, C, D=D, z=z),
        lambda: ref.selective_scan(x, dt, A, B, C, D=D, z=z), None,
        (nb, ops_), 10)
    xc, w, bias, x_prev = conv_inputs(4, 1, d, k, bf, gen, dev)
    xp = torch.cat([x_prev, xc], 1).transpose(1, 2).contiguous()
    wl, bl = w.t().contiguous().unsqueeze(1).to(bf), bias.to(bf)
    rows["causal_conv1d"] = measure(
        "causal_conv1d", f"b=4 L=1 d={d} k=4 bf16 (decode)",
        lambda: conv1d.causal_conv1d(xc, w, bias, x_prev),
        lambda: ref.causal_conv1d(xc, w, bias, x_prev),
        lambda: F.conv1d(xp, wl, bl, groups=d), conv_work(4, 1, d, k, 2), 50)
    x, dt, A, B, C, D, z, h = scan_inputs(4, 1, d, n, r, bf, gen, dev)
    args = (h, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    rows["decode_step"] = measure(
        "decode_step", f"slots=4 d={d} n=16 bf16, f32 state, f32 A",
        lambda: decode_step.selective_state_step(*args, D=D, z_t=z[:, 0]),
        lambda: ref.selective_state_step(*args, D=D, z_t=z[:, 0]), None,
        s6_work(4, 1, d, n, 2, True)[:2], 50)
    A_q, a_scale = weight_quant.quantize_rows(A)
    hq, h_scale = q_state(h, "int8")
    argsq = (hq, h_scale, x[:, 0], dt[:, 0], A_q, B[:, 0], C[:, 0])
    kwq = dict(D=D, z_t=z[:, 0], state_dtype="int8", a_scale=a_scale)
    rows["decode_step_q"] = measure(
        "decode_step_q", f"slots=4 d={d} n=16 bf16, int8 state, int8 A",
        lambda: decode_step.selective_state_step_q(*argsq, **kwq),
        lambda: ref.selective_state_step_q(*argsq, **kwq), None,
        q_step_work(4, d, n, 2), 50)
    hq_, hkv, dh, L = 28 // TP, 4 // TP, 128, 512
    q = torch.randn(1, L, hq_, dh, generator=gen).to(dev, bf)
    kk = torch.randn(1, L, hkv, dh, generator=gen).to(dev, bf)
    v = torch.randn(1, L, hkv, dh, generator=gen).to(dev, bf)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, kk, v))
    rows["flash_attention"] = measure(
        "flash_attention", f"b=1 L=512 heads {hq_}/{hkv} (28/4 over {TP}) "
        f"x 128 bf16",
        lambda: flash_attention.flash_attention(q, kk, v, causal=True),
        lambda: ref.attention(q, kk, v, causal=True),
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                               enable_gqa=True),
        flash_work(1, L, L, hq_, hkv, dh, 2), 10, flops=BF16_FLOPS)
    return rows


def tp_rank(rank, world, tmp):
    """One rank of phases 2m, 3m and 4m (spawned; rank 0 prints).  Writes
    its failures and results to ``tmp``/rank<r>.json."""
    import gc
    import traceback
    global log
    torch.set_num_threads(1)
    if rank:
        log = lambda msg="": None                       # noqa: E731
    out = {}
    try:
        from repro_torch import resolve_device
        from repro_torch.launch.mesh import init_ranks, make_serving_mesh
        init_ranks(rank, world, Path(tmp) / "store", "gloo",
                   timeout_s=TP_GLOO_TIMEOUT)
        dev = resolve_device("cuda")
        mesh = make_serving_mesh(world)
        log(f"  mesh: {mesh}")
        t0 = time.perf_counter()
        log("== phase 2m: collectives on CUDA tensors over gloo; the "
            "sequence-parallel scan; the straddled-group step")
        out["collectives"] = tp_probe(mesh, dev)
        out["scan_launches"] = tp_scan(mesh, dev)
        out["straddle"] = tp_straddle(mesh, dev)
        out["launches_2m"] = dict(LAUNCHES_2M)
        log(f"  phase 2m: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log(f"== phase 3m: {TP_ARCH} (64 layers, full width) f32 at tp={TP} "
            f"vs one device on the card; tp=1 over NCCL; qwen2-7b and "
            f"xlstm-350m at tp={TP}")
        cfg = tp_cfg(TP_ARCH, dtype="float32")
        n_ar, extra = tp_model(mesh, dev, TP_ARCH, cfg, TP_PROMPT,
                               full_cb=tp_single_serves(cfg, dev))
        singles, full = extra
        out["all_reduces_per_step"] = n_ar
        log(f"  phase 3m {TP_ARCH}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log(f"== phase 4m: serve {TP_ARCH} at tp={TP} through Engine(mesh=)"
            f", 9 requests on 4 slots, against one device")
        out["serve"] = {}
        for run in TP_SERVE_RUNS:
            wd, sd, dtype = run
            tag = f"4m tp={TP} {wd} weights {sd} state {dtype}"
            streams, snap, smry, facts, steps = tp_serve(cfg, full, run, dev,
                                                         mesh)
            tp_hold_serve(tag, cfg, sd, snap, facts, steps,
                          tp_dspb(cfg, sd, dtype))
            step_ms = facts["decode_s"] / max(steps[1], 1) * 1e3
            log(f"  {tag}: a pooled decode step {step_ms:.2f} ms of wall "
                f"time (decode time over decode steps: sampling and the "
                f"broadcast included, prefills not)")
            one = singles[run][2]["tokens_per_s"] if rank == 0 else None
            log(f"  {tag}: {smry['tokens_per_s']:.1f} tok/s against "
                f"{one if one is None else f'{one:.1f}'} tok/s on one "
                f"device (two ranks sharing one card over gloo: not a "
                f"tensor-parallel speedup); collectives "
                f"{facts['collectives']}")
            if rank == 0 and dtype == "float32":
                tp_hold_streams(tag, streams, singles[run][0], TP_TIE[wd, sd])
            out["serve"][f"{wd}/{sd}/{dtype}"] = dict(
                launches={k: v for k, v in snap.items() if v},
                tokens_per_s=smry["tokens_per_s"],
                one_device_tokens_per_s=one, steps=steps,
                bytes_per_slot=(facts["spb"], facts["dspb"]),
                collectives=facts["collectives"], decode_step_ms=step_ms)
        out["collective_ms"] = tp_collective_ms(mesh, dev, cfg, "float32")
        for shape, ms in out["collective_ms"].items():
            log(f"  4m: one all_reduce_sum of {shape} on cuda over gloo, "
                f"alone: median {ms['median_ms']:.3f} ms, mean "
                f"{ms['mean_ms']:.3f} ms ({TP_COLLECTIVE_CALLS} calls)")
        del full, singles, extra
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  phase 4m: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["nccl_tp1"] = tp_nccl_one(dev)
        tp_families(mesh, dev)
        log(f"  phase 3m (tp=1 NCCL, qwen2-7b, xlstm-350m): "
            f"{time.perf_counter() - t0:.1f} s")
        if rank == 0:
            t0 = time.perf_counter()
            log("== phase 5m: kernels at their shard widths")
            out["timing"] = tp_timing(dev)
            log(f"  phase 5m: {time.perf_counter() - t0:.1f} s")
    except BaseException:
        FAILURES.append(f"rank {rank}: {traceback.format_exc()}")
        print(f"rank {rank} raised:\n{traceback.format_exc()}", flush=True)
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(
        {"failures": FAILURES, "out": out}, default=str))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def phase_tp():
    """Phases 2m-5m: two spawned ranks on the one card; their failures
    become this process's.  Returns rank 0's results."""
    import shutil
    import torch.multiprocessing as mp
    tmp = ROOT / "build" / "tp_ranks"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_rank, args=(r, TP, str(tmp)))
             for r in range(TP)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + TP_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            FAILURES.append(f"tp rank {r} still running after {TP_TIMEOUT} s")
    results = []
    for r in range(TP):
        f = tmp / f"rank{r}.json"
        if not f.exists():
            FAILURES.append(f"tp rank {r} wrote no result (exit code "
                            f"{procs[r].exitcode})")
            results.append({})
            continue
        res = json.loads(f.read_text())
        FAILURES.extend(f"tp rank {r}: {x}" for x in res["failures"])
        results.append(res["out"])
    return results[0]


T_START = time.perf_counter()


def phase_ok() -> bool:
    if FAILURES:
        log(f"FAILED: {FAILURES}")
        log(f"total {time.perf_counter() - T_START:.1f} s")
    return not FAILURES


def main() -> int:
    global T_START
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import dataclasses
    from repro_torch import configs, resolve_device
    from repro_torch.models import registry
    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}")
    cfg = dataclasses.replace(configs.get_config(ARCH), scan_impl="pallas",
                              conv_impl="pallas", step_impl="fused")
    T_START = time.perf_counter()

    log("== phase 1: build")
    phase_build()
    if "--tp-only" in sys.argv[1:]:
        # the tensor-parallel phases alone, after the build (prints their
        # results, not the run's result line)
        tp = phase_tp()
        log(json.dumps({"tp": tp}, default=str))
        return 0 if phase_ok() else 1
    log("== phase 2: kernels vs plain versions on the card")
    errs = phase_kernels(cfg, dev)
    log("  K3 at one slot (the prefix cache's suffix chain)")
    check_k3_one(cfg, dev)
    if not phase_ok():
        return 1
    log("== phase 3: mamba-130m f32, kernel path (card) vs plain path (CPU)")
    params = registry.init_params(cfg, seed=SEED)
    phase_model("mamba-130m", cfg, params, MODEL_RUNS, dev, lambda c: c)
    if not phase_ok():
        return 1
    log("== phase 3s: mamba-130m f32 verify window (card) vs CPU, vs chained "
        "steps and select_step; K3 at 8 slots")
    check_k3_eight(cfg, dev)
    phase_spec_window("mamba-130m", cfg, params, SPEC_WINDOW_RUNS, dev,
                      lambda c: {k: v for k, v in c.items() if k != "pos"},
                      chained=True)
    if not phase_ok():
        return 1
    # the launches reported per kernel, from the serve run that serves it
    counts = {}
    if not phase_serves(4, MAMBA, cfg, params, SERVE_RUNS, dev, card,
                        counts):
        return 1
    # and from the first speculative serve run that runs it
    spec_counts = {}
    if not phase_spec_serves("4s", cfg, params, SPEC_RUNS, (64, 127), dev,
                             card, spec_counts):
        return 1
    log("== phase 4s.t: one verify pass against plain decode steps")
    time_verify(cfg, params, dev)
    # the serving front: each kernel's launches from the first prefix-cache
    # run that runs it
    front_counts = {}
    if not phase_prefix("4p", MAMBA, cfg, params, PREFIX_RUNS, front_traffic(
            cfg, 256, (16, 32, 48, 64) * 2, (3, 6), 32), 64, dev, card,
            front_counts, tie_tol=SPEC_BF16_TIE, host_store=True):
        return 1
    if not phase_best_of_n("4b", cfg, params, dev, card):
        return 1
    if not phase_disagg("4d", cfg, params, DISAGG_RUNS, dev, card):
        return 1
    log("== phase 5: kernel timing (CUDA events)")
    kernels = phase_timing(cfg, dev, counts, errs)
    if not phase_ok():
        return 1
    # xLSTM after every mamba phase and before jamba: the mamba phases
    # run as they did before, and xLSTM's host-bound serving has no 53 GB
    # model ahead of it
    log("== phase 2x: K3-mlstm and K3-slstm vs plain versions, xlstm-350m "
        "widths")
    check_xlstm_kernels(dev, errs)
    log("  K3-mlstm and K3-slstm at one slot")
    check_k3_one_xlstm(dev)
    if not phase_ok():
        return 1
    log("== phase 2u: K8 (fast exp) and K9 (piecewise SiLU) vs plain "
        "versions, bitwise")
    check_units(dev, counts, errs)
    if not phase_ok():
        return 1
    log(f"== phase 3x: xlstm-350m f32 ({XLSTM_MODEL_LAYERS} of 24 layers), "
        f"prefill {XLSTM_PROMPT}, card vs CPU")
    from repro_torch.core import state_quant
    phase_model("xlstm-350m", xlstm_cfg(n_layers=XLSTM_MODEL_LAYERS),
                layer_view(xlstm_params(dev), XLSTM_MODEL_LAYERS),
                XLSTM_MODEL_RUNS, dev, lambda c: {
                    "h": c["layers"][0]["mlstm"]["C"],
                    "h_scale": c["layers"][0]["mlstm"].get("C_scale"),
                    "conv": c["layers"][0]["mlstm"]["conv"]},
                lp=XLSTM_PROMPT, dequant=state_quant.dequantize_mat)
    log("  xlstm-350m verify window (card) vs CPU, layer 0's mLSTM state")
    phase_spec_window("xlstm-350m", xlstm_cfg(), xlstm_params(dev),
                      SPEC_WINDOW_RUNS[:1], dev, lambda c: c["layers"][0][
                          "mlstm"], slots=2, starts=(0,))
    if not phase_ok():
        return 1
    if not phase_serves("4x", XLSTM_SERVED, xlstm_cfg(), xlstm_params(dev),
                        XLSTM_SERVE_RUNS, dev, card, counts):
        return 1
    if not phase_spec_serves("4xs", xlstm_cfg(), xlstm_params(dev),
                             XLSTM_SPEC_RUNS, (64,), dev, card, spec_counts):
        return 1
    if not phase_prefix("4xp", XLSTM_SERVED, xlstm_cfg(), xlstm_params(dev),
                        XLSTM_PREFIX_RUNS, front_traffic(
                            xlstm_cfg(), 64, (16,) * 4, (3,), 16), 64, dev,
                        card, front_counts, sequential=True):
        return 1
    log("== phase 5x: xLSTM kernel, unit and decode-step timing")
    kernels += phase_xlstm_timing(dev, counts, errs)
    _XLSTM.clear()
    torch.cuda.empty_cache()
    if not phase_ok():
        return 1
    # jamba after every mamba phase: the mamba phases run as they did
    # before jamba was ported, with no 53 GB model or CPU-side model run
    # ahead of their host-bound serving
    log("== phase 2j: K7 and K3-jamba vs plain versions, jamba-v0.1 widths")
    check_jamba_kernels(dev, errs)
    log("  K3-jamba at one slot")
    check_k3_one_jamba(dev)
    if not phase_ok():
        return 1
    log("== phase 3j: jamba-v0.1-52b dense variant (8 layers) f32, card vs "
        "CPU")
    phase_model("dense jamba", jamba_cfg(n_experts=0), jamba_params(True, dev),
                JAMBA_MODEL_RUNS, dev, lambda c: c["layers"]["pos0"])
    log("  dense jamba verify window (card) vs CPU, position 0's state")
    phase_spec_window("dense jamba", jamba_cfg(n_experts=0),
                      jamba_params(True, dev), SPEC_WINDOW_RUNS[:1], dev,
                      lambda c: c["layers"]["pos0"], slots=2, starts=(0,))
    jamba_free("dense")
    if not phase_ok():
        return 1
    if not phase_serves("4j", JAMBA_SERVED, jamba_cfg(),
                        jamba_params(False, dev), JAMBA_SERVE_RUNS, dev,
                        card, counts):
        return 1
    if not phase_spec_serves("4js", jamba_cfg(), jamba_params(False, dev),
                             JAMBA_SPEC_RUNS, (64,), dev, card, spec_counts):
        return 1
    if not phase_prefix("4jp", JAMBA_SERVED, jamba_cfg(),
                        jamba_params(False, dev), JAMBA_PREFIX_RUNS,
                        front_traffic(jamba_cfg(), 64, (16,) * 4, (3,), 8),
                        64, dev, card, front_counts, sequential=True):
        return 1
    log("== phase 5j: jamba kernel and decode-step timing")
    kernels += phase_jamba_timing(dev, counts, errs)
    jamba_free("moe")
    if not phase_ok():
        return 1
    # the transformers after jamba, with its 53 GB freed: qwen2-7b (30.5 GB
    # in f32) and qwen2-moe-a2.7b cut to 8 layers (22 GB), one at a time
    t0 = time.perf_counter()
    log("== phase 2t: K7 vs plain at the transformer head layouts")
    k7_errs = check_transformer_k7(dev)
    phase_seconds("2t", t0)
    if not phase_ok():
        return 1
    t0 = time.perf_counter()
    log(f"== phase 3t: {QWEN} (full width, 2 of 28 layers) f32, card vs CPU")
    qcfg = transformer_cfg(QWEN)
    qparams = transformer_params(QWEN, 28, dev)
    phase_transformer_model(f"{QWEN} (2 layers)",
                            dataclasses.replace(qcfg, n_layers=2),
                            layer_view(qparams, 2), TRANSFORMER_MODEL_RUNS,
                            dev)
    phase_seconds("3t", t0)
    if not phase_ok():
        return 1
    t_counts = {}
    ok, serve_smry = phase_transformer_serves(
        "4t", QWEN_SERVED, qcfg, qparams, (("f32", "model"), ("int8", "int8")),
        dev, card, t_counts)
    if not ok:
        return 1
    t0 = time.perf_counter()
    tp_counts = {}
    # depth cut to 4 layers: a chain step is a batch-1 eager decode step,
    # host-bound at 28 layers (72 ms), and the cold admissions that every
    # stream is held to chain about 1,850 of them
    pcfg = dataclasses.replace(qcfg, n_layers=PREFIX_LAYERS)
    if not phase_prefix("4tp", QWEN_PREFIX_SERVED, pcfg, layer_view(
            qparams, PREFIX_LAYERS), (
            ("f32", "f32", "model", kv_slot_bytes(pcfg, "model"), None, (),
             (), True),), front_traffic(pcfg, 256, (16, 32, 48, 64) * 2,
                                        (3, 6), 32), 64, dev, card,
            tp_counts):
        return 1
    phase_seconds("4tp", t0)
    t0 = time.perf_counter()
    log(f"== phase 5t: K7 at the transformer layouts, {QWEN} decode step, "
        f"prefill and serving")
    k7_rows = phase_transformer_timing(dev, serve_smry)
    phase_seconds("5t", t0)
    del qparams
    transformer_free()
    if not phase_ok():
        return 1
    t0 = time.perf_counter()
    # one layer: the CPU's f32 expert GEMMs took 29 s at 2 layers; the
    # logits' difference is the unembedding's, not the depth's (1.4e-5 at
    # 1 layer, 1.6e-5 at 2), so TRANSFORMER_MODEL_RUNS' 2e-3 stands
    log(f"== phase 3t: {QWEN_MOE} (full width, 1 of 24 layers) f32, card vs "
        f"CPU, expert capacity = expert count")
    mcfg = transformer_cfg(QWEN_MOE, n_layers=8)
    mparams = transformer_params(QWEN_MOE, 8, dev)
    phase_transformer_model(
        f"{QWEN_MOE} (1 layer)", dataclasses.replace(
            mcfg, n_layers=1, capacity_factor=float(mcfg.n_experts)),
        layer_view(mparams, 1), TRANSFORMER_MODEL_RUNS[:1], dev)
    phase_seconds("3t moe", t0)
    if not phase_ok():
        return 1
    ok, _ = phase_transformer_serves("4tm", QWEN_MOE_SERVED, mcfg, mparams,
                                     (("f32", "model"),), dev, card,
                                     t_counts)
    del mparams
    transformer_free()
    if not ok:
        return 1
    t0 = time.perf_counter()
    log("== phase 2g: the scan, conv and K7 Functions vs autograd through "
        "their plain versions, on the card")
    grad_errs = phase_train_functions(dev)
    phase_seconds("2g", t0)
    if not phase_ok():
        return 1
    t0 = time.perf_counter()
    log("== phase 3g: model gradients, card vs CPU, f32, full width, 2 "
        "layers")
    for arch, n_layers, b, L in TRAIN_MODEL_RUNS:
        phase_train_model(arch, n_layers, b, L, dev)
    phase_seconds("3g", t0)
    if not phase_ok():
        return 1
    train = {}
    split = None
    for arch, fields, resume_at in TRAIN_RUNS:
        t0 = time.perf_counter()
        log(f"== phase 4g: train {arch} at full width and depth")
        train[arch], state = phase_train_run(arch, fields, resume_at, dev,
                                             card)
        phase_seconds(f"4g {arch}", t0)
        if not phase_ok():
            return 1
        if arch == ARCH:
            t0 = time.perf_counter()
            log(f"== phase 5g: one {arch} step split: forward, backward, "
                f"optimizer")
            split = phase_train_split(state, dev)
            phase_seconds("5g", t0)
        del state
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    if not phase_ok():
        return 1
    # tensor-parallel serving last: its ranks share the card with nothing
    # else left on it
    t0 = time.perf_counter()
    tp = phase_tp()
    phase_seconds("2m-5m", t0)
    if not phase_ok():
        return 1
    log(f"total {time.perf_counter() - T_START:.1f} s")
    for entry in kernels:
        # the tensor-parallel phases: the kernel's launches on rank 0 in 2m
        # and in each 4m run, and its row at the shard widths (5m)
        n = entry["name"]
        entry["tp_launches"] = {"2m": tp["launches_2m"].get(n, 0), **{
            f"4m {run}": s["launches"].get(n, 0)
            for run, s in tp["serve"].items()}}
        if n in tp["timing"]:
            entry["tp_shard_row"] = tp["timing"][n]
        # the launches of the speculative serve runs (phases 4s, 4xs, 4js)
        # and of the prefix-cache runs (4p, 4xp, 4jp)
        entry["spec_launches"] = spec_counts.get(entry["name"], 0)
        entry["prefix_launches"] = front_counts.get(entry["name"], 0)
        if entry["name"] == "flash_attention":
            # the transformer phases: K7's launches in 4t (f32, int8),
            # 4tp and 4tm, its largest bf16 error at each head layout
            # (2t) and its rows at qwen2-7b's and granite's layouts (5t)
            entry["transformer_launches"] = {
                "4t f32": t_counts["4t", "f32", "model"],
                "4t int8": t_counts["4t", "int8", "int8"],
                "4tp": tp_counts.get("flash_attention", 0),
                "4tm": t_counts["4tm", "f32", "model"]}
            entry["transformer_max_abs_err"] = k7_errs
            entry["transformer_shapes"] = k7_rows
        if entry["name"] in grad_errs:
            # training (2g, 4g): the Function's largest f32 gradient error
            # (a share of the gradient's max-abs) and the kernel's
            # launches a step and a microbatch of each 4g run, as counted
            n = entry["name"]
            entry["grad_err_of_max_abs"] = grad_errs[n]
            entry["training_launches"] = {
                arch: {"per_step": t["launches"][n] // t["steps"],
                       "per_microbatch": t["launches"][n]
                       // (t["steps"] * t["grad_accum"])}
                for arch, t in train.items() if n in t["launches"]}
    log(json.dumps({"training": {arch: {k: t[k] for k in (
        "losses", "median_step_s", "tokens_per_s", "peak_gib",
        "resume_max_abs_diff", "resume_bitwise") if k in t}
        for arch, t in train.items()}, "step_split": split}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
