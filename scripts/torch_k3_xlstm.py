#!/usr/bin/env python3
"""K3's xLSTM instances (K3-mlstm, K3-slstm) alone on the card.

Builds only the megakernel sources (``megakernel_*.cu``) and the conv
(``conv1d.cu``, which the per-layer decode step runs), prints the
compiler's register and spill report for every K3-xLSTM kernel
instantiation, holds the kernels against their plain versions at
xlstm-350m's widths with 4 slots (``chip_smoke.py``'s rules: f32 over a
7-layer run, bf16 layer by layer with the run's one launch bitwise equal
to its layers launched in turn, a repeated launch bit for bit), times the
bf16 rows (a 7-layer K3-mlstm run with f32 or int8 weights and state, one
K3-slstm layer) and the whole decode step through K3 beside the per-layer
one, then splits K3's time into its phases.  For that it makes a second
build of the same sources with ``-DXL_STAMPS=1`` from a copy whose every
``grid.sync()`` is wrapped in ``%globaltimer`` stamps (each block's thread
0, before and after the barrier, with the SM's clock64 beside each), with
marks inside the mLSTM phases where their code allows (a GEMV's tile in,
its rows accumulated, its sums handed out; an item's arrival at its
counter); the stamps go to a buffer just before the scratch this script
passes, so the stamped library is only launched from here.  Run from the
repository root on a machine with a CUDA card:

    python3 scripts/torch_k3_xlstm.py [--root DIR] [--quick] [--same-weights]

``--root`` takes the kernels, the wrapper and the model from another
checkout (a ``git archive`` of an earlier commit), so two versions run
through the same checks, timings and stamps; ``--quick`` skips the
checks and the decode step; ``--same-weights`` also splits a run whose
layers all read the first layer's weights (in L2 from the second layer
on).  It exits non-zero if a check fails.
"""
import argparse
import ctypes
import re
import shutil
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

# the megakernel sources and the conv (K5, which the per-layer decode step
# runs): the library built here holds these entry points only
ENTRIES = ("marca_xlstm_stacked_run", "marca_xlstm_stacked_grid",
           "marca_causal_conv1d")
# the bf16 rows timed: (kind, layers, weights, state)
ROWS = (("mlstm", 7, "f32", "f32"), ("mlstm", 7, "int8", "int8"),
        ("mlstm", 7, "f32", "int8"), ("mlstm", 7, "int8", "f32"),
        ("slstm", 1, "f32", "f32"), ("slstm", 1, "int8", "f32"))
# 64-bit words a block may stamp: a quarter for the barrier stamps, a
# quarter for the marks inside a phase (each quarter's count first), and
# the SM's clock64 beside each in the other half; and the most blocks
STAMP_ROW = 1024
STAMP_BLOCKS = 1024
# prepended to the copy of megakernel_xlstm.cuh the stamped build compiles:
# thread 0 of each block appends %globaltimer to its row of the stamp
# buffer, which lies just before the scratch this script passes (so the
# stamped library is launched through ``launch_stamped`` only)
STAMP_MACRO = r"""
#if XL_STAMPS
static __device__ unsigned long long* xl_stamp_base;
#define XL_STAMP_AT(half)                                                   \
  do {                                                                      \
    unsigned long long* s_ = xl_stamp_base;                                 \
    if (threadIdx.x == 0) {                                                 \
      s_ += (size_t)blockIdx.x * %d + (half) * %d;                          \
      unsigned long long t_;                                                \
      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_));             \
      const unsigned long long n_ = s_[0];                                  \
      if (n_ + 1 < %d) {                                                    \
        s_[1 + n_] = t_;                                                    \
        s_[%d + 1 + n_] = clock64();                                       \
        s_[0] = n_ + 1;                                                     \
      }                                                                     \
    }                                                                       \
  } while (0)
#else
#define XL_STAMP_AT(half) do {} while (0)
#endif
#define XL_STAMP() XL_STAMP_AT(0)
#define XL_MARK() XL_STAMP_AT(1)
""" % (STAMP_ROW, STAMP_ROW // 4, STAMP_ROW // 4, STAMP_ROW // 2)
# (pattern, replacement, count expected or None for any) on the header's
# text: a stamp when a block starts, one before and one after every grid
# barrier (after the block's own threads are done), one when the block
# ends; in each kernel (one, xlstm_megakernel, in a tree before the sLSTM
# had a kernel of its own; mlstm_megakernel and slstm_megakernel after)
STAMP_EDITS = (
    (r"cg::grid_group grid = cg::this_grid\(\);",
     "cg::grid_group grid = cg::this_grid();\n  if (threadIdx.x == 0)\n"
     "    xl_stamp_base = (unsigned long long*)a.scratch - (size_t)%d * %d;\n"
     "  XL_STAMP();" % (STAMP_BLOCKS, STAMP_ROW), None),
    (r"if \(l \+ 1 < a\.L\) grid\.sync\(\);\n  \}\n",
     "if (l + 1 < a.L) grid.sync();\n  }\n  __syncthreads();\n  XL_STAMP();\n",
     None),
    (r"grid\.sync\(\);",
     "{ __syncthreads(); XL_STAMP(); grid.sync(); XL_STAMP(); }", None),
)
# marks inside the phases (where the anchors exist).  mLSTM: the end of
# C''s q/k GEMV, and every item's arrival at its counter (C', E).  sLSTM:
# LN(x) staged, each strip GEMV's tile in (wx, R; out), the cell begun,
# y staged (phase 2)
MARK_EDITS = (
    (r"(column<float>\(wt, S_NORM_B\), s0, nb, dm\);\n)",
     r"\1      XL_MARK();\n"),
    (r"(      cp_async_wait_group<0>\(\);\n    \}\n    __syncthreads\(\);\n)",
     r"\1    XL_MARK();\n"),
    (r"(      if \(cell\) \{\n        const float\* pre)",
     r"      XL_MARK();\n\1"),
    (r"(stage_gnorm<T>\(sm\.xs4, h, column<float>\(wt, S_GN\), s0, nb, "
     r"a\.nh, a\.dh\);\n)", r"\1      XL_MARK();\n"),
    (r"(column<float>\(wt, M_NORM_B\), s0, nb, a\.dm\);\n)",
     r"\1      XL_MARK();\n"),
    (r"(    cp_async_wait_all\(\);\n    __syncthreads\(\);\n)",
     r"\1    XL_MARK();\n"),
    (r"(\n#pragma unroll\n  for \(int si = 0; si < kSlots; \+\+si\) \{\n"
     r"#pragma unroll\n    for \(int c = 0; c < V; \+\+c\) \{\n"
     r"      float v = acc\[si\]\[c\];)", r"\n  XL_MARK();\1"),
    (r"(    if \(j0 \+ cc < N\) epi\(mm, si, j0 \+ cc, s\);\n  \}\n"
     r"  __syncthreads\(\);\n)", r"\1  XL_MARK();\n"),
    (r"if \(last_to_arrive\(", "XL_MARK(); if (last_to_arrive("),
)
# phase names by the number of phases a layer has (the barrier after a
# phase is charged to it; the last phase's barrier joins two layers)
PHASES = {("mlstm", 5): ("A norm+up+conv", "B q/k", "C cell", "D h+gnorm",
                         "E down"),
          ("mlstm", 3): ("A norm+up+conv", "C' q/k+cell+h", "E down"),
          ("slstm", 4): ("A norm+wx", "B R h", "C cell", "D out"),
          ("slstm", 2): ("1 norm+wx+Rh+cell", "2 gnorm+out")}


def log(*a):
    print(*a, flush=True)


_BUILDS = {}  # _lib.BUILDS as the tree has it


def configure(lib, csrc=None, defines=()):
    """Point ``_lib`` at the megakernel sources and the conv only (from
    ``csrc`` if given), each xLSTM unit built with ``defines`` added (the
    other units as ``_lib.BUILDS`` builds them)."""
    lib.SOURCES = tuple(s for s in lib.SOURCES
                        if s.startswith("megakernel") or s == "conv1d.cu")
    base = _BUILDS.setdefault("base", dict(lib.BUILDS))
    lib.BUILDS = {s: (tuple(tuple(d) + tuple(defines)
                            for d in base.get(s, ((),)))
                      if "xlstm" in s else base[s])
                  for s in lib.SOURCES if "xlstm" in s or s in base}
    lib._SIGNATURES = {k: v for k, v in lib._SIGNATURES.items()
                       if k in ENTRIES}
    if csrc is not None:
        lib.CSRC = csrc
    lib._lib = None
    t0 = time.perf_counter()
    so = lib.build()
    lib.lib()
    log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    return so


def patched_csrc(root, dest):
    """A copy of ``root``'s kernel sources with the stamps put in."""
    src = root / "src" / "repro_torch" / "csrc"
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(src, dest)
    header = dest / "megakernel_xlstm.cuh"
    text = header.read_text()
    for pattern, repl, want in STAMP_EDITS:
        text, n = re.subn(pattern, repl.replace("\\", "\\\\"), text)
        if (want is not None and n != want) or n == 0:
            raise RuntimeError(f"stamp edit {pattern!r} matched {n} times")
    for pattern, repl in MARK_EDITS:
        text, n = re.subn(pattern, repl, text)
        log(f"  mark {pattern[:40]!r}: {n} place(s)")
    anchor = "namespace marca {\nnamespace xl {\n"
    if anchor not in text:
        raise RuntimeError("no xl namespace in megakernel_xlstm.cuh")
    text = text.replace(anchor, anchor + STAMP_MACRO, 1)
    header.write_text(text)
    return dest


def sass_report(so):
    """Local-memory loads and stores (spill traffic) and instructions in
    each mLSTM kernel's SASS."""
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = (cs.xlstm_kernel_name(m.group(1))
                  if cs.is_xlstm_kernel(m.group(1)) else None)
            if fn and fn.startswith("mlstm"):
                counts[fn] = {"LDL": 0, "STL": 0, "instructions": 0}
            else:
                fn = None
        elif fn:
            counts[fn]["LDL"] += bool(re.search(r"\bLDL\b", line))
            counts[fn]["STL"] += bool(re.search(r"\bSTL\b", line))
            counts[fn]["instructions"] += bool(
                re.search(r"/\*[0-9a-f]{4,}\*/\s+[A-Z@]", line))
    for fn, n in sorted(counts.items()):
        log(f"  SASS {fn}: {n}")


def launch_stamped(lib, megakernel, cfg, x0, run, states, outs, stamps):
    """xlstm_stacked_run's launch with its scratch just after ``stamps``
    (STAMP_BLOCKS x STAMP_ROW int64 words), where the stamps go."""
    kind = run.kind
    slots, d, nh = x0.shape[0], cfg.d_model, cfg.n_heads
    dh = (2 * d if kind == "mlstm" else d) // nh
    n_max = megakernel.MAX_XLSTM_RUN
    x = torch.empty_like(x0)
    n = megakernel.xlstm_scratch_floats(kind, slots, d, nh)
    scratch = stamps.view(torch.float32)[2 * STAMP_BLOCKS * STAMP_ROW:]
    assert scratch.numel() >= n
    nparts = megakernel._XLSTM_NPARTS
    ptrs = (ctypes.c_int64 * (2 * nparts * n_max))()
    for c, part in enumerate(megakernel.XLSTM_PARTS[kind]):
        for i, (st, out) in enumerate(zip(states, outs)):
            ptrs[c * n_max + i] = lib.ptr(st.get(part)) or 0
            ptrs[(c + nparts) * n_max + i] = lib.ptr(out.get(part)) or 0
    c_dtype = states[0]["C"].dtype if kind == "mlstm" else torch.float32
    lib.call("marca_xlstm_stacked_run", x0.device, lib.ptr(run.table),
             lib.ptr(x0), lib.ptr(x), ctypes.cast(ptrs, ctypes.c_void_p),
             lib.ptr(scratch), n, int(kind == "slstm"),
             len(run.rows), slots, d, nh, cfg.d_conv, lib.DTYPES[x0.dtype],
             int(run.int8), lib.STATE_DTYPES[c_dtype],
             lib.SILU_IMPLS[cfg.silu_impl], float(dh ** -0.5))
    return x


def breakdown(stamps, grid, layers, kind):
    """Mean µs a layer of each phase (its first block out of the barrier
    before it to its last block into the barrier after it), of each
    barrier (the last block in to the last block out) and of the marks
    inside a phase (the k-th mark of the last block to reach it, from the
    phase's start), from one launch's stamps; plus the whole launch (first
    start to last end)."""
    half = STAMP_ROW // 4
    st = stamps[:grid * STAMP_ROW].view(grid, STAMP_ROW).cpu()
    counts = st[:, 0]
    k = int(counts[0])
    if not bool((counts == k).all()) or k < 2 or k % 2:
        raise RuntimeError(f"uneven stamps: {counts.unique().tolist()}")
    t = st[:, 1:1 + k].double() * 1e-3   # ns -> µs
    marks = [st[g, half + 1:half + 1 + int(st[g, half])].double() * 1e-3
             for g in range(grid)]
    arr, ext = t[:, 1:-1:2], t[:, 2:-1:2]
    nbar = arr.shape[1]
    per_layer = (nbar + 1) // layers
    names = PHASES[(kind, per_layer)]
    work = {n: 0.0 for n in names}
    bar = {n: 0.0 for n in names}
    skew = {n: 0.0 for n in names}
    mk = {n: {} for n in names}
    for i in range(nbar + 1):
        t0 = t[:, 0].min() if i == 0 else ext[:, i - 1].min()
        t1 = t[:, -1].max() if i == nbar else arr[:, i].max()
        name = names[i % per_layer]
        work[name] += float(t1 - t0) / layers
        if i < nbar:
            bar[name] += float(ext[:, i].max() - arr[:, i].max()) / layers
            skew[name] += float(ext[:, i].max() - ext[:, i].min()) / layers
        for g in range(grid):
            lo = t[g, 0] if i == 0 else ext[g, i - 1]
            hi = t[g, -1] if i == nbar else arr[g, i]
            inside = marks[g][(marks[g] >= lo) & (marks[g] <= hi)]
            for j, v in enumerate(inside.tolist()):
                mk[name].setdefault(j, [0.0] * (nbar + 1))
                mk[name][j][i] = max(mk[name][j][i], v - float(t0))
    marks_out = {n: [sum(v) / layers for _, v in sorted(mk[n].items())]
                 for n in names}
    total = float(t[:, -1].max() - t[:, 0].min())
    clk = st[:, STAMP_ROW // 2 + 1:STAMP_ROW // 2 + 1 + k].double()
    mhz = float(((clk[:, -1] - clk[:, 0]) / (t[:, -1] - t[:, 0])).mean())
    for n in names:  # the blocks' spread leaving the barrier, beside it
        bar[n] = (bar[n], skew[n])
    return work, bar, marks_out, (total, mhz), nbar


def phase_stamps(lib, dev, root, rows=ROWS[:2] + ROWS[4:5],
                 same_weights=False):
    """The stamped build (made once) and, for each row, its device time
    and phase breakdown; with ``same_weights`` every layer of the run
    reads the first layer's weights (their second reading finds them in
    L2)."""
    tag = "stamped"
    from repro_torch.kernels import megakernel
    xlstm_run_inputs = cs.shared_inputs().xlstm_run_inputs
    dest = HERE / "build" / "k3x_stamps" / f"{root.name}_{tag}" / "csrc"
    so = configure(lib, patched_csrc(root, dest), ("XL_STAMPS=1",))
    for name, r in cs.xlstm_registers(lib.build_log()).items():
        log(f"  {tag} build {name}: {r}")
    log(f"  ({tag} library {so.name})")
    sass_report(so)
    for kind, n, wd, sd in rows:
        c = cs.xlstm_cfg(dtype="bfloat16", weight_dtype=wd, state_dtype=sd)
        run, x0, states, outs = xlstm_run_inputs(c, kind, n, 4,
                                                 seed=cs.SEED + 400,
                                                 device=dev)
        if same_weights:
            run = megakernel.XlstmRun(c, kind, [run.rows[0]] * n)
        grid = megakernel.xlstm_launch_config(c, kind, torch.bfloat16,
                                              wd == "int8", dev)["grid"]
        # the scratch after the stamps holds at least one float, so its
        # address lies inside the buffer (an sLSTM launch needs none)
        n_scratch = max(1, megakernel.xlstm_scratch_floats(
            kind, 4, c.d_model, c.n_heads))
        stamps = torch.zeros(STAMP_BLOCKS * STAMP_ROW + -(-n_scratch // 2),
                             dtype=torch.int64, device=dev)

        def launch():
            launch_stamped(lib, megakernel, c, x0, run, states, outs, stamps)

        ms = cs.device_ms(launch, 5)
        reps = 10
        work = bar = marks = None
        total = 0.0
        for it in range(reps + 2):
            stamps[:grid * STAMP_ROW].zero_()
            launch()
            torch.cuda.synchronize()
            if it < 2:
                continue
            w, b, m, (tot, mhz), nbar = breakdown(stamps, grid, n, kind)
            work = w if work is None else {k: work[k] + w[k] for k in w}
            bar = b if bar is None else {
                k: (bar[k][0] + b[k][0], bar[k][1] + b[k][1]) for k in b}
            marks = m if marks is None else {
                k: [x + y for x, y in zip(marks[k], m[k])] for k in m}
            total += tot
        log(f"  {tag}{' (one layer s weights)' if same_weights else ''}: "
            f"phases of K3-{kind}, {n} layer(s), bf16, {wd} w, {sd} "
            f"state ({nbar} barriers a launch; {ms * 1e3:.1f} µs a launch "
            f"(graph); mean of {reps} launches, µs a layer): whole launch "
            f"{total / reps:.2f} µs; SM clock {mhz:.0f} MHz")
        for k in work:
            mtxt = ", ".join(f"{v / reps:.2f}" for v in marks[k])
            log(f"    {k:<16} work {work[k] / reps:8.2f}   barrier after "
                f"{bar[k][0] / reps:6.2f} (spread out "
                f"{bar[k][1] / reps:5.2f})" + (f"   marks at {mtxt}" if mtxt
                                                else ""))
        log(f"    sum a layer      work {sum(work.values()) / reps:8.2f}   "
            f"barriers {sum(v[0] for v in bar.values()) / reps:6.2f}")
        del run, states, outs


def checks(dev):
    """chip_smoke.py's K3-xLSTM rules at xlstm-350m, 4 slots: f32 over a
    7-layer run against the plain version; bf16 layer by layer, the run's
    launch bitwise equal to its layers launched in turn; one launch
    repeated bit for bit."""
    from repro_torch.kernels import megakernel, ref
    xlstm_run_inputs = cs.shared_inputs().xlstm_run_inputs
    for kind, n, wd, sd in ROWS:
        for dtype in ("float32", "bfloat16"):
            c = cs.xlstm_cfg(dtype=dtype, weight_dtype=wd, state_dtype=sd)
            run, x0, states, outs = xlstm_run_inputs(c, kind, n, 4,
                                                     seed=cs.SEED + 500,
                                                     device=dev)
            x1 = megakernel.xlstm_stacked_run(c, x0, run, states, outs)
            name = f"K3-{kind} L={n} {dtype} {wd} w {sd} state"
            if dtype == "float32":
                xr, want = ref.xlstm_stacked_run(c, x0, kind, run.rows,
                                                 states)
                torch.cuda.synchronize()
                cs.check_xlstm_run(name, c, kind, x1, outs, xr, want)
            else:
                cs.check_xlstm_layers(name, c, kind, run, x0, states, x1,
                                      outs)
                first = [{k: v.clone() for k, v in o.items()} for o in outs]
                x2 = megakernel.xlstm_stacked_run(c, x0, run, states, outs)
                torch.cuda.synchronize()
                same = torch.equal(x1, x2) and all(
                    torch.equal(u[k].view(torch.uint8),
                                v[k].view(torch.uint8))
                    for u, v in zip(first, outs) for k in u)
                log(f"  {name}: one launch repeated: "
                    f"{'bitwise equal' if same else 'FAIL'}")
                if not same:
                    cs.FAILURES.append(f"{name} repeat")
            del run, states, outs


def timing(dev):
    """The bf16 rows (chip_smoke's ``measure``: CUDA-graph device time,
    eager time, device kernels a call, the plain version, the bound)."""
    from repro_torch.kernels import megakernel, ref
    xlstm_run_inputs = cs.shared_inputs().xlstm_run_inputs
    for kind, n, wd, sd in ROWS:
        c = cs.xlstm_cfg(dtype="bfloat16", weight_dtype=wd, state_dtype=sd)
        run, x0, states, outs = xlstm_run_inputs(c, kind, n, 4,
                                                 seed=cs.SEED + 400,
                                                 device=dev)
        lc = megakernel.xlstm_launch_config(c, kind, torch.bfloat16,
                                            wd == "int8", dev)
        row = cs.measure(
            f"{kind} {wd}/{sd}", f"{n} layer(s), 4 slots, bf16; grid "
            f"{lc['grid']} x {lc.get('threads', 512)}, {lc['smem_bytes']} B "
            f"shared",
            lambda: megakernel.xlstm_stacked_run(c, x0, run, states, outs),
            lambda: ref.xlstm_stacked_run(c, x0, kind, run.rows, states),
            None, cs.xlstm_run_work(c, kind, n, 4, wd == "int8", sd, 2), 5)
        log(f"    K3-{kind} {wd} w {sd} state: {row['ms'] * 1e3:.1f} µs "
            f"device, {row['eager_ms'] * 1e3:.1f} eager, bound "
            f"{row['bound_ms'] * 1e3:.1f} ({row['bound_ms'] / row['ms']:.0%}"
            f" reached), plain {row['plain_ms'] * 1e3:.1f}")
        del run, states, outs


def decode_step(dev):
    """The whole xlstm-350m decode step at 4 slots, bf16, through K3 and
    per layer (chip_smoke's phase 5x), f32/f32 and int8/int8."""
    import dataclasses
    from repro_torch.models import registry
    params = cs.xlstm_params(dev)
    for wd, sd in (("f32", "f32"), ("int8", "int8")):
        c = cs.xlstm_cfg(dtype="bfloat16", weight_dtype=wd, state_dtype=sd)
        p = registry.quantize_params(c, params)
        cache = registry.init_cache(c, 4, 64, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}
        for impl in ("megakernel", "fused"):
            ci = dataclasses.replace(c, step_impl=impl)
            pi = registry.stack_params(ci, p) if impl == "megakernel" else p
            ms, how = cs.device_time(
                lambda ci=ci, pi=pi: registry.decode_step(ci, pi, cache,
                                                          batch), 3)
            log(f"    decode step {wd} w {sd} state, {impl}: {ms:.4f} ms "
                f"({how})")
        del p, cache
    cs._XLSTM.clear()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--same-weights", action="store_true",
                    help="also split a run whose layers all read layer 0's "
                    "weights (found in L2 from the second layer on)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_xlstm: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _lib
    if Path(_lib.__file__).resolve().parents[2] != root / "src":
        raise RuntimeError(f"repro_torch came from {_lib.__file__}")
    dev = torch.device("cuda")
    log(cs.card_line())
    log(f"tree: {root}")
    configure(_lib)
    for name, r in cs.xlstm_registers(_lib.build_log()).items():
        log(f"  {name}: {r}")
    if not args.quick:
        t0 = time.perf_counter()
        checks(dev)
        log(f"checks took {time.perf_counter() - t0:.1f} s")
    timing(dev)
    if not args.quick:
        decode_step(dev)
    phase_stamps(_lib, dev, root)
    if args.same_weights:
        phase_stamps(_lib, dev, root, rows=ROWS[:2], same_weights=True)
    log(cs.card_line())
    log(f"failures: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
