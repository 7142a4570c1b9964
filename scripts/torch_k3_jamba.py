#!/usr/bin/env python3
"""K3's mamba kernel (K3-jamba, K3-mamba) alone on the card.

Builds only ``megakernel_mamba.cu``, prints the compiler's register and
spill report for every ``mamba_megakernel`` instantiation and the SASS
instructions of each, holds the kernel against its plain versions with 4
slots (K3-jamba: one position at jamba-v0.1's widths; K3-mamba:
mamba-130m's 24 layers): f32 within ``chip_smoke.K3_TOL``, a bf16 launch
repeated bit for bit; times the bf16 rows (f32 weights and state, int8
weights and state: CUDA-graph device time, eager time, bound, plain
version), then splits K3's time into its phases.  For that it makes a
second build of the same source with ``-DXL_STAMPS=1`` from a copy whose
every ``grid.sync()`` is wrapped in ``%globaltimer`` stamps (the stamp
macro of ``scripts/torch_k3_xlstm.py``: each block's thread 0, before and
after the barrier, the SM's clock64 beside each), with marks at each
item's arrival at a counter; the stamps go to a buffer just before the
launch's scratch, which this script hands the wrapper in place of its
own.  Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_k3_jamba.py [--root DIR] [--quick] [--decode]
        [--sass FILE]

``--root`` takes the kernel, the wrapper and the models from another
checkout (a ``git archive`` of an earlier commit), so two versions run
through the same checks, timings and stamps; ``--quick`` skips the
checks; ``--decode`` builds every kernel and also times the whole decode
step at 4 slots, bf16, through K3 and per layer ("fused"): mamba-130m,
and jamba-v0.1 cut to one group of 8 layers with its 16 experts (53 GB
of f32 weights drawn on the card); ``--sass FILE`` writes the SASS
listing of one kernel (the bf16 jamba instance with int8 weights) to
FILE.  It exits non-zero if a check fails.
"""
import argparse
import dataclasses
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_k3_xlstm as txl  # noqa: E402

ENTRIES = ("marca_mamba_stacked_step", "marca_mamba_stacked_grid",
           "marca_mamba_stack_maps", "marca_jamba_stacked_run")
# the bf16 rows timed: (instance, weights, state)
ROWS = (("jamba", "f32", "f32"), ("jamba", "int8", "int8"),
        ("mamba", "f32", "f32"), ("mamba", "int8", "int8"))
MAMBA_LAYERS = 24
# marks at each streamed item's arrival and refill (--item-marks)
ITEM_MARKS = False
# (pattern, replacement, count expected) on megakernel_mamba.cu's text: a
# stamp when a block starts, one before and one after every grid barrier
# (after the block's own threads are done), one when the block ends
STAMP_EDITS = (
    (r"cg::grid_group grid = cg::this_grid\(\);",
     "cg::grid_group grid = cg::this_grid();\n  if (threadIdx.x == 0)\n"
     "    xl_stamp_base = (unsigned long long*)a.scratch - (size_t)%d * %d;\n"
     "  XL_STAMP();" % (txl.STAMP_BLOCKS, txl.STAMP_ROW), 1),
    (r"if \(l \+ 1 < a\.L\) grid\.sync\(\);\n  \}\n",
     "if (l + 1 < a.L) grid.sync();\n  }\n  __syncthreads();\n  XL_STAMP();\n",
     1),
    (r"grid\.sync\(\);",
     "{ __syncthreads(); XL_STAMP(); grid.sync(); XL_STAMP(); }", None),
)
# marks inside the phases, where the source has the anchors: a GEMV
# pass's norm taken, its inputs staged, its rows streamed, an item's
# arrival at a counter, the start of a wait on one
MARK_EDITS = (
    (r"(\n(\s*)prep\(s0, nb\);\n)", r"\1\2XL_MARK();\n"),
    (r"(\n\s*stage\(xs4, c0, c1, s0, nb\);\n\s*__syncthreads\(\);\n)",
     r"\1        XL_MARK();\n"),
    (r"(\n(\s*)if \(col_ok\)\n\s*stream_rows<T, TW, V>\([^;]*;\n)",
     r"\1\2XL_MARK();\n"),
    (r"if \(arrive_last\(", "XL_MARK(); if (arrive_last("),
    (r"(\n\s*)(wait_count\()", r"\1XL_MARK(); \2"),
    # the mamba instance's streamed GEMVs: inputs staged, rows summed
    (r"(\n(\s*)stage_norm4<T>\(xs4, redn, xsrc, [^;]*;\n)",
     r"\1\2XL_MARK();\n"),
    (r"(\n(\s*)stage_rows4\(xs4, (?:xa|yb), s0, nb, a\.di\);\n)",
     r"\1\2XL_MARK();\n"),
    (r"(\n(\s*))(for \(int e = threadIdx\.x; e < nb \* ncv;)",
     r"\1XL_MARK();\2\3"),
    # its items: arrived, refilled (``--item-marks`` only)
    (r"(\n(\s*)ring_wait\(smem_addr\(&r\.full\[slot_at\]\), parity\);\n)",
     r"\1\2ITEM_MARK();\n"),
    (r"(\n(\s*)if \(threadIdx\.x == 0 && r\.left > 0\) "
     r"ring_issue<TW>\(a, r\);\n)", r"\1\2ITEM_MARK();\n"),
)
# phase names of one layer (position) by design: the parent's 4/5 and
# 6/7 phases, this tree's (a leading "zero" phase: the counters zeroed
# before the first barrier)
PHASES = {
    "old": {("mamba", False): ("A norm+in_proj+conv", "B x_proj",
                               "C S6 step", "D out_proj"),
            ("mamba", True): ("A norm+in_proj+conv", "B x_proj",
                              "C S6 step", "C2 requant", "D out_proj"),
            ("jamba", False): ("A norm+in_proj+conv", "B x_proj",
                               "C S6 step", "D out_proj", "E norm2+w1+w3",
                               "F w2"),
            ("jamba", True): ("A norm+in_proj+conv", "B x_proj",
                              "C S6 step", "C2 requant", "D out_proj",
                              "E norm2+w1+w3", "F w2")},
    "new": {("jamba", False): ("A norm+in_proj+conv", "BC x_proj+S6",
                               "D out_proj", "E norm2+w1|w3", "F w2")},
}


# The streaming probe: how fast one block an SM (512 threads, K3's launch
# shape) can stream device memory into a ring of shared-memory stages fed
# by one producer warp while 15 consumer warps read every stage.  Modes: 0
# TMA bulk copies (one cp.async.bulk a 16 KB stage by one thread, an
# mbarrier a stage for its bytes), 1 cp.async 16-byte copies (the producer
# warp's 32 lanes, each arriving on the stage's mbarrier), 2 TMA tensor
# copies of a column panel (a 2-D tensor map over a row-major f32 matrix,
# each block its own 24 columns, 96 bytes of each row: the shape of K3's
# in_proj panels at mamba-130m).
PROBE_SRC = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a wait that traps after some 10 s rather than hang the card
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__global__ void __launch_bounds__(512, 1)
probe(const char* src, long long per_block, int stages, int stage_bytes,
      int mode, float* sink, const __grid_constant__ CUtensorMap map,
      int box_rows, int box_cols) {
  extern __shared__ __align__(1024) char ring[];
  __shared__ __align__(8) uint64_t full[8], empty[8];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(su32(&full[s])), "r"(mode == 1 ? 32 : 1));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(su32(&empty[s])), "r"(15));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n = (int)(per_block / stage_bytes);
  const char* base = src + blockIdx.x * per_block;
  if (warp == 0) {
    for (int i = 0; i < n; ++i) {
      const int s = i % stages;
      if (i >= stages) wait(su32(&empty[s]), ((i / stages) & 1) ^ 1);
      char* dst = ring + (size_t)s * stage_bytes;
      const uint32_t fb = su32(&full[s]);
      if (mode == 1) {
        for (int k = lane * 16; k < stage_bytes; k += 512)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                       :: "r"(su32(dst + k)),
                          "l"(base + (size_t)i * stage_bytes + k)
                       : "memory");
        asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];"
                     :: "r"(fb) : "memory");
      } else if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(fb), "r"(stage_bytes) : "memory");
        if (mode == 0)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];"
              :: "r"(su32(dst)), "l"(base + (size_t)i * stage_bytes),
                 "r"(stage_bytes), "r"(fb) : "memory");
        else
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
              "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
              :: "r"(su32(dst)), "l"(reinterpret_cast<uint64_t>(&map)),
                 "r"(fb), "r"(blockIdx.x * box_cols), "r"(i * box_rows)
              : "memory");
      }
    }
  } else {
    float acc = 0.0f;
    const float4* v = reinterpret_cast<const float4*>(ring);
    for (int i = 0; i < n; ++i) {
      const int s = i % stages;
      wait(su32(&full[s]), (i / stages) & 1);
      const int nv = stage_bytes / 16;
      for (int k = threadIdx.x - 32; k < nv; k += 480) {
        const float4 u = v[(size_t)s * nv + k];
        acc += u.x + u.y + u.z + u.w;
      }
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(su32(&empty[s])) : "memory");
    }
    if (acc == 1234.5f) sink[0] = acc;
  }
}

typedef CUresult (*EncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);

extern "C" int probe_run(const void* src, long long per_block, int stages,
                         int stage_bytes, int mode, int blocks, void* sink,
                         long long rows, int box_rows, int box_cols,
                         void* stream) {
  CUtensorMap map{};
  if (mode == 2) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || p == nullptr) return -1;
    const cuuint64_t dims[2] = {(cuuint64_t)blocks * box_cols,
                                (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)blocks * box_cols * 4};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t ones[2] = {1, 1};
    if (reinterpret_cast<EncodeFn>(p)(
            &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<void*>(src), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -2;
  }
  const int smem = 160 * 1024;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  probe<<<blocks, 512, smem, (cudaStream_t)stream>>>(
      (const char*)src, per_block, stages, stage_bytes, mode, (float*)sink,
      map, box_rows, box_cols);
  return (int)cudaGetLastError();
}
"""


def probe(dev):
    """The streaming probe's table: GB/s a block and TB/s over the card
    for each mode and ring depth (stages of 16 KB; the panel mode's
    stages are 160 rows of 96 bytes, 15 KB)."""
    import ctypes
    out = HERE / "build" / "k3_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE_SRC)
    so = out / "libprobe.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v", "-o", str(so), str(out / "probe.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.probe_run.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                              + [ctypes.c_int] * 4
                              + [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.probe_run.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    box_rows = 160
    per_block = 96 * box_rows * 256           # 3.9 MB a block
    rows = box_rows * 256
    buf = torch.empty(blocks * per_block, dtype=torch.uint8, device=dev)
    buf.random_(0, 255)
    sink = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    log(f"  streaming probe: {blocks} blocks of 512 threads, "
        f"{per_block / 1e6:.2f} MB a block ({buf.numel() / 1e6:.0f} MB in "
        f"all, beyond L2), one producer warp, 15 consumer warps reading "
        f"every stage")
    # (mode, columns, rows) of each table row's stages: 16 KB bulk copies,
    # 16 KB of cp.async, 2-D boxes of 24 f32 x 160 rows (96-byte rows:
    # K3's in_proj panel at mamba-130m) and of 4 f32 x 256 rows (16-byte
    # rows: its f32 x_proj and int8 x_proj / out_proj panels)
    shapes = ((0, 0, 0), (1, 0, 0), (2, 24, box_rows), (2, 4, 256))
    for mode, cols, brows in shapes:
        name = ("TMA bulk (16 KB)" if mode == 0 else "cp.async 16 B (16 KB)"
                if mode == 1 else f"TMA 2-D panel ({cols} f32 x {brows} rows)")
        for stages in (1, 2, 4, 8):
            sb = 4 * cols * brows if mode == 2 else 16384
            pb = per_block // sb * sb
            if mode == 2:
                pb = min(pb, (buf.numel() // (blocks * cols * 4)) // brows
                         * brows * cols * 4)
            nrows = pb // (cols * 4) if mode == 2 else rows

            def run():
                rc = lib.probe_run(buf.data_ptr(), pb, stages, sb, mode,
                                   blocks, sink.data_ptr(), nrows, brows,
                                   cols, stream)
                if rc != 0:
                    raise RuntimeError(f"probe_run: {rc}")
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            reps = 5
            t0.record()
            for _ in range(reps):
                run()
            t1.record()
            torch.cuda.synchronize()
            s = t0.elapsed_time(t1) / reps * 1e-3
            log(f"    {name:<36} {stages} stage(s): "
                f"{pb / s / 1e9:7.2f} GB/s a block, "
                f"{blocks * pb / s / 1e12:5.2f} TB/s over the card "
                f"({s * 1e6:.1f} µs a launch)")
    del buf


def log(*a):
    print(*a, flush=True)


_BASE = {}


def configure(lib, csrc=None, defines=(), everything=False):
    """Point ``_lib`` at ``megakernel_mamba*.cu`` only (from ``csrc`` if
    given), built with ``defines``; ``everything``: every source."""
    base = _BASE.setdefault("lib", (lib.SOURCES, dict(lib.BUILDS),
                                    dict(lib._SIGNATURES), lib.CSRC))
    sources, builds, sigs, csrc0 = base
    if everything:
        lib.SOURCES, lib.BUILDS, lib._SIGNATURES = sources, builds, sigs
    else:
        lib.SOURCES = tuple(s for s in sources
                            if s.startswith("megakernel_mamba"))
        lib.BUILDS = {s: tuple(tuple(d) + tuple(defines)
                               for d in builds.get(s, ((),)))
                      for s in lib.SOURCES}
        lib._SIGNATURES = {k: v for k, v in sigs.items() if k in ENTRIES}
    lib.CSRC = csrc0 if csrc is None else csrc
    lib._lib = None
    t0 = time.perf_counter()
    so = lib.build()
    lib.lib()
    log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    return so


def design(root, kind):
    """'new' where ``kind`` is jamba and ``root`` has the split-K design
    (megakernel_mamba.cuh, zeroing its counters), else 'old' (the
    4-5-phase design of megakernel_mamba.cu, which the mamba instance
    keeps)."""
    header = root / "src/repro_torch/csrc/megakernel_mamba.cuh"
    if (kind == "jamba" and header.exists()
            and "zero_counters" in header.read_text()):
        return "new"
    return "old"


def patched_csrc(root, dest):
    """A copy of ``root``'s kernel sources with the stamps put in (in each
    file that holds a mamba_megakernel body)."""
    src = root / "src" / "repro_torch" / "csrc"
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(src, dest)
    macro = ("#ifndef MB_STAMP_ONCE\n#define MB_STAMP_ONCE\n" +
             txl.STAMP_MACRO + ("#define ITEM_MARK() XL_MARK()\n"
                                if ITEM_MARKS else
                                "#define ITEM_MARK() do {} while (0)\n")
             + "#endif\n")
    for name in ("megakernel_mamba.cuh", "megakernel_mamba.cu"):
        path = dest / name
        if not path.exists() or "cg::this_grid()" not in path.read_text():
            continue
        text = path.read_text()
        for pattern, repl, want in STAMP_EDITS:
            text, n = re.subn(pattern, repl.replace("\\", "\\\\"), text)
            if (want is not None and n != want) or n == 0:
                raise RuntimeError(f"stamp edit {pattern!r} matched {n} times "
                                   f"in {name}")
        for pattern, repl in MARK_EDITS:
            text, n = re.subn(pattern, repl, text)
            log(f"  mark {pattern[:40]!r} in {name}: {n} place(s)")
        anchor = "namespace marca {\n"
        if anchor not in text:
            raise RuntimeError(f"no marca namespace in {name}")
        text = text.replace(anchor, anchor + macro, 1)
        path.write_text(text)
    return dest


def sass_report(so, dump=None):
    """Instructions of each mamba_megakernel instantiation's SASS by
    kind (FFMA per weight and slot; I2F/PRMT, FMUL and F2FP per weight);
    ``dump``: a file the listing of the bf16 jamba kernel with int8
    weights is written to, where its inner loops are read instruction by
    instruction."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = ("FFMA", "FMUL", "FADD", "I2F", "I2FP", "PRMT", "F2FP", "LDG",
           "LDS", "STS", "LDL", "STL", "BAR", "SHFL")
    counts, fn, keep = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = cs.mamba_kernel_name(m.group(1))
            if fn in ("jamba bf16 act, int8 w", "mamba bf16 act, int8 w",
                      "mamba bf16 act, f32 w"):
                keep.append(f"// {fn}")
            if fn:
                counts[fn] = dict.fromkeys(ops + ("all",), 0)
            continue
        if not fn:
            continue
        if fn in ("jamba bf16 act, int8 w", "mamba bf16 act, int8 w",
                  "mamba bf16 act, f32 w"):
            keep.append(line)
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m:
            counts[fn]["all"] += 1
            if m.group(1) in counts[fn]:
                counts[fn][m.group(1)] += 1
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(keep))
        log(f"  SASS of the bf16 kernels with int8 weights in {dump}")
    for fn, n in sorted(counts.items()):
        log(f"  SASS {fn}: {n}")


def registers(lib):
    return cs.kernel_registers(lib.build_log(), cs.mamba_kernel_name)


def row_inputs(kind, wd, sd, dtype, dev, seed, width=None):
    """(cfg, launch, plain, work) of one row: K3-jamba one position at
    jamba-v0.1 widths or K3-mamba at mamba-130m, 4 slots (``width``: an
    entry of chip_smoke's K3_WIDTHS instead)."""
    from repro_torch.kernels import megakernel, ref
    if kind == "jamba":
        c = cs.jamba_cfg(n_experts=0, dtype=dtype, weight_dtype=wd,
                         state_dtype=sd)
        run, x0, states, outs = cs.shared_inputs().jamba_run_inputs(
            c, 1, 4, seed=seed, device=dev)
        return (c, lambda: megakernel.jamba_stacked_run(c, x0, run, states,
                                                        outs),
                lambda: ref.jamba_stacked_run(c, x0, run.rows, states),
                cs.jamba_run_work(c, 1, 4, wd == "int8", sd, 2),
                (run, x0, states, outs))
    from repro_torch import configs
    c = dataclasses.replace(configs.get_config(cs.ARCH), dtype=dtype,
                            weight_dtype=wd, state_dtype=sd,
                            n_layers=MAMBA_LAYERS)
    if width is not None:
        _, dm, layers, r = width
        c = dataclasses.replace(c, d_model=dm, n_layers=layers, dt_rank=r)
    p = cs.k3_params(c, wd, dev)
    gen = torch.Generator().manual_seed(seed)
    x0, h, h_scale, conv = cs.k3_inputs(c, 4, gen, dev)
    return (c, lambda: megakernel.mamba_stacked_step(c, x0, p["stack"], h,
                                                     h_scale, conv),
            lambda: ref.mamba_stacked_step(c, x0, p["stack"].layers, h,
                                           h_scale, conv),
            cs.k3_work(c, 4, wd == "int8", sd, 2), (p, x0, h, h_scale, conv))


def checks(dev):
    """f32 against the plain version within K3_TOL, and a bf16 launch
    repeated bit for bit, for each row's setup (K3-mamba at every width of
    chip_smoke's K3_WIDTHS)."""
    cases = [(kind, wd, sd, None) for kind, wd, sd in ROWS]
    cases += [("mamba", wd, sd, w) for w in cs.K3_WIDTHS[1:]
              for _, wd, sd in ROWS[2:]]
    for kind, wd, sd, width in cases:
        for dtype in ("float32", "bfloat16"):
            c, launch, plain, _, ins = row_inputs(kind, wd, sd, dtype, dev,
                                                  cs.SEED + 700, width)
            name = f"K3-{kind} {dtype} {wd} w {sd} state" + (
                f" ({width[0]})" if width else "")
            got = launch()
            if kind == "jamba":
                run, x0, states, outs = ins
                first = [{k: v.clone() for k, v in o.items()} for o in outs]
                got = (got, first)
            if dtype == "float32":
                want = plain()
                torch.cuda.synchronize()
                if kind == "jamba":
                    x1, o1 = got
                    xr, w = want
                    for i, (a, b) in enumerate(zip(o1, w)):
                        cs.check_k3(f"{name} [{i}]", c,
                                    (x1, a["h"], a.get("h_scale"),
                                     a["conv"]),
                                    (xr, b["h"], b.get("h_scale"),
                                     b["conv"]))
                else:
                    cs.check_k3(name, c, got, want)
                continue
            again = launch()
            torch.cuda.synchronize()
            if kind == "jamba":
                same = torch.equal(got[0], again) and all(
                    torch.equal(u[k].view(torch.uint8),
                                v[k].view(torch.uint8))
                    for u, v in zip(got[1], ins[3]) for k in u)
            else:
                same = all((u is None and v is None) or torch.equal(
                    u.view(torch.uint8), v.view(torch.uint8))
                    for u, v in zip(got, again))
            log(f"  {name}: one launch repeated: "
                f"{'bitwise equal' if same else 'FAIL'}")
            if not same:
                cs.FAILURES.append(f"{name} repeat")
            del ins


def timing(dev):
    """The bf16 rows (chip_smoke's ``measure``), then K3-mamba at
    mamba-2.8b's widths (2 layers)."""
    from repro_torch.kernels import megakernel
    wide = cs.K3_WIDTHS[1]
    for kind, wd, sd, width in ([(k, w, s, None) for k, w, s in ROWS]
                                + [("mamba", w, s, wide)
                                   for _, w, s in ROWS[2:]]):
        c, launch, plain, work, ins = row_inputs(kind, wd, sd, "bfloat16",
                                                 dev, cs.SEED + 6, width)
        lc = megakernel.launch_config(c, torch.bfloat16, wd == "int8", dev)
        what = ("1 position, jamba-v0.1" if kind == "jamba"
                else f"{MAMBA_LAYERS} layers, mamba-130m" if width is None
                else f"{width[2]} layers, mamba-{width[0]}")
        row = cs.measure(f"{kind} {wd}/{sd}" + (" wide" if width else ""),
                         f"{what}, 4 slots, bf16; grid {lc['grid']} x "
                         f"{lc.get('threads', 512)}, "
                         f"{lc['smem_bytes']} B shared", launch, plain, None,
                         work, 5)
        if kind == "mamba":
            stack = ins[0]["stack"]
            log(f"    K3-mamba {wd} w: TMA mask "
                f"{getattr(stack, 'tma', None)} (bit w: in_proj, x_proj, "
                f"out_proj by TMA), grid {getattr(stack, 'map_grid', None)}"
                f", ring {lc.get('ring_slots')} slots, items a panel "
                f"{[p['items'] for p in lc.get('panels', {}).values()]}")
        log(f"    K3-{kind}{' ' + width[0] if width else ''} {wd} w {sd} "
            f"state: {row['ms'] * 1e3:.2f} µs "
            f"device, {row['eager_ms'] * 1e3:.2f} eager, bound "
            f"{row['bound_ms'] * 1e3:.2f} ({row['bound_ms'] / row['ms']:.0%}"
            f" reached), plain {row['plain_ms'] * 1e3:.1f}; "
            f"{row['device_kernels']} device kernel(s) a call")
        del ins


def decode_steps(dev):
    """The whole decode step at 4 slots, bf16, through K3 and per layer:
    mamba-130m (as chip_smoke's phase 5) and the 16-expert jamba model
    cut to 8 layers (as phase 5j)."""
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.get_config(cs.ARCH),
                              scan_impl="pallas", conv_impl="pallas")
    for wd, sd in (("f32", "f32"), ("int8", "int8")):
        c = dataclasses.replace(cfg, dtype="bfloat16", weight_dtype=wd,
                                state_dtype=sd)
        p = cs.k3_params(c, wd, dev)
        cache = registry.init_cache(c, 4, 64, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}
        for impl in ("megakernel", "fused"):
            ci = dataclasses.replace(c, step_impl=impl)
            ms, how = cs.device_time(
                lambda ci=ci: registry.decode_step(ci, p, cache, batch), 5)
            log(f"    mamba-130m decode step {wd} w {sd} state, {impl}: "
                f"{ms:.4f} ms ({how})")
    cs._PARAMS.clear()
    params = cs.jamba_params(False, dev)
    for wd, sd in (("f32", "f32"), ("int8", "int8")):
        c = cs.jamba_cfg(dtype="bfloat16", weight_dtype=wd, state_dtype=sd,
                         kv_cache_dtype="int8" if sd == "int8" else "model")
        p = registry.quantize_params(c, params)
        cache = registry.init_cache(c, 4, 576, device=dev)
        batch = {"tokens": torch.arange(4, device=dev)[:, None]}
        for impl in ("megakernel", "fused"):
            ci = dataclasses.replace(c, step_impl=impl)
            pi = registry.stack_params(ci, p) if impl == "megakernel" else p
            ms, how = cs.device_time(
                lambda ci=ci, pi=pi: registry.decode_step(ci, pi, cache,
                                                          batch), 2)
            log(f"    jamba decode step (MoE, 8 layers) {wd} w {sd} state, "
                f"{impl}: {ms:.4f} ms ({how})")
        del p, cache
    cs.jamba_free("moe")


class _ScratchTorch:
    """``torch`` as the wrapper module sees it, but ``torch.empty`` of a
    1-D f32 tensor (the launch's scratch) returns the part of ``buf``
    after the stamps."""

    def __init__(self, buf):
        self._buf = buf

    def empty(self, *size, dtype=None, device=None, **kw):
        if dtype == torch.float32 and len(size) == 1 and isinstance(
                size[0], int):
            off = 2 * txl.STAMP_BLOCKS * txl.STAMP_ROW
            view = self._buf.view(torch.float32)[off:off + size[0]]
            if view.numel() == size[0]:
                return view
            raise RuntimeError(f"stamp buffer too small for {size[0]}")
        return torch.empty(*size, dtype=dtype, device=device, **kw)

    def __getattr__(self, name):
        return getattr(torch, name)


def breakdown(stamps, grid, names, layers):
    """Mean µs a layer of each phase (its first block out of the barrier
    before it to its last block into the barrier after it), of the
    barrier after it (last in to last out, and the spread out) and of the
    marks inside it (the k-th mark of the last block to reach it, from
    the phase's start), from one launch's stamps; ``names`` one per phase
    of the launch; plus the whole launch and the SM clock."""
    row = txl.STAMP_ROW
    half = row // 4
    st = stamps[:grid * row].view(grid, row).cpu()
    counts = st[:, 0]
    k = int(counts[0])
    if not bool((counts == k).all()) or k < 2 or k % 2:
        raise RuntimeError(f"uneven stamps: {counts.unique().tolist()}")
    t = st[:, 1:1 + k].double() * 1e-3
    marks = [st[g, half + 1:half + 1 + int(st[g, half])].double() * 1e-3
             for g in range(grid)]
    arr, ext = t[:, 1:-1:2], t[:, 2:-1:2]
    nbar = arr.shape[1]
    if nbar + 1 != len(names):
        raise RuntimeError(f"{nbar} barriers for {len(names)} phases")
    work, bar, mk = {}, {}, {}
    for i, name in enumerate(names):
        t0 = t[:, 0].min() if i == 0 else ext[:, i - 1].min()
        t1 = t[:, -1].max() if i == nbar else arr[:, i].max()
        work[name] = work.get(name, 0.0) + float(t1 - t0)
        if i < nbar:
            b0, b1 = bar.get(name, (0.0, 0.0))
            bar[name] = (b0 + float(ext[:, i].max() - arr[:, i].max()),
                         b1 + float(ext[:, i].max() - ext[:, i].min()))
        got = mk.setdefault(name, {})
        for g in range(grid):
            lo = t[g, 0] if i == 0 else ext[g, i - 1]
            hi = t[g, -1] if i == nbar else arr[g, i]
            inside = marks[g][(marks[g] >= lo) & (marks[g] <= hi)]
            for j, v in enumerate(inside.tolist()):
                got.setdefault(j, {})
                got[j][i] = max(got[j].get(i, 0.0), v - float(t0))
    reps = {n: max(1, names.count(n)) for n in work}
    per = {n: (layers if names.count(n) >= layers else 1) for n in work}
    work = {n: v / per[n] for n, v in work.items()}
    bar = {n: (v[0] / per[n], v[1] / per[n]) for n, v in bar.items()}
    marks_out = {n: [sum(v.values()) / reps[n] for _, v in sorted(d.items())]
                 for n, d in mk.items()}
    total = float(t[:, -1].max() - t[:, 0].min())
    clk = st[:, row // 2 + 1:row // 2 + 1 + k].double()
    mhz = float(((clk[:, -1] - clk[:, 0]) / (t[:, -1] - t[:, 0])).mean())
    return work, bar, marks_out, total, mhz, nbar


def phase_stamps(lib, dev, root):
    """The stamped build and, for each row, its device time and phase
    breakdown."""
    from repro_torch.kernels import megakernel
    dest = HERE / "build" / "k3m_stamps" / f"{root.name}_stamped" / "csrc"
    so = configure(lib, patched_csrc(root, dest), ("XL_STAMPS=1",))
    for name, r in sorted(registers(lib).items()):
        log(f"  stamped build {name}: {r}")
    for kind, wd, sd in ROWS:
        c, launch, _, _, ins = row_inputs(kind, wd, sd, "bfloat16", dev,
                                          cs.SEED + 6)
        grid = megakernel.launch_config(c, torch.bfloat16, wd == "int8",
                                        dev)["grid"]
        layers = 1 if kind == "jamba" else MAMBA_LAYERS
        q = sd == "int8"
        kind_of = design(root, kind)
        per = PHASES[kind_of].get((kind, q)) or PHASES[kind_of][(kind,
                                                                 False)]
        names = list(per) * layers
        if kind_of == "new":
            names = ["zero counters"] + names
        stamps = torch.zeros(txl.STAMP_BLOCKS * txl.STAMP_ROW + (16 << 20),
                             dtype=torch.int64, device=dev)
        real = megakernel.torch
        megakernel.torch = _ScratchTorch(stamps)
        try:
            ms = cs.device_ms(launch, 5)
            reps, acc = 10, None
            for it in range(reps + 2):
                stamps[:grid * txl.STAMP_ROW].zero_()
                launch()
                torch.cuda.synchronize()
                if it < 2:
                    continue
                out = breakdown(stamps, grid, names, layers)
                if acc is None:
                    acc = [out[0], out[1], out[2], out[3], out[4]]
                else:
                    for n in acc[0]:
                        acc[0][n] += out[0][n]
                    for n in acc[1]:
                        acc[1][n] = (acc[1][n][0] + out[1][n][0],
                                     acc[1][n][1] + out[1][n][1])
                    for n in acc[2]:
                        acc[2][n] = [x + y for x, y in zip(acc[2][n],
                                                           out[2][n])]
                    acc[3] += out[3]
                    acc[4] += out[4]
        finally:
            megakernel.torch = real
        work, bar, marks, total, mhz = acc
        log(f"  stamped ({kind_of} design): phases of K3-{kind}, bf16, {wd} "
            f"w, {sd} state, {layers} layer(s) ({out[5]} barriers a launch; "
            f"{ms * 1e3:.1f} µs a launch (graph); mean of {reps} launches, "
            f"µs a layer): whole launch {total / reps:.2f} µs; SM clock "
            f"{mhz / reps:.0f} MHz")
        for n in work:
            b = bar.get(n, (0.0, 0.0))
            mtxt = ", ".join(f"{v / reps:.2f}" for v in marks.get(n, []))
            log(f"    {n:<22} work {work[n] / reps:8.2f}   barrier after "
                f"{b[0] / reps:6.2f} (spread out {b[1] / reps:5.2f})"
                + (f"   marks at {mtxt}" if mtxt else ""))
        log(f"    sum a layer            work "
            f"{sum(work[n] for n in per) / reps:8.2f}   barriers "
            f"{sum(bar.get(n, (0, 0))[0] for n in per) / reps:6.2f}")
        del ins
    sass_report(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--no-stamps", action="store_true",
                    help="skip the stamped build and the phase breakdown")
    ap.add_argument("--item-marks", action="store_true",
                    help="in the stamped build, mark each streamed item's "
                    "arrival and refill (K3-mamba at 8 layers)")
    ap.add_argument("--probe", action="store_true",
                    help="run only the streaming probe")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the bf16 jamba kernel's (int8 weights) SASS "
                    "listing here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_jamba: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _lib
    if Path(_lib.__file__).resolve().parents[2] != root / "src":
        raise RuntimeError(f"repro_torch came from {_lib.__file__}")
    dev = torch.device("cuda")
    log(cs.card_line())
    if args.item_marks:
        global MAMBA_LAYERS, ITEM_MARKS
        MAMBA_LAYERS, ITEM_MARKS = 8, True
    if args.probe:
        probe(dev)
        log(cs.card_line())
        return 0
    log(f"tree: {root} (K3-jamba: {design(root, 'jamba')} design, K3-mamba: "
        f"{design(root, 'mamba')})")
    so = configure(_lib, everything=args.decode)
    for name, r in sorted(registers(_lib).items()):
        log(f"  {name}: {r}")
    if not args.quick:
        t0 = time.perf_counter()
        checks(dev)
        log(f"checks took {time.perf_counter() - t0:.1f} s")
    timing(dev)
    if args.decode:
        decode_steps(dev)
    cs._PARAMS.clear()
    sass_report(so, args.sass)
    if not args.no_stamps:
        phase_stamps(_lib, dev, root)
    log(cs.card_line())
    log(f"failures: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
