// Cross-layer decode megakernel (K3), jamba instance, for Hopper, sm_90a.
//
// Replaces: repro/kernels/decode_step.py:413 stacked_layer_launch
// (pallas_call at :488) with the body of repro/models/jamba.py:305
// ("marca_megakernel_jamba"): one launch runs a run of pure-SSM positions
// of a group, each position
//
//   x = x + mamba_block_megastep(rmsnorm1(x));  x = x + mlp(rmsnorm2(x))
//
// with the mamba block's chain norm -> in_proj -> [x | z] -> conv over the
// tail + bias -> SiLU -> x_proj -> (dt_low, B, C) -> dt_proj + bias +
// softplus -> S6 step (exp_impl) -> D skip and SiLU(z) gate -> out_proj ->
// residual, and mlp the swiglu w2(SiLU(w1 x) * (w3 x)).  The positions'
// states live in different cache leaves: a launch takes one pointer per
// position and state tensor (StateRows).  K3's mamba instance runs
// megakernel_mamba.cu's kernel (this design measured slower there: at
// mamba-130m every weight is small and a phase's time is its chain of
// dependent steps, which the split below lengthens).
//
// Bound on this card: bytes.  One jamba-v0.1 position (105.3 M mamba and
// 176.2 M MLP weights) reads 1.126 GB in f32 at 4 slots: at least 336 us
// at 3.35 TB/s; 281 MB with int8 weights and state, at least 84 us.  The
// int8 weights cost issue slots too: about 12 instructions a weight (4
// FFMA a slot, the code's conversion, the scale, bf16's rounding).
//
// Design: one persistent cooperative kernel, one block of 384 threads an
// SM (168 registers a thread), the position loop inside.  Every dense
// layer is a GEMV over (column tile, row) units cut to fill the grid in one
// round: whole tiles a block where they fill it (in_proj: 128 tiles of
// 128 columns), else the tiles' rows split over the blocks (x_proj,
// out_proj, w2 in whole parts of a tile; w1|w3 evenly, a block's range
// crossing from one tile into the next).  A block copies its inputs into
// shared memory in one go (the residual rows for the norm, or its rows of
// a scratch vector), stages them with the 4 slots interleaved (one 16-byte
// shared load a row), and streams its weights in ping-pong batches of 4
// rows of 4 f32 or 8 rows of 8 int8 codes a lane, the next batch's loads
// issued before the current one is used, no bounds test in the loop, the
// int8 scales in registers; int8 codes and bf16's rounding on the integer
// pipes (I2F and F2F run at 16 results a clock an SM: they bound the
// first int8 builds).  A split tile's blocks write partial sums to
// scratch and the last to arrive at the tile's integer counter
// (__threadfence, atomicAdd) sums them in block order and runs the
// epilogue; no float atomics, so the same inputs and grid give the same
// bits.  Per position:
//   A   norm -> in_proj; the epilogue of the x half runs the conv over the
//       tail + bias and SiLU and writes the new tail; z is stored. barrier
//   BC  x_proj -> (dt_low, B, C); each tile's finisher counts itself
//       done.  Then the S6 step, one item per chunk of channels (a power
//       of two, so the chunks fit the grid: 64 at jamba-v0.1) for all
//       slots: its dt_proj columns, A rows, state rows, x_a and z come
//       into shared memory by cp.async while it waits for x_proj's
//       counter; then dt (each weight read once for all slots) + bias +
//       softplus, the step, D skip and gate.  An f32/bf16 state is written
//       here; an int8/fp8 state's f32 values stay in shared memory, the
//       chunk's absmax goes to scratch, the chunk arrives at its
//       512-channel scale group's counter, waits for the group's other
//       chunks, takes the group's absmax, updates the scale and encodes
//       its own channels with K2's arithmetic (common.cuh).         barrier
//   D   out_proj and the residual add x + y.                      barrier
//   E   norm2 -> w1 and w3 in one pass (half the warps each, the same
//       column tile); the finisher forms SiLU(w1 x) * (w3 x).     barrier
//   F   w2 over each block's rows of the (slots, d_ff) hidden, and the
//       residual add.                                             barrier
// 5 grid barriers a position and one a launch: the counters live in the
// call's scratch and every block zeroes its share before the first
// barrier; each counter then counts up through the positions (position
// l's last arrival makes it (l + 1) times its arrivals), so runs of any
// length back to back start from zero.  Every rounding point of the
// per-layer path is kept: the norm, each dense output, the conv and SiLU
// outputs, softplus, y, x + y, SiLU(w1 x) * (w3 x); weights are read as
// stored, f32 or int8 codes times their scale with one rounded multiply,
// then rounded to the compute type.  Slots are taken 4 at a time; more
// slots re-read a tile's weights.  The phases read their per-position
// weights through a table of device pointers that the wrapper builds once
// per engine.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_k3_jamba.py,
// PERF.md): one bf16 position at 4 slots in 481 us with f32
// weights and state (the previous design: 544) and 354 us with int8
// weights and state (488).  The f32 weights stream at 2.8-3.0 TB/s inside
// the phases; each phase adds 10-30 us of staging, finishing and waiting,
// and the int8 loops reach about half the issue rate.
#pragma once

#include <cooperative_groups.h>

#include "megakernel_common.cuh"

namespace cg = cooperative_groups;

namespace marca {

// Shared by K3's mamba instance (megakernel_mamba.cu) and its jamba
// instance (below)
constexpr int kMN = 16;                      // d_state
constexpr float kSoftplusThreshold = 20.0f;  // F.softplus

// Columns of the per-layer weight table (repro_torch/kernels/megakernel.py
// TABLE_COLUMNS); a scale column is 0 for f32 weights.
// (MLP_COLUMNS, for the jamba instance: norm2 and the MLP)
enum WeightColumn {
  W_NORM = 0, W_IN = 1, W_IN_SCALE = 2, W_CONV = 3, W_CONV_B = 4, W_X = 5,
  W_X_SCALE = 6, W_DT = 7, W_DT_SCALE = 8, W_DT_BIAS = 9, W_A = 10,
  W_A_SCALE = 11, W_D = 12, W_OUT = 13, W_OUT_SCALE = 14, W_NORM2 = 15,
  W_W1 = 16, W_W1_SCALE = 17, W_W3 = 18, W_W3_SCALE = 19, W_W2 = 20,
  W_W2_SCALE = 21, W_COLUMNS = 24
};

namespace mb {

// A block: 384 threads, so a thread may hold 168 registers (512 threads
// cap it at 128, and the streamed GEMVs then spilled 1-3 KB)
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kCW = 128;                     // columns of a GEMV tile
constexpr int kStage = 4096;                 // input rows staged at once
constexpr int kPhases = 5;                   // GEMV phases with counters
constexpr int kSmall = 128;                  // floats of per-block values
// blocks whose partial sums one tile's finisher adds, at most (it loads
// them all before it adds any: one trip to L2)
constexpr int kMaxParts = 16;
constexpr int kMaxModel = 4096;              // widest d_model (rows staged)
constexpr int kMaxConv = 4;                  // widest d_conv
// a weight of at most this many bytes is latency-bound: its GEMV runs
// whole tiles (no split, so no partial sums) where they fill half the grid
constexpr int64_t kSmallWeight = 16ll << 20;

constexpr int kMaxRows = 8;  // positions of one jamba launch (MAX_RUN)

// One state pointer per position (and tensor) of a jamba launch: each
// points at (b, ...) of its cache leaf.
struct StateRows {
  const void* h[kMaxRows];
  const float* h_scale[kMaxRows];
  const void* conv[kMaxRows];
  void* h_out[kMaxRows];
  float* h_scale_out[kMaxRows];
  void* conv_out[kMaxRows];
};

struct MegaArgs {
  const int64_t* table;  // (L, W_COLUMNS) device pointers
  const void* x0;        // (b, dm) compute type: the embedded tokens
  void* x;               // (b, dm) compute type: the residual stream out
  StateRows rows;        // each position's state tensors
  float* scratch;
  int L, b, dm, di, R, k, nx, g, d_ff;
  int state_dtype, exp_impl, silu_impl;
};

// ---------------------------------------------------------------------------
// Sizes shared by the host and the kernel
// ---------------------------------------------------------------------------

// the widest GEMV's column tiles, at most (a tile is 128 columns, or 32 for
// a weight whose width is no multiple of the vector): bounds each phase's
// counters and the partial sums' index
__host__ __device__ __forceinline__ int tile_bound(int dm, int di, int nx,
                                                   int d_ff) {
  const int n = max(max(2 * di, nx), max(dm, d_ff));
  return (n + 31) / 32;
}

// channels of one S6 item: the smallest power of two that gives the grid
// at most one item a block (the items of a scale group wait for each
// other, so all must be resident at once)
__host__ __device__ __forceinline__ int chunk_of(int di, int grid) {
  const int need = (di + grid - 1) / grid;
  int ch = 1;
  while (ch < need) ch <<= 1;
  return ch;
}

__host__ __device__ __forceinline__ size_t a16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// bytes of the S6 item's shared operands: dt_proj's columns, A's rows,
// 4 slots' state rows (as stored, at most f32) and their new f32 values,
// x_a and z, (dt_low | B | C), dt, and dt's partial sums
__host__ __device__ __forceinline__ size_t step_smem(int R, int nx, int ch,
                                                     int wbytes) {
  return a16((size_t)R * ch * wbytes) + a16((size_t)ch * kMN * wbytes) +
         2 * a16((size_t)kSlots * ch * kMN * 4) +
         2 * a16((size_t)kSlots * ch * 4) + a16(4ull * kSlots * nx) +
         a16(4ull * kSlots * ch) + 4ull * kThreads * kSlots;
}

// floats of the raw input rows a GEMV pass copies in before it stages
// them: 4 slots' d_model-wide residual rows, or 4 slots' rows of a
// segment (kStage rows, widened to 4-row boundaries), and a segment's
// norm scales
constexpr int kRawRows = kSlots * (kStage + 8) + kStage + 8;

// bytes of a GEMV's staged input rows, its warps' sums and its raw rows
constexpr size_t kGemvSmem =
    16ull * kStage + 4ull * kWarps * kSlots * kCW + 4ull * kRawRows;

// scratch floats: x_a, z, (dt_low|B|C), y, the MLP hidden (d_ff 0 without
// one), the chunks' absmax (b, grid), the partial
// sums ((grid + tiles) x 2 matrices x b x 128), then the int counters:
// kPhases x tiles, x_proj's done count, one a scale group
__host__ __device__ __forceinline__ int64_t scratch_floats(
    int b, int dm, int di, int nx, int d_ff, int g, int grid) {
  const int64_t t = tile_bound(dm, di, nx, d_ff);
  return (int64_t)b * (3 * (int64_t)di + nx + d_ff + grid) +
         ((int64_t)grid + t) * 2 * b * kCW + kPhases * t + 1 + g;
}

struct Scratch {
  float *xa, *zb, *dbc, *yb, *hid, *amax, *part;
  int* cnt;  // kPhases x tmax tile counters
  int* done;  // x_proj's tiles done
  int* grp;   // one a scale group
  int tmax, ncnt;
};

__device__ __forceinline__ Scratch scratch_of(const MegaArgs& a) {
  const int64_t b = a.b, di = a.di, G = gridDim.x;
  Scratch s;
  s.tmax = tile_bound(a.dm, a.di, a.nx, a.d_ff);
  s.xa = a.scratch;
  s.zb = s.xa + b * di;
  s.dbc = s.zb + b * di;
  s.yb = s.dbc + b * a.nx;
  s.hid = s.yb + b * di;
  s.amax = s.hid + b * a.d_ff;
  s.part = s.amax + b * G;
  s.cnt = reinterpret_cast<int*>(s.part + (G + s.tmax) * 2 * b * kCW);
  s.done = s.cnt + kPhases * s.tmax;
  s.grp = s.done + 1;
  s.ncnt = kPhases * s.tmax + 1 + a.g;
  return s;
}

// Shared memory: a small region of per-block values, then one region that
// a GEMV (staged rows, warp sums) and the S6 item (its operands) take in
// turn.
struct Smem {
  float* rinv;   // [kSlots] the norm's reciprocal RMS of the pass's slots
  float* so;     // [kSlots] the pass's group scales
  int* imax;     // [kSlots] the pass's absmax bits
  int* flag;     // the last-arrival answer
  int* rs0;      // the slot the rinv belong to (-1: none)
  float* redn;   // [kWarps x kSlots] the norm's warp partials
  float* big;    // the shared region
  float* raw;    // a GEMV's raw input rows (kRawRows floats, in big)
};

__device__ __forceinline__ Smem smem_map(float* smem) {
  Smem m;
  m.rinv = smem;
  m.so = smem + 4;
  m.imax = reinterpret_cast<int*>(smem + 8);
  m.flag = reinterpret_cast<int*>(smem + 12);
  m.rs0 = reinterpret_cast<int*>(smem + 13);
  m.redn = smem + 16;
  m.big = smem + kSmall;
  m.raw = m.big + 4 * kStage + kWarps * kSlots * kCW;
  return m;
}

// ---------------------------------------------------------------------------
// Loads, copies and counters
// ---------------------------------------------------------------------------

// a value another block wrote in this launch: from L2, never a stale L1 line
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(d), "l"(src), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// where a block starts in a copy of n pieces: the blocks that copy the
// same rows (every block, for the residual) start at scattered pieces, so
// they do not all ask L2 for the same lines at once
__device__ __forceinline__ int rotation(int n) {
  return n > 0 ? (int)(((unsigned)blockIdx.x * 2654435761u) % (unsigned)n)
               : 0;
}

template <int kBytes>
__device__ __forceinline__ void copy_pieces(char* dst, const char* src,
                                            int64_t stride, int rows,
                                            int row_bytes, int dst_row) {
  const int per = row_bytes / kBytes, n = rows * per, rot = rotation(n);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int t = k + rot < n ? k + rot : k + rot - n;
    const int r = t / per, c = t % per;
    cp_async<kBytes>(dst + (int64_t)r * dst_row + c * kBytes,
                     src + r * stride + c * kBytes);
  }
}

// rows x row_bytes bytes copied from L2 in pieces of P, 4 loads a thread
// issued before any is stored
template <typename P>
__device__ __forceinline__ void copy_l2(char* d, const char* s,
                                        int64_t stride, int rows,
                                        int row_bytes, int dst_row) {
  const int per = row_bytes / (int)sizeof(P), n = rows * per;
  const int rot = rotation(n);
  for (int k0 = threadIdx.x; k0 < n; k0 += 4 * kThreads) {
    P v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads, t = k + rot < n ? k + rot : k + rot - n;
      if (k < n)
        v[u] = __ldcg(reinterpret_cast<const P*>(
            s + (t / per) * stride + (t % per) * (int)sizeof(P)));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads, t = k + rot < n ? k + rot : k + rot - n;
      if (k < n)
        *reinterpret_cast<P*>(d + (int64_t)(t / per) * dst_row +
                              (t % per) * (int)sizeof(P)) = v[u];
    }
  }
}

// rows x row_bytes bytes, the rows stride bytes apart at src, into shared
// memory dst_row bytes apart, on their way without a register holding
// them (cp.async, the widest pieces the alignments allow; a byte copy
// where they are not 4-byte aligned).  cp_async_wait_all and a
// __syncthreads before the bytes are read.  l2_only: the bytes are floats
// that other blocks wrote in this launch, so no L1-allocating 4- or
// 8-byte cp.async may fetch them; where the 16-byte form does not fit
// they are copied in place from L2.
__device__ __forceinline__ void copy_rows(void* dst, const void* src,
                                          int64_t stride, int rows,
                                          int row_bytes, int dst_row,
                                          bool l2_only = false) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int64_t al = (int64_t)(reinterpret_cast<uintptr_t>(s) |
                               reinterpret_cast<uintptr_t>(d)) |
                     stride | row_bytes | dst_row;
  if ((al & 15) == 0) {
    copy_pieces<16>(d, s, stride, rows, row_bytes, dst_row);
  } else if (l2_only && (al & 3) == 0) {  // another block wrote them: from
    copy_l2<unsigned>(d, s, stride, rows, row_bytes, dst_row);  // L2, in
  } else if (l2_only) {                                           // place
    copy_l2<unsigned short>(d, s, stride, rows, row_bytes, dst_row);
  } else if ((al & 7) == 0) {
    copy_pieces<8>(d, s, stride, rows, row_bytes, dst_row);
  } else if ((al & 3) == 0) {
    copy_pieces<4>(d, s, stride, rows, row_bytes, dst_row);
  } else {
    for (int t = threadIdx.x; t < rows * row_bytes; t += kThreads) {
      const int r = t / row_bytes, c = t % row_bytes;
      d[(int64_t)r * dst_row + c] = s[r * stride + c];
    }
  }
}

// Every thread's writes made visible, then one arrival at the counter;
// true (in every thread of the block) for the arrival that brings it to
// ``total``, whose block then sees every arriver's writes.
__device__ __forceinline__ bool arrive_last(int* counter, int total,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == total - 1;
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// Every thread's writes made visible, then one arrival at the counter.
__device__ __forceinline__ void arrive(int* counter) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(counter, 1);
}

// Block until the counter reaches ``target`` (thread 0 polls it), then
// see every write made before the arrivals that brought it there.  A count
// that never comes (a fault: every arriver is resident) traps after about
// a second rather than hang the card.
__device__ __forceinline__ void wait_count(const int* counter, int target) {
  if (threadIdx.x == 0) {
    int v;
    for (long long n = 0;; ++n) {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                   : "=r"(v) : "l"(counter) : "memory");
      if (v >= target) break;
      if (n > (1ll << 21)) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  __threadfence();
}

// ---------------------------------------------------------------------------
// The streamed GEMV
// ---------------------------------------------------------------------------

// One 16-byte (or one-element) load of V adjacent weights of a row, and
// the value of its c-th weight as the dense layer consumes it: f32 as
// stored, or the int8 code times its column's scale with one rounded
// multiply (load_w's arithmetic), rounded to the compute type T.
template <typename TW, int V> struct WVec;
template <> struct WVec<float, 4> {
  using type = float4;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float raw(const type& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <> struct WVec<float, 1> {
  using type = float;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float raw(const type& v, int) {
    return v;
  }
};
template <> struct WVec<int8_t, 8> {
  using type = uint2;
  static __device__ __forceinline__ type load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ float raw(const type& v, int c) {
    return i8_value((c >> 2) == 0 ? v.x : v.y, c);
  }
};
template <> struct WVec<int8_t, 1> {
  using type = int;
  static __device__ __forceinline__ type load(const int8_t* p) {
    return (int)__ldg(reinterpret_cast<const signed char*>(p));
  }
  static __device__ __forceinline__ float raw(const type& v, int) {
    return (float)v;
  }
};

// int8 codes a lane loads at once (16, in one 16-byte load, kept 64
// accumulators a lane and measured 15% slower on an H100: 407 us against
// 354 a jamba-v0.1 position)
constexpr int kI8Vec = 8;

// the widest load a thread takes of an N-column weight: 16 bytes of f32,
// kI8Vec int8 codes, where N allows; else one weight
template <typename TW>
__device__ __forceinline__ int vec_of(int N) {
  if constexpr (sizeof(TW) == 1) return N % kI8Vec == 0 ? kI8Vec : 1;
  return N % 4 == 0 ? 4 : 1;
}

// How a GEMV's (K, N) weight is cut: lpr lanes across a tile's row (cw =
// lpr x V columns), ntile tiles, G blocks taking its (tile, row) units.
struct Plan {
  int lpr, cw, ntile, G;
};

// No split where whole tiles (128 columns down to 32) keep 90% of the
// blocks busy, or half of them for a weight of at most kSmallWeight
// bytes (its time is the latency chain, and a split adds one: partial
// sums, a fence, an arrival, the finisher's read), and a tile's rows are
// staged in one piece (K <= kStage: each further piece drains the
// block's loads while it stages).  Otherwise the widest
// tile (at least 32 columns) that leaves each tile at most kMaxParts
// blocks, and the units split over as many blocks as fit: whole parts of
// a tile a block where that keeps 90% of them, else evenly (a block's
// range then crosses from one tile into the next).
template <typename TW>
__device__ __forceinline__ Plan plan_of(int N, int K, int V, int NM) {
  const int G0 = gridDim.x, lmax = min(32, kCW / V);
  const int lmin = max(1, min(lmax, 32 / V));
  const bool small = (int64_t)NM * K * N * (int64_t)sizeof(TW) <= kSmallWeight;
  for (int lpr = lmin; lpr <= lmax; lpr <<= 1) {
    const int cw = lpr * V, nt = (N + cw - 1) / cw;
    if (nt > G0) continue;
    if (K <= kStage && (nt * 10 >= G0 * 9 || (small && nt * 2 >= G0)))
      return {lpr, cw, nt, nt};
    break;
  }
  int lpr = lmax;
  while (lpr > lmin &&
         (int64_t)((N + lpr * V - 1) / (lpr * V)) * kMaxParts < (int64_t)G0)
    lpr >>= 1;
  const int cw = lpr * V, nt = (N + cw - 1) / cw;
  int G = (int)min(min((int64_t)G0, (int64_t)nt * K), (int64_t)nt * kMaxParts);
  if (nt < G && nt * (G / nt) * 10 >= G * 9) G = nt * (G / nt);
  return {lpr, cw, nt, G};
}

template <typename TW>
__device__ __forceinline__ int ntiles_of(int N, int K) {
  return plan_of<TW>(N, K, vec_of<TW>(N), 1).ntile;
}

// the block that holds unit u of a line of U >= G units split over G
// blocks (each block then holds at least one)
__device__ __forceinline__ int block_of(int64_t u, int64_t U, int G) {
  return (int)(((u + 1) * G + U - 1) / U) - 1;
}

template <typename T, typename TW, int V>
__device__ __forceinline__ void fma_row(const typename WVec<TW, V>::type& w,
                                        const float4& x, const float (&sc)[V],
                                        float (&acc)[kSlots][V]) {
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const float raw = WVec<TW, V>::raw(w, c);
    const float wv =
        round_int<T>(sizeof(TW) == 1 ? __fmul_rn(raw, sc[c]) : raw);
    acc[0][c] += x.x * wv;
    acc[1][c] += x.y * wv;
    acc[2][c] += x.z * wv;
    acc[3][c] += x.w * wv;
  }
}

// kB rows' loads of one batch (rows i0 + u P), all issued before any is
// used; the masked form skips rows at or past c1
template <typename TW, int V, int kB>
__device__ __forceinline__ void load_batch(
    typename WVec<TW, V>::type (&w)[kB], const TW* wp, int64_t step) {
#pragma unroll
  for (int u = 0; u < kB; ++u) w[u] = WVec<TW, V>::load(wp + u * step);
}

template <typename TW, int V, int kB>
__device__ __forceinline__ void load_batch_masked(
    typename WVec<TW, V>::type (&w)[kB], const TW* wp, int64_t step, int i,
    int P, int c1) {
#pragma unroll
  for (int u = 0; u < kB; ++u)
    if (i + u * P < c1) w[u] = WVec<TW, V>::load(wp + u * step);
}

template <typename T, typename TW, int V, int kB>
__device__ __forceinline__ void fma_batch(
    const typename WVec<TW, V>::type (&w)[kB], const float4* xs, int P,
    int n, const float (&sc)[V], float (&acc)[kSlots][V]) {
#pragma unroll
  for (int u = 0; u < kB; ++u)
    if (u < n) fma_row<T, TW, V>(w[u], xs[u * P], sc, acc);
}

// acc[si][c] += sum over rows i = i0, i0 + P, ... < c1 of xs4[i - c0][si] *
// w(i, j + c), in row order.  Rows go in batches of kB a lane; two
// batches are in flight (ping-pong buffers: the next batch's loads are
// issued before the current one is used, and no register copy waits on
// them); full batches carry no bounds test, the last one is masked.
template <typename T, typename TW, int V>
__device__ __forceinline__ void stream_rows(const float4* xs4, int c0,
                                            const TW* W, int N, int j,
                                            int i, int c1, int P,
                                            const float (&sc)[V],
                                            float (&acc)[kSlots][V]) {
  using VT = typename WVec<TW, V>::type;
  // rows a batch: 4 of 4 f32 columns (64 bytes a lane; 8 rows spilled 1.1
  // KB and measured 6% slower), 8 of 8 int8 codes, 4 of one weight
  constexpr int kB = V == 8 ? 8 : 4;
  const int64_t step = (int64_t)P * N, bstep = kB * step;
  const TW* wp = W + (int64_t)i * N + j;
  const int last_full = c1 - (kB - 1) * P;  // a batch at i < this is full
  VT wa[kB], wb[kB];
  auto tail = [&](const VT (&w)[kB], int at) {
    fma_batch<T, TW, V, kB>(w, xs4 + (at - c0), P, (c1 - at + P - 1) / P,
                            sc, acc);
  };
  if (i < last_full) {
    load_batch<TW, V, kB>(wa, wp, step);
    for (;;) {
      // wa holds the batch at i
      wp += bstep;
      if (i + kB * P >= last_full) {
        load_batch_masked<TW, V, kB>(wb, wp, step, i + kB * P, P, c1);
        fma_batch<T, TW, V, kB>(wa, xs4 + (i - c0), P, kB, sc, acc);
        if (i + kB * P < c1) tail(wb, i + kB * P);
        return;
      }
      load_batch<TW, V, kB>(wb, wp, step);
      fma_batch<T, TW, V, kB>(wa, xs4 + (i - c0), P, kB, sc, acc);
      i += kB * P;
      // wb holds the batch at i
      wp += bstep;
      if (i + kB * P >= last_full) {
        load_batch_masked<TW, V, kB>(wa, wp, step, i + kB * P, P, c1);
        fma_batch<T, TW, V, kB>(wb, xs4 + (i - c0), P, kB, sc, acc);
        if (i + kB * P < c1) tail(wa, i + kB * P);
        return;
      }
      load_batch<TW, V, kB>(wa, wp, step);
      fma_batch<T, TW, V, kB>(wb, xs4 + (i - c0), P, kB, sc, acc);
      i += kB * P;
    }
  }
  if (i < c1) {
    load_batch_masked<TW, V, kB>(wa, wp, step, i, P, c1);
    tail(wa, i);
  }
}

// out[m][s][j] = sum_i x[s][i] * W_m(i, j) for the NM weights W_m (K, N)
// row-major (NM = 2: w1 and w3, the same columns), every slot, the sums
// handed once to epi(s, j, sum_0, sum_{NM-1}).  The (tile, row) units are
// split evenly over the grid (see the header); prep(s0, nb) runs before a
// pass of slots s0 .. s0+nb-1 and stage(xs4, c0, c1, s0, nb) fills
// xs4[i - c0] with their inputs for rows c0 <= i < c1 (0 for the slots
// past nb).  In a warp, lpr lanes take V adjacent columns each and 32 /
// lpr rows; with NM = 2 half the warps take each weight.  ``done``, where
// given, counts the tiles whose epilogue has run.
template <typename T, typename TW, int V, int NM, typename Prep,
          typename Stage, typename Epi>
__device__ void gemv_stream(const MegaArgs& a, int l, int N, int K,
                            const TW* W0, const TW* W1, const float* ws0,
                            const float* ws1, const Scratch& sc, int* cnt,
                            int* done, const Smem& sm, Prep prep,
                            Stage stage, Epi epi) {
  constexpr int kWpm = kWarps / NM;
  const Plan pl = plan_of<TW>(N, K, V, NM);
  const int lpr = pl.lpr, cw = pl.cw, ntile = pl.ntile, G = pl.G;
  const int64_t U = (int64_t)ntile * K;
  if ((int)blockIdx.x >= G) return;
  const int64_t beg = (int64_t)blockIdx.x * U / G;
  const int64_t end = (int64_t)(blockIdx.x + 1) * U / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp / kWpm, wl = warp % kWpm;
  const int cgp = lane % lpr, rl = lane / lpr, rpw = 32 / lpr;
  const int P = kWpm * rpw;
  const TW* W = m == 0 ? W0 : W1;
  const float* ws = m == 0 ? ws0 : ws1;
  float4* xs4 = reinterpret_cast<float4*>(sm.big);
  float* red = sm.big + 4 * kStage;
  const int64_t pstride = (int64_t)NM * a.b * cw;
  for (int64_t u = beg; u < end;) {
    const int t = (int)(u / K);
    const int r0 = (int)(u - (int64_t)t * K);
    const int r1 = (int)min((int64_t)K, r0 + (end - u));
    u += r1 - r0;
    const bool whole = r0 == 0 && r1 == K;
    const int j = t * cw + cgp * V;
    const bool col_ok = j < N;
    float scl[V];
#pragma unroll
    for (int c = 0; c < V; ++c)
      scl[c] = sizeof(TW) == 1 && col_ok ? ws[j + c] : 1.0f;
    for (int s0 = 0; s0 < a.b; s0 += kSlots) {
      const int nb = min(kSlots, a.b - s0);
      prep(s0, nb);
      float acc[kSlots][V];
#pragma unroll
      for (int si = 0; si < kSlots; ++si)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[si][c] = 0.0f;
      for (int c0 = r0; c0 < r1; c0 += kStage) {
        const int c1 = min(r1, c0 + kStage);
        stage(xs4, c0, c1, s0, nb);
        __syncthreads();
        if (col_ok)
          stream_rows<T, TW, V>(xs4, c0, W, N, j, c0 + wl * rpw + rl, c1, P,
                                scl, acc);
        __syncthreads();
      }
#pragma unroll
      for (int si = 0; si < kSlots; ++si) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          float v = acc[si][c];
          for (int off = lpr; off < 32; off <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (rl == 0) red[(warp * kSlots + si) * cw + cgp * V + c] = v;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nb * cw; e += kThreads) {
        const int si = e / cw, cc = e % cw;
        float v[NM];
#pragma unroll
        for (int mm = 0; mm < NM; ++mm) {
          float s = 0.0f;
          for (int w = 0; w < kWpm; ++w)
            s += red[((mm * kWpm + w) * kSlots + si) * cw + cc];
          v[mm] = s;
        }
        if (whole) {
          if (t * cw + cc < N) epi(s0 + si, t * cw + cc, v[0], v[NM - 1]);
        } else {
#pragma unroll
          for (int mm = 0; mm < NM; ++mm)
            sc.part[(int64_t)(blockIdx.x + t) * pstride +
                    ((int64_t)mm * a.b + s0 + si) * cw + cc] = v[mm];
        }
      }
      __syncthreads();
    }
    bool fin = whole;
    if (!whole) {
      const int bf = block_of((int64_t)t * K, U, G);
      const int bl = block_of((int64_t)(t + 1) * K - 1, U, G);
      if (arrive_last(cnt + t, (l + 1) * (bl - bf + 1), sm.flag)) {
        for (int e = threadIdx.x; e < a.b * cw; e += kThreads) {
          const int s = e / cw, cc = e % cw;
          if (t * cw + cc >= N) continue;
          float v[NM];
#pragma unroll
          for (int mm = 0; mm < NM; ++mm) {
            const float* pp = sc.part + (int64_t)(bf + t) * pstride +
                              ((int64_t)mm * a.b + s) * cw + cc;
            float pv[kMaxParts + 1];
#pragma unroll
            for (int p = 0; p <= kMaxParts; ++p)
              pv[p] = p <= bl - bf ? __ldcg(pp + (int64_t)p * pstride) : 0.0f;
            float acc = 0.0f;
#pragma unroll
            for (int p = 0; p <= kMaxParts; ++p)
              if (p <= bl - bf) acc += pv[p];
            v[mm] = acc;
          }
          epi(s, t * cw + cc, v[0], v[NM - 1]);
        }
        fin = true;
      }
    }
    if (done != nullptr && fin) arrive(done);
  }
}

template <typename T, typename TW, int NM, typename Prep, typename Stage,
          typename Epi>
__device__ __forceinline__ void gemv(const MegaArgs& a, int l, int N, int K,
                                     const TW* W0, const TW* W1,
                                     const float* ws0, const float* ws1,
                                     const Scratch& sc, int* cnt, int* done,
                                     const Smem& sm, Prep prep, Stage stage,
                                     Epi epi) {
  constexpr int kV = sizeof(TW) == 1 ? kI8Vec : 4;
  if (vec_of<TW>(N) == kV)
    gemv_stream<T, TW, kV, NM>(a, l, N, K, W0, W1, ws0, ws1, sc, cnt, done,
                               sm, prep, stage, epi);
  else
    gemv_stream<T, TW, 1, NM>(a, l, N, K, W0, W1, ws0, ws1, sc, cnt, done,
                              sm, prep, stage, epi);
}

// ---------------------------------------------------------------------------
// Staging the inputs
// ---------------------------------------------------------------------------

// The reciprocal RMS of residual rows s0 .. s0+nb-1 (blocks.apply_norm with
// rmsnorm: rsqrt(mean(x^2) + eps)) into sm.rinv, once per pass of slots:
// the rows come into sm.raw in one copy (d_model <= kMaxModel), and
// stage_norm reads them there.
template <typename T>
__device__ void norm_prep(const Smem& sm, const T* src, int s0, int nb,
                          int dm) {
  __syncthreads();
  if (*sm.rs0 == s0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = reinterpret_cast<const T*>(sm.raw);
  copy_rows(sm.raw, src + (int64_t)s0 * dm, (int64_t)dm * sizeof(T), nb,
            dm * (int)sizeof(T), dm * (int)sizeof(T), true);
  cp_async_wait_all();
  __syncthreads();
  float ss[kSlots];
#pragma unroll
  for (int si = 0; si < kSlots; ++si) ss[si] = 0.0f;
  for (int i = threadIdx.x; i < dm; i += kThreads) {
#pragma unroll
    for (int si = 0; si < kSlots; ++si) {
      if (si < nb) {
        const float v = to_f32(xr[si * dm + i]);
        ss[si] += v * v;
      }
    }
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    const float v = group_sum<32>(ss[si]);
    if (lane == 0) sm.redn[warp * kSlots + si] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    float tot = 0.0f;
    for (int w = 0; w < kWarps; ++w) tot += sm.redn[w * kSlots + threadIdx.x];
    sm.rinv[threadIdx.x] = rsqrtf(tot / (float)dm + kNormEps);
  }
  if (threadIdx.x == 0) *sm.rs0 = s0;
  __syncthreads();
}

// rows c0 .. c1-1 of the normalised residual (x * rinv * scale, rounded to
// the compute type), the pass's slots interleaved, from the rows
// norm_prep copied in; the segment's scales come in by one copy first
template <typename T>
__device__ void stage_norm(const Smem& sm, float4* xs4, const float* scale,
                           int c0, int c1, int nb, int dm) {
  const T* xr = reinterpret_cast<const T*>(sm.raw);
  float* sv = sm.raw + kSlots * (kStage + 8);
  copy_rows(sv, scale + c0, 0, 1, (c1 - c0) * 4, (c1 - c0) * 4);
  cp_async_wait_all();
  __syncthreads();
  for (int i = c0 + threadIdx.x; i < c1; i += kThreads) {
    float v[kSlots];
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      v[si] = si < nb ? round_to<T>(to_f32(xr[si * dm + i]) * sm.rinv[si] *
                                    sv[i - c0])
                      : 0.0f;
    xs4[i - c0] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// rows c0 .. c1-1 of a (b, K) scratch vector, the pass's slots interleaved:
// the 4 slots' rows (widened to 4-row boundaries, for 16-byte copies) come
// into sm.raw by one copy from L2 first
__device__ __forceinline__ void stage_rows(const Smem& sm, float4* xs4,
                                           const float* src, int c0, int c1,
                                           int s0, int nb, int K) {
  const int a0 = c0 & ~3, a1 = min(K, (c1 + 3) & ~3), w = a1 - a0;
  copy_rows(sm.raw, src + (int64_t)s0 * K + a0, (int64_t)K * 4, nb, w * 4,
            w * 4, true);
  cp_async_wait_all();
  __syncthreads();
  for (int i = c0 + threadIdx.x; i < c1; i += kThreads) {
    float v[kSlots];
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      v[si] = si < nb ? sm.raw[si * w + i - a0] : 0.0f;
    xs4[i - c0] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// The S6 step
// ---------------------------------------------------------------------------

// Position l's state: (b, ...) tensors in and out.
struct RowState {
  const void* h;
  const float* h_scale;
  const void* conv;
  void* h_out;
  float* h_scale_out;
  void* conv_out;
};

__device__ __forceinline__ RowState row_state(const MegaArgs& a, int l) {
  return {a.rows.h[l], a.rows.h_scale[l], a.rows.conv[l], a.rows.h_out[l],
          a.rows.h_scale_out[l], a.rows.conv_out[l]};
}

// An int8/fp8 state, one pass of slots: the chunk's absmax per slot to
// scratch, one arrival at its scale group's counter, a wait for the
// group's other chunks, each slot's group absmax from their partials, the
// updated scale (the group's first chunk writes it), and the chunk's own
// channels encoded from the f32 values in shared memory (h1s).
template <typename TQ>
__device__ void encode_pass(const MegaArgs& a, int target, const RowState& rs,
                            const Scratch& sc, const Smem& sm, int q, int ch,
                            int nch, int cols, int s0, int nb,
                            const float* h1s) {
  const int per = kScaleGroup / ch;
  const int gq = q / per, qf = gq * per, ql = min(qf + per, nch);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x, c0 = q * ch;
  TQ* h_out = static_cast<TQ*>(rs.h_out);
  __syncthreads();
  if (threadIdx.x < nb)
    sc.amax[(int64_t)(s0 + threadIdx.x) * G + q] =
        __int_as_float(sm.imax[threadIdx.x]);
  arrive(sc.grp + gq);
  wait_count(sc.grp + gq, target * (ql - qf));
  if (warp < nb) {
    float mx = 0.0f;
    for (int p = qf + lane; p < ql; p += 32)
      mx = fmaxf(mx, __ldcg(sc.amax + (int64_t)(s0 + warp) * G + p));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) {
      const int64_t sg = (int64_t)(s0 + warp) * a.g + gq;
      const float so = update_scale(mx, rs.h_scale[sg], Codes<TQ>::kMax);
      sm.so[warp] = so;
      if (q == qf) rs.h_scale_out[sg] = so;
    }
  }
  __syncthreads();
  const int per_slot = cols * kMN;
  for (int e = threadIdx.x; e < nb * per_slot; e += kThreads) {
    const int si = e / per_slot, r = e % per_slot;
    h_out[((int64_t)(s0 + si) * a.di + c0) * kMN + r] = Codes<TQ>::encode(
        __fdiv_rn(h1s[si * ch * kMN + r], sm.so[si]));
  }
}

// The step's operands of one pass of slots into shared memory: the state
// rows (as stored), x_a and z of the chunk (from L2: other blocks wrote
// them this launch)
__device__ __forceinline__ void stage_step(const MegaArgs& a,
                                           const RowState& rs,
                                           const Scratch& sc, char* hs,
                                           float* xs, float* zs, int eh,
                                           int c0, int ch, int cols, int s0,
                                           int nb) {
  copy_rows(hs, static_cast<const char*>(rs.h) +
                    ((int64_t)s0 * a.di + c0) * kMN * eh,
            (int64_t)a.di * kMN * eh, nb, cols * kMN * eh, ch * kMN * eh);
  copy_rows(xs, sc.xa + (int64_t)s0 * a.di + c0, (int64_t)a.di * 4, nb,
            cols * 4, ch * 4, true);
  copy_rows(zs, sc.zb + (int64_t)s0 * a.di + c0, (int64_t)a.di * 4, nb,
            cols * 4, ch * 4, true);
}

// BC's second half: dt, the S6 step, D skip and gate for one chunk of
// channels and every slot.  dt_proj's columns and A's rows of the chunk,
// and the first pass's state rows, x_a and z come into shared memory
// while the block waits for x_proj's tiles.
template <typename T, typename TW>
__device__ void phase_step(const MegaArgs& a, int l, const int64_t* wt,
                           const RowState& rs, const Scratch& sc,
                           const Smem& sm, int ntile_x) {
  const int G = gridDim.x;
  const int ch = chunk_of(a.di, G);
  const int nch = (a.di + ch - 1) / ch;
  const int q = blockIdx.x;
  if (q >= nch) return;
  const int c0 = q * ch, cols = min(ch, a.di - c0);
  const int eh = a.state_dtype == SD_F32 ? 4 : a.state_dtype == SD_BF16 ? 2
                                                                        : 1;
  const TW* Wdt = column<TW>(wt, W_DT);
  const float* dt_scale = column<float>(wt, W_DT_SCALE);
  const float* dt_bias = column<float>(wt, W_DT_BIAS);
  const TW* Aw = column<TW>(wt, W_A);
  const float* a_scale = column<float>(wt, W_A_SCALE);
  const float* Dv = column<float>(wt, W_D);
  char* base = reinterpret_cast<char*>(sm.big);
  TW* wdt = reinterpret_cast<TW*>(base);
  base += a16((size_t)a.R * ch * sizeof(TW));
  TW* aw = reinterpret_cast<TW*>(base);
  base += a16((size_t)ch * kMN * sizeof(TW));
  char* hs = base;
  base += a16((size_t)kSlots * ch * kMN * 4);
  float* xs = reinterpret_cast<float*>(base);
  base += a16((size_t)kSlots * ch * 4);
  float* zs = reinterpret_cast<float*>(base);
  base += a16((size_t)kSlots * ch * 4);
  float* h1s = reinterpret_cast<float*>(base);
  base += a16((size_t)kSlots * ch * kMN * 4);
  float* dl = reinterpret_cast<float*>(base);
  base += a16(4ull * kSlots * a.nx);
  float* dts = reinterpret_cast<float*>(base);
  base += a16(4ull * kSlots * ch);
  float* red2 = reinterpret_cast<float*>(base);
  copy_rows(wdt, Wdt + c0, (int64_t)a.di * sizeof(TW), a.R,
            cols * (int)sizeof(TW), ch * (int)sizeof(TW));
  copy_rows(aw, Aw + (int64_t)c0 * kMN, 0, 1,
            cols * kMN * (int)sizeof(TW), cols * kMN * (int)sizeof(TW));
  stage_step(a, rs, sc, hs, xs, zs, eh, c0, ch, cols, 0, min(kSlots, a.b));
  wait_count(sc.done, (l + 1) * ntile_x);
  const bool quant = quantized(a.state_dtype);
  const int lane = threadIdx.x & 31;
  const int NG = kThreads / ch;  // dt_proj's row groups
  const int npass = (a.b + kSlots - 1) / kSlots;
  for (int s0 = 0; s0 < a.b; s0 += kSlots) {
    const int nb = min(kSlots, a.b - s0);
    if (s0 > 0) {
      __syncthreads();
      stage_step(a, rs, sc, hs, xs, zs, eh, c0, ch, cols, s0, nb);
    }
    cp_async_wait_all();
    for (int e = threadIdx.x; e < nb * a.nx; e += kThreads)
      dl[e] = __ldcg(sc.dbc + (int64_t)s0 * a.nx + e);
    if (threadIdx.x < kSlots) sm.imax[threadIdx.x] = 0;
    __syncthreads();
    {  // dt: column c of the chunk, rows r = rg, rg + NG, ...
      const int c = threadIdx.x % ch, rg = threadIdx.x / ch;
      float acc[kSlots];
#pragma unroll
      for (int si = 0; si < kSlots; ++si) acc[si] = 0.0f;
      if (c < cols) {
        const float sdt = sizeof(TW) == 1 ? dt_scale[c0 + c] : 1.0f;
        for (int r = rg; r < a.R; r += NG) {
          const float raw = (float)wdt[r * ch + c];
          const float w =
              round_to<T>(sizeof(TW) == 1 ? __fmul_rn(raw, sdt) : raw);
#pragma unroll
          for (int si = 0; si < kSlots; ++si)
            if (si < nb) acc[si] += dl[si * a.nx + r] * w;
        }
      }
#pragma unroll
      for (int si = 0; si < kSlots; ++si)
        red2[(rg * kSlots + si) * ch + c] = acc[si];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nb * ch; e += kThreads) {
      const int si = e / ch, c = e % ch;
      if (c >= cols) continue;
      float sum = 0.0f;
      for (int rg = 0; rg < NG; ++rg)
        sum += red2[(rg * kSlots + si) * ch + c];
      const float pre = round_to<T>(sum) + dt_bias[c0 + c];
      dts[si * ch + c] =
          round_to<T>(pre > kSoftplusThreshold ? pre : log1pf(expf(pre)));
    }
    __syncthreads();
    // the step: (slot, channel, state) e, the 16 states of a channel on 16
    // consecutive lanes; every lane joins the shuffles
    const int total = nb * ch * kMN;
    for (int e0 = 0; e0 < total; e0 += kThreads) {
      const int e = min(e0 + (int)threadIdx.x, total - 1);
      const int si = e / (ch * kMN), c = (e / kMN) % ch, st = e % kMN;
      const bool valid = e0 + (int)threadIdx.x < total && c < cols;
      const int cc = min(c, cols - 1), chn = c0 + cc, s = s0 + si;
      const int hl = (si * ch + cc) * kMN + st;  // in the staged rows
      float hv;
      if (a.state_dtype == SD_F32) {
        hv = reinterpret_cast<const float*>(hs)[hl];
      } else if (a.state_dtype == SD_BF16) {
        hv = to_f32(reinterpret_cast<const __nv_bfloat16*>(hs)[hl]);
      } else {
        hv = a.state_dtype == SD_INT8
                 ? Codes<int8_t>::decode(
                       reinterpret_cast<const int8_t*>(hs)[hl])
                 : Codes<__nv_fp8_e4m3>::decode(
                       reinterpret_cast<const __nv_fp8_e4m3*>(hs)[hl]);
        hv = __fmul_rn(hv, rs.h_scale[(int64_t)s * a.g + chn / kScaleGroup]);
      }
      const float raw = (float)aw[cc * kMN + st];
      const float awv = sizeof(TW) == 1 ? __fmul_rn(raw, a_scale[chn]) : raw;
      const float xv = xs[si * ch + cc];
      const float zv = zs[si * ch + cc];
      const float bv = dl[si * a.nx + a.R + st];
      const float cv = dl[si * a.nx + a.R + kMN + st];
      const float dtv = dts[si * ch + cc];
      const float av = sizeof(TW) == 1 ? awv : -expf(awv);
      const float h1 = s6_state_update(hv, dtv, xv, av, bv, a.exp_impl);
      float yv = s6_contract<kMN>(h1, cv);
      yv = s6_gate(yv, xv, Dv, chn, true, zv, a.silu_impl);
      if (valid && st == 0) sc.yb[(int64_t)s * a.di + chn] = round_to<T>(yv);
      const int64_t hidx = ((int64_t)s * a.di + chn) * kMN + st;
      if (a.state_dtype == SD_F32) {
        if (valid) static_cast<float*>(rs.h_out)[hidx] = h1;
      } else if (a.state_dtype == SD_BF16) {
        if (valid)
          static_cast<__nv_bfloat16*>(rs.h_out)[hidx] =
              from_f32<__nv_bfloat16>(h1);
      } else {
        if (valid) h1s[hl] = h1;
        float mx = valid ? fabsf(h1) : 0.0f;
#pragma unroll
        for (int off = kMN / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if ((lane & (kMN - 1)) == 0)
          atomicMax(sm.imax + si, __float_as_int(mx));
      }
    }
    if (quant) {
      const int target = l * npass + s0 / kSlots + 1;
      if (a.state_dtype == SD_INT8)
        encode_pass<int8_t>(a, target, rs, sc, sm, q, ch, nch, cols, s0, nb,
                            h1s);
      else
        encode_pass<__nv_fp8_e4m3>(a, target, rs, sc, sm, q, ch, nch, cols,
                                   s0, nb, h1s);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
mamba_megakernel(const MegaArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem sm = smem_map(smem);
  const Scratch sc = scratch_of(a);
  const T* x0 = static_cast<const T*>(a.x0);
  T* x = static_cast<T*>(a.x);
  const int k1 = a.k - 1;
  const int ntile_x = ntiles_of<TW>(a.nx, a.di);
  // zero_counters: every block its share, before the first barrier
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < sc.ncnt;
       i += gridDim.x * kThreads)
    sc.cnt[i] = 0;
  grid.sync();
  auto no_prep = [](int, int) {};

  for (int l = 0; l < a.L; ++l) {
    const int64_t* wt = a.table + (int64_t)l * W_COLUMNS;
    const T* xsrc = l == 0 ? x0 : x;
    const RowState rs = row_state(a, l);
    const T* conv = static_cast<const T*>(rs.conv);
    T* conv_out = static_cast<T*>(rs.conv_out);

    // A: norm -> in_proj -> conv + SiLU | z
    {
      const float* nscale = column<float>(wt, W_NORM);
      const float* conv_w = column<float>(wt, W_CONV);
      const float* conv_b = column<float>(wt, W_CONV_B);
      if (threadIdx.x == 0) *sm.rs0 = -1;
      gemv<T, TW, 1>(
          a, l, 2 * a.di, a.dm, column<TW>(wt, W_IN), column<TW>(wt, W_IN),
          column<float>(wt, W_IN_SCALE), column<float>(wt, W_IN_SCALE), sc,
          sc.cnt, nullptr, sm,
          [&](int s0, int nb) { norm_prep<T>(sm, xsrc, s0, nb, a.dm); },
          [&](float4* xs4, int c0, int c1, int s0, int nb) {
            stage_norm<T>(sm, xs4, nscale, c0, c1, nb, a.dm);
          },
          [&](int s, int j, float sum, float) {
            const float v = round_to<T>(sum);
            if (j >= a.di) {
              sc.zb[(int64_t)s * a.di + j - a.di] = v;
              return;
            }
            // the conv over the tail (causal_conv1d at L = 1) + bias, its
            // operands loaded before any is used
            const int64_t tail = (int64_t)s * k1 * a.di + j;
            float cv[kMaxConv], wv[kMaxConv];
#pragma unroll
            for (int t = 0; t < kMaxConv; ++t) {
              if (t < k1) {
                cv[t] = to_f32(conv[tail + (int64_t)t * a.di]);
                wv[t] = conv_w[(int64_t)t * a.di + j];
              }
            }
            const float wl = conv_w[(int64_t)k1 * a.di + j], bj = conv_b[j];
            float acc = 0.0f;
#pragma unroll
            for (int t = 0; t < kMaxConv; ++t)
              if (t < k1) acc += cv[t] * wv[t];
            acc += v * wl;
            acc += bj;
            const float xc = round_to<T>(acc);
            sc.xa[(int64_t)s * a.di + j] =
                round_to<T>(apply_silu(xc, a.silu_impl));
            for (int t = 0; t + 1 < k1; ++t)
              conv_out[tail + (int64_t)t * a.di] =
                  conv[tail + (int64_t)(t + 1) * a.di];
            if (k1 > 0) conv_out[tail + (int64_t)(k1 - 1) * a.di] =
                from_f32<T>(v);
          });
    }
    grid.sync();

    // BC: x_proj -> (dt_low, B, C), then the S6 step
    gemv<T, TW, 1>(
        a, l, a.nx, a.di, column<TW>(wt, W_X), column<TW>(wt, W_X),
        column<float>(wt, W_X_SCALE), column<float>(wt, W_X_SCALE), sc,
        sc.cnt + sc.tmax, sc.done, sm, no_prep,
        [&](float4* xs4, int c0, int c1, int s0, int nb) {
          stage_rows(sm, xs4, sc.xa, c0, c1, s0, nb, a.di);
        },
        [&](int s, int j, float sum, float) {
          sc.dbc[(int64_t)s * a.nx + j] = round_to<T>(sum);
        });
    phase_step<T, TW>(a, l, wt, rs, sc, sm, ntile_x);
    grid.sync();

    // D: out_proj, residual
    gemv<T, TW, 1>(
        a, l, a.dm, a.di, column<TW>(wt, W_OUT), column<TW>(wt, W_OUT),
        column<float>(wt, W_OUT_SCALE), column<float>(wt, W_OUT_SCALE), sc,
        sc.cnt + 2 * sc.tmax, nullptr, sm, no_prep,
        [&](float4* xs4, int c0, int c1, int s0, int nb) {
          stage_rows(sm, xs4, sc.yb, c0, c1, s0, nb, a.di);
        },
        [&](int s, int j, float sum, float) {
          const int64_t i = (int64_t)s * a.dm + j;
          x[i] = from_f32<T>(ld_cg(xsrc + i) + round_to<T>(sum));
        });
    grid.sync();
    // E: norm2 -> w1 and w3 -> SiLU(w1 x) * (w3 x), the rounding points
    // of blocks.mlp_apply: each dense output, SiLU and the product
    const float* n2 = column<float>(wt, W_NORM2);
    if (threadIdx.x == 0) *sm.rs0 = -1;
    gemv<T, TW, 2>(
        a, l, a.d_ff, a.dm, column<TW>(wt, W_W1), column<TW>(wt, W_W3),
        column<float>(wt, W_W1_SCALE), column<float>(wt, W_W3_SCALE), sc,
        sc.cnt + 3 * sc.tmax, nullptr, sm,
        [&](int s0, int nb) { norm_prep<T>(sm, x, s0, nb, a.dm); },
        [&](float4* xs4, int c0, int c1, int s0, int nb) {
          stage_norm<T>(sm, xs4, n2, c0, c1, nb, a.dm);
        },
        [&](int s, int j, float s1, float s3) {
          const float act =
              round_to<T>(apply_silu(round_to<T>(s1), a.silu_impl));
          sc.hid[(int64_t)s * a.d_ff + j] =
              round_to<T>(act * round_to<T>(s3));
        });
    grid.sync();
    // F: w2 over each block's rows of the hidden, residual
    gemv<T, TW, 1>(
        a, l, a.dm, a.d_ff, column<TW>(wt, W_W2), column<TW>(wt, W_W2),
        column<float>(wt, W_W2_SCALE), column<float>(wt, W_W2_SCALE), sc,
        sc.cnt + 4 * sc.tmax, nullptr, sm, no_prep,
        [&](float4* xs4, int c0, int c1, int s0, int nb) {
          stage_rows(sm, xs4, sc.hid, c0, c1, s0, nb, a.d_ff);
        },
        [&](int s, int j, float sum, float) {
          const int64_t i = (int64_t)s * a.dm + j;
          x[i] = from_f32<T>(ld_cg(x + i) + round_to<T>(sum));
        });
    if (l + 1 < a.L) grid.sync();
  }
}

using KernelFn = void (*)(const MegaArgs);

// the jamba instance's kernel of one (compute type, weight type) pair,
// defined in megakernel_mamba_inst.cu (built once per pair, so the four
// compile in parallel)
KernelFn kernels_0_0();
KernelFn kernels_0_1();
KernelFn kernels_1_0();
KernelFn kernels_1_1();

}  // namespace mb
}  // namespace marca
