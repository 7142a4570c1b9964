// Cross-layer decode megakernel (K3), xLSTM instances, for Hopper, sm_90a.
//
// Replaces: repro/kernels/decode_step.py:413 stacked_layer_launch
// (pallas_call at :488) with the two bodies of repro/models/xlstm.py:575
// ("marca_megakernel_mlstm", "marca_megakernel_slstm").  ONE launch runs a
// run of same-kind layers of a decode step for the whole slot pool,
//
//   for l in run:  x = x + block_step(x)
//
// mLSTM (repro_torch/models/xlstm.py mlstm_block_step): LayerNorm -> up
// (d -> 2 x 2d) -> [u | g] -> the conv over the tail (no bias) -> SiLU ->
// per-head q, k (dh x dh each) and the i/f gate dots -> the stabilised
// matrix-memory cell -> group norm -> x SiLU(g) -> down -> residual.
// sLSTM (slstm_block_step): LayerNorm -> wx (d -> 4d) + R h + bias -> the
// scalar-memory cell -> group norm -> out -> residual.  Embed, the final
// norm and the unembed stay in PyTorch.  Each layer's state lives in its own
// cache leaves: a launch takes one pointer per layer and state tensor
// (Rows), and writes the new states into fresh leaves.
//
// The bytes: at xlstm-350m (d 1024, 4 heads of 512) an mLSTM layer reads
// 8.4 M weights (33.6 MB in f32: up 4.2 M, wq and wk 2.1 M, down 2.1 M;
// 14.7 MB with int8 up and down) and its matrix memory C, 4 x 512 x 512 a
// slot, in and out (16.8 MB each way at 4 slots in f32, 4.2 MB in int8);
// a 7-layer run's least time is 140.9 us (f32/f32) and 49.1 us (int8/int8)
// at 3.35 TB/s, a few operations a byte.
//
// mLSTM design: one persistent cooperative kernel of 256-thread blocks
// (255 registers a thread), the layer loop inside, 3 grid barriers a layer
// (3L - 1 a launch).  Each phase's items fit the 132 blocks in one round,
// each item's weights and C rows go into shared memory by cp.async before
// the block stages its inputs (so no register holds them in flight), and
// a sum that spans blocks is finished by the last block to arrive at an
// integer counter (__threadfence, atomicAdd), in a fixed order: no float
// atomics, the same inputs give the same bits.  Per layer:
//   A   block 0 zeroes the layer's counters.  Items: up's column tiles,
//       no split (128 tiles of 32 at xlstm-350m): LayerNorm of x for 4
//       slots (interleaved, one 16-byte shared load a row), the tile's
//       GEMV (4 f32 or 8 int8 columns a lane), the u half's epilogue runs
//       the conv over the tail and SiLU and writes the new tail.  barrier
//   C'  Items: (head, tile of 16 rows of C) for every slot (128 at
//       xlstm-350m): q and k for the tile's rows from the head's conv
//       output and the matching 16 columns of wq and wk (each weight read
//       once for all slots), the head's gate dots and stabiliser, then the
//       cell on the tile's rows of each slot's C, 2 warps a slot: C' =
//       f' C + i' k_d v (an int8/fp8 C requantized row by row from the
//       f32 C', its absmax a warp reduction, the quotient from the scale's
//       reciprocal and one fused correction: the correctly rounded
//       division), n'_d, and the tile's partial sums of C'^T q and n'.q.
//       The last item of each group of 8 tiles sums the group's partials
//       in tile order.                                            barrier
//   E   Items: down's 64-column tiles x row ranges (16 x 8 at xlstm-350m).
//       While an item's tile comes in it computes the y of its rows (D's
//       work for each head they lie in: num and den from the 4 group sums
//       in group order, h = num / max(|den|, 1), group norm, x SiLU(g));
//       it writes its partial sums, and the last range of a tile sums them
//       in order and adds the residual.               barrier (to the next A)
// What bounds it on an H100 (700 W): neither DRAM nor the operations. The
// phase stamps of scripts/torch_k3_xlstm.py give 23 / 41 / 24 us of work
// a layer (A / C' / E, f32/f32) and 20 / 34 / 17 (int8/int8), 1.4-2.1 us
// a barrier: a block's tile comes in at about 10 GB/s (1.2 TB/s over the
// card) whether its rows are strided, contiguous or copied by the TMA
// engine, and each dependent step that waits on memory costs 2-5 us at 8
// warps an SM; a run whose layers all read one layer's weights (so from
// L2) is no faster in f32 and 14% faster in int8.  A 7-layer bf16 run at
// 4 slots: 598 us (f32/f32) and 494 us (int8/int8) on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md, PR 18).
//
// sLSTM: one persistent cooperative kernel of its own, 256-thread blocks
// and all of an SM's shared memory, one block an SM, its Args a
// __grid_constant__; 2 grid barriers a layer (2L - 1 a launch), no
// scratch, no counters.  The layer's weights do not depend on its chain,
// so every block puts its own loads in flight (x and the norm's scale and
// bias, the head's h, its cells' inputs) and then issues its items' tiles
// into shared memory by cp.async (about 192 KB of f32, 72 KB of int8 at
// xlstm-350m): R's and wx's strips as one group, out's tile as another,
// so phase 1 does not wait for out; the next layer's as soon as this
// layer's are read.  Weights become floats on the integer and FMA pipes
// (no I2F or F2F).  Where a block's tiles do not fit, its GEMVs stream
// them through one buffer instead.
//   1   Items: (head, tile of cw columns) for all four gates (128 items of
//       8 columns at xlstm-350m): LayerNorm of x and the head's h staged
//       for 4 slots, the four gates' wx columns (K = d) and R columns (K =
//       dh), pre = round(gx) + R h + bias in that order, then the cell of
//       those columns (it is elementwise): the new c, n, h, m.   barrier
//   2   Items: out's column tiles (128 of 8 at xlstm-350m): y = the group
//       norm of h' (each (slot, head)'s mean and variance by one warp, in
//       a fixed order; every item computes them from h' in L2), the
//       tile's columns of out and the residual add.  barrier (to the next
//       layer)
// Each GEMV sums per thread in row order, then across lanes by a
// butterfly and across warps in index order: the same inputs give the
// same bits, and no float atomics.
// Every rounding point of the per-layer path is kept: the norm, each dense
// output, the conv and SiLU outputs, q and k, the gated product and x + y
// round to the compute type; the cells and the gate dots are f32.  Weights
// are read as stored: f32, or int8 codes times their column's scale (up,
// down, wx, out); wq, wk and R are f32 (no dense layers, as in repro).  The
// cells use the accurate expf, log1pf and tanhf.
//
// This header holds the device code; megakernel_xlstm_inst.cu instantiates
// the kernels of one (compute type, weight type) pair, built once per pair
// so the four build in parallel (repro_torch/kernels/_lib.py BUILDS), and
// megakernel_xlstm.cu holds the host entry points.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "megakernel_common.cuh"

namespace cg = cooperative_groups;

namespace marca {
namespace xl {

constexpr int kParts = 5;       // state tensors of a layer, at most
constexpr int kMaxRows = 32;    // layers of one launch (MAX_XLSTM_RUN)
constexpr int kMaxHead = 512;   // widest head (MAX_XLSTM_HEAD)
constexpr int kColumns = 16;    // width of the weight table

// Columns of the per-layer weight table (repro_torch/kernels/megakernel.py
// XLSTM_COLUMNS); a scale column is 0 for f32 weights.
enum MlstmColumn {
  M_NORM = 0, M_NORM_B = 1, M_UP = 2, M_UP_SCALE = 3, M_CONV = 4, M_WQ = 5,
  M_WK = 6, M_WI = 7, M_WF = 8, M_BI = 9, M_BF = 10, M_GN = 11, M_DOWN = 12,
  M_DOWN_SCALE = 13
};
enum SlstmColumn {
  S_NORM = 0, S_NORM_B = 1, S_WX = 2, S_WX_SCALE = 3, S_R = 4, S_B = 5,
  S_GN = 6, S_OUT = 7, S_OUT_SCALE = 8
};
// State parts (megakernel.py XLSTM_PARTS): mLSTM C (b, nh, dh, dh) in the
// state type, C_scale (b, nh, dh), n (b, nh, dh), m (b, nh), conv (b, k-1,
// 2d), all f32 but C; sLSTM c, n, h, m (b, nh, dh) f32.
enum MlstmPart { P_C = 0, P_CSCALE = 1, P_N = 2, P_M = 3, P_CONV = 4 };
enum SlstmPart { P_SC = 0, P_SN = 1, P_SH = 2, P_SM = 3 };

struct Rows {
  const void* in[kParts][kMaxRows];
  void* out[kParts][kMaxRows];
};

struct Args {
  const int64_t* table;  // (L, kColumns) device pointers
  const void* x0;        // (b, dm) compute type: the embedded tokens
  void* x;               // (b, dm) compute type: the residual stream out
  Rows rows;
  float* scratch;
  int L, b, dm, nh, dh, k, state_dtype, silu_impl;
  float q_scale;  // dh^-0.5 as the host rounds it to f32
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// ---------------------------------------------------------------------------
// mLSTM.  Scratch (mlstm_scratch): u, the conv+SiLU output cv and g
// (b, 2d) each; the C' items' partial sums of C'^T q (b, nh, ntile, dh),
// their sums over groups of kGroupTiles tiles (b, nh, ngroup, dh); the
// down items' partial sums (kMaxSplit, b, d); the partial sums of n'.q
// per tile and per group; the arrival counters (nh x ngroup for C', one a
// down tile for E).
// ---------------------------------------------------------------------------

constexpr int kTileRows = 16;    // rows of C (columns of wq, wk) per C' item
constexpr int kGroupTiles = 8;   // C' tiles whose partials one block sums
constexpr int kMaxSplit = 32;    // K splits of the down projection, at most
constexpr int kRedCols = 256;    // widest column tile of a GEMV item
constexpr int kDownCols = 64;    // the down items' column tile
// The mLSTM kernel's block: 256 threads, so a thread may hold 255
// registers (512 threads cap it at 128, and the phases then spill 1.6-1.9
// KB; measured slower on an H100).
constexpr int kXThreads = 256;
constexpr int kXWarps = kXThreads / 32;
// int8 weight columns a thread takes in a GEMV (8 bytes; 16 bytes would
// need 64 accumulators a thread, and measured slower)
constexpr int kI8Cols = 8;
// its dynamic shared memory: C''s largest need (4 slots' 16 rows of an
// f32 C of 512 columns, the wq and wk tiles, the staged inputs); A and E
// stage their weight tiles in what their inputs leave of it
constexpr int kXSmem = 216 * 1024;
// the widest d_model: the mLSTM's E inputs fit, and the sLSTM's staged
// inputs leave its weight buffer room
constexpr int kMaxXModel = 4096;

__host__ __device__ __forceinline__ int ntiles_of(int dh) {
  return (dh + kTileRows - 1) / kTileRows;
}
__host__ __device__ __forceinline__ int ngroups_of(int dh) {
  return (ntiles_of(dh) + kGroupTiles - 1) / kGroupTiles;
}

struct MlstmScratch {
  float *u, *cv, *g, *part, *gpart, *pe, *pden, *gden;
  int *cnt_g, *cnt_e;
};

__device__ __forceinline__ MlstmScratch mlstm_scratch(const Args& a) {
  const int nt = ntiles_of(a.dh), ng = ngroups_of(a.dh);
  const int64_t bdi = (int64_t)a.b * a.nh * a.dh;
  const int64_t bh = (int64_t)a.b * a.nh;
  MlstmScratch s;
  s.u = a.scratch;
  s.cv = s.u + bdi;
  s.g = s.cv + bdi;
  s.part = s.g + bdi;
  s.gpart = s.part + bdi * nt;
  s.pe = s.gpart + bdi * ng;
  s.pden = s.pe + (int64_t)kMaxSplit * a.b * a.dm;
  s.gden = s.pden + bh * nt;
  s.cnt_g = reinterpret_cast<int*>(s.gden + bh * ng);
  s.cnt_e = s.cnt_g + a.nh * ng;
  return s;
}

// ---------------------------------------------------------------------------
// Copies into shared memory that no thread waits for until it needs them
// (cp.async: no register holds the bytes in flight, so a block can have
// all of its operands on the way at once)
// ---------------------------------------------------------------------------

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

template <int kBytes, int kThreads>
__device__ __forceinline__ void copy_pieces(char* dst, const char* src,
                                            int64_t stride, int rows,
                                            int row_bytes, int dst_row) {
  const int per = row_bytes / kBytes;
  for (int t = threadIdx.x; t < rows * per; t += kThreads) {
    const int r = t / per, c = t % per;
    cp_async<kBytes>(dst + (int64_t)r * dst_row + c * kBytes,
                     src + r * stride + c * kBytes);
  }
}

// rows x row_bytes bytes, the rows stride bytes apart at src, into dst
// dst_row bytes apart (both multiples of 4), in the widest pieces the
// alignments allow, by a block of kThreads threads
template <int kThreads = kXThreads>
__device__ __forceinline__ void copy_rows(void* dst, const void* src,
                                          int64_t stride, int rows,
                                          int row_bytes, int dst_row) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int64_t al = (int64_t)(reinterpret_cast<uintptr_t>(s) |
                               reinterpret_cast<uintptr_t>(d)) |
                     stride | row_bytes | dst_row;
  if ((al & 15) == 0)
    copy_pieces<16, kThreads>(d, s, stride, rows, row_bytes, dst_row);
  else if ((al & 7) == 0)
    copy_pieces<8, kThreads>(d, s, stride, rows, row_bytes, dst_row);
  else
    copy_pieces<4, kThreads>(d, s, stride, rows, row_bytes, dst_row);
}

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// ---------------------------------------------------------------------------
// GEMV items: a column tile of a (K, N) row-major weight over a range of
// rows, its weights staged in shared memory
// ---------------------------------------------------------------------------

// V adjacent weights of one row as one shared-memory load: 16 bytes of
// f32, 8 bytes of int8 (kI8Cols), or a char4 where an int8 row is no
// multiple of 8 bytes
template <typename TW, int V> struct WRow;
template <> struct WRow<float, 4> {
  using type = float4;
  static __device__ __forceinline__ float at(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <> struct WRow<int8_t, 8> {
  using type = uint2;
  static __device__ __forceinline__ float at(const uint2& v, int c) {
    const unsigned w = (c >> 2) == 0 ? v.x : v.y;
    return (float)(int8_t)(w >> (8 * (c & 3)));
  }
};
template <> struct WRow<int8_t, 4> {
  using type = char4;
  static __device__ __forceinline__ float at(const char4& v, int c) {
    return (float)(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w);
  }
};

// How a GEMV's columns and rows are cut into items: a column tile of
// cw = lpr x V columns (lpr lanes across a row) and nsplit row ranges of
// kc rows.
struct Plan {
  int lpr, cw, ntile, nsplit, kc;
};

// No split: the narrowest tiles that still give every block at most one
// (up: 4d columns, 128 tiles of 32 at xlstm-350m).
__device__ __forceinline__ Plan plan_cols(int N, int K, int V) {
  Plan p;
  p.lpr = 1;
  while (p.lpr < min(32, kRedCols / V) &&
         (N + p.lpr * V - 1) / (p.lpr * V) > (int)gridDim.x)
    p.lpr <<= 1;
  p.cw = p.lpr * V;
  p.ntile = (N + p.cw - 1) / p.cw;
  p.nsplit = 1;
  p.kc = K;
  return p;
}

// Tiles of kDownCols columns and as many row ranges as fill the grid
// (down: 16 tiles x 8 ranges of 256 rows at xlstm-350m).
__device__ __forceinline__ Plan plan_split(int N, int K, int V) {
  Plan p;
  p.lpr = max(1, min(32, kDownCols / V));
  p.cw = p.lpr * V;
  p.ntile = (N + p.cw - 1) / p.cw;
  p.nsplit = max(1, min(kMaxSplit, (int)gridDim.x / p.ntile));
  p.kc = (K + p.nsplit - 1) / p.nsplit;
  p.nsplit = (K + p.kc - 1) / p.kc;
  return p;
}

// Rows c0 <= i < c1, columns j0 <= j < min(j0 + cw, N) of the NM weights
// Wm (K, N) row-major into wbuf: matrix m's rows at wbuf + m * rows * cw,
// cw elements a row.
template <typename TW, int NM>
__device__ __forceinline__ void issue_tile(TW* wbuf, const TW* W0,
                                           const TW* W1, int N, int c0,
                                           int c1, int j0, int cw) {
  const int cols = min(cw, N - j0);
#pragma unroll
  for (int m = 0; m < NM; ++m)
    copy_rows(wbuf + (int64_t)m * (c1 - c0) * cw,
              (m == 0 ? W0 : W1) + (int64_t)c0 * N + j0,
              (int64_t)N * sizeof(TW), c1 - c0, cols * (int)sizeof(TW),
              cw * (int)sizeof(TW));
}

// out[m][si][j] = sum over rows k0 <= i < k1 of xs4[i - k0][si] * w_m(i, j)
// for the columns j0 <= j < j0 + lpr * V (and < N) of NM weights (K, N)
// row-major, the f32 sum handed to epi(m, si, j, sum) once for si < nb.
// xs4 holds the slots' inputs interleaved, 4 a row, so one 16-byte load
// serves a row.  The weights pass through wbuf (cap rows of each matrix
// at a time, the first chunk already issued by the caller when issued),
// so every byte of a chunk is in flight at once.  The block's warps split
// over the NM weights; in a warp, lpr lanes take V adjacent columns each
// and 32 / lpr rows.  The sum over rows runs per thread in ascending
// order, then across the warp's rows by a butterfly and across the warps
// in index order: fixed for a given (lpr, NM), so the same inputs give the
// same bits.  Ends with the block synchronised.
template <typename T, typename TW, int V, int NM, typename Epi>
__device__ void gemv_tile(const float* xs4, int nb, int k0, int k1,
                          const TW* W0, const TW* W1, const float* ws, int N,
                          int j0, int lpr, TW* wbuf, int cap, bool issued,
                          float* red, Epi epi) {
  using R = WRow<TW, V>;
  using VT = typename R::type;
  constexpr int kWpm = kXWarps / NM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp / kWpm, wl = warp % kWpm;
  const int cg = lane & (lpr - 1), rpw = 32 / lpr;
  const int rb = kWpm * rpw;
  const int cw = lpr * V;
  const int j = j0 + cg * V;
  const bool col_ok = j < N;
  float sc[V];
#pragma unroll
  for (int c = 0; c < V; ++c)
    sc[c] = sizeof(TW) == 1 && col_ok ? ws[j + c] : 1.0f;
  float acc[kSlots][V];
#pragma unroll
  for (int si = 0; si < kSlots; ++si)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[si][c] = 0.0f;
  if (!issued)
    issue_tile<TW, NM>(wbuf, W0, W1, N, k0, min(k1, k0 + cap), j0, cw);
  for (int c0 = k0; c0 < k1; c0 += cap) {
    const int c1 = min(k1, c0 + cap);
    cp_async_wait_all();
    __syncthreads();
    const TW* tile = wbuf + (int64_t)m * (c1 - c0) * cw + cg * V;
    if (col_ok) {
#pragma unroll 4
      for (int i = c0 + wl * rpw + lane / lpr; i < c1; i += rb) {
        const VT w = *reinterpret_cast<const VT*>(tile + (i - c0) * cw);
        const float4 x =
            *reinterpret_cast<const float4*>(xs4 + 4 * (i - k0));
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float raw = R::at(w, c);
          const float wv =
              round_to<T>(sizeof(TW) == 1 ? __fmul_rn(raw, sc[c]) : raw);
          acc[0][c] += x.x * wv;
          acc[1][c] += x.y * wv;
          acc[2][c] += x.z * wv;
          acc[3][c] += x.w * wv;
        }
      }
    }
    if (c1 < k1) {
      __syncthreads();
      issue_tile<TW, NM>(wbuf, W0, W1, N, c1, min(k1, c1 + cap), j0, cw);
    }
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float v = acc[si][c];
      for (int off = lpr; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < lpr) red[(warp * kSlots + si) * cw + cg * V + c] = v;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NM * nb * cw; t += kXThreads) {
    const int mm = t / (nb * cw), si = (t / cw) % nb, cc = t % cw;
    float s = 0.0f;
    for (int w = 0; w < kWpm; ++w)
      s += red[((mm * kWpm + w) * kSlots + si) * cw + cc];
    if (j0 + cc < N) epi(mm, si, j0 + cc, s);
  }
  __syncthreads();
}

// The residual rows s0 .. s0+nb-1 layer-normalised into shared memory
// interleaved, xs4[i][si], 0 for si >= nb (blocks.apply_norm with "ln":
// (x - mean) * rsqrt(var + eps) * scale + bias, the variance biased,
// rounded to the compute type); sb holds the norm's scale and bias (2 x
// dm).  Each thread loads all of its values before it adds any.
template <typename T>
__device__ void stage_ln4(float* xs4, float* sb, float* redn, const T* src,
                          const float* scale, const float* bias, int s0,
                          int nb, int dm) {
  constexpr int kPer = 4;  // elements a thread loads at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kSlots], mu[kSlots], r[kSlots];
#pragma unroll
  for (int si = 0; si < kSlots; ++si) acc[si] = 0.0f;
  for (int i0 = threadIdx.x; i0 < dm; i0 += kPer * kXThreads) {
    float v[kPer][kSlots], sv[kPer], bv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u * kXThreads;
      sv[u] = i < dm ? scale[i] : 0.0f;
      bv[u] = i < dm ? bias[i] : 0.0f;
#pragma unroll
      for (int si = 0; si < kSlots; ++si)
        v[u][si] = i < dm && si < nb
                       ? to_f32(src[(int64_t)(s0 + si) * dm + i]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u * kXThreads;
      if (i < dm) {
        sb[i] = sv[u];
        sb[dm + i] = bv[u];
        *reinterpret_cast<float4*>(xs4 + 4 * i) =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
#pragma unroll
        for (int si = 0; si < kSlots; ++si) acc[si] += v[u][si];
      }
    }
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    const float v = group_sum<32>(acc[si]);
    if (lane == 0) redn[warp * kSlots + si] = v;
  }
  __syncthreads();
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    float tot = 0.0f;
    for (int w = 0; w < kXWarps; ++w) tot += redn[w * kSlots + si];
    mu[si] = tot / (float)dm;
    acc[si] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dm; i += kXThreads) {
    const float4 x = *reinterpret_cast<const float4*>(xs4 + 4 * i);
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int si = 0; si < kSlots; ++si) {
      const float v = xv[si] - mu[si];
      acc[si] += si < nb ? v * v : 0.0f;
    }
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    const float v = group_sum<32>(acc[si]);
    if (lane == 0) redn[warp * kSlots + si] = v;
  }
  __syncthreads();
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    float tot = 0.0f;
    for (int w = 0; w < kXWarps; ++w) tot += redn[w * kSlots + si];
    r[si] = rsqrtf(tot / (float)dm + kNormEps);
  }
  for (int i = threadIdx.x; i < dm; i += kXThreads) {
    const float4 x = *reinterpret_cast<const float4*>(xs4 + 4 * i);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    float o[4];
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      o[si] = si < nb ? round_to<T>((xv[si] - mu[si]) * r[si] * sb[i] +
                                    sb[dm + i])
                      : 0.0f;
    *reinterpret_cast<float4*>(xs4 + 4 * i) = make_float4(o[0], o[1], o[2],
                                                          o[3]);
  }
  __syncthreads();
}

// v[si] summed over the block for each slot, in one fixed order; every
// thread gets the sums.  buf holds kXWarps x kSlots floats.
__device__ __forceinline__ void block_sum4(float (&v)[kSlots], float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    const float s = group_sum<32>(v[si]);
    if (lane == 0) buf[warp * kSlots + si] = s;
  }
  __syncthreads();
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    float t = 0.0f;
    for (int w = 0; w < kXWarps; ++w) t += buf[w * kSlots + si];
    v[si] = t;
  }
  __syncthreads();
}

// The block's arrival at a counter shared by `total` items, after its
// writes: true in the block whose arrival is the last.  The fences order
// the items' partial sums before the count and the last block's reads
// (__ldcg, past L1) after it.
__device__ __forceinline__ bool last_to_arrive(int* counter, int total,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == total - 1;
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// A: this layer's counters zeroed; LayerNorm -> up -> [u | g], the u
// half's epilogue the conv over the tail, SiLU and the new tail.  Items:
// column tiles of up, no split (plan_cols); a block's tile is on its way
// into shared memory before it normalises x.
template <typename T, typename TW, int V>
__device__ void mlstm_front(const Args& a, const int64_t* wt, int l,
                            const T* xsrc, float* smem,
                            const MlstmScratch& sc) {
  const int nh = a.nh, dh = a.dh, di = nh * dh, k1 = a.k - 1, N = 2 * di;
  if (blockIdx.x == 0) {
    const int ncnt = nh * ngroups_of(dh) + (a.dm + kDownCols - 1) / kDownCols;
    for (int i = threadIdx.x; i < ncnt; i += kXThreads) sc.cnt_g[i] = 0;
  }
  const Plan p = plan_cols(N, a.dm, V);
  if ((int)blockIdx.x >= p.ntile) return;
  float* xs4 = smem;                                  // dm x 4
  float* sb = xs4 + kSlots * a.dm;                    // 2 x dm
  float* red = sb + 2 * a.dm;                         // kXWarps x 4 x cw
  float* redn = red + kXWarps * kSlots * p.cw;        // kXWarps x 4
  char* wb = reinterpret_cast<char*>(smem) +
             align16(sizeof(float) * ((size_t)6 * a.dm +
                                      kXWarps * kSlots * (p.cw + 1)));
  TW* wbuf = reinterpret_cast<TW*>(wb);
  const int cap = (int)((kXSmem - (wb - reinterpret_cast<char*>(smem))) /
                        ((size_t)p.cw * sizeof(TW)));
  const float* conv = static_cast<const float*>(a.rows.in[P_CONV][l]);
  float* conv_out = static_cast<float*>(a.rows.out[P_CONV][l]);
  const float* cw = column<float>(wt, M_CONV);
  const TW* W = column<TW>(wt, M_UP);
  const float* ws = column<float>(wt, M_UP_SCALE);
  for (int s0 = 0; s0 < a.b; s0 += kSlots) {
    const int nb = min(kSlots, a.b - s0);
    for (int t = blockIdx.x; t < p.ntile; t += gridDim.x) {
      issue_tile<TW, 1>(wbuf, W, W, N, 0, min(a.dm, cap), t * p.cw, p.cw);
      if (t == (int)blockIdx.x)
        stage_ln4<T>(xs4, sb, redn, xsrc, column<float>(wt, M_NORM),
                     column<float>(wt, M_NORM_B), s0, nb, a.dm);
      gemv_tile<T, TW, V, 1>(
          xs4, nb, 0, a.dm, W, W, ws, N, t * p.cw, p.lpr, wbuf, cap, true,
          red, [&](int, int si, int j, float sum) {
            const int s = s0 + si;
            const float v = round_to<T>(sum);
            if (j >= di) {
              sc.g[(int64_t)s * di + j - di] = v;
              return;
            }
            sc.u[(int64_t)s * di + j] = v;
            // the conv over the tail (causal_conv1d at L = 1, no bias), the
            // loads of the first kTaps taps issued before any is used
            constexpr int kTaps = 8;
            const int64_t tail = (int64_t)s * k1 * di + j;
            float tv[kTaps], tw[kTaps];
#pragma unroll
            for (int q = 0; q < kTaps; ++q) {
              if (q < k1) {
                tv[q] = conv[tail + (int64_t)q * di];
                tw[q] = cw[(int64_t)q * di + j];
              }
            }
            const float wl = cw[(int64_t)k1 * di + j];
            float acc = 0.0f;
#pragma unroll
            for (int q = 0; q < kTaps; ++q)
              if (q < k1) acc += tv[q] * tw[q];
            for (int q = kTaps; q < k1; ++q)
              acc += conv[tail + (int64_t)q * di] * cw[(int64_t)q * di + j];
            acc += v * wl;
            const float c = round_to<T>(acc);
            sc.cv[(int64_t)s * di + j] =
                round_to<T>(apply_silu(c, a.silu_impl));
#pragma unroll
            for (int q = 0; q + 1 < kTaps; ++q)
              if (q + 1 < k1) conv_out[tail + (int64_t)q * di] = tv[q + 1];
            for (int q = kTaps - 1; q + 1 < k1; ++q)
              conv_out[tail + (int64_t)q * di] =
                  conv[tail + (int64_t)(q + 1) * di];
            if (k1 > 0) conv_out[tail + (int64_t)(k1 - 1) * di] = v;
          });
    }
  }
}

template <typename TS> struct CRow;  // 16 bytes of a row of C
template <> struct CRow<float> { static constexpr int kVec = 4; };
template <> struct CRow<__nv_bfloat16> { static constexpr int kVec = 8; };
template <> struct CRow<int8_t> { static constexpr int kVec = 16; };
template <> struct CRow<__nv_fp8_e4m3> { static constexpr int kVec = 16; };

template <typename TS>
__device__ __forceinline__ float load_state(const TS* p, int64_t i,
                                            float scale) {
  if constexpr (std::is_same<TS, float>::value) {
    return p[i];
  } else if constexpr (std::is_same<TS, __nv_bfloat16>::value) {
    return __bfloat162float(p[i]);
  } else {
    return __fmul_rn(Codes<TS>::decode(p[i]), scale);  // dequantize_mat
  }
}

// value i of 16 bytes of TS held as four 32-bit words
template <typename TS>
__device__ __forceinline__ float crow_at(const uint4& r, int i, float scale) {
  const int k = (i * (int)sizeof(TS)) >> 2;
  const unsigned w = k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
  if constexpr (std::is_same<TS, float>::value) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same<TS, __nv_bfloat16>::value) {
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  } else if constexpr (std::is_same<TS, int8_t>::value) {
    return __fmul_rn((float)(int8_t)(w >> (8 * (i & 3))), scale);
  } else {
    __nv_fp8_e4m3 q;
    q.__x = (__nv_fp8_storage_t)(w >> (8 * (i & 3)));
    return __fmul_rn(static_cast<float>(q), scale);
  }
}

// v / so rounded to nearest, given rs = 1 / so rounded to nearest:
// q0 = v rs, the remainder v - q0 so exact in one fused multiply-add, and
// q0 corrected by it (Markstein's iteration: with rs within half an ulp of
// 1 / so the result is the correctly rounded quotient, the one __fdiv_rn
// gives, for the normal-range operands a quantizer divides) -- three
// operations where a division takes some ten and a reciprocal unit's
// quarter rate.
__device__ __forceinline__ float div_by(float v, float so, float rs) {
  const float q0 = __fmul_rn(v, rs);
  return __fmaf_rn(__fmaf_rn(-q0, so, v), rs, q0);
}

// C' as stored: f32 or bf16 as is, int8/fp8 codes of v / so
template <typename TS>
__device__ __forceinline__ TS encode_state(float v, float so, float rs) {
  if constexpr (sizeof(TS) == 1)
    return Codes<TS>::encode(div_by(v, so, rs));
  else
    return from_f32<TS>(v);
}

template <typename TS>
__device__ __forceinline__ unsigned state_bits(float v, float so, float rs) {
  const TS q = encode_state<TS>(v, so, rs);
  if constexpr (std::is_same<TS, float>::value)
    return __float_as_uint(q);
  else if constexpr (std::is_same<TS, __nv_bfloat16>::value)
    return __bfloat16_as_ushort(q);
  else if constexpr (std::is_same<TS, int8_t>::value)
    return (unsigned)(uint8_t)q;
  else
    return (unsigned)q.__x;
}

// kVec values of a row of C' from v: one 16-byte store (streaming: C' is
// not read again here) where the row allows, else one store each
template <typename TS>
__device__ __forceinline__ void store_crow(TS* p, bool vec, int n,
                                           float so, float rs,
                                           const float* v) {
  constexpr int kV = CRow<TS>::kVec;
  constexpr int kPer = 4 / (int)sizeof(TS);  // values a 32-bit word
  if (vec) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kV; ++i)
      w[i / kPer] |= state_bits<TS>(v[i], so, rs)
                     << (8 * (int)sizeof(TS) * (i % kPer));
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (i < n) p[i] = encode_state<TS>(v[i], so, rs);
  }
}

// The partial sums of tiles t0 .. t1-1 of head hh (part, pden: nt of them
// a (slot, head)) summed in tile order for every slot: each thread takes 4
// adjacent columns of a slot (kW such items) and loads all of its tiles'
// partials (at most kGroupTiles) before it adds any.  fn(w, si, q, num,
// den) gets item w's sums.
template <typename Fn>
__device__ __forceinline__ void sum_tiles(const float* part,
                                          const float* pden, int nt, int t0,
                                          int t1, int s0, int nb, int nh,
                                          int hh, int dh, Fn fn) {
  constexpr int kW = (kSlots * kMaxHead / 4 + kXThreads - 1) / kXThreads;
  const int nq = dh / 4;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int idx = threadIdx.x + w * kXThreads;
    const int si = idx / nq, q = idx % nq;
    float num[4] = {0.0f, 0.0f, 0.0f, 0.0f}, den = 0.0f;
    if (si < nb) {
      const int64_t sh = (int64_t)(s0 + si) * nh + hh;
      const float4* p =
          reinterpret_cast<const float4*>(part) + sh * nt * nq + q;
      const float* pd = pden + sh * nt;
      float4 v[kGroupTiles];
      float d[kGroupTiles];
#pragma unroll
      for (int u = 0; u < kGroupTiles; ++u) {
        if (t0 + u < t1) {
          v[u] = __ldcg(p + (int64_t)(t0 + u) * nq);
          d[u] = __ldcg(pd + t0 + u);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroupTiles; ++u) {
        if (t0 + u < t1) {
          num[0] += v[u].x;
          num[1] += v[u].y;
          num[2] += v[u].z;
          num[3] += v[u].w;
          den += d[u];
        }
      }
    }
    fn(w, si, q, num, den);
  }
}

// D's work for head hh and slots s0 .. s0+nb-1, in an E item: num = the
// C' groups' sums in group order (each the sum of its tiles' partials in
// tile order), den = |the same sums of n'.q|, h = num / max(den, 1), group
// norm, x SiLU(g) -> y, written for the columns k0 <= j < k1 straight into
// the item's inputs xs4[j - k0][si] (0 for si >= nb).
template <typename T>
__device__ void mlstm_y(const Args& a, const int64_t* wt, int hh, int s0,
                        int nb, int k0, int k1, float* xs4, float* redn,
                        const MlstmScratch& sc) {
  constexpr int kW = (kSlots * kMaxHead / 4 + kXThreads - 1) / kXThreads;
  const int nh = a.nh, dh = a.dh, di = nh * dh, ng = ngroups_of(dh);
  const float* gn = column<float>(wt, M_GN);
  {
    int si[kW], q[kW];
    float hv[kW][4], tot[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) tot[k] = 0.0f;
    sum_tiles(sc.gpart, sc.gden, ng, 0, ng, s0, nb, nh, hh, dh,
              [&](int w, int s, int c4, const float (&num)[4], float den) {
                si[w] = s;
                q[w] = c4;
                const float dn = fmaxf(fabsf(den), 1.0f);
                float part = 0.0f;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  hv[w][c] = s < nb ? num[c] / dn : 0.0f;
                  part += hv[w][c];
                }
#pragma unroll
                for (int k = 0; k < kSlots; ++k)
                  tot[k] += k == s ? part : 0.0f;
              });
    block_sum4(tot, redn);
    float sq[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) sq[k] = 0.0f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      float m = 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) m = k == si[w] ? tot[k] : m;
      const float mu = m / (float)dh;
      const bool ok = si[w] < nb;
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hv[w][c] = ok ? hv[w][c] - mu : 0.0f;  // now h - mean
        part += hv[w][c] * hv[w][c];
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) sq[k] += k == si[w] ? part : 0.0f;
    }
    block_sum4(sq, redn);
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int j0 = hh * dh + 4 * q[w];  // the item's first column
      if (si[w] >= kSlots || j0 + 4 <= k0 || j0 >= k1) continue;
      float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (si[w] < nb) {
        float var = 0.0f;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) var = k == si[w] ? sq[k] : var;
        const float r = rsqrtf(var / (float)dh + kNormEps);
        const int64_t i = (int64_t)(s0 + si[w]) * di + j0;
        const float4 g4 = *reinterpret_cast<const float4*>(sc.g + i);
        const float4 gn4 = *reinterpret_cast<const float4*>(gn + j0);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
        const float gs[4] = {gn4.x, gn4.y, gn4.z, gn4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float hn = hv[w][c] * r * gs[c];
          y[c] = round_to<T>(hn *
                             round_to<T>(apply_silu(gv[c], a.silu_impl)));
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + c >= k0 && j0 + c < k1) xs4[4 * (j0 + c - k0) + si[w]] = y[c];
    }
  }
}

// C': one item per (head, tile of kTileRows rows of C) for every slot.
// Its operands go into shared memory first, all at once: the tile's
// columns of wq and wk, each slot's rows of C, their scales and n.  Then
// q and k for the tile's rows from the head's conv+SiLU output (each
// weight read once for all slots), the head's gate dots, the cell on the
// tile's rows (requantized row by row for an int8/fp8 C), n', and the
// tile's partial sums of C'^T q and n'.q.  The last item of a group of
// kGroupTiles sums the group's partials; D's work follows in E, whose
// items compute the y they read (mlstm_y).
template <typename T, typename TS>
__device__ void mlstm_cells(const Args& a, const int64_t* wt, int l,
                            float* smem, const MlstmScratch& sc) {
  constexpr bool kQuant = sizeof(TS) == 1;
  constexpr int kV = CRow<TS>::kVec;
  constexpr int kNV = kMaxHead / (32 * kV);  // 16-byte pieces a lane
  constexpr int kCols = (kMaxHead + kXThreads - 1) / kXThreads;
  __shared__ int flag;
  const int nh = a.nh, dh = a.dh, di = nh * dh, nt = ntiles_of(dh);
  const int ng = ngroups_of(dh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // shared memory: C rows, the wq and wk tiles (then the cell's per-warp
  // partials), the staged cv (interleaved) and u, q and k, the gates
  char* base = reinterpret_cast<char*>(smem);
  TS* cbuf = reinterpret_cast<TS*>(base);
  const size_t cbytes = align16((size_t)kSlots * kTileRows * dh * sizeof(TS));
  float* wbuf = reinterpret_cast<float*>(base + cbytes);
  const size_t wbytes = align16(
      max((size_t)2 * dh * kTileRows, (size_t)kXWarps * dh) * sizeof(float));
  float* cvs4 = reinterpret_cast<float*>(base + cbytes + wbytes);  // dh x 4
  float* vs = cvs4 + kSlots * dh;                // 4 x dh
  float* qk = vs + kSlots * dh;                  // 2 x 4 x kTileRows
  float* crs = qk + 2 * kSlots * kTileRows;      // 2 x 4 x kTileRows
  float* gates = crs + 2 * kSlots * kTileRows;   // 2 x 4: i', f'
  float* dred = gates + 2 * kSlots;              // kXWarps
  float* gred = dred + kXWarps;                  // kXWarps x 8
  float* qred = gred + kXWarps * 2 * kSlots;     // kXWarps x 4 x kTileRows
  float* red = wbuf;                             // kXWarps x dh, after q/k
  const TS* C = static_cast<const TS*>(a.rows.in[P_C][l]);
  TS* C_out = static_cast<TS*>(a.rows.out[P_C][l]);
  const float* cs = static_cast<const float*>(a.rows.in[P_CSCALE][l]);
  float* cs_out = static_cast<float*>(a.rows.out[P_CSCALE][l]);
  const float* n = static_cast<const float*>(a.rows.in[P_N][l]);
  float* n_out = static_cast<float*>(a.rows.out[P_N][l]);
  const float* m = static_cast<const float*>(a.rows.in[P_M][l]);
  float* m_out = static_cast<float*>(a.rows.out[P_M][l]);
  const float* wq = column<float>(wt, M_WQ);
  const float* wk = column<float>(wt, M_WK);
  const float* wi = column<float>(wt, M_WI);
  const float* wf = column<float>(wt, M_WF);
  const float* bi = column<float>(wt, M_BI);
  const float* bf = column<float>(wt, M_BF);
  const bool vec = dh % kV == 0;
  for (int it = blockIdx.x; it < nh * nt; it += gridDim.x) {
    const int hh = it / nt, tile = it % nt;
    const int r0 = tile * kTileRows;
    const int rows = min(kTileRows, dh - r0);
    const int64_t wo = (int64_t)hh * dh * dh;
    // the gate weights of this thread's columns of the head
    float a_i[kCols], a_f[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int t = threadIdx.x + c * kXThreads;
      a_i[c] = t < dh ? wi[hh * dh + t] : 0.0f;
      a_f[c] = t < dh ? wf[hh * dh + t] : 0.0f;
    }
    for (int s0 = 0; s0 < a.b; s0 += kSlots) {
      const int nb = min(kSlots, a.b - s0);
      // the operands on their way: wq, wk, C rows, scales, n
      issue_tile<float, 2>(wbuf, wq + wo, wk + wo, dh, 0, dh, r0, kTileRows);
      for (int si = 0; si < nb; ++si) {
        const int64_t ri = ((int64_t)(s0 + si) * nh + hh) * dh + r0;
        copy_rows(cbuf + (int64_t)si * kTileRows * dh, C + ri * dh, 0, 1,
                  rows * dh * (int)sizeof(TS), 0);
        if (kQuant)
          copy_rows(crs + si * kTileRows, cs + ri, 0, 1, rows * 4, 0);
        copy_rows(crs + (kSlots + si) * kTileRows, n + ri, 0, 1, rows * 4,
                  0);
      }
      const bool gate = (int)threadIdx.x < nb;
      const int gsh = (s0 + threadIdx.x) * nh + hh;
      const float b_i = gate ? bi[hh] : 0.0f, b_f = gate ? bf[hh] : 0.0f;
      const float m0 = gate ? m[gsh] : 0.0f;
      for (int i0 = threadIdx.x; i0 < kSlots * dh; i0 += 4 * kXThreads) {
        float c4[4], u4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kXThreads, si = i / dh, e = i % dh;
          const int64_t o = (int64_t)(s0 + si) * di + (int64_t)hh * dh + e;
          const bool in = i < kSlots * dh && si < nb;
          c4[u] = in ? sc.cv[o] : 0.0f;
          u4[u] = in ? sc.u[o] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kXThreads, si = i / dh, e = i % dh;
          if (i < kSlots * dh) {
            cvs4[4 * e + si] = c4[u];
            vs[si * dh + e] = u4[u];
          }
        }
      }
      // q, k for the tile's rows d: columns d of wq_hh and wk_hh
      gemv_tile<T, float, 4, 2>(
          cvs4, nb, 0, dh, wq + wo, wk + wo, nullptr, dh, r0, kTileRows / 4,
          wbuf, dh, true, qred, [&](int mm, int si, int d, float sum) {
            qk[(mm * kSlots + si) * kTileRows + d - r0] = round_to<T>(sum);
          });
      // the gate pre-activations: the head's f32 dots + bias, the
      // stabiliser; every item of the head sums them in the same order
      float gd[2 * kSlots];
#pragma unroll
      for (int q = 0; q < 2 * kSlots; ++q) gd[q] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int t = threadIdx.x + c * kXThreads;
        if (t < dh) {
          const float4 x = *reinterpret_cast<const float4*>(cvs4 + 4 * t);
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int si = 0; si < kSlots; ++si) {
            gd[si] += xv[si] * a_i[c];
            gd[kSlots + si] += xv[si] * a_f[c];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2 * kSlots; ++q) {
        const float v = group_sum<32>(gd[q]);
        if (lane == 0) gred[warp * 2 * kSlots + q] = v;
      }
      __syncthreads();
      if (gate) {
        const int si = threadIdx.x;
        float pi = 0.0f, pf = 0.0f;
        for (int w = 0; w < kXWarps; ++w) {
          pi += gred[w * 2 * kSlots + si];
          pf += gred[w * 2 * kSlots + kSlots + si];
        }
        const float ig = pi + b_i;
        const float fg = pf + b_f;
        const float logf = log_sigmoid(fg);
        const float m1 = fmaxf(logf + m0, ig);
        gates[si] = expf(ig - m1);
        gates[kSlots + si] = expf(logf + m0 - m1);
        if (tile == 0) m_out[gsh] = m1;
      }
      __syncthreads();
      // the cell: warps split over the slots, each walks rows of its slot
      const int wps = kXWarps / nb;
      const int sl = warp / wps, sub = warp % wps;
      float acc[kNV * kV];
#pragma unroll
      for (int q = 0; q < kNV * kV; ++q) acc[q] = 0.0f;
      float dsum = 0.0f;
      if (sl < nb) {
        const int sh = (s0 + sl) * nh + hh;
        const float ip = gates[sl], fp = gates[kSlots + sl];
        const float* v = vs + sl * dh;
        const TS* cb = cbuf + (int64_t)sl * kTileRows * dh;
        for (int r = sub; r < rows; r += wps) {
          const float kd = qk[(kSlots + sl) * kTileRows + r];
          const float qd = qk[sl * kTileRows + r] * a.q_scale;
          const float s_in = kQuant ? crs[sl * kTileRows + r] : 0.0f;
          const int64_t ri = (int64_t)sh * dh + r0 + r;  // row of C
          float cval[kNV * kV];
#pragma unroll
          for (int c = 0; c < kNV; ++c) {
            const int e0 = (c * 32 + lane) * kV;
            if (vec) {
              const uint4 raw =
                  e0 < dh ? *reinterpret_cast<const uint4*>(cb + r * dh + e0)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
              for (int i = 0; i < kV; ++i)
                cval[c * kV + i] = crow_at<TS>(raw, i, s_in);
            } else {
#pragma unroll
              for (int i = 0; i < kV; ++i)
                cval[c * kV + i] = e0 + i < dh
                                       ? load_state<TS>(cb, r * dh + e0 + i,
                                                        s_in)
                                       : 0.0f;
            }
          }
          float amax = 0.0f;
#pragma unroll
          for (int c = 0; c < kNV; ++c) {
            const int e0 = (c * 32 + lane) * kV;
#pragma unroll
            for (int i = 0; i < kV; i += 4) {
              if (e0 + i < dh) {  // dh is a multiple of 4
                const float4 v4 = *reinterpret_cast<const float4*>(v + e0 + i);
                const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float c1 =
                      fp * cval[c * kV + i + q] + ip * (kd * vq[q]);
                  cval[c * kV + i + q] = c1;
                  acc[c * kV + i + q] += c1 * qd;
                  amax = fmaxf(amax, fabsf(c1));
                }
              }
            }
          }
          float so = 1.0f, rs = 1.0f;
          if constexpr (kQuant) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
            so = update_scale(amax, s_in, Codes<TS>::kMax);
            rs = __frcp_rn(so);
            if (lane == 0) cs_out[ri] = so;
          }
#pragma unroll
          for (int c = 0; c < kNV; ++c) {
            const int e0 = (c * 32 + lane) * kV;
            if (e0 < dh)
              store_crow<TS>(C_out + ri * dh + e0, vec, dh - e0, so, rs,
                             cval + c * kV);
          }
          if (lane == 0) {
            const float n1 = fp * crs[(kSlots + sl) * kTileRows + r] + ip * kd;
            n_out[ri] = n1;
            dsum += n1 * qd;
          }
        }
      }
      __syncthreads();  // red aliases the wq/wk tiles the warps are done with
      if (sl < nb) {
        // the warp's partial sums of C'^T q over its rows
#pragma unroll
        for (int c = 0; c < kNV; ++c) {
          const int e0 = (c * 32 + lane) * kV;
#pragma unroll
          for (int i = 0; i < kV; i += 4)
            if (e0 + i < dh)
              *reinterpret_cast<float4*>(red + warp * dh + e0 + i) =
                  make_float4(acc[c * kV + i], acc[c * kV + i + 1],
                              acc[c * kV + i + 2], acc[c * kV + i + 3]);
        }
        if (lane == 0) dred[warp] = dsum;
      }
      __syncthreads();
      // the tile's partials: each slot's warps summed in index order
      for (int t = threadIdx.x; t < nb * dh; t += kXThreads) {
        const int si = t / dh, e = t % dh;
        float s = 0.0f;
        for (int w = 0; w < wps; ++w) s += red[(si * wps + w) * dh + e];
        const int64_t sh = (int64_t)(s0 + si) * nh + hh;
        sc.part[(sh * nt + tile) * dh + e] = s;
      }
      if (threadIdx.x < nb) {
        const int si = threadIdx.x;
        float s = 0.0f;
        for (int w = 0; w < wps; ++w) s += dred[si * wps + w];
        sc.pden[((int64_t)(s0 + si) * nh + hh) * nt + tile] = s;
      }
      __syncthreads();
    }
    // the group's sums, then the head's D work, in the last to arrive
    const int grp = tile / kGroupTiles, t0 = grp * kGroupTiles;
    const int t1 = min(nt, t0 + kGroupTiles);
    if (last_to_arrive(sc.cnt_g + hh * ng + grp, t1 - t0, &flag)) {
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        sum_tiles(sc.part, sc.pden, nt, t0, t1, s0, nb, nh, hh, dh,
                  [&](int, int si, int q, const float (&num)[4], float den) {
                    if (si >= nb) return;
                    const int64_t gi =
                        ((int64_t)(s0 + si) * nh + hh) * ng + grp;
                    *reinterpret_cast<float4*>(sc.gpart + gi * dh + 4 * q) =
                        make_float4(num[0], num[1], num[2], num[3]);
                    if (q == 0) sc.gden[gi] = den;
                  });
      }
    }
  }
}

// E: D's work, down and the residual add.  Items: kDownCols-column tiles
// x row ranges (plan_split); an item's weights go into shared memory while
// it computes the y of its rows (mlstm_y: D's work for the heads they lie
// in); each writes its partial sums, and the last item of a tile sums the
// ranges in order and adds the residual.
template <typename T, typename TW, int V>
__device__ void mlstm_down(const Args& a, const int64_t* wt,
                           const T* xsrc, float* smem,
                           const MlstmScratch& sc) {
  __shared__ int flag;
  const int di = a.nh * a.dh, N = a.dm;
  const Plan p = plan_split(N, di, V);
  float* xs4 = smem;                           // kc x 4
  float* red = xs4 + kSlots * p.kc;            // kXWarps x 4 x cw
  char* wb = reinterpret_cast<char*>(smem) +
             align16(sizeof(float) * ((size_t)kSlots * p.kc +
                                      kXWarps * kSlots * p.cw));
  TW* wbuf = reinterpret_cast<TW*>(wb);
  const int cap = (int)((kXSmem - (wb - reinterpret_cast<char*>(smem))) /
                        ((size_t)p.cw * sizeof(TW)));
  T* x = static_cast<T*>(a.x);
  const TW* W = column<TW>(wt, M_DOWN);
  const float* ws = column<float>(wt, M_DOWN_SCALE);
  for (int it = blockIdx.x; it < p.ntile * p.nsplit; it += gridDim.x) {
    const int ct = it % p.ntile, sp = it / p.ntile;
    const int k0 = sp * p.kc, k1 = min(di, k0 + p.kc);
    for (int s0 = 0; s0 < a.b; s0 += kSlots) {
      const int nb = min(kSlots, a.b - s0);
      issue_tile<TW, 1>(wbuf, W, W, N, k0, min(k1, k0 + cap), ct * p.cw,
                        p.cw);
      // y for the item's rows, head by head, while its tile comes in
      for (int hh = k0 / a.dh; hh * a.dh < k1; ++hh)
        mlstm_y<T>(a, wt, hh, s0, nb, k0, k1, xs4, red, sc);
      gemv_tile<T, TW, V, 1>(xs4, nb, k0, k1, W, W, ws, N, ct * p.cw, p.lpr,
                             wbuf, cap, true, red,
                             [&](int, int si, int j, float sum) {
                               sc.pe[((int64_t)sp * a.b + s0 + si) * N + j] =
                                   sum;
                             });
    }
    if (last_to_arrive(sc.cnt_e + ct, p.nsplit, &flag)) {
      constexpr int kU = 8;
      for (int t = threadIdx.x; t < a.b * p.cw; t += kXThreads) {
        const int s = t / p.cw, j = ct * p.cw + t % p.cw;
        if (j >= N) continue;
        const int64_t i = (int64_t)s * N + j;
        const float xv = to_f32(xsrc[i]);
        float sum = 0.0f;
        for (int q0 = 0; q0 < p.nsplit; q0 += kU) {
          float v[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (q0 + u < p.nsplit)
              v[u] = __ldcg(sc.pe + ((int64_t)(q0 + u) * a.b + s) * N + j);
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (q0 + u < p.nsplit) sum += v[u];
        }
        x[i] = from_f32<T>(xv + round_to<T>(sum));
      }
    }
  }
}

template <typename T, typename TW>
__device__ void mlstm_layer(const Args& a, cg::grid_group& grid, int l,
                            const T* xsrc, float* smem) {
  const int64_t* wt = a.table + (int64_t)l * kColumns;
  const MlstmScratch sc = mlstm_scratch(a);
  constexpr int kV = sizeof(TW) == 1 ? kI8Cols : 4;
  mlstm_front<T, TW, kV>(a, wt, l, xsrc, smem, sc);
  grid.sync();
  switch (a.state_dtype) {
    case SD_F32: mlstm_cells<T, float>(a, wt, l, smem, sc); break;
    case SD_BF16: mlstm_cells<T, __nv_bfloat16>(a, wt, l, smem, sc); break;
    case SD_INT8: mlstm_cells<T, int8_t>(a, wt, l, smem, sc); break;
    default: mlstm_cells<T, __nv_fp8_e4m3>(a, wt, l, smem, sc); break;
  }
  grid.sync();
  if (sizeof(TW) == 1 && a.dm % kV != 0)
    mlstm_down<T, TW, 4>(a, wt, xsrc, smem, sc);
  else
    mlstm_down<T, TW, kV>(a, wt, xsrc, smem, sc);
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kXThreads) mlstm_megakernel(const Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const T* x0 = static_cast<const T*>(a.x0);
  const T* x = static_cast<const T*>(a.x);
  for (int l = 0; l < a.L; ++l) {
    const T* xsrc = l == 0 ? x0 : x;
    mlstm_layer<T, TW>(a, grid, l, xsrc, smem);
    if (l + 1 < a.L) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// sLSTM.  No scratch: an item keeps its input gate parts and
// pre-activations in shared memory, and phase 2 reads h back from the new
// state.
// ---------------------------------------------------------------------------

// The sLSTM kernel's block (its own: the mLSTM's is kXThreads) and dynamic
// shared memory, the H100's opt-in maximum, so one block an SM.
constexpr int kSThreads = 256;
constexpr int kSWarps = kSThreads / 32;
constexpr int kSGates = 4;
constexpr int kSSmem = 227 * 1024;
// the widest phase-1 tile: 4 slots' cells of its columns take one pass
constexpr int kSMaxCols = 64;
static_assert(kSlots * kSMaxCols <= kSThreads, "one cell a thread");
// x values a thread loads for LayerNorm before the weights are issued, a
// slot (d_model up to kSLnPer x kSThreads; the rest load after), and h
// values (a head up to kSHPer x kSThreads, kMaxHead)
constexpr int kSLnPer = 4;
constexpr int kSHPer = (kMaxHead + kSThreads - 1) / kSThreads;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// V adjacent weights of one row as one shared-memory load, and the c-th as
// a float on the integer and FMA pipes (int8 by i8_value)
template <typename TW, int V> struct SRow;
template <> struct SRow<float, 4> {
  using type = float4;
  static __device__ __forceinline__ float at(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <> struct SRow<int8_t, 8> {
  using type = uint2;
  static __device__ __forceinline__ float at(const uint2& v, int c) {
    return i8_value((c >> 2) == 0 ? v.x : v.y, c);
  }
};
template <> struct SRow<int8_t, 4> {
  using type = unsigned;
  static __device__ __forceinline__ float at(unsigned v, int c) {
    return i8_value(v, c);
  }
};

// How a layer is cut into items.  Phase 1: an item takes cw columns of one
// head for all four gates (cw = lx * vx; lx lanes across a row of wx, cw /
// 4 across a row of R, which is f32), ntile tiles a head.  Phase 2: an
// item takes cwo = lo * vo columns of out.  Each the narrowest tiles that
// still give every block at most one item (128 and 128 at xlstm-350m).
struct SPlan {
  int vx, lx, cw, ntile, items1;
  int vo, lo, cwo, items2;
};

__device__ __forceinline__ SPlan slstm_plan(int dm, int nh, int dh,
                                            bool int8) {
  SPlan p;
  p.vx = int8 && dh % 8 == 0 ? 8 : 4;
  p.lx = 1;
  while (2 * p.lx * p.vx <= kSMaxCols && p.lx * p.vx < dh &&
         nh * ((dh + p.lx * p.vx - 1) / (p.lx * p.vx)) > (int)gridDim.x)
    p.lx <<= 1;
  p.cw = p.lx * p.vx;
  p.ntile = (dh + p.cw - 1) / p.cw;
  p.items1 = nh * p.ntile;
  p.vo = int8 && dm % 8 == 0 ? 8 : 4;
  p.lo = 1;
  while (p.lo < 32 && p.lo * p.vo < dm &&
         (dm + p.lo * p.vo - 1) / (p.lo * p.vo) > (int)gridDim.x)
    p.lo <<= 1;
  p.cwo = p.lo * p.vo;
  p.items2 = (dm + p.cwo - 1) / p.cwo;
  return p;
}

// The block's shared memory.  Resident (the tiles of a block's items fit
// beside its inputs, and every block has at most one item a phase): the
// four R strips, the four wx strips and the out tile each in a place of
// their own, issued before the block needs them (the first layer's at
// launch, the next layer's as soon as this layer's are read).  Otherwise
// one buffer from R on, that each GEMV streams its strips through.
struct SLayout {
  float *xs4, *sb, *hs4, *red, *redn, *gx, *res;
  char *r, *wx, *wo;
  size_t buf_bytes;
  bool resident;
};

__device__ __forceinline__ SLayout slstm_layout(float* smem, const SPlan& p,
                                                int dm, int dh, int wbytes) {
  SLayout s;
  float* f = smem;
  s.xs4 = f;  f += kSlots * dm;
  s.sb = f;   f += 2 * dm;
  s.hs4 = f;  f += kSlots * dh;
  s.red = f;  f += kSWarps * kSlots * max(p.cw, p.cwo);
  s.redn = f; f += kSWarps * kSlots;
  s.gx = f;   f += kSGates * kSlots * p.cw;
  s.res = f;  f += kSlots * p.cwo;
  char* base = reinterpret_cast<char*>(smem);
  char* c = base + align16((size_t)(reinterpret_cast<char*>(f) - base));
  s.r = c;
  s.buf_bytes = kSSmem - (size_t)(c - base);
  c += align16((size_t)kSGates * dh * p.cw * sizeof(float));
  s.wx = c;
  c += align16((size_t)kSGates * dm * p.cw * wbytes);
  s.wo = c;
  c += (size_t)dm * p.cwo * wbytes;
  s.resident = p.items1 <= (int)gridDim.x && p.items2 <= (int)gridDim.x &&
               (size_t)(c - base) <= (size_t)kSSmem;
  return s;
}

// Rows r0 <= i < r1 of NM strips of a weight into wbuf: strip m is ncols
// columns from W + m * mstride, its rows ld elements apart; its row i goes
// to wbuf + (m * rows + i - b0) * cw (rows a strip in the buffer, the
// buffer's first row b0).
template <typename TW, int NM>
__device__ __forceinline__ void issue_strips(TW* wbuf, const TW* W,
                                             int64_t ld, int64_t mstride,
                                             int r0, int r1, int ncols,
                                             int cw, int rows, int b0) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
    copy_rows<kSThreads>(wbuf + ((int64_t)m * rows + r0 - b0) * cw,
                         W + m * mstride + (int64_t)r0 * ld,
                         ld * (int64_t)sizeof(TW), r1 - r0,
                         ncols * (int)sizeof(TW), cw * (int)sizeof(TW));
}

// out[m][si][j] = sum over rows 0 <= i < K of xs4[i][si] * w_m(i, j) for
// the ncols columns of NM strips (issue_strips' W, ld, mstride), the f32
// sum handed to epi(m, si, j, sum) once for si < nb and j < ncols.  ws
// (int8 weights) is strip 0's first column's scale, mstride apart as W.
// Resident, the strips are in wbuf whole (K rows a strip), issued by the
// caller (this waits for every cp.async group but the newest); else they
// pass through wbuf cap rows at a time, issued here.  The block's warps split over the NM strips; in a warp, lpr
// lanes take V adjacent columns each and 32 / lpr rows.  Weights become
// floats (int8 codes, the scale's rounded multiply, bf16 rounding) on the
// integer and FMA pipes.  The sum over rows runs per thread in ascending
// order, then across the warp's rows by a butterfly and across the
// strip's warps in index order: fixed, so the same inputs give the same
// bits.  Ends with the block synchronised.
template <typename T, typename TW, int V, int NM, typename Epi>
__device__ void strip_gemv(const float* xs4, int nb, int K, const TW* W,
                           int64_t ld, int64_t mstride, int ncols, int lpr,
                           const float* ws, TW* wbuf, bool resident,
                           int cap, float* red, Epi epi) {
  using R = SRow<TW, V>;
  using VT = typename R::type;
  constexpr int kWpm = kSWarps / NM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp / kWpm, wl = warp % kWpm;
  const int cg = lane & (lpr - 1), rpw = 32 / lpr;
  const int rb = kWpm * rpw;
  const int cw = lpr * V;
  const bool col_ok = cg * V < ncols;
  float sc[V];
#pragma unroll
  for (int c = 0; c < V; ++c)
    sc[c] = sizeof(TW) == 1 && col_ok ? ws[m * mstride + cg * V + c] : 1.0f;
  float acc[kSlots][V];
#pragma unroll
  for (int si = 0; si < kSlots; ++si)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[si][c] = 0.0f;
  if (resident) cap = K;
  for (int c0 = 0; c0 < K; c0 += cap) {
    const int c1 = min(K, c0 + cap);
    const int rows = resident ? K : c1 - c0, b0 = resident ? 0 : c0;
    if (resident) {
      cp_async_wait_group<1>();
    } else {
      issue_strips<TW, NM>(wbuf, W, ld, mstride, c0, c1, ncols, cw, rows,
                           b0);
      cp_async_commit();
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const TW* tile = wbuf + ((int64_t)m * rows - b0) * cw + cg * V;
    if (col_ok) {
#pragma unroll 4
      for (int i = c0 + wl * rpw + lane / lpr; i < c1; i += rb) {
        const VT w = *reinterpret_cast<const VT*>(tile + (int64_t)i * cw);
        const float4 x = *reinterpret_cast<const float4*>(xs4 + 4 * i);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float raw = R::at(w, c);
          const float wv =
              round_int<T>(sizeof(TW) == 1 ? __fmul_rn(raw, sc[c]) : raw);
          acc[0][c] += x.x * wv;
          acc[1][c] += x.y * wv;
          acc[2][c] += x.z * wv;
          acc[3][c] += x.w * wv;
        }
      }
    }
    if (!resident && c1 < K) __syncthreads();  // read before it is refilled
  }
  // the butterfly's step outermost, so its kSlots x V shuffles a step are
  // independent of each other
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
#pragma unroll
      for (int c = 0; c < V; ++c)
        acc[si][c] += __shfl_xor_sync(0xffffffffu, acc[si][c], off);
  }
  if (lane < lpr) {
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
#pragma unroll
      for (int c = 0; c < V; ++c)
        red[(warp * kSlots + si) * cw + cg * V + c] = acc[si][c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NM * nb * cw; t += kSThreads) {
    const int mm = t / (nb * cw), si = (t / cw) % nb, cc = t % cw;
    float s = 0.0f;
    for (int w = 0; w < kWpm; ++w)
      s += red[((mm * kWpm + w) * kSlots + si) * cw + cc];
    if (cc < ncols) epi(mm, si, cc, s);
  }
  __syncthreads();
}

// Phase 1 item t's columns: head hh, its columns e0 .. e0 + ncols - 1
struct SItem {
  int hh, e0, ncols;
};
__device__ __forceinline__ SItem slstm_item(const SPlan& p, int dh, int t) {
  SItem it;
  it.hh = t / p.ntile;
  it.e0 = (t % p.ntile) * p.cw;
  it.ncols = min(p.cw, dh - it.e0);
  return it;
}

// The resident tiles of layer l for this block's items: phase 1's R and
// wx strips, one cp.async group (committed even where this block has no
// item, so every block's groups stay in step)
template <typename TW>
__device__ void slstm_issue_front(const Args& a, int l, const SPlan& p,
                                  const SLayout& sm) {
  if ((int)blockIdx.x < p.items1) {
    const int64_t* wt = a.table + (int64_t)l * kColumns;
    const SItem it = slstm_item(p, a.dh, blockIdx.x);
    issue_strips<float, kSGates>(
        reinterpret_cast<float*>(sm.r), column<float>(wt, S_R) +
        (int64_t)it.hh * a.dh * a.dh + it.e0, a.dh,
        (int64_t)a.nh * a.dh * a.dh, 0, a.dh, it.ncols, p.cw, a.dh, 0);
    issue_strips<TW, kSGates>(
        reinterpret_cast<TW*>(sm.wx), column<TW>(wt, S_WX) + it.hh * a.dh +
        it.e0, 4 * (int64_t)a.dm, a.dm, 0, a.dm, it.ncols, p.cw, a.dm, 0);
  }
  cp_async_commit();
}

// phase 2's out tile of layer l (a group of its own)
template <typename TW>
__device__ void slstm_issue_out(const Args& a, int l, const SPlan& p,
                                const SLayout& sm) {
  if ((int)blockIdx.x < p.items2) {
    const int64_t* wt = a.table + (int64_t)l * kColumns;
    const int j0 = blockIdx.x * p.cwo;
    issue_strips<TW, 1>(reinterpret_cast<TW*>(sm.wo),
                        column<TW>(wt, S_OUT) + j0, a.dm, 0, 0, a.dm,
                        min(p.cwo, a.dm - j0), p.cwo, a.dm, 0);
  }
  cp_async_commit();
}

// LayerNorm of x rows s0 .. s0+nb-1 in two halves: ln_load puts the first
// kSLnPer x kSThreads entries of each row and of the norm's scale and bias
// in flight into registers (before the block issues its weights, so they
// are not queued behind them), ln_finish stages all of them (the rest
// loaded there) into xs4[i][si] and sb and normalises them as stage_ln4
// does.
struct LnIn {
  float x[kSLnPer][kSlots], s[kSLnPer], b[kSLnPer];
};

template <typename T>
__device__ __forceinline__ void ln_load(LnIn& v, const T* src,
                                        const float* scale,
                                        const float* bias, int s0, int nb,
                                        int dm) {
#pragma unroll
  for (int u = 0; u < kSLnPer; ++u) {
    const int i = threadIdx.x + u * kSThreads;
    v.s[u] = i < dm ? scale[i] : 0.0f;
    v.b[u] = i < dm ? bias[i] : 0.0f;
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      v.x[u][si] = i < dm && si < nb
                       ? to_f32(src[(int64_t)(s0 + si) * dm + i]) : 0.0f;
  }
}

template <typename T>
__device__ void ln_finish(const LnIn& v, float* xs4, float* sb, float* redn,
                          const T* src, const float* scale,
                          const float* bias, int s0, int nb, int dm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kSlots], mu[kSlots], r[kSlots];
#pragma unroll
  for (int si = 0; si < kSlots; ++si) acc[si] = 0.0f;
#pragma unroll
  for (int u = 0; u < kSLnPer; ++u) {
    const int i = threadIdx.x + u * kSThreads;
    if (i < dm) {
      *reinterpret_cast<float4*>(xs4 + 4 * i) =
          make_float4(v.x[u][0], v.x[u][1], v.x[u][2], v.x[u][3]);
      sb[i] = v.s[u];
      sb[dm + i] = v.b[u];
#pragma unroll
      for (int si = 0; si < kSlots; ++si) acc[si] += v.x[u][si];
    }
  }
  for (int i = threadIdx.x + kSLnPer * kSThreads; i < dm; i += kSThreads) {
    float w[kSlots];
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      w[si] = si < nb ? to_f32(src[(int64_t)(s0 + si) * dm + i]) : 0.0f;
    *reinterpret_cast<float4*>(xs4 + 4 * i) =
        make_float4(w[0], w[1], w[2], w[3]);
    sb[i] = scale[i];
    sb[dm + i] = bias[i];
#pragma unroll
    for (int si = 0; si < kSlots; ++si) acc[si] += w[si];
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    const float s = group_sum<32>(acc[si]);
    if (lane == 0) redn[warp * kSlots + si] = s;
  }
  __syncthreads();
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    float tot = 0.0f;
    for (int w = 0; w < kSWarps; ++w) tot += redn[w * kSlots + si];
    mu[si] = tot / (float)dm;
    acc[si] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dm; i += kSThreads) {
    const float4 x = *reinterpret_cast<const float4*>(xs4 + 4 * i);
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int si = 0; si < kSlots; ++si) {
      const float d = xv[si] - mu[si];
      acc[si] += si < nb ? d * d : 0.0f;
    }
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    const float s = group_sum<32>(acc[si]);
    if (lane == 0) redn[warp * kSlots + si] = s;
  }
  __syncthreads();
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    float tot = 0.0f;
    for (int w = 0; w < kSWarps; ++w) tot += redn[w * kSlots + si];
    r[si] = rsqrtf(tot / (float)dm + kNormEps);
  }
  for (int i = threadIdx.x; i < dm; i += kSThreads) {
    const float4 x = *reinterpret_cast<const float4*>(xs4 + 4 * i);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    float o[4];
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      o[si] = si < nb ? round_to<T>((xv[si] - mu[si]) * r[si] * sb[i] +
                                    sb[dm + i])
                      : 0.0f;
    *reinterpret_cast<float4*>(xs4 + 4 * i) = make_float4(o[0], o[1], o[2],
                                                          o[3]);
  }
  __syncthreads();
}

// Phase 1: for each item (head, columns), LayerNorm of x, the four gates'
// wx columns, the head's h and their R columns (R h, f32), pre = round(gx)
// + R h + bias (in that order), and the scalar-memory cell of those
// columns (the new c, n, h, m).  With ``issue``, the block issues its
// resident tiles of this layer (the first) once its own loads are in
// flight.
template <typename T, typename TW, int VX>
__device__ void slstm_front(const Args& a, int l, const T* xsrc,
                            const SPlan& p, const SLayout& sm, bool issue) {
  const int64_t* wt = a.table + (int64_t)l * kColumns;
  const int nh = a.nh, dh = a.dh, dm = a.dm;
  const TW* wx = column<TW>(wt, S_WX);
  const float* wxs = column<float>(wt, S_WX_SCALE);
  const float* r = column<float>(wt, S_R);
  const float* bias = column<float>(wt, S_B);
  const float* c_in = static_cast<const float*>(a.rows.in[P_SC][l]);
  const float* n_in = static_cast<const float*>(a.rows.in[P_SN][l]);
  const float* h_in = static_cast<const float*>(a.rows.in[P_SH][l]);
  const float* m_in = static_cast<const float*>(a.rows.in[P_SM][l]);
  float* c_out = static_cast<float*>(a.rows.out[P_SC][l]);
  float* n_out = static_cast<float*>(a.rows.out[P_SN][l]);
  float* h_out = static_cast<float*>(a.rows.out[P_SH][l]);
  float* m_out = static_cast<float*>(a.rows.out[P_SM][l]);
  const int cw = p.cw;
  const int cap_x = (int)(sm.buf_bytes / ((size_t)kSGates * cw * sizeof(TW)));
  const int cap_r =
      (int)(sm.buf_bytes / ((size_t)kSGates * cw * sizeof(float)));
  float* gx = sm.gx;
  for (int t = blockIdx.x; t < p.items1; t += gridDim.x) {
    const SItem it = slstm_item(p, dh, t);
    const int64_t col0 = (int64_t)it.hh * dh + it.e0;
    for (int s0 = 0; s0 < a.b; s0 += kSlots) {
      const int nb = min(kSlots, a.b - s0);
      // this thread's loads first: x and the norm's scale and bias, the
      // head's h, its (slot, column)'s cell inputs
      LnIn lin;
      ln_load<T>(lin, xsrc, column<float>(wt, S_NORM),
                 column<float>(wt, S_NORM_B), s0, nb, dm);
      float hv[kSHPer][kSlots];
#pragma unroll
      for (int u = 0; u < kSHPer; ++u) {
        const int i = threadIdx.x + u * kSThreads;
#pragma unroll
        for (int si = 0; si < kSlots; ++si)
          hv[u][si] = i < dh && si < nb
                          ? h_in[((int64_t)(s0 + si) * nh + it.hh) * dh + i]
                          : 0.0f;
      }
      const int ci = threadIdx.x / it.ncols, cj = threadIdx.x % it.ncols;
      const bool cell = (int)threadIdx.x < nb * it.ncols;
      const int64_t si_idx =
          ((int64_t)(s0 + ci) * nh + it.hh) * dh + it.e0 + cj;
      float c0v = 0.0f, n0v = 0.0f, m0v = 0.0f;
      if (cell) {
        c0v = c_in[si_idx];
        n0v = n_in[si_idx];
        m0v = m_in[si_idx];
      }
      if (issue) {
        slstm_issue_front<TW>(a, l, p, sm);
        slstm_issue_out<TW>(a, l, p, sm);
        issue = false;
      }
#pragma unroll
      for (int u = 0; u < kSHPer; ++u) {
        const int i = threadIdx.x + u * kSThreads;
        if (i < dh)
          *reinterpret_cast<float4*>(sm.hs4 + 4 * i) =
              make_float4(hv[u][0], hv[u][1], hv[u][2], hv[u][3]);
      }
      ln_finish<T>(lin, sm.xs4, sm.sb, sm.redn, xsrc,
                   column<float>(wt, S_NORM), column<float>(wt, S_NORM_B),
                   s0, nb, dm);
      strip_gemv<T, TW, VX, kSGates>(
          sm.xs4, nb, dm, wx + col0, 4 * (int64_t)dm, dm, it.ncols,
          cw / VX, wxs + col0,
          reinterpret_cast<TW*>(sm.resident ? sm.wx : sm.r), sm.resident,
          cap_x, sm.red, [&](int g, int si, int j, float sum) {
            gx[(g * kSlots + si) * cw + j] = round_to<T>(sum);
          });
      strip_gemv<float, float, 4, kSGates>(
          sm.hs4, nb, dh, r + (int64_t)it.hh * dh * dh + it.e0, dh,
          (int64_t)nh * dh * dh, it.ncols, cw / 4, nullptr,
          reinterpret_cast<float*>(sm.r), sm.resident, cap_r, sm.red,
          [&](int g, int si, int j, float sum) {
            const int i = (g * kSlots + si) * cw + j;
            gx[i] = gx[i] + sum + bias[g * dm + col0 + j];
          });
      if (cell) {
        const float* pre = gx + ci * cw + cj;
        const float z = tanhf(pre[0]);
        const float ig = pre[kSlots * cw];
        const float logf = log_sigmoid(pre[2 * kSlots * cw]);
        const float og = 1.0f / (1.0f + expf(-pre[3 * kSlots * cw]));
        const float m1 = fmaxf(logf + m0v, ig);
        const float ip = expf(ig - m1);
        const float fp = expf(logf + m0v - m1);
        const float c1 = fp * c0v + ip * z;
        const float n1 = fp * n0v + ip;
        c_out[si_idx] = c1;
        n_out[si_idx] = n1;
        h_out[si_idx] = og * c1 / fmaxf(n1, 1.0f);
        m_out[si_idx] = m1;
      }
    }
  }
  if (issue) {  // a block with no item keeps the groups in step
    slstm_issue_front<TW>(a, l, p, sm);
    slstm_issue_out<TW>(a, l, p, sm);
  }
}

// Rows s0 .. s0+nb-1 of y = group_norm(h') into shared memory
// interleaved, xs4[i][si] (0 for si >= nb): h' from this layer's new state
// (written by other blocks before the barrier, so read past L1) and the
// norm's scale (into gs) loaded kSLnPer a slot before any is stored, each
// (slot, head)'s mean and biased variance by one warp, in a fixed order,
// then (h' - mean) * rsqrt(var + eps) * scale rounded to the compute type.
template <typename T>
__device__ void stage_gnorm(float* xs4, float* gs, const float* h,
                            const float* gn, int s0, int nb, int nh,
                            int dh) {
  const int dm = nh * dh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = threadIdx.x; i0 < dm; i0 += kSLnPer * kSThreads) {
    float v[kSLnPer][kSlots], g[kSLnPer];
#pragma unroll
    for (int u = 0; u < kSLnPer; ++u) {
      const int i = i0 + u * kSThreads;
      g[u] = i < dm ? gn[i] : 0.0f;
#pragma unroll
      for (int si = 0; si < kSlots; ++si)
        v[u][si] = i < dm && si < nb
                       ? __ldcg(h + (int64_t)(s0 + si) * dm + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kSLnPer; ++u) {
      const int i = i0 + u * kSThreads;
      if (i < dm) {
        gs[i] = g[u];
        *reinterpret_cast<float4*>(xs4 + 4 * i) =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      }
    }
  }
  __syncthreads();
  for (int q = warp; q < nb * nh; q += kSWarps) {
    const int si = q / nh, hh = q % nh;
    float* col = xs4 + 4 * (int64_t)hh * dh + si;
    float sum = 0.0f;
    for (int e = lane; e < dh; e += 32) sum += col[4 * e];
    const float mu = group_sum<32>(sum) / (float)dh;
    float sq = 0.0f;
    for (int e = lane; e < dh; e += 32) {
      const float dv = col[4 * e] - mu;
      sq += dv * dv;
    }
    const float rs = rsqrtf(group_sum<32>(sq) / (float)dh + kNormEps);
    for (int e = lane; e < dh; e += 32)
      col[4 * e] = round_to<T>((col[4 * e] - mu) * rs * gs[hh * dh + e]);
  }
  __syncthreads();
}

// Phase 2: for each item (out columns), y from h', the columns of out and
// the residual add (the residual's entries loaded first, staged in
// shared memory once y is).
template <typename T, typename TW, int VO>
__device__ void slstm_out(const Args& a, int l, const T* xsrc,
                          const SPlan& p, const SLayout& sm) {
  const int64_t* wt = a.table + (int64_t)l * kColumns;
  const int dm = a.dm;
  const TW* W = column<TW>(wt, S_OUT);
  const float* ws = column<float>(wt, S_OUT_SCALE);
  const float* h = static_cast<const float*>(a.rows.out[P_SH][l]);
  T* x = static_cast<T*>(a.x);
  const int cap = (int)(sm.buf_bytes / ((size_t)p.cwo * sizeof(TW)));
  const int cwo = p.cwo;
  for (int t = blockIdx.x; t < p.items2; t += gridDim.x) {
    const int j0 = t * cwo, ncols = min(cwo, dm - j0);
    for (int s0 = 0; s0 < a.b; s0 += kSlots) {
      const int nb = min(kSlots, a.b - s0);
      const int rs = threadIdx.x / cwo, rj = threadIdx.x % cwo;
      const bool mine = rs < nb && rj < ncols;
      const float rv =
          mine ? to_f32(xsrc[(int64_t)(s0 + rs) * dm + j0 + rj]) : 0.0f;
      stage_gnorm<T>(sm.xs4, sm.sb, h, column<float>(wt, S_GN), s0, nb,
                     a.nh, a.dh);
      if (mine) sm.res[rs * cwo + rj] = rv;
      for (int q = threadIdx.x + kSThreads; q < nb * cwo; q += kSThreads)
        if (q % cwo < ncols)
          sm.res[q] = to_f32(xsrc[(int64_t)(s0 + q / cwo) * dm + j0 +
                                  q % cwo]);
      strip_gemv<T, TW, VO, 1>(
          sm.xs4, nb, dm, W + j0, dm, 0, ncols, p.lo, ws + j0,
          reinterpret_cast<TW*>(sm.resident ? sm.wo : sm.r), sm.resident,
          cap, sm.red, [&](int, int si, int j, float sum) {
            x[(int64_t)(s0 + si) * dm + j0 + j] =
                from_f32<T>(sm.res[si * cwo + j] + round_to<T>(sum));
          });
    }
  }
}

// One sLSTM layer: phase 1, a grid barrier, phase 2.  Where resident,
// the next layer's R and wx strips are issued as soon as this layer's
// are read and its out tile once this one is; every block commits the
// same groups in the same order (empty where it issued nothing), so each
// wait knows how many groups came after the one it needs.
template <typename T, typename TW>
__device__ void slstm_layer(const Args& a, cg::grid_group& grid, int l,
                            const T* xsrc, const SPlan& p,
                            const SLayout& sm) {
  const bool issue = sm.resident && l == 0;
  if constexpr (sizeof(TW) == 1) {
    if (p.vx == 8)
      slstm_front<T, TW, 8>(a, l, xsrc, p, sm, issue);
    else
      slstm_front<T, TW, 4>(a, l, xsrc, p, sm, issue);
  } else {
    slstm_front<T, TW, 4>(a, l, xsrc, p, sm, issue);
  }
  if (sm.resident) {
    if (l + 1 < a.L)
      slstm_issue_front<TW>(a, l + 1, p, sm);
    else
      cp_async_commit();
  }
  grid.sync();
  if constexpr (sizeof(TW) == 1) {
    if (p.vo == 8)
      slstm_out<T, TW, 8>(a, l, xsrc, p, sm);
    else
      slstm_out<T, TW, 4>(a, l, xsrc, p, sm);
  } else {
    slstm_out<T, TW, 4>(a, l, xsrc, p, sm);
  }
  if (sm.resident) {
    if (l + 1 < a.L)
      slstm_issue_out<TW>(a, l + 1, p, sm);
    else
      cp_async_commit();
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kSThreads, 1)
    slstm_megakernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const SPlan p = slstm_plan(a.dm, a.nh, a.dh, sizeof(TW) == 1);
  const SLayout sm = slstm_layout(smem, p, a.dm, a.dh, sizeof(TW));
  const T* x0 = static_cast<const T*>(a.x0);
  const T* x = static_cast<const T*>(a.x);
  for (int l = 0; l < a.L; ++l) {
    const T* xsrc = l == 0 ? x0 : x;
    slstm_layer<T, TW>(a, grid, l, xsrc, p, sm);
    if (l + 1 < a.L) grid.sync();
  }
}

// Shared memory of one block.  sLSTM: the opt-in maximum (slstm_layout
// places the inputs and the resident tiles in it, or the streaming
// buffer).  mLSTM: the larger of A's and E's (4 slots' inputs interleaved,
// the GEMV reduction, the norm partials) and C''s (the head's staged cv
// and u, q and k, the gates, the cell's per-warp partials).
inline size_t smem_bytes(int slstm, int) { return slstm ? kSSmem : kXSmem; }

// f32 scratch of one launch (mlstm_scratch's layout for the mLSTM, none
// for the sLSTM; repro_torch/kernels/megakernel.py xlstm_scratch_floats)
inline int64_t scratch_floats(int slstm, int b, int dm, int nh) {
  if (slstm) return 0;
  const int di = 2 * dm, nt = ntiles_of(di / nh), ng = ngroups_of(di / nh);
  const int64_t bdi = (int64_t)b * di, bh = (int64_t)b * nh;
  return bdi * (3 + nt + ng) + (int64_t)kMaxSplit * b * dm + bh * (nt + ng) +
         (int64_t)nh * ng + dm;
}

// threads a block of the mLSTM (slstm 0) or sLSTM (1) kernel
inline int block_threads(int slstm) { return slstm ? kSThreads : kXThreads; }

using KernelFn = void (*)(const Args);

// The mLSTM (slstm 0) or sLSTM (1) kernel of each (compute type, weight
// type) pair, from megakernel_xlstm_inst.cu: kernels_<act>_<weights>, act
// 0 f32 / 1 bf16, weights 0 f32 / 1 int8.
KernelFn kernels_0_0(int slstm);
KernelFn kernels_0_1(int slstm);
KernelFn kernels_1_0(int slstm);
KernelFn kernels_1_1(int slstm);

}  // namespace xl
}  // namespace marca
