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
// Bound on this card: bytes.  At xlstm-350m (d 1024, 4 heads) an mLSTM layer
// reads 8.4 M weights (33.6 MB in f32: up 4.2 M, wq and wk 2.1 M, down
// 2.1 M) and its matrix memory C, 4 x 512 x 512 a slot, in and out (16.8 MB
// each way at 4 slots in f32); an sLSTM layer reads 6.3 M weights.  A token
// (21 mLSTM and 3 sLSTM layers, 4 slots) takes at least 0.45 ms in f32, and
// the arithmetic is a few operations per byte.
//
// Design, simple and right first, on the mamba instance's machinery
// (megakernel_common.cuh): one persistent cooperative kernel of 512-thread
// blocks, the layer loop inside, a grid barrier wherever the next phase
// needs a whole vector, column-tile GEMVs (gemv_cols, 4 adjacent columns a
// thread: every output width here, 4d, d and a head, is a multiple of 4,
// which the entry point checks) for every projection.  Per mLSTM layer:
//   A   LayerNorm of x per slot (staged), up column tiles; the u half's
//       epilogue runs the conv over the tail and SiLU and writes the new
//       tail; u (= v) and g are stored.                            barrier
//   B   per head: q and k column tiles over the head's SiLU output.  barrier
//   C   the cell over tiles of 32 rows of C per (slot, head): each block
//       recomputes the head's i/f gate dots and stabiliser, then each warp
//       takes rows d of C with 16 columns e a lane: C' = f' C + i' k_d v,
//       written back (int8/fp8: the row's absmax over e is a warp
//       reduction, so each row requantizes with its own scale in the same
//       pass, from the f32 C'), n'_d, and the tile's partial sums of
//       C'^T q over its rows, summed over the warps in a fixed order and
//       stored per tile.  The contraction runs down the columns while the
//       scale runs along the rows; splitting rows over blocks serves both
//       with no atomics.                                           barrier
//   D   one block per (slot, head): num = the tiles' partials in tile
//       order, den = |n' . q|, h = num / max(den, 1), group norm, x SiLU(g).
//                                                                  barrier
//   E   down column tiles and the residual add.                    barrier
// Per sLSTM layer:
//   A   LayerNorm, wx column tiles -> the input gate parts.         barrier
//   B   per head and gate: R h column tiles (f32) + the input part + bias.
//                                                                  barrier
//   C   one block per (slot, head): the cell, the new c, n, h, m, and the
//       group norm.                                                barrier
//   D   out column tiles and the residual add.                     barrier
// Every rounding point of the per-layer path is kept: the norm, each dense
// output, the conv and SiLU outputs, q and k, the gated product and x + y
// round to the compute type; the cells and the gate dots are f32.  Weights
// are read as stored: f32, or int8 codes times their column's scale (up,
// down, wx, out); wq, wk and R are f32 (no dense layers, as in repro).  The
// cells use the accurate expf, log1pf and tanhf.  No float atomics
// anywhere: the same inputs give the same bits.
// Left for later: wgmma tiles fed by TMA, fewer barriers, the q/k and R h
// tiles spread over all blocks (they run head by head).
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
constexpr int kTileRows = 32;   // rows of C per cell item
constexpr int kMaxHead = 512;   // widest head (MAX_XLSTM_HEAD)
constexpr int kLaneCols = kMaxHead / 32;
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

// v summed over the block, in one fixed order; every thread gets the sum.
// buf holds kMWarps floats.
static __device__ float block_sum(float v, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = group_sum<32>(v);
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < kMWarps; ++w) t += buf[w];
  __syncthreads();
  return t;
}

// The residual rows s0 .. s0+nb-1 layer-normalised into shared memory,
// xs[si][i] (blocks.apply_norm with "ln": (x - mean) * rsqrt(var + eps) *
// scale + bias, the variance biased, rounded to the compute type).
template <typename T>
__device__ void stage_ln(float* xs, float* redn, const T* src,
                         const float* scale, const float* bias, int s0,
                         int nb, int dm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kSlots], mu[kSlots], r[kSlots];
#pragma unroll
  for (int si = 0; si < kSlots; ++si) acc[si] = 0.0f;
  for (int i = threadIdx.x; i < dm; i += kMThreads) {
#pragma unroll
    for (int si = 0; si < kSlots; ++si) {
      if (si < nb) {
        const float v = to_f32(src[(int64_t)(s0 + si) * dm + i]);
        xs[si * dm + i] = v;
        acc[si] += v;
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
    for (int w = 0; w < kMWarps; ++w) tot += redn[w * kSlots + si];
    mu[si] = tot / (float)dm;
    acc[si] = 0.0f;
  }
  __syncthreads();  // every thread has read redn before it is written again
  for (int i = threadIdx.x; i < dm; i += kMThreads) {
#pragma unroll
    for (int si = 0; si < kSlots; ++si) {
      if (si < nb) {
        const float v = xs[si * dm + i] - mu[si];
        acc[si] += v * v;
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
    for (int w = 0; w < kMWarps; ++w) tot += redn[w * kSlots + si];
    r[si] = rsqrtf(tot / (float)dm + kNormEps);
  }
  for (int i = threadIdx.x; i < dm; i += kMThreads) {
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      if (si < nb)
        xs[si * dm + i] = round_to<T>((xs[si * dm + i] - mu[si]) * r[si] *
                                      scale[i] + bias[i]);
  }
  __syncthreads();
}

// head hh of rows s0 .. s0+nb-1 of a (b, nh * dh) vector into shared
// memory, xs[si][e]
static __device__ void stage_head(float* xs, const float* src, int s0,
                                  int nb, int hh, int nh, int dh) {
  for (int i = threadIdx.x; i < nb * dh; i += kMThreads) {
    const int si = i / dh, e = i % dh;
    xs[i] = src[((int64_t)(s0 + si) * nh + hh) * dh + e];
  }
  __syncthreads();
}

// x = xsrc + round(W^T y) for the d_model output columns, y (b, K) rounded
// to the compute type in scratch: the block's last projection and residual
template <typename T, typename TW>
__device__ void out_residual(const Args& a, const TW* W, const float* ws,
                             int K, const float* y, const T* xsrc, float* xs,
                             float* red) {
  if (blockIdx.x >= gemv_ntiles<kVec>(a.dm)) return;
  T* x = static_cast<T*>(a.x);
  for (int s0 = 0; s0 < a.b; s0 += kSlots) {
    const int nb = min(kSlots, a.b - s0);
    stage_rows(xs, y, s0, nb, K);
    gemv_cols<T, TW, kVec>(xs, nb, K, W, ws, a.dm, red,
                            [&](int si, int j, float sum) {
                              const int64_t i = (int64_t)(s0 + si) * a.dm + j;
                              x[i] = from_f32<T>(to_f32(xsrc[i]) +
                                                 round_to<T>(sum));
                            });
  }
}

// ---------------------------------------------------------------------------
// mLSTM.  Scratch: u, the conv+SiLU output cv, g, q, k, y (b, 2d) each, and
// the cell tiles' partial sums (b, nh, ntile, dh).
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int ntiles_of(int dh) {
  return (dh + kTileRows - 1) / kTileRows;
}

// A: LayerNorm -> up -> [u | g]; the conv over the tail, SiLU, new tail
template <typename T, typename TW>
__device__ void mlstm_front(const Args& a, const int64_t* wt, int l,
                            const T* xsrc, float* xs, float* red,
                            float* redn) {
  const int di = a.nh * a.dh, k1 = a.k - 1;
  if (blockIdx.x >= gemv_ntiles<kVec>(2 * di)) return;
  const int64_t bdi = (int64_t)a.b * di;
  float* u = a.scratch;
  float* cv = u + bdi;
  float* g = cv + bdi;
  const float* conv = static_cast<const float*>(a.rows.in[P_CONV][l]);
  float* conv_out = static_cast<float*>(a.rows.out[P_CONV][l]);
  const float* cw = column<float>(wt, M_CONV);
  for (int s0 = 0; s0 < a.b; s0 += kSlots) {
    const int nb = min(kSlots, a.b - s0);
    stage_ln<T>(xs, redn, xsrc, column<float>(wt, M_NORM),
                column<float>(wt, M_NORM_B), s0, nb, a.dm);
    gemv_cols<T, TW, kVec>(
        xs, nb, a.dm, column<TW>(wt, M_UP), column<float>(wt, M_UP_SCALE),
        2 * di, red, [&](int si, int j, float sum) {
          const int s = s0 + si;
          const float v = round_to<T>(sum);
          if (j >= di) {
            g[(int64_t)s * di + j - di] = v;
            return;
          }
          u[(int64_t)s * di + j] = v;
          // the conv over the tail (causal_conv1d at L = 1, no bias)
          const int64_t tail = (int64_t)s * k1 * di + j;
          float acc = 0.0f;
          for (int t = 0; t < k1; ++t)
            acc += conv[tail + (int64_t)t * di] * cw[(int64_t)t * di + j];
          acc += v * cw[(int64_t)k1 * di + j];
          const float c = round_to<T>(acc);
          cv[(int64_t)s * di + j] = round_to<T>(apply_silu(c, a.silu_impl));
          for (int t = 0; t + 1 < k1; ++t)
            conv_out[tail + (int64_t)t * di] =
                conv[tail + (int64_t)(t + 1) * di];
          if (k1 > 0) conv_out[tail + (int64_t)(k1 - 1) * di] = v;
        });
  }
}

// B: q = cv_h Wq_h and k = cv_h Wk_h per head, rounded to the compute type
template <typename T>
__device__ void mlstm_qk(const Args& a, const int64_t* wt, float* xs,
                         float* red) {
  const int dh = a.dh, di = a.nh * dh;
  if (blockIdx.x >= gemv_ntiles<kVec>(dh)) return;
  const int64_t bdi = (int64_t)a.b * di;
  const float* cv = a.scratch + bdi;
  float* q = a.scratch + 3 * bdi;
  float* k = a.scratch + 4 * bdi;
  const float* wq = column<float>(wt, M_WQ);
  const float* wk = column<float>(wt, M_WK);
  for (int s0 = 0; s0 < a.b; s0 += kSlots) {
    const int nb = min(kSlots, a.b - s0);
    for (int hh = 0; hh < a.nh; ++hh) {
      stage_head(xs, cv, s0, nb, hh, a.nh, dh);
      const int64_t wo = (int64_t)hh * dh * dh;
      gemv_cols<T, float, kVec>(
          xs, nb, dh, wq + wo, nullptr, dh, red, [&](int si, int j, float sum) {
            q[(int64_t)(s0 + si) * di + hh * dh + j] = round_to<T>(sum);
          });
      gemv_cols<T, float, kVec>(
          xs, nb, dh, wk + wo, nullptr, dh, red, [&](int si, int j, float sum) {
            k[(int64_t)(s0 + si) * di + hh * dh + j] = round_to<T>(sum);
          });
    }
  }
}

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

// C: the cell over (slot, head, 32-row tile) items
template <typename TS>
__device__ void mlstm_cell_tiles(const Args& a, const int64_t* wt, int l,
                                 float* red, float* redn) {
  constexpr bool kQuant = sizeof(TS) == 1;
  const int nh = a.nh, dh = a.dh, di = nh * dh;
  const int64_t bdi = (int64_t)a.b * di;
  const float* u = a.scratch;
  const float* cv = u + bdi;
  const float* q = u + 3 * bdi;
  const float* k = u + 4 * bdi;
  float* part = a.scratch + 6 * bdi;
  const TS* C = static_cast<const TS*>(a.rows.in[P_C][l]);
  TS* C_out = static_cast<TS*>(a.rows.out[P_C][l]);
  const float* cs = static_cast<const float*>(a.rows.in[P_CSCALE][l]);
  float* cs_out = static_cast<float*>(a.rows.out[P_CSCALE][l]);
  const float* n = static_cast<const float*>(a.rows.in[P_N][l]);
  float* n_out = static_cast<float*>(a.rows.out[P_N][l]);
  const float* m = static_cast<const float*>(a.rows.in[P_M][l]);
  float* m_out = static_cast<float*>(a.rows.out[P_M][l]);
  const float* wi = column<float>(wt, M_WI);
  const float* wf = column<float>(wt, M_WF);
  const float* bi = column<float>(wt, M_BI);
  const float* bf = column<float>(wt, M_BF);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntile = ntiles_of(dh);
  for (int it = blockIdx.x; it < a.b * nh * ntile; it += gridDim.x) {
    const int tile = it % ntile, sh = it / ntile;  // sh = slot * nh + head
    const int hh = sh % nh;
    const int64_t off = (int64_t)(sh / nh) * di + (int64_t)hh * dh;
    // the gate pre-activations: the head's f32 dots + bias, the stabiliser
    float pi = 0.0f, pf = 0.0f;
    for (int t = threadIdx.x; t < dh; t += kMThreads) {
      const float c = cv[off + t];
      pi += c * wi[hh * dh + t];
      pf += c * wf[hh * dh + t];
    }
    const float ig = block_sum(pi, redn) + bi[hh];
    const float fg = block_sum(pf, redn) + bf[hh];
    const float logf = log_sigmoid(fg);
    const float m0 = m[sh];
    const float m1 = fmaxf(logf + m0, ig);
    const float ip = expf(ig - m1);
    const float fp = expf(logf + m0 - m1);
    if (tile == 0 && threadIdx.x == 0) m_out[sh] = m1;
    float vv[kLaneCols], acc[kLaneCols];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int e = lane + 32 * c;
      vv[c] = e < dh ? u[off + e] : 0.0f;
      acc[c] = 0.0f;
    }
    const int r1 = min((tile + 1) * kTileRows, dh);
    for (int d = tile * kTileRows + warp; d < r1; d += kMWarps) {
      const float kd = k[off + d];
      const float qd = q[off + d] * a.q_scale;
      const int64_t ri = (int64_t)sh * dh + d;  // row d of this head's C
      const float s_in = kQuant ? cs[ri] : 0.0f;
      float cval[kLaneCols];
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        const int e = lane + 32 * c;
        cval[c] = e < dh ? load_state<TS>(C, ri * dh + e, s_in) : 0.0f;
      }
      float amax = 0.0f;
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        if (lane + 32 * c < dh) {
          const float c1 = fp * cval[c] + ip * (kd * vv[c]);
          cval[c] = c1;
          acc[c] += c1 * qd;
          amax = fmaxf(amax, fabsf(c1));
        }
      }
      if constexpr (kQuant) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        const float so = update_scale(amax, s_in, Codes<TS>::kMax);
        if (lane == 0) cs_out[ri] = so;
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          const int e = lane + 32 * c;
          if (e < dh)
            C_out[ri * dh + e] = Codes<TS>::encode(__fdiv_rn(cval[c], so));
        }
      } else {
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          const int e = lane + 32 * c;
          if (e < dh) C_out[ri * dh + e] = from_f32<TS>(cval[c]);
        }
      }
      if (lane == 0) n_out[ri] = fp * n[ri] + ip * kd;
    }
    // the tile's partial sums of C'^T q: over the warps in a fixed order
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int e = lane + 32 * c;
      if (e < dh) red[warp * dh + e] = acc[c];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < dh; e += kMThreads) {
      float t = 0.0f;
      for (int w = 0; w < kMWarps; ++w) t += red[w * dh + e];
      part[((int64_t)sh * ntile + tile) * dh + e] = t;
    }
    __syncthreads();
  }
}

// D: h = num / max(|n' . q|, 1), group norm, x SiLU(g) -> y
template <typename T>
__device__ void mlstm_finish(const Args& a, const int64_t* wt, int l,
                             float* redn) {
  const int nh = a.nh, dh = a.dh, di = nh * dh;
  const int64_t bdi = (int64_t)a.b * di;
  const float* g = a.scratch + 2 * bdi;
  const float* q = a.scratch + 3 * bdi;
  float* y = a.scratch + 5 * bdi;
  const float* part = a.scratch + 6 * bdi;
  const float* n_new = static_cast<const float*>(a.rows.out[P_N][l]);
  const float* gn = column<float>(wt, M_GN);
  const int ntile = ntiles_of(dh);
  const int e = threadIdx.x;  // dh <= kMThreads
  const bool ok = e < dh;
  for (int sh = blockIdx.x; sh < a.b * nh; sh += gridDim.x) {
    const int hh = sh % nh;
    const int64_t off = (int64_t)(sh / nh) * di + (int64_t)hh * dh;
    const float pd =
        ok ? n_new[(int64_t)sh * dh + e] * (q[off + e] * a.q_scale) : 0.0f;
    const float den = fabsf(block_sum(pd, redn));
    float hv = 0.0f;
    if (ok) {
      float num = 0.0f;
      for (int t = 0; t < ntile; ++t)
        num += part[((int64_t)sh * ntile + t) * dh + e];
      hv = num / fmaxf(den, 1.0f);
    }
    const float mu = block_sum(hv, redn) / (float)dh;
    const float dv = ok ? hv - mu : 0.0f;
    const float var = block_sum(dv * dv, redn) / (float)dh;
    if (ok) {
      const float hn = dv * rsqrtf(var + kNormEps) * gn[hh * dh + e];
      const float sg = round_to<T>(apply_silu(g[off + e], a.silu_impl));
      y[off + e] = round_to<T>(hn * sg);
    }
  }
}

template <typename T, typename TW>
__device__ void mlstm_layer(const Args& a, cg::grid_group& grid, int l,
                            const T* xsrc, float* xs, float* red,
                            float* redn) {
  const int64_t* wt = a.table + (int64_t)l * kColumns;
  mlstm_front<T, TW>(a, wt, l, xsrc, xs, red, redn);
  grid.sync();
  mlstm_qk<T>(a, wt, xs, red);
  grid.sync();
  switch (a.state_dtype) {
    case SD_F32: mlstm_cell_tiles<float>(a, wt, l, red, redn); break;
    case SD_BF16: mlstm_cell_tiles<__nv_bfloat16>(a, wt, l, red, redn); break;
    case SD_INT8: mlstm_cell_tiles<int8_t>(a, wt, l, red, redn); break;
    default: mlstm_cell_tiles<__nv_fp8_e4m3>(a, wt, l, red, redn); break;
  }
  grid.sync();
  mlstm_finish<T>(a, wt, l, redn);
  grid.sync();
  const int64_t bdi = (int64_t)a.b * a.nh * a.dh;
  out_residual<T, TW>(a, column<TW>(wt, M_DOWN),
                      column<float>(wt, M_DOWN_SCALE), a.nh * a.dh,
                      a.scratch + 5 * bdi, xsrc, xs, red);
}

// ---------------------------------------------------------------------------
// sLSTM.  Scratch: the input gate parts gx and the pre-activations (b, 4d)
// each, y (b, d).
// ---------------------------------------------------------------------------

template <typename T, typename TW>
__device__ void slstm_layer(const Args& a, cg::grid_group& grid, int l,
                            const T* xsrc, float* xs, float* red,
                            float* redn) {
  const int64_t* wt = a.table + (int64_t)l * kColumns;
  const int nh = a.nh, dh = a.dh, dm = a.dm, d4 = 4 * dm;
  float* gx = a.scratch;
  float* pre = gx + (int64_t)a.b * d4;
  float* y = pre + (int64_t)a.b * d4;
  // A: LayerNorm -> wx
  if (blockIdx.x < gemv_ntiles<kVec>(d4)) {
    for (int s0 = 0; s0 < a.b; s0 += kSlots) {
      const int nb = min(kSlots, a.b - s0);
      stage_ln<T>(xs, redn, xsrc, column<float>(wt, S_NORM),
                  column<float>(wt, S_NORM_B), s0, nb, dm);
      gemv_cols<T, TW, kVec>(xs, nb, dm, column<TW>(wt, S_WX),
                              column<float>(wt, S_WX_SCALE), d4, red,
                              [&](int si, int j, float sum) {
                                gx[(int64_t)(s0 + si) * d4 + j] =
                                    round_to<T>(sum);
                              });
    }
  }
  grid.sync();
  // B: pre = gx + R h + bias per (head, gate), in f32
  const float* h = static_cast<const float*>(a.rows.in[P_SH][l]);
  const float* r = column<float>(wt, S_R);
  const float* bias = column<float>(wt, S_B);
  if (blockIdx.x < gemv_ntiles<kVec>(dh)) {
    for (int s0 = 0; s0 < a.b; s0 += kSlots) {
      const int nb = min(kSlots, a.b - s0);
      for (int hh = 0; hh < nh; ++hh) {
        stage_head(xs, h, s0, nb, hh, nh, dh);
        for (int gate = 0; gate < 4; ++gate) {
          gemv_cols<float, float, kVec>(
              xs, nb, dh, r + ((int64_t)gate * nh + hh) * dh * dh, nullptr,
              dh, red, [&](int si, int j, float sum) {
                const int col = gate * dm + hh * dh + j;
                const int64_t i = (int64_t)(s0 + si) * d4 + col;
                pre[i] = gx[i] + sum + bias[col];
              });
        }
      }
    }
  }
  grid.sync();
  // C: the cell and the group norm per (slot, head)
  const float* c_in = static_cast<const float*>(a.rows.in[P_SC][l]);
  const float* n_in = static_cast<const float*>(a.rows.in[P_SN][l]);
  const float* m_in = static_cast<const float*>(a.rows.in[P_SM][l]);
  float* c_out = static_cast<float*>(a.rows.out[P_SC][l]);
  float* n_out = static_cast<float*>(a.rows.out[P_SN][l]);
  float* h_out = static_cast<float*>(a.rows.out[P_SH][l]);
  float* m_out = static_cast<float*>(a.rows.out[P_SM][l]);
  const float* gn = column<float>(wt, S_GN);
  const int e = threadIdx.x;  // dh <= kMThreads
  const bool ok = e < dh;
  for (int sh = blockIdx.x; sh < a.b * nh; sh += gridDim.x) {
    const int s = sh / nh, hh = sh % nh;
    float hv = 0.0f;
    if (ok) {
      const int64_t gi = (int64_t)s * d4 + hh * dh + e;
      const int64_t si = (int64_t)sh * dh + e;
      const float z = tanhf(pre[gi]);
      const float ig = pre[gi + dm];
      const float logf = log_sigmoid(pre[gi + 2 * dm]);
      const float og = 1.0f / (1.0f + expf(-pre[gi + 3 * dm]));
      const float m0 = m_in[si];
      const float m1 = fmaxf(logf + m0, ig);
      const float ip = expf(ig - m1);
      const float fp = expf(logf + m0 - m1);
      const float c1 = fp * c_in[si] + ip * z;
      const float n1 = fp * n_in[si] + ip;
      hv = og * c1 / fmaxf(n1, 1.0f);
      c_out[si] = c1;
      n_out[si] = n1;
      h_out[si] = hv;
      m_out[si] = m1;
    }
    const float mu = block_sum(hv, redn) / (float)dh;
    const float dv = ok ? hv - mu : 0.0f;
    const float var = block_sum(dv * dv, redn) / (float)dh;
    if (ok)
      y[(int64_t)s * dm + hh * dh + e] =
          round_to<T>(dv * rsqrtf(var + kNormEps) * gn[hh * dh + e]);
  }
  grid.sync();
  // D: out, residual
  out_residual<T, TW>(a, column<TW>(wt, S_OUT), column<float>(wt, S_OUT_SCALE),
                      dm, y, xsrc, xs, red);
}

template <typename T, typename TW, bool kSlstm>
__global__ void __launch_bounds__(kMThreads) xlstm_megakernel(const Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int kmax = kSlstm ? a.dm : 2 * a.dm;
  float* xs = smem;                                // kSlots * kmax
  float* red = xs + kSlots * kmax;                 // kMWarps * kSlots * 32 * kVec
  float* redn = red + kMWarps * kSlots * 32 * kVec;  // kMWarps * kSlots
  const T* x0 = static_cast<const T*>(a.x0);
  const T* x = static_cast<const T*>(a.x);
  for (int l = 0; l < a.L; ++l) {
    const T* xsrc = l == 0 ? x0 : x;
    if (kSlstm)
      slstm_layer<T, TW>(a, grid, l, xsrc, xs, red, redn);
    else
      mlstm_layer<T, TW>(a, grid, l, xsrc, xs, red, redn);
    if (l + 1 < a.L) grid.sync();
  }
}

// Shared memory of one block: the staged rows, the tile reduction (which
// also holds the cell phase's kMWarps x dh partials) and the norm partials.
inline size_t smem_bytes(int slstm, int dm) {
  const int kmax = slstm ? dm : 2 * dm;
  return sizeof(float) * ((size_t)kSlots * kmax + kMWarps * kSlots * 32 * kVec +
                          kMWarps * kSlots);
}

inline int64_t scratch_floats(int slstm, int b, int dm, int nh) {
  if (slstm) return (int64_t)b * 9 * dm;
  const int di = 2 * dm;
  return (int64_t)b * di * (6 + ntiles_of(di / nh));
}

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
