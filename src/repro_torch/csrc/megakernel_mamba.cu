// Cross-layer decode megakernel (K3) for Hopper, sm_90a.
//
// Replaces: repro/kernels/decode_step.py:413 stacked_layer_launch
// (pallas_call at :488) with two of its bodies.  The mamba body of
// repro/models/mamba_lm.py:160 ("marca_megakernel_mamba"): ONE launch runs
// every layer of a decode step for the whole slot pool,
//
//   for l in layers:  x = x + mamba_block_megastep(rmsnorm(x))
//
// The jamba body of repro/models/jamba.py:305 ("marca_megakernel_jamba"):
// one launch runs a run of pure-SSM positions of a group (the kMlp
// instances), each position
//
//   x = x + mamba_block_megastep(rmsnorm1(x));  x = x + mlp(rmsnorm2(x))
//
// with mlp the swiglu w2(SiLU(w1 x) * (w3 x)).  Its positions' states live
// in different cache leaves, so a launch takes one pointer per position
// and state tensor (StateRows) where the mamba instance takes one stacked
// tensor each.
//
// with the chain of repro_torch/models/mamba.py mamba_block_megastep: norm
// -> in_proj -> [x | z] -> conv over the tail + bias -> SiLU -> x_proj ->
// (dt_low, B, C) -> dt_proj + bias + softplus -> S6 step (exp_impl) -> D
// skip and SiLU(z) gate -> out_proj -> residual.  Embed, the final norm and
// the tied unembed stay in PyTorch, as repro keeps them in XLA.
//
// Bound on this card: bytes.  A decode step at a few slots reads every
// weight of every layer once (mamba-130m: 3.77 M per layer, 362 MB in f32,
// 92 MB in int8) and the pooled state in and out; the arithmetic is two
// operations per weight and slot.  At 4 slots the f32 model takes at least
// 114 us at 3.35 TB/s, the int8 model with an int8 state 29 us.  One
// jamba-v0.1 position (105.3 M mamba and 176.2 M MLP weights) reads 1.126
// GB in f32: at least 336 us, 84 us in int8.
//
// Design, simple and right first: one persistent cooperative kernel with as
// many blocks of 512 threads as can be co-resident (the C entry point sizes
// the grid from cudaOccupancyMaxActiveBlocksPerMultiprocessor and launches
// with cudaLaunchCooperativeKernel), the layer loop inside, and a grid
// barrier (cooperative_groups grid.sync()) wherever the next phase needs a
// whole vector.  Per layer:
//   A   every block with work recomputes the RMS norm of the residual
//       stream x for its slots (staged in shared memory), then computes
//       in_proj column tiles; the x half's epilogue runs the conv over the
//       tail + bias and SiLU and writes the new tail; z is stored.  barrier
//   B   x_proj column tiles -> dt_low, B, C.                       barrier
//   C   one block per (slot, 32 channels): dt_proj (the 16 lanes of a
//       channel split the dt_rank dot) + bias + softplus, the S6 step with
//       one lane per state (as decode_step.cu), D skip and gate.  An
//       f32/bf16 state is written here; an int8/fp8 state's f32 values and
//       each chunk's absmax go to scratch.                         barrier
//   C2  (int8/fp8 state) each chunk takes its 512-channel group's absmax
//       from the 16 chunks' partials, updates the scale and encodes, with
//       K2's arithmetic (common.cuh).                              barrier
//   D   out_proj column tiles and the residual add x + y.          barrier
// and, with the MLP (kMlp),
//   E   every block recomputes norm2 of x for its slots, then w1 column
//       tiles (each sum rounded and kept in a global hidden buffer) and the
//       same tiles of w3, whose epilogue forms SiLU(w1 x) * (w3 x) in place.
//       The hidden (d_ff wide: 14336 at jamba-v0.1) is not staged in shared
//       memory: 4 slots of it are 229 KB; it stays in L2.          barrier
//   F   w2 column tiles read the hidden rows from global memory, and the
//       residual add.                                              barrier
// A column tile is TJ threads across, each taking V adjacent output columns
// (V = 4 in the jamba instance: one float4 of f32 weights or a char4 of
// int8 codes per load; 1 in the mamba instance), TJ a power of two picked
// so the tiles cover the grid; the block's 16 warps split the rows of the reduction, lanes TJ
// apart take different rows, and the partial sums combine by a shuffle
// butterfly and then over the warps in one fixed order.  No float atomics anywhere: the same inputs give the same bits.
// Weights are read as stored: f32, or int8 codes times their scale with one
// rounded multiply (load_w), then rounded to the compute type -- the values
// blocks.dense and weight_quant.dequantize_rows give.  Every rounding point
// of the per-layer path is kept: the norm, each dense output, the conv and
// SiLU outputs, softplus, y and x + y round to the compute type.  Slots are
// taken kSlots at a time; more slots re-read a tile's weights, mostly from
// L1 and L2.  The phases read their per-layer weights through a table of
// device pointers (one row per layer) that the wrapper builds once per
// engine, so the weights stay where the parameter tree holds them.
// Left for later: wgmma tiles fed by TMA, fewer barriers (B and C could
// merge, and C2 go, with a thread-block cluster per scale group), weights
// kept resident in shared memory across tokens.
#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "megakernel_common.cuh"

namespace cg = cooperative_groups;

namespace marca {

constexpr int kMN = 16;                                // d_state
constexpr int kChunk = kMThreads / kMN;                // 32 channels / item
constexpr int kChunksPerGroup = kScaleGroup / kChunk;  // 16
constexpr float kSoftplusThreshold = 20.0f;            // F.softplus

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
  // the state: stacked on L (mamba), or per position in rows (jamba)
  const void* h;         // (L, b, di, 16) state storage type
  const float* h_scale;  // (L, b, g) for an int8/fp8 state
  const void* conv;      // (L, b, k-1, di) compute type
  void* h_out;
  float* h_scale_out;
  void* conv_out;
  StateRows rows;
  float* scratch;
  int L, b, dm, di, R, k, nx, g, nchunks, d_ff;
  int state_dtype, exp_impl, silu_impl;
};

// Position l's state: (b, ...) tensors in and out.
struct RowState {
  const void* h;
  const float* h_scale;
  const void* conv;
  void* h_out;
  float* h_scale_out;
  void* conv_out;
};

template <typename T, bool kPerRow>
__device__ __forceinline__ RowState row_state(const MegaArgs& a, int l) {
  if constexpr (kPerRow)
    return {a.rows.h[l], a.rows.h_scale[l], a.rows.conv[l], a.rows.h_out[l],
            a.rows.h_scale_out[l], a.rows.conv_out[l]};
  const int64_t eh = a.state_dtype == SD_F32    ? 4
                     : a.state_dtype == SD_BF16 ? 2
                                                : 1;
  const int64_t nh = (int64_t)a.b * a.di * 16 * eh;
  const int64_t ns = (int64_t)a.b * a.g;
  const int64_t nc = (int64_t)a.b * (a.k - 1) * a.di;
  const bool q = a.h_scale != nullptr;
  return {static_cast<const char*>(a.h) + l * nh,
          q ? a.h_scale + l * ns : nullptr,
          static_cast<const T*>(a.conv) + l * nc,
          static_cast<char*>(a.h_out) + l * nh,
          q ? a.h_scale_out + l * ns : nullptr,
          static_cast<T*>(a.conv_out) + l * nc};
}

// phase C: dt, the S6 step, D skip and gate for (slot, 32-channel) items
template <typename T, typename TW>
__device__ void phase_step(const MegaArgs& a, const int64_t* wt,
                           const RowState& rs, float* warp_max) {
  const TW* Wdt = column<TW>(wt, W_DT);
  const float* dt_scale = column<float>(wt, W_DT_SCALE);
  const float* dt_bias = column<float>(wt, W_DT_BIAS);
  const TW* Aw = column<TW>(wt, W_A);
  const float* a_scale = column<float>(wt, W_A_SCALE);
  const float* Dv = column<float>(wt, W_D);
  const int64_t bdi = (int64_t)a.b * a.di;
  const float* xa = a.scratch;
  const float* zb = xa + bdi;
  const float* dbc = zb + bdi;
  float* yb = a.scratch + 2 * bdi + (int64_t)a.b * a.nx;
  float* amax = yb + bdi;
  float* hb = amax + (int64_t)a.b * a.nchunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = threadIdx.x / kMN, st = threadIdx.x % kMN;
  for (int it = blockIdx.x; it < a.b * a.nchunks; it += gridDim.x) {
    const int s = it / a.nchunks, chunk = it % a.nchunks;
    const int ch = chunk * kChunk + cl;
    const bool valid = ch < a.di;
    const int c = valid ? ch : a.di - 1;  // shadow lanes join the shuffles
    const float* row = dbc + (int64_t)s * a.nx;
    // every load first (none depends on another), then the arithmetic:
    // one memory latency per item instead of one per dependent step
    const int64_t hidx = ((int64_t)s * a.di + c) * kMN + st;
    float hv;
    if (a.state_dtype == SD_F32) {
      hv = static_cast<const float*>(rs.h)[hidx];
    } else if (a.state_dtype == SD_BF16) {
      hv = to_f32(static_cast<const __nv_bfloat16*>(rs.h)[hidx]);
    } else {
      hv = a.state_dtype == SD_INT8
               ? Codes<int8_t>::decode(static_cast<const int8_t*>(rs.h)[hidx])
               : Codes<__nv_fp8_e4m3>::decode(
                     static_cast<const __nv_fp8_e4m3*>(rs.h)[hidx]);
      hv = __fmul_rn(hv, rs.h_scale[(int64_t)s * a.g + c / kScaleGroup]);
    }
    // A: int8 codes times their row scale, or -exp(A_log) for f32 weights
    const float aw = load_w(Aw, a_scale, (int64_t)c * kMN + st, c);
    const float xv = xa[(int64_t)s * a.di + c];
    const float zv = zb[(int64_t)s * a.di + c];
    const float bv = row[a.R + st], cv = row[a.R + kMN + st];
    const float bias = dt_bias[c];
    constexpr int kDtRows = 4;  // dt_rank rows per lane loaded at once
    float part = 0.0f;
    for (int r0 = st; r0 < a.R; r0 += kDtRows * kMN) {
      float wv[kDtRows], lo[kDtRows];
#pragma unroll
      for (int u = 0; u < kDtRows; ++u) {
        const int r = min(r0 + u * kMN, a.R - 1);
        wv[u] = load_w(Wdt, dt_scale, (int64_t)r * a.di + c, c);
        lo[u] = row[r];
      }
#pragma unroll
      for (int u = 0; u < kDtRows; ++u)
        if (r0 + u * kMN < a.R) part += lo[u] * round_to<T>(wv[u]);
    }
    const float dt_raw = round_to<T>(group_sum<kMN>(part));
    const float pre = dt_raw + bias;
    const float dtv =
        round_to<T>(pre > kSoftplusThreshold ? pre : log1pf(expf(pre)));
    const float av = sizeof(TW) == 1 ? aw : -expf(aw);
    const float h1 = s6_state_update(hv, dtv, xv, av, bv, a.exp_impl);
    float yv = s6_contract<kMN>(h1, cv);
    yv = s6_gate(yv, xv, Dv, c, true, zv, a.silu_impl);
    if (valid && st == 0) yb[(int64_t)s * a.di + ch] = round_to<T>(yv);
    if (a.state_dtype == SD_F32) {
      if (valid) static_cast<float*>(rs.h_out)[hidx] = h1;
    } else if (a.state_dtype == SD_BF16) {
      if (valid)
        static_cast<__nv_bfloat16*>(rs.h_out)[hidx] = from_f32<__nv_bfloat16>(h1);
    } else {
      if (valid) hb[((int64_t)s * a.di + ch) * kMN + st] = h1;
      float m = valid ? fabsf(h1) : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) warp_max[warp] = m;
      __syncthreads();
      if (threadIdx.x == 0) {
        float mm = warp_max[0];
        for (int w = 1; w < kMWarps; ++w) mm = fmaxf(mm, warp_max[w]);
        amax[(int64_t)s * a.nchunks + chunk] = mm;
      }
      __syncthreads();
    }
  }
}

// phase C2: the group scale from the chunks' absmax, then the encode
template <typename TQ>
__device__ void phase_requant(const MegaArgs& a, const RowState& rs) {
  const int64_t bdi = (int64_t)a.b * a.di;
  const float* amax = a.scratch + 3 * bdi + (int64_t)a.b * a.nx;
  const float* hb = amax + (int64_t)a.b * a.nchunks;
  TQ* h_out = static_cast<TQ*>(rs.h_out);
  const int cl = threadIdx.x / kMN, st = threadIdx.x % kMN;
  for (int it = blockIdx.x; it < a.b * a.nchunks; it += gridDim.x) {
    const int s = it / a.nchunks, chunk = it % a.nchunks;
    const int grp = chunk / kChunksPerGroup;
    const int first = grp * kChunksPerGroup;
    const int last = min(first + kChunksPerGroup, a.nchunks);
    float m = 0.0f;
    for (int q = first; q < last; ++q)
      m = fmaxf(m, amax[(int64_t)s * a.nchunks + q]);
    const int64_t sg = (int64_t)s * a.g + grp;
    const float so = update_scale(m, rs.h_scale[sg], Codes<TQ>::kMax);
    if (chunk == first && threadIdx.x == 0) rs.h_scale_out[sg] = so;
    const int ch = chunk * kChunk + cl;
    if (ch < a.di)
      h_out[((int64_t)s * a.di + ch) * kMN + st] = Codes<TQ>::encode(
          __fdiv_rn(hb[((int64_t)s * a.di + ch) * kMN + st], so));
  }
}

template <typename T, typename TW, bool kMlp>
__global__ void __launch_bounds__(kMThreads)
mamba_megakernel(const MegaArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int kmax = max(a.dm, a.di);
  float* xs = smem;                           // kSlots * kmax
  constexpr int kV = kMlp ? kVec : 1;         // columns a thread, at most
  float* red = xs + kSlots * kmax;            // kMWarps * kSlots * 32 * kV
  float* redn = red + kMWarps * kSlots * 32 * kV;  // kMWarps * kSlots
  const int64_t bdi = (int64_t)a.b * a.di;
  float* xa = a.scratch;
  float* zb = xa + bdi;
  float* dbc = zb + bdi;
  float* yb = dbc + (int64_t)a.b * a.nx;
  // the MLP hidden (b, d_ff), after the f32 state values
  float* hid = yb + bdi + (int64_t)a.b * a.nchunks + bdi * kMN;
  const T* x0 = static_cast<const T*>(a.x0);
  T* x = static_cast<T*>(a.x);
  const int k1 = a.k - 1;

  for (int l = 0; l < a.L; ++l) {
    const int64_t* wt = a.table + (int64_t)l * W_COLUMNS;
    const T* xsrc = l == 0 ? x0 : x;
    const RowState rs = row_state<T, kMlp>(a, l);
    const T* conv = static_cast<const T*>(rs.conv);
    T* conv_out = static_cast<T*>(rs.conv_out);

    // A: norm -> in_proj -> conv + SiLU | z
    if (blockIdx.x < gemv_ntiles<kV>(2 * a.di)) {
      const float* conv_w = column<float>(wt, W_CONV);
      const float* conv_b = column<float>(wt, W_CONV_B);
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_norm<T>(xs, redn, xsrc, column<float>(wt, W_NORM), s0, nb,
                      a.dm);
        gemv_tiles<T, TW, kV>(
            xs, nb, a.dm, column<TW>(wt, W_IN), column<float>(wt, W_IN_SCALE),
            2 * a.di, red, [&](int si, int j, float sum) {
              const int s = s0 + si;
              const float v = round_to<T>(sum);
              if (j >= a.di) {
                zb[(int64_t)s * a.di + j - a.di] = v;
                return;
              }
              // the conv over the tail (causal_conv1d at L = 1) + bias
              const int64_t tail = (int64_t)s * k1 * a.di + j;
              float acc = 0.0f;
              for (int t = 0; t < k1; ++t)
                acc += to_f32(conv[tail + (int64_t)t * a.di]) *
                       conv_w[(int64_t)t * a.di + j];
              acc += v * conv_w[(int64_t)k1 * a.di + j];
              acc += conv_b[j];
              const float xc = round_to<T>(acc);
              xa[(int64_t)s * a.di + j] = round_to<T>(apply_silu(xc,
                                                                 a.silu_impl));
              for (int t = 0; t + 1 < k1; ++t)
                conv_out[tail + (int64_t)t * a.di] =
                    conv[tail + (int64_t)(t + 1) * a.di];
              if (k1 > 0) conv_out[tail + (int64_t)(k1 - 1) * a.di] =
                  from_f32<T>(v);
            });
      }
    }
    grid.sync();

    // B: x_proj -> (dt_low, B, C)
    if (blockIdx.x < gemv_ntiles<kV>(a.nx)) {
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_rows(xs, xa, s0, nb, a.di);
        gemv_tiles<T, TW, kV>(xs, nb, a.di, column<TW>(wt, W_X),
                          column<float>(wt, W_X_SCALE), a.nx, red,
                          [&](int si, int j, float sum) {
                            dbc[(int64_t)(s0 + si) * a.nx + j] =
                                round_to<T>(sum);
                          });
      }
    }
    grid.sync();

    // C (+ C2): dt, the S6 step, gate; the state written or requantized
    phase_step<T, TW>(a, wt, rs, redn);
    grid.sync();
    if (quantized(a.state_dtype)) {
      if (a.state_dtype == SD_INT8)
        phase_requant<int8_t>(a, rs);
      else
        phase_requant<__nv_fp8_e4m3>(a, rs);
      grid.sync();
    }

    // D: out_proj, residual
    if (blockIdx.x < gemv_ntiles<kV>(a.dm)) {
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_rows(xs, yb, s0, nb, a.di);
        gemv_tiles<T, TW, kV>(
            xs, nb, a.di, column<TW>(wt, W_OUT),
            column<float>(wt, W_OUT_SCALE), a.dm, red,
            [&](int si, int j, float sum) {
              const int64_t i = (int64_t)(s0 + si) * a.dm + j;
              x[i] = from_f32<T>(to_f32(xsrc[i]) + round_to<T>(sum));
            });
      }
    }
    if (kMlp) {
      grid.sync();
      // E: norm2 -> w1 and w3 -> SiLU(w1 x) * (w3 x), the rounding points
      // of blocks.mlp_apply: each dense output, SiLU and the product
      if (blockIdx.x < gemv_ntiles<kV>(a.d_ff)) {
        for (int s0 = 0; s0 < a.b; s0 += kSlots) {
          const int nb = min(kSlots, a.b - s0);
          stage_norm<T>(xs, redn, x, column<float>(wt, W_NORM2), s0, nb,
                        a.dm);
          gemv_tiles<T, TW, kV>(xs, nb, a.dm, column<TW>(wt, W_W1),
                            column<float>(wt, W_W1_SCALE), a.d_ff, red,
                            [&](int si, int j, float sum) {
                              hid[(int64_t)(s0 + si) * a.d_ff + j] =
                                  round_to<T>(sum);
                            });
          // the same tiles and epilogue threads as w1's: each thread reads
          // back only what it wrote
          gemv_tiles<T, TW, kV>(
              xs, nb, a.dm, column<TW>(wt, W_W3),
              column<float>(wt, W_W3_SCALE), a.d_ff, red,
              [&](int si, int j, float sum) {
                float* hp = hid + (int64_t)(s0 + si) * a.d_ff + j;
                const float act = round_to<T>(apply_silu(*hp, a.silu_impl));
                *hp = round_to<T>(act * round_to<T>(sum));
              });
        }
      }
      grid.sync();
      // F: w2 over the hidden rows (read from global memory), residual
      if (blockIdx.x < gemv_ntiles<kV>(a.dm)) {
        for (int s0 = 0; s0 < a.b; s0 += kSlots) {
          const int nb = min(kSlots, a.b - s0);
          gemv_tiles<T, TW, kV>(
              hid + (int64_t)s0 * a.d_ff, nb, a.d_ff, column<TW>(wt, W_W2),
              column<float>(wt, W_W2_SCALE), a.dm, red,
              [&](int si, int j, float sum) {
                const int64_t i = (int64_t)(s0 + si) * a.dm + j;
                x[i] = from_f32<T>(to_f32(x[i]) + round_to<T>(sum));
              });
        }
      }
    }
    if (l + 1 < a.L) grid.sync();
  }
}

// Shared memory of one block: the staged rows, the tile reduction and the
// norm / absmax partials.
size_t smem_bytes(int dm, int di, int mlp) {
  const int kmax = dm > di ? dm : di;
  return sizeof(float) * ((size_t)kSlots * kmax +
                          kMWarps * kSlots * 32 * (mlp ? kVec : 1) +
                          kMWarps * kSlots);
}

// scratch floats: x_a, z, (dt_low|B|C), y, chunk absmax, f32 state values
// and the MLP hidden (d_ff 0 without one)
int64_t scratch_floats(int b, int di, int nx, int nchunks, int d_ff) {
  return (int64_t)b *
         (3 * (int64_t)di + nx + nchunks + (int64_t)di * kMN + d_ff);
}

using KernelFn = void (*)(const MegaArgs);

template <bool kMlp>
KernelFn pick_mlp(int dtype, int weight_dtype) {
  using bf = __nv_bfloat16;
  if (dtype == DT_F32 && weight_dtype == 0)
    return mamba_megakernel<float, float, kMlp>;
  if (dtype == DT_F32 && weight_dtype == 1)
    return mamba_megakernel<float, int8_t, kMlp>;
  if (dtype == DT_BF16 && weight_dtype == 0)
    return mamba_megakernel<bf, float, kMlp>;
  if (dtype == DT_BF16 && weight_dtype == 1)
    return mamba_megakernel<bf, int8_t, kMlp>;
  return nullptr;
}

KernelFn pick(int dtype, int weight_dtype, int mlp) {
  return mlp ? pick_mlp<true>(dtype, weight_dtype)
             : pick_mlp<false>(dtype, weight_dtype);
}

int configure(KernelFn fn, int dm, int di, int mlp, int* per_sm, int* grid,
              size_t* smem);

// Checks the launch, sizes the grid and launches; 0 or a CUDA error.
int launch(KernelFn fn, MegaArgs& a, int64_t scratch_len, void* stream) {
  const bool quant = a.state_dtype == SD_INT8 || a.state_dtype == SD_FP8;
  if (fn == nullptr || a.L < 1 || a.b < 1 || a.dm < 1 || a.di < 1 ||
      a.R < 1 || a.k < 1 || a.d_ff < 0 || a.state_dtype < SD_INT8 ||
      a.state_dtype > SD_BF16 ||
      scratch_len < scratch_floats(a.b, a.di, a.nx, a.nchunks, a.d_ff))
    return cudaErrorInvalidValue;
  const bool per_row = a.d_ff > 0;  // the jamba instance
  for (int l = 0; per_row && l < a.L; ++l)
    if (a.rows.h[l] == nullptr || a.rows.conv[l] == nullptr ||
        a.rows.h_out[l] == nullptr || a.rows.conv_out[l] == nullptr ||
        (quant && (a.rows.h_scale[l] == nullptr ||
                   a.rows.h_scale_out[l] == nullptr)))
      return cudaErrorInvalidValue;
  if (!per_row && quant && (a.h_scale == nullptr || a.h_scale_out == nullptr))
    return cudaErrorInvalidValue;
  int per_sm = 0, grid = 0;
  size_t smem = 0;
  const int rc = configure(fn, a.dm, a.di, a.d_ff > 0, &per_sm, &grid,
                           &smem);
  if (rc != 0) return rc;
  void* params[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fn, dim3(grid), dim3(kMThreads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// blocks per SM, grid and shared memory of a launch; 0 or an error code
int configure(KernelFn fn, int dm, int di, int mlp, int* per_sm, int* grid,
              size_t* smem) {
  *smem = smem_bytes(dm, di, mlp);
  return coop_grid((const void*)fn, *smem, per_sm, grid);
}

int coop_grid(const void* fn, size_t smem, int* per_sm, int* grid,
              int threads) {
  struct Entry { const void* fn; int dev; size_t smem; int per_sm, grid; };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev, sms, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  size_t opened = 0;
  for (const Entry& x : seen) {
    if (x.fn != fn || x.dev != dev) continue;
    if (x.smem == smem) {
      *per_sm = x.per_sm;
      *grid = x.grid;
      return 0;
    }
    opened = x.smem > opened ? x.smem : opened;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && smem > opened)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop || *per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = *per_sm * sms;
  seen.push_back({fn, dev, smem, *per_sm, *grid});
  return 0;
}

}  // namespace marca

// The launch configuration K3 would use on the current device: out[0]
// blocks per SM, out[1] the grid, out[2] dynamic shared memory bytes.
// weight_dtype 0 is f32, 1 int8; mlp 1 is the jamba instance.
extern "C" int marca_mamba_stacked_grid(int d_model, int d_inner, int dtype,
                                        int weight_dtype, int mlp, int* out) {
  using namespace marca;
  const KernelFn fn = pick(dtype, weight_dtype, mlp);
  if (fn == nullptr || d_model < 1 || d_inner < 1) return cudaErrorInvalidValue;
  int per_sm = 0, grid = 0;
  size_t smem = 0;
  const int rc = configure(fn, d_model, d_inner, mlp, &per_sm, &grid,
                           &smem);
  if (rc != 0) return rc;
  out[0] = per_sm;
  out[1] = grid;
  out[2] = (int)smem;
  return 0;
}

// One decode step of the whole Mamba stack.  table: (L, 24) int64 device
// pointers per layer (megakernel.py TABLE_COLUMNS); x0, x_out (slots,
// d_model) in the compute type; h, h_out (L, slots, d_inner, 16) in the
// state type; h_scale, h_scale_out (L, slots, g) f32 for an int8/fp8 state
// (else null); conv, conv_out (L, slots, d_conv-1, d_inner) in the compute
// type; scratch at least scratch_floats() f32.  Returns 0 or a CUDA error;
// a grid that cannot be co-resident is cudaErrorCooperativeLaunchTooLarge.
extern "C" int marca_mamba_stacked_step(
    const void* table, const void* x0, void* x_out, const void* h,
    const void* h_scale, const void* conv, void* h_out, void* h_scale_out,
    void* conv_out, void* scratch, int64_t scratch_len, int L, int slots,
    int d_model, int d_inner, int d_state, int dt_rank, int d_conv,
    int dtype, int weight_dtype, int state_dtype, int exp_impl,
    int silu_impl, void* stream) {
  using namespace marca;
  if (d_state != kMN) return cudaErrorInvalidValue;
  MegaArgs a{};
  a.table = (const int64_t*)table;
  a.x0 = x0;
  a.x = x_out;
  a.h = h;
  a.h_scale = (const float*)h_scale;
  a.conv = conv;
  a.h_out = h_out;
  a.h_scale_out = (float*)h_scale_out;
  a.conv_out = conv_out;
  a.scratch = (float*)scratch;
  a.L = L;
  a.b = slots;
  a.dm = d_model;
  a.di = d_inner;
  a.R = dt_rank;
  a.k = d_conv;
  a.nx = dt_rank + 2 * kMN;
  a.g = (d_inner + kScaleGroup - 1) / kScaleGroup;
  a.nchunks = (d_inner + kChunk - 1) / kChunk;
  a.d_ff = 0;
  a.state_dtype = state_dtype;
  a.exp_impl = exp_impl;
  a.silu_impl = silu_impl;
  return launch(pick(dtype, weight_dtype, 0), a, scratch_len, stream);
}

// One decode token through a run of jamba positions (K3's jamba instance).
// table: (nrows, 24) int64 device pointers per position (megakernel.py
// TABLE_COLUMNS + MLP_COLUMNS); x0, x_out (slots, d_model) in the compute
// type; rows: a host array of 6 x 8 int64 device pointers, the h, h_scale,
// conv, h_out, h_scale_out and conv_out of each position (h (slots,
// d_inner, 16) in the state type, h_scale (slots, g) f32 for an int8/fp8
// state, else 0, conv (slots, d_conv-1, d_inner) in the compute type);
// scratch at least scratch_floats() f32.  Returns 0 or a CUDA error.
extern "C" int marca_jamba_stacked_run(
    const void* table, const void* x0, void* x_out, const int64_t* rows,
    void* scratch, int64_t scratch_len, int nrows, int slots, int d_model,
    int d_inner, int d_state, int dt_rank, int d_conv, int d_ff, int dtype,
    int weight_dtype, int state_dtype, int exp_impl, int silu_impl,
    void* stream) {
  using namespace marca;
  if (d_state != kMN || nrows < 1 || nrows > kMaxRows || d_ff < 1 ||
      rows == nullptr)
    return cudaErrorInvalidValue;
  MegaArgs a{};
  a.table = (const int64_t*)table;
  a.x0 = x0;
  a.x = x_out;
  for (int l = 0; l < nrows; ++l) {
    a.rows.h[l] = (const void*)rows[0 * kMaxRows + l];
    a.rows.h_scale[l] = (const float*)rows[1 * kMaxRows + l];
    a.rows.conv[l] = (const void*)rows[2 * kMaxRows + l];
    a.rows.h_out[l] = (void*)rows[3 * kMaxRows + l];
    a.rows.h_scale_out[l] = (float*)rows[4 * kMaxRows + l];
    a.rows.conv_out[l] = (void*)rows[5 * kMaxRows + l];
  }
  a.scratch = (float*)scratch;
  a.L = nrows;
  a.b = slots;
  a.dm = d_model;
  a.di = d_inner;
  a.R = dt_rank;
  a.k = d_conv;
  a.nx = dt_rank + 2 * kMN;
  a.g = (d_inner + kScaleGroup - 1) / kScaleGroup;
  a.nchunks = (d_inner + kChunk - 1) / kChunk;
  a.d_ff = d_ff;
  a.state_dtype = state_dtype;
  a.exp_impl = exp_impl;
  a.silu_impl = silu_impl;
  return launch(pick(dtype, weight_dtype, 1), a, scratch_len, stream);
}
