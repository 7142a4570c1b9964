// Host entry points of K3's mamba and jamba instances, the mamba instance's
// kernel, and the cooperative grid sizing every K3 kernel uses (coop_grid).
//
// Replaces: repro/kernels/decode_step.py:413 stacked_layer_launch
// (pallas_call at :488) with the body of repro/models/mamba_lm.py:160
// ("marca_megakernel_mamba"): ONE launch runs every layer of a decode step
// for the whole slot pool,
//
//   for l in layers:  x = x + mamba_block_megastep(rmsnorm(x))
//
// with the chain of repro_torch/models/mamba.py mamba_block_megastep: norm
// -> in_proj -> [x | z] -> conv over the tail + bias -> SiLU -> x_proj ->
// (dt_low, B, C) -> dt_proj + bias + softplus -> S6 step (exp_impl) -> D
// skip and SiLU(z) gate -> out_proj -> residual.  The jamba instance
// (repro/models/jamba.py:305) is megakernel_mamba.cuh's kernel.
//
// Bound on this card: bytes.  A decode step at a few slots reads every
// weight of every layer once (mamba-130m: 3.77 M per layer, 362 MB in f32,
// 92 MB in int8) and the pooled state in and out; at 4 slots the f32
// model takes at least 114 us at 3.35 TB/s, the int8 model with an int8
// state 29 us.  What binds it is latency: 4-5 dependent phases a layer,
// each a few trips to memory, and a grid barrier after each.
//
// Design (the first one, kept: megakernel_mamba.cuh's split-K design measured
// slower at mamba-130m's widths, where every weight is small and each
// phase's time is its chain of dependent steps; PERF.md): one
// persistent cooperative kernel with as many blocks of 512 threads as can
// be co-resident, the layer loop inside, and a grid barrier wherever the
// next phase needs a whole vector.  Per layer:
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
// A column tile is TJ threads across, each taking one output column, TJ
// a power of two picked so the tiles cover the grid; the block's 16 warps
// split the rows of the reduction, lanes TJ apart take different rows,
// and the partial sums combine by a shuffle butterfly and then over the
// warps in one fixed order.  No float atomics anywhere: the same inputs
// give the same bits.  Weights are read as stored: f32, or int8 codes
// times their scale with one rounded multiply, then rounded to the
// compute type; every rounding point of the per-layer path is kept.  The
// phases read their per-layer weights through a table of device pointers
// (one row per layer) that the wrapper builds once per engine.
#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "megakernel_mamba.cuh"

namespace cg = cooperative_groups;

namespace marca {

constexpr int kChunk = kMThreads / kMN;                // 32 channels / item
constexpr int kChunksPerGroup = kScaleGroup / kChunk;  // 16

struct MegaArgs {
  const int64_t* table;  // (L, W_COLUMNS) device pointers
  const void* x0;        // (b, dm) compute type: the embedded tokens
  void* x;               // (b, dm) compute type: the residual stream out
  const void* h;         // (L, b, di, 16) state storage type
  const float* h_scale;  // (L, b, g) for an int8/fp8 state
  const void* conv;      // (L, b, k-1, di) compute type
  void* h_out;
  float* h_scale_out;
  void* conv_out;
  float* scratch;
  int L, b, dm, di, R, k, nx, g, nchunks;
  int state_dtype, exp_impl, silu_impl;
};

// Layer l's state: (b, ...) tensors in and out.
struct RowState {
  const void* h;
  const float* h_scale;
  const void* conv;
  void* h_out;
  float* h_scale_out;
  void* conv_out;
};

template <typename T>
__device__ __forceinline__ RowState row_state(const MegaArgs& a, int l) {
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

// a is __grid_constant__: the phases take it by reference without a copy
// in local memory (without it this kernel spilled 64-76 B and ran 2-4%
// slower on an H100 80GB HBM3 at 700 W, scripts/torch_k3_jamba.py)
template <typename T, typename TW>
__global__ void __launch_bounds__(kMThreads)
mamba_megakernel(const __grid_constant__ MegaArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int kmax = max(a.dm, a.di);
  float* xs = smem;                      // kSlots * kmax
  float* red = xs + kSlots * kmax;       // kMWarps * kSlots * 32
  float* redn = red + kMWarps * kSlots * 32;  // kMWarps * kSlots
  const int64_t bdi = (int64_t)a.b * a.di;
  float* xa = a.scratch;
  float* zb = xa + bdi;
  float* dbc = zb + bdi;
  float* yb = dbc + (int64_t)a.b * a.nx;
  const T* x0 = static_cast<const T*>(a.x0);
  T* x = static_cast<T*>(a.x);
  const int k1 = a.k - 1;

  for (int l = 0; l < a.L; ++l) {
    const int64_t* wt = a.table + (int64_t)l * W_COLUMNS;
    const T* xsrc = l == 0 ? x0 : x;
    const RowState rs = row_state<T>(a, l);
    const T* conv = static_cast<const T*>(rs.conv);
    T* conv_out = static_cast<T*>(rs.conv_out);

    // A: norm -> in_proj -> conv + SiLU | z
    if (blockIdx.x < gemv_ntiles<1>(2 * a.di)) {
      const float* conv_w = column<float>(wt, W_CONV);
      const float* conv_b = column<float>(wt, W_CONV_B);
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_norm<T>(xs, redn, xsrc, column<float>(wt, W_NORM), s0, nb,
                      a.dm);
        gemv_cols<T, TW, 1>(
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
    if (blockIdx.x < gemv_ntiles<1>(a.nx)) {
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_rows(xs, xa, s0, nb, a.di);
        gemv_cols<T, TW, 1>(xs, nb, a.di, column<TW>(wt, W_X),
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
    if (blockIdx.x < gemv_ntiles<1>(a.dm)) {
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_rows(xs, yb, s0, nb, a.di);
        gemv_cols<T, TW, 1>(
            xs, nb, a.di, column<TW>(wt, W_OUT),
            column<float>(wt, W_OUT_SCALE), a.dm, red,
            [&](int si, int j, float sum) {
              const int64_t i = (int64_t)(s0 + si) * a.dm + j;
              x[i] = from_f32<T>(to_f32(xsrc[i]) + round_to<T>(sum));
            });
      }
    }
    if (l + 1 < a.L) grid.sync();
  }
}

// Shared memory of one block: the staged rows, the tile reduction and the
// norm / absmax partials.
size_t smem_bytes(int dm, int di) {
  const int kmax = dm > di ? dm : di;
  return sizeof(float) *
         ((size_t)kSlots * kmax + kMWarps * kSlots * 32 + kMWarps * kSlots);
}

// scratch floats: x_a, z, (dt_low|B|C), y, chunk absmax and f32 state values
int64_t scratch_floats(int b, int di, int nx, int nchunks) {
  return (int64_t)b * (3 * (int64_t)di + nx + nchunks + (int64_t)di * kMN);
}

using KernelFn = void (*)(const MegaArgs);

KernelFn pick(int dtype, int weight_dtype) {
  using bf = __nv_bfloat16;
  if (dtype == DT_F32 && weight_dtype == 0)
    return mamba_megakernel<float, float>;
  if (dtype == DT_F32 && weight_dtype == 1)
    return mamba_megakernel<float, int8_t>;
  if (dtype == DT_BF16 && weight_dtype == 0)
    return mamba_megakernel<bf, float>;
  if (dtype == DT_BF16 && weight_dtype == 1)
    return mamba_megakernel<bf, int8_t>;
  return nullptr;
}

// blocks per SM, grid and shared memory of a launch; 0 or an error code
int configure(KernelFn fn, int dm, int di, int* per_sm, int* grid,
              size_t* smem) {
  *smem = smem_bytes(dm, di);
  return coop_grid((const void*)fn, *smem, per_sm, grid);
}

// Checks the launch, sizes the grid and launches; 0 or a CUDA error.
int launch(KernelFn fn, MegaArgs& a, int64_t scratch_len, void* stream) {
  const bool quant = a.state_dtype == SD_INT8 || a.state_dtype == SD_FP8;
  if (fn == nullptr || a.L < 1 || a.b < 1 || a.dm < 1 || a.di < 1 ||
      a.R < 1 || a.k < 1 || a.state_dtype < SD_INT8 ||
      a.state_dtype > SD_BF16 ||
      scratch_len < scratch_floats(a.b, a.di, a.nx, a.nchunks) ||
      (quant && (a.h_scale == nullptr || a.h_scale_out == nullptr)))
    return cudaErrorInvalidValue;
  int per_sm = 0, grid = 0;
  size_t smem = 0;
  const int rc = configure(fn, a.dm, a.di, &per_sm, &grid, &smem);
  if (rc != 0) return rc;
  void* params[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fn, dim3(grid), dim3(kMThreads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

namespace marca {
namespace mb {

// Shared memory of one block: the per-block values, then the larger of a
// GEMV's staged rows and warp sums and the S6 item's operands, whose chunk
// is sized for the smallest grid the card gives (one block an SM).
size_t smem_bytes(int di, int R, int nx, int wbytes, int sms) {
  const size_t step = step_smem(R, nx, chunk_of(di, sms), wbytes);
  return 4 * (size_t)kSmall + (step > kGemvSmem ? step : kGemvSmem);
}

KernelFn pick(int dtype, int weight_dtype) {
  if (dtype == DT_F32 && weight_dtype == 0) return kernels_0_0();
  if (dtype == DT_F32 && weight_dtype == 1) return kernels_0_1();
  if (dtype == DT_BF16 && weight_dtype == 0) return kernels_1_0();
  if (dtype == DT_BF16 && weight_dtype == 1) return kernels_1_1();
  return nullptr;
}

// blocks per SM, grid and shared memory of a launch; 0 or an error code
int configure(KernelFn fn, int di, int R, int nx, int wbytes, int* per_sm,
              int* grid, size_t* smem) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *smem = smem_bytes(di, R, nx, wbytes, sms);
  const int rc = coop_grid((const void*)fn, *smem, per_sm, grid, kThreads);
  if (rc != 0) return rc;
  // a scale group's chunks wait for each other, so one item a block at
  // most, and the item's threads split its chunk evenly
  if (kThreads % chunk_of(di, *grid) != 0) return cudaErrorInvalidValue;
  return 0;
}

// Checks a jamba launch, sizes the grid and launches; 0 or a CUDA error.
int launch(KernelFn fn, int weight_dtype, MegaArgs& a, int64_t scratch_len,
           void* stream) {
  const bool quant = a.state_dtype == SD_INT8 || a.state_dtype == SD_FP8;
  if (fn == nullptr || a.L < 1 || a.b < 1 || a.dm < 1 || a.di < 1 ||
      a.R < 1 || a.k < 1 || a.d_ff < 0 || a.state_dtype < SD_INT8 ||
      a.state_dtype > SD_BF16 || a.dm > kMaxModel || a.k > kMaxConv)
    return cudaErrorInvalidValue;
  for (int l = 0; l < a.L; ++l)
    if (a.rows.h[l] == nullptr || a.rows.conv[l] == nullptr ||
        a.rows.h_out[l] == nullptr || a.rows.conv_out[l] == nullptr ||
        (quant && (a.rows.h_scale[l] == nullptr ||
                   a.rows.h_scale_out[l] == nullptr)))
      return cudaErrorInvalidValue;
  int per_sm = 0, grid = 0;
  size_t smem = 0;
  const int rc = configure(fn, a.di, a.R, a.nx, weight_dtype ? 1 : 4,
                           &per_sm, &grid, &smem);
  if (rc != 0) return rc;
  if (scratch_len < scratch_floats(a.b, a.dm, a.di, a.nx, a.d_ff, a.g, grid))
    return cudaErrorInvalidValue;
  void* params[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fn, dim3(grid), dim3(kThreads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace mb
}  // namespace marca

// The launch configuration K3 would use on the current device: out[0]
// blocks per SM, out[1] the grid, out[2] dynamic shared memory bytes,
// out[3] threads per block.  weight_dtype 0 is f32, 1 int8; mlp 1 is the
// jamba instance.
extern "C" int marca_mamba_stacked_grid(int d_model, int d_inner,
                                        int dt_rank, int dtype,
                                        int weight_dtype, int mlp, int* out) {
  int per_sm = 0, grid = 0, threads = marca::kMThreads;
  size_t smem = 0;
  if (d_model < 1 || d_inner < 1 || dt_rank < 1) return cudaErrorInvalidValue;
  int rc;
  if (mlp) {
    const marca::mb::KernelFn fn = marca::mb::pick(dtype, weight_dtype);
    if (fn == nullptr) return cudaErrorInvalidValue;
    rc = marca::mb::configure(fn, d_inner, dt_rank,
                              dt_rank + 2 * marca::kMN,
                              weight_dtype ? 1 : 4, &per_sm, &grid, &smem);
    threads = marca::mb::kThreads;
  } else {
    const marca::KernelFn fn = marca::pick(dtype, weight_dtype);
    if (fn == nullptr) return cudaErrorInvalidValue;
    rc = marca::configure(fn, d_model, d_inner, &per_sm, &grid, &smem);
  }
  if (rc != 0) return rc;
  out[0] = per_sm;
  out[1] = grid;
  out[2] = (int)smem;
  out[3] = threads;
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
  a.state_dtype = state_dtype;
  a.exp_impl = exp_impl;
  a.silu_impl = silu_impl;
  return launch(pick(dtype, weight_dtype), a, scratch_len, stream);
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
  namespace mb = marca::mb;
  if (d_state != marca::kMN || nrows < 1 || nrows > mb::kMaxRows || d_ff < 1 ||
      rows == nullptr)
    return cudaErrorInvalidValue;
  mb::MegaArgs a{};
  a.table = (const int64_t*)table;
  a.x0 = x0;
  a.x = x_out;
  for (int l = 0; l < nrows; ++l) {
    a.rows.h[l] = (const void*)rows[0 * mb::kMaxRows + l];
    a.rows.h_scale[l] = (const float*)rows[1 * mb::kMaxRows + l];
    a.rows.conv[l] = (const void*)rows[2 * mb::kMaxRows + l];
    a.rows.h_out[l] = (void*)rows[3 * mb::kMaxRows + l];
    a.rows.h_scale_out[l] = (float*)rows[4 * mb::kMaxRows + l];
    a.rows.conv_out[l] = (void*)rows[5 * mb::kMaxRows + l];
  }
  a.scratch = (float*)scratch;
  a.L = nrows;
  a.b = slots;
  a.dm = d_model;
  a.di = d_inner;
  a.R = dt_rank;
  a.k = d_conv;
  a.nx = dt_rank + 2 * marca::kMN;
  a.g = (d_inner + marca::kScaleGroup - 1) / marca::kScaleGroup;
  a.d_ff = d_ff;
  a.state_dtype = state_dtype;
  a.exp_impl = exp_impl;
  a.silu_impl = silu_impl;
  return mb::launch(mb::pick(dtype, weight_dtype), weight_dtype, a,
                    scratch_len, stream);
}
