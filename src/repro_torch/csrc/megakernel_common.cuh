// Shared device code of the cross-layer decode megakernels (K3): the
// block-wide stages and the column-tile GEMV that csrc/megakernel_xlstm.cuh
// (mLSTM and sLSTM instances) builds its layer phases from, the sizes and
// helpers csrc/megakernel_mamba.cu (the mamba instance, whose GEMVs read a
// weight stream of their own) shares, and the cooperative launch's grid
// sizing.  Every kernel that includes it runs blocks of kMThreads
// threads and stages kSlots slots of a vector in shared memory at a time.
#pragma once

#include "common.cuh"

namespace marca {

constexpr int kMThreads = 512;
constexpr int kMWarps = kMThreads / 32;
constexpr int kSlots = 4;                              // slots per pass
constexpr float kNormEps = 1e-5f;                      // blocks.apply_norm

template <typename P>
__device__ __forceinline__ const P* column(const int64_t* row, int c) {
  return reinterpret_cast<const P*>(row[c]);
}

// rows s0 .. s0+nb-1 of a (b, K) scratch vector into shared memory
static __device__ void stage_rows(float* xs, const float* src, int s0,
                                  int nb, int K) {
  for (int i = threadIdx.x; i < nb * K; i += kMThreads)
    xs[i] = src[(int64_t)s0 * K + i];
  __syncthreads();
}

// the widest tile (<= 32 threads across) that still gives every block one
__host__ __device__ __forceinline__ int pick_tj(int n, int grid) {
  int tj = 32;
  while (tj > 1 && (n + tj - 1) / tj < grid) tj >>= 1;
  return tj;
}

// kVec adjacent weight columns one thread of the xLSTM instances loads at
// once: a float4 of f32 weights or a char4 of int8 codes, which put 2-4
// times the bytes in flight.
constexpr int kVec = 4;

template <typename TW, int V> struct WVec;
template <> struct WVec<float, 4> { using type = float4; };
template <> struct WVec<int8_t, 4> { using type = char4; };

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(const char4& v, int c) {
  return (float)(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w);
}

// a weight as the dense layer consumes it: f32 as stored, or the int8 code
// times its column's scale with one rounded multiply (load_w's arithmetic)
template <typename TW>
__device__ __forceinline__ float weight_value(float raw, const float* scale,
                                              int col) {
  return sizeof(TW) == 1 ? __fmul_rn(raw, scale[col]) : raw;
}

// columns per thread for an N-column weight, at most kV
template <int kV>
__device__ __forceinline__ int gemv_vec(int N) {
  return kV > 1 && N % kV == 0 ? kV : 1;
}

// the column tiles of an N-column weight (the blocks with an index below
// it take part in the phase)
template <int kV>
__device__ __forceinline__ int gemv_ntiles(int N) {
  const int v = gemv_vec<kV>(N);
  const int tj = pick_tj(N / v, gridDim.x);
  return (N / v + tj - 1) / tj;
}

// out[si][j] = sum_i xs[si][i] * w(i, j) for the column tiles this block
// takes; epi(si, j, sum) gets each unrounded f32 sum once.  W is (K, N),
// row-major, as blocks.dense stores it; xs may be shared or global memory.
// A tile is tj threads across, each taking V adjacent columns (gemv_vec:
// V = kVec in the xLSTM instances, one 16-byte load of f32 weights or 4
// bytes of int8 codes); the block's other threads split the rows.  Each thread loads kB rows of its
// columns before it uses any, so that many bytes are in flight at once
// (the phase is bound by memory latency, not by the bytes); the sum still
// runs over the rows in ascending order.  The same N gives the same tiles
// and the same epilogue thread for a column, call after call.
template <typename T, typename TW, int V, typename Epi>
__device__ void gemv_cols(const float* xs, int nb, int K, const TW* W,
                          const float* wscale, int N, float* red, Epi epi) {
  using VT = typename WVec<TW, V>::type;
  constexpr int kB = (V > 1 && sizeof(TW) == 4) ? 4 : 8;
  const int tj = pick_tj(N / V, gridDim.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jj = lane & (tj - 1);
  const int p = warp * (32 / tj) + lane / tj;
  const int P = kMThreads / tj;
  const int cols = tj * V;
  const int ntiles = (N + cols - 1) / cols;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int j = min(t * cols + jj * V, N - V);
    float acc[kSlots][V];
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[si][c] = 0.0f;
    for (int i0 = p; i0 < K; i0 += kB * P) {
      VT w[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int i = i0 + u * P;
        w[u] = i < K ? *reinterpret_cast<const VT*>(W + (int64_t)i * N + j)
                     : VT{};
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int i = i0 + u * P;
        if (i < K) {
#pragma unroll
          for (int c = 0; c < V; ++c) {
            const float wv =
                round_to<T>(weight_value<TW>(lane_of(w[u], c), wscale, j + c));
#pragma unroll
            for (int si = 0; si < kSlots; ++si)
              acc[si][c] += xs[si * K + i] * wv;
          }
        }
      }
    }
#pragma unroll
    for (int si = 0; si < kSlots; ++si) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        float v = acc[si][c];
        for (int off = 16; off >= tj; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < tj) red[((warp * kSlots + si) * 32 + lane) * V + c] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < nb * cols) {
      const int si = threadIdx.x / cols, cc = threadIdx.x % cols;
      float s = 0.0f;
      for (int w = 0; w < kMWarps; ++w)
        s += red[(w * kSlots + si) * 32 * V + cc];
      if (t * cols + cc < N) epi(si, t * cols + cc, s);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool quantized(int state_dtype) {
  return state_dtype == SD_INT8 || state_dtype == SD_FP8;
}

// Blocks per SM and the grid of a cooperative launch of ``fn`` with
// ``threads`` threads and ``smem`` bytes of dynamic shared memory per block
// on the current device; 0 or a CUDA error.  Defined in
// megakernel_mamba.cu: the answers are kept per (kernel, device, shared
// memory), and so is the largest shared memory a kernel was opened to, so
// a launch after the first makes no attribute or occupancy query (none
// inside a CUDA graph capture either).
int coop_grid(const void* fn, size_t smem, int* per_sm, int* grid,
              int threads = kMThreads);

}  // namespace marca
