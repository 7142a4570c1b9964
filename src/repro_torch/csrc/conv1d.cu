// Causal depthwise conv1d (Mamba's short conv) for Hopper, sm_90a.
//
// Replaces: repro/kernels/conv1d.py:21 _conv_kernel (pallas_call at :73,
// "marca_causal_conv1d"), run at prefill (L = prompt) and at every decode
// step (L = 1).
//
//   y[b, t, c] = sum_i xp[b, t + i, c] * w[i, c] + bias[c]
//   xp = concat(x_prev (b, k-1, d) or zeros, x (b, L, d)) along time
//   tail = xp[b, L .. L+k-2, :]   (the next call's x_prev)
//
// Bound on this card: bytes.  Each output reads k inputs that neighbouring
// outputs share and does 2k operations, so one pass over x in and y out
// (plus the k-1 history rows in, the tail out and the k*d weights) is the
// floor: about 1 us at mamba-130m prefill (L = 512), and far below launch
// latency at decode.
//
// Design: one launch writes y and the tail, as the TPU kernel's tail_ref
// does: the wrapper makes no concatenated copy.  A thread takes 8
// consecutive channels (16-byte loads: one in bf16, two in f32) and a run
// of up to 8 time steps.  It keeps its channels' taps and bias in
// registers, and the k-1 inputs before the current step as a sliding
// window, so each input of the run is read once; a run's first window
// comes from the k-1 rows before it (x_prev, or zeros, before t = 0).  The
// thread whose run ends at L writes its final window as the tail: pure
// copies, bit for bit the inputs, and when L < k-1 the window still holds
// x_prev rows shifted by L.  The sum runs in tap order, then the bias, in
// f32, as the plain version does.  The 8-channel path needs d a multiple
// of 8 and every pointer and x's row strides on 16-byte boundaries (x may
// be a strided view, as the Mamba block's x of its in_proj output);
// otherwise the same kernel runs one channel a thread.  Threads are laid
// out channel-major over (run, channel group), 64 a block: at prefill of
// d 1536, L 512 that is 12,288 threads in 192 blocks.
#include "common.cuh"

namespace marca {

constexpr int kConvThreads = 64;
constexpr int kConvRun = 8;     // time steps per thread
constexpr int kConvMaxTaps = 4;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// T the stream type, K taps, V channels a thread (8 or 1)
template <typename T, int K, int V>
__global__ void __launch_bounds__(kConvThreads)
causal_conv1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const T* __restrict__ x_prev, T* __restrict__ y,
                     T* __restrict__ tail, int L, int d, int64_t sx_b,
                     int64_t sx_t) {
  constexpr int W = K > 1 ? K - 1 : 1;  // window rows (K - 1 used)
  const int groups = d / V;
  const int runs = (L + kConvRun - 1) / kConvRun;
  const int64_t item = (int64_t)blockIdx.x * kConvThreads + threadIdx.x;
  if (item >= (int64_t)groups * runs) return;
  const int c0 = (int)(item % groups) * V;
  const int t0 = (int)(item / groups) * kConvRun;
  const int b = blockIdx.y;
  const T* xb = x + b * sx_b + c0;

  float wr[K][V], br[V];
#pragma unroll
  for (int i = 0; i < K; ++i) load_vec<V>(w + (int64_t)i * d + c0, wr[i]);
  if (bias != nullptr) {
    load_vec<V>(bias + c0, br);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) br[j] = 0.0f;
  }
  // win[m] = xp[t0 + m], the K-1 inputs before x[t0]
  float win[W][V];
#pragma unroll
  for (int m = 0; m < K - 1; ++m) {
    const int src = t0 + m - (K - 1);  // time index into x; < 0 is history
    if (src >= 0) {
      load_vec<V>(xb + src * sx_t, win[m]);
    } else if (x_prev != nullptr) {
      load_vec<V>(x_prev + ((int64_t)b * (K - 1) + src + K - 1) * d + c0,
                  win[m]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) win[m][j] = 0.0f;
    }
  }
#pragma unroll
  for (int u = 0; u < kConvRun; ++u) {
    const int t = t0 + u;
    if (t >= L) break;
    float cur[V], acc[V];
    load_vec<V>(xb + t * sx_t, cur);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < K - 1; ++i) s += win[i][j] * wr[i][j];
      s += cur[j] * wr[K - 1][j];
      acc[j] = s + br[j];
    }
    store_vec<V>(y + ((int64_t)b * L + t) * d + c0, acc);
#pragma unroll
    for (int m = 0; m + 1 < K - 1; ++m) {
#pragma unroll
      for (int j = 0; j < V; ++j) win[m][j] = win[m + 1][j];
    }
    if (K > 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) win[K - 2][j] = cur[j];
    }
  }
  if (t0 + kConvRun >= L) {
    // the run that ends at L: its window is xp[L .. L+K-2], the new tail
#pragma unroll
    for (int m = 0; m < K - 1; ++m)
      store_vec<V>(tail + ((int64_t)b * (K - 1) + m) * d + c0, win[m]);
  }
}

template <typename T, int K>
int launch_conv(const void* x, const void* w, const void* bias,
                const void* x_prev, void* y, void* tail, int batch, int L,
                int d, int64_t sx_b, int64_t sx_t, cudaStream_t st) {
  constexpr int64_t per16 = 16 / sizeof(T);
  const bool vec =
      d % 8 == 0 && sx_b % per16 == 0 && sx_t % per16 == 0 &&
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)bias | (uintptr_t)x_prev |
        (uintptr_t)y | (uintptr_t)tail) & 15) == 0;
  const int v = vec ? 8 : 1;
  const int64_t items =
      (int64_t)(d / v) * ((L + kConvRun - 1) / kConvRun);
  const dim3 grid((unsigned)((items + kConvThreads - 1) / kConvThreads),
                  batch);
  const T* xt = static_cast<const T*>(x);
  const T* pt = static_cast<const T*>(x_prev);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(bias);
  if (vec)
    causal_conv1d_kernel<T, K, 8><<<grid, kConvThreads, 0, st>>>(
        xt, wt, bt, pt, static_cast<T*>(y), static_cast<T*>(tail), L, d,
        sx_b, sx_t);
  else
    causal_conv1d_kernel<T, K, 1><<<grid, kConvThreads, 0, st>>>(
        xt, wt, bt, pt, static_cast<T*>(y), static_cast<T*>(tail), L, d,
        sx_b, sx_t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_conv_taps(const void* x, const void* w, const void* bias,
                     const void* x_prev, void* y, void* tail, int batch,
                     int L, int d, int k, int64_t sx_b, int64_t sx_t,
                     cudaStream_t st) {
  switch (k) {
    case 1: return launch_conv<T, 1>(x, w, bias, x_prev, y, tail, batch, L,
                                     d, sx_b, sx_t, st);
    case 2: return launch_conv<T, 2>(x, w, bias, x_prev, y, tail, batch, L,
                                     d, sx_b, sx_t, st);
    case 3: return launch_conv<T, 3>(x, w, bias, x_prev, y, tail, batch, L,
                                     d, sx_b, sx_t, st);
    case 4: return launch_conv<T, 4>(x, w, bias, x_prev, y, tail, batch, L,
                                     d, sx_b, sx_t, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace marca

// x (b, L, d) with row strides sx_b, sx_t (unit channel stride); w (k, d)
// and bias (d,) or null, f32, contiguous; x_prev (b, k-1, d) or null, y
// (b, L, d) and tail (b, k-1, d), contiguous, in the compute type (0 f32,
// 1 bf16); 1 <= k <= 4.  Returns 0 or a CUDA error.
extern "C" int marca_causal_conv1d(const void* x, const void* w,
                                   const void* bias, const void* x_prev,
                                   void* y, void* tail, int batch, int L,
                                   int d, int k, int64_t sx_b, int64_t sx_t,
                                   int dtype, void* stream) {
  using namespace marca;
  if (batch < 1 || L < 1 || d < 1 || k < 1 || k > kConvMaxTaps ||
      batch > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_conv_taps<float>(x, w, bias, x_prev, y, tail, batch, L, d,
                                   k, sx_b, sx_t, st);
  if (dtype == DT_BF16)
    return launch_conv_taps<__nv_bfloat16>(x, w, bias, x_prev, y, tail,
                                           batch, L, d, k, sx_b, sx_t, st);
  return cudaErrorInvalidValue;
}
