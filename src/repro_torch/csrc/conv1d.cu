// Causal depthwise conv1d (Mamba's short conv) for Hopper, sm_90a.
//
// Replaces: repro/kernels/conv1d.py:21 _conv_kernel (pallas_call at :73,
// "marca_causal_conv1d"), run at prefill (L = prompt) and at every decode
// step (L = 1).
//
//   y[b, t, c] = sum_i xp[b, t + i, c] * w[i, c] + bias[c]
//   xp = concat(x_prev (b, k-1, d), x (b, L, d)) along time
//
// Bound on this card: bytes.  Each output reads k inputs that neighbouring
// outputs share and does 2k operations, so one pass over x in and y out
// (plus the k-1 history rows and the k*d weights) is the floor: about 1 us
// at mamba-130m prefill (L = 512), and far below launch latency at decode.
//
// Design: one thread per (b, t, channel); consecutive threads take
// consecutive channels, so every load and the store coalesce, and the k-fold
// reuse of an input is served from L1.  Taps before t = 0 read x_prev, so
// the history needs no concatenated copy.  The TPU kernel carried the
// history across L-blocks in VMEM scratch; with the time axis in the grid
// here, nothing carries between blocks.  The wrapper rebuilds the new tail
// (the last k-1 inputs) the way repro's wrapper does (conv1d.py:110).
#include "common.cuh"

namespace marca {

constexpr int kConvThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
causal_conv1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const T* __restrict__ x_prev, T* __restrict__ y, int L,
                     int d, int k, int64_t sx_b, int64_t sx_t) {
  const int c = blockIdx.x * kConvThreads + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= d) return;
  float acc = 0.0f;
  for (int i = 0; i < k; ++i) {
    const int src = t + i - (k - 1);  // time index into x; < 0 is history
    const float v =
        src >= 0 ? to_f32(x[b * sx_b + src * sx_t + c])
                 : (x_prev != nullptr
                        ? to_f32(x_prev[((int64_t)b * (k - 1) + (src + k - 1)) *
                                            d + c])
                        : 0.0f);
    acc += v * w[(int64_t)i * d + c];
  }
  if (bias != nullptr) acc += bias[c];
  y[((int64_t)b * L + t) * d + c] = from_f32<T>(acc);
}

}  // namespace marca

extern "C" int marca_causal_conv1d(const void* x, const void* w,
                                   const void* bias, const void* x_prev,
                                   void* y, int batch, int L, int d, int k,
                                   int64_t sx_b, int64_t sx_t, int dtype,
                                   void* stream) {
  using namespace marca;
  if (batch < 1 || L < 1 || d < 1 || k < 1 || batch > 65535 || L > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((d + kConvThreads - 1) / kConvThreads, L, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    causal_conv1d_kernel<float><<<grid, kConvThreads, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)bias,
        (const float*)x_prev, (float*)y, L, d, k, sx_b, sx_t);
  } else if (dtype == DT_BF16) {
    using bf = __nv_bfloat16;
    causal_conv1d_kernel<bf><<<grid, kConvThreads, 0, st>>>(
        (const bf*)x, (const float*)w, (const float*)bias, (const bf*)x_prev,
        (bf*)y, L, d, k, sx_b, sx_t);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
