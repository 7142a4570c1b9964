// The MARCA nonlinear units standalone (paper §5, the EXP-RCU and SiLU-RCU
// modes), for Hopper, sm_90a.
//
// Replaces: repro/kernels/fast_exp.py:26 _fast_exp_kernel (K8, pallas_call
// at :41) and repro/kernels/piecewise_silu.py:26 _silu_kernel (K9,
// pallas_call at :41): element-wise over a contiguous tensor, f32 or bf16,
// computed in f32 and rounded once to the input's type, with the device
// functions of common.cuh (fast_exp, silu_ours, silu_paper), whose
// __fmul_rn / __fadd_rn and __float2int_rz make every result equal the
// plain PyTorch version's bit for bit.
//
// Bound on this card: bytes.  Each element is read once and written once
// (8 bytes in f32, 4 in bf16) for a handful of operations: 16 M f32
// elements take at least 40 us at 3.35 TB/s.
//
// Design: a grid-stride loop, one element a thread per step, loads and
// stores coalesced across the warp; no padding or tiling (the Pallas
// wrapper's pad-and-tile serves the TPU's (8, 128) layout).
#include "common.cuh"

namespace marca {

constexpr int kUnitThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kUnitThreads)
fast_exp_kernel(const T* x, T* y, int64_t n, float bias, float c) {
  for (int64_t i = (int64_t)blockIdx.x * kUnitThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kUnitThreads)
    y[i] = from_f32<T>(fast_exp(to_f32(x[i]), bias, c));
}

template <typename T>
__global__ void __launch_bounds__(kUnitThreads)
silu_kernel(const T* x, T* y, int64_t n, int paper) {
  for (int64_t i = (int64_t)blockIdx.x * kUnitThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kUnitThreads) {
    const float v = to_f32(x[i]);
    y[i] = from_f32<T>(paper ? silu_paper(v) : silu_ours(v));
  }
}

// enough blocks to fill the card several times over, at most one a 256
// elements
int unit_grid(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kUnitThreads - 1) / kUnitThreads;
  const int64_t cap = (int64_t)sms * 16;
  return (int)(want < cap ? want : cap);
}

}  // namespace marca

// y = fast_exp(x) element-wise: bias = (127 + b_shift) * 2^23 and c as f32;
// x, y contiguous, n elements, dtype 0 f32 / 1 bf16.  Returns 0 or a CUDA
// error.
extern "C" int marca_fast_exp(const void* x, void* y, int64_t n, int dtype,
                              float bias, float c, void* stream) {
  using namespace marca;
  if (n < 1 || (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    fast_exp_kernel<float><<<unit_grid(n), kUnitThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, bias, c);
  else
    fast_exp_kernel<__nv_bfloat16><<<unit_grid(n), kUnitThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, bias, c);
  return (int)cudaGetLastError();
}

// y = piecewise SiLU(x) element-wise, variant 0 "ours" / 1 "paper"; x, y
// contiguous, n elements, dtype 0 f32 / 1 bf16.  Returns 0 or a CUDA error.
extern "C" int marca_piecewise_silu(const void* x, void* y, int64_t n,
                                    int dtype, int paper, void* stream) {
  using namespace marca;
  if (n < 1 || (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    silu_kernel<float><<<unit_grid(n), kUnitThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, paper);
  else
    silu_kernel<__nv_bfloat16><<<unit_grid(n), kUnitThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, paper);
  return (int)cudaGetLastError();
}
