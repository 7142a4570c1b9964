// Fused single-token S6 decode step over the slot pool, for Hopper, sm_90a.
//
// Replaces: repro/kernels/decode_step.py:223 _step_kernel (pallas_call at
// :316, "marca_decode_step"), the per-layer decode step of the Mamba block,
// in both its variants: f32 A, and int8 A codes with per-channel f32
// scales (weight_dtype="int8", the TPU kernel's `wq` dequant phase).
//
//   h' = exp(dt * A) * h + (dt * x) B ;  y = sum_n C_n h'_n
//   out = (y + D * x) * silu(z)
//
// Bound on this card: bytes.  Each call reads the pooled f32 state h
// (slots * d * n * 4 bytes, 393 KB at 4 slots of mamba-130m) and writes h'
// of the same size; x, dt, z, B, C, A and D add little, and the arithmetic
// is a few operations per state element.  At serving shapes the call is far
// below a microsecond of bytes, so launch latency is what it costs.
//
// Design: the scan kernel's thread mapping with the time loop removed: one
// thread per (slot, channel, state), 16 lanes per channel, the sum over n
// as a __shfl_xor_sync butterfly.  h is read in the pool's (slots, d, n)
// layout and h' written to an output the wrapper allocates; masking of
// inactive slots stays with the caller, as in repro.  Row strides for x,
// dt, z, B and C let the block pass its strided views without a copy.
// The A type is a template parameter beside the activation type: with
// int8 A each thread dequantizes its own entry (load_w in common.cuh), so
// A crosses device memory at one byte per entry and the f32-A path is
// unchanged.
#include "common.cuh"

namespace marca {

constexpr int kStepN = 16;
constexpr int kStepThreads = 128;  // 8 channels per block

template <typename T, typename TA>
__global__ void __launch_bounds__(kStepThreads)
decode_step_kernel(const float* __restrict__ h, const T* __restrict__ x,
                   const T* __restrict__ dt, const TA* __restrict__ A,
                   const float* __restrict__ a_scale,
                   const T* __restrict__ B, const T* __restrict__ C,
                   const float* __restrict__ D, const T* __restrict__ z,
                   T* __restrict__ y, float* __restrict__ h_new, int d,
                   int64_t sx, int64_t sdt, int64_t sB, int64_t sC, int64_t sz,
                   int exp_impl, int silu_impl) {
  const int s = threadIdx.x % kStepN;
  const int ch = blockIdx.x * (kStepThreads / kStepN) + threadIdx.x / kStepN;
  const int slot = blockIdx.y;
  const bool valid = ch < d;
  const int c = valid ? ch : d - 1;

  const int64_t hidx = ((int64_t)slot * d + c) * kStepN + s;
  const float xv = to_f32(x[slot * sx + c]);
  const float dtv = to_f32(dt[slot * sdt + c]);
  const float hv = s6_state_update(
      h[hidx], dtv, xv, load_w(A, a_scale, (int64_t)c * kStepN + s, c),
      to_f32(B[slot * sB + s]), exp_impl);
  float yv = s6_contract<kStepN>(hv, to_f32(C[slot * sC + s]));
  if (!valid) return;
  h_new[hidx] = hv;
  if (s == 0) {
    const bool has_z = z != nullptr;
    const float zv = has_z ? to_f32(z[slot * sz + c]) : 0.0f;
    yv = s6_gate(yv, xv, D, c, has_z, zv, silu_impl);
    y[(int64_t)slot * d + c] = from_f32<T>(yv);
  }
}

}  // namespace marca

namespace {

template <typename T, typename TA>
void launch(dim3 grid, cudaStream_t st, const void* h, const void* x,
            const void* dt, const void* A, const void* a_scale,
            const void* B, const void* C, const void* D, const void* z,
            void* y, void* h_new, int d, int64_t sx, int64_t sdt, int64_t sB,
            int64_t sC, int64_t sz, int exp_impl, int silu_impl) {
  marca::decode_step_kernel<T, TA><<<grid, marca::kStepThreads, 0, st>>>(
      (const float*)h, (const T*)x, (const T*)dt, (const TA*)A,
      (const float*)a_scale, (const T*)B, (const T*)C, (const float*)D,
      (const T*)z, (T*)y, (float*)h_new, d, sx, sdt, sB, sC, sz, exp_impl,
      silu_impl);
}

}  // namespace

// a_scale == nullptr: A is f32; otherwise A is int8 codes and a_scale
// their (d,) f32 per-channel scales.
extern "C" int marca_decode_step(const void* h, const void* x, const void* dt,
                                 const void* A, const void* a_scale,
                                 const void* B, const void* C, const void* D,
                                 const void* z, void* y, void* h_new,
                                 int slots, int d, int n, int64_t sx,
                                 int64_t sdt, int64_t sB, int64_t sC,
                                 int64_t sz, int dtype, int exp_impl,
                                 int silu_impl, void* stream) {
  using namespace marca;
  if (n != kStepN || slots < 1 || slots > 65535 || d < 1)
    return cudaErrorInvalidValue;
  const int per_block = kStepThreads / kStepN;
  const dim3 grid((d + per_block - 1) / per_block, slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a8 = a_scale != nullptr;
  using bf = __nv_bfloat16;
  if (dtype == DT_F32 && !a8) {
    launch<float, float>(grid, st, h, x, dt, A, a_scale, B, C, D, z, y,
                         h_new, d, sx, sdt, sB, sC, sz, exp_impl, silu_impl);
  } else if (dtype == DT_F32) {
    launch<float, int8_t>(grid, st, h, x, dt, A, a_scale, B, C, D, z, y,
                          h_new, d, sx, sdt, sB, sC, sz, exp_impl, silu_impl);
  } else if (dtype == DT_BF16 && !a8) {
    launch<bf, float>(grid, st, h, x, dt, A, a_scale, B, C, D, z, y, h_new,
                      d, sx, sdt, sB, sC, sz, exp_impl, silu_impl);
  } else if (dtype == DT_BF16) {
    launch<bf, int8_t>(grid, st, h, x, dt, A, a_scale, B, C, D, z, y, h_new,
                       d, sx, sdt, sB, sC, sz, exp_impl, silu_impl);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
