// Selective scan (S6 recurrence over time) for Hopper, sm_90a.
//
// Replaces: repro/kernels/selective_scan.py:43 _scan_kernel (pallas_call at
// :138, "marca_selective_scan"), the prefill scan of the Mamba block.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ;  y_t = sum_n C_t h_t
//   out_t = (y_t + D * x_t) * silu(z_t)          h0 in, h_last out
//
// Bound on this card: one pass over x, dt, z, B, C in and y out is
// O(b*L*d) bytes (a few MB at mamba-130m prefill, about 2 us at
// 3.35 TB/s), while the recurrence evaluates b*L*d*n exponentials; with the
// exact exp that is MUFU work at 16 results per clock per SM, which sets a
// slightly larger floor than the bytes.  The TPU kernel kept h in VMEM
// across L-chunks; here it lives in one register per thread.
//
// Design: one thread per (channel, state) pair; kN = 16 consecutive lanes
// hold one channel's state, so a warp covers 2 channels and the sum over n
// is a 4-step __shfl_xor_sync butterfly.  h stays in a register across a
// loop over t < L, so no padding of L or d is needed (the TPU's padded tail
// and its da=1/dbx=0 masking go away).  Inputs for kChunk time steps are
// loaded into registers before they are consumed, so each chunk pays one
// memory latency instead of one per step.  h0 and h_last are read and
// written in the pool's (b, d, n) layout directly: no transpose per call
// (repro transposes to (b, n, d) and pads on every call,
// selective_scan.py:183).  Row strides for x, dt, z, B and C are arguments,
// so the strided views the Mamba block takes of its in_proj / x_proj
// outputs need no copy.  The grid is (ceil(d / channels-per-block), b).
#include "common.cuh"

namespace marca {

constexpr int kScanN = 16;        // d_state: lanes per channel group
constexpr int kScanThreads = 64;  // 4 channels per block
constexpr int kChunk = 8;         // time steps loaded ahead

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ C, const float* __restrict__ D,
                      const T* __restrict__ z, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ h_last, int L,
                      int d, int64_t sx_b, int64_t sx_t, int64_t sdt_b,
                      int64_t sdt_t, int64_t sB_b, int64_t sB_t, int64_t sC_b,
                      int64_t sC_t, int64_t sz_b, int64_t sz_t, int exp_impl,
                      int silu_impl) {
  const int s = threadIdx.x % kScanN;
  const int ch = blockIdx.x * (kScanThreads / kScanN) + threadIdx.x / kScanN;
  const int b = blockIdx.y;
  const bool valid = ch < d;
  // lanes past d shadow the last channel so every lane joins the shuffles
  const int c = valid ? ch : d - 1;
  const bool has_z = z != nullptr;

  const float a = A[(int64_t)c * kScanN + s];
  const int64_t hidx = ((int64_t)b * d + c) * kScanN + s;
  float h = h0 != nullptr ? h0[hidx] : 0.0f;

  const T* xb = x + b * sx_b + c;
  const T* dtb = dt + b * sdt_b + c;
  const T* Bb = B + b * sB_b + s;
  const T* Cb = C + b * sC_b + s;
  const T* zb = has_z ? z + b * sz_b + c : nullptr;
  T* yb = y + (int64_t)b * L * d + c;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    float xv[kChunk], dtv[kChunk], bv[kChunk], cv[kChunk], zv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = t0 + j;
      if (t < L) {
        xv[j] = to_f32(xb[t * sx_t]);
        dtv[j] = to_f32(dtb[t * sdt_t]);
        bv[j] = to_f32(Bb[t * sB_t]);
        cv[j] = to_f32(Cb[t * sC_t]);
        zv[j] = has_z ? to_f32(zb[t * sz_t]) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = t0 + j;
      if (t < L) {  // uniform across the block: no divergent shuffles
        h = s6_state_update(h, dtv[j], xv[j], a, bv[j], exp_impl);
        float yv = s6_contract<kScanN>(h, cv[j]);
        if (s == 0 && valid) {
          yv = s6_gate(yv, xv[j], D, c, has_z, zv[j], silu_impl);
          yb[(int64_t)t * d] = from_f32<T>(yv);
        }
      }
    }
  }
  if (valid) h_last[hidx] = h;
}

}  // namespace marca

extern "C" int marca_selective_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* z, const void* h0, void* y,
    void* h_last, int batch, int L, int d, int n, int64_t sx_b, int64_t sx_t,
    int64_t sdt_b, int64_t sdt_t, int64_t sB_b, int64_t sB_t, int64_t sC_b,
    int64_t sC_t, int64_t sz_b, int64_t sz_t, int dtype, int exp_impl,
    int silu_impl, void* stream) {
  using namespace marca;
  if (n != kScanN || batch < 1 || batch > 65535 || L < 1 || d < 1)
    return cudaErrorInvalidValue;
  const int per_block = kScanThreads / kScanN;
  const dim3 grid((d + per_block - 1) / per_block, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    selective_scan_kernel<float><<<grid, kScanThreads, 0, st>>>(
        (const float*)x, (const float*)dt, (const float*)A, (const float*)B,
        (const float*)C, (const float*)D, (const float*)z, (const float*)h0,
        (float*)y, (float*)h_last, L, d, sx_b, sx_t, sdt_b, sdt_t, sB_b,
        sB_t, sC_b, sC_t, sz_b, sz_t, exp_impl, silu_impl);
  } else if (dtype == DT_BF16) {
    using bf = __nv_bfloat16;
    selective_scan_kernel<bf><<<grid, kScanThreads, 0, st>>>(
        (const bf*)x, (const bf*)dt, (const float*)A, (const bf*)B,
        (const bf*)C, (const float*)D, (const bf*)z, (const float*)h0,
        (bf*)y, (float*)h_last, L, d, sx_b, sx_t, sdt_b, sdt_t, sB_b, sB_t,
        sC_b, sC_t, sz_b, sz_t, exp_impl, silu_impl);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
