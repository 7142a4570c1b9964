// Quantized-state S6 decode step over the slot pool, for Hopper, sm_90a.
//
// Replaces: repro/kernels/decode_step.py:234 _step_kernel_q (pallas_call at
// :396, "marca_decode_step_q"): the decode_step.cu chain on an int8 or fp8
// state payload with one f32 scale per (slot, 512-channel group), with f32
// A or int8 A codes and their per-channel scales.
//
//   h     = q * s_in                                       dequant on read
//   h'    = exp(dt * A) * h + (dt * x) B ;  y = (sum_n C_n h'_n + D x) silu(z)
//   s_out = max(max|h'|_group, 0.99 * (s_in * qm), 1e-30) / qm
//   q'    = encode(h' / s_out)              qm = 127 (int8) | 448 (fp8)
//
// Bound on this card: bytes.  Each call reads the payload at one byte per
// state element (98 KB at 4 slots of mamba-130m) and writes it back,
// against four bytes each way for the f32 step; the scales, x, dt, z, B,
// C, A and D add little.  At serving shapes the call is launch-bound.
//
// Design: grid (groups, slots), one block of 512 threads per (slot,
// group): 16 lanes per channel as in decode_step.cu, 32 channels per pass
// and 16 passes over the group's 512 channels.  Each thread keeps its 16
// h' values (and y, for the channel's first lane) in registers; the
// passes' loads are independent, so they are in flight together.  The
// group's absmax is a __shfl_xor_sync max within each warp and a
// shared-memory max over the 16 warps, so the requantization is local to
// the block (scale blocking == channel blocking, as on the TPU) and the
// f32 state never reaches device memory.
// One thread computes s_out with update_scale and the block encodes with
// Codes<TQ> (both in common.cuh, shared with the megakernel).
// Channels past d in the ragged last group shadow the last channel in the
// shuffles and write nothing; the TPU kernel's zero padding gives the same
// absmax.  At mamba-130m and 4 slots the grid is 12 blocks: splitting a
// group over a thread-block cluster is later work.
#include "common.cuh"

namespace marca {

constexpr int kQN = 16;                         // d_state
constexpr int kQGroup = kScaleGroup;            // state_quant.D_BLOCK
constexpr int kQThreads = 512;
constexpr int kQPerPass = kQThreads / kQN;      // 32 channels per pass
constexpr int kQPasses = kQGroup / kQPerPass;   // 16 passes per group

struct QStepArgs {
  const void* hq;
  const float* h_scale;
  const void* x;
  const void* dt;
  const void* A;
  const float* a_scale;
  const void* B;
  const void* C;
  const float* D;
  const void* z;
  void* y;
  void* hq_new;
  float* scale_new;
  int d, g;
  int64_t sx, sdt, sB, sC, sz;
  int exp_impl, silu_impl;
};

template <typename T, typename TA, typename TQ>
__global__ void __launch_bounds__(kQThreads)
decode_step_q_kernel(const QStepArgs a) {
  __shared__ float warp_amax[kQThreads / 32];
  __shared__ float s_out_shared;
  const TQ* __restrict__ hq = static_cast<const TQ*>(a.hq);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dt = static_cast<const T*>(a.dt);
  const TA* __restrict__ A = static_cast<const TA*>(a.A);
  const T* __restrict__ z = static_cast<const T*>(a.z);
  TQ* __restrict__ hq_new = static_cast<TQ*>(a.hq_new);
  T* __restrict__ y = static_cast<T*>(a.y);

  const int s = threadIdx.x % kQN;
  const int lane_ch = threadIdx.x / kQN;
  const int grp = blockIdx.x;
  const int slot = blockIdx.y;
  const int d = a.d;
  const int c0 = grp * kQGroup;
  const int c_end = min(c0 + kQGroup, d);
  const float s_in = a.h_scale[(int64_t)slot * a.g + grp];
  const float bv = to_f32(static_cast<const T*>(a.B)[slot * a.sB + s]);
  const float cv = to_f32(static_cast<const T*>(a.C)[slot * a.sC + s]);
  const bool has_z = z != nullptr;

  // The pass loop has no branch around its loads and stores nothing, so
  // the compiler can issue every pass's loads up front: one memory latency
  // per block instead of one per pass.  Lanes past the group shadow its
  // last channel; their values are dropped below.
  float hv[kQPasses], yo[kQPasses];
  float amax = 0.0f;
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
    const int ch = c0 + p * kQPerPass + lane_ch;
    const int c = min(ch, c_end - 1);
    const int64_t hidx = ((int64_t)slot * d + c) * kQN + s;
    const float h = __fmul_rn(Codes<TQ>::decode(hq[hidx]), s_in);
    const float xv = to_f32(x[slot * a.sx + c]);
    const float dtv = to_f32(dt[slot * a.sdt + c]);
    const float h1 = s6_state_update(
        h, dtv, xv, load_w(A, a.a_scale, (int64_t)c * kQN + s, c), bv,
        a.exp_impl);
    const float zv = has_z ? to_f32(z[slot * a.sz + c]) : 0.0f;
    yo[p] = s6_gate(s6_contract<kQN>(h1, cv), xv, a.D, c, has_z, zv,
                    a.silu_impl);
    hv[p] = h1;
    if (ch < c_end) amax = fmaxf(amax, fabsf(h1));
  }
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
    const int ch = c0 + p * kQPerPass + lane_ch;
    if (s == 0 && ch < c_end)
      y[(int64_t)slot * d + ch] = from_f32<T>(yo[p]);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_amax[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_amax[0];
    for (int w = 1; w < kQThreads / 32; ++w) m = fmaxf(m, warp_amax[w]);
    const float so = update_scale(m, s_in, Codes<TQ>::kMax);
    a.scale_new[(int64_t)slot * a.g + grp] = so;
    s_out_shared = so;
  }
  __syncthreads();
  const float so = s_out_shared;
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
    const int ch = c0 + p * kQPerPass + lane_ch;
    if (ch < c_end)
      hq_new[((int64_t)slot * d + ch) * kQN + s] =
          Codes<TQ>::encode(__fdiv_rn(hv[p], so));
  }
}

template <typename T, typename TA>
int launch_q(dim3 grid, cudaStream_t st, int state_dtype,
             const QStepArgs& a) {
  if (state_dtype == SD_INT8) {
    decode_step_q_kernel<T, TA, int8_t><<<grid, kQThreads, 0, st>>>(a);
  } else if (state_dtype == SD_FP8) {
    decode_step_q_kernel<T, TA, __nv_fp8_e4m3><<<grid, kQThreads, 0, st>>>(
        a);
  } else {
    return cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace marca

// a_scale == nullptr: A is f32; otherwise A is int8 codes and a_scale
// their (d,) f32 per-channel scales.  g must be state_quant.n_groups(d).
extern "C" int marca_decode_step_q(
    const void* hq, const void* h_scale, const void* x, const void* dt,
    const void* A, const void* a_scale, const void* B, const void* C,
    const void* D, const void* z, void* y, void* hq_new, void* scale_new,
    int slots, int d, int n, int g, int64_t sx, int64_t sdt, int64_t sB,
    int64_t sC, int64_t sz, int dtype, int state_dtype, int exp_impl,
    int silu_impl, void* stream) {
  using namespace marca;
  if (n != kQN || slots < 1 || slots > 65535 || d < 1 ||
      g != (d + kQGroup - 1) / kQGroup)
    return cudaErrorInvalidValue;
  const QStepArgs a{hq,  (const float*)h_scale, x, dt, A,
                    (const float*)a_scale, B, C, (const float*)D, z, y,
                    hq_new, (float*)scale_new, d, g, sx, sdt, sB, sC, sz,
                    exp_impl, silu_impl};
  const dim3 grid(g, slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a8 = a_scale != nullptr;
  int rc;
  if (dtype == DT_F32 && !a8) {
    rc = launch_q<float, float>(grid, st, state_dtype, a);
  } else if (dtype == DT_F32) {
    rc = launch_q<float, int8_t>(grid, st, state_dtype, a);
  } else if (dtype == DT_BF16 && !a8) {
    rc = launch_q<__nv_bfloat16, float>(grid, st, state_dtype, a);
  } else if (dtype == DT_BF16) {
    rc = launch_q<__nv_bfloat16, int8_t>(grid, st, state_dtype, a);
  } else {
    return cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
