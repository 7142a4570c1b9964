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
// exact exp that is MUFU work at 16 results per clock per SM (12.6 M of them
// at b=1, L=512, d=1536: 3.2 us at 1.98 GHz), which sets the floor.  The
// TPU kernel kept h in VMEM across L-chunks; on the card a walk over L in
// order is a chain of L dependent steps, so the design cuts it.
//
// Design: a chunked scan in one launch.  Time is cut into kSegs segments of
// ceil(L / kSegs) steps (fewer where L is short, the last one ragged); a
// block holds kScanThreads / kSegs channels of one sequence for every
// segment, one thread a (channel, segment) with all 16 states of the
// channel in registers (the sum over n needs no shuffle, and the loads and
// the gate of a (channel, step) are paid once).
//   1. Every segment but the last folds its steps into (P, S) per state:
//      P = prod dA_t, S = the segment's h from zero (h = dA_t h + dBx_t).
//   2. After one __syncthreads, segment k combines the pairs of segments
//      0 .. k-1 in order from h0 (h = P_j h + S_j) into its carry-in.
//   3. Every segment reruns its steps from its carry-in and writes y_t (the
//      sum over n in 4 partial sums), D skip and the SiLU(z) gate; the last
//      segment writes h_last.
// Each step's dA_t is the same expression in passes 1 and 3 (exp_impl of
// dt_t * A, never an exp of a summed exponent), so only the association of
// the h recurrence changes.  A thread's chain is 2 L / kSegs steps plus
// kSegs combines instead of L; the rerun costs one more pass of
// exponentials.  32 segments (4 channels a block) while the call's blocks
// are all resident at once by the card's occupancy (on an H100, 3 blocks
// an SM at 150-152 registers: b * d up to 1,584 channels), 16 (8 channels)
// for wider calls (b = 2 at d_inner 1536, d_inner 2048 and up).  Inputs
// are loaded one step at a time: measured on an H100 (700 W,
// scripts/torch_k4.py), deeper register prefetch and 2 or 4 lanes a
// channel were slower.  B and C are read in 16-byte words where their base
// and row strides allow it, element by element otherwise (the ragged
// dt_rank of the card tests).  h0 and h_last are read and written in the
// pool's (b, d, n) layout; row strides for x, dt, z, B and C are
// arguments, so the strided views the Mamba block takes of its in_proj /
// x_proj outputs need no copy.  No atomics: the same inputs give the same
// bits.
#include "common.cuh"

#include <atomic>

namespace marca {

constexpr int kScanN = 16;  // d_state: all of a channel's states a thread
constexpr int kScanThreads = 128;

template <int kExp>
__device__ __forceinline__ float exp_of(float x) {
  if (kExp == EXP_OURS) return fast_exp(x, kOursBias, kOursC);
  if (kExp == EXP_FAST) return fast_exp(x, kFastBias, 0.0f);
  return expf(x);
}

// One row of B or C (16 states) kept in its storage type: 16-byte loads
// where the rows allow them (kVec), else element by element.
template <typename T>
struct Row {
  static constexpr int kWords = kScanN * sizeof(T) / 16;
  uint4 w[kWords];
};

template <typename T, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ p, Row<T>& r) {
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < Row<T>::kWords; ++k)
      r.w[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
  } else {
    T* e = reinterpret_cast<T*>(r.w);
#pragma unroll
    for (int i = 0; i < kScanN; ++i) e[i] = __ldg(p + i);
  }
}

template <typename T>
__device__ __forceinline__ float elem(const Row<T>& r, int i) {
  return to_f32(reinterpret_cast<const T*>(r.w)[i]);
}

struct ScanArgs {
  const void *x, *dt, *B, *C, *z;
  const float *A, *D, *h0;
  void* y;
  float* h_last;
  int L, d;
  int64_t sx_b, sx_t, sdt_b, sdt_t, sB_b, sB_t, sC_b, sC_t, sz_b, sz_t;
  int silu_impl;
};

// the inputs of one time step of one channel
template <typename T, bool kC>
struct Step {
  float x, dt, z;
  Row<T> B, C;
};

template <typename T, bool kVec, bool kC>
__device__ __forceinline__ void load_step(
    const ScanArgs& a, const T* __restrict__ xb, const T* __restrict__ dtb,
    const T* __restrict__ zb, const T* __restrict__ Bb,
    const T* __restrict__ Cb, int t, Step<T, kC>& s) {
  s.x = to_f32(__ldg(xb + t * a.sx_t));
  s.dt = to_f32(__ldg(dtb + t * a.sdt_t));
  load_row<T, kVec>(Bb + t * a.sB_t, s.B);
  if constexpr (kC) {
    s.z = zb != nullptr ? to_f32(__ldg(zb + t * a.sz_t)) : 0.0f;
    load_row<T, kVec>(Cb + t * a.sC_t, s.C);
  }
}

template <typename T, int kExp, bool kVec, int kSegs>
__global__ void __launch_bounds__(kScanThreads, kSegs == 16 ? 4 : 1)
selective_scan_kernel(const __grid_constant__ ScanArgs a) {
  constexpr int kCh = kScanThreads / kSegs;  // channels a block
  __shared__ float4 Ps[kSegs - 1][kCh][kScanN / 4];
  __shared__ float4 Ss[kSegs - 1][kCh][kScanN / 4];
  const int cl = threadIdx.x % kCh;
  const int seg = threadIdx.x / kCh;
  const int ch = blockIdx.x * kCh + cl;
  const int b = blockIdx.y;
  const int L = a.L, d = a.d;
  const bool valid = ch < d;
  const int c = valid ? ch : d - 1;  // shadow threads run, never write
  const int seglen = (L + kSegs - 1) / kSegs;
  const int nseg = (L + seglen - 1) / seglen;
  const int t0 = min(seg * seglen, L), t1 = min(t0 + seglen, L);
  const bool has_z = a.z != nullptr;

  // restrict: y's stores cannot alias the inputs, so a step's loads need
  // not wait for the previous step's store
  const T* __restrict__ xb = static_cast<const T*>(a.x) + b * a.sx_b + c;
  const T* __restrict__ dtb = static_cast<const T*>(a.dt) + b * a.sdt_b + c;
  const T* __restrict__ Bb = static_cast<const T*>(a.B) + b * a.sB_b;
  const T* __restrict__ Cb = static_cast<const T*>(a.C) + b * a.sC_b;
  const T* __restrict__ zb =
      has_z ? static_cast<const T*>(a.z) + b * a.sz_b + c : nullptr;
  const float dskip = a.D != nullptr ? a.D[c] : 0.0f;
  float av[kScanN];
#pragma unroll
  for (int i = 0; i < kScanN; ++i) av[i] = a.A[(int64_t)c * kScanN + i];

  // 1. (P, S) of every segment but the last
  if (seg + 1 < nseg) {
    float P[kScanN], S[kScanN];
#pragma unroll
    for (int i = 0; i < kScanN; ++i) P[i] = 1.0f, S[i] = 0.0f;
    for (int t = t0; t < t1; ++t) {
      Step<T, false> cur;
      load_step<T, kVec, false>(a, xb, dtb, zb, Bb, Cb, t, cur);
      const float dx = cur.dt * cur.x;
#pragma unroll
      for (int i = 0; i < kScanN; ++i) {
        const float da = exp_of<kExp>(cur.dt * av[i]);
        P[i] *= da;
        S[i] = da * S[i] + dx * elem(cur.B, i);
      }
    }
#pragma unroll
    for (int k = 0; k < kScanN / 4; ++k) {
      Ps[seg][cl][k] = make_float4(P[4 * k], P[4 * k + 1], P[4 * k + 2],
                                   P[4 * k + 3]);
      Ss[seg][cl][k] = make_float4(S[4 * k], S[4 * k + 1], S[4 * k + 2],
                                   S[4 * k + 3]);
    }
  }
  __syncthreads();
  if (seg >= nseg) return;

  // 2. the carry-in: segments 0 .. seg-1 folded in order from h0
  const int64_t hidx = ((int64_t)b * d + c) * kScanN;
  float h[kScanN];
#pragma unroll
  for (int i = 0; i < kScanN; ++i)
    h[i] = a.h0 != nullptr ? a.h0[hidx + i] : 0.0f;
  for (int j = 0; j < seg; ++j) {
#pragma unroll
    for (int k = 0; k < kScanN / 4; ++k) {
      const float4 p = Ps[j][cl][k], s = Ss[j][cl][k];
      h[4 * k] = p.x * h[4 * k] + s.x;
      h[4 * k + 1] = p.y * h[4 * k + 1] + s.y;
      h[4 * k + 2] = p.z * h[4 * k + 2] + s.z;
      h[4 * k + 3] = p.w * h[4 * k + 3] + s.w;
    }
  }

  // 3. the segment again from its carry-in: y_t (the sum over n in 4
  // partial sums), D skip and gate; then h_last
  T* __restrict__ yb = static_cast<T*>(a.y) + (int64_t)b * L * d + c;
  for (int t = t0; t < t1; ++t) {
    Step<T, true> cur;
    load_step<T, kVec, true>(a, xb, dtb, zb, Bb, Cb, t, cur);
    const float dx = cur.dt * cur.x;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kScanN; ++i) {
      const float da = exp_of<kExp>(cur.dt * av[i]);
      h[i] = da * h[i] + dx * elem(cur.B, i);
      part[i % 4] += h[i] * elem(cur.C, i);
    }
    float yv = (part[0] + part[1]) + (part[2] + part[3]);
    if (valid) {
      // s6_gate with D[c] read once
      if (a.D != nullptr) yv += dskip * cur.x;
      if (has_z) yv *= apply_silu(cur.z, a.silu_impl);
      yb[(int64_t)t * d] = from_f32<T>(yv);
    }
  }
  if (seg == nseg - 1 && valid) {
    float4* out = reinterpret_cast<float4*>(a.h_last + hidx);
#pragma unroll
    for (int k = 0; k < kScanN / 4; ++k)
      out[k] = make_float4(h[4 * k], h[4 * k + 1], h[4 * k + 2],
                           h[4 * k + 3]);
  }
}

// Segments of time a block: 32 (4 channels a block) while every block of
// the call is resident on the card at once (the 32-segment kernel's
// blocks an SM, as the card's occupancy reports them, times its SMs), 16
// (8 channels, half the blocks) for wider calls, where a second wave of
// 32-segment blocks would cost more than the shorter chain saves.
template <typename T, int kExp, bool kVec>
cudaError_t launch_vec(const ScanArgs& a, int batch, cudaStream_t st) {
  static std::atomic<int> per_sm{0};  // asked of the card once
  int dev = 0, sms = 0, fit = per_sm.load(std::memory_order_relaxed);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && fit == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, selective_scan_kernel<T, kExp, kVec, 32>, kScanThreads, 0);
    per_sm.store(fit, std::memory_order_relaxed);
  }
  if (e != cudaSuccess) return e;
  const int per32 = kScanThreads / 32;  // channels a 32-segment block
  const int64_t blocks32 = (int64_t)batch * ((a.d + per32 - 1) / per32);
  if (blocks32 > (int64_t)fit * sms) {
    const dim3 grid((a.d + kScanThreads / 16 - 1) / (kScanThreads / 16),
                    batch);
    selective_scan_kernel<T, kExp, kVec, 16>
        <<<grid, kScanThreads, 0, st>>>(a);
  } else {
    const dim3 grid((a.d + per32 - 1) / per32, batch);
    selective_scan_kernel<T, kExp, kVec, 32>
        <<<grid, kScanThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int kExp>
cudaError_t launch_exp(const ScanArgs& a, int batch, bool vec,
                       cudaStream_t st) {
  return vec ? launch_vec<T, kExp, true>(a, batch, st)
             : launch_vec<T, kExp, false>(a, batch, st);
}

template <typename T>
cudaError_t launch_scan(const ScanArgs& a, int batch, bool vec, int exp_impl,
                        cudaStream_t st) {
  if (exp_impl == EXP_OURS) return launch_exp<T, EXP_OURS>(a, batch, vec, st);
  if (exp_impl == EXP_FAST) return launch_exp<T, EXP_FAST>(a, batch, vec, st);
  return launch_exp<T, EXP_EXACT>(a, batch, vec, st);
}

// whether B's or C's rows can be read in 16-byte words: the base and every
// row stride a multiple of 16 bytes
static bool rows_of_16_bytes(const void* p, int64_t s_b, int64_t s_t,
                             int64_t esize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s_b * esize) % 16 == 0 &&
         (s_t * esize) % 16 == 0;
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
  if (n != kScanN || batch < 1 || batch > 65535 || L < 1 || d < 1 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const ScanArgs a{x, dt, B, C, z, (const float*)A, (const float*)D,
                   (const float*)h0, y, (float*)h_last, L, d, sx_b, sx_t,
                   sdt_b, sdt_t, sB_b, sB_t, sC_b, sC_t, sz_b, sz_t,
                   silu_impl};
  const int64_t es = dtype == DT_F32 ? 4 : 2;
  const bool vec = rows_of_16_bytes(B, sB_b, sB_t, es) &&
                   rows_of_16_bytes(C, sC_b, sC_t, es);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == DT_F32
          ? launch_scan<float>(a, batch, vec, exp_impl, st)
          : launch_scan<__nv_bfloat16>(a, batch, vec, exp_impl, st);
  return (int)e;
}
