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
// Design: one thread-block cluster of kQCluster = 8 blocks (the portable
// maximum) per (slot, 512-channel group); grid (8 g, slots), 96 blocks at
// mamba-130m and 4 slots, 512 at jamba's d_inner 8192.  Each block owns 64
// channels of its group: 512 threads, 16 lanes per channel as in
// decode_step.cu, 32 channels per pass and 2 passes.  Each thread keeps its
// h' values (and y, for the channel's first lane) in registers; the passes'
// loads are independent, so they are in flight together.  The only thing
// that ties a group's channels together is the absmax of h' that sets the
// new scale: each warp reduces its own (a __shfl_xor_sync max) and pushes
// it into every block of the cluster (lane r stores it into block r's
// shared memory: distributed shared memory, 128 remote stores a block),
// the cluster meets at one barrier, and each warp takes the max of the
// cluster's 128 warp maxima from its own shared memory, 4 a lane, then a
// butterfly.  A max does not depend on the order it is taken in, so every
// block computes the same s_out with update_scale; the cluster's rank 0
// writes scale_new.  h' stays in registers across the barrier and each
// block encodes its own channels with Codes<TQ>, so the f32 state never
// reaches device memory.  Each value's arithmetic is the 12-block design's
// (s6_state_update, s6_contract, s6_gate, update_scale, the encode of h' /
// s_out: all in common.cuh), so y, the payload and the scales are its
// bits.  A block arrives (relaxed) at a first cluster barrier when it
// starts and waits there before its remote stores, so every peer has
// started; after the second it touches no peer, so it may exit at once.
// Lanes past d shadow the last channel and write nothing; blocks whose 64
// channels lie wholly past d (the ragged last group) take part in both
// barriers and write nothing.  The TPU kernel's zero padding gives the
// same absmax.  The launch is cudaLaunchKernelEx with the cluster
// dimension (it captures into a CUDA graph); a refused launch is an error.
#include "common.cuh"

namespace marca {

constexpr int kQN = 16;                          // d_state
constexpr int kQGroup = kScaleGroup;             // state_quant.D_BLOCK
constexpr int kQCluster = 8;   // blocks per group, the portable most
constexpr int kQThreads = 512;
constexpr int kQSpan = kQGroup / kQCluster;      // 64 channels per block
constexpr int kQPerPass = kQThreads / kQN;       // 32 channels per pass
constexpr int kQPasses = kQSpan / kQPerPass;     // 2 passes per block
static_assert(kQPasses * kQPerPass * kQCluster == kQGroup,
              "a cluster covers one scale group");

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

// The cluster's barrier in two halves (PTX barrier.cluster): arrive
// releases this thread's shared-memory writes (relaxed: orders nothing),
// wait acquires the others'; and a store into the same shared-memory
// address of the cluster's block ``rank``.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void store_peer(float* p, unsigned rank, float v) {
  unsigned addr = (unsigned)__cvta_generic_to_shared(p), peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(peer) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(peer), "f"(v)
               : "memory");
}

// the cluster's warp maxima (each block holds all of them) and the ones a
// lane takes: a warp's 32 lanes cover them all
constexpr int kQWarps = kQThreads / 32;
constexpr int kQPeerReads = kQCluster * kQWarps / 32;
static_assert(kQPeerReads * 32 == kQCluster * kQWarps,
              "a warp's lanes read every warp maximum of the cluster");

template <typename T, typename TA, typename TQ>
__global__ void __launch_bounds__(kQThreads)
decode_step_q_kernel(const __grid_constant__ QStepArgs a) {
  __shared__ float warp_amax[kQCluster * kQWarps];
  cluster_arrive_relaxed();  // this block has started
  const TQ* __restrict__ hq = static_cast<const TQ*>(a.hq);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dt = static_cast<const T*>(a.dt);
  const TA* __restrict__ A = static_cast<const TA*>(a.A);
  const T* __restrict__ z = static_cast<const T*>(a.z);
  TQ* __restrict__ hq_new = static_cast<TQ*>(a.hq_new);
  T* __restrict__ y = static_cast<T*>(a.y);

  const int s = threadIdx.x % kQN;
  const int lane_ch = threadIdx.x / kQN;
  const int rank = blockIdx.x % kQCluster;
  const int grp = blockIdx.x / kQCluster;
  const int slot = blockIdx.y;
  const int d = a.d;
  const int c0 = grp * kQGroup + rank * kQSpan;
  const float s_in = a.h_scale[(int64_t)slot * a.g + grp];
  const float bv = to_f32(static_cast<const T*>(a.B)[slot * a.sB + s]);
  const float cv = to_f32(static_cast<const T*>(a.C)[slot * a.sC + s]);
  const bool has_z = z != nullptr;

  // The pass loop has no branch around its loads and stores nothing, so
  // the compiler can issue both passes' loads up front.  Lanes past d
  // shadow the last channel; their values are dropped below.
  float hv[kQPasses], yo[kQPasses];
  float amax = 0.0f;
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
    const int ch = c0 + p * kQPerPass + lane_ch;
    const int c = min(ch, d - 1);
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
    if (ch < d) amax = fmaxf(amax, fabsf(h1));
  }
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
    const int ch = c0 + p * kQPerPass + lane_ch;
    if (s == 0 && ch < d) y[(int64_t)slot * d + ch] = from_f32<T>(yo[p]);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int lane = threadIdx.x & 31;
  cluster_wait();  // every peer has started
  if (lane < kQCluster)
    store_peer(&warp_amax[rank * kQWarps + (threadIdx.x >> 5)], lane, amax);
  cluster_arrive();
  cluster_wait();  // every block's warp maxima are in every block
  float m = warp_amax[lane * kQPeerReads];
#pragma unroll
  for (int r = 1; r < kQPeerReads; ++r)
    m = fmaxf(m, warp_amax[lane * kQPeerReads + r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float so = update_scale(m, s_in, Codes<TQ>::kMax);
  if (rank == 0 && threadIdx.x == 0)
    a.scale_new[(int64_t)slot * a.g + grp] = so;
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
    const int ch = c0 + p * kQPerPass + lane_ch;
    if (ch < d)
      hq_new[((int64_t)slot * d + ch) * kQN + s] =
          Codes<TQ>::encode(__fdiv_rn(hv[p], so));
  }
}

template <typename T, typename TA, typename TQ>
int launch_cluster(dim3 grid, cudaStream_t st, const QStepArgs& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kQCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_step_q_kernel<T, TA, TQ>, a);
}

template <typename T, typename TA>
int launch_q(dim3 grid, cudaStream_t st, int state_dtype,
             const QStepArgs& a) {
  if (state_dtype == SD_INT8) return launch_cluster<T, TA, int8_t>(grid, st, a);
  if (state_dtype == SD_FP8)
    return launch_cluster<T, TA, __nv_fp8_e4m3>(grid, st, a);
  return cudaErrorInvalidValue;
}

}  // namespace marca

// The launch a call of (slots, d) makes: out[0], out[1] the grid, out[2]
// the blocks of a cluster (along x), out[3] the threads of a block.
extern "C" int marca_decode_step_q_shape(int slots, int d, int* out) {
  using namespace marca;
  if (slots < 1 || d < 1) return cudaErrorInvalidValue;
  out[0] = kQCluster * ((d + kQGroup - 1) / kQGroup);
  out[1] = slots;
  out[2] = kQCluster;
  out[3] = kQThreads;
  return 0;
}

// a_scale == nullptr: A is f32; otherwise A is int8 codes and a_scale
// their (d,) f32 per-channel scales.  g must be state_quant.n_groups(d).
// Returns 0 or a CUDA error (a cluster launch the card refuses included).
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
  const dim3 grid(kQCluster * g, slots);
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
