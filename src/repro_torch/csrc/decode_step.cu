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
// Bound on this card: bytes.  A call reads the pooled f32 state h and
// writes h' (slots * d * 64 bytes each) and reads A (d * 64 bytes f32,
// d * 16 int8); x, dt, z, B, C and D add little, and the arithmetic is a
// few operations per state element.  At 3.35 TB/s the bytes take 0.28 us
// at 4 slots of mamba-130m, 0.94 at mamba-2.8b's d_inner 5120, 1.50 at
// jamba's 8192 and 5.49 at 8192 with 16 slots.  Measured on an H100
// (scripts/torch_k1.py, bf16, CUDA graph): at this launch shape a kernel
// that does nothing takes 1.1 us and one that only copies h to h' 1.4 us
// with h in L2 (1.8 from device memory); this kernel 1.8 (2.3) at
// mamba-130m, where the chain of dependent instructions after the loads
// sets the rest, and 7.2 us from device memory at 8192 x 16 slots, 76% of
// the byte bound.
//
// Design: 4 lanes a channel, 4 consecutive states a lane, 32 channels a
// block of 128 threads, one block a (32 channels, slot).  Each lane moves
// h, A and h' in one 16-byte word each (int8 A: one 4-byte word of
// codes), so one warp instruction covers 512 contiguous bytes of h; x,
// dt, z and D are one broadcast load for the 4 lanes, B and C 4 scalar
// loads a lane (their rows may start 2-byte aligned).  Every load is
// issued before the first arithmetic, so a call makes one trip to memory.
// The sum over the states runs in the order of the 16-lane butterfly (one
// state a lane) of the first design, and the state update and the gate
// are pinned to the rounding that design compiled to, so y and h' keep
// its bits.  h is read in the pool's (slots, d, n) layout and h' written
// to an output the wrapper allocates; h, A and h' must start on a 16-byte
// boundary (the wrapper checks them, and so does the entry point).
// Masking of inactive slots stays with the caller, as in repro.  Row
// strides for x, dt, z, B and C let the block pass its strided views
// without a copy.
#include "common.cuh"

namespace marca {

constexpr int kStepN = 16;
constexpr int kStepLanes = 4;      // lanes a channel, 4 states a lane
constexpr int kStepThreads = 128;  // 32 channels a block
constexpr int kStepChannels = kStepThreads / kStepLanes;

// A's 4 entries of one lane as loaded: one 16-byte load of f32, or one
// 4-byte load of int8 codes; a_values gives the values the step consumes
// (load_w's: the codes times the channel's scale, one rounded multiply)
__device__ __forceinline__ float4 load_a4(const float* A, int64_t idx) {
  return *reinterpret_cast<const float4*>(A + idx);
}
__device__ __forceinline__ char4 load_a4(const int8_t* A, int64_t idx) {
  return *reinterpret_cast<const char4*>(A + idx);
}
__device__ __forceinline__ void a_values(float4 v, float, float a[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
__device__ __forceinline__ void a_values(char4 v, float s, float a[4]) {
  a[0] = __fmul_rn((float)v.x, s);
  a[1] = __fmul_rn((float)v.y, s);
  a[2] = __fmul_rn((float)v.z, s);
  a[3] = __fmul_rn((float)v.w, s);
}

// s6_state_update with the rounding the 16-lane design compiled it to
// (its SASS: exp(dt a) h rounded, then one FMA of B and dt x onto it),
// pinned so that the unrolled 4-state loop keeps the same bits
__device__ __forceinline__ float state_update(float h, float dt, float dtx,
                                             float a, float b,
                                             int exp_impl) {
  return __fmaf_rn(b, dtx,
                   __fmul_rn(apply_exp(__fmul_rn(dt, a), exp_impl), h));
}

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
  const int lane = threadIdx.x % kStepLanes;
  const int ch = blockIdx.x * kStepChannels + threadIdx.x / kStepLanes;
  const int slot = blockIdx.y;
  const bool valid = ch < d;
  const int c = valid ? ch : d - 1;
  const int s0 = lane * 4;
  const bool has_z = z != nullptr;

  // Every load is issued before any arithmetic, so a call makes one trip
  // to memory: left to itself nvcc put each load beside its first use
  // (B and C after the wait for h and A, each in its own arm of the exp
  // switch).  The empty asm keeps them in this order.
  const int64_t hidx = ((int64_t)slot * d + c) * kStepN + s0;
  const float4 h4 = *reinterpret_cast<const float4*>(h + hidx);
  const auto a_raw = load_a4(A, (int64_t)c * kStepN + s0);
  const float as = a_scale != nullptr ? a_scale[c] : 0.0f;
  const T xr = x[slot * sx + c];
  const T dtr = dt[slot * sdt + c];
  const T zr = has_z ? z[slot * sz + c] : from_f32<T>(0.0f);
  const float dv = D != nullptr ? D[c] : 0.0f;
  T br[4], cr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    br[i] = B[slot * sB + s0 + i];
    cr[i] = C[slot * sC + s0 + i];
  }
  asm volatile("" ::: "memory");

  float a[4];
  a_values(a_raw, as, a);
  const float xv = to_f32(xr);
  const float dtv = to_f32(dtr);
  const float dtx = __fmul_rn(dtv, xv);
  float hv[4] = {h4.x, h4.y, h4.z, h4.w};
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hv[i] = state_update(hv[i], dtv, dtx, a[i], to_f32(br[i]), exp_impl);
    p[i] = __fmul_rn(hv[i], to_f32(cr[i]));
  }
  // the sum over the 16 states in group_sum<16>'s order (xor 8, 4, 2, 1
  // over one state a lane): states s and s^8 sit on lanes l and l^2, s
  // and s^4 on lanes l and l^1, s and s^2 or s^1 in the same lane
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __fadd_rn(p[i], __shfl_xor_sync(0xffffffffu, p[i], 2));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __fadd_rn(p[i], __shfl_xor_sync(0xffffffffu, p[i], 1));
  float yv = __fadd_rn(__fadd_rn(p[0], p[2]), __fadd_rn(p[1], p[3]));
  if (!valid) return;
  *reinterpret_cast<float4*>(h_new + hidx) =
      make_float4(hv[0], hv[1], hv[2], hv[3]);
  if (lane == 0) {
    // s6_gate, its multiply-add pinned as the 16-lane design compiled it
    if (D != nullptr) yv = __fmaf_rn(dv, xv, yv);
    if (has_z) yv = __fmul_rn(yv, apply_silu(to_f32(zr), silu_impl));
    y[(int64_t)slot * d + c] = from_f32<T>(yv);
  }
}

inline dim3 step_grid(int slots, int d) {
  return dim3((d + kStepChannels - 1) / kStepChannels, slots);
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
  // h, A and h' move in 16-byte words (the wrapper checks it too)
  if (((uintptr_t)h | (uintptr_t)A | (uintptr_t)h_new) % 16)
    return cudaErrorMisalignedAddress;
  const dim3 grid = step_grid(slots, d);
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

// the launch marca_decode_step makes for (slots, d): out = {grid.x,
// grid.y, threads of a block}
extern "C" int marca_decode_step_shape(int slots, int d, void* out) {
  if (slots < 1 || slots > 65535 || d < 1) return cudaErrorInvalidValue;
  const dim3 grid = marca::step_grid(slots, d);
  int* o = static_cast<int*>(out);
  o[0] = grid.x;
  o[1] = grid.y;
  o[2] = marca::kStepThreads;
  return 0;
}
