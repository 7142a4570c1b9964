// The MARCA nonlinear units standalone (paper §5, the EXP-RCU and SiLU-RCU
// modes), for Hopper, sm_90a.
//
// Replaces: repro/kernels/fast_exp.py:26 _fast_exp_kernel (K8, pallas_call
// at :41) and repro/kernels/piecewise_silu.py:26 _silu_kernel (K9,
// pallas_call at :41): element-wise over a contiguous tensor, f32 or bf16,
// computed in f32 and rounded once to the input's type.  Every result
// equals the plain PyTorch version's bit for bit: the same rounded
// operations (__fmul_rn / __fadd_rn, never a contracted FMA) on the same
// f32 constants, __float2int_rz for the truncating cast.
//
// Bound on this card: bytes.  Each element is read once and written once
// (8 bytes in f32, 4 in bf16): 16 M bf16 elements take at least 20 us at
// 3.35 TB/s, and the card has to keep about 2 MB in flight to reach that.
//
// Design.
// - Memory: each thread moves 16-byte vectors (4 f32 or 8 bf16) and issues
//   both loads of its chunk before it computes either vector; loads and
//   stores carry the streaming hint (ld/st.global.cs), since nothing reads
//   x or y again.  One block a chunk of kUnitThreads x kUnitVecs vectors,
//   indexed within the block in 32 bits (a persistent grid walking the
//   chunks, with or without the next chunk's loads issued ahead, was 3-8%
//   slower in f32).  The kernel is held to 32 registers, so 8 blocks (2048
//   threads) fit an SM: with more, the compiler interleaves the 16 bf16
//   elements of "ours" into 78 registers and the SM runs too few warps to
//   keep the bytes in flight (uncapped, a 40-register cap, 1 and 4
//   vectors a thread were each no faster on the H100; PERF.md §6).
// - Ragged and unaligned inputs in the same launch: the elements before
//   the first 16-byte boundary of x and after the last whole vector go
//   through a scalar grid-stride loop; where x and y are aligned
//   differently (a view at an odd offset beside a fresh output) that loop
//   takes every element.
// - Arithmetic: K8 is a handful of instructions (fast_exp of common.cuh).
//   K9 detects the range first, as the SiLU-RCU does, and evaluates one
//   polynomial: "ours" counts the breaks at or below x (the >= / > tests
//   and break constants of silu_ours) and reads that segment's three
//   coefficients from shared memory (three conflict-free 4-byte reads; a
//   __constant__ table read at lane-divergent indices would serialize),
//   then runs one quad(); "paper" selects its segment's constants and runs
//   one p * (t * w) + q with t = x + h, which is each of silu_paper's
//   segments with the same rounded operations (h 0 and w 1 are exact).
//   common.cuh's silu_ours / silu_paper stay as the other kernels use
//   them.
#include "common.cuh"

namespace marca {

constexpr int kUnitThreads = 256;
constexpr int kUnitVecs = 2;
constexpr int kUnitChunk = kUnitThreads * kUnitVecs;  // vectors a chunk
constexpr int kUnitMinBlocks = 8;  // blocks an SM: 32 registers a thread

enum UnitOp { U_EXP = 0, U_SILU_OURS = 1, U_SILU_PAPER = 2 };

// K9 "ours" by segment: row s holds (a2, a1, a0) of the segment that
// starts at the s-th break (SILU_COEFS[s - 1]); row 0 is below -9 and NaN
__constant__ float kSiluOursTable[7][3] = {
    {0.0f, 0.0f, 0.0f},
    {-0.0026606f, -0.0442494f, -0.1855941f},  // [-9, -5)
    {-0.0117359f, -0.1503727f, -0.4880836f},  // [-5, -1.5)
    {0.2163049f, 0.4986513f, 0.0058849f},     // [-1.5, 0.75)
    {0.0813905f, 0.7826839f, -0.1309739f},    // [0.75, 2.25)
    {-0.0164214f, 1.1849977f, -0.5492407f},   // [2.25, 4.5)
    {-0.0033375f, 1.0541269f, -0.2208955f},   // [4.5, 9]
};

// the coefficients by row, in shared memory: three arrays read by LDS.32
// (3 registers an element, where a float4 row takes 4)
struct OursTable {
  float a2[8], a1[8], a0[8];
};

__device__ __forceinline__ float silu_ours_rd(float x, const OursTable* t) {
  const int s = (x >= -9.0f) + (x >= -5.0f) + (x >= -1.5f) + (x >= 0.75f) +
                (x >= 2.25f) + (x >= 4.5f);
  // rows 1-6 see x itself (x >= -9 there); row 0's zeros see -9 in place
  // of x < -9, -inf or NaN, and give +0.0
  const float y = quad(fmaxf(x, -9.0f), t->a2[s], t->a1[s], t->a0[s]);
  return x > 9.0f ? x : y;
}

// silu_paper's segments: x < -5 the constant; [-5, -1.5) and above 0.75
// (NaN too, as the if-chain) p * x + q; [-1.5, 0.75] p * (x + h)^2 + q
__device__ __forceinline__ float silu_paper_rd(float x) {
  const bool lo = x < -5.0f, mid = !(x < -1.5f), hi = !(x <= 0.75f);
  const bool sq = mid && !hi;
  const float t = __fadd_rn(x, sq ? 1.181f : 0.0f);
  const float w = sq ? t : 1.0f;
  const float p = hi ? 1.05f : (mid ? 0.232f : -0.06244f);
  const float q = hi ? -0.2781f : (mid ? -0.275f : -0.3457f);
  const float y = __fadd_rn(__fmul_rn(p, __fmul_rn(t, w)), q);
  return lo ? -0.0135f : y;
}

template <int kOp>
struct Unit {
  float bias, c;         // the exp's
  const OursTable* tab;  // "ours"' segments, in shared memory
  __device__ __forceinline__ float operator()(float v) const {
    if constexpr (kOp == U_EXP) return fast_exp(v, bias, c);
    else if constexpr (kOp == U_SILU_OURS) return silu_ours_rd(v, tab);
    else return silu_paper_rd(v);
  }
};

// the unit on each element of a 16-byte vector: 4 f32, or 8 bf16 (bf16 to
// f32 is the 16 bits shifted up; each pair rounds back in one cvt.rn)
template <int kOp>
__device__ __forceinline__ unsigned unit_bf16x2(unsigned u,
                                                const Unit<kOp>& f) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      f(__uint_as_float(u << 16)), f(__uint_as_float(u & 0xffff0000u)));
  return *reinterpret_cast<const unsigned*>(&r);
}

template <typename T, int kOp>
__device__ __forceinline__ uint4 unit_vec(uint4 v, const Unit<kOp>& f) {
  if constexpr (sizeof(T) == 4)
    return make_uint4(__float_as_uint(f(__uint_as_float(v.x))),
                      __float_as_uint(f(__uint_as_float(v.y))),
                      __float_as_uint(f(__uint_as_float(v.z))),
                      __float_as_uint(f(__uint_as_float(v.w))));
  else
    return make_uint4(unit_bf16x2(v.x, f), unit_bf16x2(v.y, f),
                      unit_bf16x2(v.z, f), unit_bf16x2(v.w, f));
}

// a chunk's vectors of this thread: all loads issued, then each computed
// and stored
__device__ __forceinline__ void load_chunk(uint4 (&r)[kUnitVecs],
                                           const uint4* src) {
#pragma unroll
  for (int j = 0; j < kUnitVecs; ++j)
    r[j] = __ldcs(src + j * kUnitThreads + threadIdx.x);
}

template <typename T, int kOp>
__device__ __forceinline__ void store_chunk(uint4* dst,
                                            const uint4 (&r)[kUnitVecs],
                                            const Unit<kOp>& f) {
#pragma unroll
  for (int j = 0; j < kUnitVecs; ++j)
    __stcs(dst + j * kUnitThreads + threadIdx.x, unit_vec<T>(r[j], f));
}

// x, y: n elements; the vector body is the nvec 16-byte vectors from
// element head on (x + head and y + head both 16-byte aligned); the rest,
// nrest = n - nvec * kPer elements, goes through the scalar loop
template <typename T, int kOp>
__global__ void __launch_bounds__(kUnitThreads, kUnitMinBlocks)
unit_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
            int64_t head, int64_t nvec, float bias, float c) {
  constexpr int kPer = 16 / sizeof(T);
  __shared__ OursTable tab;
  if constexpr (kOp == U_SILU_OURS) {
    if (threadIdx.x < 7) {
      tab.a2[threadIdx.x] = kSiluOursTable[threadIdx.x][0];
      tab.a1[threadIdx.x] = kSiluOursTable[threadIdx.x][1];
      tab.a0[threadIdx.x] = kSiluOursTable[threadIdx.x][2];
    }
    __syncthreads();
  }
  const Unit<kOp> f{bias, c, &tab};

  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  const int64_t nfull = nvec / kUnitChunk;
  uint4 r[kUnitVecs];
  for (int64_t ch = blockIdx.x; ch < nfull; ch += gridDim.x) {
    load_chunk(r, xv + ch * kUnitChunk);
    store_chunk<T>(yv + ch * kUnitChunk, r, f);
  }
  // the last chunk, partly full
  const int left = (int)(nvec - nfull * kUnitChunk);
  if (left && blockIdx.x == nfull % gridDim.x) {
    const uint4* src = xv + nfull * kUnitChunk;
    uint4* dst = yv + nfull * kUnitChunk;
#pragma unroll
    for (int j = 0; j < kUnitVecs; ++j) {
      const int i = j * kUnitThreads + threadIdx.x;
      if (i < left) r[j] = __ldcs(src + i);
    }
#pragma unroll
    for (int j = 0; j < kUnitVecs; ++j) {
      const int i = j * kUnitThreads + threadIdx.x;
      if (i < left) __stcs(dst + i, unit_vec<T>(r[j], f));
    }
  }

  // the scalar rest: [0, head) and [head + nvec * kPer, n)
  const int64_t tail0 = head + nvec * kPer;
  const int64_t nrest = n - nvec * kPer;
  for (int64_t i = (int64_t)blockIdx.x * kUnitThreads + threadIdx.x;
       i < nrest; i += (int64_t)gridDim.x * kUnitThreads) {
    const int64_t e = i < head ? i : tail0 + (i - head);
    y[e] = from_f32<T>(f(to_f32(x[e])));
  }
}

template <typename T, int kOp>
int unit_launch(const void* xp, void* yp, int64_t n, float bias, float c,
                cudaStream_t st) {
  constexpr int kPer = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x) & 15;
  const uintptr_t ay = reinterpret_cast<uintptr_t>(y) & 15;
  int64_t head = 0, nvec = 0;
  if (ax == ay) {
    head = (int64_t)((16 - ax) & 15) / (int64_t)sizeof(T);
    if (head > n) head = n;
    nvec = (n - head) / kPer;
  }
  const int64_t nrest = n - nvec * kPer;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (nvec + kUnitChunk - 1) / kUnitChunk;
  // the scalar loop: enough blocks for its elements, at most a full SM's
  int64_t rest_blocks = (nrest + kUnitThreads - 1) / kUnitThreads;
  const int64_t rest_cap = (int64_t)sms * kUnitMinBlocks;
  if (rest_blocks > rest_cap) rest_blocks = rest_cap;
  if (blocks < rest_blocks) blocks = rest_blocks;
  if (blocks < 1) blocks = 1;
  unit_kernel<T, kOp><<<(unsigned)blocks, kUnitThreads, 0, st>>>(
      x, y, n, head, nvec, bias, c);
  return (int)cudaGetLastError();
}

template <int kOp>
int unit_dispatch(const void* x, void* y, int64_t n, int dtype, float bias,
                  float c, void* stream) {
  if (n < 1 || (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == DT_F32
             ? unit_launch<float, kOp>(x, y, n, bias, c, st)
             : unit_launch<__nv_bfloat16, kOp>(x, y, n, bias, c, st);
}

}  // namespace marca

// y = fast_exp(x) element-wise: bias = (127 + b_shift) * 2^23 and c as f32;
// x, y contiguous, n elements, dtype 0 f32 / 1 bf16.  Returns 0 or a CUDA
// error.
extern "C" int marca_fast_exp(const void* x, void* y, int64_t n, int dtype,
                              float bias, float c, void* stream) {
  return marca::unit_dispatch<marca::U_EXP>(x, y, n, dtype, bias, c, stream);
}

// y = piecewise SiLU(x) element-wise, variant 0 "ours" / 1 "paper"; x, y
// contiguous, n elements, dtype 0 f32 / 1 bf16.  Returns 0 or a CUDA error.
extern "C" int marca_piecewise_silu(const void* x, void* y, int64_t n,
                                    int dtype, int paper, void* stream) {
  using namespace marca;
  return paper ? unit_dispatch<U_SILU_PAPER>(x, y, n, dtype, 0.0f, 0.0f,
                                             stream)
               : unit_dispatch<U_SILU_OURS>(x, y, n, dtype, 0.0f, 0.0f,
                                            stream);
}
