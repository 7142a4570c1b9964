// Causal GQA flash attention (K7) for Hopper, sm_90a.
//
// Replaces: repro/kernels/flash_attention.py:27 _flash_kernel (pallas_call
// at :80, "flash_attention"), run by attention_apply at prefill
// (repro/models/blocks.py:253, attn_impl="pallas"): jamba's attention
// sublayer and, later, the transformer family.
//
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, g]) v[b, j, g]
//   g = h / (hq / hkv),  j <= i + lk - lq when causal (the queries are the
//   suffix of the sequence),  scale = dh^-0.5
//
// with the online softmax in f32 (running max m and sum l, exact expf as
// the TPU kernel's jnp.exp), a masked score of -1e30 as there, and
// o = acc / max(l, 1e-30) in q's type.
//
// Bound on this card: at jamba's prefill (b = 1, L 64..512, hq 32, hkv 8,
// dh 128, bf16) reading q, k, v once and writing o takes 0.4-3 us at 3.35
// TB/s; the 4 L^2/2 dh hq multiply-adds take 0.3-2.2 us at the bf16 tensor
// rate.  Either is far below what this first kernel takes: its products
// run on the f32 pipes, not the tensor cores.
//
// Design, simple and right first: one block of 128 threads per (b, query
// head, 16 queries); each warp owns 4 of the queries.  The block walks the
// key/value tiles of 32 keys up to the causal diagonal of its last query,
// staging each tile in shared memory as f32 (the queries, pre-scaled, stay
// staged for the whole walk).  Lane j scores key j of the tile against the
// warp's 4 queries (float4 reads; the key rows are padded by 4 floats so
// the 8 lanes of a quarter-warp hit distinct banks), the row max and sum
// take warp shuffles, and lane j's probability is broadcast by shuffle
// while each lane accumulates dh/32 output columns.  Keys past lk and past
// the diagonal are masked, so lengths need no multiple of a tile and no
// padded copy.  Tiles wholly above the diagonal are skipped: the TPU kernel
// visits them, but there exp(-1e30 - m) is 0 and the correction 1, so the
// values are the same.  Left for later: mma.sync / wgmma tiles fed by TMA,
// and splitting the key walk of long rows over blocks.
#include "common.cuh"

namespace marca {

constexpr int kFaThreads = 128;
constexpr int kFaWarps = kFaThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kFaBq = kFaWarps * kRowsPerWarp;  // 16 queries per block
constexpr int kFaBk = 32;                       // keys per tile (one warp)
constexpr int kFaMaxDh = 128;
constexpr int kKPad = 4;                        // floats of row padding
constexpr float kFaNegInf = -1e30f;

struct FlashArgs {
  const void* q;  // (b, lq, hq, dh)
  const void* k;  // (b, lk, hkv, dh)
  const void* v;
  void* o;        // (b, lq, hq, dh)
  int lq, lk, hq, hkv, dh;
  float scale;
  int causal;
};

template <typename T>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const FlashArgs a) {
  __shared__ __align__(16) float qs[kFaBq][kFaMaxDh];
  __shared__ __align__(16) float ks[kFaBk][kFaMaxDh + kKPad];
  __shared__ __align__(16) float vs[kFaBk][kFaMaxDh];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kFaBq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.hq / a.hkv);
  const int dh = a.dh;
  const int q_off = a.lk - a.lq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  // the block's queries, scaled as the TPU kernel scales them
  for (int e = threadIdx.x; e < kFaBq * dh; e += kFaThreads) {
    const int r = e / dh, d = e % dh;
    const int i = q0 + r;
    qs[r][d] = i < a.lq
        ? to_f32(q[(((int64_t)b * a.lq + i) * a.hq + h) * dh + d]) * a.scale
        : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kFaMaxDh / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kFaNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int u = 0; u < kFaMaxDh / 32; ++u) acc[r][u] = 0.0f;
  }
  // the keys this block needs: up to the diagonal of its last query
  const int kv_end =
      a.causal ? min(a.lk, q_off + min(q0 + kFaBq, a.lq)) : a.lk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kFaBk) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int e = threadIdx.x; e < kFaBk * dh; e += kFaThreads) {
      const int j = e / dh, d = e % dh;
      const int kj = kv0 + j;
      float kv_k = 0.0f, kv_v = 0.0f;
      if (kj < a.lk) {
        const int64_t idx = (((int64_t)b * a.lk + kj) * a.hkv + g) * dh + d;
        kv_k = to_f32(k[idx]);
        kv_v = to_f32(v[idx]);
      }
      ks[j][d] = kv_k;
      vs[j][d] = kv_v;
    }
    __syncthreads();
    // lane j scores key kv0 + j against the warp's queries
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    for (int d = 0; d < dh; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][d]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(
            &qs[warp * kRowsPerWarp + r][d]);
        s[r] += qq.x * kk.x;
        s[r] += qq.y * kk.y;
        s[r] += qq.z * kk.z;
        s[r] += qq.w * kk.w;
      }
    }
    const int kj = kv0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = q0 + warp * kRowsPerWarp + r;
      const bool ok = kj < a.lk && (!a.causal || kj <= q_off + i);
      const float sv = ok ? s[r] : kFaNegInf;
      float mc = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[r], mc);
      p[r] = expf(sv - m_new);
      const float corr = expf(m[r] - m_new);
      float ps = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = corr * l[r] + ps;
      m[r] = m_new;
#pragma unroll
      for (int u = 0; u < kFaMaxDh / 32; ++u) acc[r][u] *= corr;
    }
    // acc += p . v over the tile's keys, lane owning columns lane + 32u
    for (int j = 0; j < kFaBk; ++j) {
      float vv[kFaMaxDh / 32];
#pragma unroll
      for (int u = 0; u < kFaMaxDh / 32; ++u) {
        const int d = lane + 32 * u;
        vv[u] = d < dh ? vs[j][d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int u = 0; u < kFaMaxDh / 32; ++u) acc[r][u] += pj * vv[u];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + warp * kRowsPerWarp + r;
    if (i >= a.lq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int u = 0; u < kFaMaxDh / 32; ++u) {
      const int d = lane + 32 * u;
      if (d < dh)
        o[(((int64_t)b * a.lq + i) * a.hq + h) * dh + d] =
            from_f32<T>(acc[r][u] / den);
    }
  }
}

}  // namespace marca

// q (b, lq, hq, dh), k and v (b, lk, hkv, dh), o (b, lq, hq, dh), all
// contiguous in the compute type (0 f32, 1 bf16); hq a multiple of hkv; dh
// a multiple of 4 up to 128; with causal, lq <= lk.  Returns 0 or a CUDA
// error.
extern "C" int marca_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int lq, int lk, int hq, int hkv, int dh,
                                     float scale, int causal, int dtype,
                                     void* stream) {
  using namespace marca;
  if (batch < 1 || lq < 1 || lk < 1 || hq < 1 || hkv < 1 || hq % hkv ||
      dh < 4 || dh > kFaMaxDh || dh % 4 || (causal && lq > lk) ||
      batch > 65535 || hq > 65535)
    return cudaErrorInvalidValue;
  const FlashArgs a{q, k, v, o, lq, lk, hq, hkv, dh, scale, causal};
  const dim3 grid((lq + kFaBq - 1) / kFaBq, hq, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    flash_attention_kernel<float><<<grid, kFaThreads, 0, st>>>(a);
  } else if (dtype == DT_BF16) {
    flash_attention_kernel<__nv_bfloat16><<<grid, kFaThreads, 0, st>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
