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
// with the online softmax in f32 (running max m and sum l), a masked score
// of -1e30 as there, and o = acc / max(l, 1e-30) in q's type.  Tiles wholly
// above the diagonal are skipped: the TPU kernel visits them, but there
// exp(-1e30 - m) is 0 and the correction 1, so the values are the same.
// No atomics and no split of the key walk: a launch repeats bit for bit.
//
// Bound on this card: at jamba's prefill (b = 1, L 64..512, hq 32, hkv 8,
// dh 128, bf16) reading q, k, v once and writing o takes 0.4-3 us at 3.35
// TB/s; the 4 L^2/2 dh hq multiply-adds take 0.3-2.2 us at the bf16 tensor
// rate.  Both are below a launch's latency at L 64 and 127.
//
// Two instantiations:
//
// bf16: the tensor cores (flash_attention_tc).  A query tile is 64 rows of
// (query position, head) pairs, position-major, over every query head that
// shares one KV head (P of them, the largest power of two dividing hq / hkv,
// at most 64), so each K/V tile is fetched once for the P heads. One
// consumer warpgroup per query tile computes S = Q K^T with wgmma (Q and K
// from shared memory, both K-major), the online softmax on S in registers,
// and O += P V with wgmma, P converted to bf16 in registers as the A operand
// (the S accumulator's layout is the A fragment's) and V as the B operand in
// its stored (keys x dh) order through wgmma's transpose bit: no copy of V
// is made.  The scale, times log2(e), multiplies S in f32, and the softmax
// runs in base 2 on the special-function unit (a masked score is -1e30
// there); o is acc times the reciprocal of max(l, 1e-30).  A warpgroup
// issues S of tile t and then P V of tile t-1 together, and runs the softmax
// of S(t) while the tensor cores finish P V; the correction then rescales O.
// One producer warp keeps the next K and V tiles of 64 keys in flight with
// TMA into a ring of three stages (mbarriers: full per K and per V tile,
// empty per stage), so tile t+1 loads while a warpgroup holds tiles t-1 and
// t. q, k and v are described by 5-D / 4-D tensor maps over their (b, l,
// heads, dh) layout, a head's rows strided by heads * dh, with 128-byte
// swizzle (the mode in the wgmma descriptors); a head dim under 64 or
// between 64 and 128 is padded with the zeros TMA fills past the tensor's
// edge (dh 16 runs as 64), and so are rows past lq or lk.
//
// Grid: the causal walk of query tile j grows with j, so where that still
// gives 128 blocks a block holds two consumer warpgroups on tiles x and
// N-1-x of one KV head (one light, one heavy: every block walks about
// N/2 + 1 K/V tiles, and the light one's warpgroup leaves the tensor
// cores to the other once done); otherwise one warpgroup on tile N-1-x
// (heavier tiles launch first).  At jamba's shapes (P = 4, 16 positions a
// tile): L = 512 runs 16 x 8 = 128 blocks of two tiles; L = 127 runs
// 8 x 8 = 64 blocks of one, L = 64 4 x 8 = 32.  Shared memory at dh 128:
// 16 KB of Q a tile and three stages of K and V (16 KB each), 128 KB with
// two tiles.
//
// f32: the SIMT kernel (flash_attention_kernel), kept as it is.  On the
// tensor cores f32 would run as TF32 (10 mantissa bits) and miss the 2e-5
// the f32 tolerance holds.  One block of 128 threads per (b, query head, 16
// queries); each warp owns 4 of the queries.  The block walks the key/value
// tiles of 32 keys up to the causal diagonal of its last query, staging
// each tile in shared memory as f32 (the queries, pre-scaled, stay staged
// for the whole walk).  Lane j scores key j of the tile against the warp's
// 4 queries (float4 reads; the key rows are padded by 4 floats so the 8
// lanes of a quarter-warp hit distinct banks), the row max and sum take
// warp shuffles, and lane j's probability is broadcast by shuffle while
// each lane accumulates dh/32 output columns.
#include "common.cuh"

#include <cuda.h>

namespace marca {

// ---------------------------------------------------------------------------
// f32: the SIMT kernel
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcBn = 64;      // keys per K/V tile
constexpr int kTcStages = 3;   // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

struct FlashTcArgs {
  void* o;  // (b, lq, hq, dh) bf16
  int lq, lk, hq, dh;
  int pack_shift;  // log2(P), P the query heads of a KV head in a tile
  int group;       // hq / hkv
  int q_tiles;     // 64-row query tiles: ceil(lq / (64 / P))
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive, and expect this many bytes of copies to land before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.  A
// transfer that never lands (a bad tensor map) traps after some 10 s
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A wgmma shared-memory operand in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
// Every tile starts on a 1024-byte boundary (one swizzle atom: 8 rows of
// 128 bytes), so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving a register's reads and writes across the
// asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 64) += A (64 x 16, K-major in shared memory) . B (64 x 16,
// K-major in shared memory)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// S (64 x 64) = A (64 x 16, K-major in shared memory) . B (64 x 16,
// K-major in shared memory)^T, the accumulator not read (scale-d false):
// the first step of a product, whose registers the softmax of the last
// tile wrote while other products were in flight
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// O (64 x 64) += A (64 x 16 in registers) . B (16 x 64, MN-major in
// shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += A (64 x 16 in registers) . B (16 x 128, MN-major in
// shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DHP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DHP / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NWG, int DHP>
constexpr int tc_smem_bytes() {
  // Q, the K and V rings, the barriers, and slack to align to 1024 bytes
  return NWG * 64 * DHP * 2 + 2 * kTcStages * kTcBn * DHP * 2 + 128 + 1024;
}

// S = Q K^T for one K tile: the head dim 16 at a time, column block kk / 4,
// 32 bytes into its 128-byte rows per step.  Issued, not waited for.
template <int DHP, int Q_CB>
__device__ __forceinline__ void issue_qk(float (&s)[kTcBn / 2], uint32_t sq,
                                         uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = sw128_desc(sq + (kk >> 2) * Q_CB + off, 16, 1024);
    const uint64_t db =
        sw128_desc(sk + (kk >> 2) * kTcBn * 128 + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_n64_first(s, da, db);
    else
      wgmma_ss_n64(s, da, db);
  }
  wgmma_commit();
}

// O += P V for one V tile: V's 16-key slabs (2048 bytes) in turn,
// MN-major, the leading offset stepping between 64-column blocks and the
// stride offset between 8-key groups.  Issued, not waited for.
template <int DHP>
__device__ __forceinline__ void issue_pv(float (&o)[DHP / 2],
                                         const uint32_t (&p)[kTcBn / 16][4],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < kTcBn / 16; ++kk)
    wgmma_pv<DHP>(o, p[kk], sw128_desc(sv + kk * 16 * 128, kTcBn * 128,
                                       1024));
  wgmma_commit();
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile, for this thread's two rows (a quad of
// lanes shares a row), in the base-2 domain: v = s * scale * log2(e) in
// f32, a masked key's v is -1e30 (only on a tile that needs a mask),
// p = 2^(v - m) = exp(scale s - m ln 2) in place, this lane's share of l,
// and each row's correction 2^(m_old - m_new).
__device__ __forceinline__ void online_softmax(
    float (&s)[kTcBn / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool masked, int kv0, const int (&last_key)[2], float scale_log2,
    int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -1e30f;
#pragma unroll
    for (int c = 0; c < kTcBn / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[4 * c + 2 * h + e] * scale_log2;
        if (masked && kv0 + 8 * c + 2 * (lane & 3) + e > last_key[h])
          v = -1e30f;
        s[4 * c + 2 * h + e] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kTcBn / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(s[4 * c + 2 * h + e] - m_new);
        s[4 * c + 2 * h + e] = p;
        sum += p;
      }
    }
    l[h] = l[h] * corr[h] + sum;
  }
}

// P as bf16 A fragments: keys 16 kk .. + 15 are S's chunks 2 kk and
// 2 kk + 1, in the order {row r, row r + 8} x {chunk 2 kk, 2 kk + 1}
__device__ __forceinline__ void pack_p(const float (&s)[kTcBn / 2],
                                       uint32_t (&p)[kTcBn / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcBn / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// NWG consumer warpgroups and one producer warp; DHP the head dim padded
// to 64 or 128 (one or two 128-byte column blocks).  Each warpgroup takes
// its own query tile of 64 rows (64 / P positions x P heads) of one KV
// head: with NWG 1 the block's tile is the x-th from the end (heavier
// tiles first), with NWG 2 the block pairs tile x with tile N-1-x, so
// every block walks about the same number of K/V tiles.  The warpgroups
// walk the same K/V prefix; one whose tile needs fewer K/V tiles (or that
// has none: the middle of an odd N) only acknowledges the rest.
template <int NWG, int DHP>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const FlashTcArgs a) {
  constexpr int NCB = DHP / 64;         // 128-byte column blocks
  constexpr int Q_CB = 64 * 128;        // bytes of a column block of Q
  constexpr int Q_WG = NCB * Q_CB;      // ... of a warpgroup's Q tile
  constexpr int KV_CB = kTcBn * 128;    // ... of a column block of K or V
  constexpr int KV_BYTES = NCB * KV_CB;
  constexpr int S = kTcStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + NWG * Q_WG;  // + stage * KV_BYTES
  const uint32_t sv = sk + S * KV_BYTES;
  // barriers: Q's, then per stage K full, V full, and empty (the stage's
  // K and V released by every consumer warp)
  const uint32_t bar_q = sv + S * KV_BYTES;
  const auto k_full = [&](int st) { return bar_q + 8 * (1 + st); };
  const auto v_full = [&](int st) { return bar_q + 8 * (1 + S + st); };
  const auto empty = [&](int st) { return bar_q + 8 * (1 + 2 * S + st); };

  const int pos_per_tile = 64 >> a.pack_shift;
  const int hg = blockIdx.y, b = blockIdx.z;
  const int pack = 1 << a.pack_shift;
  const int g = (hg * pack) / a.group;  // the KV head
  const int q_off = a.lk - a.lq;
  // each warpgroup's query tile (-1: none), first position and K/V tiles
  int jt[NWG], i0[NWG], n_w[NWG], n_tiles = 0;
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    const int x = blockIdx.x;
    jt[w] = NWG == 1 ? a.q_tiles - 1 - x
                     : (w == 0 ? x : (a.q_tiles - 1 - x > x ? a.q_tiles - 1 - x
                                                            : -1));
    i0[w] = jt[w] * pos_per_tile;
    const int i_last = min(i0[w] + pos_per_tile, a.lq) - 1;
    const int kv_end = a.causal ? min(a.lk, q_off + i_last + 1) : a.lk;
    n_w[w] = jt[w] < 0 ? 0 : (kv_end + kTcBn - 1) / kTcBn;
    n_tiles = max(n_tiles, n_w[w]);
  }
  // the warp index as a warp-uniform value, so the compiler knows each
  // warpgroup's branches (and the products in them) are convergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // the producer: the Q tiles once, then K and V tile by tile into the
    // ring
    if (lane == 0) {
      int q_bytes = 0;
#pragma unroll
      for (int w = 0; w < NWG; ++w) q_bytes += jt[w] < 0 ? 0 : Q_WG;
      mbar_expect_tx(bar_q, q_bytes);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        if (jt[w] < 0) continue;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_5d(sq + w * Q_WG + cb * Q_CB, &tq, bar_q, cb * 64, 0, hg,
                      i0[w], b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % S;
        if (t >= S) mbar_wait(empty(st), ((t / S) + 1) & 1);
        mbar_expect_tx(k_full(st), KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_4d(sk + st * KV_BYTES + cb * KV_CB, &tk, k_full(st),
                      cb * 64, g, t * kTcBn, b);
        mbar_expect_tx(v_full(st), KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_4d(sv + st * KV_BYTES + cb * KV_CB, &tv, v_full(st),
                      cb * 64, g, t * kTcBn, b);
      }
    }
    return;
  }

  // a consumer warpgroup; this thread holds rows r and r + 8 of its
  // warp's 16 (the wgmma accumulator layout: row lane / 4 (+ 8), columns
  // 8 c + 2 (lane % 4) (+ 1) of each 8-column chunk c)
  const int wg = warp >> 2;
  int my_tiles = n_w[0], my_i0 = i0[0];  // (no array indexed at run time)
#pragma unroll
  for (int w = 1; w < NWG; ++w) {
    if (wg == w) {
      my_tiles = n_w[w];
      my_i0 = i0[w];
    }
  }
  const int r0 = (warp & 3) * 16 + (lane >> 2);
  const uint32_t sq_wg = sq + wg * Q_WG;
  int qi[2], last_key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = my_i0 + ((r0 + 8 * h) >> a.pack_shift);
    last_key[h] = a.causal ? min(a.lk - 1, qi[h] + q_off) : a.lk - 1;
  }
  const auto needs_mask = [&](int kv0) {
    return (a.causal && kv0 + kTcBn - 1 > q_off + my_i0) ||
           kv0 + kTcBn > a.lk;
  };
  const float scale_log2 = a.scale * kLog2e;
  const auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  if (my_tiles > 0) {
    float o_acc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o_acc[i] = 0.0f;
    float s_acc[kTcBn / 2];  // written whole by each tile's first step
    float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.0f, 0.0f}, corr[2];
    uint32_t p_cur[kTcBn / 16][4];

    // tile 0: S, then its softmax (O is still 0: no correction)
    mbar_wait(bar_q, 0);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_qk<DHP, Q_CB>(s_acc, sq_wg, sk);
    wgmma_wait<0>();
    fence_regs(s_acc);
    online_softmax(s_acc, m_r, l_r, corr, needs_mask(0), 0, last_key,
                   scale_log2, lane);
    pack_p(s_acc, p_cur);
    // tile t: S(t) and then O += P(t-1) V(t-1) are issued together; the
    // softmax of S(t) runs while the tensor cores finish P V, and the
    // correction is applied to O once P V has landed
    for (int t = 1; t < my_tiles; ++t) {
      const int st = t % S, sp = (t - 1) % S;
      mbar_wait(k_full(st), (t / S) & 1);
      fence_regs(o_acc);
      wgmma_fence();
      issue_qk<DHP, Q_CB>(s_acc, sq_wg, sk + st * KV_BYTES);
      mbar_wait(v_full(sp), ((t - 1) / S) & 1);
      issue_pv<DHP>(o_acc, p_cur, sv + sp * KV_BYTES);
      wgmma_wait<1>();
      fence_regs(s_acc);
      online_softmax(s_acc, m_r, l_r, corr, needs_mask(t * kTcBn),
                     t * kTcBn, last_key, scale_log2, lane);
      wgmma_wait<0>();
      fence_regs(o_acc);
      release(sp);
#pragma unroll
      for (int c = 0; c < DHP / 8; ++c) {
        o_acc[4 * c] *= corr[0];
        o_acc[4 * c + 1] *= corr[0];
        o_acc[4 * c + 2] *= corr[1];
        o_acc[4 * c + 3] *= corr[1];
      }
      // P(t) is packed only now: registers a product reads are written
      // while no product is in flight, or ptxas serializes the products
      pack_p(s_acc, p_cur);
    }
    // the last tile's P V
    const int sl = (my_tiles - 1) % S;
    mbar_wait(v_full(sl), ((my_tiles - 1) / S) & 1);
    fence_regs(o_acc);
    wgmma_fence();
    issue_pv<DHP>(o_acc, p_cur, sv + sl * KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o_acc);
    release(sl);

    // o = acc / max(l, 1e-30) (a multiply by the row's reciprocal); rows
    // past lq and columns past dh are not stored
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / fmaxf(l, 1e-30f);
      if (qi[h] >= a.lq) continue;
      const int head = hg * pack + ((r0 + 8 * h) & (pack - 1));
      __nv_bfloat16* orow =
          o + (((int64_t)b * a.lq + qi[h]) * a.hq + head) * a.dh;
#pragma unroll
      for (int c = 0; c < DHP / 8; ++c) {
        const int col = 8 * c + 2 * (lane & 3);
        if (col < a.dh)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o_acc[4 * c + 2 * h] * inv,
                                    o_acc[4 * c + 2 * h + 1] * inv);
      }
    }
  }
  // the K/V tiles the other warpgroup still walks: released as they land
  // (a tile's K landing means its stage's previous use was released by
  // both warpgroups, so no release runs a phase ahead)
  for (int t = my_tiles; t < n_tiles; ++t) {
    mbar_wait(k_full(t % S), (t / S) & 1);
    release(t % S);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// links the runtime only
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map over dims[0..rank) (innermost first, dims[0] = dh,
// contiguous) with byte strides of dims 1.. and the given box, 128-byte
// swizzle, zeros past the edges.
static bool encode_map(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int DHP>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     int batch, int lq, int lk, int hq, int hkv, int dh,
                     int pack, int pack_shift, float scale, int causal,
                     cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<NWG, DHP>();
  // above 48 KB of dynamic shared memory: allowed once per instantiation
  // and device
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices || !smem_set[device]) {
    e = cudaFuncSetAttribute(flash_attention_tc<NWG, DHP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (device < kMaxDevices) smem_set[device] = true;
  }
  const cuuint64_t row = (cuuint64_t)dh * 2;
  CUtensorMap tq, tk, tv;
  // q (b, lq, hq, dh) as (dh, P, hq / P, lq, b); box (64, P, 1, 64 / P, 1)
  const cuuint64_t qd[5] = {(cuuint64_t)dh, (cuuint64_t)pack,
                            (cuuint64_t)(hq / pack), (cuuint64_t)lq,
                            (cuuint64_t)batch};
  const cuuint64_t qs[4] = {row, row * pack, row * hq, row * hq * lq};
  const cuuint32_t qb[5] = {64, (cuuint32_t)pack, 1,
                            (cuuint32_t)(64 >> pack_shift), 1};
  // k, v (b, lk, hkv, dh) as (dh, hkv, lk, b); box (64, 1, 64, 1)
  const cuuint64_t kd[4] = {(cuuint64_t)dh, (cuuint64_t)hkv, (cuuint64_t)lk,
                            (cuuint64_t)batch};
  const cuuint64_t ks[3] = {row, row * hkv, row * hkv * lk};
  const cuuint32_t kb[4] = {64, 1, kTcBn, 1};
  if (!encode_map(&tq, q, 5, qd, qs, qb) ||
      !encode_map(&tk, k, 4, kd, ks, kb) ||
      !encode_map(&tv, v, 4, kd, ks, kb))
    return cudaErrorInvalidValue;
  const int pos_per_tile = 64 >> pack_shift;
  const int q_tiles = (lq + pos_per_tile - 1) / pos_per_tile;
  const FlashTcArgs a{o,       lq,      lk,    hq,    dh, pack_shift,
                      hq / hkv, q_tiles, scale, causal};
  const dim3 grid((q_tiles + NWG - 1) / NWG, hq / pack, batch);
  flash_attention_tc<NWG, DHP><<<grid, NWG * 128 + 32, smem, st>>>(tq, tk, tv,
                                                                   a);
  return (int)cudaGetLastError();
}

template <int DHP>
static int launch_tc_rows(const void* q, const void* k, const void* v,
                          void* o, int batch, int lq, int lk, int hq, int hkv,
                          int dh, float scale, int causal, cudaStream_t st) {
  // P: the largest power of two dividing hq / hkv, at most 64
  int pack_shift = 0;
  while (pack_shift < 6 && (hq / hkv) % (2 << pack_shift) == 0) ++pack_shift;
  const int pack = 1 << pack_shift;
  // two query tiles a block where that still gives 128 blocks
  const int pos64 = 64 >> pack_shift;
  const long long pairs =
      (long long)((lq + pos64 - 1) / pos64 + 1) / 2 * (hq / pack) * batch;
  if (pairs >= 128)
    return launch_tc<2, DHP>(q, k, v, o, batch, lq, lk, hq, hkv, dh, pack,
                             pack_shift, scale, causal, st);
  return launch_tc<1, DHP>(q, k, v, o, batch, lq, lk, hq, hkv, dh, pack,
                           pack_shift, scale, causal, st);
}

}  // namespace marca

// q (b, lq, hq, dh), k and v (b, lk, hkv, dh), o (b, lq, hq, dh), all
// contiguous in the compute type (0 f32, 1 bf16); hq a multiple of hkv; dh
// a multiple of 4 up to 128 in f32, a multiple of 16 up to 128 in bf16
// (whose q, k, v start on 16-byte boundaries); with causal, lq <= lk.
// Returns 0 or a CUDA error.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    const FlashArgs a{q, k, v, o, lq, lk, hq, hkv, dh, scale, causal};
    const dim3 grid((lq + kFaBq - 1) / kFaBq, hq, batch);
    flash_attention_kernel<float><<<grid, kFaThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype != DT_BF16 || dh % 16 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return cudaErrorInvalidValue;
  if (dh <= 64)
    return launch_tc_rows<64>(q, k, v, o, batch, lq, lk, hq, hkv, dh, scale,
                              causal, st);
  return launch_tc_rows<128>(q, k, v, o, batch, lq, lk, hq, hkv, dh, scale,
                             causal, st);
}
