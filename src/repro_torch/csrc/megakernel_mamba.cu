// Host entry points of K3's mamba and jamba instances, the mamba instance's
// kernel, and the cooperative grid sizing every K3 kernel uses (coop_grid).
//
// Replaces: repro/kernels/decode_step.py:413 stacked_layer_launch
// (pallas_call at :488) with the body of repro/models/mamba_lm.py:160
// ("marca_megakernel_mamba"): ONE launch runs every layer of a decode step
// for the whole slot pool,
//
//   for l in layers:  x = x + mamba_block_megastep(rmsnorm(x))
//
// with the chain of repro_torch/models/mamba.py mamba_block_megastep: norm
// -> in_proj -> [x | z] -> conv over the tail + bias -> SiLU -> x_proj ->
// (dt_low, B, C) -> dt_proj + bias + softplus -> S6 step (exp_impl) -> D
// skip and SiLU(z) gate -> out_proj -> residual.  The jamba instance
// (repro/models/jamba.py:305) is megakernel_mamba.cuh's kernel.
//
// Bound on this card: bytes.  A decode step at a few slots reads every
// weight of every layer once (mamba-130m: 3.77 M per layer, 362 MB in f32,
// 92 MB in int8) and the pooled state in and out; at 4 slots the f32
// model takes at least 114 us at 3.35 TB/s, the int8 model with an int8
// state 29 us.  What binds it is latency: 4-5 dependent phases a layer
// with a grid barrier after each; the weights, which depend on nothing in
// that chain, need not wait for it.
//
// Design: one persistent cooperative kernel, one block of 512 threads an
// SM, the layer loop inside, and a grid barrier wherever the next phase
// needs a whole vector.  Per layer:
//   A   every block with an in_proj panel recomputes the RMS norm of the
//       residual stream x for its slots (staged in shared memory), then
//       its panel's columns; the x half's epilogue runs the conv over the
//       tail + bias and SiLU and writes the new tail; z is stored.  barrier
//   B   x_proj panels -> dt_low, B, C.                             barrier
//   C   one block per (slot, 32 channels): dt_proj (the 16 lanes of a
//       channel split the dt_rank dot) + bias + softplus, the S6 step with
//       one lane per state (as decode_step.cu), D skip and gate.  An
//       f32/bf16 state is written here; an int8/fp8 state's f32 values and
//       each chunk's absmax go to scratch.                         barrier
//   C2  (int8/fp8 state) each chunk takes its 512-channel group's absmax
//       from the 16 chunks' partials, updates the scale and encodes, with
//       K2's arithmetic (common.cuh).                              barrier
//   D   out_proj panels and the residual add x + y.                barrier
// The dense weights stream into a ring of shared-memory slots (below: "The
// weight stream"): each block owns one panel of columns of each weight,
// the same every layer, and its thread 0 keeps the next items in flight
// by TMA across phases and layers, so a phase finds its weights in shared
// memory.  A panel's columns are summed by the block's 16 warps over row
// groups, each row's 4 slot inputs read in one 16-byte load, and the
// partial sums combine by a shuffle butterfly and then over the warps in
// one fixed order.  No float atomics anywhere: the same inputs give the
// same bits.  Weights are read as stored: f32, or int8 codes times their
// scale with one rounded multiply, then rounded to the compute type (on
// the integer and FMA pipes); every rounding point of the per-layer path
// is kept.  The phases read their per-layer weights through a table of
// device pointers, and the ring its tensor maps, both built once per
// engine.  The first design (column tiles read from global memory in each
// phase) and megakernel_mamba.cuh's split-K design measured slower at
// mamba-130m's and mamba-2.8b's widths (PERF.md).
#include <cooperative_groups.h>
#include <cuda.h>

#include <string.h>

#include <mutex>
#include <vector>

#include "megakernel_mamba.cuh"

namespace cg = cooperative_groups;

namespace marca {

constexpr int kChunk = kMThreads / kMN;                // 32 channels / item
constexpr int kChunksPerGroup = kScaleGroup / kChunk;  // 16

struct MegaArgs {
  const int64_t* table;  // (L, W_COLUMNS) device pointers
  const void* x0;        // (b, dm) compute type: the embedded tokens
  void* x;               // (b, dm) compute type: the residual stream out
  const void* h;         // (L, b, di, 16) state storage type
  const float* h_scale;  // (L, b, g) for an int8/fp8 state
  const void* conv;      // (L, b, k-1, di) compute type
  void* h_out;
  float* h_scale_out;
  void* conv_out;
  float* scratch;
  const CUtensorMap* maps;  // (L, 3) tensor maps of in_proj, x_proj, out_proj
  int L, b, dm, di, R, k, nx, g, nchunks;
  int state_dtype, exp_impl, silu_impl;
  int tma;     // bit w: weight w streams by TMA, else by the copy path
  int stages;  // slots of the weight ring
};

// Layer l's state: (b, ...) tensors in and out.
struct RowState {
  const void* h;
  const float* h_scale;
  const void* conv;
  void* h_out;
  float* h_scale_out;
  void* conv_out;
};

template <typename T>
__device__ __forceinline__ RowState row_state(const MegaArgs& a, int l) {
  const int64_t eh = a.state_dtype == SD_F32    ? 4
                     : a.state_dtype == SD_BF16 ? 2
                                                : 1;
  const int64_t nh = (int64_t)a.b * a.di * 16 * eh;
  const int64_t ns = (int64_t)a.b * a.g;
  const int64_t nc = (int64_t)a.b * (a.k - 1) * a.di;
  const bool q = a.h_scale != nullptr;
  return {static_cast<const char*>(a.h) + l * nh,
          q ? a.h_scale + l * ns : nullptr,
          static_cast<const T*>(a.conv) + l * nc,
          static_cast<char*>(a.h_out) + l * nh,
          q ? a.h_scale_out + l * ns : nullptr,
          static_cast<T*>(a.conv_out) + l * nc};
}

// phase C: dt, the S6 step, D skip and gate for (slot, 32-channel) items
template <typename T, typename TW>
__device__ void phase_step(const MegaArgs& a, const int64_t* wt,
                           const RowState& rs, float* warp_max) {
  const TW* Wdt = column<TW>(wt, W_DT);
  const float* dt_scale = column<float>(wt, W_DT_SCALE);
  const float* dt_bias = column<float>(wt, W_DT_BIAS);
  const TW* Aw = column<TW>(wt, W_A);
  const float* a_scale = column<float>(wt, W_A_SCALE);
  const float* Dv = column<float>(wt, W_D);
  const int64_t bdi = (int64_t)a.b * a.di;
  const float* xa = a.scratch;
  const float* zb = xa + bdi;
  const float* dbc = zb + bdi;
  float* yb = a.scratch + 2 * bdi + (int64_t)a.b * a.nx;
  float* amax = yb + bdi;
  float* hb = amax + (int64_t)a.b * a.nchunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = threadIdx.x / kMN, st = threadIdx.x % kMN;
  for (int it = blockIdx.x; it < a.b * a.nchunks; it += gridDim.x) {
    const int s = it / a.nchunks, chunk = it % a.nchunks;
    const int ch = chunk * kChunk + cl;
    const bool valid = ch < a.di;
    const int c = valid ? ch : a.di - 1;  // shadow lanes join the shuffles
    const float* row = dbc + (int64_t)s * a.nx;
    // every load first (none depends on another), then the arithmetic:
    // one memory latency per item instead of one per dependent step
    const int64_t hidx = ((int64_t)s * a.di + c) * kMN + st;
    float hv;
    if (a.state_dtype == SD_F32) {
      hv = static_cast<const float*>(rs.h)[hidx];
    } else if (a.state_dtype == SD_BF16) {
      hv = to_f32(static_cast<const __nv_bfloat16*>(rs.h)[hidx]);
    } else {
      hv = a.state_dtype == SD_INT8
               ? Codes<int8_t>::decode(static_cast<const int8_t*>(rs.h)[hidx])
               : Codes<__nv_fp8_e4m3>::decode(
                     static_cast<const __nv_fp8_e4m3*>(rs.h)[hidx]);
      hv = __fmul_rn(hv, rs.h_scale[(int64_t)s * a.g + c / kScaleGroup]);
    }
    // A: int8 codes times their row scale, or -exp(A_log) for f32 weights
    const float aw = load_w(Aw, a_scale, (int64_t)c * kMN + st, c);
    const float xv = xa[(int64_t)s * a.di + c];
    const float zv = zb[(int64_t)s * a.di + c];
    const float bv = row[a.R + st], cv = row[a.R + kMN + st];
    const float bias = dt_bias[c];
    constexpr int kDtRows = 4;  // dt_rank rows per lane loaded at once
    float part = 0.0f;
    for (int r0 = st; r0 < a.R; r0 += kDtRows * kMN) {
      float wv[kDtRows], lo[kDtRows];
#pragma unroll
      for (int u = 0; u < kDtRows; ++u) {
        const int r = min(r0 + u * kMN, a.R - 1);
        wv[u] = load_w(Wdt, dt_scale, (int64_t)r * a.di + c, c);
        lo[u] = row[r];
      }
#pragma unroll
      for (int u = 0; u < kDtRows; ++u)
        if (r0 + u * kMN < a.R) part += lo[u] * round_to<T>(wv[u]);
    }
    const float dt_raw = round_to<T>(group_sum<kMN>(part));
    const float pre = dt_raw + bias;
    const float dtv =
        round_to<T>(pre > kSoftplusThreshold ? pre : log1pf(expf(pre)));
    const float av = sizeof(TW) == 1 ? aw : -expf(aw);
    const float h1 = s6_state_update(hv, dtv, xv, av, bv, a.exp_impl);
    float yv = s6_contract<kMN>(h1, cv);
    yv = s6_gate(yv, xv, Dv, c, true, zv, a.silu_impl);
    if (valid && st == 0) yb[(int64_t)s * a.di + ch] = round_to<T>(yv);
    if (a.state_dtype == SD_F32) {
      if (valid) static_cast<float*>(rs.h_out)[hidx] = h1;
    } else if (a.state_dtype == SD_BF16) {
      if (valid)
        static_cast<__nv_bfloat16*>(rs.h_out)[hidx] = from_f32<__nv_bfloat16>(h1);
    } else {
      if (valid) hb[((int64_t)s * a.di + ch) * kMN + st] = h1;
      float m = valid ? fabsf(h1) : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) warp_max[warp] = m;
      __syncthreads();
      if (threadIdx.x == 0) {
        float mm = warp_max[0];
        for (int w = 1; w < kMWarps; ++w) mm = fmaxf(mm, warp_max[w]);
        amax[(int64_t)s * a.nchunks + chunk] = mm;
      }
      __syncthreads();
    }
  }
}

// phase C2: the group scale from the chunks' absmax, then the encode
template <typename TQ>
__device__ void phase_requant(const MegaArgs& a, const RowState& rs) {
  const int64_t bdi = (int64_t)a.b * a.di;
  const float* amax = a.scratch + 3 * bdi + (int64_t)a.b * a.nx;
  const float* hb = amax + (int64_t)a.b * a.nchunks;
  TQ* h_out = static_cast<TQ*>(rs.h_out);
  const int cl = threadIdx.x / kMN, st = threadIdx.x % kMN;
  for (int it = blockIdx.x; it < a.b * a.nchunks; it += gridDim.x) {
    const int s = it / a.nchunks, chunk = it % a.nchunks;
    const int grp = chunk / kChunksPerGroup;
    const int first = grp * kChunksPerGroup;
    const int last = min(first + kChunksPerGroup, a.nchunks);
    float m = 0.0f;
    for (int q = first; q < last; ++q)
      m = fmaxf(m, amax[(int64_t)s * a.nchunks + q]);
    const int64_t sg = (int64_t)s * a.g + grp;
    const float so = update_scale(m, rs.h_scale[sg], Codes<TQ>::kMax);
    if (chunk == first && threadIdx.x == 0) rs.h_scale_out[sg] = so;
    const int ch = chunk * kChunk + cl;
    if (ch < a.di)
      h_out[((int64_t)s * a.di + ch) * kMN + st] = Codes<TQ>::encode(
          __fdiv_rn(hb[((int64_t)s * a.di + ch) * kMN + st], so));
  }
}

// ---------------------------------------------------------------------------
// The weight stream.  Each block owns, for each dense layer, one panel of
// pw adjacent output columns (the same in every layer; pw a multiple of 16
// bytes, the grid's share of the columns rounded up, so one round covers
// the weight).  A panel is fetched in items of `rows` rows, each filling
// one ring slot of at most kSlotBytes laid out [row][pw] (TMA boxes of at
// most 256 rows, as many as the item needs); the block's items are its
// panels' items in the order the phases consume them: per layer and
// 4-slot pass, in_proj's, x_proj's, out_proj's.  The ring holds `stages`
// slots with an mbarrier each; thread 0 is the producer: it issues the
// first `stages` items at the start and refills a slot as soon as the
// block has consumed it, with the item `stages` further on, whatever phase
// or layer that is, so the next phases' weights are in flight while the
// chain of this one (barriers, norms, the S6 step) runs.  A weight whose
// global row stride or base is no multiple of 16 bytes (TMA's rule) takes
// the copy path: its slot's mbarrier is arrived on at issue, and the block
// copies the item into the slot with plain loads when it consumes it.
// ---------------------------------------------------------------------------
constexpr int kSlotBytes = 32768;
constexpr int kMaxStages = 8;
constexpr int kMaxCols = 4;   // columns a thread: panels up to 128 wide
constexpr int kMaxTail = 4;   // the conv tail a thread reads: d_conv <= 5
constexpr int kStreamed = 3;  // in_proj, x_proj, out_proj
enum StreamedWeight { SW_IN = 0, SW_X = 1, SW_OUT = 2 };
// Hopper's most for a block, less the block's static ring state
constexpr size_t kSmemLimit = 232448 - 256;

// The panels of a (K, N) weight of esize-byte elements on a grid of G
// blocks: pw columns a block, nblk blocks with a panel, rows an item (box
// rows a TMA box), chunks items a panel.
struct Panel {
  int K, N, pw, nblk, rows, box, chunks;
};

__host__ __device__ inline Panel panel_of(int K, int N, int esize, int G) {
  Panel p;
  p.K = K;
  p.N = N;
  const int v = 16 / esize;
  p.pw = ((N + G - 1) / G + v - 1) / v * v;
  p.nblk = (N + p.pw - 1) / p.pw;
  const int fit = kSlotBytes / (p.pw * esize);
  p.box = fit < 256 ? fit : 256;
  p.rows = fit < 256 ? fit : fit / 256 * 256;
  p.rows = p.rows < K ? p.rows : K;
  p.box = p.box < p.rows ? p.box : p.rows;
  p.chunks = (K + p.rows - 1) / p.rows;
  return p;
}

struct Panels {
  Panel w[kStreamed];
};

__host__ __device__ inline Panels panels_of(int dm, int di, int nx,
                                            int esize, int G) {
  return {{panel_of(dm, 2 * di, esize, G), panel_of(di, nx, esize, G),
           panel_of(di, dm, esize, G)}};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of the given parity to complete; a transfer that
// never lands traps after some 10 s rather than hang the card.
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
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

// The ring, shared by the block: the panels, the slots and their
// mbarriers, and the producer's cursor (the next item to issue: its slot,
// layer, weight, pass and chunk; thread 0's alone).  Each thread keeps the
// consumers' cursor (the slot and parity of the next item to read) in
// registers.
struct Ring {
  Panels ps;
  char* slots;      // stages x kSlotBytes, 1024-byte aligned
  uint64_t full[kMaxStages];  // an mbarrier a slot
  int stages, passes, left;   // left: items still to issue
  bool own[kStreamed];        // the block has a panel of weight w
  int islot, il, iw, ipass, ichunk;
};

// the producer's cursor to the block's item after the one it points at
__device__ __forceinline__ void ring_advance(Ring& r) {
  if (++r.islot == r.stages) r.islot = 0;
  if (++r.ichunk < r.ps.w[r.iw].chunks) return;
  r.ichunk = 0;
  if (++r.ipass < r.passes) return;
  r.ipass = 0;
  do {
    if (++r.iw == kStreamed) {
      r.iw = 0;
      ++r.il;
    }
  } while (!r.own[r.iw]);
}

// Issue the producer's next item (thread 0) and advance its cursor.
template <typename TW>
__device__ void ring_issue(const MegaArgs& a, Ring& r) {
  const uint32_t bar = smem_addr(&r.full[r.islot]);
  const int w = r.iw;
  if ((a.tma >> w) & 1) {
    const Panel& p = r.ps.w[w];
    const int r0 = r.ichunk * p.rows;
    const int nr = min(p.rows, p.K - r0);
    const int boxes = (nr + p.box - 1) / p.box;
    const uint32_t box_bytes = (uint32_t)(p.pw * p.box * sizeof(TW));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(boxes * box_bytes) : "memory");
    const uint64_t map = reinterpret_cast<uint64_t>(
        a.maps + (int64_t)r.il * kStreamed + w);
    const uint32_t dst = smem_addr(r.slots + (size_t)r.islot * kSlotBytes);
    for (int b = 0; b < boxes; ++b)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
          :: "r"(dst + b * box_bytes), "l"(map), "r"(bar),
             "r"(blockIdx.x * p.pw), "r"(r0 + b * p.box)
          : "memory");
  } else {  // the copy path: the consumers copy
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
  }
  --r.left;
  if (r.left > 0) ring_advance(r);
}

// The residual rows s0 .. s0+nb-1 normalised into shared memory as
// xs4[i] = (slot 0, .., slot 3) (blocks.apply_norm with rmsnorm:
// x * rsqrt(mean(x^2) + eps) * scale, rounded to the compute type; slots
// interleaved so a GEMV row reads its 4 inputs in one 16-byte load; slots
// past nb 0).
constexpr int kNormPer = 8;  // norm scales a thread holds: d_model <= 4096

template <typename T>
__device__ void stage_norm4(float4* xs4, float* redn, const T* src,
                            const float* scale, int s0, int nb, int dm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ss[kSlots], sc[kNormPer];
#pragma unroll
  for (int si = 0; si < kSlots; ++si) ss[si] = 0.0f;
  // the scales are read beside the rows: one trip to memory, not two
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) {
    const int i = threadIdx.x + u * kMThreads;
    sc[u] = i < dm ? scale[i] : 0.0f;
  }
  for (int i = threadIdx.x; i < dm; i += kMThreads) {
    float v[kSlots];
#pragma unroll
    for (int si = 0; si < kSlots; ++si) {
      v[si] = si < nb ? to_f32(src[(int64_t)(s0 + si) * dm + i]) : 0.0f;
      ss[si] += v[si] * v[si];
    }
    xs4[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    const float v = group_sum<32>(ss[si]);
    if (lane == 0) redn[warp * kSlots + si] = v;
  }
  __syncthreads();
  float r[kSlots];
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
    float tot = 0.0f;
    for (int w = 0; w < kMWarps; ++w) tot += redn[w * kSlots + si];
    r[si] = rsqrtf(tot / (float)dm + kNormEps);
  }
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) {
    const int i = threadIdx.x + u * kMThreads;
    if (i < dm) {
      const float4 v = xs4[i];
      xs4[i] = make_float4(round_to<T>(v.x * r[0] * sc[u]),
                           round_to<T>(v.y * r[1] * sc[u]),
                           round_to<T>(v.z * r[2] * sc[u]),
                           round_to<T>(v.w * r[3] * sc[u]));
    }
  }
  __syncthreads();
}

// rows s0 .. s0+nb-1 of a (b, K) scratch vector into shared memory as xs4
__device__ void stage_rows4(float4* xs4, const float* src, int s0, int nb,
                            int K) {
  for (int i = threadIdx.x; i < K; i += kMThreads) {
    float v[kSlots];
#pragma unroll
    for (int si = 0; si < kSlots; ++si)
      v[si] = si < nb ? src[(int64_t)(s0 + si) * K + i] : 0.0f;
    xs4[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
}

// a weight as the dense layer consumes it, on the FMA and integer pipes:
// an int8 code made a float exactly by the 1.5 * 2^23 bias (no I2F), times
// its column's scale with one rounded multiply, then rounded to the compute
// type by round_int (no F2F); f32 weights only rounded
template <typename T, typename TW>
__device__ __forceinline__ float weight_of(TW raw, float scale) {
  if constexpr (sizeof(TW) == 1) {
    const float code = __fadd_rn(__int_as_float(0x4b400000 + (int)raw),
                                 -12582912.0f);
    return round_int<T>(__fmul_rn(code, scale));
  } else {
    return round_int<T>(raw);
  }
}

// out[si][j] = sum_i xs[si][i] * W(i, j) over this block's panel p of W
// (weight w of the stream, its items the consumers' next ones); epi(si, j,
// sum) gets each unrounded f32 sum once.  A thread takes column (lane % tj)
// (+ 32 k for panels wider than 32) and the rows of its row group, in
// ascending order; the partial sums combine by a shuffle butterfly and
// then over the warps in one fixed order.  After a slot is read, thread 0
// refills it with the item `stages` further on.
template <typename T, typename TW, int kNC, typename Epi>
__device__ void stream_panel(const MegaArgs& a, Ring& r, const char* slots,
                             int& slot_at, uint32_t& parity, const Panel& p,
                             int w, const TW* W, const float* wscale,
                             const float4* xs4, int nb, float* red,
                             Epi& epi) {
  const int K = p.K, N = p.N, pw = p.pw;
  const int j0 = blockIdx.x * pw;
  const int ncv = min(pw, N - j0);  // the panel's columns inside W
  const int tj = pw > 16 ? 32 : pw > 8 ? 16 : pw > 4 ? 8 : 4;
  const int ncol = kNC == 1 ? 1 : (pw + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jj = lane & (tj - 1);
  const int rg = warp * (32 / tj) + lane / tj;
  const int P = kMThreads / tj;
  const bool tma = (a.tma >> w) & 1;
  // a lane past the panel's columns reads column 0 and drops its sums, so
  // the row loop carries no branch
  int col[kNC];
  float sc[kNC];  // int8 weights: the columns' scales
#pragma unroll
  for (int k = 0; k < kNC; ++k) {
    const int j = jj + 32 * k;
    col[k] = k < ncol && j < ncv ? j : 0;
    sc[k] = sizeof(TW) == 1 ? wscale[j0 + col[k]] : 1.0f;
  }
  float acc[kSlots][kNC];
#pragma unroll
  for (int si = 0; si < kSlots; ++si)
#pragma unroll
    for (int k = 0; k < kNC; ++k) acc[si][k] = 0.0f;
  for (int c = 0; c < p.chunks; ++c) {
    TW* slot = reinterpret_cast<TW*>(
        const_cast<char*>(slots) + (size_t)slot_at * kSlotBytes);
    ring_wait(smem_addr(&r.full[slot_at]), parity);
    const int r0 = c * p.rows;
    const int nr = min(p.rows, K - r0);
    if (!tma) {
      for (int e = threadIdx.x; e < nr * pw; e += kMThreads) {
        const int i = e / pw, j = e % pw;
        slot[e] = j < ncv ? W[(int64_t)(r0 + i) * N + j0 + j] : TW(0);
      }
      // a later TMA refill of this slot is ordered after these writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }
    const TW* wr = slot + rg * pw;
    const float4* xr = xs4 + r0 + rg;
#pragma unroll 4
    for (int i = rg; i < nr; i += P, wr += P * pw, xr += P) {
      const float4 x = *xr;
#pragma unroll
      for (int k = 0; k < kNC; ++k) {
        const float wv = weight_of<T, TW>(wr[col[k]], sc[k]);
        acc[0][k] += x.x * wv;
        acc[1][k] += x.y * wv;
        acc[2][k] += x.z * wv;
        acc[3][k] += x.w * wv;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && r.left > 0) ring_issue<TW>(a, r);
    if (++slot_at == r.stages) {
      slot_at = 0;
      parity ^= 1;
    }
  }
#pragma unroll
  for (int si = 0; si < kSlots; ++si) {
#pragma unroll
    for (int k = 0; k < kNC; ++k) {
      float v = acc[si][k];
      for (int off = 16; off >= tj; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int j = lane + 32 * k;
      if (k < ncol && lane < tj && j < ncv)
        red[(warp * kSlots + si) * pw + j] = v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nb * ncv; e += kMThreads) {
    const int si = e / ncv, j = e % ncv;
    float sum = 0.0f;
    for (int wp = 0; wp < kMWarps; ++wp)
      sum += red[(wp * kSlots + si) * pw + j];
    epi(si, j0 + j, sum);
  }
  __syncthreads();
}

// stream_panel with one column a thread where the panel is at most a warp
// wide (every panel of mamba-130m), else up to kMaxCols
template <typename T, typename TW, typename Epi>
__device__ void stream_gemv(const MegaArgs& a, Ring& r, const char* slots,
                            int& slot_at, uint32_t& parity, int w,
                            const TW* W, const float* wscale,
                            const float4* xs4, int nb, float* red, Epi epi) {
  const Panel& p = r.ps.w[w];
  if (p.pw <= 32)
    stream_panel<T, TW, 1>(a, r, slots, slot_at, parity, p, w, W, wscale,
                           xs4, nb, red, epi);
  else
    stream_panel<T, TW, kMaxCols>(a, r, slots, slot_at, parity, p, w, W,
                                  wscale, xs4, nb, red, epi);
}

// a is __grid_constant__: the phases take it by reference without a copy
// in local memory (without it this kernel spilled 64-76 B and ran 2-4%
// slower on an H100 80GB HBM3 at 700 W, scripts/torch_k3_jamba.py)
template <typename T, typename TW>
__global__ void __launch_bounds__(kMThreads)
mamba_megakernel(const __grid_constant__ MegaArgs a) {
  extern __shared__ __align__(1024) char smem_raw[];
  __shared__ __align__(8) Ring ring;
  cg::grid_group grid = cg::this_grid();
  const int kmax = max(a.dm, a.di);
  const Panels ps = panels_of(a.dm, a.di, a.nx, sizeof(TW), gridDim.x);
  const int pwmax = max(ps.w[SW_IN].pw, max(ps.w[SW_X].pw, ps.w[SW_OUT].pw));
  // the ring at the first 1024-byte boundary (smem_bytes adds the room)
  char* slots = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float4* xs4 = reinterpret_cast<float4*>(slots +
                                          (size_t)a.stages * kSlotBytes);
  float* red = reinterpret_cast<float*>(xs4 + kmax);  // kMWarps*kSlots*pwmax
  float* redn = red + kMWarps * kSlots * pwmax;  // kMWarps * kSlots
  if (threadIdx.x == 0) {
    ring.ps = ps;
    ring.slots = slots;
    ring.stages = a.stages;
    ring.passes = (a.b + kSlots - 1) / kSlots;
    int per_layer = 0;
    ring.iw = 0;
    for (int w = kStreamed - 1; w >= 0; --w) {
      ring.own[w] = blockIdx.x < ps.w[w].nblk;
      per_layer += ring.own[w] ? ring.passes * ps.w[w].chunks : 0;
      if (ring.own[w]) ring.iw = w;  // the block's first weight
    }
    ring.left = a.L * per_layer;
    ring.islot = ring.il = ring.ipass = ring.ichunk = 0;
    for (int s = 0; s < a.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&ring.full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int l = 0; a.tma != 0 && l < a.L * kStreamed; ++l)
      asm volatile("fence.proxy.tensormap::generic.acquire.gpu [%0], 128;"
                   :: "l"(reinterpret_cast<uint64_t>(a.maps + l))
                   : "memory");
    for (int s = 0; s < a.stages && ring.left > 0; ++s)
      ring_issue<TW>(a, ring);
  }
  __syncthreads();
  int slot_at = 0;  // the consumers' cursor
  uint32_t parity = 0;

  const int64_t bdi = (int64_t)a.b * a.di;
  float* xa = a.scratch;
  float* zb = xa + bdi;
  float* dbc = zb + bdi;
  float* yb = dbc + (int64_t)a.b * a.nx;
  const T* x0 = static_cast<const T*>(a.x0);
  T* x = static_cast<T*>(a.x);
  const int k1 = a.k - 1;

  for (int l = 0; l < a.L; ++l) {
    const int64_t* wt = a.table + (int64_t)l * W_COLUMNS;
    const T* xsrc = l == 0 ? x0 : x;
    const RowState rs = row_state<T>(a, l);
    const T* conv = static_cast<const T*>(rs.conv);
    T* conv_out = static_cast<T*>(rs.conv_out);

    // A: norm -> in_proj -> conv + SiLU | z
    if (ring.own[SW_IN]) {
      const float* conv_w = column<float>(wt, W_CONV);
      const float* conv_b = column<float>(wt, W_CONV_B);
      const int pw = ps.w[SW_IN].pw, j0 = blockIdx.x * pw;
      const int ncv = min(pw, 2 * a.di - j0);
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_norm4<T>(xs4, redn, xsrc, column<float>(wt, W_NORM), s0, nb,
                       a.dm);
        // the epilogue thread of (slot, column) threadIdx.x reads the conv
        // tail, taps and bias while the panel's rows are summed
        const int es = s0 + threadIdx.x / ncv, ej = j0 + threadIdx.x % ncv;
        const bool conv_col = threadIdx.x < nb * ncv && ej < a.di;
        const int64_t tail = (int64_t)es * k1 * a.di + ej;
        float cv[kMaxTail], cw[kMaxTail + 1], cb = 0.0f;
#pragma unroll
        for (int t = 0; t <= kMaxTail; ++t) {
          if (t < kMaxTail)
            cv[t] = conv_col && t < k1
                        ? to_f32(conv[tail + (int64_t)t * a.di])
                        : 0.0f;
          cw[t] = conv_col && t <= k1 ? conv_w[(int64_t)t * a.di + ej] : 0.0f;
        }
        if (conv_col) cb = conv_b[ej];
        stream_gemv<T, TW>(
            a, ring, slots, slot_at, parity, SW_IN, column<TW>(wt, W_IN),
            column<float>(wt, W_IN_SCALE), xs4, nb, red,
            [&](int si, int j, float sum) {
              const int s = s0 + si;
              const float v = round_to<T>(sum);
              if (j >= a.di) {
                zb[(int64_t)s * a.di + j - a.di] = v;
                return;
              }
              // the conv over the tail (causal_conv1d at L = 1) + bias
              float acc = 0.0f;
#pragma unroll
              for (int t = 0; t < kMaxTail; ++t)
                if (t < k1) acc += cv[t] * cw[t];
#pragma unroll
              for (int t = 0; t <= kMaxTail; ++t)
                if (t == k1) acc += v * cw[t];
              acc += cb;
              const float xc = round_to<T>(acc);
              xa[(int64_t)s * a.di + j] = round_to<T>(apply_silu(xc,
                                                                 a.silu_impl));
#pragma unroll
              for (int t = 0; t + 1 < kMaxTail; ++t)
                if (t + 1 < k1)
                  conv_out[tail + (int64_t)t * a.di] = from_f32<T>(cv[t + 1]);
              if (k1 > 0) conv_out[tail + (int64_t)(k1 - 1) * a.di] =
                  from_f32<T>(v);
            });
      }
    }
    grid.sync();

    // B: x_proj -> (dt_low, B, C)
    if (ring.own[SW_X]) {
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_rows4(xs4, xa, s0, nb, a.di);
        stream_gemv<T, TW>(a, ring, slots, slot_at, parity, SW_X,
                           column<TW>(wt, W_X),
                           column<float>(wt, W_X_SCALE), xs4, nb, red,
                           [&](int si, int j, float sum) {
                             dbc[(int64_t)(s0 + si) * a.nx + j] =
                                 round_to<T>(sum);
                           });
      }
    }
    grid.sync();

    // C (+ C2): dt, the S6 step, gate; the state written or requantized
    phase_step<T, TW>(a, wt, rs, redn);
    grid.sync();
    if (quantized(a.state_dtype)) {
      if (a.state_dtype == SD_INT8)
        phase_requant<int8_t>(a, rs);
      else
        phase_requant<__nv_fp8_e4m3>(a, rs);
      grid.sync();
    }

    // D: out_proj, residual
    if (ring.own[SW_OUT]) {
      for (int s0 = 0; s0 < a.b; s0 += kSlots) {
        const int nb = min(kSlots, a.b - s0);
        stage_rows4(xs4, yb, s0, nb, a.di);
        // the residual of the epilogue thread's (slot, column), read while
        // the panel's rows are summed
        const int pw = ps.w[SW_OUT].pw, j0 = blockIdx.x * pw;
        const int ncv = min(pw, a.dm - j0);
        const int64_t ei = (int64_t)(s0 + threadIdx.x / ncv) * a.dm + j0 +
                           threadIdx.x % ncv;
        const float res = threadIdx.x < nb * ncv ? to_f32(xsrc[ei]) : 0.0f;
        stream_gemv<T, TW>(
            a, ring, slots, slot_at, parity, SW_OUT, column<TW>(wt, W_OUT),
            column<float>(wt, W_OUT_SCALE), xs4, nb, red,
            [&](int si, int j, float sum) {
              x[ei] = from_f32<T>(res + round_to<T>(sum));
            });
      }
    }
    if (l + 1 < a.L) grid.sync();
  }
}

// Shared memory of one block on a grid of G blocks: the ring (as many
// slots as fit, at most kMaxStages), then the staged rows, the panel
// reduction and the norm / absmax partials; 0 if fewer than 2 slots fit.
size_t smem_bytes(int dm, int di, int nx, int esize, int G, int* stages) {
  const int kmax = dm > di ? dm : di;
  const Panels ps = panels_of(dm, di, nx, esize, G);
  int pwmax = 0;
  for (int w = 0; w < kStreamed; ++w)
    pwmax = ps.w[w].pw > pwmax ? ps.w[w].pw : pwmax;
  const size_t rest = sizeof(float) * ((size_t)kSlots * kmax +
                                       (size_t)kMWarps * kSlots * pwmax +
                                       kMWarps * kSlots);
  const int n = rest + 1024 >= kSmemLimit
                    ? 0
                    : (int)((kSmemLimit - 1024 - rest) / kSlotBytes);
  *stages = n < kMaxStages ? n : kMaxStages;
  if (*stages < 2) return 0;
  return 1024 + (size_t)*stages * kSlotBytes + rest;
}

// scratch floats: x_a, z, (dt_low|B|C), y, chunk absmax and f32 state values
int64_t scratch_floats(int b, int di, int nx, int nchunks) {
  return (int64_t)b * (3 * (int64_t)di + nx + nchunks + (int64_t)di * kMN);
}

using KernelFn = void (*)(const MegaArgs);

KernelFn pick(int dtype, int weight_dtype) {
  using bf = __nv_bfloat16;
  if (dtype == DT_F32 && weight_dtype == 0)
    return mamba_megakernel<float, float>;
  if (dtype == DT_F32 && weight_dtype == 1)
    return mamba_megakernel<float, int8_t>;
  if (dtype == DT_BF16 && weight_dtype == 0)
    return mamba_megakernel<bf, float>;
  if (dtype == DT_BF16 && weight_dtype == 1)
    return mamba_megakernel<bf, int8_t>;
  return nullptr;
}

// the SM count of the current device: K3's mamba instance runs one block
// an SM, and its panels are cut for that grid
int sm_count(int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// blocks per SM, grid, shared memory and ring slots of a launch; 0 or an
// error code (a width whose panels or shared memory a block cannot take
// is refused)
int configure(KernelFn fn, int dm, int di, int nx, int esize, int* per_sm,
              int* grid, size_t* smem, int* stages) {
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const Panels ps = panels_of(dm, di, nx, esize, sms);
  for (int w = 0; w < kStreamed; ++w)
    if (ps.w[w].pw > kMaxCols * 32) return cudaErrorInvalidValue;
  *smem = smem_bytes(dm, di, nx, esize, sms, stages);
  if (*smem == 0) return cudaErrorInvalidValue;
  rc = coop_grid((const void*)fn, *smem, per_sm, grid);
  if (rc != 0) return rc;
  // the panels were cut for one block an SM
  return *grid == sms ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Checks the launch, sizes the grid and launches; 0 or a CUDA error.
int launch(KernelFn fn, int weight_dtype, MegaArgs& a, int64_t scratch_len,
           void* stream) {
  const bool quant = a.state_dtype == SD_INT8 || a.state_dtype == SD_FP8;
  if (fn == nullptr || a.L < 1 || a.b < 1 || a.dm < 1 || a.di < 1 ||
      a.R < 1 || a.k < 1 || a.k > kMaxTail + 1 ||
      a.dm > kNormPer * kMThreads || a.state_dtype < SD_INT8 ||
      a.state_dtype > SD_BF16 ||
      scratch_len < scratch_floats(a.b, a.di, a.nx, a.nchunks) ||
      (quant && (a.h_scale == nullptr || a.h_scale_out == nullptr)) ||
      (a.tma != 0 && a.maps == nullptr))
    return cudaErrorInvalidValue;
  int per_sm = 0, grid = 0;
  size_t smem = 0;
  const int rc = configure(fn, a.dm, a.di, a.nx, weight_dtype ? 1 : 4,
                           &per_sm, &grid, &smem, &a.stages);
  if (rc != 0) return rc;
  void* params[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fn, dim3(grid), dim3(kMThreads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

int coop_grid(const void* fn, size_t smem, int* per_sm, int* grid,
              int threads) {
  struct Entry { const void* fn; int dev; size_t smem; int per_sm, grid; };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev, sms, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  size_t opened = 0;
  for (const Entry& x : seen) {
    if (x.fn != fn || x.dev != dev) continue;
    if (x.smem == smem) {
      *per_sm = x.per_sm;
      *grid = x.grid;
      return 0;
    }
    opened = x.smem > opened ? x.smem : opened;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && smem > opened)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop || *per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = *per_sm * sms;
  seen.push_back({fn, dev, smem, *per_sm, *grid});
  return 0;
}

}  // namespace marca

namespace marca {
namespace mb {

// Shared memory of one block: the per-block values, then the larger of a
// GEMV's staged rows and warp sums and the S6 item's operands, whose chunk
// is sized for the smallest grid the card gives (one block an SM).
size_t smem_bytes(int di, int R, int nx, int wbytes, int sms) {
  const size_t step = step_smem(R, nx, chunk_of(di, sms), wbytes);
  return 4 * (size_t)kSmall + (step > kGemvSmem ? step : kGemvSmem);
}

KernelFn pick(int dtype, int weight_dtype) {
  if (dtype == DT_F32 && weight_dtype == 0) return kernels_0_0();
  if (dtype == DT_F32 && weight_dtype == 1) return kernels_0_1();
  if (dtype == DT_BF16 && weight_dtype == 0) return kernels_1_0();
  if (dtype == DT_BF16 && weight_dtype == 1) return kernels_1_1();
  return nullptr;
}

// blocks per SM, grid and shared memory of a launch; 0 or an error code
int configure(KernelFn fn, int di, int R, int nx, int wbytes, int* per_sm,
              int* grid, size_t* smem) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *smem = smem_bytes(di, R, nx, wbytes, sms);
  const int rc = coop_grid((const void*)fn, *smem, per_sm, grid, kThreads);
  if (rc != 0) return rc;
  // a scale group's chunks wait for each other, so one item a block at
  // most, and the item's threads split its chunk evenly
  if (kThreads % chunk_of(di, *grid) != 0) return cudaErrorInvalidValue;
  return 0;
}

// Checks a jamba launch, sizes the grid and launches; 0 or a CUDA error.
int launch(KernelFn fn, int weight_dtype, MegaArgs& a, int64_t scratch_len,
           void* stream) {
  const bool quant = a.state_dtype == SD_INT8 || a.state_dtype == SD_FP8;
  if (fn == nullptr || a.L < 1 || a.b < 1 || a.dm < 1 || a.di < 1 ||
      a.R < 1 || a.k < 1 || a.d_ff < 0 || a.state_dtype < SD_INT8 ||
      a.state_dtype > SD_BF16 || a.dm > kMaxModel || a.k > kMaxConv)
    return cudaErrorInvalidValue;
  for (int l = 0; l < a.L; ++l)
    if (a.rows.h[l] == nullptr || a.rows.conv[l] == nullptr ||
        a.rows.h_out[l] == nullptr || a.rows.conv_out[l] == nullptr ||
        (quant && (a.rows.h_scale[l] == nullptr ||
                   a.rows.h_scale_out[l] == nullptr)))
      return cudaErrorInvalidValue;
  int per_sm = 0, grid = 0;
  size_t smem = 0;
  const int rc = configure(fn, a.di, a.R, a.nx, weight_dtype ? 1 : 4,
                           &per_sm, &grid, &smem);
  if (rc != 0) return rc;
  if (scratch_len < scratch_floats(a.b, a.dm, a.di, a.nx, a.d_ff, a.g, grid))
    return cudaErrorInvalidValue;
  void* params[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fn, dim3(grid), dim3(kThreads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace mb
}  // namespace marca

// The launch configuration K3 would use on the current device: out[0]
// blocks per SM, out[1] the grid, out[2] dynamic shared memory bytes,
// out[3] threads per block; for the mamba instance also out[4] its weight
// ring's slots and, for each streamed weight w (in_proj, x_proj,
// out_proj), out[5 + 3w] the columns of a block's panel, out[6 + 3w] the
// blocks with a panel and out[7 + 3w] the ring items a panel takes (all
// 0 for the jamba instance).  weight_dtype 0 is f32, 1 int8; mlp 1 is the
// jamba instance.  A width whose panels or shared memory one block cannot
// take is refused.
extern "C" int marca_mamba_stacked_grid(int d_model, int d_inner,
                                        int dt_rank, int dtype,
                                        int weight_dtype, int mlp, int* out) {
  int per_sm = 0, grid = 0, threads = marca::kMThreads, stages = 0;
  size_t smem = 0;
  if (d_model < 1 || d_inner < 1 || dt_rank < 1) return cudaErrorInvalidValue;
  const int nx = dt_rank + 2 * marca::kMN;
  int rc;
  if (mlp) {
    const marca::mb::KernelFn fn = marca::mb::pick(dtype, weight_dtype);
    if (fn == nullptr) return cudaErrorInvalidValue;
    rc = marca::mb::configure(fn, d_inner, dt_rank, nx,
                              weight_dtype ? 1 : 4, &per_sm, &grid, &smem);
    threads = marca::mb::kThreads;
  } else {
    const marca::KernelFn fn = marca::pick(dtype, weight_dtype);
    if (fn == nullptr) return cudaErrorInvalidValue;
    rc = marca::configure(fn, d_model, d_inner, nx, weight_dtype ? 1 : 4,
                          &per_sm, &grid, &smem, &stages);
  }
  if (rc != 0) return rc;
  out[0] = per_sm;
  out[1] = grid;
  out[2] = (int)smem;
  out[3] = threads;
  out[4] = stages;
  const marca::Panels ps = marca::panels_of(d_model, d_inner, nx,
                                            weight_dtype ? 1 : 4, grid);
  for (int w = 0; w < marca::kStreamed; ++w) {
    out[5 + 3 * w] = mlp ? 0 : ps.w[w].pw;
    out[6 + 3 * w] = mlp ? 0 : ps.w[w].nblk;
    out[7 + 3 * w] = mlp ? 0 : ps.w[w].chunks;
  }
  return 0;
}

// The tensor maps K3's mamba instance streams its dense weights with, for
// a stack of L layers on the current device: weights (host, (L, 3) int64)
// the device pointers of each layer's in_proj, x_proj and out_proj (f32
// or int8 codes, row-major (K, N)); maps (host, L * 3 * 128 bytes) gets a
// 2-D tensor map of each over the TMA box (pw columns, box rows) its
// blocks fetch, info[0] a mask of the weights every layer of which TMA
// can read (bit w: a 16-byte aligned base and row stride; the others take
// the copy path and their maps stay zero), info[1] the grid the panels
// were cut for.  Returns 0 or a CUDA error.
extern "C" int marca_mamba_stack_maps(const int64_t* weights, int L,
                                      int d_model, int d_inner, int dt_rank,
                                      int weight_dtype, void* maps,
                                      int* info) {
  using namespace marca;
  if (L < 1 || d_model < 1 || d_inner < 1 || dt_rank < 1)
    return cudaErrorInvalidValue;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int esize = weight_dtype ? 1 : 4;
  const Panels ps = panels_of(d_model, d_inner, dt_rank + 2 * kMN, esize,
                              sms);
  CUtensorMap* out = static_cast<CUtensorMap*>(maps);
  const EncodeTiledFn encode = encode_tiled();
  int mask = 0;
  for (int w = 0; w < kStreamed; ++w) {
    const Panel& p = ps.w[w];
    bool ok = encode != nullptr && ((int64_t)p.N * esize) % 16 == 0;
    for (int l = 0; ok && l < L; ++l)
      ok = weights[l * kStreamed + w] % 16 == 0;
    for (int l = 0; l < L; ++l) {
      CUtensorMap* m = out + (int64_t)l * kStreamed + w;
      memset(m, 0, sizeof(CUtensorMap));
      if (!ok) continue;
      const cuuint64_t dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.K};
      const cuuint64_t strides[1] = {(cuuint64_t)p.N * esize};
      const cuuint32_t box[2] = {(cuuint32_t)p.pw, (cuuint32_t)p.box};
      const cuuint32_t ones[2] = {1, 1};
      if (encode(m,
                 esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                 2, reinterpret_cast<void*>(weights[l * kStreamed + w]),
                 dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    }
    if (ok) mask |= 1 << w;
  }
  info[0] = mask;
  info[1] = sms;
  return 0;
}

// One decode step of the whole Mamba stack.  table: (L, 24) int64 device
// pointers per layer (megakernel.py TABLE_COLUMNS); maps: the (L, 3)
// tensor maps marca_mamba_stack_maps wrote, in device memory, and tma its
// mask (0 and null: every weight by the copy path); x0, x_out (slots,
// d_model) in the compute type; h, h_out (L, slots, d_inner, 16) in the
// state type; h_scale, h_scale_out (L, slots, g) f32 for an int8/fp8 state
// (else null); conv, conv_out (L, slots, d_conv-1, d_inner) in the compute
// type; scratch at least scratch_floats() f32.  Returns 0 or a CUDA error;
// a grid that cannot be co-resident is cudaErrorCooperativeLaunchTooLarge.
extern "C" int marca_mamba_stacked_step(
    const void* table, const void* maps, int tma, const void* x0,
    void* x_out, const void* h, const void* h_scale, const void* conv,
    void* h_out, void* h_scale_out, void* conv_out, void* scratch,
    int64_t scratch_len, int L, int slots, int d_model, int d_inner,
    int d_state, int dt_rank, int d_conv, int dtype, int weight_dtype,
    int state_dtype, int exp_impl, int silu_impl, void* stream) {
  using namespace marca;
  if (d_state != kMN || tma < 0 || tma >= (1 << kStreamed))
    return cudaErrorInvalidValue;
  MegaArgs a{};
  a.table = (const int64_t*)table;
  a.maps = (const CUtensorMap*)maps;
  a.tma = tma;
  a.x0 = x0;
  a.x = x_out;
  a.h = h;
  a.h_scale = (const float*)h_scale;
  a.conv = conv;
  a.h_out = h_out;
  a.h_scale_out = (float*)h_scale_out;
  a.conv_out = conv_out;
  a.scratch = (float*)scratch;
  a.L = L;
  a.b = slots;
  a.dm = d_model;
  a.di = d_inner;
  a.R = dt_rank;
  a.k = d_conv;
  a.nx = dt_rank + 2 * kMN;
  a.g = (d_inner + kScaleGroup - 1) / kScaleGroup;
  a.nchunks = (d_inner + kChunk - 1) / kChunk;
  a.state_dtype = state_dtype;
  a.exp_impl = exp_impl;
  a.silu_impl = silu_impl;
  return launch(pick(dtype, weight_dtype), weight_dtype, a, scratch_len,
                stream);
}

// One decode token through a run of jamba positions (K3's jamba instance).
// table: (nrows, 24) int64 device pointers per position (megakernel.py
// TABLE_COLUMNS + MLP_COLUMNS); x0, x_out (slots, d_model) in the compute
// type; rows: a host array of 6 x 8 int64 device pointers, the h, h_scale,
// conv, h_out, h_scale_out and conv_out of each position (h (slots,
// d_inner, 16) in the state type, h_scale (slots, g) f32 for an int8/fp8
// state, else 0, conv (slots, d_conv-1, d_inner) in the compute type);
// scratch at least scratch_floats() f32.  Returns 0 or a CUDA error.
extern "C" int marca_jamba_stacked_run(
    const void* table, const void* x0, void* x_out, const int64_t* rows,
    void* scratch, int64_t scratch_len, int nrows, int slots, int d_model,
    int d_inner, int d_state, int dt_rank, int d_conv, int d_ff, int dtype,
    int weight_dtype, int state_dtype, int exp_impl, int silu_impl,
    void* stream) {
  namespace mb = marca::mb;
  if (d_state != marca::kMN || nrows < 1 || nrows > mb::kMaxRows || d_ff < 1 ||
      rows == nullptr)
    return cudaErrorInvalidValue;
  mb::MegaArgs a{};
  a.table = (const int64_t*)table;
  a.x0 = x0;
  a.x = x_out;
  for (int l = 0; l < nrows; ++l) {
    a.rows.h[l] = (const void*)rows[0 * mb::kMaxRows + l];
    a.rows.h_scale[l] = (const float*)rows[1 * mb::kMaxRows + l];
    a.rows.conv[l] = (const void*)rows[2 * mb::kMaxRows + l];
    a.rows.h_out[l] = (void*)rows[3 * mb::kMaxRows + l];
    a.rows.h_scale_out[l] = (float*)rows[4 * mb::kMaxRows + l];
    a.rows.conv_out[l] = (void*)rows[5 * mb::kMaxRows + l];
  }
  a.scratch = (float*)scratch;
  a.L = nrows;
  a.b = slots;
  a.dm = d_model;
  a.di = d_inner;
  a.R = dt_rank;
  a.k = d_conv;
  a.nx = dt_rank + 2 * marca::kMN;
  a.g = (d_inner + marca::kScaleGroup - 1) / marca::kScaleGroup;
  a.d_ff = d_ff;
  a.state_dtype = state_dtype;
  a.exp_impl = exp_impl;
  a.silu_impl = silu_impl;
  return mb::launch(mb::pick(dtype, weight_dtype), weight_dtype, a,
                    scratch_len, stream);
}
