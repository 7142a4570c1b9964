// Shared device code for the port's Hopper kernels: type conversion, the
// MARCA nonlinear units (paper §5: biased fast exp, piecewise SiLU) and the
// S6 cell every selective-SSM kernel applies per (channel, state) pair.
//
// The nonlinearities are a runtime switch on each kernel (one uniform branch
// per call site); the numbering of the switches and of the activation and
// state storage types matches repro_torch/kernels/_lib.py.  The quantized
// state's codes and its running-absmax scale update (state_quant.encode and
// update_scale) live here too, so every kernel that writes an int8/fp8
// state encodes it with the same bits.
// fast_exp's multiply-add uses __fmul_rn/__fadd_rn so nvcc cannot contract
// it into an FMA: the int32 it truncates then equals the one the plain
// PyTorch version computes, bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace marca {

enum ExpImpl { EXP_EXACT = 0, EXP_OURS = 1, EXP_FAST = 2 };
enum SiluImpl { SILU_EXACT = 0, SILU_OURS = 1, SILU_PAPER = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum StateDType { SD_INT8 = 0, SD_FP8 = 1, SD_F32 = 2, SD_BF16 = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// the value a torch tensor of type T holds after .to(T): rounding to bf16 and
// back, or nothing for f32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// ---------------------------------------------------------------------------
// Biased fast exponential (repro/core/approx.py:81 fast_exp, :100 our_exp):
//   i = int32(clamp(x, +-80) * 2^23/ln2 + (127 + b_shift) * 2^23)
//   y = bitcast_f32(i) + c
// The constants are rounded to f32 exactly as np.float32 rounds them.  The
// clamp keeps a NaN, as torch.clamp and jnp.clip do (fmaxf would turn it
// into -80), and __float2int_rz(NaN) is 0, so a NaN gives +0.0 + c.  It is
// PTX's max.NaN / min.NaN: the two instructions of fminf(fmaxf(..)), so a
// kernel that inlines this keeps its register allocation (a compare-and-
// select form took the scan kernel from 80 to 124 registers and 10% longer
// on an H100).
// ---------------------------------------------------------------------------
constexpr double kS23 = 8388608.0;
constexpr double kLn2 = 0.6931471805599453;
constexpr float kExpScale = (float)(kS23 / kLn2);
constexpr float kFastBias = (float)((127.0 - 0.065) * kS23);    // FAST_EXP
constexpr float kOursBias = (float)((127.0 - 0.03475) * kS23);  // OUR_EXP
constexpr float kOursC = (float)5.6e-07;

__device__ __forceinline__ float fast_exp(float x, float bias, float c) {
  // x = min(max(x, -80), 80) with a NaN kept; 0fC2A00000 is -80.0f
  asm("max.NaN.f32 %0, %0, 0fC2A00000;\n\tmin.NaN.f32 %0, %0, 0f42A00000;"
      : "+f"(x));
  const int i = __float2int_rz(__fadd_rn(__fmul_rn(x, kExpScale), bias));
  return __fadd_rn(__int_as_float(i), c);
}

__device__ __forceinline__ float apply_exp(float x, int impl) {
  if (impl == EXP_OURS) return fast_exp(x, kOursBias, kOursC);
  if (impl == EXP_FAST) return fast_exp(x, kFastBias, 0.0f);
  return expf(x);
}

// ---------------------------------------------------------------------------
// Piecewise SiLU (repro/core/approx.py:153 "ours", :162 "paper").
// ---------------------------------------------------------------------------
__device__ __forceinline__ float quad(float x, float a2, float a1, float a0) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(a2, x), a1), x), a0);
}

__device__ __forceinline__ float silu_ours(float x) {
  float y = 0.0f;
  y = x >= -9.0f ? quad(x, -0.0026606f, -0.0442494f, -0.1855941f) : y;
  y = x >= -5.0f ? quad(x, -0.0117359f, -0.1503727f, -0.4880836f) : y;
  y = x >= -1.5f ? quad(x, 0.2163049f, 0.4986513f, 0.0058849f) : y;
  y = x >= 0.75f ? quad(x, 0.0813905f, 0.7826839f, -0.1309739f) : y;
  y = x >= 2.25f ? quad(x, -0.0164214f, 1.1849977f, -0.5492407f) : y;
  y = x >= 4.5f ? quad(x, -0.0033375f, 1.0541269f, -0.2208955f) : y;
  return x > 9.0f ? x : y;
}

__device__ __forceinline__ float silu_paper(float x) {
  if (x < -5.0f) return -0.0135f;
  if (x < -1.5f) return __fadd_rn(__fmul_rn(-0.06244f, x), -0.3457f);
  if (x <= 0.75f) {
    const float t = __fadd_rn(x, 1.181f);
    return __fadd_rn(__fmul_rn(0.232f, __fmul_rn(t, t)), -0.275f);
  }
  return __fadd_rn(__fmul_rn(1.05f, x), -0.2781f);
}

__device__ __forceinline__ float apply_silu(float x, int impl) {
  if (impl == SILU_OURS) return silu_ours(x);
  if (impl == SILU_PAPER) return silu_paper(x);
  return x / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// The S6 cell (repro/kernels/decode_step.py:98 s6_cell) for one thread that
// owns one (channel, state) pair; a group of kN consecutive lanes holds one
// channel's whole state vector.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float s6_state_update(float h, float dt, float x,
                                                 float a, float b,
                                                 int exp_impl) {
  return apply_exp(dt * a, exp_impl) * h + (dt * x) * b;
}

// A weight entry as a kernel consumes it: f32 weights as stored, or int8
// codes times their scale (A's per channel, a dense matrix's per output
// column) with one rounded multiply -- the multiply of
// repro_torch/core/weight_quant.py dequantize_rows / dequantize_w, so every
// path sees bit-identical values (__fmul_rn keeps nvcc from fusing it
// onward).
__device__ __forceinline__ float load_w(const float* W, const float*,
                                        int64_t idx, int) {
  return W[idx];
}
__device__ __forceinline__ float load_w(const int8_t* W, const float* scale,
                                        int64_t idx, int c) {
  return __fmul_rn((float)W[idx], scale[c]);
}

// sum of v over a group of kN consecutive lanes: a butterfly, so the order
// is fixed and every lane of the group gets the sum
template <int kN>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kN / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// y_d = sum_n C_n h_nd over the kN lanes of the channel's group
template <int kN>
__device__ __forceinline__ float s6_contract(float h, float c) {
  return group_sum<kN>(h * c);
}

__device__ __forceinline__ float s6_gate(float y, float x, const float* D,
                                         int ch, bool has_z, float z,
                                         int silu_impl) {
  if (D != nullptr) y += D[ch] * x;
  if (has_z) y *= apply_silu(z, silu_impl);
  return y;
}

// ---------------------------------------------------------------------------
// Quantized state storage (repro_torch/core/state_quant.py): codes and the
// decayed running-absmax scale update, with the rounded operations torch
// runs in f32 (__fmul_rn/__fdiv_rn keep nvcc from contracting them), a true
// division per value (never a multiply by the reciprocal), rintf (half to
// even, as torch.round) for int8 and __nv_fp8_e4m3 (round to nearest even,
// as .to(float8_e4m3fn)) for fp8.
// ---------------------------------------------------------------------------
constexpr int kScaleGroup = 512;    // state_quant.D_BLOCK
constexpr float kEmaDecay = 0.99f;  // state_quant.EMA_DECAY
constexpr float kEpsAmax = 1e-30f;  // state_quant.EPS_AMAX

template <typename TQ>
struct Codes;

template <>
struct Codes<int8_t> {
  static constexpr float kMax = 127.0f;
  static __device__ __forceinline__ float decode(int8_t q) {
    return (float)q;
  }
  static __device__ __forceinline__ int8_t encode(float v) {
    return (int8_t)(int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  }
};

template <>
struct Codes<__nv_fp8_e4m3> {
  static constexpr float kMax = 448.0f;
  static __device__ __forceinline__ float decode(__nv_fp8_e4m3 q) {
    return static_cast<float>(q);
  }
  static __device__ __forceinline__ __nv_fp8_e4m3 encode(float v) {
    return __nv_fp8_e4m3(v);
  }
};

// state_quant.update_scale: the group's new scale from this step's absmax
// and the scale it was stored with (0 for a fresh slot)
__device__ __forceinline__ float update_scale(float amax, float s_in,
                                              float qmax) {
  const float m = fmaxf(amax, __fmul_rn(kEmaDecay, __fmul_rn(s_in, qmax)));
  return __fdiv_rn(fmaxf(m, kEpsAmax), qmax);
}

}  // namespace marca
