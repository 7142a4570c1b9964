// Shared device code of the cross-layer decode megakernels (K3): the sizes
// and helpers csrc/megakernel_mamba.cu (the mamba instance, blocks of
// kMThreads threads), csrc/megakernel_mamba.cuh (jamba) and
// csrc/megakernel_xlstm.cuh (mLSTM and sLSTM, blocks of their own sizes)
// share, and the cooperative launch's grid sizing.  Every kernel that
// includes it stages kSlots slots of a vector in shared memory at a time.
#pragma once

#include "common.cuh"

namespace marca {

constexpr int kMThreads = 512;
constexpr int kMWarps = kMThreads / 32;
constexpr int kSlots = 4;                              // slots per pass
constexpr float kNormEps = 1e-5f;                      // blocks.apply_norm

template <typename P>
__device__ __forceinline__ const P* column(const int64_t* row, int c) {
  return reinterpret_cast<const P*>(row[c]);
}

// round_to<T> of a finite value on the integer pipes: bf16's round to
// nearest even as 0x7fff plus the kept lowest bit added and the low half
// cut (the F2F conversion runs at 16 results a clock an SM)
template <typename T>
__device__ __forceinline__ float round_int(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    const unsigned u = __float_as_uint(v);
    return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
  }
}

// the int8 code in byte c & 3 of w as a float, exactly, on the integer and
// FMA pipes: the byte (sign bit flipped) under 2^23's exponent is 2^23 +
// code + 128; less 2^23 + 128 it is the code (I2F, like F2F, runs at 16
// results a clock an SM)
__device__ __forceinline__ float i8_value(unsigned w, int c) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4b000000u,
                                     0x7540u | (c & 3))) -
         8388736.0f;
}

// adjacent weight columns a thread of the xLSTM instances loads at least:
// their widths (d_model, the head) must be multiples of it
constexpr int kVec = 4;

__device__ __forceinline__ bool quantized(int state_dtype) {
  return state_dtype == SD_INT8 || state_dtype == SD_FP8;
}

// Blocks per SM and the grid of a cooperative launch of ``fn`` with
// ``threads`` threads and ``smem`` bytes of dynamic shared memory per block
// on the current device; 0 or a CUDA error.  Defined in
// megakernel_mamba.cu: the answers are kept per (kernel, device, shared
// memory), and so is the largest shared memory a kernel was opened to, so
// a launch after the first makes no attribute or occupancy query (none
// inside a CUDA graph capture either).
int coop_grid(const void* fn, size_t smem, int* per_sm, int* grid,
              int threads = kMThreads);

}  // namespace marca
