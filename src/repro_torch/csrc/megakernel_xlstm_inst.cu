// The kernels of K3's xLSTM instances (megakernel_xlstm.cuh) for one
// (compute type, weight type) pair: XL_ACT 0 f32 / 1 bf16, XL_W 0 f32 /
// 1 int8, set on the nvcc line (repro_torch/kernels/_lib.py BUILDS), so
// that the four pairs compile in parallel.
#include "megakernel_xlstm.cuh"

#define XL_NAME2(act, w) kernels_##act##_##w
#define XL_NAME(act, w) XL_NAME2(act, w)

namespace marca {
namespace xl {

#if XL_ACT == 0
using TAct = float;
#else
using TAct = __nv_bfloat16;
#endif
#if XL_W == 0
using TWgt = float;
#else
using TWgt = int8_t;
#endif

KernelFn XL_NAME(XL_ACT, XL_W)(int slstm) {
  return slstm ? slstm_megakernel<TAct, TWgt> : mlstm_megakernel<TAct, TWgt>;
}

}  // namespace xl
}  // namespace marca
