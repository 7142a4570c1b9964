// The kernels of K3's jamba instance (megakernel_mamba.cuh) for one
// (compute type, weight type) pair: MB_ACT 0 f32 / 1 bf16, MB_W 0 f32
// / 1 int8, set on the nvcc line (repro_torch/kernels/_lib.py BUILDS), so
// that the four pairs compile in parallel.
#include "megakernel_mamba.cuh"

#define MB_NAME2(act, w) kernels_##act##_##w
#define MB_NAME(act, w) MB_NAME2(act, w)

namespace marca {
namespace mb {

#if MB_ACT == 0
using TAct = float;
#else
using TAct = __nv_bfloat16;
#endif
#if MB_W == 0
using TWgt = float;
#else
using TWgt = int8_t;
#endif

KernelFn MB_NAME(MB_ACT, MB_W)() {
  return mamba_megakernel<TAct, TWgt>;
}

}  // namespace mb
}  // namespace marca
