// Host entry points of K3's xLSTM instances (the kernels and their design:
// megakernel_xlstm.cuh): the launch checks, the grid and the cooperative
// launch.
#include "megakernel_xlstm.cuh"

namespace marca {
namespace xl {

KernelFn pick(int slstm, int dtype, int weight_dtype) {
  if (dtype == DT_F32 && weight_dtype == 0) return kernels_0_0(slstm);
  if (dtype == DT_F32 && weight_dtype == 1) return kernels_0_1(slstm);
  if (dtype == DT_BF16 && weight_dtype == 0) return kernels_1_0(slstm);
  if (dtype == DT_BF16 && weight_dtype == 1) return kernels_1_1(slstm);
  return nullptr;
}

}  // namespace xl
}  // namespace marca

// The launch configuration of K3's xLSTM instance on the current device:
// out[0] blocks per SM, out[1] the grid, out[2] dynamic shared memory
// bytes, out[3] threads a block.  kind 0 is mLSTM, 1 sLSTM; weight_dtype
// 0 is f32, 1 int8.
extern "C" int marca_xlstm_stacked_grid(int kind, int d_model, int dtype,
                                        int weight_dtype, int* out) {
  using namespace marca;
  const xl::KernelFn fn = xl::pick(kind, dtype, weight_dtype);
  if (fn == nullptr || d_model < 1) return cudaErrorInvalidValue;
  const size_t smem = xl::smem_bytes(kind, d_model);
  int per_sm = 0, grid = 0;
  const int rc = coop_grid((const void*)fn, smem, &per_sm, &grid,
                           xl::block_threads(kind));
  if (rc != 0) return rc;
  out[0] = per_sm;
  out[1] = grid;
  out[2] = (int)smem;
  out[3] = xl::block_threads(kind);
  return 0;
}

// One decode token through a run of same-kind xLSTM layers (K3's xLSTM
// instance).  table: (nrows, 16) int64 device pointers per layer
// (megakernel.py XLSTM_COLUMNS); x0, x_out (slots, d_model) in the compute
// type; rows: a host array of 2 x 5 x 32 int64 device pointers, each state
// part's input of every layer, then its output (megakernel.py XLSTM_PARTS:
// mLSTM C in the state type, C_scale for an int8/fp8 C, n, m, conv; sLSTM
// c, n, h, m; f32 but C); scratch at least scratch_floats() f32; q_scale
// the mLSTM's dh^-0.5 in f32; d_model at most kMaxXModel.
// Returns 0 or a CUDA error; a grid that cannot be co-resident is
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int marca_xlstm_stacked_run(
    const void* table, const void* x0, void* x_out, const int64_t* rows,
    void* scratch, int64_t scratch_len, int kind, int nrows, int slots,
    int d_model, int n_heads, int d_conv, int dtype, int weight_dtype,
    int state_dtype, int silu_impl, float q_scale, void* stream) {
  using namespace marca;
  const xl::KernelFn fn = xl::pick(kind, dtype, weight_dtype);
  const int di = kind ? d_model : 2 * d_model;
  if (fn == nullptr || rows == nullptr || nrows < 1 || nrows > xl::kMaxRows ||
      slots < 1 || d_model < 1 || d_model % kVec != 0 || n_heads < 1 ||
      di % n_heads != 0 || di / n_heads > xl::kMaxHead ||
      (di / n_heads) % kVec != 0 || d_conv < 1 || state_dtype < SD_INT8 ||
      state_dtype > SD_BF16 || (kind && state_dtype != SD_F32) ||
      d_model > xl::kMaxXModel ||
      scratch_len < xl::scratch_floats(kind, slots, d_model, n_heads))
    return cudaErrorInvalidValue;
  const bool quant = state_dtype == SD_INT8 || state_dtype == SD_FP8;
  const int nparts = kind ? 4 : xl::kParts;
  xl::Args a{};
  for (int p = 0; p < nparts; ++p) {
    const bool needed = kind || p != xl::P_CSCALE || quant;
    for (int l = 0; l < nrows; ++l) {
      a.rows.in[p][l] = (const void*)rows[p * xl::kMaxRows + l];
      a.rows.out[p][l] = (void*)rows[(xl::kParts + p) * xl::kMaxRows + l];
      if (needed && (a.rows.in[p][l] == nullptr ||
                     a.rows.out[p][l] == nullptr))
        return cudaErrorInvalidValue;
    }
  }
  a.table = (const int64_t*)table;
  a.x0 = x0;
  a.x = x_out;
  a.scratch = (float*)scratch;
  a.L = nrows;
  a.b = slots;
  a.dm = d_model;
  a.nh = n_heads;
  a.dh = di / n_heads;
  a.k = d_conv;
  a.state_dtype = state_dtype;
  a.silu_impl = silu_impl;
  a.q_scale = q_scale;
  const size_t smem = xl::smem_bytes(kind, d_model);
  int per_sm = 0, grid = 0;
  const int threads = xl::block_threads(kind);
  const int rc = coop_grid((const void*)fn, smem, &per_sm, &grid, threads);
  if (rc != 0) return rc;
  void* params[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fn, dim3(grid), dim3(threads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
