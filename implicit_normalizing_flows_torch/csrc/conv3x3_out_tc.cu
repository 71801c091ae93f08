// The Neumann chain's form of conv3x3_out_tc.cuh's tensor-core 3x3 mid -> c
// product (C3_CHAIN), as a translation unit of its own: ops/cuda_build.py
// links it into estimator.cu's library (nc_jt_out_acc, mode bf16), so that
// its instantiations leave the SASS of that library's other kernels as it
// was (conv3x3_in_tc.cuh says why that needs a unit of its own).

#include "conv3x3_out_chain.cuh"
#include "conv3x3_out_tc.cuh"

namespace imnf {

cudaError_t conv3x3_out_tc_chain(const __nv_bfloat16* wt, const float* t, int B, int nets,
                                 int C, int MID, int H, int W, const float* s0,
                                 const float* coef, int k, float* u_out, float* acc,
                                 cudaStream_t s) {
  return launch_nc_conv3x3_out_tc(wt, t, B, nets, C, MID, H, W, s0, coef, k, u_out, acc, s);
}

cudaError_t conv3x3_out_tc_chain(const __nv_bfloat16* wt, const float* t, int B, int nets,
                                 int C, int MID, int H, int W, const __nv_bfloat16* s0,
                                 const float* coef, int k, float* u_out, float* acc,
                                 cudaStream_t s) {
  return launch_nc_conv3x3_out_tc(wt, t, B, nets, C, MID, H, W, s0, coef, k, u_out, acc, s);
}

}  // namespace imnf
