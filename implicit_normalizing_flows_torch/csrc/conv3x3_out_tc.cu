// The Neumann chain's and the final pair's forms of conv3x3_out_tc.cuh's
// tensor-core 3x3 mid -> c product (C3_CHAIN, C3_FINAL), as a translation
// unit of their own: ops/cuda_build.py links it into estimator.cu's library
// (nc_jt_out_acc and fp_conv_out, mode bf16), so that its instantiations
// leave the SASS of that library's other kernels as it was
// (conv3x3_in_tc.cuh says why that needs a unit of its own).

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

// out = C1^T t for every slot of `nets` nets stacked along the batch, on
// the tensor cores: net n takes the weights of net n % wnets, wt their
// tile layout (wnets, MID / 64, 9 * 8 NT, 64) bf16 as the chain's; t (B,
// MID, H*W), out (B, C, H*W). Takes what launch_conv3x3_out_tc takes, with
// a 16-byte aligned wt and nets a multiple of wnets; cudaErrorInvalidValue
// otherwise.
cudaError_t conv3x3_out_tc_final(const __nv_bfloat16* wt, const float* t, int B, int nets,
                                 int wnets, int C, int MID, int H, int W, float* out,
                                 cudaStream_t s) {
  if (C < 1 || C > 48 || MID < C3_MC || MID % C3_MC || H < C3_TH || H % C3_TH || nets < 1 ||
      B % nets || wnets < 1 || nets % wnets || wt == nullptr)
    return cudaErrorInvalidValue;
#define C3_FINAL_W(TW)                                                                        \
  if (W == TW) {                                                                              \
    if (C <= 8) return launch_c3_final<TW, 1>(wt, t, B, nets, wnets, C, MID, H, out, s);      \
    if (C <= 16) return launch_c3_final<TW, 2>(wt, t, B, nets, wnets, C, MID, H, out, s);     \
    return launch_c3_final<TW, 6>(wt, t, B, nets, wnets, C, MID, H, out, s);                  \
  }
  C3_FINAL_W(8)
  C3_FINAL_W(16)
  C3_FINAL_W(32)
#undef C3_FINAL_W
  return cudaErrorInvalidValue;
}

}  // namespace imnf
