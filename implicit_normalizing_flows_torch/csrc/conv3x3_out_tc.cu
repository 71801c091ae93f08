// The Neumann chain's, the final pair's and the forward solve's forms of
// conv3x3_out_tc.cuh's tensor-core 3x3 mid -> c product (C3_CHAIN,
// C3_FINAL, C3_SOLVE), as a translation unit of their own: ops/cuda_build.py
// links it into estimator.cu's library (nc_jt_out_acc and fp_conv_out, mode
// bf16) and fused_solve.cu's (conv3x3_out, modes tf32 / tf32x), so that its
// instantiations leave the SASS of those libraries' other kernels as it was
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

// out[e] = base[e] + sgn * (W3 t[s] + bias) [- sub[e]], e = idx[s], for the
// slots s < *count, the bf16 split's 3 or 4 passes (passes) on the tensor
// cores: wt_hi and wt_lo W3's halves in the tile layout (MID / 64, 9 npad,
// 64) bf16 (npad: C padded to 8, 16 or 48), each band's npad / 8 output
// tiles split over `groups` blocks of 1 or 2 tiles; t (B, MID, H*W) by
// slot, base, sub (or nullptr) and out (B, C, H*W) by example. Takes what
// launch_conv3x3_out_tc takes, with 16-byte aligned wt_hi and wt_lo;
// cudaErrorInvalidValue otherwise.
cudaError_t conv3x3_out_tc_solve(int passes, int groups, const __nv_bfloat16* wt_hi,
                                 const __nv_bfloat16* wt_lo, const float* bias, const float* t,
                                 const int* idx, const int* count, int B, int C, int MID, int H,
                                 int W, const float* base, float sgn, const float* sub,
                                 float* out, cudaStream_t s) {
  const int tiles = C <= 8 ? 1 : C <= 16 ? 2 : 6, nt = groups > 0 ? tiles / groups : 0;
  if (C < 1 || C > 48 || MID < C3_MC || MID % C3_MC || H < C3_TH || H % C3_TH ||
      groups < 1 || tiles % groups || (nt != 1 && nt != 2) || (passes != 3 && passes != 4) ||
      wt_hi == nullptr || wt_lo == nullptr || bias == nullptr || base == nullptr ||
      idx == nullptr || count == nullptr)
    return cudaErrorInvalidValue;
#define C3_SOLVE_W(TW, NT, P)                                                                  \
  if (W == TW && nt == NT && passes == P)                                                      \
    return launch_c3_solve<TW, NT, P>(wt_hi, wt_lo, bias, t, idx, count, B, C, MID, H, groups, \
                                      base, sgn, sub, out, s);
#define C3_SOLVE_NT(TW) \
  C3_SOLVE_W(TW, 1, 3) C3_SOLVE_W(TW, 1, 4) C3_SOLVE_W(TW, 2, 3) C3_SOLVE_W(TW, 2, 4)
  C3_SOLVE_NT(8)
  C3_SOLVE_NT(16)
  C3_SOLVE_NT(32)
#undef C3_SOLVE_NT
#undef C3_SOLVE_W
  return cudaErrorInvalidValue;
}

}  // namespace imnf
