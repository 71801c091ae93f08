// The Neumann chain's, the final pair's and the forward solve's forms of
// conv3x3_out_tc.cuh's tensor-core 3x3 mid -> c product (C3_CHAIN,
// C3_FINAL, C3_SOLVE), declared for estimator.cu and fused_solve.cu: they
// are defined in conv3x3_out_tc.cu, a translation unit of their own that
// ops/cuda_build.py links into those libraries, as conv3x3_in_tc.cuh's forms
// are. Those units include this declaration and not conv3x3_out_tc.cuh,
// whose inline launchers would instantiate the re-attachment's and the
// backward solve's forms there too. Hidden, so that each library calls its
// own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace imnf {

// u = bf16_round(C1^T t * s0), acc += coef[k] * u of `nets` nets stacked
// along the batch (conv3x3_out_tc.cuh's launch_nc_conv3x3_out_tc), s0
// float32 or bfloat16
#define C3O_API __attribute__((visibility("hidden")))
C3O_API cudaError_t conv3x3_out_tc_chain(const __nv_bfloat16* wt, const float* t, int B,
                                         int nets, int C, int MID, int H, int W,
                                         const float* s0, const float* coef, int k,
                                         float* u_out, float* acc, cudaStream_t s);
C3O_API cudaError_t conv3x3_out_tc_chain(const __nv_bfloat16* wt, const float* t, int B,
                                         int nets, int C, int MID, int H, int W,
                                         const __nv_bfloat16* s0, const float* coef, int k,
                                         float* u_out, float* acc, cudaStream_t s);
// out = C1^T t of `nets` nets stacked along the batch on the weights of
// wnets nets, net n taking net n % wnets's (conv3x3_out_tc.cuh's C3_FINAL)
C3O_API cudaError_t conv3x3_out_tc_final(const __nv_bfloat16* wt, const float* t, int B,
                                         int nets, int wnets, int C, int MID, int H, int W,
                                         float* out, cudaStream_t s);
// out[e] = base[e] + sgn * (W3 t[s] + bias) [- sub[e]] of the forward solve,
// the bf16 split's 3 or 4 passes on W3's pre-cast halves
// (conv3x3_out_tc.cuh's C3_SOLVE)
C3O_API cudaError_t conv3x3_out_tc_solve(int passes, int groups, const __nv_bfloat16* wt_hi,
                                         const __nv_bfloat16* wt_lo, const float* bias,
                                         const float* t, const int* idx, const int* count,
                                         int B, int C, int MID, int H, int W,
                                         const float* base, float sgn, const float* sub,
                                         float* out, cudaStream_t s);

}  // namespace imnf
