// The forms of conv3x3_in_tc.cuh's tensor-core 3x3 c -> mid product that the
// port launches, as their own translation unit: ops/cuda_build.py links it
// into the libraries of estimator.cu (nc_jt_in and fp_conv_in, mode bf16),
// implicit_grad.cu (jt_conv3x3_in and rv_conv3x3_in, mode bf16),
// block_forward.cu (lin_conv3x3_in, modes tf32 / tf32x) and fused_solve.cu
// (conv3x3_in, modes tf32 / tf32x). The header says why.

#include "conv3x3_in_tc.cuh"

namespace imnf {

// out = bf16_round(C3^T u * s2) of `nets` nets stacked along the batch
cudaError_t conv3x3_in_tc_chain(const __nv_bfloat16* w, const float* u, int B, int nets, int C,
                                int H, int W, int M, const float* s2, float* out,
                                cudaStream_t s) {
  return launch_conv3x3_in_tc<EPI_SCALE_RND, 1>(w, nullptr, nullptr, u, B, nets, C, H, W, M,
                                                0, 0.f, 0.f, s2, out, nullptr, nullptr, s);
}

cudaError_t conv3x3_in_tc_chain(const __nv_bfloat16* w, const float* u, int B, int nets, int C,
                                int H, int W, int M, const __nv_bfloat16* s2, float* out,
                                cudaStream_t s) {
  return launch_conv3x3_in_tc<EPI_SCALE_RND, 1>(w, nullptr, nullptr, u, B, nets, C, H, W, M,
                                                0, 0.f, 0.f, s2, out, nullptr, nullptr, s);
}

// out[s] = C3^T u[idx[s]] * s2[idx[s]] for the slots s < *count, one net
cudaError_t conv3x3_in_tc_jt(const __nv_bfloat16* w, const float* u, const int* idx,
                             const int* count, int B, int C, int H, int W, int M,
                             const float* s2, float* out, cudaStream_t s) {
  return launch_conv3x3_in_tc<EPI_SCALE, 1>(w, nullptr, nullptr, u, B, 1, C, H, W, M, 0, 0.f,
                                            0.f, s2, out, nullptr, nullptr, s, idx, count);
}

cudaError_t conv3x3_in_tc_jt(const __nv_bfloat16* w, const float* u, const int* idx,
                             const int* count, int B, int C, int H, int W, int M,
                             const __nv_bfloat16* s2, float* out, cudaStream_t s) {
  return launch_conv3x3_in_tc<EPI_SCALE, 1>(w, nullptr, nullptr, u, B, 1, C, H, W, M, 0, 0.f,
                                            0.f, s2, out, nullptr, nullptr, s, idx, count);
}

// out = swish(h1), s1 = swish'(h1) [, s0 = swish'(inp)] with h1 = W1
// [swish](inp) + bias, the bf16 split's 3 or 4 passes
cudaError_t conv3x3_in_tc_lin(int passes, const __nv_bfloat16* w_hi, const __nv_bfloat16* w_lo,
                              const float* bias, const float* inp, int B, int C, int H, int W,
                              int M, int preact, float beta_in, float beta_out, float* out,
                              float* s1, float* s0, cudaStream_t s) {
  const float* no_scale = nullptr;
  if (passes == 3)
    return launch_conv3x3_in_tc<EPI_SWISH_LIN, 3>(w_hi, w_lo, bias, inp, B, 1, C, H, W, M,
                                                  preact, beta_in, beta_out, no_scale, out, s1,
                                                  s0, s);
  if (passes == 4)
    return launch_conv3x3_in_tc<EPI_SWISH_LIN, 4>(w_hi, w_lo, bias, inp, B, 1, C, H, W, M,
                                                  preact, beta_in, beta_out, no_scale, out, s1,
                                                  s0, s);
  return cudaErrorInvalidValue;
}

// out[s] = swish(W1 [swish](inp[idx[s]]) + bias) for the slots s < *count,
// the bf16 split's 3 or 4 passes
cudaError_t conv3x3_in_tc_solve(int passes, const __nv_bfloat16* w_hi, const __nv_bfloat16* w_lo,
                                const float* bias, const float* inp, const int* idx,
                                const int* count, int B, int C, int H, int W, int M, int preact,
                                float beta_in, float beta_out, float* out, cudaStream_t s) {
  const float* no_scale = nullptr;
  if (passes == 3)
    return launch_conv3x3_in_tc<EPI_SWISH, 3>(w_hi, w_lo, bias, inp, B, 1, C, H, W, M, preact,
                                              beta_in, beta_out, no_scale, out, nullptr,
                                              nullptr, s, idx, count);
  if (passes == 4)
    return launch_conv3x3_in_tc<EPI_SWISH, 4>(w_hi, w_lo, bias, inp, B, 1, C, H, W, M, preact,
                                              beta_in, beta_out, no_scale, out, nullptr,
                                              nullptr, s, idx, count);
  return cudaErrorInvalidValue;
}

// out[s] = alpha * W1 IN(inp[idx[s]]) [+ bias] for the slots s < *count, one
// net, IN by act (IN_ID | IN_SWISH) at the slope *beta (a device pointer)
cudaError_t conv3x3_in_tc_affine(const __nv_bfloat16* w, const float* bias, float alpha, int act,
                                 const float* beta, const float* inp, const int* idx,
                                 const int* count, int B, int C, int H, int W, int M, float* out,
                                 cudaStream_t s) {
  const float* no_scale = nullptr;
  return launch_conv3x3_in_tc<EPI_AFFINE, 1>(w, nullptr, bias, inp, B, 1, C, H, W, M, 0, 0.f,
                                             0.f, no_scale, out, nullptr, nullptr, s, idx, count,
                                             nullptr, beta, alpha, act);
}

// out[s] = W[net] IN(inp[s]) [+ bias[net]] of `nets` nets stacked along the
// batch (net = s / (B / nets)), IN by act (IN_ID | IN_SWISH | IN_DSWISH
// with inh) at the slope beta_net[net] (a device array), the exact products
// summed in float64 (the header says why). Takes what launch_conv3x3_in_tc
// takes of the shapes and an 8-byte aligned out; cudaErrorInvalidValue
// otherwise.
cudaError_t conv3x3_in_dmma_affine(const __nv_bfloat16* w, const float* bias, int act,
                                   const float* beta_net, const float* inp, const float* inh,
                                   int B, int nets, int C, int H, int W, int M, float* out,
                                   cudaStream_t s) {
  if (C < 1 || C > C3I_CMAX || M < C3I_MQ || M % C3I_MQ || nets < 1 || B % nets ||
      (W != 8 && W != 16 && W != 32) || H < 1 || (H * W) % c3i_np(W) || act < IN_ID ||
      act > IN_DSWISH || (act != IN_ID && beta_net == nullptr) ||
      (act == IN_DSWISH && inh == nullptr))
    return cudaErrorInvalidValue;
#define C3D_W(TW) \
  if (W == TW) return launch_c3i_dmma<TW>(w, bias, act, beta_net, inp, inh, B, nets, C, H, M, out, s);
  C3D_W(8)
  C3D_W(16)
  C3D_W(32)
#undef C3D_W
  return cudaErrorInvalidValue;
}

}  // namespace imnf
