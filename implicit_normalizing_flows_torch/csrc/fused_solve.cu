// Hopper (sm_90a) kernels of the forward Broyden solve.
//
// Replaces the TPU kernel implicit_normalizing_flows_tpu/ops/fused_solve.py
// ::fused_broyden_solve (_solve_kernel :773, _broyden_in_kernel :538,
// _make_eval :245). The TPU kernel runs one example's whole solve per grid
// step with the Broyden state and the 512 x HW intermediates resident in up
// to 110 MiB of VMEM. An H100 SM has 227 KB of shared memory, so the solve is
// re-cut into a host-driven loop over four batched kernels; every launch
// works on a list of ACTIVE example indices kept on the device, so an
// example that converged, stalled or broke costs no further conv work:
//
//   conv3x3_in   [swish(b0)] -> conv3x3 c->mid + b1 -> swish(b1)   (im2col GEMM)
//   conv1x1_mid  mid->mid product + b2 -> swish(b2)                (tiled GEMM)
//   conv3x3_out  conv3x3 mid->c + b3, fused with the residual
//                out = base + sgn * net - sub   (g = x_embed - net(z) - z)
//   broyden_step secant update, best iterate, protective break, stall exit,
//                next update; appends the example to the next active list
//                (its own unit, broyden_step.cu, linked into this library:
//                a thread-block cluster a live example)
//
// The conv kernels and the precision model (modes f32 / bf16 / tf32 /
// tf32x) are shared with the implicit-gradient kernels: conv_gemm.cuh, and
// in the split modes mma_gemm.cuh for conv1x1_mid, conv3x3_in_tc.cuh
// (linked from conv3x3_in_tc.cu) for conv3x3_in and conv3x3_out_tc.cuh
// (linked from conv3x3_out_tc.cu) for conv3x3_out.
//
// What bounds them on H100: conv1x1_mid is ~90% of the MACs (268M of 296M
// per example per net eval at 32x32). In modes tf32 / tf32x it runs on the
// tensor cores (mma_gemm.cuh's tc_conv1x1_kernel with PASSES 3 / 4: the
// bf16 split's 3 or 4 passes of wgmma on a hi and a lo panel, each
// activation read and split once; that header gives its bound and design),
// and so does conv3x3_in (conv3x3_in_tc.cuh's mma.sync kernel on an im2col
// tile of the band, the split's 3 or 4 passes, its output's bytes bounding
// it; the blocks of dead slots return at once), and so does conv3x3_out
// (conv3x3_out_tc.cuh's mma.sync kernel on hi / lo halo tiles of the band,
// its input's bytes bounding it). Modes f32 / bf16 of the three run on the
// CUDA cores (conv_gemm.cuh), bound by their FP32 operations.
// broyden_step.cu says what bounds broyden_step.

#include "mma_gemm.cuh"
#include "conv3x3_in_tc.cuh"
#include "conv3x3_out_chain.cuh"

namespace {

using namespace imnf;

template <int MODE>
cudaError_t launch_in(int preact, const float* w_hi, const float* w_lo,
                      const float* bias, int M, int K, const float* inp,
                      const int* idx, const int* count, int B, int C, int H,
                      int W, float beta_pre, float beta_post, float* out,
                      cudaStream_t s) {
  if (preact)
    return launch_conv_gemm<MODE, 0, IN_SWISH, EPI_SWISH>(
        w_hi, w_lo, bias, M, K, inp, nullptr, idx, count, B, C, H, W,
        beta_pre, beta_post, 1.f, nullptr, out, s);
  return launch_conv_gemm<MODE, 0, IN_ID, EPI_SWISH>(
      w_hi, w_lo, bias, M, K, inp, nullptr, idx, count, B, C, H, W, beta_pre,
      beta_post, 1.f, nullptr, out, s);
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() right after its launch (0 on success).

// w_hi / w_lo: W1's split, bfloat16 in modes tf32 / tf32x (the tensor
// cores' operands, cast once per solve), float32 in modes f32 / bf16 (the
// CUDA cores; w_lo unused there)
int imnf_conv3x3_in(int mode, int preact, const void* w_hi,
                    const void* w_lo, const float* bias, float beta0,
                    float beta1, const float* inp, const int* idx,
                    const int* count, int B, int C, int H, int W, int mid,
                    float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* fh = static_cast<const float*>(w_hi);
  const float* fl = static_cast<const float*>(w_lo);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  switch (mode) {
    case MODE_F32: return (int)launch_in<MODE_F32>(preact, fh, fl, bias, mid, C * 9, inp, idx, count, B, C, H, W, beta0, beta1, out, s);
    case MODE_BF16: return (int)launch_in<MODE_BF16>(preact, fh, fl, bias, mid, C * 9, inp, idx, count, B, C, H, W, beta0, beta1, out, s);
    case MODE_TF32: return (int)conv3x3_in_tc_solve(3, wh, wl, bias, inp, idx, count, B, C, H, W, mid, preact, beta0, beta1, out, s);
    case MODE_TF32X: return (int)conv3x3_in_tc_solve(4, wh, wl, bias, inp, idx, count, B, C, H, W, mid, preact, beta0, beta1, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w_hi / w_lo: W2's split, bfloat16 in modes tf32 / tf32x (the tensor
// cores' operands, cast once per solve), float32 in modes f32 / bf16 (the
// CUDA cores; w_lo unused there)
int imnf_conv1x1_mid(int mode, const void* w_hi, const void* w_lo,
                     const float* bias, float beta2, const float* inp,
                     const int* count, int B, int mid, int H, int W,
                     float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  const float* fh = static_cast<const float*>(w_hi);
  const float* no_scale = nullptr;
  switch (mode) {
    case MODE_F32: return (int)launch_conv_gemm<MODE_F32, 1, IN_ID, EPI_SWISH>(fh, nullptr, bias, mid, mid, inp, nullptr, nullptr, count, B, mid, H, W, 0.f, beta2, 1.f, nullptr, out, s);
    case MODE_BF16: return (int)launch_conv_gemm<MODE_BF16, 1, IN_ID, EPI_SWISH>(fh, nullptr, bias, mid, mid, inp, nullptr, nullptr, count, B, mid, H, W, 0.f, beta2, 1.f, nullptr, out, s);
    case MODE_TF32: return (int)launch_tc_conv1x1<EPI_SWISH, IN_ID, 3>(wh, mid, mid, inp, B, 1, H * W, no_scale, out, s, nullptr, count, nullptr, nullptr, bias, wl, beta2);
    case MODE_TF32X: return (int)launch_tc_conv1x1<EPI_SWISH, IN_ID, 4>(wh, mid, mid, inp, B, 1, H * W, no_scale, out, s, nullptr, count, nullptr, nullptr, bias, wl, beta2);
  }
  return (int)cudaErrorInvalidValue;
}

// w_hi / w_lo: W3's split, bfloat16 in the tile layout in modes tf32 /
// tf32x (the tensor cores' operands, cast once per solve; each band's
// output tiles over `groups` blocks), float32 OIHW in modes f32 / bf16 (the
// CUDA cores; w_lo unused there, and groups)
int imnf_conv3x3_out(int mode, const void* w_hi, const void* w_lo,
                     const float* bias, const float* t2, const int* idx,
                     const int* count, int B, int C, int mid, int H, int W,
                     const float* base, float sgn, const float* sub,
                     float* out, int groups, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* fh = static_cast<const float*>(w_hi);
  const float* fl = static_cast<const float*>(w_lo);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  switch (mode) {
    case MODE_F32: return (int)launch_conv3x3_out<MODE_F32, IN_ID>(fh, fl, bias, t2, nullptr, 0.f, idx, count, B, C, mid, H, W, base, sgn, nullptr, sub, out, s);
    case MODE_BF16: return (int)launch_conv3x3_out<MODE_BF16, IN_ID>(fh, fl, bias, t2, nullptr, 0.f, idx, count, B, C, mid, H, W, base, sgn, nullptr, sub, out, s);
    case MODE_TF32: return (int)conv3x3_out_tc_solve(3, groups, wh, wl, bias, t2, idx, count, B, C, mid, H, W, base, sgn, sub, out, s);
    case MODE_TF32X: return (int)conv3x3_out_tc_solve(4, groups, wh, wl, bias, t2, idx, count, B, C, mid, H, W, base, sgn, sub, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
