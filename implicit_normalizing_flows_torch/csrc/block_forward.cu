// Hopper (sm_90a) kernels of the merged implicit-block forward: the
// linearisation variants of the forward solve's first two convs, which also
// write the float32 derivative factors of both nets' Neumann chains.
//
// Replaces the TPU kernel implicit_normalizing_flows_tpu/ops/fused_solve.py
// ::fused_block_forward (:1814; _block_fwd_kernel :1706). The TPU kernel
// runs one example's whole block forward per grid step: the solve, one more
// net-z evaluation at the best iterate, and both chains, with the
// activation derivatives s0/s1/s2 built from the solve's own
// pre-activations and kept in VMEM (up to 120 MiB), so they never touch
// HBM. An H100 SM holds 227 KB of shared memory, so the work is cut into
// four stages driven from the host (ops/fused_block.py):
//
//   A. the solve: fused_solve.cu's kernels, except that the phase-1
//      evaluation of net x at x runs the linearisation variants below;
//   B. net z once more at the best iterate, in the phase-1 mode, through the
//      same variants (its last conv is not needed);
//   C. both nets' chains on estimator.cu's nc_jt_* kernels, which read the
//      float32 s0/s1/s2 of stages A-B (the split path gives them bf16
//      ones): _make_apply_jt (:867) with _make_wdot('bf16' | 'f32');
//   D. the protective-break patch, PyTorch glue in the caller.
//
//   lin_conv3x3_in   [swish(b0)] conv3x3 c->mid + b1: writes swish(h1) for
//                    the next conv, s1 = swish'(h1) and, under preact,
//                    s0 = swish'(x; b0), all float32
//   lin_conv1x1_mid  mid->mid + b2: writes swish(h2) and s2 = swish'(h2)
//
// Precision: the solve's modes (conv_gemm.cuh); the derivative factors are
// float32 swish' of the float32 pre-activations of the solve's own
// evaluation, as the TPU kernel takes them (:1790-1793).
//
// What bounds them on H100: in the split modes tf32 / tf32x both run on the
// tensor cores. lin_conv1x1_mid (~90% of the MACs) on mma_gemm.cuh's 1x1
// kernel (EPI_SWISH_LIN: the bf16 split's 3 / 4 wgmma passes, as the
// forward solve's conv1x1_mid, with s2 written beside swish(h2)), where its
// products bound it; lin_conv3x3_in on conv3x3_in_tc.cuh's mma.sync kernel
// (EPI_SWISH_LIN: the split's 3 / 4 passes on an im2col tile built once per
// band, swish(h1) and s1 written as 16-byte stores), bound by those bytes.
// Modes f32 / bf16 run on the CUDA cores (conv_gemm.cuh), bound by their
// FP32 products. The linearisation adds two float32 writes of 512 x
// HW per example to an evaluation (s1 + s2 of both nets at 32x32, B = 64:
// 512 MiB, held in HBM between stages B and C, and streamed once per chain
// term). Keeping them on chip is later work.

#include "mma_gemm.cuh"
#include "conv3x3_in_tc.cuh"

namespace {

using namespace imnf;

// the 3x3 c -> mid conv on the CUDA cores (modes f32, bf16)
template <int MODE>
cudaError_t lin_in(int preact, const float* w_hi, const float* w_lo,
                   const float* bias, int M, int K, const float* inp, int B, int C,
                   int H, int W, float beta_pre, float beta_post, float* out,
                   float* s, float* s0, cudaStream_t st) {
  if (preact)
    return launch_conv_gemm<MODE, 0, IN_SWISH, EPI_SWISH_LIN>(
        w_hi, w_lo, bias, M, K, inp, nullptr, nullptr, nullptr, B, C, H, W,
        beta_pre, beta_post, 1.f, nullptr, out, st, 1, nullptr, s, s0);
  return launch_conv_gemm<MODE, 0, IN_ID, EPI_SWISH_LIN>(
      w_hi, w_lo, bias, M, K, inp, nullptr, nullptr, nullptr, B, C, H, W,
      beta_pre, beta_post, 1.f, nullptr, out, st, 1, nullptr, s, nullptr);
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() right after its launch (0 on success). Every example is
// live (no active list): slot s is example s.

// out, s1 (B, mid, HW); s0 (B, C, HW), written under preact only. w_hi /
// w_lo: W1's split (mid, C, 3, 3), bfloat16 in modes tf32 / tf32x (the
// tensor cores' operands, cast once per solve), float32 in modes f32 / bf16
// (the CUDA cores)
int imnf_lin_conv3x3_in(int mode, int preact, const void* w_hi,
                        const void* w_lo, const float* bias, float beta0,
                        float beta1, const float* inp, int B, int C, int H,
                        int W, int mid, float* out, float* s1, float* s0,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* fh = static_cast<const float*>(w_hi);
  const float* fl = static_cast<const float*>(w_lo);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  switch (mode) {
    case MODE_F32: return (int)lin_in<MODE_F32>(preact, fh, fl, bias, mid, C * 9, inp, B, C, H, W, beta0, beta1, out, s1, s0, s);
    case MODE_BF16: return (int)lin_in<MODE_BF16>(preact, fh, fl, bias, mid, C * 9, inp, B, C, H, W, beta0, beta1, out, s1, s0, s);
    case MODE_TF32: return (int)conv3x3_in_tc_lin(3, wh, wl, bias, inp, B, C, H, W, mid, preact, beta0, beta1, out, s1, s0, s);
    case MODE_TF32X: return (int)conv3x3_in_tc_lin(4, wh, wl, bias, inp, B, C, H, W, mid, preact, beta0, beta1, out, s1, s0, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w_hi / w_lo: W2's split, bfloat16 in modes tf32 / tf32x (the tensor
// cores' operands, cast once per solve), float32 in modes f32 / bf16 (the
// CUDA cores; w_lo unused there)
int imnf_lin_conv1x1_mid(int mode, const void* w_hi, const void* w_lo,
                         const float* bias, float beta2, const float* inp,
                         int B, int mid, int H, int W, float* out, float* s2,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  const float* fh = static_cast<const float*>(w_hi);
  const float* no_scale = nullptr;
  switch (mode) {
    case MODE_F32: return (int)launch_conv_gemm<MODE_F32, 1, IN_ID, EPI_SWISH_LIN>(fh, nullptr, bias, mid, mid, inp, nullptr, nullptr, nullptr, B, mid, H, W, 0.f, beta2, 1.f, nullptr, out, s, 1, nullptr, s2);
    case MODE_BF16: return (int)launch_conv_gemm<MODE_BF16, 1, IN_ID, EPI_SWISH_LIN>(fh, nullptr, bias, mid, mid, inp, nullptr, nullptr, nullptr, B, mid, H, W, 0.f, beta2, 1.f, nullptr, out, s, 1, nullptr, s2);
    case MODE_TF32: return (int)launch_tc_conv1x1<EPI_SWISH_LIN, IN_ID, 3>(wh, mid, mid, inp, B, 1, H * W, no_scale, out, s, nullptr, nullptr, nullptr, nullptr, bias, wl, beta2, s2);
    case MODE_TF32X: return (int)launch_tc_conv1x1<EPI_SWISH_LIN, IN_ID, 4>(wh, mid, mid, inp, B, 1, H * W, no_scale, out, s, nullptr, nullptr, nullptr, nullptr, bias, wl, beta2, s2);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
