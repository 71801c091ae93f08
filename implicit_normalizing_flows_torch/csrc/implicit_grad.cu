// Hopper (sm_90a) kernels of the implicit gradient: the backward Broyden
// solve u (I + J_gz) = grad and the re-attachment VJP.
//
// Replaces the TPU kernels implicit_normalizing_flows_tpu/ops/fused_solve.py
// ::fused_backward_solve (:930; _backward_kernel :893, _make_apply_jt :867)
// and ::fused_reattach_vjp (:1226; _reattach_vjp_kernel :1146,
// _net_vjp_in_kernel :1093). The TPU kernels keep one example's
// linearisation (s0, s1, s2) or forward intermediates resident in VMEM and
// accumulate the weight gradients across the sequential grid in VMEM tiles.
// On Hopper the blocks run in parallel, so the work is re-cut into batched
// kernels over the whole batch, written once and shared through
// conv_gemm.cuh:
//
// backward solve (host loop; broyden_step of fused_solve.cu does the
// secant algebra, on the same active lists):
//   jt_conv3x3_in   C3^T u * s2          c -> mid, flipped w3
//                   (bf16: tensor cores, conv3x3_in_tc.cuh, linked from
//                   conv3x3_in_tc.cu; w3t cast to bfloat16 once per solve)
//   jt_conv1x1_mid  C2^T t * s1          mid -> mid, w2^T        (tiled GEMM)
//   jt_conv3x3_out  u + s0 * C1^T t - grad   mid -> c, flipped w1
//                   (bf16: tensor cores)
// re-attachment VJP, per net (x at x with cotangent u; z at z_hat with -u):
//   rv_conv3x3_in   h1 = W1 [swish](h) + b1, and t2 = sign * C3^T u
//                   (bf16: tensor cores, conv3x3_in_tc.cuh's EPI_AFFINE;
//                   w1 and w3t cast to bfloat16 once per VJP)
//   rv_conv1x1_mid  h2 = W2 swish(h1) + b2, and t1 = C2^T (t2 swish'(h2))
//                   (bf16: tensor cores)
//   rv_conv3x3_out  t0 = C1^T (t1 swish'(h1))   (bf16: tensor cores)
//   rv_wgrad        split-K partial sums of dW3 = cot x shift(swish(h2)),
//                   dW2 = t2 swish'(h2) x swish(h1), dW1 = t1 swish'(h1) x
//                   shift(a0), summed over batch x pixels
//   rv_wgrad_reduce the fixed-order sum over the splits (deterministic: no
//                   float atomics)
//   (rv_wgrad, with a pre-activated B operand, and rv_wgrad_reduce also
//   make the weight gradients of the estimator's final pair, estimator.cu)
//   rv_chan_sums    per-channel bias grads and swish-slope grads
//                   (sum t swish'(h), sum t dswish/dbeta(h)), and
//                   d_x = u + t0 swish'(x): its own unit, chan_sums.cu
//                   (a thread-block cluster a channel), linked beside this
//
// Precision: the backward solve honours mode f32 | bf16 (IMNF_BWD_PRECISION),
// the re-attachment f32 | bf16 | tf32 (IMNF_REATTACH_PRECISION): every
// product rounds both operands as _make_dot / _make_wdot do, f32 sums. The
// backward solve reads s0/s1/s2 as the linearisation stores them, bfloat16
// in mode bf16 (as the TPU kernel takes them), which halves their traffic.
//
// What bounds them on H100. On the CUDA cores, FP32 operations: one J^T
// application at 32x32 is ~296M MACs per example (268M in the 1x1); the
// re-attachment is ~3 x 296M per net and example (forward, cotangent and
// weight-gradient products). The GEMMs keep 64x64 tiles in shared memory
// with a 4x4 register micro-tile per thread (16 FMAs per loaded element);
// the weight gradients, which reduce over batch x pixels (65,536 terms at
// 32x32), split that reduction into whole examples over enough blocks to
// fill the 132 SMs and sum the splits in a second pass. In mode bf16 every
// product runs on the tensor cores, where bytes bound them:
// jt_conv1x1_mid on mma_gemm.cuh's 1x1 kernel (EPI_SCALE, on the active
// list), rv_conv1x1_mid on the same kernel (EPI_AFFINE, its swish / swish'
// applied once per element as the panel is staged, W2 / W2^T bfloat16, the
// slope read on the device), rv_wgrad on wgrad_tc.cuh (a bf16 pre-pass, then the product),
// rv_conv3x3_out on conv3x3_out_tc.cuh (t1 swish'(h1) formed once per
// element into a halo tile, the 9 taps as shifted reads of it) and
// jt_conv3x3_out on the same kernel (t rounded once per element into the
// tile, the residual in its epilogue, on the active list), and
// jt_conv3x3_in on conv3x3_in_tc.cuh (an im2col tile per band, the scale by
// example in the epilogue, on the active list) and rv_conv3x3_in on that
// kernel's EPI_AFFINE (its swish applied once per loaded halo element, the
// slope read on the device, alpha and the bias in the epilogue, on the
// active list); those headers'
// notes give their bounds and designs. Modes f32 / tf32 stay on the CUDA
// cores.

#include "conv3x3_in_tc.cuh"
#include "conv3x3_out_tc.cuh"
#include "wgrad_tc.cuh"

namespace {

using namespace imnf;

// ---------------------------------------------------------------------------
// weight gradients: part[split][m][n] = sum over k = (b, p) in the split of
//   A(b, m, p) * B(b, n, p)
// A = a[b][m][p] (AIN IN_ID) or a * swish'(ah; *beta_a) (AIN IN_DSWISH)
// B = BIN(bsrc[b][n][p]) (BSH 0) or, with n = ci*9 + ky*3 + kx,
//     BIN(bsrc[b][ci][p shifted by (ky-1, kx-1)]) with zero padding (BSH 1)
// BIN: IN_ID, IN_SWISH(*beta_b) or IN_DSWISH (bsrc * swish'(bh; *beta_b), bh
// in bsrc's layout). The slopes are read on the device (nullptr where the
// transform takes none). Both operands split in MODE.
// The caller guarantees HW % WG_BK == 0 and kchunk % WG_BK == 0, so a K
// step never straddles two examples: (b, p) are worked out once per step.
constexpr int WG_BN = 64, WG_BK = 16, WG_THREADS = 256;

template <int MODE, int WBM, int AIN, int BIN, int BSH>
__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(
    const float* __restrict__ a, const float* __restrict__ ah,
    const float* __restrict__ beta_a_p, const float* __restrict__ bsrc,
    const float* __restrict__ bh, const float* __restrict__ beta_b_p, int M,
    int N, int Cb, int H, int W, int Bn, long long kchunk,
    float* __restrict__ part) {
  constexpr int WTM = WBM / 16, WTN = 4;
  const float beta_a = AIN == IN_ID ? 0.f : *beta_a_p;
  const float beta_b = BIN == IN_ID ? 0.f : *beta_b_p;
  const int HW = H * W;
  const long long ktot = (long long)Bn * HW;
  const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.y * WBM;
  const long long kbeg = (long long)blockIdx.z * kchunk;
  const long long kend = min(ktot, kbeg + kchunk);
  // +1 column: the loads walk k fastest, so unpadded rows would put all
  // 16 k of one m (or n) in one bank
  __shared__ float As[2][WG_BK][WBM + 1];
  __shared__ float Bs[2][WG_BK][WG_BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[WTM][WTN];
#pragma unroll
  for (int i = 0; i < WTM; ++i)
#pragma unroll
    for (int j = 0; j < WTN; ++j) acc[i][j] = 0.f;

  for (long long k0 = kbeg; k0 < kend; k0 += WG_BK) {
    const int b = (int)(k0 / HW), p0 = (int)(k0 % HW);
    for (int i = tid; i < WBM * WG_BK; i += WG_THREADS) {
      const int mm = i / WG_BK, kk = i % WG_BK, m = m0 + mm;
      float v = 0.f;
      if (m < M && k0 + kk < kend) {
        const size_t off = ((size_t)b * M + m) * HW + p0 + kk;
        v = in_xform<AIN>(a[off], ah, off, beta_a);
      }
      float h, l;
      split(v, MODE, h, l);
      As[0][kk][mm] = h;
      As[1][kk][mm] = l;
    }
    for (int i = tid; i < WG_BN * WG_BK; i += WG_THREADS) {
      const int nn = i / WG_BK, kk = i % WG_BK, n = n0 + nn;
      float v = 0.f;
      if (n < N && k0 + kk < kend) {
        const int p = p0 + kk;
        int ch = n, yy = p / W, xx = p % W;
        if (BSH) {
          ch = n / 9;
          const int d = n % 9;
          yy += d / 3 - 1;
          xx += d % 3 - 1;
        }
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          const size_t off = ((size_t)b * Cb + ch) * HW + yy * W + xx;
          v = in_xform<BIN>(bsrc[off], bh, off, beta_b);
        }
      }
      float h, l;
      split(v, MODE, h, l);
      Bs[0][kk][nn] = h;
      Bs[1][kk][nn] = l;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WG_BK; ++kk) {
      float ahv[WTM], alv[WTM], bhv[WTN], blv[WTN];
#pragma unroll
      for (int i = 0; i < WTM; ++i) {
        ahv[i] = As[0][kk][ty * WTM + i];
        alv[i] = As[1][kk][ty * WTM + i];
      }
#pragma unroll
      for (int j = 0; j < WTN; ++j) {
        bhv[j] = Bs[0][kk][tx * WTN + j];
        blv[j] = Bs[1][kk][tx * WTN + j];
      }
#pragma unroll
      for (int i = 0; i < WTM; ++i)
#pragma unroll
        for (int j = 0; j < WTN; ++j)
          acc[i][j] = mac<MODE>(acc[i][j], ahv[i], alv[i], bhv[j], blv[j]);
    }
    __syncthreads();
  }
  float* o = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < WTM; ++i) {
    const int m = m0 + ty * WTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < WTN; ++j) {
      const int n = n0 + tx * WTN + j;
      if (n < N) o[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = alpha * sum_{s < S} part[s][i], the splits in order
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, int S,
                                    long long MN, float alpha,
                                    float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * MN + i];
  out[i] = alpha * s;
}

// ---------------------------------------------------------------------------
// host-side dispatch

// The J^T stages read their derivative factors s0/s1/s2 as stored: float32
// (ST float) or bfloat16 (ST __nv_bfloat16, mode bf16's linearisation).
// C3^T u * s2: mode bf16 on the tensor cores (w bf16, conv3x3_in_tc.cu),
// mode f32 on the CUDA cores (w float32)
template <typename ST>
cudaError_t jt_in_mode(int mode, const void* w, int M, const float* inp, const int* idx,
                       const int* count, int B, int C, int H, int W, const void* scale,
                       float* out, cudaStream_t s) {
  const ST* sc = static_cast<const ST*>(scale);
  switch (mode) {
    case MODE_F32: return launch_conv_gemm<MODE_F32, 0, IN_ID, EPI_SCALE, ST>(static_cast<const float*>(w), nullptr, nullptr, M, C * 9, inp, nullptr, idx, count, B, C, H, W, 0.f, 0.f, 1.f, sc, out, s);
    case MODE_BF16: return conv3x3_in_tc_jt(static_cast<const __nv_bfloat16*>(w), inp, idx, count, B, C, H, W, M, sc, out, s);
  }
  return cudaErrorInvalidValue;
}

// C2^T t * s1: mode bf16 on the tensor cores (w bf16), mode f32 on the
// CUDA cores (w float32)
template <typename ST>
cudaError_t jt_mid_mode(int mode, const void* w, int mid, const float* inp,
                        const int* idx, const int* count, int B, int H, int W,
                        const void* scale, float* out, cudaStream_t s) {
  const ST* sc = static_cast<const ST*>(scale);
  switch (mode) {
    case MODE_F32: return launch_conv_gemm<MODE_F32, 1, IN_ID, EPI_SCALE, ST>(static_cast<const float*>(w), nullptr, nullptr, mid, mid, inp, nullptr, idx, count, B, mid, H, W, 0.f, 0.f, 1.f, sc, out, s);
    case MODE_BF16: return launch_tc_conv1x1<EPI_SCALE>(static_cast<const __nv_bfloat16*>(w), mid, mid, inp, B, 1, H * W, sc, out, s, idx, count);
  }
  return cudaErrorInvalidValue;
}

// u + s0 C1^T t - grad: mode bf16 on the tensor cores, mode f32 on the CUDA
// cores (w_lo unused in both)
template <typename ST>
cudaError_t jt_out_mode(int mode, const float* w_hi, const float* w_lo,
                        const float* t, const int* idx, const int* count, int B,
                        int C, int mid, int H, int W, const float* base,
                        const void* scale, const float* sub, float* out,
                        cudaStream_t s) {
  const ST* sc = static_cast<const ST*>(scale);
  switch (mode) {
    case MODE_F32: return launch_conv3x3_out<MODE_F32, IN_ID, ST>(w_hi, w_lo, nullptr, t, nullptr, 0.f, idx, count, B, C, mid, H, W, base, 1.f, sc, sub, out, s);
    case MODE_BF16: return launch_jt_conv3x3_out_tc<ST>(w_hi, t, idx, count, B, C, mid, H, W, base, sc, sub, out, s);
  }
  return cudaErrorInvalidValue;
}

// act: 0 IN_ID, 1 IN_SWISH, 2 IN_DSWISH; SRC 0 the 3x3 convs, SRC 1 the
// 1x1; the slope *beta_net, on the device
template <int MODE, int SRC>
cudaError_t rv_gemm(int act, const float* w_hi, const float* w_lo,
                    const float* bias, int M, int K, const float* inp,
                    const float* inh, const int* idx, const int* count, int B,
                    int C, int H, int W, const float* beta_net,
                    float alpha, float* out, cudaStream_t s) {
#define RV_GEMM(IN)                                                          \
  return launch_conv_gemm<MODE, SRC, IN, EPI_AFFINE>(                        \
      w_hi, w_lo, bias, M, K, inp, inh, idx, count, B, C, H, W, 0.f,         \
      0.f, alpha, nullptr, out, s, 1, beta_net)
  if constexpr (SRC == 0) {
    if (act == IN_ID) RV_GEMM(IN_ID);
    if (act == IN_SWISH) RV_GEMM(IN_SWISH);
  } else {
    if (act == IN_SWISH) RV_GEMM(IN_SWISH);
    if (act == IN_DSWISH) RV_GEMM(IN_DSWISH);
  }
#undef RV_GEMM
  return cudaErrorInvalidValue;
}

// rv_conv1x1_mid in mode bf16 on the tensor cores: W (mid, mid) bfloat16,
// every slot below *count, no idx, alpha 1 (both call sites; anything else
// is refused, not ignored)
cudaError_t rv_mid_tc(int act, const __nv_bfloat16* w, const float* bias, float alpha,
                      const float* beta, const float* inp, const float* inh,
                      const int* count, int B, int mid, int HW, float* out,
                      cudaStream_t s) {
  const float* no_scale = nullptr;
  if (alpha != 1.f) return cudaErrorInvalidValue;
  if (act == IN_SWISH)
    return launch_tc_conv1x1<EPI_AFFINE, IN_SWISH>(w, mid, mid, inp, B, 1, HW, no_scale, out, s,
                                                   nullptr, count, nullptr, beta, bias);
  if (act == IN_DSWISH)
    return launch_tc_conv1x1<EPI_AFFINE, IN_DSWISH>(w, mid, mid, inp, B, 1, HW, no_scale, out, s,
                                                    nullptr, count, inh, beta, bias);
  return cudaErrorInvalidValue;
}

// The weight gradients of the path, by (AIN, BIN, BSH):
//   re-attachment  dW3 (ID, SWISH, 1), dW2 (DSWISH, SWISH, 0),
//                  dW1 (DSWISH, ID | SWISH, 1)
//   final pair     dW3 (ID, DSWISH, 1), dW2 (ID, DSWISH | SWISH, 0),
//                  dW1 (ID, ID | SWISH | DSWISH, 1)
// On the CUDA cores (modes f32, tf32): 16-row tiles when M < 64 (dW3: M =
// c is small), else 64. Mode bf16 runs wgrad_tc.cuh.
template <int MODE, int WBM>
cudaError_t wgrad_launch(int ain, int bin, int shift, dim3 grid,
                         const float* a, const float* ah, const float* beta_a,
                         const float* bsrc, const float* bh,
                         const float* beta_b, int M, int N, int Cb, int H,
                         int W, int Bn, long long kchunk, float* part,
                         cudaStream_t s) {
#define WG(AIN, BIN, BSH)                                                    \
  if (ain == AIN && bin == BIN && shift == BSH) {                            \
    wgrad_kernel<MODE, WBM, AIN, BIN, BSH><<<grid, WG_THREADS, 0, s>>>(      \
        a, ah, beta_a, bsrc, bh, beta_b, M, N, Cb, H, W, Bn, kchunk, part);  \
    return cudaGetLastError();                                               \
  }
  WG(IN_ID, IN_SWISH, 1);
  WG(IN_ID, IN_DSWISH, 1);
  WG(IN_ID, IN_ID, 1);
  WG(IN_ID, IN_SWISH, 0);
  WG(IN_ID, IN_DSWISH, 0);
  WG(IN_DSWISH, IN_SWISH, 0);
  WG(IN_DSWISH, IN_ID, 1);
  WG(IN_DSWISH, IN_SWISH, 1);
#undef WG
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t wgrad_mode(int ain, int bin, int shift, const float* a,
                       const float* ah, const float* beta_a, const float* bsrc,
                       const float* bh, const float* beta_b, int M, int N,
                       int Cb, int H, int W, int Bn, int splits,
                       long long kchunk, float* part, cudaStream_t s) {
  const int wbm = M < 64 ? 16 : 64;
  const dim3 grid((N + WG_BN - 1) / WG_BN, (M + wbm - 1) / wbm, splits);
  if (wbm == 16)
    return wgrad_launch<MODE, 16>(ain, bin, shift, grid, a, ah, beta_a, bsrc, bh, beta_b, M, N, Cb, H, W, Bn, kchunk, part, s);
  return wgrad_launch<MODE, 64>(ain, bin, shift, grid, a, ah, beta_a, bsrc, bh, beta_b, M, N, Cb, H, W, Bn, kchunk, part, s);
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() right after its launch (0 on success).

// The J^T entry points take their scale (s2, s1, s0) as float32 or, with
// scale_bf16, as bfloat16.
// w: W3^T (mid, C, 3, 3), bfloat16 in mode bf16 (the tensor cores'
// operand), float32 in mode f32 (both modes are single-pass)
int imnf_jt_conv3x3_in(int mode, const void* w, const float* inp, const int* idx,
                       const int* count, const void* scale, int scale_bf16, int B, int C,
                       int H, int W, int mid, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (scale_bf16)
    return (int)jt_in_mode<__nv_bfloat16>(mode, w, mid, inp, idx, count, B, C, H, W, scale, out, s);
  return (int)jt_in_mode<float>(mode, w, mid, inp, idx, count, B, C, H, W, scale, out, s);
}

// w: W2^T (mid, mid), bfloat16 in mode bf16 (the tensor cores' operand),
// float32 in mode f32; w_lo unused (both modes are single-pass)
int imnf_jt_conv1x1_mid(int mode, const void* w, const float* w_lo,
                        const float* inp, const int* idx, const int* count,
                        const void* scale, int scale_bf16, int B, int mid,
                        int H, int W, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  (void)w_lo;
  if (scale_bf16)
    return (int)jt_mid_mode<__nv_bfloat16>(mode, w, mid, inp, idx, count, B, H, W, scale, out, s);
  return (int)jt_mid_mode<float>(mode, w, mid, inp, idx, count, B, H, W, scale, out, s);
}

int imnf_jt_conv3x3_out(int mode, const float* w_hi, const float* w_lo,
                        const float* t, const int* idx, const int* count,
                        int B, int C, int mid, int H, int W, const float* base,
                        const void* scale, int scale_bf16, const float* sub,
                        float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (scale_bf16)
    return (int)jt_out_mode<__nv_bfloat16>(mode, w_hi, w_lo, t, idx, count, B, C, mid, H, W, base, scale, sub, out, s);
  return (int)jt_out_mode<float>(mode, w_hi, w_lo, t, idx, count, B, C, mid, H, W, base, scale, sub, out, s);
}

// w_hi: W1 or W3^T (mid, C, 3, 3), bfloat16 in mode bf16 (the tensor cores'
// operand, conv3x3_in_tc.cuh's EPI_AFFINE, linked from conv3x3_in_tc.cu),
// float32 in modes f32 / tf32 (w_lo its lo half in tf32); beta: a device
// pointer to the input transform's slope (nullptr for act IN_ID)
int imnf_rv_conv3x3_in(int mode, int act, const void* w_hi,
                       const float* w_lo, const float* bias, float alpha,
                       const float* beta, const float* inp, const int* idx,
                       const int* count, int B, int C, int H, int W, int mid,
                       float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* wf = static_cast<const float*>(w_hi);
  switch (mode) {
    case MODE_F32: return (int)rv_gemm<MODE_F32, 0>(act, wf, w_lo, bias, mid, C * 9, inp, nullptr, idx, count, B, C, H, W, beta, alpha, out, s);
    case MODE_BF16: return (int)conv3x3_in_tc_affine(static_cast<const __nv_bfloat16*>(w_hi), bias, alpha, act, beta, inp, idx, count, B, C, H, W, mid, out, s);
    case MODE_TF32: return (int)rv_gemm<MODE_TF32, 0>(act, wf, w_lo, bias, mid, C * 9, inp, nullptr, idx, count, B, C, H, W, beta, alpha, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w_hi: W (mid, mid), bfloat16 in mode bf16 (the tensor cores' operand),
// float32 in modes f32 / tf32 (w_lo its lo half in tf32); beta: a device
// pointer to the input transform's slope
int imnf_rv_conv1x1_mid(int mode, int act, const void* w_hi,
                        const float* w_lo, const float* bias, float alpha,
                        const float* beta, const float* inp, const float* inh,
                        const int* count, int B, int mid, int H, int W,
                        float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* wf = static_cast<const float*>(w_hi);
  switch (mode) {
    case MODE_F32: return (int)rv_gemm<MODE_F32, 1>(act, wf, w_lo, bias, mid, mid, inp, inh, nullptr, count, B, mid, H, W, beta, alpha, out, s);
    case MODE_BF16: return (int)rv_mid_tc(act, static_cast<const __nv_bfloat16*>(w_hi), bias, alpha, beta, inp, inh, count, B, mid, H * W, out, s);
    case MODE_TF32: return (int)rv_gemm<MODE_TF32, 1>(act, wf, w_lo, bias, mid, mid, inp, inh, nullptr, count, B, mid, H, W, beta, alpha, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

int imnf_rv_conv3x3_out(int mode, const float* w_hi, const float* w_lo,
                        const float* t, const float* th, float beta_in,
                        const int* idx, const int* count, int B, int C,
                        int mid, int H, int W, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_F32: return (int)launch_conv3x3_out<MODE_F32, IN_DSWISH>(w_hi, w_lo, nullptr, t, th, beta_in, idx, count, B, C, mid, H, W, nullptr, 1.f, nullptr, nullptr, out, s);
    case MODE_BF16: return (int)launch_conv3x3_out_tc(w_hi, t, th, beta_in, idx, count, B, C, mid, H, W, out, s);
    case MODE_TF32: return (int)launch_conv3x3_out<MODE_TF32, IN_DSWISH>(w_hi, w_lo, nullptr, t, th, beta_in, idx, count, B, C, mid, H, W, nullptr, 1.f, nullptr, nullptr, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ain, bin: 0 IN_ID, 1 IN_SWISH, 2 IN_DSWISH; beta_a, beta_b device
// pointers to the slopes (nullptr where unused); a16 (Bn, M, HW) and b16
// (Bn, Cb, HW) bfloat16 scratch of mode bf16's pre-pass (nullptr in the
// other modes)
int imnf_rv_wgrad(int mode, int ain, int bin, int shift, const float* a,
                  const float* ah, const float* beta_a, const float* bsrc,
                  const float* bh, const float* beta_b, int M, int N, int Cb,
                  int H, int W, int Bn, int splits, long long kchunk,
                  void* a16, void* b16, float* part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_F32: return (int)wgrad_mode<MODE_F32>(ain, bin, shift, a, ah, beta_a, bsrc, bh, beta_b, M, N, Cb, H, W, Bn, splits, kchunk, part, s);
    case MODE_BF16: return (int)launch_wgrad_tc(ain, bin, shift, a, ah, beta_a, bsrc, bh, beta_b, M, N, Cb, H, W, Bn, splits, kchunk, static_cast<__nv_bfloat16*>(a16), static_cast<__nv_bfloat16*>(b16), part, s);
    case MODE_TF32: return (int)wgrad_mode<MODE_TF32>(ain, bin, shift, a, ah, beta_a, bsrc, bh, beta_b, M, N, Cb, H, W, Bn, splits, kchunk, part, s);
  }
  return (int)cudaErrorInvalidValue;
}

int imnf_rv_wgrad_reduce(const float* part, int S, long long MN, float alpha,
                         float* out, void* stream) {
  const int threads = 256;
  const long long blocks = (MN + threads - 1) / threads;
  wgrad_reduce_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      part, S, MN, alpha, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
