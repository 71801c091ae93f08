// Shared device code of the port's Hopper (sm_90a) kernels: the precision
// model, the swish family, the two conv kernels every net evaluation is
// made of, templated on where their operands come from, how the input is
// transformed on load and what the epilogue writes. fused_solve.cu (forward
// solve), implicit_grad.cu (backward solve, re-attachment VJP) and
// estimator.cu (Neumann chain, final pair) instantiate them; nothing here
// is launched on its own.
//
// Active lists: the conv kernels run slot s < *count on example idx[s];
// with idx and count nullptr every slot is live and slot s is example s.
// Several nets in one launch: the conv kernels take the examples of N nets
// stacked along the batch (nb examples each, all live); slot s belongs to
// net s / nb, whose weights follow the previous net's in w_hi / w_lo, whose
// bias follows in bias, and whose input slope is beta_net[net] when
// beta_net is given. One net: nb = B.
//
// Precision: every product honours mode 0 f32 (FP32 FMAs), 1 bf16 (hi*hi),
// 2 tf32 (hi*hi + hi*lo + lo*hi), 3 tf32x (+ lo*lo), with hi/lo the bf16
// round-to-nearest split of each operand (__float2bfloat16_rn), exactly the
// JAX kernels' _make_dot/_make_wdot error model. Products of two bf16 values
// are exact in FP32, so only the order of the f32 sums differs. Weight-side
// splits are prepared once by the caller (w_hi / w_lo); activation-side
// splits happen here, after the input transform.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace imnf {

enum { MODE_F32 = 0, MODE_BF16 = 1, MODE_TF32 = 2, MODE_TF32X = 3 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void split(float v, int mode, float& hi, float& lo) {
  if (mode == MODE_F32) { hi = v; lo = 0.f; return; }
  hi = bf16_round(v);
  lo = (mode >= MODE_TF32) ? bf16_round(v - hi) : 0.f;
}

template <int MODE>
__device__ __forceinline__ float mac(float acc, float ah, float al, float bh, float bl) {
  acc = fmaf(ah, bh, acc);
  if (MODE >= MODE_TF32) {
    acc = fmaf(ah, bl, acc);
    acc = fmaf(al, bh, acc);
  }
  if (MODE == MODE_TF32X) acc = fmaf(al, bl, acc);
  return acc;
}

// swish(t; b) = t * sigmoid(b t) / 1.1 and its derivatives in t and b
// (_swish, _dswish, _dswish_dbeta of the JAX kernels). Each is rounded
// operation by operation in the order the plain PyTorch versions (and the
// JAX kernels) take them, with their constant f32(1/1.1) (not 1.0f/1.1f,
// one ulp below it), and the __f*_rn intrinsics keep nvcc from contracting
// a product and a sum into one FMA. So an operand computed on load is the
// plain version's to the bit and rounds to the same bfloat16.
constexpr float INV_1_1 = (float)(1.0 / 1.1);

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float swish(float t, float beta) {
  return __fmul_rn(__fmul_rn(t, sigm(__fmul_rn(t, beta))), INV_1_1);
}

__device__ __forceinline__ float dswish(float t, float beta) {
  const float tb = __fmul_rn(t, beta), s = sigm(tb);
  const float d = __fmul_rn(__fmul_rn(tb, s), __fsub_rn(1.f, s));
  return __fmul_rn(__fadd_rn(s, d), INV_1_1);
}

__device__ __forceinline__ float dswish_dbeta(float t, float beta) {
  const float s = sigm(__fmul_rn(t, beta));
  return __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(t, t), s), __fsub_rn(1.f, s)), INV_1_1);
}

// dswish and dswish_dbeta from one sigmoid, each rounded as those two round it
__device__ __forceinline__ void dswish_pair(float t, float beta, float& d, float& db) {
  const float tb = __fmul_rn(t, beta), s = sigm(tb), r = __fsub_rn(1.f, s);
  d = __fmul_rn(__fadd_rn(s, __fmul_rn(__fmul_rn(tb, s), r)), INV_1_1);
  db = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(t, t), s), r), INV_1_1);
}

// d^2/dt^2 and d/dbeta of swish'(t; b) (_d2swish, _ddswish_dbeta of the JAX
// kernels), with sp = s (1 - s):
//   ((2 b) sp + (((b b) t) (1 - 2 s)) sp) / 1.1
//   ((2 t) sp + (((b t) t) (1 - 2 s)) sp) / 1.1
__device__ __forceinline__ float d2swish(float t, float beta) {
  const float s = sigm(__fmul_rn(t, beta));
  const float sp = __fmul_rn(s, __fsub_rn(1.f, s)), c = __fsub_rn(1.f, __fmul_rn(2.f, s));
  const float a = __fmul_rn(__fmul_rn(2.f, beta), sp);
  const float b = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(beta, beta), t), c), sp);
  return __fmul_rn(__fadd_rn(a, b), INV_1_1);
}

__device__ __forceinline__ float ddswish_dbeta(float t, float beta) {
  const float s = sigm(__fmul_rn(t, beta));
  const float sp = __fmul_rn(s, __fsub_rn(1.f, s)), c = __fsub_rn(1.f, __fmul_rn(2.f, s));
  const float a = __fmul_rn(__fmul_rn(2.f, t), sp);
  const float b = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(beta, t), t), c), sp);
  return __fmul_rn(__fadd_rn(a, b), INV_1_1);
}

// A derivative factor as stored: float32, or bfloat16 (the backward solve's
// s0/s1/s2 in mode bf16, from net z run in bfloat16), read once and widened.
__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Keeps a launcher's scale type out of argument deduction, so that callers
// without a scale pass nullptr and get the float32 default.
template <class T> struct ident { using type = T; };

// Input transforms, applied to an element v of a conv's input as it is
// loaded (h: the matching pre-activation, same layout as the input):
//   IN_ID v;  IN_SWISH swish(v; beta);  IN_DSWISH v * swish'(h; beta).
enum { IN_ID = 0, IN_SWISH = 1, IN_DSWISH = 2 };

template <int IN>
__device__ __forceinline__ float in_xform(float v, const float* h, size_t off, float beta) {
  if (IN == IN_SWISH) return swish(v, beta);
  if (IN == IN_DSWISH) return __fmul_rn(v, dswish(__ldg(h + off), beta));
  return v;
}

// ---------------------------------------------------------------------------
// GEMM-shaped convs: out[slot][m][p] = EPI(sum_k W[m][k] * Bop[k][p])
// SRC 0: Bop = im2col of IN(inp[idx[slot]]) (conv3x3, K = C*9,
//        k = ci*9 + ky*3 + kx, the natural OIHW flattening of W)
// SRC 1: Bop = IN(inp[slot]) (K x HW, conv1x1)
// EPI_SWISH  swish(acc + bias[m]; beta_out)           (forward solve)
// EPI_AFFINE alpha * acc [+ bias[m]]                  (pre-activations, raw
//                                                      cotangents)
// EPI_SCALE  acc * scale[idx[slot]][m][p]             (J^T stages; scale
//                                                      of type ST)
// EPI_SCALE_RND  bf16_round(acc * scale[...])          (the Neumann chain's
//                                                      bf16 J^T stages)
// EPI_SWISH_LIN  EPI_SWISH, and aux[e][m][p] = swish'(acc + bias[m];
//                beta_out) in float32; with aux0 (SRC 0) the blocks of the
//                first row of tiles also write aux0[e][c][p] =
//                swish'(inp[e][c][p]; beta_in) (the merged block forward's
//                linearisation: s1 / s2, and s0 under preact)
// Tiling: a 64x64 output tile per block, K in steps of 16 through shared
// memory, a 4x4 register micro-tile per thread, so each loaded (split)
// element feeds 16 FMAs per pass.
enum { EPI_SWISH = 0, EPI_AFFINE = 1, EPI_SCALE = 2, EPI_SCALE_RND = 3, EPI_SWISH_LIN = 4 };
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, GEMM_THREADS = 256;

template <int MODE, int SRC, int IN, int EPI, typename ST>
__global__ void __launch_bounds__(GEMM_THREADS) conv_gemm_kernel(
    const float* __restrict__ w_hi, const float* __restrict__ w_lo,
    const float* __restrict__ bias, int M, int K,
    const float* __restrict__ inp, const float* __restrict__ inh,
    const int* __restrict__ idx, const int* __restrict__ count, int C, int H,
    int W, float beta_in, float beta_out, float alpha,
    const ST* __restrict__ scale, float* __restrict__ out, int nb,
    const float* __restrict__ beta_net, float* __restrict__ aux,
    float* __restrict__ aux0) {
  const int slot = blockIdx.z;
  if (count != nullptr && slot >= *count) return;
  const int e = idx != nullptr ? idx[slot] : slot;
  const int net = slot / nb;
  w_hi += (size_t)net * M * K;
  if (MODE >= MODE_TF32) w_lo += (size_t)net * M * K;
  if (bias != nullptr) bias += (size_t)net * M;
  if (beta_net != nullptr) beta_in = beta_net[net];
  const int HW = H * W;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t src_off = (SRC == 0) ? (size_t)e * C * HW : (size_t)slot * K * HW;
  const float* src = inp + src_off;
  __shared__ float As[2][BK][BM];
  __shared__ float Bs[2][BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
      const int mm = i / BK, kk = i % BK, m = m0 + mm, k = k0 + kk;
      float h = 0.f, l = 0.f;
      if (m < M && k < K) {
        h = w_hi[(size_t)m * K + k];
        if (MODE >= MODE_TF32) l = w_lo[(size_t)m * K + k];
      }
      As[0][kk][mm] = h;
      As[1][kk][mm] = l;
    }
    for (int i = tid; i < BK * BN; i += GEMM_THREADS) {
      const int kk = i / BN, nn = i % BN, k = k0 + kk, p = n0 + nn;
      float v = 0.f;
      if (k < K && p < HW) {
        if (SRC == 0) {
          const int ci = k / 9, d = k % 9;
          const int yy = p / W + d / 3 - 1, xx = p % W + d % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const size_t off = (size_t)ci * HW + yy * W + xx;
            v = in_xform<IN>(src[off], inh, src_off + off, beta_in);
          }
        } else {
          const size_t off = (size_t)k * HW + p;
          v = in_xform<IN>(src[off], inh, src_off + off, beta_in);
        }
      }
      float h, l;
      split(v, MODE, h, l);
      Bs[0][kk][nn] = h;
      Bs[1][kk][nn] = l;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ah[TM], al[TM], bh[TN], bl[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ah[i] = As[0][kk][ty * TM + i];
        al[i] = As[1][kk][ty * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bh[j] = Bs[0][kk][tx * TN + j];
        bl[j] = Bs[1][kk][tx * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = mac<MODE>(acc[i][j], ah[i], al[i], bh[j], bl[j]);
    }
    __syncthreads();
  }
  if (EPI == EPI_SWISH_LIN && SRC == 0 && aux0 != nullptr && blockIdx.y == 0) {
    float* a0 = aux0 + (size_t)e * C * HW;
    for (int i = tid; i < C * BN; i += GEMM_THREADS) {
      const int p = n0 + i % BN;
      if (p < HW) {
        const size_t off = (size_t)(i / BN) * HW + p;
        a0[off] = dswish(src[off], beta_in);
      }
    }
  }
  float* o = out + (size_t)slot * M * HW;
  float* ax = EPI == EPI_SWISH_LIN ? aux + (size_t)e * M * HW : nullptr;
  const ST* sc = (EPI == EPI_SCALE || EPI == EPI_SCALE_RND)
                     ? scale + (size_t)e * M * HW : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const float b = (bias != nullptr) ? bias[m] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int p = n0 + tx * TN + j;
      if (p >= HW) continue;
      const size_t off = (size_t)m * HW + p;
      float r;
      if (EPI == EPI_SWISH) r = swish(acc[i][j] + b, beta_out);
      else if (EPI == EPI_SWISH_LIN) {
        const float h = acc[i][j] + b;
        r = swish(h, beta_out);
        ax[off] = dswish(h, beta_out);
      }
      else if (EPI == EPI_AFFINE) r = alpha * acc[i][j] + b;
      else if (EPI == EPI_SCALE) r = acc[i][j] * ld(sc, off);
      else r = bf16_round(acc[i][j] * ld(sc, off));
      o[off] = r;
    }
  }
}

template <int MODE, int SRC, int IN, int EPI, typename ST = float>
cudaError_t launch_conv_gemm(const float* w_hi, const float* w_lo,
                             const float* bias, int M, int K, const float* inp,
                             const float* inh, const int* idx,
                             const int* count, int B, int C, int H, int W,
                             float beta_in, float beta_out, float alpha,
                             const typename ident<ST>::type* scale, float* out,
                             cudaStream_t s, int nets = 1,
                             const float* beta_net = nullptr,
                             float* aux = nullptr, float* aux0 = nullptr) {
  dim3 grid((H * W + BN - 1) / BN, (M + BM - 1) / BM, B);
  conv_gemm_kernel<MODE, SRC, IN, EPI, ST><<<grid, GEMM_THREADS, 0, s>>>(
      w_hi, w_lo, bias, M, K, inp, inh, idx, count, C, H, W, beta_in,
      beta_out, alpha, scale, out, B / nets, beta_net, aux, aux0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// conv3x3 MID -> C (the conv whose output has the image's few channels).
// One thread per (pixel, group of 4 output channels); the group's weights
// for a chunk of MC mid channels sit in shared memory, and each split
// activation feeds 4 output channels. The input t2 (B, MID, HW) is indexed
// by slot, the outputs by example e = idx[slot]:
//   out[e][co][p] = [base] + sgn * (acc * [scale] + [bias[co]]) - [sub]
// with every bracketed operand optional (nullptr): the forward solve's
// residual x_embed - net(z) - z, the backward solve's u + s0 * C1^T t - grad,
// and the re-attachment's raw cotangent; scale is of type ST.
// CHAIN instead writes the Neumann chain's term and accumulates it:
//   r = acc * scale (rounded to bf16 in MODE_BF16);  out = r;
//   chain_acc += coef[k] * r
constexpr int OUT_THREADS = 128, OUT_CO = 4, OUT_MC = 64;

template <int MODE, int IN, typename ST, bool CHAIN>
__global__ void __launch_bounds__(OUT_THREADS) conv3x3_out_kernel(
    const float* __restrict__ w_hi, const float* __restrict__ w_lo,
    const float* __restrict__ bias, const float* __restrict__ t2,
    const float* __restrict__ t2h, float beta_in,
    const int* __restrict__ idx, const int* __restrict__ count, int C, int MID,
    int H, int W, const float* __restrict__ base, float sgn,
    const ST* __restrict__ scale, const float* __restrict__ sub,
    float* __restrict__ out, int nb, const float* __restrict__ coef, int k,
    float* __restrict__ chain_acc) {
  const int slot = blockIdx.z;
  if (count != nullptr && slot >= *count) return;
  const int net = slot / nb;
  w_hi += (size_t)net * C * MID * 9;
  if (MODE >= MODE_TF32) w_lo += (size_t)net * C * MID * 9;
  if (bias != nullptr) bias += (size_t)net * C;
  const int HW = H * W;
  const int co0 = blockIdx.y * OUT_CO;
  const int p = blockIdx.x * OUT_THREADS + threadIdx.x;
  const bool valid = p < HW;
  const int y = valid ? p / W : 0, x = valid ? p % W : 0;
  const size_t src_off = (size_t)slot * MID * HW;
  const float* src = t2 + src_off;
  __shared__ float ws[2][OUT_MC][9][OUT_CO];
  float acc[OUT_CO];
#pragma unroll
  for (int j = 0; j < OUT_CO; ++j) acc[j] = 0.f;

  for (int mc0 = 0; mc0 < MID; mc0 += OUT_MC) {
    for (int i = threadIdx.x; i < OUT_MC * 9 * OUT_CO; i += OUT_THREADS) {
      const int j = i % OUT_CO, d = (i / OUT_CO) % 9, mm = i / (OUT_CO * 9);
      const int co = co0 + j, m = mc0 + mm;
      float h = 0.f, l = 0.f;
      if (co < C && m < MID) {
        const size_t off = ((size_t)co * MID + m) * 9 + d;
        h = w_hi[off];
        if (MODE >= MODE_TF32) l = w_lo[off];
      }
      ws[0][mm][d][j] = h;
      ws[1][mm][d][j] = l;
    }
    __syncthreads();
    if (valid) {
      const int mend = min(OUT_MC, MID - mc0);
      for (int mm = 0; mm < mend; ++mm) {
        const size_t plane = (size_t)(mc0 + mm) * HW;
#pragma unroll
        for (int d = 0; d < 9; ++d) {
          const int yy = y + d / 3 - 1, xx = x + d % 3 - 1;
          float v = 0.f;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const size_t off = plane + yy * W + xx;
            v = in_xform<IN>(__ldg(src + off), t2h, src_off + off, beta_in);
          }
          float h, l;
          split(v, MODE, h, l);
#pragma unroll
          for (int j = 0; j < OUT_CO; ++j)
            acc[j] = mac<MODE>(acc[j], ws[0][mm][d][j], ws[1][mm][d][j], h, l);
        }
      }
    }
    __syncthreads();
  }
  if (!valid) return;
  const size_t e = idx != nullptr ? (size_t)idx[slot] : (size_t)slot;
#pragma unroll
  for (int j = 0; j < OUT_CO; ++j) {
    const int co = co0 + j;
    if (co >= C) continue;
    const size_t off = (e * C + co) * HW + p;
    float r = acc[j];
    if (scale != nullptr) r *= ld(scale, off);
    if (CHAIN) {
      if (MODE == MODE_BF16) r = bf16_round(r);
      out[off] = r;
      chain_acc[off] = __fadd_rn(chain_acc[off], __fmul_rn(coef[k], r));
      continue;
    }
    if (bias != nullptr) r += bias[co];
    float o = sgn * r;
    if (base != nullptr) o += base[off];
    if (sub != nullptr) o -= sub[off];
    out[off] = o;
  }
}

template <int MODE, int IN, typename ST = float, bool CHAIN = false>
cudaError_t launch_conv3x3_out(const float* w_hi, const float* w_lo,
                               const float* bias, const float* t2,
                               const float* t2h, float beta_in, const int* idx,
                               const int* count, int B, int C, int MID, int H,
                               int W, const float* base, float sgn,
                               const typename ident<ST>::type* scale,
                               const float* sub, float* out, cudaStream_t s,
                               int nets = 1, const float* coef = nullptr,
                               int k = 0, float* chain_acc = nullptr) {
  dim3 grid((H * W + OUT_THREADS - 1) / OUT_THREADS, (C + OUT_CO - 1) / OUT_CO, B);
  conv3x3_out_kernel<MODE, IN, ST, CHAIN><<<grid, OUT_THREADS, 0, s>>>(
      w_hi, w_lo, bias, t2, t2h, beta_in, idx, count, C, MID, H, W, base, sgn,
      scale, sub, out, B / nets, coef, k, chain_acc);
  return cudaGetLastError();
}

}  // namespace imnf
