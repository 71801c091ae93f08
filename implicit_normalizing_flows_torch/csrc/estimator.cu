// Hopper (sm_90a) kernels of the training log-det estimator at
// --mem-eff False: both nets' stop-gradient Neumann chains and the
// differentiable final pair T = <acc, J_g(h) eps> with its second-order
// backward.
//
// Replaces the TPU kernels implicit_normalizing_flows_tpu/ops/fused_chain.py
// ::fused_neumann_chain2 (:333; _chain2_kernel :239, _make_apply_jt :182)
// and ops/fused_solve.py::fused_final_pair (:1689; _final_primal_kernel
// :1440, _final_bwd_kernel :1478, _final_T_in_kernel :1346,
// _final_grads_in_kernel :1372). The TPU kernels keep one example's
// derivative factors (chain) or forward and tangent intermediates (final
// pair) resident in VMEM for the whole computation and accumulate the
// weight gradients across the sequential grid. On Hopper the blocks run in
// parallel and an SM holds 227 KB, so both are host-driven sequences of
// batched kernels on the conv_gemm.cuh templates, each launch covering
// both nets (their examples stacked along the batch, a net index in the
// grid):
//
// chain, per term k (every example runs all n_power terms):
//   nc_jt_in       t2 = rnd(C3^T u * s2)          c -> mid, flipped w3 (bf16:
//                  tensor cores, conv3x3_in_tc.cuh)
//   nc_jt_mid      t1 = rnd(C2^T t2 * s1)         mid -> mid, w2^T (bf16:
//                  tensor cores, mma_gemm.cuh)
//   nc_jt_out_acc  u = rnd(s0 * C1^T t1); acc += c_k u   mid -> c, flipped w1
//                  (bf16: tensor cores, conv3x3_out_tc.cuh, w1 cast once per
//                  chain call into its tile layout)
//   rnd rounds to bf16 in mode bf16 (the chain dtype), as _make_apply_jt
//   rounds; c_k is read from a device array of signed coefficients.
// final pair, primal:
//   fp_conv_in     h1 = W1 a0 + b1; th1 = W1 ta0; r2 = C3^T acc (bf16:
//                  FP64 tensor cores, conv3x3_in_tc.cuh's
//                  conv3x3_in_dmma_kernel, the transform once per loaded
//                  element, float64 sums; w1 / w3t cast once per
//                  final-pair call)
//   fp_conv_mid    h2 = W2 swish(h1) + b2; th2 = W2 (swish'(h1) th1);
//                  ra1 = W2^T rh2 and p_a1 = W2^T p_h2 (four "nets") (bf16:
//                  tensor cores, mma_gemm.cuh)
//   fp_tdot        T[e] = sum r2 (swish'(h2) th2)   (its own unit, tdot.cu,
//                  linked into this library: a thread-block cluster an
//                  example)
// final pair, backward (the cotangent folded into acc by the caller):
//   fp_second      rh = swish'(h) r, p = [swish'(h) q] + swish''(h) th r,
//                  per-channel sums of p (db) and of the slope terms (dbeta)
//   fp_conv_out    p_a0 = C1^T p_h1 [and ra0 = C1^T rh1 with preact: four
//                  "nets" on two nets' weights] (bf16: tensor cores,
//                  conv3x3_out_tc.cuh, w1 cast once per final-pair call into
//                  the chain's tile layout)
//   the weight gradients dW3 = acc x shift(ta2), dW2 = rh2 x ta1 + p_h2 x a1,
//   dW1 = rh1 x shift(ta0) + p_h1 x shift(a0) are implicit_grad.cu's
//   rv_wgrad split-K partials (each pair's two products into one partial
//   buffer) and its fixed-order rv_wgrad_reduce
//
// Precision: mode bf16 rounds both operands of every product to bf16 and
// sums in f32, mode f32 is exact f32 (_make_dot); the elementwise math is
// f32 with the swish family rounded op by op as the plain versions and JAX
// take it (conv_gemm.cuh). The chain reads s0/s1/s2 as stored: bf16 in mode
// bf16, which halves their traffic.
//
// What bounds them on H100: the 1x1 products of mode bf16, the chain's
// nc_jt_mid (the J^T 1x1 is ~90% of a term's MACs: 268M of 296M per
// example and net at 32x32) and the final pair's fp_conv_mid, run on the
// tensor cores (mma_gemm.cuh, whose note gives their bytes bounds and
// design; fp_conv_mid applies its input transform once per element as the
// panel is staged), and so does the chain's 3x3 c -> mid product nc_jt_in
// (conv3x3_in_tc.cuh: an im2col tile built once per band in shared memory,
// bound by its float32 output's bytes), and the final pair's fp_conv_in
// runs that header's float64 form (the same bf16 operands and im2col tile,
// the transform applied once per loaded element, the slope per net read on
// the device, the bias per net, but the products summed in float64 on the
// FP64 tensor cores: the pair's weight gradients at 8x8 move past their
// limit under any float32 order of h1 and th1), and the chain's 3x3 mid -> c product
// nc_jt_out_acc (conv3x3_out_tc.cuh: a bf16 halo tile per band and 64-channel
// chunk, the pre-cast weights copied by cp.async, bound by reading t1 as
// float32), and so does the final pair's fp_conv_out (the same kernel and
// weights, out = acc); every product of mode f32
// runs as FP32 FMAs on the CUDA cores (conv_gemm.cuh), as the implicit-gradient kernels do. The
// tensor cores sum fp_conv_mid's products in another order than the plain
// version (cuDNN's), which moves the final pair's d_h and weight gradients,
// small differences of large terms, by up to 1.3e-5 whatever the order:
// its check holds the kernels against the plain path with that product
// summed exactly (chip_smoke.py, FINAL_TOL). The chain's design cost: the TPU
// kernel keeps s0/s1/s2 resident across the series, so its traffic is
// O(|s|); one net's s1 + s2 at 32x32, B = 64 is 128 MiB in bf16, more than
// the 50 MB L2, so here every term streams them again: O(n_power |s|).
// Keeping s on chip across terms is later work.

#include "conv_gemm.cuh"
#include "mma_gemm.cuh"
#include "conv3x3_in_tc.cuh"
#include "conv3x3_out_chain.cuh"

namespace {

using namespace imnf;

constexpr int RED_THREADS = 256, RED_WARPS = RED_THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v (all threads call it; thread 0 gets the result).
// Fixed tree order: deterministic.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < RED_WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// One block per (channel m, net): over the net's nb examples and HW pixels
//   ds = swish'(h), rh = ds r, p = [ds q] + (swish''(h) th) r
//   dsum[net][m] = sum p;  dbsum[net][m] = sum [dswish/dbeta(h) q]
//                                              + (dswish'/dbeta(h) th) r
// q, rh, p, dsum optional (nullptr).
__global__ void __launch_bounds__(RED_THREADS) second_kernel(
    const float* __restrict__ r, const float* __restrict__ q,
    const float* __restrict__ h, const float* __restrict__ th,
    const float* __restrict__ beta_net, int nb, int M, int HW,
    float* __restrict__ rh, float* __restrict__ p, float* __restrict__ dsum,
    float* __restrict__ dbsum) {
  const int m = blockIdx.x, net = blockIdx.y;
  const float beta = beta_net[net];
  const int n = nb * HW;
  float sp = 0.f, sb = 0.f;
  for (int i = threadIdx.x; i < n; i += RED_THREADS) {
    const int b = net * nb + i / HW, px = i % HW;
    const size_t off = ((size_t)b * M + m) * HW + px;
    const float rv = r[off], hv = h[off], tv = th[off];
    const float ds = dswish(hv, beta);
    const float t2 = __fmul_rn(__fmul_rn(d2swish(hv, beta), tv), rv);
    const float tb = __fmul_rn(__fmul_rn(ddswish_dbeta(hv, beta), tv), rv);
    float pv = t2, bv = tb;
    if (q != nullptr) {
      const float qv = q[off];
      pv = __fadd_rn(__fmul_rn(ds, qv), t2);
      bv = __fadd_rn(__fmul_rn(dswish_dbeta(hv, beta), qv), tb);
    }
    if (rh != nullptr) rh[off] = __fmul_rn(ds, rv);
    if (p != nullptr) p[off] = pv;
    sp = __fadd_rn(sp, pv);
    sb = __fadd_rn(sb, bv);
  }
  __shared__ float red[RED_WARPS];
  const float a = block_sum(sp, red), c = block_sum(sb, red);
  if (threadIdx.x == 0) {
    if (dsum != nullptr) dsum[(size_t)net * M + m] = a;
    dbsum[(size_t)net * M + m] = c;
  }
}

// the chain's J^T stages: rounded in mode bf16, plain f32 otherwise.
// nc_jt_in: the 3x3 c -> mid, w bf16 on the tensor cores in mode bf16
// (conv3x3_in_tc.cuh, linked from conv3x3_in_tc.cu), w float32 on the SIMT
// template in mode f32.
template <typename ST>
cudaError_t nc_in_mode(int mode, const void* w, int mid, const float* inp,
                       int B, int nets, int C, int H, int W, const void* scale,
                       float* out, cudaStream_t s) {
  const ST* sc = static_cast<const ST*>(scale);
  switch (mode) {
    case MODE_F32: return launch_conv_gemm<MODE_F32, 0, IN_ID, EPI_SCALE, ST>(static_cast<const float*>(w), nullptr, nullptr, mid, C * 9, inp, nullptr, nullptr, nullptr, B, C, H, W, 0.f, 0.f, 1.f, sc, out, s, nets);
    case MODE_BF16: return conv3x3_in_tc_chain(static_cast<const __nv_bfloat16*>(w), inp, B, nets, C, H, W, mid, sc, out, s);
  }
  return cudaErrorInvalidValue;
}

// nc_jt_mid: the 1x1 mid -> mid, w bf16 on the tensor cores in mode bf16,
// w float32 on the SIMT template in mode f32.
template <typename ST>
cudaError_t nc_mid_mode(int mode, const void* w, int mid, const float* inp,
                        int B, int nets, int H, int W, const void* scale,
                        float* out, cudaStream_t s) {
  const ST* sc = static_cast<const ST*>(scale);
  switch (mode) {
    case MODE_F32: return launch_conv_gemm<MODE_F32, 1, IN_ID, EPI_SCALE, ST>(static_cast<const float*>(w), nullptr, nullptr, mid, mid, inp, nullptr, nullptr, nullptr, B, mid, H, W, 0.f, 0.f, 1.f, sc, out, s, nets);
    case MODE_BF16: return launch_tc_conv1x1<EPI_SCALE_RND>(static_cast<const __nv_bfloat16*>(w), mid, mid, inp, B, nets, H * W, sc, out, s);
  }
  return cudaErrorInvalidValue;
}

// nc_jt_out_acc: the 3x3 mid -> c, w bf16 in the tile layout on the tensor
// cores in mode bf16 (conv3x3_out_tc.cuh, linked from conv3x3_out_tc.cu), w
// float32 OIHW on the SIMT template in mode f32.
template <typename ST>
cudaError_t nc_out_mode(int mode, const void* w, const float* t, int B,
                        int nets, int C, int mid, int H, int W, const void* scale,
                        const float* coef, int k, float* u_out, float* acc,
                        cudaStream_t s) {
  const ST* sc = static_cast<const ST*>(scale);
  switch (mode) {
    case MODE_F32: return launch_conv3x3_out<MODE_F32, IN_ID, ST, true>(static_cast<const float*>(w), nullptr, nullptr, t, nullptr, 0.f, nullptr, nullptr, B, C, mid, H, W, nullptr, 1.f, sc, nullptr, u_out, s, nets, coef, k, acc);
    case MODE_BF16: return conv3x3_out_tc_chain(static_cast<const __nv_bfloat16*>(w), t, B, nets, C, mid, H, W, sc, coef, k, u_out, acc, s);
  }
  return cudaErrorInvalidValue;
}

// the final pair's convs in mode f32: EPI_AFFINE with alpha 1, the input
// transform act (IN_ID | IN_SWISH | IN_DSWISH with inh) at each net's slope
// beta_net[net]
template <int MODE, int SRC>
cudaError_t fp_gemm(int act, const float* w, const float* bias, int M, int K,
                    const float* inp, const float* inh, int B, int nets, int C,
                    int H, int W, const float* beta_net, float* out,
                    cudaStream_t s) {
#define FP_GEMM(IN)                                                          \
  return launch_conv_gemm<MODE, SRC, IN, EPI_AFFINE>(                        \
      w, nullptr, bias, M, K, inp, inh, nullptr, nullptr, B, C, H, W, 0.f,   \
      0.f, 1.f, nullptr, out, s, nets, beta_net)
  if (act == IN_ID) FP_GEMM(IN_ID);
  if (act == IN_SWISH) FP_GEMM(IN_SWISH);
  if (act == IN_DSWISH) FP_GEMM(IN_DSWISH);
#undef FP_GEMM
  return cudaErrorInvalidValue;
}

// fp_conv_mid: the 1x1 mid -> mid, w bf16 on the tensor cores in mode
// bf16, w float32 on the SIMT template in mode f32
cudaError_t fp_mid_mode(int mode, int act, const void* w, const float* bias, int mid,
                        const float* inp, const float* inh, int B, int nets, int H,
                        int W, const float* beta_net, float* out, cudaStream_t s) {
  if (mode == MODE_F32)
    return fp_gemm<MODE_F32, 1>(act, static_cast<const float*>(w), bias, mid, mid, inp, inh, B, nets, mid, H, W, beta_net, out, s);
  if (mode != MODE_BF16) return cudaErrorInvalidValue;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const float* no_scale = nullptr;
#define FP_TC(IN)                                                            \
  return launch_tc_conv1x1<EPI_AFFINE, IN>(wb, mid, mid, inp, B, nets, H * W, \
                                           no_scale, out, s, nullptr, nullptr, \
                                           inh, beta_net, bias)
  if (act == IN_ID) FP_TC(IN_ID);
  if (act == IN_SWISH) FP_TC(IN_SWISH);
  if (act == IN_DSWISH) FP_TC(IN_DSWISH);
#undef FP_TC
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() right after its launch (0 on success). B counts the
// examples of all `nets` nets together; every example is live (the conv
// kernels get no active list). Weights are stacked per net, bfloat16 in
// mode bf16 (the tensor-core operand; nc_jt_out_acc's and fp_conv_out's in
// the tile layout) and float32 in mode f32.

// chain: the derivative factors s2 / s1 / s0 as float32 or, with s_bf16,
// bfloat16
int imnf_nc_jt_in(int mode, const void* w, const float* u, const void* s2,
                  int s_bf16, int B, int nets, int C, int H, int W, int mid,
                  float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (s_bf16)
    return (int)nc_in_mode<__nv_bfloat16>(mode, w, mid, u, B, nets, C, H, W, s2, out, s);
  return (int)nc_in_mode<float>(mode, w, mid, u, B, nets, C, H, W, s2, out, s);
}

int imnf_nc_jt_mid(int mode, const void* w, const float* t, const void* s1,
                   int s_bf16, int B, int nets, int mid, int H, int W,
                   float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (s_bf16)
    return (int)nc_mid_mode<__nv_bfloat16>(mode, w, mid, t, B, nets, H, W, s1, out, s);
  return (int)nc_mid_mode<float>(mode, w, mid, t, B, nets, H, W, s1, out, s);
}

int imnf_nc_jt_out_acc(int mode, const void* w, const float* t,
                       const void* s0, int s_bf16, const float* coef, int k,
                       int B, int nets, int C, int mid, int H, int W,
                       float* u_out, float* acc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (s_bf16)
    return (int)nc_out_mode<__nv_bfloat16>(mode, w, t, B, nets, C, mid, H, W, s0, coef, k, u_out, acc, s);
  return (int)nc_out_mode<float>(mode, w, t, B, nets, C, mid, H, W, s0, coef, k, u_out, acc, s);
}

// final pair: act 0 IN_ID, 1 IN_SWISH, 2 IN_DSWISH (inh the pre-activation);
// w (nets, mid, C, 3, 3): bfloat16 on the tensor cores in mode bf16
// (conv3x3_in_tc.cuh's float64 form, linked from
// conv3x3_in_tc.cu), float32 on the SIMT template in mode f32
int imnf_fp_conv_in(int mode, int act, const void* w, const float* bias,
                    const float* beta_net, const float* inp, const float* inh,
                    int B, int nets, int C, int H, int W, int mid, float* out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_F32: return (int)fp_gemm<MODE_F32, 0>(act, static_cast<const float*>(w), bias, mid, C * 9, inp, inh, B, nets, C, H, W, beta_net, out, s);
    case MODE_BF16: return (int)conv3x3_in_dmma_affine(static_cast<const __nv_bfloat16*>(w), bias, act, beta_net, inp, inh, B, nets, C, H, W, mid, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w: W2 or W2^T (nets, mid, mid), bfloat16 in mode bf16, float32 in mode f32
int imnf_fp_conv_mid(int mode, int act, const void* w, const float* bias,
                     const float* beta_net, const float* inp, const float* inh,
                     int B, int nets, int mid, int H, int W, float* out,
                     void* stream) {
  return (int)fp_mid_mode(mode, act, w, bias, mid, inp, inh, B, nets, H, W, beta_net, out, (cudaStream_t)stream);
}

// out = C1^T t of `nets` nets stacked along the batch, net n on the weights
// of net n % wnets: w the tile layout (wnets, mid / 64, 9 npad, 64) bfloat16
// on the tensor cores in mode bf16, (nets, C, mid, 3, 3) float32 on the SIMT
// template in mode f32 (wnets == nets)
int imnf_fp_conv_out(int mode, const void* w, const float* t, int B, int nets,
                     int wnets, int C, int mid, int H, int W, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_F32:
      if (wnets != nets) return (int)cudaErrorInvalidValue;
      return (int)launch_conv3x3_out<MODE_F32, IN_ID>(static_cast<const float*>(w), nullptr, nullptr, t, nullptr, 0.f, nullptr, nullptr, B, C, mid, H, W, nullptr, 1.f, nullptr, nullptr, out, s, nets);
    case MODE_BF16: return (int)conv3x3_out_tc_final(static_cast<const __nv_bfloat16*>(w), t, B, nets, wnets, C, mid, H, W, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

int imnf_fp_second(const float* r, const float* q, const float* h,
                   const float* th, const float* beta_net, int B, int nets,
                   int M, int HW, float* rh, float* p, float* dsum,
                   float* dbsum, void* stream) {
  dim3 grid(M, nets);
  second_kernel<<<grid, RED_THREADS, 0, (cudaStream_t)stream>>>(r, q, h, th, beta_net, B / nets, M, HW, rh, p, dsum, dbsum);
  return (int)cudaGetLastError();
}

}  // extern "C"
