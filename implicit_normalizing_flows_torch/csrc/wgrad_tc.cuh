// Tensor-core (wgmma) split-K weight gradient of mode bf16 for Hopper
// (sm_90a): rv_wgrad of implicit_grad.cu,
//
//   part[split][m][n] = sum over k = (b, p) in the split of
//                       bf16(A[m][k]) * bf16(B[n][k]),  f32 sums
//
// with A = a or a * swish'(ah) and B = b, swish(b) or b * swish'(bh),
// im2col-shifted (n = ci*9 + ky*3 + kx, zero padding) for a 3x3 kernel's
// gradient: the weight gradients _dot_nt(dot, ...) of the TPU kernels
// fused_reattach_vjp (implicit_normalizing_flows_tpu/ops/fused_solve.py:1226;
// _net_vjp_in_kernel :1093, products at :1117 and :1123) and
// fused_final_pair (:1689; its weight-gradient pairs at :1410), in
// _make_dot("bf16")'s error model. (The backward solve's product of mode
// bf16, of fused_backward_solve :930, is mma_gemm.cuh's.) Modes f32 and
// tf32 stay on implicit_grad.cu's CUDA-core wgrad_kernel.
//
// What bounds it on an H100: bytes. dW2 at 32x32, B 64 (M = N = 512, K =
// 65,536) is 34.4 GFLOP, 0.035 ms at 989 TFLOP/s, but reads a, ah and b as
// float32, 384 MiB: 0.12 ms at 3.35 TB/s. The CUDA-core kernel recomputed
// the transforms (an expf each) on every 64-wide tile, re-reading A N/64
// and B M/64 times, and ran the products as FP32 FMAs.
//
// The design against that bound:
// * A pre-pass (wgrad_prep_kernel) reads each float32 input once, applies
//   its transform once (the op-by-op rounded swish family of conv_gemm.cuh,
//   the slopes read on the device, so each value is the plain version's to
//   the bit), rounds it to bf16 and writes it in its own layout, (Bn, C,
//   HW): 384 MiB read and 128 MiB written for dW2. Its time is the
//   kernel's.
// * The product (wgrad_tc_kernel) reads those bf16 operands, K-major as
//   stored (k = (b, p) runs along p for both), so both operands take
//   wgmma's K-major layout with the 128-byte swizzle and no transpose. A
//   block owns a 128 x 128 output tile of one split: 128 rows of the
//   unshifted operand X (M = 512 for dW2 and dW1, the mid channels of B
//   for dW3) and 128 of the other, Y (N = 512, or the 9c shifted rows of a
//   3x3 gradient, 27 to 432, padded with zero rows to a multiple of 128:
//   tensor-core time, not bytes). Each 64-k step stages both tiles (32 KB)
//   through a 4-slot ring, three steps ahead: X by cp.async, Y by
//   cp.async, or, when shifted, by 16-byte plain loads whose one-pixel
//   shift is a funnel shift of two neighbouring chunks (zero past the
//   image's edges). The blocks of one split run together, so the bf16
//   operands (64 MiB each for dW2) are re-read from the 50 MB L2 rather
//   than from device memory.
// * dW3 (M = c <= 48, N = mid * 9) computes the transposed tile: rows the
//   mid channels of B, unshifted, and columns the 9c rows of A shifted the
//   other way (sum_p a[p] b[p + d] = sum_q a[q - d] b[q]; a split holds
//   whole examples, so no product crosses a split), stored transposed.
// * Products: wgmma.mma_async m64n64k16, two per 16 k (the tile's column
//   halves), each warpgroup 64 rows. The tensor cores truncate as they
//   add: each 64-k step is summed into a fresh partial that is added to
//   the float32 sum with round-to-nearest adds.
// * The splits' partials stay in part and are summed in a fixed order by
//   wgrad_reduce_kernel: deterministic, no float atomics.
#pragma once

#include "mma_gemm.cuh"

namespace imnf {

constexpr int WT_ROWS = 128, WT_COLS = 128, WT_BK = 64;
constexpr int WT_STAGES = 4, WT_AHEAD = WT_STAGES - 1, WT_THREADS = 256;
constexpr int WT_TILE_BYTES = 128 * WT_BK * 2;       // one operand's 128 rows
constexpr int WT_STAGE_BYTES = 2 * WT_TILE_BYTES;    // X, then Y
constexpr int WT_SMEM = WT_STAGES * WT_STAGE_BYTES + 1024;
constexpr int WT_PREP_THREADS = 256;

// out[i] = bf16(IN(v[i]; h[i], *beta)), 4 entries a thread and step.
template <int IN>
__global__ void __launch_bounds__(WT_PREP_THREADS) wgrad_prep_kernel(
    const float* __restrict__ v, const float* __restrict__ h,
    const float* __restrict__ beta_p, long long n4, __nv_bfloat16* __restrict__ out) {
  const float beta = IN == IN_ID ? 0.f : *beta_p;
  for (long long i = (long long)blockIdx.x * WT_PREP_THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * WT_PREP_THREADS) {
    float4 x = __ldg(reinterpret_cast<const float4*>(v) + i);
    if (IN == IN_SWISH) {
      x = make_float4(swish(x.x, beta), swish(x.y, beta), swish(x.z, beta), swish(x.w, beta));
    } else if (IN == IN_DSWISH) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(h) + i);
      x = make_float4(__fmul_rn(x.x, dswish(g.x, beta)), __fmul_rn(x.y, dswish(g.y, beta)),
                      __fmul_rn(x.z, dswish(g.z, beta)), __fmul_rn(x.w, dswish(g.w, beta)));
    }
    reinterpret_cast<uint2*>(out)[i] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

// Eight bf16 of a row of Y shifted by one pixel: dx +1 takes entries 1..8
// of (lo, hi), dx -1 entry 7 of lo then entries 0..6 of hi.
__device__ __forceinline__ uint4 shift_right1(uint4 a, uint4 b) {
  return make_uint4(__funnelshift_r(a.x, a.y, 16), __funnelshift_r(a.y, a.z, 16),
                    __funnelshift_r(a.z, a.w, 16), __funnelshift_r(a.w, b.x, 16));
}
__device__ __forceinline__ uint4 shift_left1(uint4 l, uint4 a) {
  return make_uint4(__funnelshift_r(l.w, a.x, 16), __funnelshift_r(a.x, a.y, 16),
                    __funnelshift_r(a.y, a.z, 16), __funnelshift_r(a.z, a.w, 16));
}

// Grid: tiles_r x tiles_c output tiles of each split, a split's tiles
// consecutive. X (Bn, R, HW) and Y (Bn, Cy, HW) bf16. SH 0: Y's row j is
// channel j (NC = Cy), out[x][j]; SH +1 / -1: Y's row j = ch * 9 + ky * 3 +
// kx is channel ch shifted by +-(ky - 1, kx - 1) with zero padding (NC =
// 9 Cy), out[x][j] (+1) or out[j / 9][x * 9 + j % 9] (-1). A split is
// `steps` 64-k steps (the last one may hold fewer), whole examples.
template <int SH>
__global__ void __launch_bounds__(WT_THREADS, 1) wgrad_tc_kernel(
    const __nv_bfloat16* __restrict__ X, int R, const __nv_bfloat16* __restrict__ Y,
    int Cy, int NC, int H, int W, int steps, int total, int tiles_r, int tiles_c,
    float* __restrict__ part, int M, int N) {
  extern __shared__ uint8_t wt_smem[];
  const uint32_t raw = smem_u32(wt_smem);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // [stage][X | Y][128 rows][128 bytes]
  uint8_t* const gbase = wt_smem + (sbase - raw);  // its generic address
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), wt = tid % 128;
  const int tiles = tiles_r * tiles_c, split = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int r0 = tile % tiles_r * WT_ROWS, j0 = tile / tiles_r * WT_COLS;
  const int HW = H * W, t0 = split * steps, nsteps = min(steps, total - t0);

  if (SH != 0) {  // the shifted rows past NC are never loaded: zero them once
    for (int q = tid; q < WT_STAGES * WT_TILE_BYTES / 16; q += WT_THREADS) {
      const int st = q / (WT_TILE_BYTES / 16), i = q % (WT_TILE_BYTES / 16);
      *reinterpret_cast<uint4*>(gbase + st * WT_STAGE_BYTES + WT_TILE_BYTES + i * 16) =
          make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
  }

  auto load = [&](int t) {
    if (t < nsteps) {
      const long long k0 = (long long)(t0 + t) * WT_BK;
      const int b = (int)(k0 / HW), p0 = (int)(k0 % HW);
      const uint32_t xs = sbase + (t % WT_STAGES) * WT_STAGE_BYTES, ys = xs + WT_TILE_BYTES;
#pragma unroll
      for (int q = tid; q < WT_ROWS * 8; q += WT_THREADS) {
        const int r = q / 8, c = q % 8, row = r0 + r;
        const bool ok = row < R;
        cp_async16(xs + sw128(r, c), ok ? X + ((size_t)b * R + row) * HW + p0 + 8 * c : X, ok);
      }
#pragma unroll
      for (int q = tid; q < WT_COLS * 8; q += WT_THREADS) {
        const int r = q / 8, c = q % 8, j = j0 + r;
        if (SH == 0) {
          const bool ok = j < NC;
          cp_async16(ys + sw128(r, c), ok ? Y + ((size_t)b * Cy + j) * HW + p0 + 8 * c : Y, ok);
          continue;
        }
        if (j >= NC) continue;
        const int d = j % 9, sdy = SH * (d / 3 - 1), sdx = SH * (d % 3 - 1);
        const int p = p0 + 8 * c, x0 = p % W, yy = p / W + sdy;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (yy >= 0 && yy < H) {
          const __nv_bfloat16* src = Y + ((size_t)b * Cy + j / 9) * HW + yy * W + x0;
          const uint4 mid = __ldg(reinterpret_cast<const uint4*>(src));
          if (sdx == 0) {
            v = mid;
          } else if (sdx > 0) {
            const uint4 nxt = x0 + 8 < W ? __ldg(reinterpret_cast<const uint4*>(src + 8))
                                         : make_uint4(0, 0, 0, 0);
            v = shift_right1(mid, nxt);
          } else {
            const uint4 prv = x0 > 0 ? __ldg(reinterpret_cast<const uint4*>(src - 8))
                                     : make_uint4(0, 0, 0, 0);
            v = shift_left1(prv, mid);
          }
        }
        *reinterpret_cast<uint4*>(gbase + (ys - sbase) + sw128(r, c)) = v;
      }
    }
    cp_async_commit();  // an empty group past the last step keeps the count
  };
#pragma unroll
  for (int t = 0; t < WT_AHEAD; ++t) load(t);

  float acc[2][32], part_[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<WT_AHEAD - 1>();  // this thread's copies of step t landed
    fence_async_smem();             // its copies and stores, to wgmma's reads
    __syncthreads();                // everyone's; step t - 1's products done
    const uint32_t xs = sbase + (t % WT_STAGES) * WT_STAGE_BYTES, ys = xs + WT_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < WT_BK / 16; ++kk)
        wgmma_n64(part_[h], tc_desc(xs + wg * 64 * 128 + 32 * kk),
                  tc_desc(ys + h * 64 * 128 + 32 * kk), kk);
      wgmma_commit();
      acc_fence(part_[h]);  // in flight: the compiler leaves them be
    }
    load(t + WT_AHEAD);  // into step t - 1's slot, under the products
    wgmma_wait<1>();
    acc_fence(part_[0]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = __fadd_rn(acc[0][i], part_[0][i]);
    wgmma_wait<0>();
    acc_fence(part_[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[1][i] = __fadd_rn(acc[1][i], part_[1][i]);
  }
  cp_async_wait<0>();  // no copy outlives the block

  // the accumulator fragment: entry 4 jj + v of half h is row x = wg 64 +
  // warp 16 + lane / 4 (+ 8 for v >= 2) of X, column h 64 + 8 jj + 2
  // (lane % 4) + v % 2 of Y
  const int warp = wt / 32, lane = wt % 32;
  float* const o = part + (size_t)split * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = r0 + wg * 64 + warp * 16 + lane / 4 + (i % 4 >= 2 ? 8 : 0);
      const int j = j0 + h * 64 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      if (x >= R || j >= NC) continue;
      if (SH >= 0)
        o[(size_t)x * N + j] = acc[h][i];
      else
        o[(size_t)(j / 9) * N + x * 9 + j % 9] = acc[h][i];
    }
}

template <int IN>
cudaError_t wgrad_prep(const float* v, const float* h, const float* beta, long long n,
                       __nv_bfloat16* out, int nsm, cudaStream_t s) {
  const long long n4 = n / 4, need = (n4 + WT_PREP_THREADS - 1) / WT_PREP_THREADS;
  const long long blocks = need < 8LL * nsm ? need : 8LL * nsm;
  wgrad_prep_kernel<IN><<<(unsigned)blocks, WT_PREP_THREADS, 0, s>>>(v, h, beta, n4, out);
  return cudaGetLastError();
}

// static: internal linkage, so that each library that includes this
// header keeps its own once-per-instantiation state below (as
// mma_gemm.cuh's launch_tc_np). A function-local static of a function with
// external linkage is one object across every loaded library (a GNU-unique
// symbol): the second library would find it set and launch its own copy of
// the kernel without ever raising its shared-memory limit.
template <int SH>
static cudaError_t wgrad_product(const __nv_bfloat16* X, int R, const __nv_bfloat16* Y,
                                 int Cy, int NC, int H, int W, int steps, int total,
                                 int splits, float* part, int M, int N, cudaStream_t s) {
  auto kernel = wgrad_tc_kernel<SH>;
  static bool attr = false;  // once per instantiation (one device)
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WT_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int tr = (R + WT_ROWS - 1) / WT_ROWS, tc = (NC + WT_COLS - 1) / WT_COLS;
  kernel<<<tr * tc * splits, WT_THREADS, WT_SMEM, s>>>(X, R, Y, Cy, NC, H, W, steps, total,
                                                        tr, tc, part, M, N);
  return cudaGetLastError();
}

// rv_wgrad in mode bf16: the two pre-passes into a16 (Bn, M, HW) and b16
// (Bn, Cb, HW), then the product. ain IN_ID | IN_DSWISH, bin IN_ID |
// IN_SWISH | IN_DSWISH; the splits hold whole examples (kchunk % HW == 0),
// H * W % 64 == 0 and W % 8 == 0, the float32 tensors 16-byte aligned.
// cudaErrorInvalidValue for what it does not take.
static cudaError_t launch_wgrad_tc(int ain, int bin, int shift, const float* a,
                                   const float* ah, const float* beta_a, const float* bsrc,
                                   const float* bh, const float* beta_b, int M, int N,
                                   int Cb, int H, int W, int Bn, int splits, long long kchunk,
                                   __nv_bfloat16* a16, __nv_bfloat16* b16, float* part,
                                   cudaStream_t s) {
  const int HW = H * W;
  if (HW % WT_BK || W % 8 || kchunk % HW || kchunk < HW ||
      (long long)splits * kchunk < (long long)Bn * HW || N != (shift ? 9 * Cb : Cb))
    return cudaErrorInvalidValue;
  static int nsm = 0;
  if (nsm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      nsm = 0;
      return e;
    }
  }
  cudaError_t e = cudaErrorInvalidValue;
  const long long na = (long long)Bn * M * HW, nbb = (long long)Bn * Cb * HW;
  if (ain == IN_ID) e = wgrad_prep<IN_ID>(a, nullptr, nullptr, na, a16, nsm, s);
  if (ain == IN_DSWISH) e = wgrad_prep<IN_DSWISH>(a, ah, beta_a, na, a16, nsm, s);
  if (e != cudaSuccess) return e;
  e = cudaErrorInvalidValue;
  if (bin == IN_ID) e = wgrad_prep<IN_ID>(bsrc, nullptr, nullptr, nbb, b16, nsm, s);
  if (bin == IN_SWISH) e = wgrad_prep<IN_SWISH>(bsrc, nullptr, beta_b, nbb, b16, nsm, s);
  if (bin == IN_DSWISH) e = wgrad_prep<IN_DSWISH>(bsrc, bh, beta_b, nbb, b16, nsm, s);
  if (e != cudaSuccess) return e;
  const int steps = (int)(kchunk / WT_BK), total = (int)((long long)Bn * HW / WT_BK);
  if (!shift)
    return wgrad_product<0>(a16, M, b16, Cb, Cb, H, W, steps, total, splits, part, M, N, s);
  if (M >= Cb)  // dW1: rows the M channels of A, columns the 9 Cb shifted rows of B
    return wgrad_product<1>(a16, M, b16, Cb, 9 * Cb, H, W, steps, total, splits, part, M, N, s);
  // dW3: rows the Cb channels of B, columns the 9 M rows of A shifted back
  return wgrad_product<-1>(b16, Cb, a16, M, 9 * M, H, W, steps, total, splits, part, M, N, s);
}

}  // namespace imnf
