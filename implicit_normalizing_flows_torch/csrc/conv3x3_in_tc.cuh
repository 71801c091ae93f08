// Tensor-core (mma.sync) 3x3 conv c -> mid for Hopper (sm_90a), in five
// forms that share the product:
//
//   acc[s][m][p] = sum_k W[net][m][k] * X(IN(inp[s]))[k][p],  net = s / nb,
//
// with k = ci * 9 + ky * 3 + kx (W's OIHW flattening, K = 9 c) and X the
// im2col of the zero-padded input, every slot s live.
// * EPI_SCALE_RND, mode bf16: out[s] = bf16_round(acc * scale[s]), scale
//   float32 or bfloat16 (ST), two nets stacked along the batch: the
//   Neumann chain's first J^T stage t2 = rnd(C3^T u * s2), dot(m3, u9) *
//   s2 of _make_apply_jt (implicit_normalizing_flows_tpu/ops/fused_chain.py
//   :182, in fused_neumann_chain2 :333); estimator.cu's nc_jt_in.
// * EPI_SCALE, mode bf16, on an active list: for the live slots s <
//   *count, out[s] = acc * scale[idx[s]] (unrounded), the input and the
//   scale (float32 or bfloat16, ST) of example idx[s], one net; the slots
//   past *count are not written: the backward solve's first J^T stage t =
//   d3(u9) * s2 of _make_apply_jt (implicit_normalizing_flows_tpu/ops
//   /fused_solve.py:867-882, in fused_backward_solve :930); implicit_grad.cu's
//   jt_conv3x3_in.
// * EPI_SWISH_LIN, modes tf32 / tf32x: h1 = acc + bias[m], out[s] =
//   swish(h1; beta_out) and aux[s] = swish'(h1; beta_out), with IN =
//   swish(.; beta_in) under preact, whose blocks of M group 0 also write
//   aux0[s] = swish'(inp[s]; beta_in): the merged block forward's
//   linearisation d1(xsh) + b1 of _make_eval (implicit_normalizing_flows_tpu
//   /ops/fused_solve.py:245-266) with s1x = _dswish(h1x) (and s0x) of
//   _block_fwd_kernel (:1706, in fused_block_forward :1814);
//   block_forward.cu's lin_conv3x3_in.
// * EPI_SWISH, modes tf32 / tf32x, on an active list: for the live slots s
//   < *count, out[s] = swish(acc + bias[m]; beta_out) with the input of
//   example idx[s] (IN = swish(.; beta_in) under preact); the slots past
//   *count are not written: the forward solve's first conv, [swish(h;
//   b0)], d1(xsh) + b1 and _swish(h1, b1) of _make_eval
//   (implicit_normalizing_flows_tpu/ops/fused_solve.py:245-266, in
//   fused_broyden_solve :1921); fused_solve.cu's conv3x3_in.
// * EPI_AFFINE, mode bf16, on an active list: for the live slots s <
//   *count, out[s] = alpha * acc [+ bias[m]] (unrounded), with IN = id,
//   swish(.; *beta_net) or inp * swish'(inh; *beta_net) (conv_gemm.cuh's
//   in_xform, the slope read on the device) of example idx[s], one net; the
//   slots past *count are not written: the re-attachment's h1 = W1
//   [swish](h) + b1 and t2 = +-C3^T u of _net_vjp_in_kernel
//   (implicit_normalizing_flows_tpu/ops/fused_solve.py:1093, in
//   fused_reattach_vjp :1226); implicit_grad.cu's rv_conv3x3_in.
// PASSES 1 (mode bf16): both operands bf16, the sums float32. PASSES 3 / 4
// (tf32 / tf32x): the bf16 split of both operands, hi = rn(v), lo = rn(v -
// hi), and the products hi*hi + hi*lo + lo*hi (+ lo*lo), exactly
// _make_dot's model (fused_solve.py:101-135); never native TF32. Mode f32
// (every form) and bf16 of the linearisation stay on conv_gemm.cuh.
//
// The final pair's affine form of mode bf16 has a kernel of its own below
// (conv3x3_in_dmma_kernel): out[s] = acc + bias[net] (bias optional),
// unrounded, IN as EPI_AFFINE's at the slope beta_net[net], nets stacked
// along the batch: h1 = W1 a0 + b1, th1 = W1 ta0 and r2 = C3^T acc of
// _final_T_in_kernel and _final_grads_in_kernel
// (implicit_normalizing_flows_tpu/ops/fused_solve.py:1346, :1372, in
// fused_final_pair :1689), estimator.cu's fp_conv_in. Its operands are the
// same bf16 values (the same im2col tile), but it sums their exact products
// in float64 on the FP64 tensor cores (mma.sync m8n8k4 f64) and rounds
// once: the final pair's weight gradients at 8x8 are sums over 4,096 terms
// that cancel, so a float32 sum of h1 and th1 moves them past the 1e-5
// that the pair is held to against the exactly summed path (chip_smoke.py
// phase 9: cuDNN's order by 1.75e-5, EPI_AFFINE's K tiles of 16 by
// 1.39e-5; the float64 sums read 8.9e-6). That is a cost of the design, not
// a bound of the function: the function's bound is its bytes (its bf16
// products are few), 256 MiB written at 32x32 (0.08 ms), 64 MiB at 16x16
// (0.02 ms), 16 MiB at 8x8 (0.005 ms), but the FP64 rate (67 TFLOP/s)
// holds the kernel to at least 0.054 ms for its 1.8 G products (both nets,
// every scale): 2.7 and 11 times the bytes' bound at 16x16 and 8x8. The
// re-attachment's floors leave room for float32 sums, so it runs
// EPI_AFFINE.
//
// What bounds it on an H100 (32x32, mid 512, c 3): bytes. The chain's form
// writes t2 as float32 (the next stage reads float32) and reads s2: 402 MB
// at B 64 x 2 nets with bf16 s2, 0.12 ms at 3.35 TB/s (0.16 ms with float32
// s2); the backward solve's form reads s2 (bf16) and writes t as float32,
// 192 MiB with all 64 slots live, 0.060 ms; the linearisation writes
// swish(h1) and s1 as float32, 256 MiB at B 64, 0.08 ms; the solve's form
// swish(h1) of the live slots, 128 MiB with all 64 live, 0.04 ms; the
// re-attachment's writes h1 or t2, 128 MiB, 0.04 ms. The
// products are few: K is 27, 108 or 432. The CUDA-core kernel
// (conv_gemm.cuh, SRC 0) rebuilt the im2col for each of the 8 64-row M
// tiles with an integer divide and modulo per element, ran the products (3
// or 4 FMA passes in the split modes) on the CUDA cores, read its scale
// with scalar loads and stored scalars whose lanes lay 16 bytes apart.
//
// The design against that bound:
// * A block owns one slot's band of NP pixels (whole image rows: 128, or 64
//   at 8x8) and a group of the M channels. It loads the band's c-channel
//   input with a one-row, one-column halo once into shared memory as
//   float32 (zero outside the image), applies IN once per loaded element,
//   and builds the band's im2col from it once (each k's halo offset read
//   from a table of the block's): a pixel-major bf16 tile (a lo tile beside
//   it in the split modes), K padded with zeros to a multiple of 16, rows
//   of an odd number of 16-byte chunks so that the 16-byte stores and the
//   ldmatrix reads are free of bank conflicts.
// * Products: mma.sync m16n8k16, bf16 x bf16 -> f32, M the output
//   channels, N the pixels, so that a lane pair's fragments hold 4
//   consecutive pixels of one channel row after one exchange: every
//   output leaves as a 16-byte store, a warp's eight covering whole 32-byte
//   sectors of 16 rows. A (the weights, OIHW bf16, cast once per step or
//   solve) is read from L2 / L1 into registers per K step, zero past K (in
//   mode bf16 one step ahead of the products: 8x8's K of 432 is 27 steps);
//   B from the im2col tile by ldmatrix. Each warp owns 16 channels x 64
//   pixels of an M chunk (64 channels at NP 128, 128 at NP 64).
// * Sums: each K tile of 16 products goes into a fresh float32 partial,
//   added to the sum with round-to-nearest adds: the tensor cores truncate
//   as they add (mma_gemm.cuh). In the split modes hi*hi has its partial
//   and sum, and the small passes share a second partial and sum; the
//   epilogue adds the two, then the bias.
// * The epilogue's scale (16 or 8 bytes per 4 pixels) is loaded at the
//   chunk's start, under its products; the swish family is rounded op by op
//   as conv_gemm.cuh's epilogue.
// * Occupancy: two blocks of 256 threads an SM (at most 128 registers a
//   thread; the split forms spill a few bytes). Where slots x bands fill
//   less than twice the card (16x16, 8x8), the M chunks are split into
//   groups of blocks (a power of two), each rebuilding the band's small
//   im2col, so that 8x8's 128 slots become 512 blocks. The forms on an
//   active list keep the grid of their whole batch: the blocks of slots at
//   or past *count return at once (the host does not read the count). The groups
//   divide the chunks evenly (a mid of 384 at 8x8, 3 chunks, keeps one
//   group). M need only be a multiple of 64: the last chunk at NP 64 may
//   hold 64 rows, for 4 of the 8 warps.
#pragma once

#include <stdint.h>

#include "mma_gemm.cuh"

namespace imnf {

constexpr int C3I_THREADS = 256;  // 8 warps
constexpr int C3I_CMAX = 48;      // input channels: K = 9 c <= 432
constexpr int C3I_BK = 16;        // the K tile of a fresh partial (one mma.sync K step)
constexpr int C3I_MQ = 64;        // M comes in multiples of this

__host__ __device__ constexpr int c3i_np(int tw) { return tw == 8 ? 64 : 128; }
__host__ __device__ constexpr int c3i_kpad(int c) { return (9 * c + C3I_BK - 1) / C3I_BK * C3I_BK; }
// the im2col row of a pixel: an odd number of 16-byte chunks
__host__ __device__ constexpr int c3i_stride(int c) { return ((c3i_kpad(c) / 8) | 1) * 16; }
__host__ __device__ constexpr int c3i_halo_bytes(int tw, int c) {
  return (c * (c3i_np(tw) / tw + 2) * (tw + 2) * 4 + 127) / 128 * 128;
}
// the halo offset of each k of the im2col (-1 past K)
__host__ __device__ constexpr int c3i_koff_bytes(int c) { return (c3i_kpad(c) * 4 + 127) / 128 * 128; }
__host__ __device__ constexpr int c3i_smem_bytes(int tw, int c, int panels) {
  // the halo tile, the k offsets, the im2col tile(s), slack to align the
  // base to 128 bytes
  return c3i_halo_bytes(tw, c) + c3i_koff_bytes(c) + panels * c3i_np(tw) * c3i_stride(c) + 128;
}

// The A fragment of mma.m16n8k16 (row-major, 16 x 16) at rows m .. m + 15,
// columns k .. k + 15 of a (rows, K) bfloat16 matrix, zero past K.
__device__ __forceinline__ void c3i_load_a(uint32_t (&a)[4], const unsigned short* w, int K,
                                           int m, int k, int lane) {
  const unsigned short* r0 = w + (size_t)(m + lane / 4) * K;
  const unsigned short* r1 = r0 + (size_t)8 * K;
  const int k0 = k + 2 * (lane % 4);
  if (K % 2 == 0) {  // the pairs are 4-byte aligned
    auto pair = [&](const unsigned short* r, int kk) -> uint32_t {
      return kk < K ? __ldg(reinterpret_cast<const unsigned int*>(r + kk)) : 0u;
    };
    a[0] = pair(r0, k0), a[1] = pair(r1, k0), a[2] = pair(r0, k0 + 8), a[3] = pair(r1, k0 + 8);
  } else {
    auto pair = [&](const unsigned short* r, int kk) -> uint32_t {
      const uint32_t lo = kk < K ? __ldg(r + kk) : 0u;
      const uint32_t hi = kk + 1 < K ? __ldg(r + kk + 1) : 0u;
      return lo | (hi << 16);
    };
    a[0] = pair(r0, k0), a[1] = pair(r1, k0), a[2] = pair(r0, k0 + 8), a[3] = pair(r1, k0 + 8);
  }
}

// IN of the affine forms, by act (IN_ID, IN_SWISH, IN_DSWISH with h the
// pre-activation): conv_gemm.cuh's in_xform, rounded op by op.
__device__ __forceinline__ float c3i_in(int act, float v, const float* h, size_t off, float beta) {
  return act == IN_SWISH    ? in_xform<IN_SWISH>(v, h, off, beta)
         : act == IN_DSWISH ? in_xform<IN_DSWISH>(v, h, off, beta)
                            : v;
}

// The block's tiles, in its dynamic shared memory (c3i_smem_bytes), for the
// band of NP pixels from row y0 of the example x (C, H, TW): the band's
// input with a one-row, one-column halo as float32, xform(v, off, hr)
// applied once per element inside the image (off its offset in x, hr its
// row of the halo tile), zero outside; each k's halo offset; then the
// band's im2col, 8 consecutive k of one pixel a thread and step, as one
// 16-byte store into each tile (hi [, lo]). Returns the hi tile: NP
// pixel-major rows of c3i_stride(C) bytes, the lo tile NP rows past it.
template <int TW, bool SPLIT, typename Xform>
__device__ __forceinline__ uint8_t* c3i_build_tile(const float* x, int C, int H, int y0,
                                                   Xform xform) {
  constexpr int NP = c3i_np(TW), R = NP / TW, HPW = TW + 2, HR = R + 2;
  extern __shared__ uint8_t c3i_smem[];
  const uint32_t raw = smem_u32(c3i_smem);
  float* const halo = reinterpret_cast<float*>(c3i_smem + (((raw + 127u) & ~127u) - raw));
  int* const koff = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(halo) +
                                           c3i_halo_bytes(TW, C));
  uint8_t* const col = reinterpret_cast<uint8_t*>(koff) + c3i_koff_bytes(C);
  const int K = 9 * C, KP = c3i_kpad(C), S = c3i_stride(C);
  const int HW = H * TW, tid = threadIdx.x;
  for (int i = tid; i < C * HR * HPW; i += C3I_THREADS) {
    const int xx = i % HPW - 1, hr = (i / HPW) % HR, ci = i / (HPW * HR), y = y0 + hr - 1;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < TW) {
      const size_t off = (size_t)ci * HW + y * TW + xx;
      v = xform(__ldg(x + off), off, hr);
    }
    halo[i] = v;
  }
  for (int k = tid; k < KP; k += C3I_THREADS) {
    const int ci = k / 9, d = k - 9 * ci;
    koff[k] = k < K ? (ci * HR + d / 3) * HPW + d % 3 : -1;
  }
  __syncthreads();
  for (int i = tid; i < NP * (KP / 8); i += C3I_THREADS) {
    const int p = i % NP, kc = i / NP, po = (p / TW) * HPW + p % TW;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = koff[kc * 8 + j];
      v[j] = o >= 0 ? halo[o + po] : 0.f;
    }
    uint8_t* const dst = col + p * S + kc * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    if constexpr (SPLIT) {  // lo = rn(v - rn(v)), as conv_gemm.cuh's split()
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fsub_rn(v[j], bf16_round(v[j]));
      *reinterpret_cast<uint4*>(dst + NP * S) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }
  __syncthreads();
  return col;
}

// Grid (bands x groups, B slots); block x = band * groups + group. TW is
// the image width (8, 16 or 32); the band is NP / TW rows. w_hi [w_lo]:
// (nets, M, C, 3, 3) bf16; inp (B, C, H, TW); scale, out, aux (B, M, H TW);
// aux0 (B, C, H TW) or nullptr; bias (M) (EPI_SWISH_LIN, EPI_SWISH: one
// net; EPI_AFFINE: one net, or nullptr). EPI_SWISH, EPI_SCALE, EPI_AFFINE
// (one net): slot s < *count reads example idx[s] of inp (and of scale,
// inh). EPI_AFFINE: IN by act at the slope *beta_net (inh (B, C, H, TW)
// under IN_DSWISH), out = alpha * acc [+ bias].
template <int TW, int EPI, int PASSES, typename ST>
__global__ void __launch_bounds__(C3I_THREADS, 2) conv3x3_in_tc_kernel(
    const __nv_bfloat16* __restrict__ w_hi, const __nv_bfloat16* __restrict__ w_lo,
    const float* __restrict__ bias, const float* __restrict__ inp, int C, int H, int M,
    int groups, int nb, int preact, float beta_in, float beta_out,
    const ST* __restrict__ scale, float* __restrict__ out, float* __restrict__ aux,
    float* __restrict__ aux0, const int* __restrict__ idx, const int* __restrict__ count,
    const float* __restrict__ inh, const float* __restrict__ beta_net, float alpha, int act) {
  static_assert(((EPI == EPI_SCALE_RND || EPI == EPI_SCALE || EPI == EPI_AFFINE) &&
                 PASSES == 1) ||
                    ((EPI == EPI_SWISH_LIN || EPI == EPI_SWISH) && (PASSES == 3 || PASSES == 4)),
                "the chain's, the backward solve's or the re-attachment's form (bf16), the "
                "linearisation's or the solve's (tf32 / tf32x)");
  constexpr bool SPLIT = PASSES > 1;
  // on an active list
  constexpr bool LIST = EPI == EPI_SWISH || EPI == EPI_SCALE || EPI == EPI_AFFINE;
  constexpr int NP = c3i_np(TW), R = NP / TW;
  constexpr int WN = NP / 64, WM = 8 / WN, CH = 16 * WM;  // warps along N, M; chunk rows
  const int K = 9 * C, KP = c3i_kpad(C), S = c3i_stride(C);
  const int HW = H * TW, tid = threadIdx.x;
  const int slot = blockIdx.y, band = blockIdx.x / groups, g = blockIdx.x % groups;
  if constexpr (LIST) {
    if (slot >= *count) return;  // a dead slot: its blocks return at once
  }
  const int net = slot / nb, y0 = band * R, p0 = y0 * TW;
  const int e = LIST ? idx[slot] : slot;  // the example the slot reads
  const float* const x = inp + (size_t)e * C * HW;

  // the band's input with its halo, transformed once per element; under
  // preact the blocks of group 0 write swish'(x) of the band's pixels
  float* const s0 = EPI == EPI_SWISH_LIN && preact && g == 0 ? aux0 + (size_t)slot * C * HW
                                                               : nullptr;
  const float* const xh = EPI == EPI_AFFINE && act == IN_DSWISH ? inh + (size_t)e * C * HW
                                                                : nullptr;
  const float beta = EPI == EPI_AFFINE && act != IN_ID ? __ldg(beta_net + net) : 0.f;
  uint8_t* const col = c3i_build_tile<TW, SPLIT>(x, C, H, y0, [&](float v, size_t off, int hr) {
    if constexpr (EPI == EPI_AFFINE) {
      return c3i_in(act, v, xh, off, beta);
    } else {
      if ((EPI == EPI_SWISH_LIN || EPI == EPI_SWISH) && preact) {
        if (s0 != nullptr && hr >= 1 && hr <= R) s0[off] = dswish(v, beta_in);
        v = swish(v, beta_in);
      }
      return v;
    }
  });

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM;
  const bool odd = lane & 1;
  const int cq = 2 * ((lane % 4) & ~1);  // the lane pair's first pixel in 8
  // the launcher's groups divide the chunks; at NP 64 (128-row chunks) a
  // chunk past M's last multiple of 128 holds 64 rows, and the warps past
  // them sit it out
  const int nch = CH > C3I_MQ ? (M + CH - 1) / CH : M / CH, cpg = nch / groups;
  const unsigned short* const wh =
      reinterpret_cast<const unsigned short*>(w_hi) + (size_t)net * M * K;
  const unsigned short* const wl =
      SPLIT ? reinterpret_cast<const unsigned short*>(w_lo) + (size_t)net * M * K : wh;
  // this lane's ldmatrix row: pixel wn * 64 + 16 jp + 8 (lane / 16) + lane % 8
  // of n-tile pair jp, k chunk (lane / 8) % 2 of the K step
  const uint32_t brow = smem_u32(col) + (wn * 64 + (lane / 16) * 8 + lane % 8) * S +
                        ((lane / 8) % 2) * 16;
  const int pl0 = p0 + wn * 64 + cq;  // + 8 j: this lane's 4 pixels of n-tile j

  for (int cc = 0; cc < cpg; ++cc) {
    const int m0 = (g * cpg + cc) * CH + wm * 16;
    if (CH > C3I_MQ && m0 >= M) continue;  // warp-uniform
    // after the pair's exchange a lane holds row r: m0 + lane / 4 (even
    // lane) or + 8 (odd lane)
    const int r = m0 + lane / 4 + (odd ? 8 : 0);
    const size_t orow = ((size_t)slot * M + r) * HW;
    typename Vec4<ST>::type sv[8];
    float bv = 0.f;
    if constexpr (EPI == EPI_SCALE_RND || EPI == EPI_SCALE) {
      const size_t srow = EPI == EPI_SCALE ? ((size_t)e * M + r) * HW : orow;  // by example
#pragma unroll
      for (int j = 0; j < 8; ++j) sv[j] = ldv4(scale + srow + pl0 + 8 * j);
    } else if constexpr (EPI == EPI_AFFINE) {
      if (bias != nullptr) bv = __ldg(bias + r);
    } else {
      bv = __ldg(bias + r);
    }
    float acc[8][4], accl[SPLIT ? 8 : 1][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int j = 0; j < (SPLIT ? 8 : 1); ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) accl[j][i] = 0.f;

    // mode bf16 loads A of the next K step under this step's products; the
    // split forms, short of registers, load each step's hi and lo halves at
    // its start
    uint32_t ah[4], al[4], nh[4];
    if constexpr (!SPLIT) c3i_load_a(nh, wh, K, m0, 0, lane);
#pragma unroll 1
    for (int ks = 0; ks < KP / C3I_BK; ++ks) {
      if constexpr (SPLIT) {
        c3i_load_a(ah, wh, K, m0, ks * C3I_BK, lane);
        c3i_load_a(al, wl, K, m0, ks * C3I_BK, lane);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[i] = nh[i];
        if (ks + 1 < KP / C3I_BK) c3i_load_a(nh, wh, K, m0, (ks + 1) * C3I_BK, lane);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bh[4], bl[4];
        const uint32_t addr = brow + jp * 16 * S + ks * 32;
        ldmatrix_x4(bh, addr);
        if constexpr (SPLIT) ldmatrix_x4(bl, addr + NP * S);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * jp + h;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_16816(part, ah, bh[2 * h], bh[2 * h + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], part[i]);
          if constexpr (SPLIT) {
            float pl[4] = {0.f, 0.f, 0.f, 0.f};
            mma_16816(pl, ah, bl[2 * h], bl[2 * h + 1]);  // hi * lo
            mma_16816(pl, al, bh[2 * h], bh[2 * h + 1]);  // lo * hi
            if constexpr (PASSES == 4) mma_16816(pl, al, bl[2 * h], bl[2 * h + 1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) accl[j][i] = __fadd_rn(accl[j][i], pl[i]);
          }
        }
      }
    }

    // the fragment's rows r, r + 8 and columns 2 (lane % 4), + 1: the lane
    // pair exchanges halves, so that each lane holds 4 pixels of one row
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a0 = acc[j][0], a1 = acc[j][1], b0 = acc[j][2], b1 = acc[j][3];
      if constexpr (SPLIT) {  // hh + (hl + lh [+ ll])
        a0 = __fadd_rn(a0, accl[j][0]), a1 = __fadd_rn(a1, accl[j][1]);
        b0 = __fadd_rn(b0, accl[j][2]), b1 = __fadd_rn(b1, accl[j][3]);
      }
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      float4 o = odd ? make_float4(x0, x1, b0, b1) : make_float4(a0, a1, x0, x1);
      const size_t off = orow + pl0 + 8 * j;
      if constexpr (EPI == EPI_SCALE_RND) {
        const float4 sc = widen4(sv[j]);
        o = make_float4(bf16_round(__fmul_rn(o.x, sc.x)), bf16_round(__fmul_rn(o.y, sc.y)),
                        bf16_round(__fmul_rn(o.z, sc.z)), bf16_round(__fmul_rn(o.w, sc.w)));
      } else if constexpr (EPI == EPI_SCALE) {
        const float4 sc = widen4(sv[j]);
        o = make_float4(__fmul_rn(o.x, sc.x), __fmul_rn(o.y, sc.y), __fmul_rn(o.z, sc.z),
                        __fmul_rn(o.w, sc.w));
      } else if constexpr (EPI == EPI_AFFINE) {  // alpha * acc, then + bias, as _affine
        o = make_float4(__fmul_rn(alpha, o.x), __fmul_rn(alpha, o.y), __fmul_rn(alpha, o.z),
                        __fmul_rn(alpha, o.w));
        if (bias != nullptr)
          o = make_float4(__fadd_rn(o.x, bv), __fadd_rn(o.y, bv), __fadd_rn(o.z, bv),
                          __fadd_rn(o.w, bv));
      } else {
        const float4 h = make_float4(__fadd_rn(o.x, bv), __fadd_rn(o.y, bv), __fadd_rn(o.z, bv),
                                     __fadd_rn(o.w, bv));
        o = make_float4(swish(h.x, beta_out), swish(h.y, beta_out), swish(h.z, beta_out),
                        swish(h.w, beta_out));
        if constexpr (EPI == EPI_SWISH_LIN)
          *reinterpret_cast<float4*>(aux + off) =
              make_float4(dswish(h.x, beta_out), dswish(h.y, beta_out), dswish(h.z, beta_out),
                          dswish(h.w, beta_out));
      }
      *reinterpret_cast<float4*>(out + off) = o;
    }
  }
}

// Once per kernel (one device; nsm the launcher's function-local static):
// the SMs' count and the kernel's shared-memory cap. Then the grid: each
// slot's bands times the M-chunk groups, doubled while the blocks fill less
// than twice the card and the groups divide the chunks evenly.
template <typename Kernel>
static cudaError_t c3i_grid(Kernel kernel, int& nsm, int tw, int B, int H, int M, int& groups,
                            dim3& grid) {
  if (nsm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TC_SMEM_MAX);
    if (e != cudaSuccess) {
      nsm = 0;
      return e;
    }
  }
  const int np = c3i_np(tw), ch = 16 * 8 / (np / 64), bands = H * tw / np;
  const int nch = (M + ch - 1) / ch;
  groups = 1;
  while (nch % (2 * groups) == 0 && (long long)B * bands * groups < 2LL * nsm) groups *= 2;
  grid = dim3(bands * groups, B);
  return cudaSuccess;
}

// static: internal linkage, so that each library that includes this header
// keeps its own `nsm` below (as mma_gemm.cuh's launch_tc_np).
template <int TW, int EPI, int PASSES, typename ST>
static cudaError_t launch_c3i_tc(const __nv_bfloat16* w_hi, const __nv_bfloat16* w_lo,
                                 const float* bias, const float* inp, int B, int nets, int C,
                                 int H, int M, int preact, float beta_in, float beta_out,
                                 const ST* scale, float* out, float* aux, float* aux0,
                                 cudaStream_t s, const int* idx, const int* count,
                                 const float* inh, const float* beta_net, float alpha, int act) {
  auto kernel = conv3x3_in_tc_kernel<TW, EPI, PASSES, ST>;
  const int bytes = c3i_smem_bytes(TW, C, PASSES > 1 ? 2 : 1);
  if (bytes > TC_SMEM_MAX) return cudaErrorInvalidValue;
  static int nsm = 0;  // once per instantiation (one device)
  int groups;
  dim3 grid;
  const cudaError_t e = c3i_grid(kernel, nsm, TW, B, H, M, groups, grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, C3I_THREADS, bytes, s>>>(
      w_hi, w_lo, bias, inp, C, H, M, groups, B / nets, preact, beta_in, beta_out, scale, out,
      aux, aux0, idx, count, inh, beta_net, alpha, act);
  return cudaGetLastError();
}

// A 3x3 conv c -> M on the tensor cores: inp (B, C, H, W) of `nets` nets (B
// / nets examples each), w_hi [w_lo] (nets, M, C, 3, 3) bfloat16, out [aux]
// (B, M, H W) by slot. EPI_SCALE_RND (PASSES 1): scale (B, M, H W), float32
// or bfloat16. EPI_SCALE (PASSES 1, one net): scale as EPI_SCALE_RND's, by
// example, the active list idx (B) and count (1), out by slot.
// EPI_SWISH_LIN (PASSES 3 / 4, one net): bias (M), aux, and with preact
// aux0 (B, C, H W). EPI_SWISH (PASSES 3 / 4, one net): bias, the
// active list idx (B) and count (1), out by slot. EPI_AFFINE (PASSES 1, one
// net): out = alpha * acc [+ bias (M)], IN by act at the slope *beta_net (a
// device pointer; inh (B, C, H W) under IN_DSWISH), the active list idx
// (B) and count (1), out by slot. Takes C <= 48 (within the
// shared memory an SM grants), M a multiple of 64, W 8, 16 or 32, H a
// multiple of the band's rows (NP / W) and 16-byte aligned scale, out and
// aux; cudaErrorInvalidValue otherwise.
template <int EPI, int PASSES, typename ST>
cudaError_t launch_conv3x3_in_tc(const __nv_bfloat16* w_hi, const __nv_bfloat16* w_lo,
                                 const float* bias, const float* inp, int B, int nets, int C,
                                 int H, int W, int M, int preact, float beta_in,
                                 float beta_out, const ST* scale, float* out, float* aux,
                                 float* aux0, cudaStream_t s, const int* idx = nullptr,
                                 const int* count = nullptr, const float* inh = nullptr,
                                 const float* beta_net = nullptr, float alpha = 1.f,
                                 int act = IN_ID) {
  if (C < 1 || C > C3I_CMAX || M < C3I_MQ || M % C3I_MQ || nets < 1 || B % nets ||
      (W != 8 && W != 16 && W != 32) || H < 1 || (H * W) % c3i_np(W) ||
      (EPI == EPI_SCALE_RND && scale == nullptr) ||
      (EPI == EPI_SCALE && (scale == nullptr || nets != 1 || idx == nullptr ||
                            count == nullptr)) ||
      (EPI == EPI_SWISH_LIN && (bias == nullptr || aux == nullptr || nets != 1 ||
                                (preact && aux0 == nullptr))) ||
      (EPI == EPI_SWISH && (bias == nullptr || nets != 1 || idx == nullptr ||
                            count == nullptr)) ||
      (EPI == EPI_AFFINE && (nets != 1 || idx == nullptr || count == nullptr || act < IN_ID ||
                             act > IN_DSWISH || (act != IN_ID && beta_net == nullptr) ||
                             (act == IN_DSWISH && inh == nullptr))) ||
      (PASSES > 1 && w_lo == nullptr))
    return cudaErrorInvalidValue;
#define C3I_W(TW)                                                                             \
  if (W == TW)                                                                                \
    return launch_c3i_tc<TW, EPI, PASSES, ST>(w_hi, w_lo, bias, inp, B, nets, C, H, M, preact, \
                                              beta_in, beta_out, scale, out, aux, aux0, s, idx, \
                                              count, inh, beta_net, alpha, act);
  C3I_W(8)
  C3I_W(16)
  C3I_W(32)
#undef C3I_W
  return cudaErrorInvalidValue;
}

// The final pair's affine form on the FP64 tensor cores. The block's band,
// halo and bf16 im2col tile are the forms' above (c3i_build_tile, the
// transform applied once per loaded element), and so are the warps' chunks
// of 16 channels x 64 pixels; each warp takes its 64 pixels in two halves of
// 32 (a half's 4 x 2 m8n8 tiles hold 16 float64 sums a thread, 80
// registers; the 64 pixels in one pass, the next K step's operands loaded
// under the products, took 128 and spilled, 1.04-1.18x slower). Per K step
// of 4, a lane widens one bf16 weight of each m8 tile (from L2 / L1) and one
// im2col value of each n8 tile (from the tile: 8 pixels' rows of an odd
// number of 16-byte chunks, free of bank conflicts) to float64 (the
// conversion unit; building the float64 bits with integer ops was 1.3-1.9x
// slower), then the 8 products run as mma.sync.m8n8k4.f64. The epilogue
// rounds each sum once to float32, then adds the bias as the plain version
// adds it; a lane holds 2 consecutive pixels of a row (8-byte stores, 4
// lanes a 32-byte sector).
__device__ __forceinline__ double bf16_to_f64(unsigned short u) {
  return (double)__uint_as_float((uint32_t)u << 16);  // exact
}

__device__ __forceinline__ void dmma_884(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// Grid and band as conv3x3_in_tc_kernel's, every slot live; w (nets, M, C,
// 3, 3) bf16; bias (nets, M) or nullptr; inp, inh (B, C, H, TW); out (B, M,
// H TW); IN by act at the slope beta_net[net] (a device array).
template <int TW>
__global__ void __launch_bounds__(C3I_THREADS, 2) conv3x3_in_dmma_kernel(
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ inp, const float* __restrict__ inh,
    const float* __restrict__ beta_net, int act, int C, int H, int M, int groups, int nb,
    float* __restrict__ out) {
  constexpr int NP = c3i_np(TW), R = NP / TW;
  constexpr int WN = NP / 64, WM = 8 / WN, CH = 16 * WM;  // warps along N, M; chunk rows
  const int K = 9 * C, KP = c3i_kpad(C), S = c3i_stride(C);
  const int HW = H * TW, tid = threadIdx.x;
  const int slot = blockIdx.y, band = blockIdx.x / groups, g = blockIdx.x % groups;
  const int net = slot / nb, y0 = band * R, p0 = y0 * TW;
  const float* const xh = act == IN_DSWISH ? inh + (size_t)slot * C * HW : nullptr;
  const float beta = act != IN_ID ? __ldg(beta_net + net) : 0.f;
  const uint8_t* const col = c3i_build_tile<TW, false>(
      inp + (size_t)slot * C * HW, C, H, y0,
      [&](float v, size_t off, int) { return c3i_in(act, v, xh, off, beta); });

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM, q = lane / 4, kq = lane % 4;
  const int nch = CH > C3I_MQ ? (M + CH - 1) / CH : M / CH, cpg = nch / groups;
  const unsigned short* const wk =
      reinterpret_cast<const unsigned short*>(w) + (size_t)net * M * K + kq;
  // this lane's im2col value of n8 tile j: pixel wn * 64 + 32 h + 8 j + q, k = 4 ks + kq
  const uint8_t* const bl = col + (wn * 64 + q) * S + kq * 2;
  for (int cc = 0; cc < cpg; ++cc) {
    const int m0 = (g * cpg + cc) * CH + wm * 16;
    if (CH > C3I_MQ && m0 >= M) continue;  // warp-uniform
    const unsigned short* const wa = wk + (size_t)(m0 + q) * K;  // row m0 + q (+ 8)
    float bv[2] = {0.f, 0.f};  // the bias of rows m0 + q and m0 + 8 + q
    if (bias != nullptr) {
      const float* const brow = bias + (size_t)net * M + m0 + q;
      bv[0] = __ldg(brow), bv[1] = __ldg(brow + 8);
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      double acc[2][4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
      const uint8_t* const bh = bl + 32 * h * S;
#pragma unroll 2
      for (int ks = 0; ks < KP / 4; ++ks) {
        const int k = 4 * ks;
        double a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a[i] = k + kq < K ? bf16_to_f64(__ldg(wa + (size_t)8 * i * K + k)) : 0.0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = bf16_to_f64(*reinterpret_cast<const unsigned short*>(bh + 8 * j * S + 2 * k));
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dmma_884(acc[i][j], a[i], b[j]);
      }
      // a lane holds row m0 + 8 i + q, pixels 2 kq and 2 kq + 1 of each n8 tile
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t orow = ((size_t)slot * M + m0 + 8 * i + q) * HW + p0 + wn * 64 + 32 * h +
                            2 * kq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 o = make_float2(__double2float_rn(acc[i][j][0]), __double2float_rn(acc[i][j][1]));
          if (bias != nullptr) o = make_float2(__fadd_rn(o.x, bv[i]), __fadd_rn(o.y, bv[i]));
          *reinterpret_cast<float2*>(out + orow + 8 * j) = o;
        }
      }
    }
  }
}

// The final pair's launcher (static, as launch_c3i_tc).
template <int TW>
static cudaError_t launch_c3i_dmma(const __nv_bfloat16* w, const float* bias, int act,
                                   const float* beta_net, const float* inp, const float* inh,
                                   int B, int nets, int C, int H, int M, float* out,
                                   cudaStream_t s) {
  auto kernel = conv3x3_in_dmma_kernel<TW>;
  const int bytes = c3i_smem_bytes(TW, C, 1);
  if (bytes > TC_SMEM_MAX) return cudaErrorInvalidValue;
  static int nsm = 0;  // once per instantiation (one device)
  int groups;
  dim3 grid;
  const cudaError_t e = c3i_grid(kernel, nsm, TW, B, H, M, groups, grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, C3I_THREADS, bytes, s>>>(w, bias, inp, inh, beta_net, act, C, H, M, groups,
                                          B / nets, out);
  return cudaGetLastError();
}

// The forms the libraries launch, defined in conv3x3_in_tc.cu: a translation
// unit of their own, linked into the libraries of estimator.cu (the chain's,
// EPI_SCALE_RND, and the final pair's float64 form), implicit_grad.cu (the
// backward solve's, EPI_SCALE, and the re-attachment's, EPI_AFFINE),
// block_forward.cu (the linearisation's, EPI_SWISH_LIN, passes 3 or 4) and
// fused_solve.cu (the solve's, EPI_SWISH, passes 3 or 4). Instantiated
// beside estimator.cu's kernels, this kernel moved the SASS of two of them
// (mma_gemm.cuh's tc_conv1x1_kernel<NP, float, EPI_AFFINE, IN_DSWISH, 1>),
// though they share no code. Hidden, so that each library calls its own
// copy.
#define C3I_API __attribute__((visibility("hidden")))
C3I_API cudaError_t conv3x3_in_tc_chain(const __nv_bfloat16* w, const float* u, int B, int nets,
                                        int C, int H, int W, int M, const float* s2, float* out,
                                        cudaStream_t s);
C3I_API cudaError_t conv3x3_in_tc_chain(const __nv_bfloat16* w, const float* u, int B, int nets,
                                        int C, int H, int W, int M, const __nv_bfloat16* s2,
                                        float* out, cudaStream_t s);
C3I_API cudaError_t conv3x3_in_tc_jt(const __nv_bfloat16* w, const float* u, const int* idx,
                                     const int* count, int B, int C, int H, int W, int M,
                                     const float* s2, float* out, cudaStream_t s);
C3I_API cudaError_t conv3x3_in_tc_jt(const __nv_bfloat16* w, const float* u, const int* idx,
                                     const int* count, int B, int C, int H, int W, int M,
                                     const __nv_bfloat16* s2, float* out, cudaStream_t s);
C3I_API cudaError_t conv3x3_in_tc_lin(int passes, const __nv_bfloat16* w_hi,
                                      const __nv_bfloat16* w_lo, const float* bias,
                                      const float* inp, int B, int C, int H, int W, int M,
                                      int preact, float beta_in, float beta_out, float* out,
                                      float* s1, float* s0, cudaStream_t s);
C3I_API cudaError_t conv3x3_in_tc_solve(int passes, const __nv_bfloat16* w_hi,
                                        const __nv_bfloat16* w_lo, const float* bias,
                                        const float* inp, const int* idx, const int* count,
                                        int B, int C, int H, int W, int M, int preact,
                                        float beta_in, float beta_out, float* out,
                                        cudaStream_t s);
C3I_API cudaError_t conv3x3_in_tc_affine(const __nv_bfloat16* w, const float* bias, float alpha,
                                         int act, const float* beta, const float* inp,
                                         const int* idx, const int* count, int B, int C, int H,
                                         int W, int M, float* out, cudaStream_t s);
C3I_API cudaError_t conv3x3_in_dmma_affine(const __nv_bfloat16* w, const float* bias, int act,
                                           const float* beta_net, const float* inp,
                                           const float* inh, int B, int nets, int C, int H,
                                           int W, int M, float* out, cudaStream_t s);

}  // namespace imnf
