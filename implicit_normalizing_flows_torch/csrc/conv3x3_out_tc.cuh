// Tensor-core (mma.sync) 3x3 conv mid -> c for Hopper (sm_90a), in five
// forms that share the product:
//
//   acc[e][co][p] = sum_{m, d} W[co][m][d] * bf16(IN(t[s][m][p + off(d)])),
//                   e = idx[s],
//
// (in the forward solve's form the bf16 split's 3 or 4 passes of t and W)
// for the live slots s < *count, zero outside the image.
// * IN_DSWISH, C3_STORE: the re-attachment's last cotangent product t0 =
//   C1^T (t1 swish'(h1)), out[e] = acc with IN(t) = t1 swish'(h1): R =
//   dot(m1t, t1h) and its shifted sum in _net_vjp_in_kernel
//   (implicit_normalizing_flows_tpu/ops/fused_solve.py:1093, in
//   fused_reattach_vjp :1226); implicit_grad.cu's rv_conv3x3_out.
// * IN_ID, C3_RESID: the backward solve's residual u + J^T u - grad, out[e]
//   = base[e] + acc * s0[e] - sub[e] (each op rounded, as conv_gemm.cuh's
//   conv3x3_out_kernel), s0 float32 or bfloat16 (ST): R = d1(t), the taps'
//   shifted sum and v * s0 of _make_apply_jt (fused_solve.py:867-888, in
//   resid :909 of fused_backward_solve :930); implicit_grad.cu's
//   jt_conv3x3_out.
// * IN_ID, C3_CHAIN: the Neumann chain's last J^T stage and its sum, u[s] =
//   bf16_round(acc * s0[s]) and chain_acc[s] += coef[k] * u[s] (each op
//   rounded, as conv_gemm.cuh's CHAIN), s0 float32 or bfloat16 (ST), two
//   nets stacked along the batch (net = s / nb, every slot live): R =
//   dot(m1, t), the taps' shifted sum and (v * s0).astype(cdtype) of
//   _make_apply_jt (implicit_normalizing_flows_tpu/ops/fused_chain.py
//   :206-211) and acc + c_k u of _chain2_kernel (:239-272, in
//   fused_neumann_chain2 :333); estimator.cu's nc_jt_out_acc, linked from
//   conv3x3_out_tc.cu. Its weights come pre-cast (below).
// * IN_ID, C3_FINAL: the final pair's backward C1^T products, out[s] = acc,
//   every slot live, on the chain's pre-cast weights of `wnets` nets, net
//   (s / nb) modulo wnets (under preact rh1 and p_h1 of both nets are four
//   "nets" on two nets' weights): back_c1 of _final_grads_in_kernel
//   (implicit_normalizing_flows_tpu/ops/fused_solve.py:1420-1433, in
//   fused_final_pair :1689); estimator.cu's fp_conv_out, linked from
//   conv3x3_out_tc.cu.
// * IN_ID, C3_SOLVE, PASSES 3 / 4 (modes tf32 / tf32x): the forward solve's
//   residual, out[e] = base[e] + sgn * (acc + bias[co]) [- sub[e]] (each op
//   rounded, in conv_gemm.cuh's conv3x3_out_kernel's order), acc the bf16
//   split's hi*hi + hi*lo + lo*hi (+ lo*lo), exactly _make_dot's model
//   (implicit_normalizing_flows_tpu/ops/fused_solve.py:101-135; never native
//   TF32), on the active list: R = d3(t), the taps' shifted sum and + b3 of
//   _make_eval (:245-280) inside resid = x_embed - eval_z(z) - z (:797-798,
//   in fused_broyden_solve :1921); fused_solve.cu's conv3x3_out, linked from
//   conv3x3_out_tc.cu. Its weights come pre-cast (below), W3's hi and lo
//   halves each in the chain's tile layout.
// Modes bf16 of the mid -> c forms above; modes f32 (the solve's ladder's
// last stage, and every form's) and the solve's bf16 stay on conv_gemm.cuh's
// conv3x3_out_kernel.
//
// What bounds it on an H100 (32x32, B 64, mid 512, c 3): bytes. The
// re-attachment's form reads t1 and h1 as float32 once, 256 MiB: 0.080 ms at
// 3.35 TB/s; the backward solve's reads t once, 128 MiB: 0.041 ms; the
// product is 1.8 GFLOP; the chain's reads t1 of both nets, 256 MiB: 0.080
// ms, and so does the final pair's (0.161 ms for its four "nets"); the
// forward solve's reads t once, 128 MiB: 0.041 ms (its 3 or 4 passes, 5.4 or
// 7.2 GFLOP of bf16 products, 0.005-0.007 ms). The CUDA-core kernel ran one thread per pixel and group of 4 output
// channels and re-read each input (and recomputed t1 swish'(h1) from two
// float32 loads) for each of the 9 taps and each channel group.
//
// The design against that bound:
// * A block owns one slot's band of C3_TH image rows (all W columns) and
//   walks the mid channels in chunks of 64. Each chunk it loads the band's
//   t (and h1) with a one-row halo above and below (16-byte loads, 32
//   contiguous bytes of a channel row per lane pair), forms IN(t) once per
//   loaded element (the swish family rounded op by op as conv_gemm.cuh's
//   in_xform), rounds it to bf16 and stores the tile pixel-major: a 128-byte
//   row of 64 channels for each of the (C3_TH + 2) x (W + 2) halo pixels,
//   the pixels outside the image zero, the row's 16-byte chunks
//   XOR-swizzled by the pixel's low 3 bits (sw128), so that the stores and
//   the ldmatrix reads below are free of bank conflicts.
// * The 9 taps are shifted reads of that tile: tap (dy, dx)'s A operand for
//   output pixel (y, x) is halo pixel (y + 1 + dy, x + 1 + dx). The products
//   run on mma.sync m16n8k16, bf16 x bf16 -> f32: M 16 pixels, N 8 output
//   channels (c padded with zero weights to 8, 16 or 48), K 16 channels.
//   mma.sync and not wgmma: wgmma takes A from shared memory only as a
//   64-row tile in one fixed layout, which a shifted window of the halo
//   tile is not; mma.sync takes A from registers (ldmatrix of any 16 rows)
//   at N 8. The products are few: the tensor cores' rate does not bound it.
// * The chunk's weights (float32 holding bf16 values, OIHW) are rounded to
//   bf16 and stored the same way, one 128-byte row per (tap, output
//   channel). The chain's and the final pair's forms take them cast once
//   per call into that tile layout (bf16 rows tap * NPAD + co of each net's
//   64-channel chunks, NPAD c padded to 8 NT: ops/fused_solve.py's
//   tile_w1t) and copy a chunk's rows with 16-byte cp.async into one of two
//   buffers, issued before the previous chunk's products: at 8x8 (c 48) the float32 OIHW
//   staging took 27,648 scalar loads a chunk and block. One block takes
//   every output-channel tile of its band: splitting the tiles over 2 or 3
//   blocks of a band, each forming the band's halo tile again, made 16x16
//   and 8x8 slower on an H100 (PERF.md, section 6).
// * Sums: each (tap, chunk) K tile of 64 products goes into a fresh float32
//   partial, added to the sum with round-to-nearest adds: the tensor cores
//   truncate as they add (mma_gemm.cuh).
// * 256 threads a block and 42-67 KB of shared memory, 3-5 blocks per SM:
//   one block's loads overlap another's products.
// * The forward solve's split form (PASSES 3 / 4): each loaded element is
//   split once, hi = rn(v) and lo = rn(v - hi), into two halo tiles; W3's
//   halves come pre-cast in the tile layout, one buffer of both halves
//   copied with cp.async at the chunk's start, under the halo's loads (two
//   buffers would take 247 KB a block at c 48). Per (chunk, tap) hi*hi goes
//   into one fresh float32 partial and hi*lo + lo*hi (+ lo*lo) into a
//   second, each added round-to-nearest to its own sum; the epilogue adds
//   the two sums, then the bias. The band's output-channel tiles are split
//   over `groups` blocks of 1 or 2 tiles (ops/fused_solve.py's
//   C3_SOLVE_GROUPS: c 3 and c 12 one block, c 48 three), each forming the
//   band's halo tiles again: so 8x8 (c 48, one band, 64 slots) fills 192
//   blocks of 62.6 KB, all resident at once, where one block for all 6
//   tiles (136 KB) would leave half the SMs idle. 105.6 KB a block at
//   32x32, 83.1 KB at 16x16; 85-128 registers: 2 blocks an SM.
#pragma once

#include <stdint.h>

#include "mma_gemm.cuh"

namespace imnf {

constexpr int C3_TH = 8;        // image rows a block owns
constexpr int C3_MC = 64;       // mid channels a chunk: one 128-byte row a pixel
constexpr int C3_THREADS = 256;

constexpr int c3_smem_bytes(int tw, int nt, int wbufs = 1, int halos = 1) {
  // the halo tile(s), the chunk's weights (the chain's form: two buffers;
  // the solve's: hi and lo), slack to align the base to 128 bytes
  return halos * (C3_TH + 2) * (tw + 2) * 128 + wbufs * 9 * 8 * nt * 128 + 128;
}

// The epilogues: out = acc, the backward solve's residual, the Neumann
// chain's term and its sum, out = acc on the pre-cast weights, or the
// forward solve's residual
enum { C3_STORE = 0, C3_RESID = 1, C3_CHAIN = 2, C3_FINAL = 3, C3_SOLVE = 4 };

// Grid (H / C3_TH bands, B slots); a slot at or past *count returns. TW is
// the image width (8, 16 or 32), NT the 8-channel output tiles (c <= 8 NT),
// IN the input form (IN_DSWISH with th and beta, or IN_ID), EPI the
// epilogue (C3_RESID reads base, scale and sub, indexed as out). The 8 warps
// split the band's 16-pixel M tiles (and, when there are fewer than 8 of
// them, the N tiles). C3_CHAIN: slots of nets stacked nb each, wt the
// pre-cast tile layout (nets, MID / 64, 9 * 8 NT, 64) bf16, out u (B, C,
// H*W), scale s0, chain_acc += coef[kterm] * u. C3_FINAL: wt as the chain's
// for wnets nets, slot s taking net (s / nb) % wnets, out (B, C, H*W).
// C3_SOLVE (PASSES 3 / 4): grid (H / C3_TH bands x groups, B slots), the
// block's NT tiles those of group g = blockIdx.x % groups; wt and wtl W3's
// hi and lo halves in the tile layout (MID / 64, 9 * 8 NT groups, 64) bf16;
// out, base and sub (nullptr: none) by example, bias (C).
template <int TW, int NT, int IN, int EPI, typename ST, int PASSES = 1>
__global__ void __launch_bounds__(C3_THREADS, PASSES > 1 ? 2 : 3) conv3x3_out_tc_kernel(
    const float* __restrict__ w, const float* __restrict__ t,
    const float* __restrict__ th, float beta, const int* __restrict__ idx,
    const int* __restrict__ count, int C, int MID, int H,
    float* __restrict__ out, const float* __restrict__ base,
    const ST* __restrict__ scale, const float* __restrict__ sub,
    const __nv_bfloat16* __restrict__ wt, int nb, const float* __restrict__ coef, int kterm,
    float* __restrict__ chain_acc, int wnets, const __nv_bfloat16* __restrict__ wtl,
    const float* __restrict__ bias, float sgn, int groups) {
  static_assert(((IN == IN_DSWISH && EPI == C3_STORE) || (IN == IN_ID && EPI == C3_RESID) ||
                 (IN == IN_ID && EPI == C3_CHAIN) || (IN == IN_ID && EPI == C3_FINAL)) ==
                        (PASSES == 1) &&
                    (IN == IN_ID && EPI == C3_SOLVE) == (PASSES == 3 || PASSES == 4),
                "the re-attachment's form, the backward solve's, the chain's or the final "
                "pair's (bf16), or the forward solve's (tf32 / tf32x)");
  constexpr bool CHAIN = EPI == C3_CHAIN, SPLIT = EPI == C3_SOLVE;
  constexpr bool TILED = CHAIN || EPI == C3_FINAL;  // the pre-cast weights, two buffers
  constexpr int HPW = TW + 2, HP = (C3_TH + 2) * HPW;  // halo row, halo pixels
  constexpr int NPAD = 8 * NT;
  constexpr int MT = C3_TH * TW / 16;                  // M tiles of the band
  constexpr int WM = MT >= 8 ? 8 : MT, WN = 8 / WM;    // warps along M and N
  constexpr int MPW = MT / WM, NPW = (NT + WN - 1) / WN;
  constexpr int NPG = TW / 4;                          // 4-pixel groups a row
  extern __shared__ uint8_t c3_smem[];
  const uint32_t raw = smem_u32(c3_smem);
  const uint32_t act = (raw + 127u) & ~127u;  // [HP][128 bytes], swizzled
  uint8_t* const act_g = c3_smem + (act - raw);  // SPLIT: hi, then lo HP * 128 on
  constexpr int HALOS = SPLIT ? 2 : 1;
  uint8_t* const ws_g = act_g + HALOS * HP * 128;  // [9 * NPAD][128 bytes], swizzled
  // the pre-cast ones: two such, a chunk in turn; SPLIT: hi, then lo
  constexpr int WS_BYTES = 9 * NPAD * 128;

  const int slot = blockIdx.y;
  if (count != nullptr && slot >= *count) return;
  const int e = idx != nullptr ? idx[slot] : slot;
  const int band = SPLIT ? blockIdx.x / groups : blockIdx.x;
  const int g = SPLIT ? blockIdx.x % groups : 0;  // the block's group of output tiles
  const int HW = H * TW, y0 = band * C3_TH;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wm = warp % WM, wn = warp / WM;
  const float* const ts = t + (size_t)slot * MID * HW;
  const float* const hs = IN == IN_DSWISH ? th + (size_t)slot * MID * HW : nullptr;

  // the border pixels stay zero; the in-image ones are written every chunk
  for (int i = tid; i < HALOS * HP * 8; i += C3_THREADS)
    reinterpret_cast<uint4*>(act_g)[i] = make_uint4(0u, 0u, 0u, 0u);

  // the halo pixel of this lane's ldmatrix row (band pixel (mt * 16 + lane
  // % 16)) at the centre tap, for each of the warp's M tiles mt
  int hrow[MPW];
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    const int q = (wm + i * WM) * 16 + lane % 16;
    hrow[i] = (q / TW + 1) * HPW + q % TW + 1;
  }
  // SPLIT: acc sums hi*hi, accl the small passes
  float acc[MPW][NPW][4], accl[SPLIT ? MPW : 1][SPLIT ? NPW : 1][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) accl[i][j][k] = 0.f;
  }

  // the pre-cast weights: chunk ci's 9 NPAD rows of this net's tile layout
  // into buffer b, 16 bytes a copy
  const int net = EPI == C3_FINAL ? slot / nb % wnets : slot / nb;
  const __nv_bfloat16* const wnet =
      TILED ? wt + (size_t)net * (MID / C3_MC) * WS_BYTES / 2 : nullptr;
  auto stage_w = [&](int ci, int b) {
    const uint32_t dst = act + HP * 128 + b * WS_BYTES;
    const __nv_bfloat16* const src = wnet + (size_t)ci * WS_BYTES / 2;
    for (int i = tid; i < 9 * NPAD * 8; i += C3_THREADS)
      cp_async16(dst + sw128(i / 8, i % 8), src + i * 8, true);
    cp_async_commit();
  };
  if constexpr (TILED) stage_w(0, 0);
  // SPLIT: chunk ci's rows of both halves, the block's group's NPAD rows
  // of each tap (of the layout's NPAD groups), into the one buffer
  auto stage_split = [&](int ci) {
    const uint32_t dst = act + HALOS * HP * 128;
    const int rows = 9 * NPAD * groups;
    for (int i = tid; i < 2 * 9 * NPAD * 8; i += C3_THREADS) {
      const int r = i / 8 % (9 * NPAD), half = i / (9 * NPAD * 8);
      const int src = (ci * rows + r / NPAD * NPAD * groups + g * NPAD + r % NPAD) * 64;
      cp_async16(dst + half * WS_BYTES + sw128(r, i % 8), (half ? wtl : wt) + src + i % 8 * 8,
                 true);
    }
    cp_async_commit();
  };

  for (int m0 = 0; m0 < MID; m0 += C3_MC) {
    __syncthreads();  // the zeroing, or the previous chunk's products, done
    if constexpr (SPLIT) {
      stage_split(m0 / C3_MC);  // under the halo's loads below
    } else if constexpr (TILED) {
      // the next chunk's weights, under this chunk's loads and products
      if (m0 + C3_MC < MID) stage_w(m0 / C3_MC + 1, (m0 / C3_MC + 1) & 1);
    } else {
      // the chunk's weights: row d * NPAD + co holds W[co][m0 .. m0 + 63][d]
      for (int i = tid; i < NPAD * C3_MC; i += C3_THREADS) {
        const int co = i / C3_MC, ch = i % C3_MC;
        const float* src = w + ((size_t)co * MID + m0 + ch) * 9;
#pragma unroll
        for (int d = 0; d < 9; ++d) {
          const float v = co < C ? __ldg(src + d) : 0.f;
          *reinterpret_cast<__nv_bfloat16*>(ws_g + sw128(d * NPAD + co, ch / 8) +
                                            (ch % 8) * 2) = __float2bfloat16_rn(v);
        }
      }
    }
    // the activations: unit u covers channels m0 + 2 cp, + 1 at 4 pixels of
    // halo row hr; a warp takes 16 channel pairs x 2 neighbouring groups
    constexpr int UNITS = (C3_TH + 2) * NPG * (C3_MC / 2);
#pragma unroll 2
    for (int u = tid; u < UNITS; u += C3_THREADS) {
      const int cp = (u & 15) | (((u >> 5) & 1) << 4);
      const int rest = u >> 6;
      const int pg = ((rest % (NPG / 2)) << 1) | ((u >> 4) & 1);
      const int hr = rest / (NPG / 2), y = y0 + hr - 1;
      if (y < 0 || y >= H) continue;
      const size_t off = (size_t)(m0 + 2 * cp) * HW + y * TW + 4 * pg;
      const float4 ta = ldv4(ts + off), tb = ldv4(ts + off + HW);
      uint32_t px[4];
      if constexpr (IN == IN_DSWISH) {
        const float4 ha = ldv4(hs + off), hb = ldv4(hs + off + HW);
        px[0] = pack_bf16(__fmul_rn(ta.x, dswish(ha.x, beta)), __fmul_rn(tb.x, dswish(hb.x, beta)));
        px[1] = pack_bf16(__fmul_rn(ta.y, dswish(ha.y, beta)), __fmul_rn(tb.y, dswish(hb.y, beta)));
        px[2] = pack_bf16(__fmul_rn(ta.z, dswish(ha.z, beta)), __fmul_rn(tb.z, dswish(hb.z, beta)));
        px[3] = pack_bf16(__fmul_rn(ta.w, dswish(ha.w, beta)), __fmul_rn(tb.w, dswish(hb.w, beta)));
      } else {
        px[0] = pack_bf16(ta.x, tb.x);
        px[1] = pack_bf16(ta.y, tb.y);
        px[2] = pack_bf16(ta.z, tb.z);
        px[3] = pack_bf16(ta.w, tb.w);
      }
      const int hp0 = hr * HPW + 4 * pg + 1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(act_g + sw128(hp0 + j, cp >> 2) + (cp & 3) * 4) = px[j];
      if constexpr (SPLIT) {  // lo = rn(v - rn(v)), as conv_gemm.cuh's split()
        const auto lo = [](float v) { return __fsub_rn(v, bf16_round(v)); };
        px[0] = pack_bf16(lo(ta.x), lo(tb.x));
        px[1] = pack_bf16(lo(ta.y), lo(tb.y));
        px[2] = pack_bf16(lo(ta.z), lo(tb.z));
        px[3] = pack_bf16(lo(ta.w), lo(tb.w));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(act_g + HP * 128 + sw128(hp0 + j, cp >> 2) +
                                       (cp & 3) * 4) = px[j];
      }
    }
    if constexpr (SPLIT) {
      cp_async_wait<0>();  // this chunk's weights landed
    } else if constexpr (TILED) {  // this chunk's weights landed (the next chunk's may still fly)
      if (m0 + C3_MC < MID)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    __syncthreads();  // the tile and the weights are whole
    const uint8_t* const wbuf = TILED ? ws_g + ((m0 / C3_MC) & 1) * WS_BYTES : ws_g;

    // the products: per tap, 4 K steps of 16 channels into fresh partials
#pragma unroll 1
    for (int d = 0; d < 9; ++d) {
      const int shift = (d / 3 - 1) * HPW + d % 3 - 1;
      float part[MPW][NPW][4], pl[SPLIT ? MPW : 1][SPLIT ? NPW : 1][4];
#pragma unroll
      for (int i = 0; i < MPW; ++i)
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) part[i][j][k] = 0.f;
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < MPW; ++i)
#pragma unroll
          for (int j = 0; j < NPW; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) pl[i][j][k] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < C3_MC / 16; ++ks) {
        uint32_t b[NPW][2], bl[SPLIT ? NPW : 1][2];
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int r = d * NPAD + (wn * NPW + j) * 8 + lane / 4;
          const uint8_t* row = wbuf + (lane % 4) * 4;
          b[j][0] = wn * NPW + j < NT ? *reinterpret_cast<const uint32_t*>(row + sw128(r, 2 * ks)) : 0u;
          b[j][1] = wn * NPW + j < NT ? *reinterpret_cast<const uint32_t*>(row + sw128(r, 2 * ks + 1)) : 0u;
          if constexpr (SPLIT) {
            bl[j][0] = wn * NPW + j < NT ? *reinterpret_cast<const uint32_t*>(row + WS_BYTES + sw128(r, 2 * ks)) : 0u;
            bl[j][1] = wn * NPW + j < NT ? *reinterpret_cast<const uint32_t*>(row + WS_BYTES + sw128(r, 2 * ks + 1)) : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          uint32_t a[4];
          ldmatrix_x4(a, act + sw128(hrow[i] + shift, 2 * ks + lane / 16));
#pragma unroll
          for (int j = 0; j < NPW; ++j)
            if (wn * NPW + j < NT) mma_16816(part[i][j], a, b[j][0], b[j][1]);
          if constexpr (SPLIT) {
            uint32_t al[4];
            ldmatrix_x4(al, act + HP * 128 + sw128(hrow[i] + shift, 2 * ks + lane / 16));
#pragma unroll
            for (int j = 0; j < NPW; ++j) {
              if (wn * NPW + j >= NT) continue;
              mma_16816(pl[i][j], a, bl[j][0], bl[j][1]);  // hi * lo
              mma_16816(pl[i][j], al, b[j][0], b[j][1]);   // lo * hi
              if constexpr (PASSES == 4) mma_16816(pl[i][j], al, bl[j][0], bl[j][1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MPW; ++i)
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[i][j][k] = __fadd_rn(acc[i][j][k], part[i][j][k]);
            if constexpr (SPLIT) accl[i][j][k] = __fadd_rn(accl[i][j][k], pl[i][j][k]);
          }
    }
  }

  // the fragment's rows lane / 4 and + 8, columns 2 (lane % 4) and + 1
  const float ck = CHAIN ? coef[kterm] : 0.f;
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int nt = wn * NPW + j;
      if (nt >= NT) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = y0 * TW + (wm + i * WM) * 16 + lane / 4 + 8 * (k / 2);
        const int co = (g * NT + nt) * 8 + 2 * (lane % 4) + k % 2;
        if constexpr (EPI == C3_SOLVE) {  // hh + (hl + lh [+ ll]), + b3, then the residual
          const size_t o = ((size_t)e * C + co) * HW + p;
          if (co < C) {
            const float r = __fadd_rn(__fadd_rn(acc[i][j][k], accl[i][j][k]), bias[co]);
            float v = __fadd_rn(__fmul_rn(sgn, r), base[o]);
            if (sub != nullptr) v = __fsub_rn(v, sub[o]);
            out[o] = v;
          }
        } else if constexpr (EPI == C3_RESID) {
          const size_t o = ((size_t)e * C + co) * HW + p;
          if (co < C)
            out[o] = __fsub_rn(__fadd_rn(base[o], __fmul_rn(acc[i][j][k], ld(scale, o))), sub[o]);
        } else if constexpr (EPI == C3_CHAIN) {
          const size_t o = ((size_t)e * C + co) * HW + p;
          if (co < C) {
            const float r = bf16_round(__fmul_rn(acc[i][j][k], ld(scale, o)));
            out[o] = r;
            chain_acc[o] = __fadd_rn(chain_acc[o], __fmul_rn(ck, r));
          }
        } else {  // C3_STORE, C3_FINAL
          if (co < C) out[((size_t)e * C + co) * HW + p] = acc[i][j][k];
        }
      }
    }
}

// static: internal linkage, so that each library that includes this
// header keeps its own `ready` below (as mma_gemm.cuh's launch_tc_np). A
// function-local static of a template with external linkage is one object
// across every loaded library (a GNU-unique symbol): the second library
// would find it set and launch its own copy of the kernel without ever
// raising its shared-memory limit.
template <int TW, int NT, int IN, int EPI, typename ST>
static cudaError_t launch_c3_tc(const float* w, const float* t, const float* th, float beta,
                                const int* idx, const int* count, int B, int C, int MID, int H,
                                float* out, const float* base, const ST* scale,
                                const float* sub, cudaStream_t s) {
  auto kernel = conv3x3_out_tc_kernel<TW, NT, IN, EPI, ST>;
  constexpr int bytes = c3_smem_bytes(TW, NT);
  static bool ready = false;  // once per instantiation
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<dim3(H / C3_TH, B), C3_THREADS, bytes, s>>>(w, t, th, beta, idx, count, C, MID, H,
                                                        out, base, scale, sub, nullptr, 1,
                                                        nullptr, 0, nullptr, 1, nullptr,
                                                        nullptr, 0.f, 1);
  return cudaGetLastError();
}

template <int IN, int EPI, typename ST>
cudaError_t launch_c3_tc_any(const float* w, const float* t, const float* th, float beta,
                             const int* idx, const int* count, int B, int C, int MID, int H,
                             int W, float* out, const float* base, const ST* scale,
                             const float* sub, cudaStream_t s) {
  if (C < 1 || C > 48 || MID < C3_MC || MID % C3_MC || H < C3_TH || H % C3_TH)
    return cudaErrorInvalidValue;
#define C3_W(TW)                                                                             \
  if (W == TW) {                                                                             \
    if (C <= 8)                                                                              \
      return launch_c3_tc<TW, 1, IN, EPI>(w, t, th, beta, idx, count, B, C, MID, H, out,     \
                                          base, scale, sub, s);                              \
    if (C <= 16)                                                                             \
      return launch_c3_tc<TW, 2, IN, EPI>(w, t, th, beta, idx, count, B, C, MID, H, out,     \
                                          base, scale, sub, s);                              \
    return launch_c3_tc<TW, 6, IN, EPI>(w, t, th, beta, idx, count, B, C, MID, H, out, base, \
                                        scale, sub, s);                                      \
  }
  C3_W(8)
  C3_W(16)
  C3_W(32)
#undef C3_W
  return cudaErrorInvalidValue;
}

// The chain's form. static, as launch_c3_tc.
template <int TW, int NT, typename ST>
static cudaError_t launch_c3_chain(const __nv_bfloat16* wt, const float* t, int B, int nets,
                                   int C, int MID, int H, const ST* s0, const float* coef,
                                   int k, float* u_out, float* acc, cudaStream_t s) {
  auto kernel = conv3x3_out_tc_kernel<TW, NT, IN_ID, C3_CHAIN, ST>;
  constexpr int bytes = c3_smem_bytes(TW, NT, 2);
  static bool ready = false;  // once per instantiation
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<dim3(H / C3_TH, B), C3_THREADS, bytes, s>>>(nullptr, t, nullptr, 0.f, nullptr,
                                                        nullptr, C, MID, H, u_out, nullptr, s0,
                                                        nullptr, wt, B / nets, coef, k, acc,
                                                        nets, nullptr, nullptr, 0.f, 1);
  return cudaGetLastError();
}

// u = bf16_round(s0 * C1^T t) and acc += coef[k] * u for every slot of
// `nets` nets stacked along the batch, on the tensor cores: wt the tile
// layout (nets, MID / 64, 9 * 8 NT, 64) bf16 (8 NT: C padded to 8, 16 or
// 48), t (B, MID, H*W), s0 (float32 or bfloat16), u_out and acc (B, C,
// H*W). Takes what launch_conv3x3_out_tc takes, with a 16-byte aligned wt;
// cudaErrorInvalidValue otherwise.
template <typename ST>
cudaError_t launch_nc_conv3x3_out_tc(const __nv_bfloat16* wt, const float* t, int B, int nets,
                                     int C, int MID, int H, int W, const ST* s0,
                                     const float* coef, int k, float* u_out, float* acc,
                                     cudaStream_t s) {
  if (C < 1 || C > 48 || MID < C3_MC || MID % C3_MC || H < C3_TH || H % C3_TH || nets < 1 ||
      B % nets || wt == nullptr || s0 == nullptr || coef == nullptr || acc == nullptr)
    return cudaErrorInvalidValue;
#define C3_CHAIN_W(TW)                                                                       \
  if (W == TW) {                                                                             \
    if (C <= 8)                                                                              \
      return launch_c3_chain<TW, 1>(wt, t, B, nets, C, MID, H, s0, coef, k, u_out, acc, s);  \
    if (C <= 16)                                                                             \
      return launch_c3_chain<TW, 2>(wt, t, B, nets, C, MID, H, s0, coef, k, u_out, acc, s);  \
    return launch_c3_chain<TW, 6>(wt, t, B, nets, C, MID, H, s0, coef, k, u_out, acc, s);    \
  }
  C3_CHAIN_W(8)
  C3_CHAIN_W(16)
  C3_CHAIN_W(32)
#undef C3_CHAIN_W
  return cudaErrorInvalidValue;
}

// The final pair's form. static, as launch_c3_tc.
template <int TW, int NT>
static cudaError_t launch_c3_final(const __nv_bfloat16* wt, const float* t, int B, int nets,
                                   int wnets, int C, int MID, int H, float* out,
                                   cudaStream_t s) {
  auto kernel = conv3x3_out_tc_kernel<TW, NT, IN_ID, C3_FINAL, float>;
  constexpr int bytes = c3_smem_bytes(TW, NT, 2);
  static bool ready = false;  // once per instantiation
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const float* no_scale = nullptr;
  kernel<<<dim3(H / C3_TH, B), C3_THREADS, bytes, s>>>(nullptr, t, nullptr, 0.f, nullptr,
                                                        nullptr, C, MID, H, out, nullptr,
                                                        no_scale, nullptr, wt, B / nets,
                                                        nullptr, 0, nullptr, wnets, nullptr,
                                                        nullptr, 0.f, 1);
  return cudaGetLastError();
}

// The forward solve's split form. static, as launch_c3_tc.
template <int TW, int NT, int PASSES>
static cudaError_t launch_c3_solve(const __nv_bfloat16* wt, const __nv_bfloat16* wtl,
                                   const float* bias, const float* t, const int* idx,
                                   const int* count, int B, int C, int MID, int H, int groups,
                                   const float* base, float sgn, const float* sub, float* out,
                                   cudaStream_t s) {
  auto kernel = conv3x3_out_tc_kernel<TW, NT, IN_ID, C3_SOLVE, float, PASSES>;
  constexpr int bytes = c3_smem_bytes(TW, NT, 2, 2);
  static_assert(bytes <= TC_SMEM_MAX, "the split tiles fit a block");
  static bool ready = false;  // once per instantiation
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const float* no_scale = nullptr;
  kernel<<<dim3(H / C3_TH * groups, B), C3_THREADS, bytes, s>>>(
      nullptr, t, nullptr, 0.f, idx, count, C, MID, H, out, base, no_scale, sub, wt, 1, nullptr,
      0, nullptr, 1, wtl, bias, sgn, groups);
  return cudaGetLastError();
}

// The final pair's public launcher is conv3x3_out_tc.cu's
// conv3x3_out_tc_final (conv3x3_out_chain.cuh), defined there and not
// inline here: an inline launcher would instantiate launch_c3_final's
// kernels in every unit that includes this header (implicit_grad.cu). So is
// the forward solve's, conv3x3_out_tc_solve.

// out[idx[s]] = C1^T (t[s] swish'(th[s]; beta)) on the tensor cores, for
// slots s < *count: w (C, MID, 3, 3) float32 holding bf16 values (the
// flipped, transposed w1), t and th (B, MID, H*W), out (B, C, H*W) by
// example. Takes C <= 48, MID a multiple of 64, W 8, 16 or 32, H a multiple
// of 8 and 16-byte aligned t and th (the wrapper checks the pointers);
// cudaErrorInvalidValue otherwise.
inline cudaError_t launch_conv3x3_out_tc(const float* w, const float* t, const float* th,
                                         float beta, const int* idx, const int* count,
                                         int B, int C, int MID, int H, int W, float* out,
                                         cudaStream_t s) {
  return launch_c3_tc_any<IN_DSWISH, C3_STORE, float>(w, t, th, beta, idx, count, B, C, MID,
                                                      H, W, out, nullptr, nullptr, nullptr, s);
}

// out[e] = base[e] + s0[e] * C1^T t[s] - sub[e], e = idx[s], on the tensor
// cores, for slots s < *count: the backward solve's residual. w as above,
// t (B, MID, H*W) by slot, base, s0 (float32 or bfloat16), sub and out (B,
// C, H*W) by example. Takes what launch_conv3x3_out_tc takes, with a
// 16-byte aligned t; cudaErrorInvalidValue otherwise.
template <typename ST>
cudaError_t launch_jt_conv3x3_out_tc(const float* w, const float* t, const int* idx,
                                     const int* count, int B, int C, int MID, int H, int W,
                                     const float* base, const ST* s0, const float* sub,
                                     float* out, cudaStream_t s) {
  if (base == nullptr || s0 == nullptr || sub == nullptr) return cudaErrorInvalidValue;
  return launch_c3_tc_any<IN_ID, C3_RESID, ST>(w, t, nullptr, 0.f, idx, count, B, C, MID, H,
                                               W, out, base, s0, sub, s);
}

}  // namespace imnf
