// Tensor-core (wgmma) 1x1 conv for Hopper (sm_90a): the J^T stage C2^T t *
// s1 of two TPU kernels, the final pair's and the re-attachment's 512 ->
// 512 products (mode bf16), and the forward solve's 512 -> 512 product in
// the bf16 split modes tf32 / tf32x:
//
//   out[slot][m][p] = EPI(sum_k W[net][m][k] * X(IN(inp[slot][k][p])),
//                         scale[e][m][p] | bias[net][m]),  e = idx[slot] (or slot)
//
// * EPI_SCALE_RND, bf16_round(acc * s): the Neumann chain's nc_jt_mid
//   (estimator.cu), t1 = rnd(C2^T t2 * s1) of _make_apply_jt
//   (implicit_normalizing_flows_tpu/ops/fused_chain.py:182, in
//   fused_neumann_chain2 :333 and fused_neumann_chain :275), s bf16 or
//   float32, several nets a launch, every slot live;
// * EPI_SCALE, acc * s unrounded: the backward solve's jt_conv1x1_mid
//   (implicit_grad.cu), t = d2(t) * s1 of _make_apply_jt
//   (implicit_normalizing_flows_tpu/ops/fused_solve.py:887, in
//   fused_backward_solve :930), s1 bf16, one net, on an active list: slot
//   s < *count is live, t and out are indexed by slot, s1 by example
//   idx[slot]; a dead slot's out is never written;
// * EPI_AFFINE, acc [+ bias[net][m]] (the bias added after the product):
//   the final pair's fp_conv_mid (estimator.cu), h2 = W2 swish(h1) + b2,
//   th2 = W2 (th1 swish'(h1)) and W2^T on rh2 and p_h2 of
//   _final_T_in_kernel / _final_grads_in_kernel
//   (implicit_normalizing_flows_tpu/ops/fused_solve.py:1346, 1372, in
//   fused_final_pair :1689), 2 or 4 nets a launch, every slot live; and
//   the re-attachment's rv_conv1x1_mid (implicit_grad.cu), h2 = W2
//   swish(h1) + b2 and t1 = W2^T (t2 swish'(h2)) of _net_vjp_in_kernel
//   (fused_solve.py:1112, 1124, in fused_reattach_vjp :1226), one net,
//   slots past *count never written; both with the input transform IN
//   (conv_gemm.cuh's IN_ID, IN_SWISH, IN_DSWISH with inh) at each net's
//   slope beta_net[net] (a device pointer), applied once per element as
//   the panel is staged;
// * EPI_SWISH, swish(acc + bias[m]; beta_out), rounded op by op as
//   conv_gemm.cuh's epilogue: the forward solve's conv1x1_mid
//   (fused_solve.cu), h2 = d2(t) + b2; t = swish(h2) of _make_eval
//   (fused_solve.py:269-270, in fused_broyden_solve :1921), in the split
//   modes, one net, on the solve's active list (count, no idx);
// * EPI_SWISH_LIN, EPI_SWISH's output and aux[slot][m][p] = swish'(acc +
//   bias[m]; beta_out): the merged block forward's lin_conv1x1_mid
//   (block_forward.cu), h2 and s2 = _dswish(h2) of _block_fwd_kernel
//   (fused_solve.py:1792, in fused_block_forward :1814), in the split
//   modes, one net, every slot live.
// PASSES 1 (mode bf16): both operands bf16, the sums float32,
// _make_dot("bf16") of the JAX kernels. PASSES 3 / 4 (modes tf32 / tf32x,
// _make_dot's split, fused_solve.py:101-135): W and X each split into
// bf16 hi = rn(v) and lo = rn(v - hi); the products hi*hi + hi*lo + lo*hi
// (+ lo*lo) of bf16 values, each exact in float32, summed in float32.
// Native TF32 (10 mantissa bits) is never used: it is another error model.
// conv_gemm.cuh's SIMT template computes the same models with FP32 FMAs;
// mode f32 stays on it (its error model needs CUDA-core float32).
//
// What bounds it on an H100 (32x32, mid 512): bytes in mode bf16, the
// products in the split modes. nc_jt_mid (B 64 x 2 nets) is 68.7 GFLOP
// (0.07 ms at 989 TFLOP/s), but reads t2 as float32 (256 MiB) and s1 (128
// MiB bf16 or 256 MiB float32) and writes t1 as float32 (256 MiB): 0.20 ms
// (bf16 s) or 0.24 ms (float32 s) at 3.35 TB/s; jt_conv1x1_mid (B 64) moves
// 320 MiB, 0.10 ms; fp_conv_mid's th2 (B 64 x 2 nets) reads th1 and h1 and
// writes th2, 768 MiB, 0.24 ms; rv_conv1x1_mid's h2 (B 64) 256 MiB, 0.08
// ms. conv1x1_mid (B 64) moves 256 MiB (0.08 ms) for 3 x 34.4 GFLOP in
// tf32 (0.104 ms) and 4 x in tf32x (0.139 ms); lin_conv1x1_mid writes s2
// too, 384 MiB (0.12 ms). The SIMT template re-read
// each activation (and re-applied its transform or its split) once per
// 64-row M block (8 times at mid 512) and ran the products on CUDA cores
// (3 or 4 FMAs per MAC in the split modes).
//
// The design against that bound:
// * Activation-stationary: a block owns NP pixels of one slot (NP 128, or
//   64 when H*W <= 64 and in the split modes). It reads that tile's whole
//   K <= 512 panel once, as float32 slabs streamed by cp.async (16-byte
//   copies, 80 KB in flight; with IN_DSWISH each slab of inp travels with
//   the matching slab of inh) through the space the weight rings take
//   later, transforms (and splits) each element once, and keeps the panel
//   (NP x 512 bf16, 128 KB at NP 128; in the split modes a hi and a lo
//   panel, 2 x 64 KB at NP 64, which is why they take NP 64: 230,400 B
//   with the rings, of the 232,448 an SM grants) in dynamic shared memory
//   for all M rows. Each activation and s element is read from device
//   memory exactly once; each output is written once, 16 bytes a thread.
// * Weights from L2: one net's 512x512 bf16 kernel is 512 KB (its hi and
//   lo halves 1 MB) and stays in the 50 MB L2. Each of the block's two
//   consumer warpgroups takes every other 64-row M chunk and streams its
//   64x64 weight tiles through its own ring of TC_STAGES shared-memory
//   slots with cp.async (zero-filled past M and K): in mode bf16 one tile
//   a K step, four steps ahead of the products; in the split modes a W_hi
//   and a W_lo tile a K step (3 steps in the ring), two steps ahead (the
//   step before's slots are free once the warpgroup's barrier shows its
//   products done). At NP 64 each 64-pixel tile re-reads the 1 MB pair
//   from L2: 1 GB at 32x32, B 64, which with the products bounds the split
//   kernel above its device-memory bound.
// * Products: wgmma.mma_async m64n64k16, bf16 x bf16 -> f32, both operands
//   from shared memory, K-major, 128-byte swizzle (A: a weight tile's rows
//   m, B: 64 of the panel's rows p). wgmma and not mma.sync: it reads both
//   operands from shared memory without ldmatrix or registers, and is the
//   only route to the full rate. The panel is transposed to K-major as it
//   is staged (the slabs run along p), so both operands share one layout
//   and one descriptor form; each thread's 8-byte stores are rotated over
//   its 4 pixels to spread the banks.
// * Sums: the tensor cores truncate as they add, a bias toward zero that
//   grows with the number of products summed there. Each weight tile's 64
//   products go into a fresh partial that is added to the float32 sum with
//   round-to-nearest adds. In the split modes hi*hi has its partial and
//   sum, and the small passes (hi*lo, lo*hi [, lo*lo], about 2^-8 of it)
//   share a second partial and sum; the epilogue adds the two, hh + (hl +
//   lh [+ ll]) where JAX adds ((hh + hl) + lh) [+ ll]: the two orders
//   differ as any two float32 orders of the same sums do.
// * Epilogue per 64-row chunk, fused: a lane pair exchanges halves of its
//   accumulator fragment (rows r and r+8) so that each lane holds 4
//   consecutive pixels of one row, scales and rounds them (or adds the
//   row's bias [and applies swish [and swish']]), and stores 16 bytes (and
//   16 of swish'); its s (or bias)
//   was read into registers once, at the chunk's first tile, under the
//   chunk's products.
// * Work items (live slot, NP-pixel tile, group of M chunks): where live
//   slots x tiles fill less than the card (8x8 images, late iterations of
//   the backward solve), the M chunks are split into groups (powers of
//   two, at least TC_WGS chunks each, tc_groups) so that the items still
//   fill it; each group re-reads its slot's panel (from L2). Without an
//   active list every block takes one item. With one, the count is read on
//   the device, so the grid cannot shrink with it: nsm blocks at most walk
//   the live items in a loop (persistent).
// One block of 256 threads per SM (225 KB of shared memory): the blocks'
// panel loads and products interleave across SMs.
#pragma once

#include <stdint.h>

#include "conv_gemm.cuh"

namespace imnf {

constexpr int TC_KMAX = 512;                  // K the panel holds
constexpr int TC_BM = 64, TC_BK = 64;         // a weight tile: 64 rows x 128 bytes
constexpr int TC_STAGES = 6;                  // ring slots per warpgroup
constexpr int TC_AHEAD = TC_STAGES - 2;       // tiles loaded ahead of the products
constexpr int TC_WGS = 2, TC_THREADS = 128 * TC_WGS;
constexpr int TC_TILE_BYTES = TC_BM * TC_BK * 2;
// the panel's float32 slabs, staged in the rings' space before the products
constexpr int TC_SLAB_BYTES = 16384;
constexpr int TC_STAGING_BYTES = TC_WGS * TC_STAGES * TC_TILE_BYTES;

constexpr int TC_SMEM_MAX = 232448;  // the dynamic shared memory an SM grants a block

__host__ __device__ constexpr int tc_smem_bytes(int np, int panels) {
  // the panel(s), both rings, and slack to align the base to 1024 bytes
  return panels * np * TC_KMAX * 2 + TC_WGS * TC_STAGES * TC_TILE_BYTES + 1024;
}

// M-chunk groups per (slot, tile) item: double them while the items still
// fit one block per SM and each group keeps TC_WGS chunks
__host__ __device__ inline int tc_groups(int nmc, int live, int tiles, int nsm) {
  int groups = 1;
  while (2 * groups * TC_WGS <= nmc && 2 * groups * live * tiles <= nsm) groups *= 2;
  return groups;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows under
// the 128-byte swizzle (the tile 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 16 bytes (unused by this layout),
// 8-row groups 1024 bytes apart, layout type 1 (128B).
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// generic-proxy writes (st.shared, cp.async) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from touching accumulators across an in-flight wgmma
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64 x 64) = A(64 x 16) B(16 x 64) [+ D when acc_in], bf16 operands by
// descriptor, f32 sums.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc_in));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mma.sync operands (conv3x3_out_tc.cuh, conv3x3_in_tc.cuh): the four 8x8
// bf16 matrices at the lanes' row addresses
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// d(16 x 8) += a(16 x 16) b(16 x 8), bf16 operands, f32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 consecutive entries of a scale as loaded (16 or 8 bytes), and widened
template <typename ST> struct Vec4 { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };
__device__ __forceinline__ float4 ldv4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 ldv4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 u) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// Items (slot, tile, group), one a block or walked by a persistent grid
// (above); slot s belongs to net s / nb. Takes K <= TC_KMAX with K % 8 ==
// 0, HW % 4 == 0 and 16-byte aligned tensors (the launcher checks the
// shapes, the wrapper the pointers). PASSES 3 / 4 read W's lo half at wl0
// (same layout as w0) and keep a lo panel beside the hi one.
//
// Phase 1, the panel: float32 slabs of SK k-rows x NP pixels (16 KB)
// stream through the rings' space with cp.async, all but one of its slots
// ahead (zero-filled past K and HW; IN_DSWISH: a slab of inp and one of inh
// per slot, half as many slots); each thread transforms, rounds (and
// splits) 4 k x 4 pixels of a slab and stores them K-major into the
// panel(s). Phase 2, the products: each warpgroup walks its (M chunk, K
// tile) weight tiles (a hi and a lo tile a step in the split modes)
// through its ring; a chunk's scale (or bias) is loaded into registers at
// its first tile and used by its epilogue after its last.
template <int NP, typename ST, int EPI, int IN, int PASSES>
__global__ void __launch_bounds__(TC_THREADS, 1) tc_conv1x1_kernel(
    const __nv_bfloat16* __restrict__ w0, int M, int K,
    const float* __restrict__ inp, int HW, const ST* __restrict__ scale,
    float* __restrict__ out, int nb, const int* __restrict__ idx,
    const int* __restrict__ count, int B, int nsm,
    const float* __restrict__ inh, const float* __restrict__ beta_net,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ wl0,
    float beta_out, float* __restrict__ aux) {
  constexpr bool SPLIT = PASSES > 1;
  constexpr int NPANELS = SPLIT ? 2 : 1;        // hi [and lo] panels
  constexpr int PANEL_BYTES = NP * TC_KMAX * 2;
  constexpr int TPS = SPLIT ? 2 : 1;            // weight tiles a K step: hi [and lo]
  constexpr int SP = TC_STAGES / TPS;           // K steps a ring holds
  // steps loaded ahead of the products: the split modes' ring holds three,
  // so the step before's slots (its products done by the barrier) take the
  // next; mode bf16 keeps its four of six
  constexpr int AHEAD = SPLIT ? SP - 1 : TC_AHEAD;
  static_assert(PASSES == 1 || PASSES == 3 || PASSES == 4, "1, 3 or 4 passes");
  static_assert(tc_smem_bytes(NP, NPANELS) <= TC_SMEM_MAX, "the panels and rings fit an SM");
  extern __shared__ uint8_t tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t panel = (raw + 1023u) & ~1023u;  // [K / 64][NP rows][128 bytes] (hi)
  uint8_t* const base = tc_smem + (panel - raw);   // its generic address
  const uint32_t rings = panel + NPANELS * PANEL_BYTES;  // the lo panel sits at panel + PANEL_BYTES
  const int tid = threadIdx.x;
  // the warpgroup index, warp-uniform to the compiler: wgmma is issued on
  // a path it can prove converged
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), wt = tid % 128;
  const int nkt = (K + TC_BK - 1) / TC_BK, nmc = (M + TC_BM - 1) / TC_BM;
  const int tiles = (HW + NP - 1) / NP;
  const int live = count != nullptr ? min(*count, B) : B;
  const int groups = tc_groups(nmc, live, tiles, nsm);
  const int cpg = (nmc + groups - 1) / groups;  // chunks per group
  const int items = live * tiles * groups;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item % groups, slot = item / (groups * tiles);
    const int p0 = (item / groups) % tiles * NP, net = slot / nb;
    const int e = idx != nullptr ? idx[slot] : slot;
    const __nv_bfloat16* const w = w0 + (size_t)net * M * K;
    const __nv_bfloat16* const wl = SPLIT ? wl0 + (size_t)net * M * K : w;
    const int c0 = g * cpg, nloc = min(nmc, c0 + cpg) - c0;  // this group's chunks
    const size_t src_off = (size_t)slot * K * HW;

    // phase 1: the panel(s)
    {
      constexpr int SK = TC_SLAB_BYTES / (NP * 4);
      constexpr int BUFS = TC_STAGING_BYTES / TC_SLAB_BYTES;
      constexpr int NSRC = IN == IN_DSWISH ? 2 : 1;  // inp [and inh] per slot
      constexpr int SLOTS = BUFS / NSRC;
      const int ns = nkt * TC_BK / SK;
      auto load_slab = [&](int j) {
        if (j < ns) {
#pragma unroll
          for (int src = 0; src < NSRC; ++src) {
            const float* g = src == 0 ? inp : inh;
            const uint32_t buf = rings + ((j % SLOTS) * NSRC + src) * TC_SLAB_BYTES;
#pragma unroll
            for (int q = tid; q < TC_SLAB_BYTES / 16; q += TC_THREADS) {
              const int k = j * SK + q / (NP / 4), p = p0 + (q % (NP / 4)) * 4;
              const bool ok = k < K && p < HW;
              cp_async16(buf + q * 16, ok ? g + src_off + (size_t)k * HW + p : g, ok);
            }
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int j = 0; j < SLOTS - 1; ++j) load_slab(j);
      const int kq = tid / (NP / 4), pg = tid % (NP / 4);  // this thread's 4 k x 4 pixels
      const float beta = IN == IN_ID ? 0.f : beta_net[net];
      for (int j = 0; j < ns; ++j) {
        cp_async_wait<SLOTS - 2>();  // this thread's copies of slab j landed
        __syncthreads();             // everyone's; slab j - 1's buffer converted
        load_slab(j + SLOTS - 1);    // into slab j - 1's buffer
        const float* sl = reinterpret_cast<const float*>(
            base + NPANELS * PANEL_BYTES + (j % SLOTS) * NSRC * TC_SLAB_BYTES);
        float4 v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[r] = *reinterpret_cast<const float4*>(sl + (kq * 4 + r) * NP + pg * 4);
        // the input transform, once per element, rounded op by op as
        // conv_gemm.cuh's in_xform (zero-filled entries stay zero)
        if constexpr (IN == IN_SWISH) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            v[r] = make_float4(swish(v[r].x, beta), swish(v[r].y, beta),
                               swish(v[r].z, beta), swish(v[r].w, beta));
        }
        if constexpr (IN == IN_DSWISH) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 h = *reinterpret_cast<const float4*>(
                sl + TC_SLAB_BYTES / 4 + (kq * 4 + r) * NP + pg * 4);
            v[r] = make_float4(__fmul_rn(v[r].x, dswish(h.x, beta)),
                               __fmul_rn(v[r].y, dswish(h.y, beta)),
                               __fmul_rn(v[r].z, dswish(h.z, beta)),
                               __fmul_rn(v[r].w, dswish(h.w, beta)));
          }
        }
        // the split's lo half, v - rn(v) (exact in float32), as
        // conv_gemm.cuh's split(); the hi half is rn(v), packed below
        float4 lo[SPLIT ? 4 : 1];
        if constexpr (SPLIT) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            lo[r] = make_float4(__fsub_rn(v[r].x, bf16_round(v[r].x)),
                                __fsub_rn(v[r].y, bf16_round(v[r].y)),
                                __fsub_rn(v[r].z, bf16_round(v[r].z)),
                                __fsub_rn(v[r].w, bf16_round(v[r].w)));
        }
        uint2 px[4], pl[4];
#define TC_PACK(D, S, J, F) \
        D[J] = make_uint2(pack_bf16(S[0].F, S[1].F), pack_bf16(S[2].F, S[3].F))
        TC_PACK(px, v, 0, x); TC_PACK(px, v, 1, y); TC_PACK(px, v, 2, z); TC_PACK(px, v, 3, w);
        if constexpr (SPLIT) {
          TC_PACK(pl, lo, 0, x); TC_PACK(pl, lo, 1, y); TC_PACK(pl, lo, 2, z);
          TC_PACK(pl, lo, 3, w);
        }
#undef TC_PACK
        const int k = j * SK + kq * 4;
        uint8_t* tile = base + (k / TC_BK) * NP * 128 + ((k % 8) / 4) * 8;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // the value selected into a register, then one store: a store
          // under each branch on jr made the bf16 kernels 2-3% slower (H100)
          const int jr = (jj + (pg >> 1)) & 3;
          const uint2 val = jr == 0 ? px[0] : jr == 1 ? px[1] : jr == 2 ? px[2] : px[3];
          *reinterpret_cast<uint2*>(tile + sw128(pg * 4 + jr, (k % TC_BK) / 8)) = val;
          if constexpr (SPLIT) {
            const uint2 lv = jr == 0 ? pl[0] : jr == 1 ? pl[1] : jr == 2 ? pl[2] : pl[3];
            *reinterpret_cast<uint2*>(tile + PANEL_BYTES + sw128(pg * 4 + jr, (k % TC_BK) / 8)) =
                lv;
          }
        }
      }
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();  // the panels are whole; the staging space is the rings' again
    }

    // phase 2: this warpgroup's K steps t -> (M chunk c0 + wg + (t / nkt)
    // TC_WGS, K tile t % nkt), AHEAD ahead of the products
    const int chunks = nloc > wg ? (nloc - wg + TC_WGS - 1) / TC_WGS : 0;
    const int T = chunks * nkt;
    const uint32_t ring = rings + wg * TC_STAGES * TC_TILE_BYTES;
    auto load_w = [&](int t) {
      if (t < T) {
        const int m0 = (c0 + wg + (t / nkt) * TC_WGS) * TC_BM, k0 = (t % nkt) * TC_BK;
        const uint32_t dst = ring + (t % SP) * TPS * TC_TILE_BYTES;
#pragma unroll
        for (int q = 0; q < TPS; ++q) {
          const __nv_bfloat16* const src = q == 0 ? w : wl;
#pragma unroll
          for (int i = wt; i < TC_BM * 8; i += 128) {
            const int r = i / 8, c = i % 8, m = m0 + r, k = k0 + c * 8;
            const bool ok = m < M && k < K;
            cp_async16(dst + q * TC_TILE_BYTES + sw128(r, c),
                       ok ? src + (size_t)m * K + k : src, ok);
          }
        }
      }
      cp_async_commit();  // an empty group past the last step keeps the count
    };
#pragma unroll
    for (int t = 0; t < AHEAD; ++t) load_w(t);

    constexpr int NH = NP / 64, NJ = NP / 8;  // 64-pixel halves, 8-pixel groups
    static_assert(!SPLIT || NH == 1, "the split modes take NP 64");
    float acc[NH][32], part[NH][32];
    // the split modes' small passes (hi*lo, lo*hi [, lo*lo]): their sum
    // and per-tile partial
    float accl[SPLIT ? 32 : 1], partl[SPLIT ? 32 : 1];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (SPLIT ? 32 : 1); ++i) accl[i] = 0.f;
    const int warp = wt / 32, lane = wt % 32;
    const bool odd = lane & 1;
    const int cq = 2 * ((lane % 4) & ~1);  // the lane pair's first pixel in 8
    // the epilogue's operands of the current chunk: after the pair's exchange
    // a lane holds row r (even lane) or r + 8 (odd lane), pixels p0 + 8 j + cq
    // .. + 3
    typename Vec4<ST>::type sv[NJ];
    float bv = 0.f;  // EPI_AFFINE, EPI_SWISH[_LIN]: row r's bias
    int r = 0;
    size_t srow = 0, orow = 0;  // row r of scale (example e) and of out (slot)

    for (int t = 0; t < T; ++t) {
      cp_async_wait<AHEAD - 1>();  // this thread's copies of step t landed
      fence_async_smem();
      warpgroup_bar(1 + wg);  // everyone's copies of step t; step t - 1's products done
      load_w(t + AHEAD);      // into the slots of step t + AHEAD - SP
      const int kt = t % nkt;
      if (kt == 0) {  // a new chunk: its epilogue's scale, loaded under its products
        r = (c0 + wg + (t / nkt) * TC_WGS) * TC_BM + warp * 16 + lane / 4 + (odd ? 8 : 0);
        srow = ((size_t)e * M + r) * HW;
        orow = ((size_t)slot * M + r) * HW;
        if constexpr (EPI == EPI_AFFINE || EPI == EPI_SWISH || EPI == EPI_SWISH_LIN) {
          if (bias != nullptr && r < M) bv = __ldg(bias + (size_t)net * M + r);
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int p = p0 + 8 * j + cq;
            if (r < M && p < HW) sv[j] = ldv4(scale + srow + p);
          }
        }
      }
      // the step's products, each 64-pixel half (or pass group) into a
      // fresh partial, then added to its sum with round-to-nearest adds
      const uint32_t a = ring + (t % SP) * TPS * TC_TILE_BYTES, b = panel + kt * NP * 128;
      wgmma_fence();
      if constexpr (SPLIT) {
        const uint32_t al = a + TC_TILE_BYTES, bl = b + PANEL_BYTES;  // W_lo, X_lo
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk)  // hi * hi
          wgmma_n64(part[0], tc_desc(a + 32 * kk), tc_desc(b + 32 * kk), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk)  // hi * lo
          wgmma_n64(partl, tc_desc(a + 32 * kk), tc_desc(bl + 32 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk)  // lo * hi
          wgmma_n64(partl, tc_desc(al + 32 * kk), tc_desc(b + 32 * kk), 1);
        if constexpr (PASSES == 4) {
#pragma unroll
          for (int kk = 0; kk < TC_BK / 16; ++kk)  // lo * lo
            wgmma_n64(partl, tc_desc(al + 32 * kk), tc_desc(bl + 32 * kk), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        acc_fence(part[0]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[0][i] = __fadd_rn(acc[0][i], part[0][i]);
        wgmma_wait<0>();
        acc_fence(partl);
#pragma unroll
        for (int i = 0; i < 32; ++i) accl[i] = __fadd_rn(accl[i], partl[i]);
      } else {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
#pragma unroll
          for (int kk = 0; kk < TC_BK / 16; ++kk)
            wgmma_n64(part[h], tc_desc(a + 32 * kk), tc_desc(b + h * 64 * 128 + 32 * kk), kk);
          wgmma_commit();
        }
        if constexpr (NH == 2) {
          wgmma_wait<1>();
          acc_fence(part[0]);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[0][i] = __fadd_rn(acc[0][i], part[0][i]);
        }
        wgmma_wait<0>();
        acc_fence(part[NH - 1]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[NH - 1][i] = __fadd_rn(acc[NH - 1][i], part[NH - 1][i]);
      }
      if (kt != nkt - 1) continue;
      if constexpr (SPLIT) {  // hh + (hl + lh [+ ll])
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[0][i] = __fadd_rn(acc[0][i], accl[i]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int h = j / 8, i = 4 * (j % 8);  // compile-time after unrolling
        const float a0 = acc[h][i], a1 = acc[h][i + 1], b0 = acc[h][i + 2], b1 = acc[h][i + 3];
        const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        float4 o = odd ? make_float4(x0, x1, b0, b1) : make_float4(a0, a1, x0, x1);
        if constexpr (EPI == EPI_AFFINE) {
          if (bias != nullptr)
            o = make_float4(__fadd_rn(o.x, bv), __fadd_rn(o.y, bv), __fadd_rn(o.z, bv),
                            __fadd_rn(o.w, bv));
        } else if constexpr (EPI == EPI_SWISH) {
          o = make_float4(swish(__fadd_rn(o.x, bv), beta_out), swish(__fadd_rn(o.y, bv), beta_out),
                          swish(__fadd_rn(o.z, bv), beta_out), swish(__fadd_rn(o.w, bv), beta_out));
        } else if constexpr (EPI == EPI_SWISH_LIN) {
          const float4 h = make_float4(__fadd_rn(o.x, bv), __fadd_rn(o.y, bv), __fadd_rn(o.z, bv),
                                       __fadd_rn(o.w, bv));
          o = make_float4(swish(h.x, beta_out), swish(h.y, beta_out), swish(h.z, beta_out),
                          swish(h.w, beta_out));
          const int p = p0 + 8 * j + cq;
          if (r < M && p < HW)
            *reinterpret_cast<float4*>(aux + orow + p) =
                make_float4(dswish(h.x, beta_out), dswish(h.y, beta_out),
                            dswish(h.z, beta_out), dswish(h.w, beta_out));
        } else {
          const float4 sc = widen4(sv[j]);
          o = make_float4(__fmul_rn(o.x, sc.x), __fmul_rn(o.y, sc.y), __fmul_rn(o.z, sc.z),
                          __fmul_rn(o.w, sc.w));
          if (EPI == EPI_SCALE_RND)
            o = make_float4(bf16_round(o.x), bf16_round(o.y), bf16_round(o.z), bf16_round(o.w));
        }
        const int p = p0 + 8 * j + cq;
        if (r < M && p < HW) *reinterpret_cast<float4*>(out + orow + p) = o;
      }
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
#pragma unroll
      for (int i = 0; i < (SPLIT ? 32 : 1); ++i) accl[i] = 0.f;
    }
    cp_async_wait<0>();  // no copy outlives the item
    __syncthreads();     // both warpgroups done with the panels and the rings
  }
}

// static: internal linkage, so that each library that includes this
// header (estimator.cu, implicit_grad.cu and fused_solve.cu share
// instantiations) keeps its own `nsm` below. A function-local static of a
// template with external linkage is one object across every loaded library
// (a GNU-unique symbol): the second library would find it set and launch
// its own copy of the kernel without ever raising its shared-memory limit.
template <int NP, typename ST, int EPI, int IN, int PASSES>
static cudaError_t launch_tc_np(const __nv_bfloat16* w, int M, int K, const float* inp,
                                int B, int nb, int HW, const ST* scale, float* out,
                                const int* idx, const int* count, const float* inh,
                                const float* beta_net, const float* bias,
                                const __nv_bfloat16* w_lo, float beta_out, float* aux,
                                cudaStream_t s) {
  auto kernel = tc_conv1x1_kernel<NP, ST, EPI, IN, PASSES>;
  constexpr int bytes = tc_smem_bytes(NP, PASSES > 1 ? 2 : 1);
  static int nsm = 0;  // once per instantiation (one device)
  if (nsm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) {
      nsm = 0;
      return e;
    }
  }
  // every slot live: one block an item; an active list: nsm blocks at
  // most, enough for every item at the most groups the kernel may choose
  const int tiles = (HW + NP - 1) / NP, nmc = (M + TC_BM - 1) / TC_BM;
  const long long most = (long long)B * tiles * (nmc / TC_WGS > 1 ? nmc / TC_WGS : 1);
  const long long grid = count == nullptr ? (long long)B * tiles * tc_groups(nmc, B, tiles, nsm)
                                          : most < nsm ? most : nsm;
  kernel<<<(unsigned)grid, TC_THREADS, bytes, s>>>(
      w, M, K, inp, HW, scale, out, nb, idx, count, B, nsm, inh, beta_net, bias, w_lo,
      beta_out, aux);
  return cudaGetLastError();
}

// A 1x1 product on the tensor cores: B slots of `nets` nets (B / nets
// each), weights (nets, M, K) bf16, inp (B, K, HW) float32 (inh the same,
// for IN_DSWISH), out (B, M, HW) by slot; with count, slots past *count
// are not touched. EPI EPI_SCALE_RND (the chain) or EPI_SCALE (the
// backward solve) with IN_ID: scale (B, M, HW) indexed by idx[slot] (slot
// without idx). EPI_AFFINE (the final pair, the re-attachment): IN_ID |
// IN_SWISH | IN_DSWISH at slope beta_net[net], bias (nets, M) or nullptr,
// scale nullptr. EPI_SWISH (the forward solve): swish(acc + bias; beta_out);
// EPI_SWISH_LIN (the merged forward) also writes aux (B, M, HW) by slot,
// swish'(acc + bias; beta_out).
// PASSES 1 (mode bf16), or 3 / 4 (tf32 / tf32x: w the hi half, w_lo the lo
// half of W's bf16 split, same layout). cudaErrorInvalidValue for shapes
// the kernel does not take.
template <int EPI, int IN = IN_ID, int PASSES = 1, typename ST>
cudaError_t launch_tc_conv1x1(const __nv_bfloat16* w, int M, int K, const float* inp,
                              int B, int nets, int HW, const ST* scale, float* out,
                              cudaStream_t s, const int* idx = nullptr,
                              const int* count = nullptr, const float* inh = nullptr,
                              const float* beta_net = nullptr,
                              const float* bias = nullptr,
                              const __nv_bfloat16* w_lo = nullptr, float beta_out = 0.f,
                              float* aux = nullptr) {
  if (M < 1 || K < 8 || K > TC_KMAX || K % 8 || HW < 4 || HW % 4 || nets < 1 ||
      B % nets || (IN != IN_ID && beta_net == nullptr) ||
      (IN == IN_DSWISH && inh == nullptr) || (PASSES > 1 && w_lo == nullptr) ||
      (EPI == EPI_SWISH_LIN && aux == nullptr))
    return cudaErrorInvalidValue;
  if constexpr (PASSES > 1) {  // two panels: NP 64 at every size
    return launch_tc_np<64, ST, EPI, IN, PASSES>(w, M, K, inp, B, B / nets, HW, scale, out,
                                                 idx, count, inh, beta_net, bias, w_lo,
                                                 beta_out, aux, s);
  } else {
    if (HW <= 64)
      return launch_tc_np<64, ST, EPI, IN, 1>(w, M, K, inp, B, B / nets, HW, scale, out, idx,
                                              count, inh, beta_net, bias, nullptr, 0.f, aux, s);
    return launch_tc_np<128, ST, EPI, IN, 1>(w, M, K, inp, B, B / nets, HW, scale, out, idx,
                                             count, inh, beta_net, bias, nullptr, 0.f, aux, s);
  }
}

}  // namespace imnf
