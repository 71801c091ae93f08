// Hopper (sm_90a) kernel of the generic Broyden solver's rank-1 secant
// update and next direction.
//
// Replaces the TPU kernel implicit_normalizing_flows_tpu/ops/pallas_kernels.py
// ::fused_broyden_update (:69; _kernel :27), the per-iteration low-rank stage
// of ops/broyden.py::broyden (:271-312). Per example, with the live planes
// k < col of U^T = UTs[b] (K, D) and V^T = VTs[b] (K, D), both plane-major
// (plane k of U is column k of the JAX solver's (D, K) panel):
//   vT   = -dx + (dx^T U) V^T                          (rmatvec)
//   mdgx = -dgx + U (V^T dgx),  mgx = -gx + U (V^T gx)  (matvec)
//   u    = (dx - mdgx) / (vT . dgx)
//   u, vT with NaN and inf scrubbed to 0, and 0 where the example is inactive
//   U^T[col, :] = u,  V^T[col, :] = vT                  (in place)
//   update = -mgx - u (vT . gx)    (-matvec(U', V', gx) by the rank-1 identity)
//
// In place: the solver writes plane col = nstep - 1, and nstep never
// exceeds the threshold K before the loop ends (broyden.py:201-202, 272), so
// col never wraps: the planes k >= col are still zero and plane col is
// written once (the TPU kernel adds a masked outer product for the same
// reason). Only the live planes k < col are read.
//
// What bounds it on an H100: the bytes of the live planes, 2 B D col
// floats, beside three vectors read and two planes and the update written:
// at B 64, D 3072 about 1.9 / 6.1 / 15.0 us at col 1 / 10 / 29. At the
// tabular shapes (B 1000-4000, D 6-63) a call moves under 1.4 MB and costs
// its launch. One block an example left 68 of 132 SMs idle at B 64, its
// per-column sums ran one warp a column over U's strided columns, and it
// read the live planes four times. Two forms, chosen by the shape
// (ops/broyden_update.py update_plan):
// * the cluster form (D > 128): each example runs on a thread-block cluster
//   of up to 8 CTAs, CTA r owning a slice of float4 vectors (scalar loads
//   where D % 4 != 0) held in registers from the first load to the last
//   store. The planes are read once from DRAM, in batches of 8 / VPT planes
//   (a batch's loads in flight together): pass A sums <V_k, dgx>,
//   <V_k, gx>, <U_k, dx> for up to 64 planes a round, one fixed-order
//   reduction through cluster_reduce.cuh (the same bits in every CTA); pass
//   B adds the round's planes into U V^T dgx, U V^T gx and V (U^T dx), from
//   the registers while the round fits one batch, else from L2. Then
//   denom = <vT, dgx> (unscrubbed) and vg = <scrub(vT), gx> go through one
//   reduction, and u, the two planes and the update are written from the
//   registers. Two cluster barriers at col <= 64. Past 8 CTAs of 256
//   threads of 4 vectors (D > 32768) the stream kernel takes the same sums
//   in the same order with the per-element values kept in the output rows
//   between the passes.
// * the warp form (D <= 128, the tabular widths): a warp an example, four
//   examples a CTA, lane l holding elements l + 32 m. It reads each live
//   plane once and takes its three sums by the warp's butterfly right after
//   the load, so pass B follows pass A plane by plane with no shared memory
//   and no block barrier.
// Every sum is in a fixed order (ops/sum_order.py broyden_update_tiled
// repeats it): a thread's products from 0 in element order, the xor
// butterfly over the warp, the CTA's warps in order, the cluster's CTAs in
// rank order; over k in order from 0. Every add, product and quotient is
// rounded on its own (no FMA), float32 as JAX's Precision.HIGHEST, no
// tensor cores.

#include <cuda_runtime.h>
#include <math.h>

#include "cluster_reduce.cuh"

namespace {

using namespace imnf;

constexpr int MAX_THREADS = 256, MAX_WARPS = MAX_THREADS / 32, MAX_CLUSTER = 8;
constexpr int ROUND = 64, NSUM = 3 * ROUND;  // planes a reduction round, and their sums
constexpr int WARP_EXAMPLES = 4;              // the warp form's examples a CTA
constexpr int VPT_MAX = 4;  // float4 vectors a thread held in registers (else the stream kernel)

struct Args {
  float *U, *V;  // (B, K, D) each: plane k of example b at (b K + k) D
  const float *dx, *dgx, *gx;
  const unsigned char* active;
  float* update;
  int B, D, K, col;
  int slice;  // the cluster form's float4 vectors a CTA (the last may hold fewer)
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z),
                     __fsub_rn(a.w, b.w));
}
__device__ __forceinline__ float4 neg4(float4 a) { return make_float4(-a.x, -a.y, -a.z, -a.w); }
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s), __fmul_rn(a.w, s));
}
__device__ __forceinline__ float4 div4(float4 a, float s) {
  return make_float4(__fdiv_rn(a.x, s), __fdiv_rn(a.y, s), __fdiv_rn(a.z, s), __fdiv_rn(a.w, s));
}
__device__ __forceinline__ float scrub(float v, bool act) { return act && isfinite(v) ? v : 0.f; }
__device__ __forceinline__ float4 scrub4(float4 a, bool act) {
  return make_float4(scrub(a.x, act), scrub(a.y, act), scrub(a.z, act), scrub(a.w, act));
}

// vector j of a row of D floats: a float4 load where D % 4 == 0 (VEC4),
// else four scalar loads with the elements past D read as 0
template <bool VEC4>
__device__ __forceinline__ float4 ld(const float* row, int j, int D) {
  if constexpr (VEC4) {
    return reinterpret_cast<const float4*>(row)[j];
  } else {
    const int e = 4 * j;
    return make_float4(e < D ? row[e] : 0.f, e + 1 < D ? row[e + 1] : 0.f,
                       e + 2 < D ? row[e + 2] : 0.f, e + 3 < D ? row[e + 3] : 0.f);
  }
}
template <bool VEC4>
__device__ __forceinline__ void st(float* row, int j, int D, float4 v) {
  if constexpr (VEC4) {
    reinterpret_cast<float4*>(row)[j] = v;
  } else {
    const int e = 4 * j;
    if (e < D) row[e] = v.x;
    if (e + 1 < D) row[e + 1] = v.y;
    if (e + 2 < D) row[e + 2] = v.z;
    if (e + 3 < D) row[e + 3] = v.w;
  }
}

// grid (B cluster), clusters of `cluster` CTAs, one an example; CTA r owns
// vectors [r slice, (r + 1) slice) of the example's rows, thread t the
// vectors t + m T, m < VPT.
template <int VPT, bool VEC4>
__global__ void __launch_bounds__(MAX_THREADS) broyden_update_cluster_kernel(const Args a) {
  constexpr int KB = 8 / VPT;  // planes a batch, their loads in flight together
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned ncta = cluster.num_blocks(), rank = cluster.block_rank();
  cluster_arrive_relaxed();
  const size_t b = blockIdx.x / ncta;
  const int tid = threadIdx.x, T = blockDim.x, D = a.D;
  const int j0 = (int)rank * a.slice;
  const int nv = min(a.slice, (D + 3) / 4 - j0);  // this CTA's vectors (may be <= 0)
  const size_t row = b * D;
  const float* U0 = a.U + b * (size_t)a.K * D;
  const float* V0 = a.V + b * (size_t)a.K * D;

  __shared__ float part[NSUM * MAX_WARPS];
  __shared__ float slots[2][MAX_CLUSTER * NSUM];  // a round's, alternating
  __shared__ float red[NSUM];
  __shared__ float slots2[MAX_CLUSTER * 2];
  __shared__ float red2[2];

  float4 x[VPT], dg[VPT], g[VPT], uvd[VPT], uvg[VPT], vt[VPT];
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    const int j = tid + m * T;
    uvd[m] = uvg[m] = vt[m] = x[m] = dg[m] = g[m] = zero4();
    if (j < nv) {
      x[m] = ld<VEC4>(a.dx + row, j0 + j, D);
      dg[m] = ld<VEC4>(a.dgx + row, j0 + j, D);
      g[m] = ld<VEC4>(a.gx + row, j0 + j, D);
    }
  }

  // planes k0 .. k0 + KB - 1 below kend of this thread's vectors into ub / vb
  float4 ub[KB][VPT], vb[KB][VPT];
  auto load_batch = [&](int k0, int kend) {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int k = k0 + kk;
      if (k >= kend) break;
#pragma unroll
      for (int m = 0; m < VPT; ++m) {
        const int j = tid + m * T;
        if (j >= nv) continue;
        ub[kk][m] = ld<VEC4>(U0 + (size_t)k * D, j0 + j, D);
        vb[kk][m] = ld<VEC4>(V0 + (size_t)k * D, j0 + j, D);
      }
    }
  };

  for (int r0 = 0, ri = 0; r0 < a.col; r0 += ROUND, ++ri) {
    const int rend = min(r0 + ROUND, a.col);
    // pass A: the round's 3 (rend - r0) sums over D
    for (int k0 = r0; k0 < rend; k0 += KB) {
      load_batch(k0, rend);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const int k = k0 + kk;
        if (k >= rend) break;
        float pa = 0.f, pb = 0.f, pc = 0.f;
#pragma unroll
        for (int m = 0; m < VPT; ++m) {
          if (tid + m * T >= nv) continue;
          pa = dot4(pa, vb[kk][m], dg[m]);
          pb = dot4(pb, vb[kk][m], g[m]);
          pc = dot4(pc, ub[kk][m], x[m]);
        }
        stage(pa, 3 * (k - r0), part);
        stage(pb, 3 * (k - r0) + 1, part);
        stage(pc, 3 * (k - r0) + 2, part);
      }
    }
    // the round's planes stay in the registers while they fit one batch;
    // else pass B's first batch is loaded again, in flight across the
    // reduction
    const bool kept = rend - r0 <= KB;
    if (!kept) load_batch(r0, rend);
    if (ri == 0) cluster_wait();
    cluster_reduce(part, slots[ri & 1], red, 3 * (rend - r0), NSUM, rank, ncta);
    // pass B: U_k <V_k, dgx>, U_k <V_k, gx>, V_k <U_k, dx> added in k order
    for (int k0 = r0; k0 < rend; k0 += KB) {
      if (!kept && k0 > r0) load_batch(k0, rend);  // from L2
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const int k = k0 + kk;
        if (k >= rend) break;
        const float ra = red[3 * (k - r0)], rb = red[3 * (k - r0) + 1],
                    rc = red[3 * (k - r0) + 2];
#pragma unroll
        for (int m = 0; m < VPT; ++m) {
          uvd[m] = add4(uvd[m], scale4(ub[kk][m], ra));
          uvg[m] = add4(uvg[m], scale4(ub[kk][m], rb));
          vt[m] = add4(vt[m], scale4(vb[kk][m], rc));
        }
      }
    }
  }
  if (a.col == 0) cluster_wait();

  // denom = <vT, dgx> before the scrub and vg = <scrub(vT), gx>, one reduction
  const bool act = a.active[b] != 0;
  float pd = 0.f, pe = 0.f;
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    if (tid + m * T >= nv) continue;
    const float4 v = add4(neg4(x[m]), vt[m]);
    pd = dot4(pd, v, dg[m]);
    vt[m] = scrub4(v, act);
    pe = dot4(pe, vt[m], g[m]);
  }
  stage(pd, 0, part);
  stage(pe, 1, part);
  cluster_reduce(part, slots2, red2, 2, 2, rank, ncta);
  const float denom = red2[0], vg = red2[1];

  // u = (dx - (-dgx + U V^T dgx)) / denom into plane col with scrub(vT);
  // update = -(-gx + U V^T gx) - u vg
  float* u_new = a.U + (b * a.K + a.col) * (size_t)D;
  float* v_new = a.V + (b * a.K + a.col) * (size_t)D;
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    const int j = tid + m * T;
    if (j >= nv) continue;
    const float4 u = scrub4(div4(sub4(x[m], add4(neg4(dg[m]), uvd[m])), denom), act);
    st<VEC4>(u_new, j0 + j, D, u);
    st<VEC4>(v_new, j0 + j, D, vt[m]);
    st<VEC4>(a.update + row, j0 + j, D, sub4(neg4(add4(neg4(g[m]), uvg[m])), scale4(u, vg)));
  }
}

// The cluster form past the registers (more than VPT_MAX vectors a
// thread): each thread walks its vectors t + m T in m order in every pass,
// reading dx, dgx and gx again where a pass needs them, and keeps
// U V^T dgx, U V^T gx and V (U^T dx) between the passes in plane col of
// U^T, the update and plane col of V^T, where the last pass writes u, the
// update and scrub(vT). The same sums in the same order, so the same bits,
// as broyden_update_cluster_kernel<VPT> would give.
template <bool VEC4>
__global__ void __launch_bounds__(MAX_THREADS) broyden_update_stream_kernel(const Args a) {
  constexpr int KB = 8;  // planes a batch
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned ncta = cluster.num_blocks(), rank = cluster.block_rank();
  cluster_arrive_relaxed();
  const size_t b = blockIdx.x / ncta;
  const int tid = threadIdx.x, T = blockDim.x, D = a.D;
  const int j0 = (int)rank * a.slice;
  const int nv = min(a.slice, (D + 3) / 4 - j0);
  const size_t row = b * D;
  const float* U0 = a.U + b * (size_t)a.K * D;
  const float* V0 = a.V + b * (size_t)a.K * D;
  float* u_new = a.U + (b * a.K + a.col) * (size_t)D;
  float* v_new = a.V + (b * a.K + a.col) * (size_t)D;
  float* upd = a.update + row;

  __shared__ float part[NSUM * MAX_WARPS];
  __shared__ float slots[2][MAX_CLUSTER * NSUM];
  __shared__ float red[NSUM];
  __shared__ float slots2[MAX_CLUSTER * 2];
  __shared__ float red2[2];

  for (int r0 = 0, ri = 0; r0 < a.col; r0 += ROUND, ++ri) {
    const int rend = min(r0 + ROUND, a.col);
    for (int k0 = r0; k0 < rend; k0 += KB) {
      const int nk = min(KB, rend - k0);
      float pa[KB], pb[KB], pc[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) pa[kk] = pb[kk] = pc[kk] = 0.f;
      for (int j = tid; j < nv; j += T) {
        const float4 x = ld<VEC4>(a.dx + row, j0 + j, D), dg = ld<VEC4>(a.dgx + row, j0 + j, D),
                     g = ld<VEC4>(a.gx + row, j0 + j, D);
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          if (kk >= nk) break;
          const float4 ub = ld<VEC4>(U0 + (size_t)(k0 + kk) * D, j0 + j, D),
                       vb = ld<VEC4>(V0 + (size_t)(k0 + kk) * D, j0 + j, D);
          pa[kk] = dot4(pa[kk], vb, dg);
          pb[kk] = dot4(pb[kk], vb, g);
          pc[kk] = dot4(pc[kk], ub, x);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        if (kk >= nk) break;
        stage(pa[kk], 3 * (k0 + kk - r0), part);
        stage(pb[kk], 3 * (k0 + kk - r0) + 1, part);
        stage(pc[kk], 3 * (k0 + kk - r0) + 2, part);
      }
    }
    if (ri == 0) cluster_wait();
    cluster_reduce(part, slots[ri & 1], red, 3 * (rend - r0), NSUM, rank, ncta);
    for (int j = tid; j < nv; j += T) {
      float4 ud = zero4(), ug = zero4(), vt = zero4();
      if (r0 > 0) {
        ud = ld<VEC4>(u_new, j0 + j, D);
        ug = ld<VEC4>(upd, j0 + j, D);
        vt = ld<VEC4>(v_new, j0 + j, D);
      }
      for (int k = r0; k < rend; ++k) {
        const float4 ub = ld<VEC4>(U0 + (size_t)k * D, j0 + j, D),
                     vb = ld<VEC4>(V0 + (size_t)k * D, j0 + j, D);
        ud = add4(ud, scale4(ub, red[3 * (k - r0)]));
        ug = add4(ug, scale4(ub, red[3 * (k - r0) + 1]));
        vt = add4(vt, scale4(vb, red[3 * (k - r0) + 2]));
      }
      st<VEC4>(u_new, j0 + j, D, ud);
      st<VEC4>(upd, j0 + j, D, ug);
      st<VEC4>(v_new, j0 + j, D, vt);
    }
  }
  if (a.col == 0) cluster_wait();

  const bool act = a.active[b] != 0;
  float pd = 0.f, pe = 0.f;
  for (int j = tid; j < nv; j += T) {
    const float4 x = ld<VEC4>(a.dx + row, j0 + j, D), dg = ld<VEC4>(a.dgx + row, j0 + j, D),
                 g = ld<VEC4>(a.gx + row, j0 + j, D);
    const float4 v = add4(neg4(x), a.col ? ld<VEC4>(v_new, j0 + j, D) : zero4());
    pd = dot4(pd, v, dg);
    const float4 vs = scrub4(v, act);
    pe = dot4(pe, vs, g);
    st<VEC4>(v_new, j0 + j, D, vs);
  }
  stage(pd, 0, part);
  stage(pe, 1, part);
  cluster_reduce(part, slots2, red2, 2, 2, rank, ncta);
  const float denom = red2[0], vg = red2[1];
  for (int j = tid; j < nv; j += T) {
    const float4 x = ld<VEC4>(a.dx + row, j0 + j, D), dg = ld<VEC4>(a.dgx + row, j0 + j, D),
                 g = ld<VEC4>(a.gx + row, j0 + j, D);
    const float4 ud = a.col ? ld<VEC4>(u_new, j0 + j, D) : zero4(),
                 ug = a.col ? ld<VEC4>(upd, j0 + j, D) : zero4();
    const float4 u = scrub4(div4(sub4(x, add4(neg4(dg), ud)), denom), act);
    st<VEC4>(u_new, j0 + j, D, u);
    st<VEC4>(upd, j0 + j, D, sub4(neg4(add4(neg4(g), ug)), scale4(u, vg)));
  }
}

// grid (ceil(B / WARP_EXAMPLES)), WARP_EXAMPLES warps a CTA, warp w of CTA
// c the example c WARP_EXAMPLES + w; lane l the elements l + 32 m, m < EPL.
template <int EPL>
__global__ void __launch_bounds__(32 * WARP_EXAMPLES) broyden_update_warp_kernel(const Args a) {
  constexpr int KB = 8;  // planes a batch, their loads in flight together
  const int lane = threadIdx.x & 31, D = a.D;
  const size_t b = (size_t)blockIdx.x * WARP_EXAMPLES + (threadIdx.x >> 5);
  if (b >= (size_t)a.B) return;  // the whole warp
  const size_t row = b * D;
  const float* U0 = a.U + b * (size_t)a.K * D;
  const float* V0 = a.V + b * (size_t)a.K * D;

  float x[EPL], dg[EPL], g[EPL], uvd[EPL], uvg[EPL], vt[EPL];
#pragma unroll
  for (int m = 0; m < EPL; ++m) {
    const int d = lane + 32 * m;
    const bool in = d < D;
    x[m] = in ? a.dx[row + d] : 0.f;
    dg[m] = in ? a.dgx[row + d] : 0.f;
    g[m] = in ? a.gx[row + d] : 0.f;
    uvd[m] = uvg[m] = vt[m] = 0.f;
  }
  for (int k0 = 0; k0 < a.col; k0 += KB) {
    float ub[KB][EPL], vb[KB][EPL];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int k = k0 + kk;
#pragma unroll
      for (int m = 0; m < EPL; ++m) {
        const int d = lane + 32 * m;
        const bool in = k < a.col && d < D;
        ub[kk][m] = in ? U0[(size_t)k * D + d] : 0.f;
        vb[kk][m] = in ? V0[(size_t)k * D + d] : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      if (k0 + kk >= a.col) break;
      float pa = 0.f, pb = 0.f, pc = 0.f;
#pragma unroll
      for (int m = 0; m < EPL; ++m) {
        pa = __fadd_rn(pa, __fmul_rn(vb[kk][m], dg[m]));
        pb = __fadd_rn(pb, __fmul_rn(vb[kk][m], g[m]));
        pc = __fadd_rn(pc, __fmul_rn(ub[kk][m], x[m]));
      }
      pa = warp_allsum(pa);
      pb = warp_allsum(pb);
      pc = warp_allsum(pc);
#pragma unroll
      for (int m = 0; m < EPL; ++m) {
        uvd[m] = __fadd_rn(uvd[m], __fmul_rn(ub[kk][m], pa));
        uvg[m] = __fadd_rn(uvg[m], __fmul_rn(ub[kk][m], pb));
        vt[m] = __fadd_rn(vt[m], __fmul_rn(vb[kk][m], pc));
      }
    }
  }

  const bool act = a.active[b] != 0;
  float pd = 0.f, pe = 0.f;
#pragma unroll
  for (int m = 0; m < EPL; ++m) {
    const float v = __fadd_rn(-x[m], vt[m]);
    pd = __fadd_rn(pd, __fmul_rn(v, dg[m]));
    vt[m] = scrub(v, act);
    pe = __fadd_rn(pe, __fmul_rn(vt[m], g[m]));
  }
  const float denom = warp_allsum(pd), vg = warp_allsum(pe);
  float* u_new = a.U + (b * a.K + a.col) * (size_t)D;
  float* v_new = a.V + (b * a.K + a.col) * (size_t)D;
#pragma unroll
  for (int m = 0; m < EPL; ++m) {
    const int d = lane + 32 * m;
    if (d >= D) continue;
    const float u =
        scrub(__fdiv_rn(__fsub_rn(x[m], __fadd_rn(-dg[m], uvd[m])), denom), act);
    u_new[d] = u;
    v_new[d] = vt[m];
    a.update[row + d] = __fsub_rn(-__fadd_rn(-g[m], uvg[m]), __fmul_rn(u, vg));
  }
}

template <int VPT, bool VEC4>
cudaError_t launch_cluster(const Args& a, int ncta, int threads, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * ncta);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if constexpr (VPT == 0)
    err = cudaLaunchKernelEx(&cfg, broyden_update_stream_kernel<VEC4>, a);
  else
    err = cudaLaunchKernelEx(&cfg, broyden_update_cluster_kernel<VPT, VEC4>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int VPT>
cudaError_t launch_cluster(const Args& a, int ncta, int threads, bool vec4, cudaStream_t s) {
  return vec4 ? launch_cluster<VPT, true>(a, ncta, threads, s)
              : launch_cluster<VPT, false>(a, ncta, threads, s);
}

template <int EPL>
cudaError_t launch_warp(const Args& a, cudaStream_t s) {
  const int grid = (a.B + WARP_EXAMPLES - 1) / WARP_EXAMPLES;
  broyden_update_warp_kernel<EPL><<<grid, 32 * WARP_EXAMPLES, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// UTs, VTs (B, K, D): updated in place at plane col. dx, dgx, gx, update
// (B, D) float32; active (B,) bool. 0 <= col < K. The plan of
// ops/broyden_update.py update_plan: cluster 0, the warp form with vpt
// elements a lane (1, 2 or 4; D <= 32 vpt); else the cluster form,
// `cluster` CTAs an example of `threads` threads, `slice` float4 vectors a
// CTA, vpt (1, 2 or 4; more than 4: the stream kernel) a thread, float4
// loads where vec4 (D % 4 == 0 and every row 16-byte aligned). Launches on
// `stream`, does not synchronise, returns the launch's error (0 on
// success).
int imnf_broyden_update(float* UTs, float* VTs, const float* dx, const float* dgx,
                        const float* gx, const unsigned char* active, int B, int D, int K,
                        int col, float* update, int cluster, int slice, int threads, int vpt,
                        int vec4, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (D <= 0 || col < 0 || col >= K) return (int)cudaErrorInvalidValue;
  const Args a{UTs, VTs, dx, dgx, gx, active, update, B, D, K, col, slice};
  if (cluster == 0) {
    if (D > 32 * vpt) return (int)cudaErrorInvalidValue;
    switch (vpt) {
      case 1: return (int)launch_warp<1>(a, stream);
      case 2: return (int)launch_warp<2>(a, stream);
      case 4: return (int)launch_warp<4>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (cluster < 1 || cluster > MAX_CLUSTER || (long long)cluster * slice * 4 < D ||
      threads < 32 || threads > MAX_THREADS || threads % 32 || vpt * threads < slice ||
      (vec4 && D % 4))
    return (int)cudaErrorInvalidValue;
  switch (vpt) {
    case 1: return (int)launch_cluster<1>(a, cluster, threads, vec4, stream);
    case 2: return (int)launch_cluster<2>(a, cluster, threads, vec4, stream);
    case 4: return (int)launch_cluster<4>(a, cluster, threads, vec4, stream);
  }
  if (vpt > VPT_MAX) return (int)launch_cluster<0>(a, cluster, threads, vec4, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
