// Hopper (sm_90a) kernel of the Broyden update that both fused solves run
// once an iteration: broyden_step (ops/fused_solve.py), linked into
// fused_solve.cu's library (LINKED in ops/cuda_build.py), its own
// translation unit so that a change here moves no conv kernel's SASS.
//
// Replaces the secant part of the TPU kernels
// implicit_normalizing_flows_tpu/ops/fused_solve.py::fused_broyden_solve
// (_broyden_in_kernel :538, its semantics at :19-25) and
// ::fused_backward_solve (:930). For every live example of an active list:
// the 3 nk contractions with the written U/V planes, the best iterate, the
// protective break at 1e6x, the stall exit, the Newton first step, plane nk
// (NaN scrub), the next update and trial point, and the example appended to
// the next active list; its phase argument also runs the solve's
// initialisation (PHASE_INIT) and the precision ladder's re-arm
// (PHASE_REARM).
//
// What bounds it on an H100: the bytes of the planes and vectors it moves,
// 4 B D (2 nk + 12) an iteration for B live examples (about 7.5 us at B 64,
// D 3072, nk 10). One 512-thread block an example left 68 of 132 SMs idle
// at B 64, and more late in a solve, and ran three block-wide reductions in
// series. Design: each live example runs on a thread-block cluster of 4 or
// 8 CTAs (ops/fused_solve.py broyden_plan), CTA r owning D / cluster
// elements as float4 vectors held in registers from pass A to the end; the
// sums go through cluster_reduce.cuh (fixed order, the same bits in every
// CTA: ops/sum_order.py broyden_step_tiled repeats them). Pass B sums both
// denom = <vT, dg> (vT unscrubbed) and <vT scrubbed, g_new> in one cluster
// reduction, and passes C and D run as one sweep, so a step takes two
// cluster barriers. The planes are loaded in batches of 8 / VPT (a batch's
// loads in flight together), and while nk fits one batch pass B takes them
// from the registers; past it from L2 again, the first batch's loads started
// before the cluster reduction. (Keeping a CTA's slice of the planes in
// shared memory from pass A instead, as many as left the grid's CTAs
// resident, was slower at every nstep on an H100: PERF.md row 1d.)
// Every other value is rounded op by op as _broyden_step_plain rounds it.
// Under the line search (ops/line_search.py) the step taken is
// delta_z = ZN - Z (the search may have shortened it; DZ_TAKEN), else UPD;
// the instantiations without it are those from before the search.
// Rank 0 of a cluster writes the example's scalar state and appends it;
// every CTA reads that state before the first cluster barrier, and rank 0
// writes it after.

#include <cuda_runtime.h>

#include "cluster_reduce.cuh"

namespace {

using namespace imnf;

constexpr int KMAX = 64, NVAL = 3 * KMAX + 1, MAX_THREADS = 256,
              MAX_WARPS = MAX_THREADS / 32, MAX_CLUSTER = 8;
enum { PHASE_INIT = 0, PHASE_STEP = 1, PHASE_REARM = 2 };
// per-example int state: [nstep, best_step, prot, done]; float state:
// [best_obj, best_snap, init_obj]
enum { I_NSTEP = 0, I_BEST_STEP = 1, I_PROT = 2, I_DONE = 3, NI = 4 };
enum { F_BEST_OBJ = 0, F_BEST_SNAP = 1, F_INIT_OBJ = 2, NF = 3 };

struct StepArgs {
  int phase;
  const int* idx_in;
  const int* cnt_in;
  int* idx_out;
  int* cnt_out;
  float *Z, *G, *UPD, *ZN;
  const float* GN;
  float *BZ, *BG, *U, *V;
  int* istate;
  float* fstate;
  int D, K, slice;
  float eps;
  int cap, patience;
  float rtol, guard_eps;
  int newton;
};

__device__ __forceinline__ float4 ld4(const float* p, int j) {
  return reinterpret_cast<const float4*>(p)[j];
}
__device__ __forceinline__ void st4(float* p, int j, float4 v) {
  reinterpret_cast<float4*>(p)[j] = v;
}
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
__device__ __forceinline__ float scrub(float v) { return isfinite(v) ? v : 0.f; }
__device__ __forceinline__ float4 scrub4(float4 a) {
  return make_float4(scrub(a.x), scrub(a.y), scrub(a.z), scrub(a.w));
}

template <int VPT, bool DZ_TAKEN>
__global__ void __launch_bounds__(MAX_THREADS) broyden_cluster_kernel(const StepArgs a) {
  // planes a batch: loaded together (their loads in flight at once), and
  // kept in registers for pass B while nk <= KB
  constexpr int KB = 8 / VPT;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned ncta = cluster.num_blocks(), rank = cluster.block_rank();
  const int slot = blockIdx.x / ncta;
  const int count = *a.cnt_in, ei = a.idx_in[slot];  // both loads in flight
  if (slot >= count) return;  // the whole cluster: one slot, one count
  cluster_arrive_relaxed();
  const size_t e = (size_t)ei;
  const int tid = threadIdx.x, T = blockDim.x, nv = a.slice / 4;
  const size_t row = e * a.D + (size_t)rank * a.slice;  // this CTA's slice of a row
  const float* U0 = a.U + e * (size_t)a.K * a.D + (size_t)rank * a.slice;
  const float* V0 = a.V + e * (size_t)a.K * a.D + (size_t)rank * a.slice;
  int* ist = a.istate + e * NI;
  float* fst = a.fstate + e * NF;

  __shared__ float part[NVAL * MAX_WARPS];
  __shared__ float slots[MAX_CLUSTER * NVAL];
  __shared__ float red[NVAL];
  __shared__ float slots2[MAX_CLUSTER * 2];
  __shared__ float red2[2];

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
        ub[kk][m] = ld4(U0 + (size_t)k * a.D, j);
        vb[kk][m] = ld4(V0 + (size_t)k * a.D, j);
      }
    }
  };

  // the example's scalar state, read by every CTA before the first cluster
  // barrier (rank 0 writes it after)
  const int nk = ist[I_NSTEP], best_step0 = ist[I_BEST_STEP], prot0 = ist[I_PROT];
  const float best_obj0 = fst[F_BEST_OBJ], best_snap0 = fst[F_BEST_SNAP],
              init_obj0 = fst[F_INIT_OBJ];

  float4 gn[VPT];
  float ss = 0.f;
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    const int j = tid + m * T;
    if (j < nv) {
      gn[m] = ld4(a.GN + row, j);
      ss = dot4(ss, gn[m], gn[m]);
    }
  }
  stage(ss, 0, part);

  if (a.phase == PHASE_INIT) {
    cluster_wait();
    cluster_reduce(part, slots, red, 1, NVAL, rank, ncta);
    const float obj = sqrtf(red[0]);
#pragma unroll
    for (int m = 0; m < VPT; ++m) {
      const int j = tid + m * T;
      if (j >= nv) continue;
      const float4 zn = ld4(a.ZN + row, j), u = a.newton ? gn[m] : neg4(gn[m]);
      st4(a.Z + row, j, zn);
      st4(a.G + row, j, gn[m]);
      st4(a.BZ + row, j, zn);
      st4(a.BG + row, j, gn[m]);
      st4(a.UPD + row, j, u);
      st4(a.ZN + row, j, add4(zn, u));
    }
    if (rank == 0 && tid == 0) {
      const int done = obj < a.eps;
      ist[I_NSTEP] = 0; ist[I_BEST_STEP] = 0; ist[I_PROT] = 0; ist[I_DONE] = done;
      fst[F_BEST_OBJ] = obj; fst[F_BEST_SNAP] = obj; fst[F_INIT_OBJ] = obj;
      if (!done && 0 < a.cap) a.idx_out[atomicAdd(a.cnt_out, 1)] = (int)e;
    }
    return;
  }

  if (a.phase == PHASE_REARM) {
    // continue from the best iterate with the residual g_b re-evaluated at
    // the stage precision; update = g_b - sum_k U_k <V_k, g_b>
    for (int k0 = 0; k0 < nk; k0 += KB) {
      load_batch(k0, nk);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        if (k0 + kk >= nk) break;
        float pb = 0.f;
#pragma unroll
        for (int m = 0; m < VPT; ++m)
          if (tid + m * T < nv) pb = dot4(pb, vb[kk][m], gn[m]);
        stage(pb, k0 + kk + 1, part);
      }
    }
    cluster_wait();
    cluster_reduce(part, slots, red, nk + 1, NVAL, rank, ncta);
    const float obj = sqrtf(red[0]);
    float4 uvg[VPT];
#pragma unroll
    for (int m = 0; m < VPT; ++m) uvg[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < nk; k0 += KB) {
      if (nk > KB) load_batch(k0, nk);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        if (k0 + kk >= nk) break;
#pragma unroll
        for (int m = 0; m < VPT; ++m) uvg[m] = add4(uvg[m], scale4(ub[kk][m], red[k0 + kk + 1]));
      }
    }
#pragma unroll
    for (int m = 0; m < VPT; ++m) {
      const int j = tid + m * T;
      if (j >= nv) continue;
      const float4 bz = ld4(a.BZ + row, j), u = sub4(gn[m], uvg[m]);
      st4(a.Z + row, j, bz);
      st4(a.G + row, j, gn[m]);
      st4(a.BG + row, j, gn[m]);
      st4(a.UPD + row, j, u);
      st4(a.ZN + row, j, add4(bz, u));
    }
    if (rank == 0 && tid == 0) {
      const int done = prot0 || obj < a.eps;
      ist[I_DONE] = done;
      fst[F_BEST_OBJ] = obj; fst[F_BEST_SNAP] = obj;
      if (!done && nk < a.cap) a.idx_out[atomicAdd(a.cnt_out, 1)] = (int)e;
    }
    return;
  }

  // PHASE_STEP: z_new = zn, g_new = gn, delta_z = upd (ZN - Z under the
  // line search), delta_g = gn - g.
  // Pass A: ||g_new||^2 and the 3 nk contractions <V_k, dg>, <V_k, g_new>,
  // <U_k, dz>.
  float4 dz[VPT], dg[VPT], zn[VPT];
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    const int j = tid + m * T;
    if (j < nv) {
      if constexpr (DZ_TAKEN)
        dz[m] = sub4(ld4(a.ZN + row, j), ld4(a.Z + row, j));
      else
        dz[m] = ld4(a.UPD + row, j);
      dg[m] = sub4(gn[m], ld4(a.G + row, j));
      zn[m] = ld4(a.ZN + row, j);
    }
  }
  for (int k0 = 0; k0 < nk; k0 += KB) {
    load_batch(k0, nk);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int k = k0 + kk;
      if (k >= nk) break;
      float pa = 0.f, pb = 0.f, pc = 0.f;
#pragma unroll
      for (int m = 0; m < VPT; ++m) {
        if (tid + m * T >= nv) continue;
        pa = dot4(pa, vb[kk][m], dg[m]);
        pb = dot4(pb, vb[kk][m], gn[m]);
        pc = dot4(pc, ub[kk][m], dz[m]);
      }
      stage(pa, 1 + 3 * k, part);
      stage(pb, 2 + 3 * k, part);
      stage(pc, 3 + 3 * k, part);
    }
  }
  // pass B's first batch, where pass A left another one in the registers:
  // its loads in flight across the reduction
  if (nk > KB) load_batch(0, nk);
  cluster_wait();
  cluster_reduce(part, slots, red, 3 * nk + 1, NVAL, rank, ncta);
  const float obj = sqrtf(red[0]);
  const int nstep = nk + 1;
  const int improved = obj < best_obj0;
  const float best_obj = improved ? obj : best_obj0;
  const int bad = !isfinite(obj) || obj > init_obj0 * 1e6f;
  int done = bad || obj < a.eps;
  float best_snap = best_snap0;
  if (a.patience > 0) {
    const int at_check = (nstep % a.patience) == 0;
    int stalled = at_check && best_obj > best_snap0 * (1.0f - a.rtol);
    if (a.guard_eps > 0.f) stalled = stalled && best_obj < a.guard_eps;
    done = done || stalled;
    if (at_check) best_snap = best_obj;
  }
  if (rank == 0 && tid == 0) {
    ist[I_NSTEP] = nstep; ist[I_BEST_STEP] = improved ? nstep : best_step0;
    ist[I_PROT] = prot0 || bad; ist[I_DONE] = done;
    fst[F_BEST_OBJ] = best_obj; fst[F_BEST_SNAP] = best_snap;
    if (!done && nstep < a.cap) a.idx_out[atomicAdd(a.cnt_out, 1)] = (int)e;
  }

  // Pass B: UVd = sum_k U_k <V_k, dg>, UVg = sum_k U_k <V_k, g_new>,
  // vT = -dz + sum_k V_k <U_k, dz> (k in order, from 0); then
  // denom = <vT, dg> and vg = <scrub(vT), g_new> in one cluster reduction.
  float4 uvd[VPT], uvg[VPT], vt[VPT];
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    uvd[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    uvg[m] = uvd[m];
    vt[m] = uvd[m];
  }
  for (int k0 = 0; k0 < nk; k0 += KB) {
    if (nk > KB && k0 > 0) load_batch(k0, nk);  // the planes again, from L2
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int k = k0 + kk;
      if (k >= nk) break;
      const float ra = red[1 + 3 * k], rb = red[2 + 3 * k], rc = red[3 + 3 * k];
#pragma unroll
      for (int m = 0; m < VPT; ++m) {
        uvd[m] = add4(uvd[m], scale4(ub[kk][m], ra));
        uvg[m] = add4(uvg[m], scale4(ub[kk][m], rb));
        vt[m] = add4(vt[m], scale4(vb[kk][m], rc));
      }
    }
  }
  float pd = 0.f, pe = 0.f;
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    if (tid + m * T >= nv) continue;
    const float4 v = add4(neg4(dz[m]), vt[m]);
    pd = dot4(pd, v, dg[m]);
    vt[m] = scrub4(v);
    pe = dot4(pe, vt[m], gn[m]);
  }
  stage(pd, 0, part);
  stage(pe, 1, part);
  cluster_reduce(part, slots2, red2, 2, 2, rank, ncta);
  const float denom = red2[0], vg = red2[1];

  // Passes C and D: u = (dz - (-dg + UVd)) / denom, scrubbed, into plane
  // nk with scrub(vT); update = -(-g_new + UVg) - u vg; the next trial point.
  float* u_new = a.U + e * (size_t)a.K * a.D + (size_t)nk * a.D + (size_t)rank * a.slice;
  float* v_new = a.V + e * (size_t)a.K * a.D + (size_t)nk * a.D + (size_t)rank * a.slice;
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    const int j = tid + m * T;
    if (j >= nv) continue;
    const float4 u = scrub4(div4(sub4(dz[m], add4(neg4(dg[m]), uvd[m])), denom));
    const float4 upd = sub4(neg4(add4(neg4(gn[m]), uvg[m])), scale4(u, vg));
    st4(u_new, j, u);
    st4(v_new, j, vt[m]);
    if (improved) {
      st4(a.BZ + row, j, zn[m]);
      st4(a.BG + row, j, gn[m]);
    }
    st4(a.Z + row, j, zn[m]);
    st4(a.G + row, j, gn[m]);
    st4(a.UPD + row, j, upd);
    st4(a.ZN + row, j, add4(zn[m], upd));
  }
}

template <int VPT, bool DZ_TAKEN>
cudaError_t launch(const StepArgs& a, int B, int ncta, int threads, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ncta);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, broyden_cluster_kernel<VPT, DZ_TAKEN>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, returns the launch's error
// (0 on success). cluster, slice, threads and vpt: the plan of
// ops/fused_solve.py broyden_plan. dz_taken: the step taken is ZN - Z
// (the line search's), else UPD.
int imnf_broyden_step(int phase, const int* idx_in, const int* cnt_in,
                      int* idx_out, int* cnt_out, float* Z, float* G,
                      float* UPD, float* ZN, const float* GN, float* BZ,
                      float* BG, float* U, float* V, int* istate,
                      float* fstate, int B, int D, int K, float eps, int cap,
                      int patience, float rtol, float guard_eps, int newton,
                      int dz_taken, int cluster, int slice, int threads, int vpt,
                      void* stream) {
  if (K > KMAX || cluster < 1 || cluster > MAX_CLUSTER || cluster * slice != D ||
      slice % 4 || threads < 32 || threads > MAX_THREADS || threads % 32 ||
      vpt * threads < slice / 4)
    return (int)cudaErrorInvalidValue;
  const StepArgs a{phase, idx_in, cnt_in, idx_out, cnt_out, Z, G, UPD, ZN, GN, BZ, BG, U, V,
                   istate, fstate, D, K, slice, eps, cap, patience, rtol, guard_eps, newton};
  cudaStream_t s = (cudaStream_t)stream;
  if (dz_taken) {
    switch (vpt) {
      case 1: return (int)launch<1, true>(a, B, cluster, threads, s);
      case 2: return (int)launch<2, true>(a, B, cluster, threads, s);
      case 4: return (int)launch<4, true>(a, B, cluster, threads, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (vpt) {
    case 1: return (int)launch<1, false>(a, B, cluster, threads, s);
    case 2: return (int)launch<2, false>(a, B, cluster, threads, s);
    case 4: return (int)launch<4, false>(a, B, cluster, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
