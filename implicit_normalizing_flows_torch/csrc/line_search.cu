// Hopper (sm_90a) kernel of the Armijo line search that the fused solves
// run under IMNF_LINE_SEARCH=1: line_search (ops/line_search.py), linked
// into fused_solve.cu's library (LINKED in ops/cuda_build.py), its own
// translation unit so that it moves no other kernel's SASS.
//
// Replaces the bounded two-trial backtracking inside the TPU kernels
// implicit_normalizing_flows_tpu/ops/fused_solve.py::fused_broyden_solve
// and ::fused_backward_solve (_broyden_in_kernel :610-642, the lane-packed
// _broyden_in_kernel_packed :373-405), which evaluate both trials of an
// example under one lax.cond. On Hopper the solve's host loop evaluates
// the trial residuals with its conv kernels on device-side lists, and this
// kernel runs the three steps around them, for every example of its list:
//
//   PHASE_TEST  phi0 = sum G^2, phi1 = sum GN^2; an example with
//               phi1 > phi0 (1 - c1) fails: sq = clip(phi0 / (2 phi1 +
//               1e-30), 1e-2, 1), ZQ = Z + sq UPD, lsf = (phi0, sq), the
//               example appended to the fail list
//   PHASE_HALF  phi_q = sum GQ^2; phi_q <= phi0 (1 - c1 sq) takes the
//               quadratic trial (ZN = ZQ, GN = GQ), else ZH = Z + sq/2 UPD,
//               lsf[1] = sq/2, the example appended to the half list
//   PHASE_PICK  phi_h = sum GH^2; phi_h <= phi0 (1 - c1 sh) takes the
//               halved trial (ZN = ZH, GN = GH), else the full step stays
//
// and counts the examples that failed the test and took each step into a
// device tally. The host reads nothing: the conv kernels' blocks past a
// list's count return.
//
// What bounds it on an H100: the bytes of the vectors it moves, at most
// 4 B D (2 + 3) for the test (G, GN read; Z, UPD read and ZQ written for
// the failing examples), 4 B D (2 + 2) for each trial's pick (about 3.9 MB
// at B 64, D 3072, about 1.2 us at 3.35 TB/s); a launch's floor of 2.5-3 us
// sets its time. Design: broyden_step.cu's layout, a thread-block cluster
// of 4 or 8 CTAs a live example on ops/fused_solve.py broyden_plan, CTA r
// owning D / cluster elements as float4 vectors; the sums of squares go
// through cluster_reduce.cuh (fixed order, the same bits in every CTA, so
// every CTA takes the same branch: ops/sum_order.py line_search_tiled
// repeats them). Every value is rounded op by op (__fmul_rn / __fadd_rn /
// __fdiv_rn, no FMA contraction) as _line_search_plain rounds it; a NaN
// phi fails no comparison, as there (a NaN phi1 keeps the full step and the
// protective break fires; an inf phi1 fails with sq = 1e-2). Rank 0 of a
// cluster writes the example's lsf, list entry and tally; every CTA reads
// lsf before the cluster barrier, and rank 0 writes it after.

#include <cuda_runtime.h>

#include "cluster_reduce.cuh"

namespace {

using namespace imnf;

constexpr int MAX_THREADS = 256, MAX_WARPS = MAX_THREADS / 32, MAX_CLUSTER = 8, NSUM = 2;
enum { PHASE_TEST = 0, PHASE_HALF = 1, PHASE_PICK = 2 };
enum { T_FAILED = 0, T_QUADRATIC = 1, T_HALVED = 2, T_FULL = 3 };
// the constants as the plain version's float32 operations take them
constexpr float C1 = (float)1e-4, KEEP = (float)(1.0 - 1e-4), SQ_MIN = (float)1e-2,
                TINY = (float)1e-30;

struct SearchArgs {
  int phase;
  const int* idx_in;
  const int* cnt_in;
  int* idx_out;
  int* cnt_out;
  const float *Z, *G, *UPD;
  float *ZN, *GN, *ZQ;
  const float* GQ;
  float* ZH;
  const float* GH;
  float* lsf;
  int* tally;
  int D, slice;
};

__device__ __forceinline__ float4 ld4(const float* p, int j) {
  return reinterpret_cast<const float4*>(p)[j];
}
__device__ __forceinline__ void st4(float* p, int j, float4 v) {
  reinterpret_cast<float4*>(p)[j] = v;
}
// z + s u, the product and the sum each rounded
__device__ __forceinline__ float4 axpy4(float4 z, float s, float4 u) {
  return make_float4(__fadd_rn(z.x, __fmul_rn(s, u.x)), __fadd_rn(z.y, __fmul_rn(s, u.y)),
                     __fadd_rn(z.z, __fmul_rn(s, u.z)), __fadd_rn(z.w, __fmul_rn(s, u.w)));
}
// phi <= phi0 (1 - c1 s), rounded as the plain version
__device__ __forceinline__ bool armijo(float phi, float phi0, float s) {
  return phi <= __fmul_rn(phi0, __fsub_rn(1.f, __fmul_rn(C1, s)));
}

template <int VPT>
__global__ void __launch_bounds__(MAX_THREADS) line_search_kernel(const SearchArgs a) {
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

  __shared__ float part[NSUM * MAX_WARPS];
  __shared__ float slots[MAX_CLUSTER * NSUM];
  __shared__ float red[NSUM];

  // the residual whose sum of squares decides: G (and GN) in the test, the
  // trial's residual in the picks (kept for GN)
  const bool test = a.phase == PHASE_TEST;
  const float* r = test ? a.G : a.phase == PHASE_HALF ? a.GQ : a.GH;
  float4 g[VPT];
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    const int j = tid + m * T;
    if (j >= nv) continue;
    g[m] = ld4(r + row, j);
    s0 = dot4(s0, g[m], g[m]);
    if (test) {
      const float4 gn = ld4(a.GN + row, j);
      s1 = dot4(s1, gn, gn);
    }
  }
  stage(s0, 0, part);
  if (test) stage(s1, 1, part);
  // the example's (phi0, step), read by every CTA before the barrier
  const float phi0_in = test ? 0.f : a.lsf[2 * e], step = test ? 0.f : a.lsf[2 * e + 1];
  cluster_wait();
  cluster_reduce(part, slots, red, test ? 2 : 1, NSUM, rank, ncta);
  const bool lead = rank == 0 && tid == 0;

  if (test) {
    const float phi0 = red[0], phi1 = red[1];
    if (!(phi1 > __fmul_rn(phi0, KEEP))) return;
    float sq = __fdiv_rn(phi0, __fadd_rn(__fmul_rn(2.f, phi1), TINY));
    sq = sq < SQ_MIN ? SQ_MIN : sq > 1.f ? 1.f : sq;
#pragma unroll
    for (int m = 0; m < VPT; ++m) {
      const int j = tid + m * T;
      if (j < nv) st4(a.ZQ + row, j, axpy4(ld4(a.Z + row, j), sq, ld4(a.UPD + row, j)));
    }
    if (lead) {
      a.lsf[2 * e] = phi0;
      a.lsf[2 * e + 1] = sq;
      a.idx_out[atomicAdd(a.cnt_out, 1)] = (int)e;
      atomicAdd(a.tally + T_FAILED, 1);
    }
    return;
  }

  const bool half = a.phase == PHASE_HALF;
  if (armijo(red[0], phi0_in, step)) {
    const float* zt = half ? a.ZQ : a.ZH;
#pragma unroll
    for (int m = 0; m < VPT; ++m) {
      const int j = tid + m * T;
      if (j >= nv) continue;
      st4(a.ZN + row, j, ld4(zt + row, j));
      st4(a.GN + row, j, g[m]);
    }
    if (lead) atomicAdd(a.tally + (half ? T_QUADRATIC : T_HALVED), 1);
    return;
  }
  if (!half) {
    if (lead) atomicAdd(a.tally + T_FULL, 1);
    return;
  }
  const float sh = step * 0.5f;
#pragma unroll
  for (int m = 0; m < VPT; ++m) {
    const int j = tid + m * T;
    if (j < nv) st4(a.ZH + row, j, axpy4(ld4(a.Z + row, j), sh, ld4(a.UPD + row, j)));
  }
  if (lead) {
    a.lsf[2 * e + 1] = sh;
    a.idx_out[atomicAdd(a.cnt_out, 1)] = (int)e;
  }
}

template <int VPT>
cudaError_t launch(const SearchArgs& a, int B, int ncta, int threads, cudaStream_t s) {
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, line_search_kernel<VPT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, returns the launch's error
// (0 on success). idx_out / cnt_out: the fail list (PHASE_TEST), the half
// list (PHASE_HALF), unused (PHASE_PICK); the caller zeroes their counts
// before PHASE_TEST. cluster, slice, threads and vpt: the plan of
// ops/fused_solve.py broyden_plan.
int imnf_line_search(int phase, const int* idx_in, const int* cnt_in, int* idx_out,
                     int* cnt_out, const float* Z, const float* G, const float* UPD, float* ZN,
                     float* GN, float* ZQ, const float* GQ, float* ZH, const float* GH,
                     float* lsf, int* tally, int B, int D, int cluster, int slice,
                     int threads, int vpt, void* stream) {
  if (phase < PHASE_TEST || phase > PHASE_PICK || (phase != PHASE_PICK && !idx_out) ||
      cluster < 1 || cluster > MAX_CLUSTER || cluster * slice != D || slice % 4 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 || vpt * threads < slice / 4)
    return (int)cudaErrorInvalidValue;
  const SearchArgs a{phase, idx_in, cnt_in, idx_out, cnt_out, Z, G, UPD, ZN, GN, ZQ, GQ, ZH,
                     GH, lsf, tally, D, slice};
  cudaStream_t s = (cudaStream_t)stream;
  switch (vpt) {
    case 1: return (int)launch<1>(a, B, cluster, threads, s);
    case 2: return (int)launch<2>(a, B, cluster, threads, s);
    case 4: return (int)launch<4>(a, B, cluster, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
