// Hopper (sm_90a) kernel of the final pair's scalar: fp_tdot
// (ops/fused_final.py), T[e] = sum r (swish'(h; beta) th) over an example's
// M x HW elements. Linked into estimator.cu's library (LINKED in
// ops/cuda_build.py), its own translation unit so that a change here moves
// no other kernel's SASS.
//
// Replaces the T reduction of the TPU kernel
// implicit_normalizing_flows_tpu/ops/fused_solve.py::fused_final_pair
// (_final_T_in_kernel :1346, inside _final_primal_kernel :1440).
//
// What bounds it on an H100: the bytes of r, h and th, read once (805 MB
// at 32x32 for both nets' 128 examples: 0.24 ms). One 256-thread block an
// example with scalar loads read them at 0.69 TB/s. Design: each example
// runs on a thread-block cluster of up to 8 CTAs (ops/fused_final.py
// tdot_plan: at least 4 CTAs an SM where the batch allows), CTA r summing
// elements [r chunk, (r + 1) chunk) by float4 loads of the three tensors,
// swish' applied once an element in registers; the CTAs' sums meet in
// rank 0's shared memory through cluster_reduce.cuh (fixed order:
// ops/sum_order.py fp_tdot_tiled repeats it), so one launch finishes T.

#include <cuda_runtime.h>

#include "cluster_reduce.cuh"
#include "conv_gemm.cuh"

namespace {

using namespace imnf;

constexpr int TDOT_THREADS = 256, MAX_CLUSTER = 8;

__device__ __forceinline__ float term(float r, float h, float th, float beta) {
  return __fmul_rn(r, __fmul_rn(dswish(h, beta), th));
}

// T[e] for example e = blockIdx.x / cluster of nets stacked along the
// batch (nb examples each, net e / nb's slope beta_net[e / nb]).
__global__ void __launch_bounds__(TDOT_THREADS) tdot_split_kernel(
    const float* __restrict__ r, const float* __restrict__ h,
    const float* __restrict__ th, const float* __restrict__ beta_net, int nb,
    long long n, long long chunk, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned ncta = cluster.num_blocks(), rank = cluster.block_rank();
  cluster_arrive_relaxed();
  const int e = blockIdx.x / ncta;
  const float beta = beta_net[e / nb];
  const size_t base = (size_t)e * n + (size_t)rank * chunk;
  const float4* r4 = reinterpret_cast<const float4*>(r + base);
  const float4* h4 = reinterpret_cast<const float4*>(h + base);
  const float4* t4 = reinterpret_cast<const float4*>(th + base);
  const long long nv = chunk / 4;
  float acc = 0.f;
#pragma unroll 4
  for (long long j = threadIdx.x; j < nv; j += TDOT_THREADS) {
    const float4 a = __ldg(r4 + j), b = __ldg(h4 + j), c = __ldg(t4 + j);
    acc = __fadd_rn(acc, term(a.x, b.x, c.x, beta));
    acc = __fadd_rn(acc, term(a.y, b.y, c.y, beta));
    acc = __fadd_rn(acc, term(a.z, b.z, c.z, beta));
    acc = __fadd_rn(acc, term(a.w, b.w, c.w, beta));
  }
  __shared__ float part[TDOT_THREADS / 32];
  __shared__ float slots[MAX_CLUSTER];
  stage(acc, 0, part);
  __syncthreads();
  cluster_wait();
  if (threadIdx.x == 0) push(cta_sum(part, 0), slots, rank, 1, 0, 0);
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) out[e] = ranks_sum(slots, ncta, 1, 0);
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, returns the launch's error
// (0 on success). cluster and chunk: the plan of ops/fused_final.py
// tdot_plan (cluster * chunk == n, chunk % 4 == 0).
int imnf_fp_tdot(const float* r, const float* h, const float* th,
                 const float* beta_net, int B, int nets, long long n, int cluster,
                 long long chunk, float* out, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || cluster * chunk != n || chunk % 4 ||
      nets < 1 || B % nets)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(TDOT_THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, tdot_split_kernel, r, h, th, beta_net,
                                             B / nets, n, chunk, out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
