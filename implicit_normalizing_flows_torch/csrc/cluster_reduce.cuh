// Fixed-order sums split over a thread-block cluster (Hopper, sm_90a): the
// reduction helpers of broyden_step.cu, tdot.cu, chan_sums.cu and
// line_search.cu.
//
// A cluster's CTAs each sum their part of a row, then exchange the CTA sums
// through distributed shared memory: every CTA pushes its sums into a slot
// array of the CTAs that need them (st.shared::cluster through
// map_shared_rank), one cluster barrier (arrive.release / wait.acquire)
// makes the pushes visible, and each CTA adds the slots in rank order. So
// every CTA that reads a sum reads the same bits, no second launch and no
// atomics are needed, and no CTA touches another's shared memory after the
// last barrier (a CTA may exit right after it).
//
// The order, which ops/sum_order.py's _cluster_tree repeats: each thread
// sums its own elements from 0 (a float4 vector's four lanes in order);
// a warp adds its lanes by the xor butterfly (offsets 16 .. 1; every lane
// ends with the same bits); the CTA adds its warps' sums in order from 0;
// the cluster adds its CTAs' sums in rank order from 0. Every add and
// product is rounded on its own (__fadd_rn / __fmul_rn: no FMA).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace imnf {

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// this thread's running sum of the products of a float4 pair
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
  acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
  acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
  return __fadd_rn(acc, __fmul_rn(a.w, b.w));
}

// The cluster barrier, split: every thread of every CTA arrives (release:
// its earlier shared and global writes become visible to the cluster) and
// waits for all (acquire). The relaxed arrive at a kernel's start, waited
// on before the first push, shows that every CTA of the cluster runs (a
// CTA's shared memory may be written only then) while the loads go on.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The CTA's sum of value i: every thread calls stage(v, i, part) for the
// same sequence of i (lane 0 of warp w leaves its warp's sum in
// part[i * nwarps + w]); after a __syncthreads, cta_sum(part, i, nwarps)
// adds them in order.
__device__ __forceinline__ void stage(float v, int i, float* part) {
  v = warp_allsum(v);
  if (threadIdx.x % 32 == 0) part[i * (blockDim.x / 32) + threadIdx.x / 32] = v;
}
__device__ __forceinline__ float cta_sum(const float* part, int i) {
  const int nw = blockDim.x / 32;
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s = __fadd_rn(s, part[i * nw + w]);
  return s;
}

// Push value i of this CTA (rank `rank`) into slot[rank * stride + i] of
// CTA `to` of the cluster.
__device__ __forceinline__ void push(float v, float* slot, int rank, int stride, int i,
                                     unsigned to) {
  namespace cg = cooperative_groups;
  cg::this_cluster().map_shared_rank(slot, to)[rank * stride + i] = v;
}

// Value i summed over the cluster's `n` CTAs in rank order, from this CTA's
// slots (after the barrier that follows the pushes).
__device__ __forceinline__ float ranks_sum(const float* slot, int n, int stride, int i) {
  float s = 0.f;
  for (int r = 0; r < n; ++r) s = __fadd_rn(s, slot[r * stride + i]);
  return s;
}

// The cluster's sums of the n values every thread staged into part (after
// the first cluster barrier's wait): each CTA adds its warps' sums, pushes
// them into every CTA's slots (stride values a rank), and after the barrier
// adds the slots in rank order into red, every CTA the same bits.
__device__ __forceinline__ void cluster_reduce(float* part, float* slots, float* red, int n,
                                               int stride, unsigned rank, unsigned ncta) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float s = cta_sum(part, i);
    for (unsigned to = 0; to < ncta; ++to) push(s, slots, rank, stride, i, to);
  }
  cluster_sync();
  for (int i = threadIdx.x; i < n; i += blockDim.x) red[i] = ranks_sum(slots, ncta, stride, i);
  __syncthreads();
}

}  // namespace imnf
