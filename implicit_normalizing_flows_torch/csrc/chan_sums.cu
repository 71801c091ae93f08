// Hopper (sm_90a) kernel of the re-attachment's channel sums: rv_chan_sums
// (ops/implicit_grad.py). Per channel m of t (Bn, M, HW):
//   g = t * swish'(h; beta) (with h) or t (without)
//   sums[m] = alpha * sum_{b,p} g;  dbeta[m] = sum_{b,p} t * dswish/dbeta(h)
//   out[b][m][p] = [base[b][m][p]] + g   (when out is given)
// Linked into implicit_grad.cu's library (LINKED in ops/cuda_build.py), its
// own translation unit so that a change here moves no other kernel's SASS.
//
// Replaces the bias and slope sums of the TPU kernel
// implicit_normalizing_flows_tpu/ops/fused_solve.py::fused_reattach_vjp
// (:1226; _net_vjp_in_kernel :1118-1142) and its d_x = u + t0 swish'(x).
//
// What bounds it on an H100: the bytes of t, h, base and out, each moved
// once (268 MB at M = mid 512, 32x32, batch 64, with h: 0.080 ms). One
// 256-thread block a channel, with scalar loads and a division by HW an
// element, read them at 0.39 of that rate at M = mid and ran 3 to 48 blocks
// on the 132 SMs at M = c. Design: each channel runs on a thread-block
// cluster of up to 16 CTAs (ops/implicit_grad.py chan_sums_plan: the fewest
// that give every SM one; 1 at M = mid, 16 at c 3 and 12, 4 at c 48), CTA r
// taking elements [r chunk, (r + 1) chunk) of the channel's Bn runs of HW
// (whole examples where the cluster divides Bn, pieces of HW otherwise) as
// float4 vectors (single floats where HW % 4 or a pointer's alignment
// forbids them), the example and position of a thread's next vector
// carried from its last (no division in the loop), CS_UNROLL vectors of
// each tensor loaded before the first is used, swish' and its slope
// derivative from one sigmoid (dswish_pair). The CTAs' sums meet in rank
// 0's shared memory through cluster_reduce.cuh (fixed order:
// ops/sum_order.py rv_chan_sums_tiled repeats it), so one launch finishes
// both sums, with no atomics.

#include <cuda_runtime.h>

#include "cluster_reduce.cuh"
#include "conv_gemm.cuh"

namespace {

using namespace imnf;

constexpr int CS_THREADS = 256, CS_UNROLL = 4, MAX_CLUSTER = 16;

template <int VEC>
__device__ __forceinline__ void load(const float* __restrict__ p, size_t off, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + off));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p + off);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ p, size_t off, const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p + off) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[off] = v[0];
}

// channel m = blockIdx.x / cluster; CTA rank r of its cluster sums the
// channel's vectors [r nv, (r + 1) nv) in the order (b, p), thread i the
// vectors i + k CS_THREADS (k = 0, 1, ...), each vector's lanes in order
template <int VEC, bool HAS_H, bool HAS_OUT>
__global__ void __launch_bounds__(CS_THREADS) chan_sums_split_kernel(
    const float* __restrict__ t, const float* __restrict__ h, float beta,
    const float* __restrict__ base, int M, int HW, long long nv, float alpha,
    float* __restrict__ sums, float* __restrict__ dbeta, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned ncta = cluster.num_blocks(), rank = cluster.block_rank();
  cluster_arrive_relaxed();
  const int m = blockIdx.x / ncta;
  const int hv = max(HW / VEC, 1);  // vectors in an example's run
  const long long j0 = (long long)rank * nv + threadIdx.x;
  // this thread's next vector: example b, vector p of its run; a step of
  // CS_THREADS vectors moves it db examples and dp vectors on
  int b = (int)(j0 / hv), p = (int)(j0 % hv);
  const int db = CS_THREADS / hv, dp = CS_THREADS % hv;
  const size_t run0 = (size_t)m * HW, stride = (size_t)M * HW;
  float sg = 0.f, sb = 0.f;
  for (long long j = threadIdx.x; j < nv; j += CS_UNROLL * CS_THREADS) {
    size_t off[CS_UNROLL];
    float tv[CS_UNROLL][VEC], hh[CS_UNROLL][VEC], bv[CS_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < CS_UNROLL; ++u) {
      off[u] = run0 + (size_t)b * stride + (size_t)p * VEC;
      if (j + u * CS_THREADS < nv) {
        load<VEC>(t, off[u], tv[u]);
        if (HAS_H) load<VEC>(h, off[u], hh[u]);
        if (HAS_OUT && base != nullptr) load<VEC>(base, off[u], bv[u]);
      }
      p += dp;
      b += db;
      if (p >= hv) {
        p -= hv;
        ++b;
      }
    }
#pragma unroll
    for (int u = 0; u < CS_UNROLL; ++u) {
      if (j + u * CS_THREADS >= nv) break;
      float o[VEC];
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        float g = tv[u][l];
        if (HAS_H) {
          float d, dsb;
          dswish_pair(hh[u][l], beta, d, dsb);
          g = __fmul_rn(tv[u][l], d);
          sb = __fadd_rn(sb, __fmul_rn(tv[u][l], dsb));
        }
        sg = __fadd_rn(sg, g);
        if (HAS_OUT) o[l] = base != nullptr ? __fadd_rn(bv[u][l], g) : g;
      }
      if (HAS_OUT) store<VEC>(out, off[u], o);
    }
  }
  __shared__ float part[2 * (CS_THREADS / 32)];
  __shared__ float slots[2 * MAX_CLUSTER];
  stage(sg, 0, part);
  if (HAS_H) stage(sb, 1, part);
  __syncthreads();
  cluster_wait();
  if (threadIdx.x == 0) {
    push(cta_sum(part, 0), slots, rank, 2, 0, 0);
    if (HAS_H) push(cta_sum(part, 1), slots, rank, 2, 1, 0);
  }
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) {
    sums[m] = __fmul_rn(alpha, ranks_sum(slots, ncta, 2, 0));
    if (dbeta != nullptr) dbeta[m] = HAS_H ? ranks_sum(slots, ncta, 2, 1) : 0.f;
  }
}

template <int VEC, bool HAS_H, bool HAS_OUT>
cudaError_t launch(const float* t, const float* h, float beta, const float* base, int M,
                   int HW, long long nv, int cluster, float alpha, float* sums, float* dbeta,
                   float* out, cudaStream_t stream) {
  auto kernel = chan_sums_split_kernel<VEC, HAS_H, HAS_OUT>;
  if (cluster > 8) {  // past the portable 8 (c 3 and 12): allowed once per kernel
    static const cudaError_t wide =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (wide != cudaSuccess) return wide;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M * cluster);
  cfg.blockDim = dim3(CS_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, t, h, beta, base, M, HW, nv, alpha, sums, dbeta,
                            out);
}

template <int VEC>
cudaError_t launch_vec(const float* t, const float* h, float beta, const float* base, int M,
                       int HW, long long nv, int cluster, float alpha, float* sums,
                       float* dbeta, float* out, cudaStream_t s) {
  if (h != nullptr)
    return out != nullptr
               ? launch<VEC, true, true>(t, h, beta, base, M, HW, nv, cluster, alpha, sums,
                                         dbeta, out, s)
               : launch<VEC, true, false>(t, h, beta, base, M, HW, nv, cluster, alpha, sums,
                                          dbeta, out, s);
  return out != nullptr
             ? launch<VEC, false, true>(t, h, beta, base, M, HW, nv, cluster, alpha, sums,
                                        dbeta, out, s)
             : launch<VEC, false, false>(t, h, beta, base, M, HW, nv, cluster, alpha, sums,
                                         dbeta, out, s);
}

bool aligned(const void* p) { return p == nullptr || (size_t)p % 16 == 0; }

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, returns the launch's error
// (0 on success). cluster and vec: the plan of ops/implicit_grad.py
// chan_sums_plan (cluster divides Bn HW into chunks of whole vectors; vec
// 4 only where HW % 4 == 0 and every pointer is 16-byte aligned).
int imnf_rv_chan_sums(const float* t, const float* h, float beta, const float* base, int Bn,
                      int M, int HW, float alpha, float* sums, float* dbeta, float* out,
                      int cluster, int vec, void* stream) {
  const long long n = (long long)Bn * HW;
  if (cluster < 1 || cluster > MAX_CLUSTER || n % ((long long)cluster * vec) ||
      (vec != 1 && vec != 4) ||
      (vec == 4 && (HW % 4 || !aligned(t) || !aligned(h) || !aligned(base) || !aligned(out))))
    return (int)cudaErrorInvalidValue;
  const long long nv = n / cluster / vec;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      vec == 4 ? launch_vec<4>(t, h, beta, base, M, HW, nv, cluster, alpha, sums, dbeta, out, s)
               : launch_vec<1>(t, h, beta, base, M, HW, nv, cluster, alpha, sums, dbeta, out, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
