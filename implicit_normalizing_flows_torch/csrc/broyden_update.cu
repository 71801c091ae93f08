// Hopper (sm_90a) kernel of the generic Broyden solver's rank-1 secant
// update and next direction.
//
// Replaces the TPU kernel implicit_normalizing_flows_tpu/ops/pallas_kernels.py
// ::fused_broyden_update (:69; _kernel :27), the per-iteration low-rank stage
// of ops/broyden.py::broyden (:271-312). Per example, with the live columns
// k < col of U = Us[b] (D, K) and V^T = VTs[b] (K, D):
//   vT   = -dx + (dx^T U) V^T                          (rmatvec)
//   mdgx = -dgx + U (V^T dgx),  mgx = -gx + U (V^T gx)  (matvec)
//   u    = (dx - mdgx) / (vT . dgx)
//   u, vT with NaN and inf scrubbed to 0, and 0 where the example is inactive
//   U[:, col] = u,  V^T[col, :] = vT                    (in place)
//   update = -mgx - u (vT . gx)    (-matvec(U', V', gx) by the rank-1 identity)
//
// In place: the solver writes column col = nstep - 1, and nstep never
// exceeds the threshold K before the loop ends (broyden.py:201-202, 272), so
// col never wraps: the columns k >= col are still zero and column col is
// written once (the TPU kernel adds a masked outer product for the same
// reason). Only the live columns k < col are read.
//
// Design: one block per example, threads over D (d = tid, tid + blockDim,
// ...). The sums over D are fixed-order reductions (each thread's strided
// partial sum, a xor butterfly over the warp whose lane 0 result is kept,
// then the warps' sums in warp order), so a result does not depend on the
// run; the sums over k run in k order. The per-d values (vT, u, mgx) are
// recomputed from the live columns where a later stage needs them again
// rather than held in shared memory, so any D runs. All arithmetic is f32
// FMAs: JAX runs these contractions at Precision.HIGHEST (broyden.py:60-63).
//
// What bounds it on H100: bytes, and below them the launch. A call reads the
// live columns of U and V^T (2 B D col floats), three vectors and the mask,
// and writes a column, a row and the update. At POWER's shapes (B 1000, D 6,
// K 30 forward, K 4 backward, B 4000 in evaluation) that is at most about
// 1.4 MB, under half a microsecond at 3.35 TB/s, so a call costs its launch
// latency. It is not tuned.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;

// Lane 0's total of v over the warp (the other lanes' totals are summed in
// other orders and are not used).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's total of v, the same on every thread: warp totals in warp
// order. scratch holds MAX_WARPS floats; the block syncs twice.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

struct Example {
  float* U;           // (D, K)
  float* V;           // (K, D)
  const float* dx;    // (D,)
  const float* dgx;
  const float* gx;
  int D, K, col;
};

// vT, the numerator dx - mdgx of u, and mgx at row d, from the live columns
// and the per-column sums vtx = V^T dgx, vtg = V^T gx, xtu = dx^T U.
__device__ __forceinline__ void row_values(const Example& e, int d, const float* vtx,
                                           const float* vtg, const float* xtu,
                                           float& vT, float& num, float& mgx) {
  float uv0 = 0.f, uv1 = 0.f, xv = 0.f;
  const float* Ud = e.U + (size_t)d * e.K;
  for (int k = 0; k < e.col; ++k) {
    const float u = Ud[k];
    uv0 = fmaf(u, vtx[k], uv0);
    uv1 = fmaf(u, vtg[k], uv1);
    xv = fmaf(xtu[k], e.V[(size_t)k * e.D + d], xv);
  }
  const float dx = e.dx[d];
  vT = -dx + xv;
  num = dx - (-e.dgx[d] + uv0);
  mgx = -e.gx[d] + uv1;
}

__device__ __forceinline__ float scrub(float v, bool active) {
  return (active && isfinite(v)) ? v : 0.f;
}

// grid (B), block (threads over D, a multiple of 32); dynamic shared memory
// 3 * col floats.
__global__ void broyden_update_kernel(float* __restrict__ Us, float* __restrict__ VTs,
                                      const float* __restrict__ dx,
                                      const float* __restrict__ dgx,
                                      const float* __restrict__ gx,
                                      const unsigned char* __restrict__ active, int D,
                                      int K, int col, float* __restrict__ update) {
  extern __shared__ float sums[];  // vtx[col], vtg[col], xtu[col]
  __shared__ float scratch[MAX_WARPS];
  const int b = blockIdx.x;
  const Example e{Us + (size_t)b * D * K, VTs + (size_t)b * K * D, dx + (size_t)b * D,
                  dgx + (size_t)b * D, gx + (size_t)b * D, D, K, col};
  float* vtx = sums;
  float* vtg = sums + col;
  float* xtu = sums + 2 * col;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;

  // the per-column sums over D: one warp per column
  for (int k = warp; k < col; k += nw) {
    const float* Vk = e.V + (size_t)k * D;
    float a = 0.f, g = 0.f, x = 0.f;
    for (int d = lane; d < D; d += 32) {
      a = fmaf(Vk[d], e.dgx[d], a);
      g = fmaf(Vk[d], e.gx[d], g);
      x = fmaf(e.dx[d], e.U[(size_t)d * K + k], x);
    }
    a = warp_sum(a);
    g = warp_sum(g);
    x = warp_sum(x);
    if (lane == 0) {
      vtx[k] = a;
      vtg[k] = g;
      xtu[k] = x;
    }
  }
  __syncthreads();

  // denom = vT . dgx, before the scrub
  float part = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float vT, num, mgx;
    row_values(e, d, vtx, vtg, xtu, vT, num, mgx);
    part = fmaf(vT, e.dgx[d], part);
  }
  const float denom = block_sum(part, scratch);

  // u and vT scrubbed and masked, the column and row written; vg = vT . gx.
  // The live columns read below are k < col: the writes do not touch them.
  const bool act = active[b] != 0;
  part = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float vT, num, mgx;
    row_values(e, d, vtx, vtg, xtu, vT, num, mgx);
    const float u = scrub(num / denom, act);
    vT = scrub(vT, act);
    e.U[(size_t)d * K + col] = u;
    e.V[(size_t)col * D + d] = vT;
    part = fmaf(vT, e.gx[d], part);
  }
  const float vg = block_sum(part, scratch);

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float vT, num, mgx;
    row_values(e, d, vtx, vtg, xtu, vT, num, mgx);
    const float u = scrub(num / denom, act);
    update[(size_t)b * D + d] = -mgx - u * vg;
  }
}

}  // namespace

extern "C" {

// Us (B, D, K), VTs (B, K, D): updated in place at column / row col.
// dx, dgx, gx, update (B, D) float32; active (B,) bool. 0 <= col < K.
int imnf_broyden_update(float* Us, float* VTs, const float* dx, const float* dgx,
                        const float* gx, const unsigned char* active, int B, int D,
                        int K, int col, float* update, cudaStream_t stream) {
  if (B <= 0) return 0;
  int threads = 32 * ((D + 31) / 32);
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = 3 * (size_t)col * sizeof(float);
  broyden_update_kernel<<<B, threads, smem, stream>>>(Us, VTs, dx, dgx, gx, active, D, K,
                                                      col, update);
  return (int)cudaGetLastError();
}

}  // extern "C"
