// Hopper (sm_90a) kernels of the forward Broyden solve.
//
// Replaces the TPU kernel implicit_normalizing_flows_tpu/ops/fused_solve.py
// ::fused_broyden_solve (_solve_kernel :773, _broyden_in_kernel :538,
// _make_eval :245). The TPU kernel runs one example's whole solve per grid
// step with the Broyden state and the 512 x HW intermediates resident in up
// to 110 MiB of VMEM. An H100 SM has 227 KB of shared memory, so the solve is
// re-cut into a host-driven loop over four batched kernels; every launch
// works on a list of ACTIVE example indices kept on the device, so an
// example that converged, stalled or broke costs no further conv work:
//
//   conv3x3_in   [swish(b0)] -> conv3x3 c->mid + b1 -> swish(b1)   (im2col GEMM)
//   conv1x1_mid  mid->mid product + b2 -> swish(b2)                (tiled GEMM)
//   conv3x3_out  conv3x3 mid->c + b3, fused with the residual
//                out = base + sgn * net - sub   (g = x_embed - net(z) - z)
//   broyden_step one block per active example: secant contractions over the
//                nstep written U/V planes, writes plane nstep (NaN scrub),
//                best iterate, protective break, stall exit, done, next
//                update; appends the example to the next active list.
//                Its phase argument also runs the solve's initialisation and
//                the precision ladder's re-arm.
//
// The conv kernels and the precision model (modes f32 / bf16 / tf32 /
// tf32x) are shared with the implicit-gradient kernels: conv_gemm.cuh, and
// in the split modes mma_gemm.cuh for conv1x1_mid, conv3x3_in_tc.cuh
// (linked from conv3x3_in_tc.cu) for conv3x3_in and conv3x3_out_tc.cuh
// (linked from conv3x3_out_tc.cu) for conv3x3_out.
//
// What bounds them on H100: conv1x1_mid is ~90% of the MACs (268M of 296M
// per example per net eval at 32x32). In modes tf32 / tf32x it runs on the
// tensor cores (mma_gemm.cuh's tc_conv1x1_kernel with PASSES 3 / 4: the
// bf16 split's 3 or 4 passes of wgmma on a hi and a lo panel, each
// activation read and split once; that header gives its bound and design),
// and so does conv3x3_in (conv3x3_in_tc.cuh's mma.sync kernel on an im2col
// tile of the band, the split's 3 or 4 passes, its output's bytes bounding
// it; the blocks of dead slots return at once), and so does conv3x3_out
// (conv3x3_out_tc.cuh's mma.sync kernel on hi / lo halo tiles of the band,
// its input's bytes bounding it). Modes f32 / bf16 of the three run on the
// CUDA cores (conv_gemm.cuh), bound by their FP32 operations. broyden_step
// is bound by the bytes of the U/V planes it streams (2 x nstep x D floats
// per example).

#include "mma_gemm.cuh"
#include "conv3x3_in_tc.cuh"
#include "conv3x3_out_chain.cuh"

namespace {

using namespace imnf;

// ---------------------------------------------------------------------------
// broyden_step: one block per active example (_broyden_in_kernel body).
constexpr int STEP_THREADS = 512, STEP_WARPS = STEP_THREADS / 32, KMAX = 64;
enum { PHASE_INIT = 0, PHASE_STEP = 1, PHASE_REARM = 2 };
// per-example int state: [nstep, best_step, prot, done]; float state:
// [best_obj, best_snap, init_obj]
enum { I_NSTEP = 0, I_BEST_STEP = 1, I_PROT = 2, I_DONE = 3, NI = 4 };
enum { F_BEST_OBJ = 0, F_BEST_SNAP = 1, F_INIT_OBJ = 2, NF = 3 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums in two steps: every thread calls stage(v, i) for the same
// sequence of i (warp sums land in part[i][warp]); finish(first, n, red) then
// leaves red[i] = the block's sum of value i for first <= i < n, readable by
// every thread. The tree order is fixed, so the sums are deterministic.
struct BlockSums {
  float (*part)[STEP_WARPS];
  __device__ void stage(float v, int i) const {
    const float s = warp_sum(v);
    if (threadIdx.x % 32 == 0) part[i][threadIdx.x / 32] = s;
  }
  __device__ void finish(int first, int n, float* red) const {
    __syncthreads();
    for (int i = first + threadIdx.x; i < n; i += STEP_THREADS) {
      float s = 0.f;
      for (int w = 0; w < STEP_WARPS; ++w) s += part[i][w];
      red[i] = s;
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(STEP_THREADS) broyden_step_kernel(
    int phase, const int* __restrict__ idx_in, const int* __restrict__ cnt_in,
    int* __restrict__ idx_out, int* __restrict__ cnt_out, float* Z, float* G,
    float* UPD, float* ZN, const float* __restrict__ GN, float* BZ, float* BG,
    float* U, float* V, int* istate, float* fstate, int D, int K, float eps,
    int cap, int patience, float rtol, float guard_eps, int newton) {
  const int slot = blockIdx.x;
  if (slot >= *cnt_in) return;
  const size_t e = (size_t)idx_in[slot];
  const int tid = threadIdx.x;
  float* z = Z + e * D;
  float* g = G + e * D;
  float* upd = UPD + e * D;
  float* zn = ZN + e * D;
  const float* gn = GN + e * D;
  float* bz = BZ + e * D;
  float* bg = BG + e * D;
  float* Ue = U + e * (size_t)K * D;
  float* Ve = V + e * (size_t)K * D;
  int* ist = istate + e * NI;
  float* fst = fstate + e * NF;

  __shared__ float part[3 * KMAX + 2][STEP_WARPS];
  __shared__ float red[3 * KMAX + 2];
  const BlockSums sums{part};
  constexpr int R_LAST = 3 * KMAX + 1;  // scratch slot of the late sums
  __shared__ float sc[1];  // improved flag of PHASE_STEP
  const int nk = ist[I_NSTEP];  // planes written so far (never wraps)

  if (phase == PHASE_INIT) {
    float ss = 0.f;
    for (int j = tid; j < D; j += STEP_THREADS) ss += gn[j] * gn[j];
    sums.stage(ss, 0);
    sums.finish(0, 1, red);
    const float obj = sqrtf(red[0]);
    for (int j = tid; j < D; j += STEP_THREADS) {
      const float zj = zn[j], gj = gn[j], u = newton ? gj : -gj;
      z[j] = zj; g[j] = gj; bz[j] = zj; bg[j] = gj; upd[j] = u; zn[j] = zj + u;
    }
    if (tid == 0) {
      const int done = obj < eps;
      ist[I_NSTEP] = 0; ist[I_BEST_STEP] = 0; ist[I_PROT] = 0; ist[I_DONE] = done;
      fst[F_BEST_OBJ] = obj; fst[F_BEST_SNAP] = obj; fst[F_INIT_OBJ] = obj;
      if (!done && 0 < cap) idx_out[atomicAdd(cnt_out, 1)] = (int)e;
    }
    return;
  }

  if (phase == PHASE_REARM) {
    // continue from the best iterate with the residual g_b re-evaluated at
    // the stage precision; update = g_b - sum_k U_k <V_k, g_b>
    float ss = 0.f;
    for (int j = tid; j < D; j += STEP_THREADS) ss += gn[j] * gn[j];
    sums.stage(ss, 0);
    for (int k = 0; k < nk; ++k) {
      const float* vk = Ve + (size_t)k * D;
      float s = 0.f;
      for (int j = tid; j < D; j += STEP_THREADS) s += vk[j] * gn[j];
      sums.stage(s, k + 1);
    }
    sums.finish(0, nk + 1, red);
    const float obj = sqrtf(red[0]);
    for (int j = tid; j < D; j += STEP_THREADS) {
      float uvg = 0.f;
      for (int k = 0; k < nk; ++k) uvg += Ue[(size_t)k * D + j] * red[k + 1];
      const float gj = gn[j], bzj = bz[j], u = gj - uvg;
      z[j] = bzj; g[j] = gj; bg[j] = gj; upd[j] = u; zn[j] = bzj + u;
    }
    if (tid == 0) {
      const int done = ist[I_PROT] || obj < eps;
      ist[I_DONE] = done;
      fst[F_BEST_OBJ] = obj; fst[F_BEST_SNAP] = obj;
      if (!done && nk < cap) idx_out[atomicAdd(cnt_out, 1)] = (int)e;
    }
    return;
  }

  // PHASE_STEP: z_new = zn, g_new = gn, delta_z = upd, delta_g = gn - g.
  // Pass A: ||g_new||^2 and the 3 nk contractions <V_k,dg>, <V_k,g_new>,
  // <U_k,dz>.
  {
    float ss = 0.f;
    for (int j = tid; j < D; j += STEP_THREADS) ss += gn[j] * gn[j];
    sums.stage(ss, 0);
  }
  for (int k = 0; k < nk; ++k) {
    const float* uk = Ue + (size_t)k * D;
    const float* vk = Ve + (size_t)k * D;
    float a = 0.f, b = 0.f, c = 0.f;
    for (int j = tid; j < D; j += STEP_THREADS) {
      const float gj = gn[j], dg = gj - g[j];
      a += vk[j] * dg;
      b += vk[j] * gj;
      c += uk[j] * upd[j];
    }
    sums.stage(a, 1 + 3 * k);
    sums.stage(b, 2 + 3 * k);
    sums.stage(c, 3 + 3 * k);
  }
  sums.finish(0, 3 * nk + 1, red);
  const int nstep = nk + 1;
  if (tid == 0) {
    const float obj = sqrtf(red[0]);
    float best_obj = fst[F_BEST_OBJ], best_snap = fst[F_BEST_SNAP];
    const float init_obj = fst[F_INIT_OBJ];
    const int improved = obj < best_obj;
    if (improved) { best_obj = obj; ist[I_BEST_STEP] = nstep; }
    const int bad = !isfinite(obj) || obj > init_obj * 1e6f;
    const int prot = ist[I_PROT] || bad;
    int done = bad || obj < eps;
    if (patience > 0) {
      const int at_check = (nstep % patience) == 0;
      int stalled = at_check && best_obj > best_snap * (1.0f - rtol);
      if (guard_eps > 0.f) stalled = stalled && best_obj < guard_eps;
      done = done || stalled;
      if (at_check) best_snap = best_obj;
    }
    ist[I_NSTEP] = nstep; ist[I_PROT] = prot; ist[I_DONE] = done;
    fst[F_BEST_OBJ] = best_obj; fst[F_BEST_SNAP] = best_snap;
    sc[0] = (float)improved;
    if (!done && nstep < cap) idx_out[atomicAdd(cnt_out, 1)] = (int)e;
  }
  // Pass B: UVd, UVg, vT; staged in plane nk of U (UVd) and V (vT), UVg in
  // zn after z <- z_new.
  float* u_new = Ue + (size_t)nk * D;
  float* v_new = Ve + (size_t)nk * D;
  float pd = 0.f;
  for (int j = tid; j < D; j += STEP_THREADS) {
    const float dz = upd[j], dg = gn[j] - g[j];
    float uvd = 0.f, uvg = 0.f, vt = -dz;
    for (int k = 0; k < nk; ++k) {
      const float uk = Ue[(size_t)k * D + j], vk = Ve[(size_t)k * D + j];
      uvd += uk * red[1 + 3 * k];
      uvg += uk * red[2 + 3 * k];
      vt += vk * red[3 + 3 * k];
    }
    z[j] = zn[j];
    zn[j] = uvg;
    u_new[j] = uvd;
    v_new[j] = vt;
    pd += vt * dg;
  }
  sums.stage(pd, R_LAST);
  sums.finish(R_LAST, R_LAST + 1, red);
  const float denom = red[R_LAST];
  const bool improved = sc[0] != 0.f;
  // Pass C: u = (dz - (-dg + UVd)) / denom, scrub, write plane nk.
  float pe = 0.f;
  for (int j = tid; j < D; j += STEP_THREADS) {
    const float dz = upd[j], gj = gn[j], dg = gj - g[j];
    float u = (dz - (-dg + u_new[j])) / denom;
    float vt = v_new[j];
    vt = isfinite(vt) ? vt : 0.f;
    u = isfinite(u) ? u : 0.f;
    u_new[j] = u;
    v_new[j] = vt;
    pe += vt * gj;
    g[j] = gj;
    if (improved) { bz[j] = z[j]; bg[j] = gj; }
  }
  sums.stage(pe, R_LAST);
  sums.finish(R_LAST, R_LAST + 1, red);
  const float vg = red[R_LAST];
  // Pass D: update = -(-g_new + UVg) - u <vT, g_new>; next trial point.
  for (int j = tid; j < D; j += STEP_THREADS) {
    const float u = -(-g[j] + zn[j]) - u_new[j] * vg;
    upd[j] = u;
    zn[j] = z[j] + u;
  }
}

template <int MODE>
cudaError_t launch_in(int preact, const float* w_hi, const float* w_lo,
                      const float* bias, int M, int K, const float* inp,
                      const int* idx, const int* count, int B, int C, int H,
                      int W, float beta_pre, float beta_post, float* out,
                      cudaStream_t s) {
  if (preact)
    return launch_conv_gemm<MODE, 0, IN_SWISH, EPI_SWISH>(
        w_hi, w_lo, bias, M, K, inp, nullptr, idx, count, B, C, H, W,
        beta_pre, beta_post, 1.f, nullptr, out, s);
  return launch_conv_gemm<MODE, 0, IN_ID, EPI_SWISH>(
      w_hi, w_lo, bias, M, K, inp, nullptr, idx, count, B, C, H, W, beta_pre,
      beta_post, 1.f, nullptr, out, s);
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() right after its launch (0 on success).

// w_hi / w_lo: W1's split, bfloat16 in modes tf32 / tf32x (the tensor
// cores' operands, cast once per solve), float32 in modes f32 / bf16 (the
// CUDA cores; w_lo unused there)
int imnf_conv3x3_in(int mode, int preact, const void* w_hi,
                    const void* w_lo, const float* bias, float beta0,
                    float beta1, const float* inp, const int* idx,
                    const int* count, int B, int C, int H, int W, int mid,
                    float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* fh = static_cast<const float*>(w_hi);
  const float* fl = static_cast<const float*>(w_lo);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  switch (mode) {
    case MODE_F32: return (int)launch_in<MODE_F32>(preact, fh, fl, bias, mid, C * 9, inp, idx, count, B, C, H, W, beta0, beta1, out, s);
    case MODE_BF16: return (int)launch_in<MODE_BF16>(preact, fh, fl, bias, mid, C * 9, inp, idx, count, B, C, H, W, beta0, beta1, out, s);
    case MODE_TF32: return (int)conv3x3_in_tc_solve(3, wh, wl, bias, inp, idx, count, B, C, H, W, mid, preact, beta0, beta1, out, s);
    case MODE_TF32X: return (int)conv3x3_in_tc_solve(4, wh, wl, bias, inp, idx, count, B, C, H, W, mid, preact, beta0, beta1, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w_hi / w_lo: W2's split, bfloat16 in modes tf32 / tf32x (the tensor
// cores' operands, cast once per solve), float32 in modes f32 / bf16 (the
// CUDA cores; w_lo unused there)
int imnf_conv1x1_mid(int mode, const void* w_hi, const void* w_lo,
                     const float* bias, float beta2, const float* inp,
                     const int* count, int B, int mid, int H, int W,
                     float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  const float* fh = static_cast<const float*>(w_hi);
  const float* no_scale = nullptr;
  switch (mode) {
    case MODE_F32: return (int)launch_conv_gemm<MODE_F32, 1, IN_ID, EPI_SWISH>(fh, nullptr, bias, mid, mid, inp, nullptr, nullptr, count, B, mid, H, W, 0.f, beta2, 1.f, nullptr, out, s);
    case MODE_BF16: return (int)launch_conv_gemm<MODE_BF16, 1, IN_ID, EPI_SWISH>(fh, nullptr, bias, mid, mid, inp, nullptr, nullptr, count, B, mid, H, W, 0.f, beta2, 1.f, nullptr, out, s);
    case MODE_TF32: return (int)launch_tc_conv1x1<EPI_SWISH, IN_ID, 3>(wh, mid, mid, inp, B, 1, H * W, no_scale, out, s, nullptr, count, nullptr, nullptr, bias, wl, beta2);
    case MODE_TF32X: return (int)launch_tc_conv1x1<EPI_SWISH, IN_ID, 4>(wh, mid, mid, inp, B, 1, H * W, no_scale, out, s, nullptr, count, nullptr, nullptr, bias, wl, beta2);
  }
  return (int)cudaErrorInvalidValue;
}

// w_hi / w_lo: W3's split, bfloat16 in the tile layout in modes tf32 /
// tf32x (the tensor cores' operands, cast once per solve; each band's
// output tiles over `groups` blocks), float32 OIHW in modes f32 / bf16 (the
// CUDA cores; w_lo unused there, and groups)
int imnf_conv3x3_out(int mode, const void* w_hi, const void* w_lo,
                     const float* bias, const float* t2, const int* idx,
                     const int* count, int B, int C, int mid, int H, int W,
                     const float* base, float sgn, const float* sub,
                     float* out, int groups, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* fh = static_cast<const float*>(w_hi);
  const float* fl = static_cast<const float*>(w_lo);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w_hi);
  const __nv_bfloat16* wl = static_cast<const __nv_bfloat16*>(w_lo);
  switch (mode) {
    case MODE_F32: return (int)launch_conv3x3_out<MODE_F32, IN_ID>(fh, fl, bias, t2, nullptr, 0.f, idx, count, B, C, mid, H, W, base, sgn, nullptr, sub, out, s);
    case MODE_BF16: return (int)launch_conv3x3_out<MODE_BF16, IN_ID>(fh, fl, bias, t2, nullptr, 0.f, idx, count, B, C, mid, H, W, base, sgn, nullptr, sub, out, s);
    case MODE_TF32: return (int)conv3x3_out_tc_solve(3, groups, wh, wl, bias, t2, idx, count, B, C, mid, H, W, base, sgn, sub, out, s);
    case MODE_TF32X: return (int)conv3x3_out_tc_solve(4, groups, wh, wl, bias, t2, idx, count, B, C, mid, H, W, base, sgn, sub, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

int imnf_broyden_step(int phase, const int* idx_in, const int* cnt_in,
                      int* idx_out, int* cnt_out, float* Z, float* G,
                      float* UPD, float* ZN, const float* GN, float* BZ,
                      float* BG, float* U, float* V, int* istate,
                      float* fstate, int B, int D, int K, float eps, int cap,
                      int patience, float rtol, float guard_eps, int newton,
                      void* stream) {
  if (K > KMAX) return (int)cudaErrorInvalidValue;
  broyden_step_kernel<<<B, STEP_THREADS, 0, (cudaStream_t)stream>>>(
      phase, idx_in, cnt_in, idx_out, cnt_out, Z, G, UPD, ZN, GN, BZ, BG, U, V,
      istate, fstate, D, K, eps, cap, patience, rtol, guard_eps, newton);
  return (int)cudaGetLastError();
}

}  // extern "C"
