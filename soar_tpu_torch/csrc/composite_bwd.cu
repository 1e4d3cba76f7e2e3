// Backward of the per-tile alpha composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel soar_tpu/render/block_composite.py
// `_bwd_kernel` (launched by `_make_fused._bwd_call`, the custom VJP
// `fused_bwd` of `composite_block`).  Same function: given the forward's
// inputs and the cotangents of its outputs (gacc [C, P], gcorr [P] and gT [P]
// per tile), it returns the gradient of every slot's packed features,
// summed over the tile's pixels:
//
//   w_k = alpha_k t_k,  t_k = prod_{j<k} (1 - alpha_j),  T = prod_j (1 - alpha_j)
//   gw_k = sum_c gacc_c attr_kc + gcorr (dx e0 + dy e1)
//   dL/dalpha_k = gw_k t_k - (S_k + gT T) / (1 - alpha_k),  S_k = sum_{j>k} gw_j w_j
//
// over the slots the forward blended (the skip and stop masks are constants,
// as XLA's autodiff treats them), then through the 0.99 clamp and
// exp(min(power, 0)) to xy, conic (a, b, c), opacity, e and attrs.  The
// `valid` column's gradient is zero.
//
// Design: one block per tile, one thread per pixel; the tile's K slot rows
// are staged in shared memory as in the forward, and a pixel's gacc[C],
// gcorr and gT live in registers.  Two walks front to back, both through
// the forward's own per-slot code (composite_common.cuh), so they reach the
// masks the forward kernel reached:
//   pass 1 gives T_final and G = sum_k gw_k w_k over the blended slots;
//   pass 2 keeps the running exclusive T and the prefix P_k = sum_{j<=k}
//   gw_j w_j, takes S_k = G - P_k, and chains dL/dalpha_k down to the slot's
//   features.
// Walking front to back twice avoids recovering T by division in a walk
// from the back (as 3DGS's backward.cu does), which drifts from the
// forward's product.  The price is the cancellation in G - P_k: its error
// is about one float32 ulp of |G|, divided by 1 - alpha_k >= 0.01.
// Per-slot sums over the pixels: a __shfl_down_sync reduction within each
// warp, the warps' partials combined through shared memory, and one thread
// per feature column writes gfeat[tile, k, :].  A tile owns its slots, so
// there are no atomics and the result does not depend on scheduling.  A
// slot that no pixel of the tile blended is written as zeros without a
// reduction, and the block leaves both walks once every pixel has stopped.
// The TPU kernel's log-space triangular matmuls (_prefix_mm) and its
// [1, P] @ [P, G*K] pixel sums (_pix_sum_many) were Mosaic workarounds and
// are not carried over.
//
// What bounds it on an H100: the f32 work of two forward walks plus the
// gradient chain (about 60 operations and two expf per blended pixel-slot
// pair, 8 + C warp reductions per slot that some pixel blended), against
// its I/O: at NT = 1024, K = 64, C = 7 it reads feat (4.2 MB), gacc (7.3 MB),
// gcorr, gT and pixf (4.2 MB) and writes gfeat (4.2 MB) once, ~6 us at
// 3.35 TB/s.  It is operation- and barrier-bound.  Making it fast (several
// pixels per thread, a count bound per tile, fewer barriers, fewer
// reductions per slot) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  Plain C entry
// point for ctypes; it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace soar;

constexpr int kMaxWarps = kMaxPixels / 32;

// Column of gfeat for the g-th reduced gradient: the valid column (6) is
// skipped, it is written as zero.
__device__ __forceinline__ int grad_column(int g) { return g < kValid ? g : g + 1; }

template <int C>
__device__ __forceinline__ float grad_w(const float* f, const Splat& s,
                                        const float (&ga)[C], float gc) {
  float gw = gc * (s.dx * f[kE] + s.dy * f[kE + 1]);
#pragma unroll
  for (int c = 0; c < C; ++c) gw += ga[c] * f[kAttr + c];
  return gw;
}

template <int C>
__global__ void __launch_bounds__(kMaxPixels)
composite_bwd_kernel(const float* __restrict__ feat,   // [NT, K, 9 + C]
                     const float* __restrict__ pixf,   // [NT, P, 2]
                     const float* __restrict__ gacc,   // [NT, C, P]
                     const float* __restrict__ gcorr,  // [NT, P]
                     const float* __restrict__ gT,     // [NT, P]
                     float* __restrict__ gfeat,        // [NT, K, 9 + C]
                     int K, int P, float alpha_clamp, float alpha_min,
                     float t_min) {
  constexpr int F = kAttr + C;
  constexpr int G = F - 1;  // reduced gradients per slot (all but `valid`)
  extern __shared__ float smem[];
  float* s_feat = smem;          // [K * F]
  float* s_part = smem + K * F;  // [warps * G] per-warp partial sums
  const int tile = blockIdx.x;
  const int nthreads = blockDim.x;  // P rounded up to a whole warp
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = nthreads >> 5;

  const float* src = feat + static_cast<size_t>(tile) * K * F;
  for (int i = p; i < K * F; i += nthreads) s_feat[i] = src[i];
  __syncthreads();

  // Threads past P (a partial last warp) walk as pixels that stopped.
  const bool live = p < P;
  const size_t pix = static_cast<size_t>(tile) * P + p;
  float px = 0.f, py = 0.f, gc = 0.f, gt = 0.f;
  float ga[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ga[c] = 0.f;
  if (live) {
    px = pixf[2 * pix];
    py = pixf[2 * pix + 1];
    gc = gcorr[pix];
    gt = gT[pix];
    const float* g_in = gacc + static_cast<size_t>(tile) * C * P + p;
#pragma unroll
    for (int c = 0; c < C; ++c) ga[c] = g_in[static_cast<size_t>(c) * P];
  }

  // ---- pass 1: T_final and G = sum_k gw_k w_k over the blended slots
  float T = 1.f;
  bool done = !live;
  float g_total = 0.f;
  for (int k = 0; k < K; ++k) {
    if (__syncthreads_count(!done) == 0) break;  // uniform across the block
    if (done) continue;
    const float* f = s_feat + k * F;
    Splat s;
    if (!splat_eval(f, px, py, alpha_clamp, alpha_min, s)) continue;
    const float t_next = t_after(T, s.alpha);
    if (t_next < t_min) {
      done = true;
      continue;
    }
    const float w = s.alpha * T;
    g_total = __fmaf_rn(grad_w<C>(f, s, ga, gc), w, g_total);
    T = t_next;
  }
  const float gt_T = gt * T;  // gT * T_final

  // ---- pass 2: per-slot gradients, reduced over the tile's pixels
  float* out = gfeat + static_cast<size_t>(tile) * K * F;
  T = 1.f;
  done = !live;
  float prefix = 0.f;
  int k = 0;
  for (; k < K; ++k) {
    if (__syncthreads_count(!done) == 0) break;  // uniform across the block
    const float* f = s_feat + k * F;
    float g[G];
#pragma unroll
    for (int j = 0; j < G; ++j) g[j] = 0.f;
    bool active = false;
    Splat s;
    if (!done && splat_eval(f, px, py, alpha_clamp, alpha_min, s)) {
      const float t_next = t_after(T, s.alpha);
      if (t_next < t_min) {
        done = true;
      } else {
        active = true;
        const float w = s.alpha * T;
        const float gw = grad_w<C>(f, s, ga, gc);
        prefix = __fmaf_rn(gw, w, prefix);  // as g_total was summed
        const float suffix = g_total - prefix;  // S_k = sum_{j>k} gw_j w_j
        const float g_alpha = gw * T - (suffix + gt_T) / (1.f - s.alpha);
        const float g_u = (s.u < alpha_clamp) ? g_alpha : 0.f;
        const float g_pow = (s.power < 0.f) ? g_u * s.u : 0.f;
        const float g_op = g_u * expf(s.power);  // power <= 0 here
        const float ca = f[kConic], cb = f[kConic + 1], cc = f[kConic + 2];
        const float gcw = gc * w;
        g[0] = g_pow * -(ca * s.dx + cb * s.dy) + gcw * f[kE];
        g[1] = g_pow * -(cc * s.dy + cb * s.dx) + gcw * f[kE + 1];
        g[2] = g_pow * (-0.5f * s.dx * s.dx);
        g[3] = g_pow * (-s.dx * s.dy);
        g[4] = g_pow * (-0.5f * s.dy * s.dy);
        g[5] = g_op;
        g[6] = gcw * s.dx;  // e0
        g[7] = gcw * s.dy;  // e1
#pragma unroll
        for (int c = 0; c < C; ++c) g[8 + c] = w * ga[c];
        T = t_next;
      }
    }
    float* row = out + static_cast<size_t>(k) * F;
    if (__syncthreads_or(active) == 0) {  // no pixel blended this slot
      if (p < F) row[p] = 0.f;
      continue;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float v = g[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_part[warp * G + j] = v;
    }
    __syncthreads();
    if (p < G) {
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += s_part[w * G + p];
      row[grad_column(p)] = v;
    } else if (p == G) {
      row[kValid] = 0.f;
    }
    // s_part is next written after the barrier at the top of the loop.
  }
  // Slots past the block-wide stop get no gradient.
  for (int i = k * F + p; i < K * F; i += nthreads) out[i] = 0.f;
}

template <int C>
void launch(const float* feat, const float* pixf, const float* gacc,
           const float* gcorr, const float* gT, float* gfeat, int NT, int K,
           int P, float alpha_clamp, float alpha_min, float t_min,
           cudaStream_t stream) {
  constexpr int F = kAttr + C;
  const int threads = (P + 31) / 32 * 32;
  const size_t smem =
      (static_cast<size_t>(K) * F + static_cast<size_t>(kMaxWarps) * (F - 1)) *
      sizeof(float);
  composite_bwd_kernel<C><<<NT, threads, smem, stream>>>(
      feat, pixf, gacc, gcorr, gT, gfeat, K, P, alpha_clamp, alpha_min, t_min);
}

}  // namespace

extern "C" int composite_bwd(const float* feat, const float* pixf,
                             const float* gacc, const float* gcorr,
                             const float* gT, float* gfeat, int NT, int K,
                             int P, int C, float alpha_clamp, float alpha_min,
                             float t_min, void* stream) {
  if (NT <= 0) return 0;
  if (P <= 0 || P > kMaxPixels || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define SOAR_CASE(n)                                                         \
  case n:                                                                    \
    launch<n>(feat, pixf, gacc, gcorr, gT, gfeat, NT, K, P, alpha_clamp,     \
              alpha_min, t_min, s);                                          \
    break;
    SOAR_CASE(1) SOAR_CASE(2) SOAR_CASE(3) SOAR_CASE(4)
    SOAR_CASE(5) SOAR_CASE(6) SOAR_CASE(7) SOAR_CASE(8)
    SOAR_CASE(9) SOAR_CASE(10) SOAR_CASE(11) SOAR_CASE(12)
    SOAR_CASE(13) SOAR_CASE(14) SOAR_CASE(15) SOAR_CASE(16)
#undef SOAR_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
