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
// Two walks front to back, both through the forward's own per-slot code
// (composite_common.cuh), so they reach the masks the forward kernel
// reached:
//   pass 1 gives T_final, G = sum_k gw_k w_k over the blended slots and the
//   pixel's last blended slot;
//   pass 2 keeps the running exclusive T and the prefix P_k = sum_{j<=k}
//   gw_j w_j, takes S_k = G - P_k, and chains dL/dalpha_k down to the slot's
//   features.
// Walking front to back twice avoids recovering T by division in a walk
// from the back (as 3DGS's backward.cu does), which drifts from the
// forward's product.  The price is the cancellation in G - P_k: its error
// is about one float32 ulp of |G|, divided by 1 - alpha_k >= 0.01.  gw is
// summed with explicit FMAs in both passes, so P_k at a pixel's last
// blended slot is G to the bit.
//
// What bounds it on an H100: the f32 work of two walks (an expf each per
// evaluated pixel-slot pair) plus the gradient chain (about 60 operations
// per blended pair, which reuses pass 2's expf) and
// the per-slot sums of 8 + C gradients over the tile's pixels, against its
// I/O: at NT = 1024, K = 64, C = 7 it reads feat (4.2 MB), gacc (7.3 MB),
// gcorr, gT and pixf (4.2 MB) and writes gfeat (4.2 MB) once, ~6 us at
// 3.35 TB/s.  It is operation-bound, and on the renderer's real tile lists
// the latency of the few full tiles sets its time.  What the design does:
//   - A per-tile slot bound n (1 + the last valid slot, composite_common.cuh
//     slot_bound): only rows [0, n) are staged and walked, rows [n, K) of
//     gfeat are written as zeros, and a tile with no valid slot writes a
//     zero gfeat tile and leaves at once.
//   - One block per tile, one thread per pixel (with two pixels a thread
//     one butterfly serves 64 pixels, but the real tile lists ran 1.5x
//     slower).  After the staging barrier no block barrier is left inside a
//     walk: each warp walks on its own, leaves pass 1 once all its pixels
//     have stopped (__all_sync), and ends pass 2 after the last slot any of
//     its pixels blended.
//   - Slots in groups (kGroup1 = 4 in pass 1, kGroup2 = 1 in pass 2, whose
//     gradient chain needs the registers; 2 and 4 spilled at some C and
//     were no faster): splat_eval of the group's slots first, without a
//     branch, then the sequential part in slot order with selects, so the
//     group's expf and loads overlap; per pixel the operations and their
//     order are unchanged.
//   - Per-slot pixel sums without block barriers: a warp in which no pixel
//     blended the slot skips it; otherwise the warp sums its 8 + C values
//     with a transposed butterfly (each shuffle step halves the values a
//     lane carries: 16 shuffles for up to 16 values, 25 for up to 24 in two
//     parts, against 5 per value) and writes one partial row to shared memory
//     (s_part[warp][k][0:8+C]).  After the walk, one barrier; the block then
//     adds each (slot, column) over the warps in warp order, reading a warp's
//     rows only below its last blended slot, and writes gfeat with
//     neighbouring threads on neighbouring columns.  A tile owns its slots:
//     no atomics, a fixed summation order, bit-equal results from launch to
//     launch.
//   - Rows padded to a multiple of 4 floats in shared memory, read as
//     float4 broadcasts.
// The TPU kernel's log-space triangular matmuls (_prefix_mm) and its
// [1, P] @ [P, G*K] pixel sums (_pix_sum_many) were Mosaic workarounds and
// are not carried over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  Plain C entry
// point for ctypes; it returns cudaGetLastError() after the launch.
// Shared memory: K * FP floats of rows, warps * K * (8 + C) floats of
// partial sums and 2 * kMaxWarps ints, dynamic, opted into up to 227 KB
// (render/block_composite.py::bwd_smem_bytes mirrors it).

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace soar;

// Slots evaluated together before their sequential part, in pass 1 and in
// pass 2.
constexpr int kGroup1 = 4;
constexpr int kGroup2 = 1;

// gw = gcorr (dx e0 + dy e1) + sum_c gacc_c attr_c, with explicit rounding
// so both passes form it identically.
template <int C, int FP>
__device__ __forceinline__ float grad_w(const Splat& s, float e0,
                                        const Tail<FP>& tl, const float (&ga)[C],
                                        float gc) {
  float gw = __fmul_rn(gc, __fmaf_rn(s.dy, tl.f[kE + 1 - 8], __fmul_rn(s.dx, e0)));
#pragma unroll
  for (int c = 0; c < C; ++c) gw = __fmaf_rn(ga[c], tl.f[kAttr - 8 + c], gw);
  return gw;
}

// One transposed-butterfly step over lane bit OFF: a lane keeps the lower
// or upper H of its 2H values and adds its partner's copy of them.  The
// steps recurse down to one value a lane; `idx` collects which one.
template <int H, int OFF, int N>
__device__ __forceinline__ void butterfly(float (&x)[N], int lane, int& idx) {
  if constexpr (H > 0) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = upper ? x[j] : x[j + H];
      const float keep = upper ? x[j + H] : x[j];
      x[j] = keep + __shfl_xor_sync(kFullMask, send, OFF);
    }
    if (upper) idx += H;
    butterfly<H / 2, OFF / 2>(x, lane, idx);
  }
}

// Sums the N <= 16 values v[0..N) over the warp's 32 lanes and writes sum
// j to dst[j].  The values are padded to NP = 8 or 16; the butterfly over
// lane bits 16 .. 32/NP leaves lane L with value idx(L) summed over those
// lanes, xor steps over the lower lane bits complete it (the lanes that
// differ only there then hold the same sum; the one with those bits 0
// writes).
template <int N>
__device__ __forceinline__ void warp_sum_part(const float* v, int lane,
                                              float* __restrict__ dst) {
  constexpr int NP = N <= 8 ? 8 : 16;
  float x[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) x[j] = j < N ? v[j] : 0.f;
  int idx = 0;
  butterfly<NP / 2, 16>(x, lane, idx);
#pragma unroll
  for (int off = 16 / NP; off > 0; off >>= 1) x[0] += __shfl_xor_sync(kFullMask, x[0], off);
  if (idx < N && (lane & (32 / NP - 1)) == 0) dst[idx] = x[0];
}

// Sums the G = 8 + C <= 24 values v over the warp's lanes into dst[0..G):
// the first 16, then the rest, so that at most 16 are carried through a
// butterfly (15 + 1 shuffles for up to 16 values, 15 + 1 + 7 + 2 for up to
// 24).
template <int G>
__device__ __forceinline__ void warp_sum_row(const float (&v)[G], int lane,
                                             float* __restrict__ dst) {
  if constexpr (G <= 16) {
    warp_sum_part<G>(v, lane, dst);
  } else {
    warp_sum_part<16>(v, lane, dst);
    warp_sum_part<G - 16>(v + 16, lane, dst + 16);
  }
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
  constexpr int FP = padded_row(F);
  constexpr int G = F - 1;  // reduced gradients per slot (all but `valid`)
  const int nthreads = blockDim.x;  // P rounded up to whole warps
  const int nwarps = nthreads >> 5;
  extern __shared__ float4 smem4[];
  float4* s_rows = smem4;                                              // [K][FP / 4]
  float* s_part = reinterpret_cast<float*>(smem4 + K * (FP / 4));       // [nwarps][K][G]
  int* s_warp = reinterpret_cast<int*>(s_part + nwarps * K * G);        // [kMaxWarps]
  int* s_kend = s_warp + kMaxWarps;                                      // [kMaxWarps]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* src = feat + static_cast<size_t>(tile) * K * F;
  float* out = gfeat + static_cast<size_t>(tile) * K * F;
  const int n = slot_bound(src, K, F, s_warp);
  if (n == 0) {  // no valid slot: a zero gfeat tile
    for (int i = threadIdx.x; i < K * F; i += nthreads) out[i] = 0.f;
    return;
  }
  stage_rows<F>(reinterpret_cast<float*>(s_rows), src, n);

  // This thread's pixel; one past P (a partial last warp) walks as a pixel
  // that stopped and contributes zeros.
  const int p = threadIdx.x;
  const bool live = p < P;
  float px = 0.f, py = 0.f, gc = 0.f, gt = 0.f, ga[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ga[c] = 0.f;
  if (live) {
    const size_t q = static_cast<size_t>(tile) * P + p;
    px = pixf[2 * q];
    py = pixf[2 * q + 1];
    gc = gcorr[q];
    gt = gT[q];
    const float* g_in = gacc + static_cast<size_t>(tile) * C * P + p;
#pragma unroll
    for (int c = 0; c < C; ++c) ga[c] = g_in[static_cast<size_t>(c) * P];
  }
  __syncthreads();  // the staged rows

  // ---- pass 1: T_final, G = sum_k gw_k w_k over the blended slots, and
  // 1 + the last blended slot
  float T = 1.f, g_total = 0.f;
  bool done = !live;
  int kend = 0;
  for (int k0 = 0; k0 < n; k0 += kGroup1) {
    if (__all_sync(kFullMask, done)) break;  // uniform across the warp
    Splat s[kGroup1];
    bool keep[kGroup1];
    float e0[kGroup1];
#pragma unroll
    for (int g = 0; g < kGroup1; ++g) {
      const bool in = k0 + g < n;
      const Head h = load_head(s_rows + min(k0 + g, n - 1) * (FP / 4));
      e0[g] = h.f[kE];
      keep[g] = splat_eval(h.f, px, py, alpha_clamp, alpha_min, s[g]) & in;
    }
#pragma unroll
    for (int g = 0; g < kGroup1; ++g) {
      const Tail<FP> tl = load_tail<FP>(s_rows + min(k0 + g, n - 1) * (FP / 4));
      const Splat& sg = s[g];
      const bool blend = keep[g] & !done;
      const float t_next = t_after(T, sg.alpha);
      const bool stop = t_next < t_min;
      done |= blend & stop;
      const bool use = blend & !stop;
      const float w = sg.alpha * T;
      const float gw = grad_w<C, FP>(sg, e0[g], tl, ga, gc);
      g_total = use ? __fmaf_rn(gw, w, g_total) : g_total;
      T = use ? t_next : T;
      kend = use ? k0 + g + 1 : kend;
    }
  }
  const float gt_T = gt * T;  // gT * T_final
  kend = __reduce_max_sync(kFullMask, kend);  // the warp's pass-2 end
  if (lane == 0) s_kend[warp] = kend;

  // ---- pass 2: per-slot gradients, summed over the warp's pixels
  T = 1.f;
  done = !live;
  float prefix = 0.f;
  float* part = s_part + static_cast<size_t>(warp) * K * G;
  for (int k0 = 0; k0 < kend; k0 += kGroup2) {
    Splat s[kGroup2];
    bool keep[kGroup2];
    float e0[kGroup2], ca[kGroup2], cb[kGroup2], cc[kGroup2];
#pragma unroll
    for (int g = 0; g < kGroup2; ++g) {
      const bool in = k0 + g < kend;
      const Head h = load_head(s_rows + min(k0 + g, n - 1) * (FP / 4));
      e0[g] = h.f[kE];
      ca[g] = h.f[kConic];
      cb[g] = h.f[kConic + 1];
      cc[g] = h.f[kConic + 2];
      keep[g] = splat_eval(h.f, px, py, alpha_clamp, alpha_min, s[g]) & in;
    }
#pragma unroll
    for (int g = 0; g < kGroup2; ++g) {
      const int k = k0 + g;
      if (k >= kend) break;  // uniform across the warp
      const Splat& sg = s[g];
      const bool blend = keep[g] & !done;
      const float t_next = t_after(T, sg.alpha);
      const bool stop = t_next < t_min;
      done |= blend & stop;
      const bool use = blend & !stop;
      float* row = part + k * G;
      if (__any_sync(kFullMask, use)) {  // uniform across the warp
        const Tail<FP> tl = load_tail<FP>(s_rows + k * (FP / 4));
        const float w = sg.alpha * T;
        const float gw = grad_w<C, FP>(sg, e0[g], tl, ga, gc);
        const float pre = __fmaf_rn(gw, w, prefix);  // as g_total was summed
        prefix = use ? pre : prefix;
        const float suffix = g_total - pre;  // S_k = sum_{j>k} gw_j w_j
        const float g_alpha = gw * T - (suffix + gt_T) / (1.f - sg.alpha);
        const float g_u = (sg.u < alpha_clamp) ? g_alpha : 0.f;
        const float g_pow = (sg.power < 0.f) ? g_u * sg.u : 0.f;
        const float g_op = g_u * sg.e;
        const float gcw = gc * w;
        float v[G];
        v[0] = g_pow * -(ca[g] * sg.dx + cb[g] * sg.dy) + gcw * e0[g];
        v[1] = g_pow * -(cc[g] * sg.dy + cb[g] * sg.dx) + gcw * tl.f[kE + 1 - 8];
        v[2] = g_pow * (-0.5f * sg.dx * sg.dx);
        v[3] = g_pow * (-sg.dx * sg.dy);
        v[4] = g_pow * (-0.5f * sg.dy * sg.dy);
        v[5] = g_op;
        v[6] = gcw * sg.dx;  // e0
        v[7] = gcw * sg.dy;  // e1
#pragma unroll
        for (int c = 0; c < C; ++c) v[8 + c] = w * ga[c];
        // A pixel that does not blend the slot adds nothing (a select: its
        // values may be inf or NaN).
#pragma unroll
        for (int m = 0; m < G; ++m) v[m] = use ? v[m] : 0.f;
        warp_sum_row<G>(v, lane, row);
      } else if (lane < G) {
        row[lane] = 0.f;  // no pixel of the warp blended this slot
      }
      T = use ? t_next : T;
    }
  }
  __syncthreads();  // every warp's partial rows and s_kend

  // ---- gfeat rows: each (slot, column) summed over the warps in warp order
  for (int i = threadIdx.x; i < K * F; i += nthreads) {
    const int k = i / F;
    const int col = i - k * F;
    float acc = 0.f;
    if (k < n && col != kValid) {
      const int m = col < kValid ? col : col - 1;
      for (int w = 0; w < nwarps; ++w)
        if (k < s_kend[w]) acc += s_part[(static_cast<size_t>(w) * K + k) * G + m];
    }
    out[i] = acc;
  }
}

template <int C>
int launch(const float* feat, const float* pixf, const float* gacc,
           const float* gcorr, const float* gT, float* gfeat, int NT, int K,
           int P, float alpha_clamp, float alpha_min, float t_min,
           cudaStream_t stream) {
  // Once per instance: allow up to the opt-in limit of dynamic shared memory.
  static const cudaError_t opted = cudaFuncSetAttribute(
      composite_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptin);
  if (opted != cudaSuccess) return opted;
  constexpr int F = kAttr + C;
  const int threads = (P + 31) / 32 * 32;
  const size_t smem =
      (static_cast<size_t>(K) * (padded_row(F) + (threads / 32) * (F - 1)) +
       2 * kMaxWarps) * sizeof(float);
  composite_bwd_kernel<C><<<NT, threads, smem, stream>>>(
      feat, pixf, gacc, gcorr, gT, gfeat, K, P, alpha_clamp, alpha_min, t_min);
  return static_cast<int>(cudaGetLastError());
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
    return launch<n>(feat, pixf, gacc, gcorr, gT, gfeat, NT, K, P,           \
                     alpha_clamp, alpha_min, t_min, s);
    SOAR_CASE(1) SOAR_CASE(2) SOAR_CASE(3) SOAR_CASE(4)
    SOAR_CASE(5) SOAR_CASE(6) SOAR_CASE(7) SOAR_CASE(8)
    SOAR_CASE(9) SOAR_CASE(10) SOAR_CASE(11) SOAR_CASE(12)
    SOAR_CASE(13) SOAR_CASE(14) SOAR_CASE(15) SOAR_CASE(16)
#undef SOAR_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
