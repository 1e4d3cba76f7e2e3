// Forward per-tile alpha composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel soar_tpu/render/block_composite.py
// `_fwd_kernel` (launched by `_make_fused._fwd_call`, entry point
// `composite_block`).  Same function: for every 16x16 tile and each of its
// P pixels, walk the tile's K depth-sorted slots front to back with the
// reference rules (forward.cu:497-633):
//   alpha = min(0.99, opacity * exp(min(power, 0)));
//   a slot is skipped when power > 0, alpha < 1/255 or it is invalid;
//   the first slot that would push T below 1e-4 and every slot after it
//   are excluded (sticky early stop).
// Outputs accum[c] = sum w*attr_c, corr = sum w*(dx*e0 + dy*e1) (the
// per-pixel-depth plane correction the caller subtracts) and the final T.
//
// What bounds it on an H100: f32 ALU work and one expf per pixel-slot pair
// actually walked (up to NT*P*K = 25M pairs at the 512x512, K=96 render)
// against ~18 MB of input and output at that shape (~5 us at 3.35 TB/s):
// it is operation-bound, and on the renderer's real tile lists, where a few
// full tiles hold all the splats, the latency of those few blocks sets its
// time.  What the design does about it:
//   - A per-tile slot bound n (1 + the last valid slot, composite_common.cuh
//     slot_bound): only rows [0, n) are staged and walked, and a tile with
//     no valid slot writes accum 0, corr 0, T 1 and leaves at once.
//   - One block per tile, one thread per pixel (two pixels a thread were
//     slower on the real tile lists, where one block's latency sets the
//     time).  After the staging barrier no block barrier is left: each warp
//     walks on its own and leaves once all its pixels have stopped
//     (__all_sync).
//   - Slots in groups of kGroup (8; 4 was a little slower and spilled at
//     C = 14, 15): the T-independent part of each slot of the group
//     (splat_eval: offsets, power, expf, alpha, the skip tests, without a
//     branch) runs first, into registers, so the group's expf and loads
//     overlap; then the sequential part (stop test, w, the sums, T) in slot
//     order, with selects instead of branches.  Per pixel the operations
//     and their order are the ones of a slot-by-slot walk, so colour,
//     normal and T stay bit-equal to composite_tiles.cu's.
//   - Rows padded to a multiple of 4 floats in shared memory and read as
//     float4 (a broadcast: every thread reads the same row).
// The TPU kernel's log-space triangular-matmul cumprod and MXU pixel sums
// were workarounds for Mosaic and are not carried over: T is the plain
// sequential product, as in the reference's CUDA loop.
//
// The per-slot arithmetic (alpha, the skip tests, the T update) lives in
// composite_common.cuh, which the backward kernel (composite_bwd.cu) and the
// tile-list kernel (composite_tiles.cu) include too, so all reach the same
// masks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  Plain C entry
// point for ctypes; it returns cudaGetLastError() after the launch.
// Shared memory: K * FP floats of rows and kMaxWarps ints, dynamic, opted
// into up to 227 KB (render/block_composite.py::fwd_smem_bytes mirrors it).

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace soar;

// Slots evaluated together before their sequential part.
constexpr int kGroup = 8;

template <int C>
__global__ void __launch_bounds__(kMaxPixels)
composite_fwd_kernel(const float* __restrict__ feat,  // [NT, K, 9 + C]
                     const float* __restrict__ pixf,  // [NT, P, 2]
                     float* __restrict__ accum,       // [NT, C, P]
                     float* __restrict__ corr,        // [NT, P]
                     float* __restrict__ t_out,       // [NT, P]
                     int K, int P, float alpha_clamp, float alpha_min,
                     float t_min) {
  constexpr int F = kAttr + C;
  constexpr int FP = padded_row(F);
  extern __shared__ float4 smem4[];
  float4* s_rows = smem4;                                    // [K][FP / 4]
  int* s_warp = reinterpret_cast<int*>(smem4 + K * (FP / 4));  // [kMaxWarps]
  const int tile = blockIdx.x;

  // This thread's pixel; one past P (a partial last warp) walks as a pixel
  // that stopped and writes nothing.
  const int pix = threadIdx.x;
  bool done = pix >= P;
  const size_t q = static_cast<size_t>(tile) * P + (done ? 0 : pix);
  const float px = pixf[2 * q];
  const float py = pixf[2 * q + 1];

  const float* src = feat + static_cast<size_t>(tile) * K * F;
  const int n = slot_bound(src, K, F, s_warp);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float cr = 0.f, T = 1.f;

  if (n > 0) {
    stage_rows<F>(reinterpret_cast<float*>(s_rows), src, n);
    __syncthreads();
  }

  for (int k0 = 0; k0 < n; k0 += kGroup) {
    if (__all_sync(kFullMask, done)) break;  // uniform across the warp

    // The T-independent part of the group's slots.
    Splat s[kGroup];
    bool keep[kGroup];
    float e0[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const bool in = k0 + g < n;
      const Head h = load_head(s_rows + min(k0 + g, n - 1) * (FP / 4));
      e0[g] = h.f[kE];
      keep[g] = splat_eval(h.f, px, py, alpha_clamp, alpha_min, s[g]) & in;
    }
    // The sequential part, slot by slot; a slot the pixel does not blend
    // leaves its sums and T as they were (selects, no branch).
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const Tail<FP> tl = load_tail<FP>(s_rows + min(k0 + g, n - 1) * (FP / 4));
      const float e1 = tl.f[kE + 1 - 8];
      const Splat& sg = s[g];
      const bool blend = keep[g] & !done;
      const float t_next = t_after(T, sg.alpha);
      const bool stop = t_next < t_min;
      done |= blend & stop;
      const bool use = blend & !stop;
      const float w = sg.alpha * T;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float a = acc[c] + w * tl.f[kAttr - 8 + c];
        acc[c] = use ? a : acc[c];
      }
      const float r = cr + w * (sg.dx * e0[g] + sg.dy * e1);
      cr = use ? r : cr;
      T = use ? t_next : T;
    }
  }

  if (pix >= P) return;
  float* out = accum + static_cast<size_t>(tile) * C * P + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) out[static_cast<size_t>(c) * P] = acc[c];
  corr[q] = cr;
  t_out[q] = T;
}

template <int C>
int launch(const float* feat, const float* pixf, float* accum, float* corr,
           float* t_out, int NT, int K, int P, float alpha_clamp,
           float alpha_min, float t_min, cudaStream_t stream) {
  // Once per instance: allow up to the opt-in limit of dynamic shared memory.
  static const cudaError_t opted = cudaFuncSetAttribute(
      composite_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptin);
  if (opted != cudaSuccess) return opted;
  constexpr int FP = padded_row(kAttr + C);
  const size_t smem = (static_cast<size_t>(K) * FP + kMaxWarps) * sizeof(float);
  const int threads = (P + 31) / 32 * 32;
  composite_fwd_kernel<C><<<NT, threads, smem, stream>>>(
      feat, pixf, accum, corr, t_out, K, P, alpha_clamp, alpha_min, t_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int composite_fwd(const float* feat, const float* pixf,
                             float* accum, float* corr, float* t_out, int NT,
                             int K, int P, int C, float alpha_clamp,
                             float alpha_min, float t_min, void* stream) {
  if (NT <= 0) return 0;
  if (P <= 0 || P > kMaxPixels || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define SOAR_CASE(n)                                                        \
  case n:                                                                   \
    return launch<n>(feat, pixf, accum, corr, t_out, NT, K, P, alpha_clamp, \
                     alpha_min, t_min, s);
    SOAR_CASE(1) SOAR_CASE(2) SOAR_CASE(3) SOAR_CASE(4)
    SOAR_CASE(5) SOAR_CASE(6) SOAR_CASE(7) SOAR_CASE(8)
    SOAR_CASE(9) SOAR_CASE(10) SOAR_CASE(11) SOAR_CASE(12)
    SOAR_CASE(13) SOAR_CASE(14) SOAR_CASE(15) SOAR_CASE(16)
#undef SOAR_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
