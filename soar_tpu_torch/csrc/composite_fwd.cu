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
// Design: one block per tile, one thread per pixel.  The tile's K slot rows
// (K x (9+C) floats, ~6 KB at K=96, C=7) are staged once into shared
// memory, where every thread reads the same row at the same time
// (a broadcast).  Each thread keeps its running T, the sticky `done` flag,
// C channel sums and `corr` in registers, and the block leaves the slot
// loop as soon as every pixel is done (__syncthreads_count).  The TPU
// kernel's log-space triangular-matmul cumprod and MXU pixel sums were
// workarounds for Mosaic and are not carried over: T is the plain
// sequential product, as in the reference's CUDA loop.
//
// What bounds it on an H100: f32 ALU work and one expf per pixel-slot pair
// actually walked (up to NT*P*K = 25M pairs at the 512x512, K=96 render),
// against ~18 MB of input and output at that shape (~5 us at 3.35 TB/s).
// It is operation-bound; making it fast (fewer barriers, several pixels per
// thread, skipping the invalid tail) is later work.
//
// The per-slot arithmetic (alpha, the skip tests, the T update) lives in
// composite_common.cuh, which the backward kernel (composite_bwd.cu)
// includes too, so both walks reach the same masks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  Plain C entry
// point for ctypes; it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace soar;

template <int C>
__global__ void __launch_bounds__(kMaxPixels)
composite_fwd_kernel(const float* __restrict__ feat,  // [NT, K, 9 + C]
                     const float* __restrict__ pixf,  // [NT, P, 2]
                     float* __restrict__ accum,       // [NT, C, P]
                     float* __restrict__ corr,        // [NT, P]
                     float* __restrict__ t_out,       // [NT, P]
                     int K, float alpha_clamp, float alpha_min, float t_min) {
  constexpr int F = kAttr + C;
  extern __shared__ float s_feat[];
  const int tile = blockIdx.x;
  const int P = blockDim.x;
  const int p = threadIdx.x;

  const float* src = feat + static_cast<size_t>(tile) * K * F;
  for (int i = p; i < K * F; i += P) s_feat[i] = src[i];
  __syncthreads();

  const size_t pix = static_cast<size_t>(tile) * P + p;
  const float px = pixf[2 * pix];
  const float py = pixf[2 * pix + 1];

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float cr = 0.f;
  float T = 1.f;
  bool done = false;

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
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += w * f[kAttr + c];
    cr += w * (s.dx * f[kE] + s.dy * f[kE + 1]);
    T = t_next;
  }

  float* out = accum + static_cast<size_t>(tile) * C * P + p;
#pragma unroll
  for (int c = 0; c < C; ++c) out[static_cast<size_t>(c) * P] = acc[c];
  corr[pix] = cr;
  t_out[pix] = T;
}

template <int C>
void launch(const float* feat, const float* pixf, float* accum, float* corr,
            float* t_out, int NT, int K, int P, float alpha_clamp,
            float alpha_min, float t_min, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * (kAttr + C) * sizeof(float);
  composite_fwd_kernel<C><<<NT, P, smem, stream>>>(
      feat, pixf, accum, corr, t_out, K, alpha_clamp, alpha_min, t_min);
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
    launch<n>(feat, pixf, accum, corr, t_out, NT, K, P, alpha_clamp,        \
              alpha_min, t_min, s);                                         \
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
