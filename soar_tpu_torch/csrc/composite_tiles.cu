// Count-bounded per-tile alpha composite over gathered tile lists, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel soar_tpu/render/pallas_composite.py
// `_make_kernel` (launched by `composite_tiles_pallas`).  Same function: for
// every tile, walk its first min(count, K) slots front to back and, for each
// of the tile's P = tile*tile pixels, apply the reference rules
// (forward.cu:497-633):
//   alpha = min(0.99, opacity * exp(min(power, 0)));
//   a slot is skipped when power > 0, alpha < 1/255 or it is invalid;
//   the first slot that would push T below 1e-4 and every slot after it
//   are excluded (sticky early stop).
// Outputs the weighted sums of colour [NT, P, 3], normal [NT, P, 3] and
// depth [NT, P], and the final transmittance T [NT, P] (not 1 - T).  With
// perpix_depth the depth of a slot at a pixel is its plane-corrected depth,
//   depth - ((dx j0 + dy j1) j6 + (dx j2 + dy j3) j9),
// from columns [0, 1, 2, 3, 6, 9] of the slot's 10-float `jinv`.  A tile
// with count 0 returns zeros and T = 1.  Forward only: the TPU kernel has no
// gradient either.
//
// Design: one block per tile, one thread per pixel.  The tile's count is
// read once; only the slots below it are staged, each input array with its
// own coalesced loop, into one 20-float record per slot in shared memory
// whose first seven floats are laid out as composite_common.cuh's slot row
// (xy, conic, opacity, valid), so the mask-deciding arithmetic is the very
// function composite_fwd.cu and composite_bwd.cu call and all three kernels
// stop the same pixels at the same slots.  Every thread then reads the same
// record at the same time (a broadcast), keeps T, the sticky `done` flag and
// the seven sums in registers, and the block leaves the walk once every
// pixel is done (__syncthreads_and); the exit is uniform and changes no
// value, since a done pixel adds nothing.  The TPU kernel's scalar-prefetch
// counts and per-splat VMEM loads have no counterpart here.
//
// What bounds it on an H100: like composite_fwd it does f32 ALU work and one
// expf per pixel-slot pair actually walked, against 93 bytes per staged slot
// and 32 bytes per pixel written; at the render's shapes (NT=1024, K=96) the
// two bounds are within a factor of two of each other, a few microseconds.
// One barrier per slot keeps it far from both; making it fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  Plain C entry
// point for ctypes; it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace soar;

// Slot record in shared memory; 0..6 as composite_common.cuh's slot row.
constexpr int kColor = 7;
constexpr int kNormal = 10;
constexpr int kDepth = 13;
constexpr int kJinv = 14;  // j0, j1, j2, j3, j6, j9
constexpr int kRecord = 20;

// Copies rows [0, n) of `src` (row stride `stride`, `width` columns taken
// from column `col0`) to columns [dst0, dst0 + width) of the records.
__device__ __forceinline__ void stage(float* rec, const float* __restrict__ src,
                                      int n, int stride, int col0, int width,
                                      int dst0) {
  for (int i = threadIdx.x; i < n * width; i += blockDim.x) {
    const int k = i / width, c = i - k * width;
    rec[k * kRecord + dst0 + c] = src[k * stride + col0 + c];
  }
}

template <bool kPerPixDepth>
__global__ void __launch_bounds__(kMaxPixels)
composite_tiles_kernel(const float* __restrict__ xy,       // [NT, K, 2]
                       const float* __restrict__ conic,    // [NT, K, 3]
                       const float* __restrict__ opac,     // [NT, K]
                       const float* __restrict__ colors,   // [NT, K, 3]
                       const float* __restrict__ normals,  // [NT, K, 3]
                       const float* __restrict__ depths,   // [NT, K]
                       const float* __restrict__ jinv,     // [NT, K, 10]
                       const unsigned char* __restrict__ slot_valid,  // [NT, K]
                       const int* __restrict__ counts,     // [NT]
                       const int* __restrict__ origins,    // [NT, 2] (x, y)
                       float* __restrict__ color_out,      // [NT, P, 3]
                       float* __restrict__ normal_out,     // [NT, P, 3]
                       float* __restrict__ depth_out,      // [NT, P]
                       float* __restrict__ t_out,          // [NT, P]
                       int K, int tile, float alpha_clamp, float alpha_min,
                       float t_min) {
  extern __shared__ float rec[];
  const int t = blockIdx.x;
  const int P = blockDim.x;
  const int p = threadIdx.x;
  const int n = min(max(counts[t], 0), K);  // the tile's trip count, read once

  const size_t slot0 = static_cast<size_t>(t) * K;
  stage(rec, xy + slot0 * 2, n, 2, 0, 2, kXY);
  stage(rec, conic + slot0 * 3, n, 3, 0, 3, kConic);
  stage(rec, opac + slot0, n, 1, 0, 1, kOpac);
  stage(rec, colors + slot0 * 3, n, 3, 0, 3, kColor);
  stage(rec, normals + slot0 * 3, n, 3, 0, 3, kNormal);
  stage(rec, depths + slot0, n, 1, 0, 1, kDepth);
  if (kPerPixDepth) {
    stage(rec, jinv + slot0 * 10, n, 10, 0, 4, kJinv);
    stage(rec, jinv + slot0 * 10, n, 10, 6, 1, kJinv + 4);
    stage(rec, jinv + slot0 * 10, n, 10, 9, 1, kJinv + 5);
  }
  for (int k = p; k < n; k += P)
    rec[k * kRecord + kValid] = slot_valid[slot0 + k] ? 1.f : 0.f;
  __syncthreads();

  const float px = static_cast<float>(origins[2 * t] + p % tile);
  const float py = static_cast<float>(origins[2 * t + 1] + p / tile);

  float cr = 0.f, cg = 0.f, cb = 0.f, nx = 0.f, ny = 0.f, nz = 0.f, dsum = 0.f;
  float T = 1.f;
  bool done = false;

  for (int k = 0; k < n; ++k) {
    if (__syncthreads_and(done)) break;  // uniform across the block
    if (done) continue;
    const float* f = rec + k * kRecord;
    Splat s;
    if (!splat_eval(f, px, py, alpha_clamp, alpha_min, s)) continue;
    const float t_next = t_after(T, s.alpha);
    if (t_next < t_min) {
      done = true;
      continue;
    }
    const float w = s.alpha * T;
    float d_px = f[kDepth];
    if (kPerPixDepth) {
      const float du0 = s.dx * f[kJinv] + s.dy * f[kJinv + 1];
      const float du1 = s.dx * f[kJinv + 2] + s.dy * f[kJinv + 3];
      d_px -= du0 * f[kJinv + 4] + du1 * f[kJinv + 5];
    }
    cr += w * f[kColor];
    cg += w * f[kColor + 1];
    cb += w * f[kColor + 2];
    nx += w * f[kNormal];
    ny += w * f[kNormal + 1];
    nz += w * f[kNormal + 2];
    dsum += w * d_px;
    T = t_next;
  }

  const size_t pix = static_cast<size_t>(t) * P + p;
  color_out[3 * pix] = cr;
  color_out[3 * pix + 1] = cg;
  color_out[3 * pix + 2] = cb;
  normal_out[3 * pix] = nx;
  normal_out[3 * pix + 1] = ny;
  normal_out[3 * pix + 2] = nz;
  depth_out[pix] = dsum;
  t_out[pix] = T;
}

}  // namespace

extern "C" int composite_tiles(const float* xy, const float* conic,
                               const float* opac, const float* colors,
                               const float* normals, const float* depths,
                               const float* jinv,
                               const unsigned char* slot_valid,
                               const int* counts, const int* origins,
                               float* color_out, float* normal_out,
                               float* depth_out, float* t_out, int NT, int K,
                               int tile, int perpix_depth, float alpha_clamp,
                               float alpha_min, float t_min, void* stream) {
  if (NT <= 0) return 0;
  const int P = tile * tile;
  if (tile <= 0 || P > kMaxPixels || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(K) * kRecord * sizeof(float);
  if (perpix_depth) {
    composite_tiles_kernel<true><<<NT, P, smem, s>>>(
        xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
        origins, color_out, normal_out, depth_out, t_out, K, tile, alpha_clamp,
        alpha_min, t_min);
  } else {
    composite_tiles_kernel<false><<<NT, P, smem, s>>>(
        xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
        origins, color_out, normal_out, depth_out, t_out, K, tile, alpha_clamp,
        alpha_min, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}
