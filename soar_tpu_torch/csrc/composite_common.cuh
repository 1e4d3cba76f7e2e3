// Per-slot arithmetic of the per-tile alpha composite, shared by the forward
// (composite_fwd.cu), backward (composite_bwd.cu) and tile-list
// (composite_tiles.cu) kernels, and the row staging of the first two.
//
// The backward recomputes the forward walk, so it must reach exactly the
// masks the forward reached: which slots are skipped and at which slot the
// sticky T < t_min stop fires.  A mask recomputed any other way can flip at
// the cutoff, and the gradients would then belong to another forward.  Both
// kernels therefore call these functions, and every operation that decides
// a mask is an explicit round-to-nearest intrinsic, which the compiler never
// contracts into an FMA, so the two kernels round identically.  The order
// of the operations is the plain PyTorch version's
// (soar_tpu_torch/render/composite.py::splat_alpha), which also keeps the
// kernels close to it.
//
// Feature packing of one slot row (F = 9 + C floats), as in the JAX package:
//   0:2 xy | 2:5 conic (a, b, c) | 5 opacity | 6 valid | 7:9 e | 9: attrs[C]
//
// In shared memory a row is padded to FP = 4 * ceil(F / 4) floats and read
// as FP / 4 float4s: the first two hold what splat_eval reads (columns 0..7,
// e0 included), the rest e1 and the attributes.  The pad columns are never
// written or used.

#pragma once

#include <cuda_runtime.h>

namespace soar {

constexpr int kXY = 0;
constexpr int kConic = 2;
constexpr int kOpac = 5;
constexpr int kValid = 6;
constexpr int kE = 7;
constexpr int kAttr = 9;
constexpr int kMaxPixels = 256;
constexpr int kMaxWarps = kMaxPixels / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Shared memory one block may opt into on sm_90 (227 KB of the SM's 256 KB),
// as dynamic shared memory after cudaFuncSetAttribute.
constexpr int kSmemOptin = 227 * 1024;

__host__ __device__ constexpr int padded_row(int F) { return (F + 3) / 4 * 4; }

// The tile's slot bound n: 1 + its last slot whose valid column is set, 0
// when none is.  The occlusion pass hands the kernels `slot_valid & front`,
// which is not a prefix, so n is read from the flags and not from a count.
// `src` is the tile's [K, F] rows in device memory, `s_warp` kMaxWarps ints
// of shared memory.  Every thread of the block must call it (it holds a
// block barrier), and every thread gets the same n.  blockDim.x is a
// multiple of 32.
__device__ __forceinline__ int slot_bound(const float* __restrict__ src, int K,
                                          int F, int* s_warp) {
  int last = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (src[static_cast<size_t>(k) * F + kValid] > 0.5f) last = k + 1;
  last = __reduce_max_sync(kFullMask, last);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = last;
  __syncthreads();
  int n = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) n = max(n, s_warp[w]);
  return n;
}

// Copies rows [0, n) of the tile's [K, F] rows into padded shared rows
// ([n][FP] floats); the caller then holds a block barrier.
template <int F>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src, int n) {
  constexpr int FP = padded_row(F);
  for (int i = threadIdx.x; i < n * F; i += blockDim.x) {
    const int k = i / F;
    dst[k * FP + (i - k * F)] = src[i];
  }
}

// The first 8 columns of a padded shared row (xy, conic, opacity, valid,
// e0), as splat_eval reads them: two float4 loads.
struct Head {
  float f[8];
};

__device__ __forceinline__ Head load_head(const float4* __restrict__ row) {
  const float4 a = row[0], b = row[1];
  return Head{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// Columns 8 .. FP-1 of a padded shared row: e1, then the attributes.
template <int FP>
struct Tail {
  float f[FP - 8];
};

template <int FP>
__device__ __forceinline__ Tail<FP> load_tail(const float4* __restrict__ row) {
  Tail<FP> t;
#pragma unroll
  for (int q = 2; q < FP / 4; ++q) {
    const float4 v = row[q];
    t.f[4 * q - 8] = v.x;
    t.f[4 * q - 7] = v.y;
    t.f[4 * q - 6] = v.z;
    t.f[4 * q - 5] = v.w;
  }
  return t;
}

struct Splat {
  float dx, dy;  // slot mean minus pixel
  float power;   // -0.5 (a dx^2 + c dy^2) - b dx dy
  float e;       // exp(power)
  float u;       // opacity * e, before the clamp
  float alpha;   // min(alpha_clamp, u)
};

// Evaluates slot row `f` at pixel (px, py).  Returns false where the slot is
// skipped (invalid, power > 0 or NaN, alpha < alpha_min or NaN): it then
// contributes nothing and does not advance T.  Every value is computed
// whatever the outcome and the tests are combined at the end, so the code
// has no branch: the evaluations of several slots, expf included, can be in
// flight at once.  The values of a kept slot do not depend on this form.
__device__ __forceinline__ bool splat_eval(const float* f, float px, float py,
                                           float alpha_clamp, float alpha_min,
                                           Splat& s) {
  s.dx = __fsub_rn(f[kXY], px);
  s.dy = __fsub_rn(f[kXY + 1], py);
  const float qa = __fmul_rn(__fmul_rn(f[kConic], s.dx), s.dx);
  const float qc = __fmul_rn(__fmul_rn(f[kConic + 2], s.dy), s.dy);
  const float qb = __fmul_rn(__fmul_rn(f[kConic + 1], s.dx), s.dy);
  s.power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  s.e = expf(s.power);
  s.u = __fmul_rn(f[kOpac], s.e);
  s.alpha = (s.u > alpha_clamp) ? alpha_clamp : s.u;  // keeps NaN
  return (f[kValid] > 0.5f) & (s.power <= 0.f) & (s.alpha >= alpha_min);
}

// The transmittance after a kept slot; the walk stops (stickily) at the
// first kept slot whose t_next would fall below t_min, which is excluded.
__device__ __forceinline__ float t_after(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.f, alpha));
}

}  // namespace soar
