// Per-slot arithmetic of the per-tile alpha composite, shared by the forward
// (composite_fwd.cu) and backward (composite_bwd.cu) kernels.
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

struct Splat {
  float dx, dy;  // slot mean minus pixel
  float power;   // -0.5 (a dx^2 + c dy^2) - b dx dy
  float u;       // opacity * exp(power), before the clamp
  float alpha;   // min(alpha_clamp, u)
};

// Evaluates slot row `f` at pixel (px, py).  Returns false where the slot is
// skipped (invalid, power > 0 or NaN, alpha < alpha_min or NaN): it then
// contributes nothing and does not advance T.
__device__ __forceinline__ bool splat_eval(const float* f, float px, float py,
                                           float alpha_clamp, float alpha_min,
                                           Splat& s) {
  if (!(f[kValid] > 0.5f)) return false;
  s.dx = __fsub_rn(f[kXY], px);
  s.dy = __fsub_rn(f[kXY + 1], py);
  const float qa = __fmul_rn(__fmul_rn(f[kConic], s.dx), s.dx);
  const float qc = __fmul_rn(__fmul_rn(f[kConic + 2], s.dy), s.dy);
  const float qb = __fmul_rn(__fmul_rn(f[kConic + 1], s.dx), s.dy);
  s.power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  if (!(s.power <= 0.f)) return false;
  s.u = __fmul_rn(f[kOpac], expf(s.power));
  s.alpha = (s.u > alpha_clamp) ? alpha_clamp : s.u;  // keeps NaN
  return s.alpha >= alpha_min;
}

// The transmittance after a kept slot; the walk stops (stickily) at the
// first kept slot whose t_next would fall below t_min, which is excluded.
__device__ __forceinline__ float t_after(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.f, alpha));
}

}  // namespace soar
