// Per-surfel screen-space preprocess for Hopper (sm_90a): forward, and the
// gradients of the surfels' means, quaternions and scales.
//
// Replaces the plain PyTorch chain of soar_tpu_torch/render/preprocess.py
// (`preprocess_plain`: about a hundred aten kernels, among them cuBLAS's
// batched 2x3, 3x3 and [N, 3] x [3, 3] products, each padded into a 32x32
// tile, and as many again in autograd's backward).  The JAX package's
// soar_tpu/render/preprocess.py is plain jnp and reaches no pallas_call: this
// kernel replaces none of the TPU's.  Same function: the projection, the
// frustum / near-plane / back-face / grazing culls as a validity mask,
// quat -> rotation, the view-space surfel axes, Sigma = R S S R^T with the
// flat z-scale, the fov-clamped EWA Jacobian, cov2d with the low-pass, its
// determinant, conic and screen radius, and the per-pixel-depth local
// homography `jinv`, with the near-plane clamp of the depth that the
// footprint and the homography divide by.
//
// What bounds it on an H100: memory, and not by much.  A forward reads 40
// bytes a surfel (means, quaternion, scales) and writes 85 (xy, depth, conic,
// radius, normal, view_dot, jinv, valid): at N = 125,664 about 15.7 MB, 4.7 us
// at 3.35 TB/s.  The backward reads the 40 input bytes and the 80 bytes of
// cotangents and writes 40 bytes of gradients: 20 MB, 6.0 us.  A few hundred float32
// operations a surfel sit far below the card's 67 TFLOP/s.  What the design
// does about it:
//   - One thread per surfel, everything in registers: nothing but the
//     outputs is written, and the backward recomputes the forward from the
//     inputs, so nothing but the inputs is saved for it.
//   - The camera (full_proj, w2c, the fovs, the principal point) is read
//     from the camera's own device tensors, never from host scalars, so a
//     CUDA graph that captured a launch replays it for a new camera.
//   - The forward's products and sums are explicit round-to-nearest
//     intrinsics, which the compiler never contracts, in the order the plain
//     chain's kernels take them (torch's elementwise ops one rounding each;
//     its last-dimension sums and norms of three terms as `sum3` and `norm3`
//     pair them; the matrix products' K = 3 and 4 sums as the FMA chains of
//     `gemm_dot`, as measured on an H100 with torch 2.11), so the forward is
//     the plain version's to the bit there.  The backward
//     is the hand-derived chain rule in plain float32 arithmetic, with
//     torch's subgradients: a clamp passes the gradient on its closed
//     interval, a torch.where sends none to the branch not taken, the
//     radius (a ceil) and the masks send none.  No atomics: every thread
//     writes its own surfel's gradients.
//   - cfg.surface, cfg.perpix_depth and cfg.render_front are template
//     parameters, so every combination the port's paths use is one kernel
//     without branches on them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  One plain C
// entry point for ctypes, `preprocess`, which returns cudaGetLastError()
// after its launch; it allocates nothing and never synchronises, so it can
// be captured into a CUDA graph.

#include <cuda_runtime.h>

// The launch's arguments; render/preprocess.py::_Args is the same struct in
// ctypes.  Row strides are in floats; each row's floats are contiguous.
struct PreprocessArgs {
  const float* means;   // [N, 3]
  const float* quats;   // [N, 4] wxyz
  const float* scales;  // [N, 3]
  const float* fovx;    // []
  const float* fovy;    // []
  const float* w2c;     // [4, 4]
  const float* full_proj;  // [4, 4]
  const float* prcp;    // [2]
  // Forward outputs.
  unsigned char* valid;  // [N] bool
  float* xy;             // [N, 2]
  float* depth;          // [N]
  float* conic;          // [N, 3]
  float* radius;         // [N]
  float* normal;         // [N, 3]
  float* view_dot;       // [N]
  float* jinv;           // [N, 10]
  // Backward: the outputs' cotangents (null: zero) and the inputs'
  // gradients (null: not wanted).
  const float* g_xy;
  const float* g_depth;
  const float* g_conic;
  const float* g_normal;
  const float* g_view_dot;
  const float* g_jinv;
  float* g_means;  // [N, 3]
  float* g_quats;  // [N, 4]
  float* g_scales;  // [N, 3]
  long long s_means, s_quats, s_scales;
  long long s_gxy, s_gdepth, s_gconic, s_gnormal, s_gview_dot, s_gjinv;
  int N, W, H;
  float near_z, low_pass, scale_modifier;
  float lo_x, hi_x, lo_y, hi_y;  // the frustum's 20% border, in pixels
};

namespace {

using Args = PreprocessArgs;

constexpr int kThreads = 128;
// Flags (render/preprocess.py::FLAGS mirrors them).
constexpr int kSurface = 1;
constexpr int kPerpix = 2;
constexpr int kFront = 4;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// A matrix product's K-term sum, as cuBLAS's float32 kernels form it: one
// FMA after another from k = 0.
template <int K>
__device__ __forceinline__ float gemm_dot(const float* a, const float* b) {
  float acc = mul(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) acc = __fmaf_rn(a[k], b[k], acc);
  return acc;
}

// torch.sum over a last dimension of three, as its vectorised reduction
// pairs them: (a + c) + b.
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, c), b); }
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}

// The camera as the plain chain derives it, each step one float32 rounding
// as torch's kernels take it.
struct Cam {
  float P[3][4];  // rows 0, 1 and 3 of full_proj
  float V[3][4];  // rows 0..2 of w2c
  float fx, fy, tanx, tany, off_x, off_y, scale;
};

__device__ __forceinline__ Cam load_cam(const Args& a) {
  Cam c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.P[0][k] = __ldg(a.full_proj + k);
    c.P[1][k] = __ldg(a.full_proj + 4 + k);
    c.P[2][k] = __ldg(a.full_proj + 12 + k);
#pragma unroll
    for (int r = 0; r < 3; ++r) c.V[r][k] = __ldg(a.w2c + 4 * r + k);
  }
  // tan(fov * 0.5); focal_from_fov: W / (2 tan(fov / 2)), which torch forms
  // as reciprocal(2 tan) * W.
  c.tanx = tanf(mul(__ldg(a.fovx), 0.5f));
  c.tany = tanf(mul(__ldg(a.fovy), 0.5f));
  c.fx = mul(dvd(1.0f, mul(2.0f, c.tanx)), static_cast<float>(a.W));
  c.fy = mul(dvd(1.0f, mul(2.0f, c.tany)), static_cast<float>(a.H));
  // ndc2pix's principal-point shift, size * (prcp - 0.5).
  c.off_x = mul(static_cast<float>(a.W), sub(__ldg(a.prcp), 0.5f));
  c.off_y = mul(static_cast<float>(a.H), sub(__ldg(a.prcp + 1), 0.5f));
  // _local_homo's (fx + fy) / 2 / S_fix; torch divides by a host scalar as a
  // product with its float32 reciprocal.
  c.scale = mul(mul(add(c.fx, c.fy), 0.5f), 1.0f / 1000.0f);
  return c;
}

__device__ __forceinline__ float ndc2pix(float v, int size, float off) {
  return add(mul(sub(mul(add(v, 1.0f), static_cast<float>(size)), 1.0f), 0.5f), off);
}

// quat_to_rotmat (wxyz, not normalised); R[i][j], columns the local axes.
__device__ __forceinline__ void rotmat(const float* q, float R[3][3]) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  R[0][1] = mul(2.0f, sub(mul(x, y), mul(r, z)));
  R[0][2] = mul(2.0f, add(mul(x, z), mul(r, y)));
  R[1][0] = mul(2.0f, add(mul(x, y), mul(r, z)));
  R[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  R[1][2] = mul(2.0f, sub(mul(y, z), mul(r, x)));
  R[2][0] = mul(2.0f, sub(mul(x, z), mul(r, y)));
  R[2][1] = mul(2.0f, add(mul(y, z), mul(r, x)));
  R[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
}

// Column j of R, rotated into the view: out_r = sum_k R[k][j] w2c[r][k]
// (R[..., :, j] @ w_rot.T).
__device__ __forceinline__ void view_axis(const Cam& c, const float R[3][3], int j, float* out) {
  const float col[3] = {R[0][j], R[1][j], R[2][j]};
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = gemm_dot<3>(col, c.V[r]);
}

// The per-surfel state both kernels compute from the inputs.
struct Geometry {
  float hom0, hom1, hom3, pw;  // full_proj rows 0, 1, 3 applied; 1 / (hom3 + 1e-7)
  float pv[3];                 // view-space position
  float zs;                    // its depth clamped to the near plane
  float R[3][3];
};

__device__ __forceinline__ Geometry geometry(const Args& a, const Cam& c, int i) {
  Geometry g;
  const float* mp = a.means + i * a.s_means;
  const float m[4] = {__ldg(mp), __ldg(mp + 1), __ldg(mp + 2), 1.0f};
  g.hom0 = gemm_dot<4>(m, c.P[0]);
  g.hom1 = gemm_dot<4>(m, c.P[1]);
  g.hom3 = gemm_dot<4>(m, c.P[2]);
  g.pw = dvd(1.0f, add(g.hom3, 1e-7f));
#pragma unroll
  for (int r = 0; r < 3; ++r) g.pv[r] = gemm_dot<4>(m, c.V[r]);
  g.zs = g.pv[2] >= a.near_z ? g.pv[2] : a.near_z;
  const float* qp = a.quats + i * a.s_quats;
  const float q[4] = {__ldg(qp), __ldg(qp + 1), __ldg(qp + 2), __ldg(qp + 3)};
  rotmat(q, g.R);
  return g;
}

// The local homography's intermediates (_local_homo) at p = (pv0, pv1, zs).
struct Homo {
  float px, py, v0[3], v1[3], mod0, mod1, d0[3], d1[3], prj0, prj1, tt, sp0, sp1, t0, t1;
  float xu0[3], xu1[3];
  bool grazing;
};

// torch.linalg.norm over a last dimension of three, clamped as _local_homo
// clamps it: the squares summed as sum3 sums.
__device__ __forceinline__ float norm3(const float* v) {
  const float n = __fsqrt_rn(sum3(mul(v[0], v[0]), mul(v[1], v[1]), mul(v[2], v[2])));
  return n < 1e-8f ? 1e-8f : n;
}

__device__ __forceinline__ float safe(float x) { return fabsf(x) < 1e-12f ? 1e-12f : x; }

__device__ __forceinline__ Homo homo(const Geometry& g, const float* n) {
  Homo h;
  const float p[3] = {g.pv[0], g.pv[1], g.zs};
  h.px = dvd(p[0], p[2]);
  h.py = dvd(p[1], p[2]);
  h.v0[0] = add(h.px, 0.001f);
  h.v0[1] = h.py;
  h.v0[2] = 1.0f;
  h.v1[0] = h.px;
  h.v1[1] = add(h.py, 0.001f);
  h.v1[2] = 1.0f;
  h.mod0 = norm3(h.v0);
  h.mod1 = norm3(h.v1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.d0[k] = dvd(h.v0[k], h.mod0);
    h.d1[k] = dvd(h.v1[k], h.mod1);
  }
  h.prj0 = dot3(h.d0, n);
  h.prj1 = dot3(h.d1, n);
  h.grazing = fabsf(dvd(h.prj0, h.mod0)) < 0.01f || fabsf(dvd(h.prj1, h.mod1)) < 0.01f;
  h.tt = dot3(p, n);
  h.sp0 = safe(h.prj0);
  h.sp1 = safe(h.prj1);
  h.t0 = dvd(h.tt, h.sp0);
  h.t1 = dvd(h.tt, h.sp1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.xu0[k] = sub(mul(h.d0[k], h.t0), p[k]);
    h.xu1[k] = sub(mul(h.d1[k], h.t1), p[k]);
  }
  return h;
}

// Sigma's screen footprint (_ewa_cov2d and what follows it).
struct Footprint {
  float s[3];        // the scales as Sigma takes them
  float cov3[3][3];  // R S S R^T
  float rx, ry, lim_x, lim_y, cx, cy, tx, ty;
  float J00, J02, J11, J12, tz2;
  float JW[2][3], T[2][3];
  float a, b, c, det, dinv;
};

template <bool kSurf>
__device__ __forceinline__ Footprint footprint(const Args& a, const Cam& cam, const Geometry& g,
                                               int i) {
  Footprint f;
  const float* sp = a.scales + i * a.s_scales;
#pragma unroll
  for (int k = 0; k < 3; ++k) f.s[k] = mul(__ldg(sp + k), a.scale_modifier);
  if constexpr (kSurf) f.s[2] = 0.0f;
  float RS[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) RS[r][k] = mul(g.R[r][k], f.s[k]);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) f.cov3[r][k] = gemm_dot<3>(RS[r], RS[k]);

  const float tz = g.zs;
  f.lim_x = mul(cam.tanx, 1.3f);
  f.lim_y = mul(cam.tany, 1.3f);
  f.rx = dvd(g.pv[0], tz);
  f.ry = dvd(g.pv[1], tz);
  f.cx = fminf(fmaxf(f.rx, -f.lim_x), f.lim_x);
  f.cy = fminf(fmaxf(f.ry, -f.lim_y), f.lim_y);
  f.tx = mul(f.cx, tz);
  f.ty = mul(f.cy, tz);
  f.tz2 = mul(tz, tz);
  f.J00 = dvd(cam.fx, tz);
  f.J02 = dvd(mul(-cam.fx, f.tx), f.tz2);
  f.J11 = dvd(cam.fy, tz);
  f.J12 = dvd(mul(-cam.fy, f.ty), f.tz2);
  // JW = J @ w_rot, J = [[J00, 0, J02], [0, J11, J12]].
  const float J[2][3] = {{f.J00, 0.0f, f.J02}, {0.0f, f.J11, f.J12}};
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float col[3] = {cam.V[0][j], cam.V[1][j], cam.V[2][j]};
      f.JW[r][j] = gemm_dot<3>(J[r], col);
    }
  // T = JW @ cov3, cov2d = T @ JW^T.
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float col[3] = {f.cov3[0][j], f.cov3[1][j], f.cov3[2][j]};
      f.T[r][j] = gemm_dot<3>(f.JW[r], col);
    }
  f.a = add(gemm_dot<3>(f.T[0], f.JW[0]), a.low_pass);
  f.b = gemm_dot<3>(f.T[0], f.JW[1]);
  f.c = add(gemm_dot<3>(f.T[1], f.JW[1]), a.low_pass);
  f.det = sub(mul(f.a, f.c), mul(f.b, f.b));
  f.dinv = dvd(1.0f, f.det == 0.0f ? 1.0f : f.det);
  return f;
}

template <bool kSurf, bool kPix, bool kFrontOnly>
__global__ void __launch_bounds__(kThreads) preprocess_fwd(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.N) return;
  const Cam cam = load_cam(a);
  const Geometry g = geometry(a, cam, i);

  const float prx = mul(g.hom0, g.pw);
  const float pry = mul(g.hom1, g.pw);
  const float x_pix = ndc2pix(prx, a.W, cam.off_x);
  const float y_pix = ndc2pix(pry, a.H, cam.off_y);
  bool valid = g.pv[2] >= a.near_z && x_pix >= a.lo_x && x_pix < a.hi_x && y_pix >= a.lo_y &&
               y_pix < a.hi_y;

  float n[3] = {0.0f, 0.0f, 0.0f}, jv[10];
  float vd = -1.0f;
#pragma unroll
  for (int k = 0; k < 10; ++k) jv[k] = 0.0f;
  if constexpr (kSurf) {
    float u0[3], u1[3];
    view_axis(cam, g.R, 2, n);
    view_axis(cam, g.R, 0, u0);
    view_axis(cam, g.R, 1, u1);
    vd = dot3(g.pv, n);
    if constexpr (kFrontOnly) valid = valid && vd <= -0.01f;
    if constexpr (kPix) {
      const Homo h = homo(g, n);
      valid = valid && !h.grazing;
      jv[0] = dvd(dot3(h.xu0, u0), cam.scale);
      jv[1] = dvd(dot3(h.xu1, u0), cam.scale);
      jv[2] = dvd(dot3(h.xu0, u1), cam.scale);
      jv[3] = dvd(dot3(h.xu1, u1), cam.scale);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        jv[4 + k] = u0[k];
        jv[7 + k] = u1[k];
      }
    }
  }

  const Footprint f = footprint<kSurf>(a, cam, g, i);
  valid = valid && f.det != 0.0f;
  const float mid = mul(0.5f, add(f.a, f.c));
  const float lam = add(mid, __fsqrt_rn(fmaxf(sub(mul(mid, mid), f.det), 0.1f)));
  const float rad = ceilf(mul(3.0f, __fsqrt_rn(lam)));
  valid = valid && rad > 0.0f;

  a.valid[i] = valid;
  a.xy[2 * i] = x_pix;
  a.xy[2 * i + 1] = y_pix;
  a.depth[i] = g.pv[2];
  a.conic[3 * i] = mul(f.c, f.dinv);
  a.conic[3 * i + 1] = mul(-f.b, f.dinv);
  a.conic[3 * i + 2] = mul(f.a, f.dinv);
  a.radius[i] = rad;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.normal[3 * i + k] = n[k];
  a.view_dot[i] = vd;
#pragma unroll
  for (int k = 0; k < 10; ++k) a.jinv[10 * i + k] = jv[k];
}

__device__ __forceinline__ float cot(const float* g, long long stride, int i, int k) {
  return g == nullptr ? 0.0f : __ldg(g + i * stride + k);
}

template <bool kSurf, bool kPix>
__global__ void __launch_bounds__(kThreads) preprocess_bwd(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.N) return;
  const Cam cam = load_cam(a);
  const Geometry g = geometry(a, cam, i);

  float gpv[3] = {0.0f, 0.0f, 0.0f};  // view-space position
  float gzs = 0.0f;                   // the clamped depth
  float gR[3][3] = {};                // rotation

  // ---- conic <- cov2d <- (J, Sigma)
  {
    const Footprint f = footprint<kSurf>(a, cam, g, i);
    const float gc0 = cot(a.g_conic, a.s_gconic, i, 0);
    const float gc1 = cot(a.g_conic, a.s_gconic, i, 1);
    const float gc2 = cot(a.g_conic, a.s_gconic, i, 2);
    // conic = (c, -b, a) / det, dinv = 1 / det where det != 0.
    float ga = gc2 * f.dinv, gb = -gc1 * f.dinv, gc = gc0 * f.dinv;
    const float gdinv = gc0 * f.c - gc1 * f.b + gc2 * f.a;
    const float gdet = f.det != 0.0f ? -gdinv * f.dinv * f.dinv : 0.0f;
    ga += gdet * f.c;
    gc += gdet * f.a;
    gb -= 2.0f * f.b * gdet;
    // cov2d_ij = sum_k T_ik JW_jk; a, b, c read (0, 0), (0, 1), (1, 1).
    float gT[2][3], gJW[2][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gT[0][k] = ga * f.JW[0][k] + gb * f.JW[1][k];
      gT[1][k] = gc * f.JW[1][k];
      gJW[0][k] = ga * f.T[0][k];
      gJW[1][k] = gb * f.T[0][k] + gc * f.T[1][k];
    }
    // T_ij = sum_k JW_ik cov3_kj.
    float gcov[3][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gJW[r][k] += gT[r][0] * f.cov3[k][0] + gT[r][1] * f.cov3[k][1] + gT[r][2] * f.cov3[k][2];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) gcov[k][j] = f.JW[0][k] * gT[0][j] + f.JW[1][k] * gT[1][j];
    // JW_ij = sum_k J_ik w2c_kj: the four J entries that are not zeros.
    float gJ[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gJ[r][k] = gJW[r][0] * cam.V[k][0] + gJW[r][1] * cam.V[k][1] + gJW[r][2] * cam.V[k][2];
    const float tz = g.zs;
    float gtz = -gJ[0][0] * f.J00 / tz - gJ[1][1] * f.J11 / tz;
    const float gtz2 = -(gJ[0][2] * f.J02 + gJ[1][2] * f.J12) / f.tz2;
    const float gtx = -cam.fx * (gJ[0][2] / f.tz2);
    const float gty = -cam.fy * (gJ[1][2] / f.tz2);
    gtz += 2.0f * tz * gtz2;
    // t = clamp(p / tz, -lim, lim) * tz; the clamp passes on its closed interval.
    gtz += gtx * f.cx + gty * f.cy;
    const float grx = (f.rx >= -f.lim_x && f.rx <= f.lim_x) ? gtx * tz : 0.0f;
    const float gry = (f.ry >= -f.lim_y && f.ry <= f.lim_y) ? gty * tz : 0.0f;
    gpv[0] += grx / tz;
    gpv[1] += gry / tz;
    gtz -= (grx * f.rx + gry * f.ry) / tz;
    gzs += gtz;
    // cov3 = RS RS^T, RS_ij = R_ij s_j.
    float gs[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float gRS = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) gRS += (gcov[r][j] + gcov[j][r]) * g.R[j][k] * f.s[k];
        gR[r][k] += gRS * f.s[k];
        gs[k] += gRS * g.R[r][k];
      }
    if (a.g_scales != nullptr) {
      float* out = a.g_scales + 3 * i;
      out[0] = gs[0] * a.scale_modifier;
      out[1] = gs[1] * a.scale_modifier;
      out[2] = kSurf ? 0.0f : gs[2] * a.scale_modifier;
    }
  }

  // ---- normal, view_dot and the local homography <- the view axes
  if constexpr (kSurf) {
    float n[3], u0[3], u1[3];
    view_axis(cam, g.R, 2, n);
    view_axis(cam, g.R, 0, u0);
    view_axis(cam, g.R, 1, u1);
    float gn[3], gu0[3] = {0.0f, 0.0f, 0.0f}, gu1[3] = {0.0f, 0.0f, 0.0f};
    const float gvd = cot(a.g_view_dot, a.s_gview_dot, i, 0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gn[k] = cot(a.g_normal, a.s_gnormal, i, k) + gvd * g.pv[k];
      gpv[k] += gvd * n[k];
    }
    if constexpr (kPix) {
      const Homo h = homo(g, n);
      float gj[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) gj[k] = cot(a.g_jinv, a.s_gjinv, i, k);
      const float ge00 = gj[0] / cam.scale, ge01 = gj[1] / cam.scale;
      const float ge10 = gj[2] / cam.scale, ge11 = gj[3] / cam.scale;
      const float p[3] = {g.pv[0], g.pv[1], g.zs};
      float gp[3], gd0[3], gd1[3];
      float gt0 = 0.0f, gt1 = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float gxu0 = ge00 * u0[k] + ge10 * u1[k];
        const float gxu1 = ge01 * u0[k] + ge11 * u1[k];
        gu0[k] += ge00 * h.xu0[k] + ge01 * h.xu1[k] + gj[4 + k];
        gu1[k] += ge10 * h.xu0[k] + ge11 * h.xu1[k] + gj[7 + k];
        // xu = d t - p
        gp[k] = -(gxu0 + gxu1);
        gd0[k] = gxu0 * h.t0;
        gd1[k] = gxu1 * h.t1;
        gt0 += gxu0 * h.d0[k];
        gt1 += gxu1 * h.d1[k];
      }
      // t = tt / safe(prj); safe passes where |prj| >= 1e-12.
      const float gtt = gt0 / h.sp0 + gt1 / h.sp1;
      const float gprj0 = fabsf(h.prj0) < 1e-12f ? 0.0f : -gt0 * h.t0 / h.sp0;
      const float gprj1 = fabsf(h.prj1) < 1e-12f ? 0.0f : -gt1 * h.t1 / h.sp1;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gp[k] += gtt * n[k];
        gn[k] += gtt * p[k] + gprj0 * h.d0[k] + gprj1 * h.d1[k];
        gd0[k] += gprj0 * n[k];
        gd1[k] += gprj1 * n[k];
      }
      // d = v / max(|v|, 1e-8).
      float gv0[3], gv1[3];
      {
        const float dot0 = gd0[0] * h.v0[0] + gd0[1] * h.v0[1] + gd0[2] * h.v0[2];
        const float dot1 = gd1[0] * h.v1[0] + gd1[1] * h.v1[1] + gd1[2] * h.v1[2];
        const float gm0 = h.mod0 >= 1e-8f ? -dot0 / (h.mod0 * h.mod0 * h.mod0) : 0.0f;
        const float gm1 = h.mod1 >= 1e-8f ? -dot1 / (h.mod1 * h.mod1 * h.mod1) : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          gv0[k] = gd0[k] / h.mod0 + gm0 * h.v0[k];
          gv1[k] = gd1[k] / h.mod1 + gm1 * h.v1[k];
        }
      }
      // v0 = (px + 0.001, py, 1), v1 = (px, py + 0.001, 1), (px, py) = p.xy / p.z.
      const float gpx = gv0[0] + gv1[0];
      const float gpy = gv0[1] + gv1[1];
      gp[0] += gpx / p[2];
      gp[1] += gpy / p[2];
      gp[2] -= (gpx * h.px + gpy * h.py) / p[2];
      gpv[0] += gp[0];
      gpv[1] += gp[1];
      gzs += gp[2];
    }
    // n_r = sum_k R_k2 w2c_rk, and u0, u1 from columns 0, 1.
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        gR[k][2] += gn[r] * cam.V[r][k];
        gR[k][0] += gu0[r] * cam.V[r][k];
        gR[k][1] += gu1[r] * cam.V[r][k];
      }
  }

  // ---- the view-space position and the projection <- the mean
  gpv[2] += cot(a.g_depth, a.s_gdepth, i, 0) + (g.pv[2] >= a.near_z ? gzs : 0.0f);
  const float gprx = cot(a.g_xy, a.s_gxy, i, 0) * (static_cast<float>(a.W) * 0.5f);
  const float gpry = cot(a.g_xy, a.s_gxy, i, 1) * (static_cast<float>(a.H) * 0.5f);
  const float ghom0 = gprx * g.pw;
  const float ghom1 = gpry * g.pw;
  const float ghom3 = -(gprx * g.hom0 + gpry * g.hom1) * g.pw * g.pw;
  if (a.g_means != nullptr) {
    float* out = a.g_means + 3 * i;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[k] = gpv[0] * cam.V[0][k] + gpv[1] * cam.V[1][k] + gpv[2] * cam.V[2][k] +
               ghom0 * cam.P[0][k] + ghom1 * cam.P[1][k] + ghom3 * cam.P[2][k];
  }

  // ---- the rotation <- the quaternion
  if (a.g_quats != nullptr) {
    const float* qp = a.quats + i * a.s_quats;
    const float r = __ldg(qp), x = __ldg(qp + 1), y = __ldg(qp + 2), z = __ldg(qp + 3);
    float* out = a.g_quats + 4 * i;
    out[0] = 2.0f * (-gR[0][1] * z + gR[0][2] * y + gR[1][0] * z - gR[1][2] * x -
                     gR[2][0] * y + gR[2][1] * x);
    out[1] = 2.0f * (gR[0][1] * y + gR[0][2] * z + gR[1][0] * y - gR[1][2] * r +
                     gR[2][0] * z + gR[2][1] * r) -
             4.0f * x * (gR[1][1] + gR[2][2]);
    out[2] = 2.0f * (gR[0][1] * x + gR[0][2] * r + gR[1][0] * x + gR[1][2] * z -
                     gR[2][0] * r + gR[2][1] * z) -
             4.0f * y * (gR[0][0] + gR[2][2]);
    out[3] = 2.0f * (-gR[0][1] * r + gR[0][2] * x + gR[1][0] * r + gR[1][2] * y +
                     gR[2][0] * x + gR[2][1] * y) -
             4.0f * z * (gR[0][0] + gR[1][1]);
  }
}

template <bool kSurf, bool kPix, bool kFrontOnly>
int launch(const Args& a, bool backward, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((a.N + kThreads - 1) / kThreads);
  if (backward) {
    preprocess_bwd<kSurf, kPix><<<blocks, kThreads, 0, s>>>(a);
  } else {
    preprocess_fwd<kSurf, kPix, kFrontOnly><<<blocks, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// The forward (backward == 0: the outputs from the inputs) or the backward
// (the inputs' gradients from the inputs and the outputs' cotangents) of N
// surfels, on the given stream.  flags: 0 (volume Gaussians) or kSurface
// with kPerpix and kFront as the call has them; per-pixel depth and the
// front-face cull act only on surfels.  The backward reads neither
// render_front nor the outputs.
extern "C" int preprocess(const PreprocessArgs* args, int flags, int backward, void* stream) {
  const Args& a = *args;
  if (a.N < 0) return cudaErrorInvalidValue;
  if (a.N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bwd = backward != 0;
  // render_front acts only on the forward's mask: the backward takes one
  // kernel per (surface, perpix_depth).
  switch (bwd ? flags & ~kFront : flags) {
    case 0: return launch<false, false, false>(a, bwd, s);
    case kSurface: return launch<true, false, false>(a, bwd, s);
    case kSurface | kPerpix: return launch<true, true, false>(a, bwd, s);
    case kSurface | kFront: return launch<true, false, true>(a, bwd, s);
    case kSurface | kPerpix | kFront: return launch<true, true, true>(a, bwd, s);
    default: return cudaErrorInvalidValue;
  }
}
