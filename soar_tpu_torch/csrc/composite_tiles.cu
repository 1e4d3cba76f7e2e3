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
// What bounds it on an H100.  The arithmetic is f32 ALU work and one expf
// per pixel-slot pair walked; the bytes are 93 per slot read and 32 per
// pixel written.  On the renderer's real tile lists (NT = 1024, K = 96) a
// dozen to a hundred tiles hold every splat and the rest hold none: the
// zeros and ones the empty tiles write set the byte bound (~2.5 us), and
// the time is the latency of the heaviest tiles: a few dependent global
// round trips to stage their rows, then 96 slots one after another for
// each pixel, a few dozen instructions a slot, most of them in dependent
// chains, so one warp issues well under one instruction a cycle.  The synthetic
// lists (every tile busy) are bound by instruction issue over the card.
// What the design does about it:
//   - A tile's pixels are split over blocks of kBlockPixels (128: 4 warps,
//     one per scheduler, two SMs for a 16x16 tile).  Nothing is summed
//     across pixels, so the blocks share nothing but the tile's rows, which
//     each stages itself from L2.
//   - A slot bound n per tile: min(count clamped to [0, K], 1 + the last
//     valid slot below it).  The flags need not be a prefix (the occlusion
//     pass's `slot_valid & front` is not), so n is read from them, by every
//     warp on its own (no barrier).  A tile with n = 0 writes zeros and
//     T = 1 and leaves: no staging, no barrier, no walk.
//   - Two round trips before the walk: the count, then the flags and each
//     thread's row together (a row past n is read and dropped).  Rows
//     [0, n) go to 20-float records in shared memory, one slot a thread,
//     read through the lists' own strides (the column views of the
//     gather's packed rows need no copy), zero records up to a whole group.
//     One barrier; after it each warp walks on its own and leaves once all
//     its pixels have stopped (__all_sync).
//   - Slots in groups of kGroup (8): the T-independent part of each slot
//     (composite_common.cuh splat_eval, branch-free: offsets, power, expf,
//     alpha, the skip tests; and the plane-corrected depth) runs first, so
//     the group's expf and loads overlap; then the sequential part (stop
//     test, w, the seven sums, T) in slot order, with selects.  Records are
//     padded to whole groups and a record past n has valid = 0, so a group
//     needs no clamp or range test.  Per pixel the operations and their
//     order are those of a slot-by-slot walk, so colour, normal and T stay
//     bit-equal to composite_fwd.cu's, and all four outputs to the
//     one-block-a-tile kernel this replaces.
//   - Records are 5 float4: the first 8 floats are composite_common.cuh's
//     Head (xy, conic, opacity, valid; depth in the 8th), read by
//     load_head; then j0 j1 j2 j3 j6 j9, colour, normal.
// Measured and dropped (composite_ab.py, PERF.md): 256 and 64 pixels a
// block; groups of 4 and 16 slots; the next group evaluated ahead of the
// current one's sequential part (software pipelining: no faster, at 72
// registers).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  Plain C entry
// point for ctypes; it returns cudaGetLastError() after the launch.
// Shared memory: K rounded up to whole groups of 20-float records, dynamic,
// opted into up to 227 KB (render/tiles_composite.py::tiles_smem_bytes
// mirrors it).

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace soar;

// Slot record in shared memory; 0..6 as composite_common.cuh's slot row.
constexpr int kDepth = 7;
constexpr int kJinv = 8;  // j0, j1, j2, j3, j6, j9
constexpr int kColor = 14;
constexpr int kNormal = 17;
constexpr int kRecord = 20;
constexpr int kRecord4 = kRecord / 4;

// Slots evaluated together before their sequential part.
constexpr int kGroup = 8;
// Pixels of one block; a tile spans ceil(P / kBlockPixels) blocks.
constexpr int kBlockPixels = 128;

// Records staged for n slots: whole groups, so a group's rows never need
// a clamp (a record past n is never kept).
__host__ __device__ constexpr int records(int n) {
  return (n + kGroup - 1) / kGroup * kGroup;
}

// The seven float lists: base pointers and (tile, slot) strides in
// elements; the [NT, K, W] lists have unit stride over W.
enum { kXYList, kConicList, kOpacList, kColorList, kNormalList, kDepthList,
       kJinvList, kLists };

struct Lists {
  const float* ptr[kLists];
  long long tile_stride[kLists];
  long long slot_stride[kLists];
};

__device__ __forceinline__ const float* slot_of(const Lists& L, int list, int t,
                                                int k) {
  return L.ptr[list] + t * L.tile_stride[list] + k * L.slot_stride[list];
}

// An int32 or int64 entry, widened.
__device__ __forceinline__ long long read_int(const void* p, int is64, int i) {
  return is64 ? static_cast<const long long*>(p)[i]
              : static_cast<long long>(static_cast<const int*>(p)[i]);
}

// Slot k's record, read from the lists through their strides; the jinv
// columns only with the per-pixel depth.
template <bool kPerPixDepth>
__device__ __forceinline__ void load_record(const Lists& L,
                                            const unsigned char* valid, int t,
                                            int k, float (&r)[kRecord]) {
  const float* a = slot_of(L, kXYList, t, k);
  r[kXY] = a[0];
  r[kXY + 1] = a[1];
  a = slot_of(L, kConicList, t, k);
  r[kConic] = a[0];
  r[kConic + 1] = a[1];
  r[kConic + 2] = a[2];
  r[kOpac] = *slot_of(L, kOpacList, t, k);
  r[kValid] = valid[k] ? 1.f : 0.f;
  r[kDepth] = *slot_of(L, kDepthList, t, k);
  if (kPerPixDepth) {
    a = slot_of(L, kJinvList, t, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) r[kJinv + j] = a[j];
    r[kJinv + 4] = a[6];
    r[kJinv + 5] = a[9];
  }
  a = slot_of(L, kColorList, t, k);
  r[kColor] = a[0];
  r[kColor + 1] = a[1];
  r[kColor + 2] = a[2];
  a = slot_of(L, kNormalList, t, k);
  r[kNormal] = a[0];
  r[kNormal + 1] = a[1];
  r[kNormal + 2] = a[2];
}

__device__ __forceinline__ void store_record(float4* dst, const float (&r)[kRecord]) {
#pragma unroll
  for (int q = 0; q < kRecord4; ++q)
    dst[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

// The T-independent part of kGroup slots at one pixel: composite_common.cuh
// splat_eval (branch-free) and the slot's depth at the pixel.
template <bool kPerPixDepth>
struct Group {
  float alpha[kGroup], depth[kGroup];
  bool keep[kGroup];

  // Slots [k0, k0 + kGroup) of the records `rec` (a record past the slot
  // bound has its valid column 0, so it is never kept).
  __device__ __forceinline__ void eval(const float4* __restrict__ rec, int k0,
                                       float px, float py, float alpha_clamp,
                                       float alpha_min) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float4* row = rec + (k0 + g) * kRecord4;
      const Head h = load_head(row);
      Splat s;
      keep[g] = splat_eval(h.f, px, py, alpha_clamp, alpha_min, s);
      alpha[g] = s.alpha;
      float d = h.f[kDepth];
      if (kPerPixDepth) {
        const float4 j = row[2];  // j0 j1 j2 j3
        const float2 j69 = reinterpret_cast<const float2*>(row + 3)[0];
        const float du0 = s.dx * j.x + s.dy * j.y;
        const float du1 = s.dx * j.z + s.dy * j.w;
        d -= du0 * j69.x + du1 * j69.y;
      }
      depth[g] = d;
    }
  }
};

// One pixel's walk: the sums, T and the sticky stop.
struct PixelWalk {
  float cr = 0.f, cg = 0.f, cb = 0.f, nx = 0.f, ny = 0.f, nz = 0.f, dsum = 0.f;
  float T = 1.f;
  bool done;

  // The sequential part of slots [k0, k0 + kGroup), slot by slot; a slot
  // the pixel does not blend leaves its sums and T as they were (selects,
  // no branch).
  template <bool kPerPixDepth>
  __device__ __forceinline__ void blend(const Group<kPerPixDepth>& e,
                                        const float4* __restrict__ rec, int k0,
                                        float t_min) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float4* row = rec + (k0 + g) * kRecord4;
      const float2 c01 = reinterpret_cast<const float2*>(row + 3)[1];
      const float4 c2n = row[4];  // colour b, normal x y z
      const bool in = e.keep[g] & !done;
      const float t_next = t_after(T, e.alpha[g]);
      const bool stop = t_next < t_min;
      done |= in & stop;
      const bool use = in & !stop;
      const float w = e.alpha[g] * T;
      const float a0 = cr + w * c01.x, a1 = cg + w * c01.y, a2 = cb + w * c2n.x;
      const float a3 = nx + w * c2n.y, a4 = ny + w * c2n.z, a5 = nz + w * c2n.w;
      const float a6 = dsum + w * e.depth[g];
      cr = use ? a0 : cr;
      cg = use ? a1 : cg;
      cb = use ? a2 : cb;
      nx = use ? a3 : nx;
      ny = use ? a4 : ny;
      nz = use ? a5 : nz;
      dsum = use ? a6 : dsum;
      T = use ? t_next : T;
    }
  }
};

template <bool kPerPixDepth>
__global__ void __launch_bounds__(kBlockPixels)
composite_tiles_kernel(const Lists L,
                       const unsigned char* __restrict__ slot_valid,  // [NT, K]
                       const void* __restrict__ counts,   // [NT] int32 / int64
                       const void* __restrict__ origins,  // [NT, 2] (x, y)
                       int counts_i64, int origins_i64,
                       float* __restrict__ color_out,   // [NT, P, 3]
                       float* __restrict__ normal_out,  // [NT, P, 3]
                       float* __restrict__ depth_out,   // [NT, P]
                       float* __restrict__ t_out,       // [NT, P]
                       int K, int tile, int parts, float alpha_clamp,
                       float alpha_min, float t_min) {
  extern __shared__ float4 s_rec[];  // [records(K)][kRecord4]
  const int t = blockIdx.x / parts;
  const int P = tile * tile;
  const int p = (blockIdx.x - t * parts) * kBlockPixels + static_cast<int>(threadIdx.x);
  const bool active = p < P;  // a partial last warp or block
  const size_t pix = static_cast<size_t>(t) * P + (active ? p : 0);

  // The slot bound, by each warp from the flags below the clamped count.
  // Each thread reads its first row in the same round trip, before the
  // bound is known (a row past it is read and never kept).
  const long long c = read_int(counts, counts_i64, t);
  const int nc = static_cast<int>(c < 0 ? 0 : (c > K ? K : c));
  const unsigned char* valid = slot_valid + static_cast<size_t>(t) * K;
  const int tid = threadIdx.x;
  float r[kRecord] = {};
  if (tid < nc) load_record<kPerPixDepth>(L, valid, t, tid, r);
  int last = 0;
  for (int k = tid & 31; k < nc; k += 32)
    if (valid[k]) last = k + 1;
  const int n = __reduce_max_sync(kFullMask, last);

  PixelWalk walk;
  walk.done = !active;
  if (n > 0) {
    // Records [0, records(n)): the rows below the count, zeros past it.
    if (tid < records(n)) store_record(s_rec + tid * kRecord4, r);
    for (int k = tid + blockDim.x; k < records(n); k += blockDim.x) {
      float rk[kRecord] = {};
      if (k < nc) load_record<kPerPixDepth>(L, valid, t, k, rk);
      store_record(s_rec + k * kRecord4, rk);
    }
    __syncthreads();

    const int q = active ? p : 0;
    const float px = static_cast<float>(read_int(origins, origins_i64, 2 * t) + q % tile);
    const float py =
        static_cast<float>(read_int(origins, origins_i64, 2 * t + 1) + q / tile);

    for (int k0 = 0; k0 < n; k0 += kGroup) {
      if (__all_sync(kFullMask, walk.done)) break;  // uniform across the warp
      Group<kPerPixDepth> e;
      e.eval(s_rec, k0, px, py, alpha_clamp, alpha_min);
      walk.blend(e, s_rec, k0, t_min);
    }
  }

  if (!active) return;
  color_out[3 * pix] = walk.cr;
  color_out[3 * pix + 1] = walk.cg;
  color_out[3 * pix + 2] = walk.cb;
  normal_out[3 * pix] = walk.nx;
  normal_out[3 * pix + 1] = walk.ny;
  normal_out[3 * pix + 2] = walk.nz;
  depth_out[pix] = walk.dsum;
  t_out[pix] = walk.T;
}

template <bool kPerPixDepth>
int launch(const Lists& L, const unsigned char* slot_valid, const void* counts,
           const void* origins, int counts_i64, int origins_i64,
           float* color_out, float* normal_out, float* depth_out, float* t_out,
           int NT, int K, int tile, float alpha_clamp, float alpha_min,
           float t_min, cudaStream_t stream) {
  // Once per instance: allow up to the opt-in limit of dynamic shared memory.
  static const cudaError_t opted = cudaFuncSetAttribute(
      composite_tiles_kernel<kPerPixDepth>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
  if (opted != cudaSuccess) return opted;
  const int P = tile * tile;
  const int parts = (P + kBlockPixels - 1) / kBlockPixels;
  const int threads = P < kBlockPixels ? (P + 31) / 32 * 32 : kBlockPixels;
  const size_t smem = static_cast<size_t>(records(K)) * kRecord * sizeof(float);
  composite_tiles_kernel<kPerPixDepth><<<NT * parts, threads, smem, stream>>>(
      L, slot_valid, counts, origins, counts_i64, origins_i64, color_out,
      normal_out, depth_out, t_out, K, tile, parts, alpha_clamp, alpha_min,
      t_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `strides` (host memory): the tile and slot strides, in elements, of xy,
// conic, opac, colors, normals, depths and jinv, in that order (14 values).
// `counts` and `origins` are int64 where their flag is set, else int32.
extern "C" int composite_tiles(const float* xy, const float* conic,
                               const float* opac, const float* colors,
                               const float* normals, const float* depths,
                               const float* jinv,
                               const unsigned char* slot_valid,
                               const void* counts, const void* origins,
                               float* color_out, float* normal_out,
                               float* depth_out, float* t_out,
                               const long long* strides, int NT, int K,
                               int tile, int perpix_depth, int counts_i64,
                               int origins_i64, float alpha_clamp,
                               float alpha_min, float t_min, void* stream) {
  if (NT <= 0) return 0;
  const int P = tile * tile;
  if (tile <= 0 || P > kMaxPixels || K <= 0 ||
      static_cast<size_t>(records(K)) * kRecord * sizeof(float) >
          static_cast<size_t>(kSmemOptin))
    return cudaErrorInvalidValue;
  Lists L;
  const float* ptrs[kLists] = {xy, conic, opac, colors, normals, depths, jinv};
  for (int i = 0; i < kLists; ++i) {
    L.ptr[i] = ptrs[i];
    L.tile_stride[i] = strides[2 * i];
    L.slot_stride[i] = strides[2 * i + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return perpix_depth
             ? launch<true>(L, slot_valid, counts, origins, counts_i64,
                            origins_i64, color_out, normal_out, depth_out,
                            t_out, NT, K, tile, alpha_clamp, alpha_min, t_min, s)
             : launch<false>(L, slot_valid, counts, origins, counts_i64,
                             origins_i64, color_out, normal_out, depth_out,
                             t_out, NT, K, tile, alpha_clamp, alpha_min, t_min,
                             s);
}
