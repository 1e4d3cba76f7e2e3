// Multiresolution hash encoding for Hopper (sm_90a): forward, and the hash
// table's gradient.
//
// Replaces the plain PyTorch chain of soar_tpu_torch/field/hashgrid.py
// (`hash_encode_plain`, about 20 aten kernels; the JAX package's
// soar_tpu/field/hashgrid.py is plain jnp and reaches no pallas_call).  Same
// function: for every point and level, scale the position by the level's
// resolution, take the lattice cell and the trilinear weights, hash with
// soar_tpu's uint32 primes, gather the 8 corners' features from the float32
// table rounded to the table's gather dtype, and sum the weighted corners in
// float32.  Two storage modes, as in the plain version: `cell` hashes the
// cell once and one row of 8 * F floats holds its corners; `corner` hashes
// each corner and a row holds F floats.  Built for what the port's fields
// use: F = 2 features a level, a gather dtype of bfloat16 or float32.
//
// What bounds it on an H100: memory.  One encode at the published grid (16
// levels, 2^18 rows, F = 2, cell mode) and N = 125,664 reads one 64-byte row
// for each of its 2.01 M (point, level) pairs, ~129 MB, and writes 16 MB:
// ~0.044 ms at 3.35 TB/s.  The plain chain casts the whole 268 MB table to
// bf16 and writes [N, 16, 8, ...] temporaries of 64-257 MB each.  What the
// design does about it:
//   - One thread per (point, level): the row is read straight from the
//     float32 table as float4s and rounded to the gather dtype in registers
//     (round to nearest even), so no rounded copy of the table is made.
//   - Consecutive threads are a point's consecutive levels, so the output
//     [N, L * F] is written in order and a warp reads each position once.
//   - Every product and sum is an explicit round-to-nearest intrinsic, which
//     the compiler never contracts into an FMA, in the order torch's CUDA
//     reductions take in the plain version (measured on an H100 with torch
//     2.11 at N from 48 to 251,328): a corner's weight is (x * z) * y, and
//     the 8 corners are summed as four pairs (c, c + 4), then those in
//     turn.  So the weights, and the cotangents the backward forms from
//     them, are the plain version's to the bit.  No atomics: the forward is
//     deterministic.
//
// Backward (the table's gradient; the positions get none): each (point,
// level, corner, feature) cotangent go * w is rounded to the gather dtype,
// as autograd rounds the cotangent of the plain version's widening cast, and
// added with float32 atomics (float4 / float2 vector atomics on sm_90) into
// a zeroed float32 buffer of the table's shape; one pass then rounds every
// entry to the gather dtype once and widens it back, as the plain version's
// index_put stores each entry's float32 sum in the gather dtype.  Only the
// order of the float32 sums differs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (see soar_tpu_torch/kernels.py).  One plain C
// entry point for ctypes, `hash_encode`, which returns cudaGetLastError()
// after its launches; it allocates nothing and never synchronises, so it can
// be captured into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kRoundBlocks = 132 * 16;  // 16 blocks on each of the H100's 132 SMs
constexpr int kF = 2;                        // features a level
constexpr unsigned kPrimeY = 2654435761u;
constexpr unsigned kPrimeZ = 805459861u;
// Gather dtypes (field/hashgrid.py::DTYPE_CODES mirrors them).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <int DT>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (DT == kBF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// The cell of one (point, level): the lattice base (as uint32, the low 32
// bits of the plain version's int64) and the fractional weights.
struct Cell {
  unsigned b[3];
  float w[3];
};

__device__ __forceinline__ Cell locate(const float* __restrict__ pos, int n,
                                       float res) {
  Cell c;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float s = __fmul_rn(__ldg(pos + 3 * static_cast<size_t>(n) + d), res);
    const float f = floorf(s);
    c.w[d] = __fsub_rn(s, f);
    c.b[d] = static_cast<unsigned>(static_cast<long long>(f));
  }
  return c;
}

__device__ __forceinline__ unsigned hash3(unsigned x, unsigned y, unsigned z,
                                          unsigned mask) {
  return (x ^ (y * kPrimeY) ^ (z * kPrimeZ)) & mask;
}

// Weight of corner c (offsets c & 1, (c >> 1) & 1, (c >> 2) & 1 on x, y, z),
// in torch.prod's order over the last dimension of size 3: (x * z) * y.
__device__ __forceinline__ float corner_weight(const Cell& cell, int c) {
  const float wx = (c & 1) ? cell.w[0] : __fsub_rn(1.0f, cell.w[0]);
  const float wy = (c & 2) ? cell.w[1] : __fsub_rn(1.0f, cell.w[1]);
  const float wz = (c & 4) ? cell.w[2] : __fsub_rn(1.0f, cell.w[2]);
  return __fmul_rn(__fmul_rn(wx, wz), wy);
}

// sum over the 8 corners of term(c) in torch.sum's order over that
// dimension: the pairs (c, c + 4), then the four pair sums in turn.
template <typename Term>
__device__ __forceinline__ float corner_sum(Term term) {
  float acc = __fadd_rn(term(0), term(4));
#pragma unroll
  for (int c = 1; c < 4; ++c) acc = __fadd_rn(acc, __fadd_rn(term(c), term(c + 4)));
  return acc;
}

// Row width in floats: a cell's 8 corners, or one corner.
template <bool kCorner>
constexpr int kRow = kCorner ? kF : 8 * kF;

// Offset (in floats) of the table row of level l holding corner c's
// features: the cell's row in cell mode, the corner's own in corner mode.
template <bool kCorner>
__device__ __forceinline__ size_t row_offset(const Cell& cell, int c, int l, int log2T) {
  const unsigned mask = (1u << log2T) - 1u;
  unsigned h;
  if constexpr (kCorner) {
    h = hash3(cell.b[0] + (c & 1), cell.b[1] + ((c >> 1) & 1),
              cell.b[2] + ((c >> 2) & 1), mask);
  } else {
    h = hash3(cell.b[0], cell.b[1], cell.b[2], mask);
  }
  return ((static_cast<size_t>(l) << log2T) + h) * kRow<kCorner>;
}

// One row: 16 floats as four float4s (cell mode), 2 as a float2 (corner).
template <bool kCorner>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* v) {
  if constexpr (kCorner) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < kRow<false> / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  }
}

template <bool kCorner>
__device__ __forceinline__ void add_row(float* dst, const float* v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (kCorner) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < kRow<false> / 4; ++k)
      atomicAdd(reinterpret_cast<float4*>(dst) + k,
                make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
  }
#else
#pragma unroll
  for (int k = 0; k < kRow<kCorner>; ++k) atomicAdd(dst + k, v[k]);
#endif
}

template <bool kCorner, int DT>
__global__ void __launch_bounds__(kThreads)
    encode_fwd(const float* __restrict__ table, const float* __restrict__ pos,
               const float* __restrict__ res, float* __restrict__ out, int N,
               int L, int log2T) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // N * L * kF < 2^31
  if (i >= N * L) return;
  const int n = i / L;
  const int l = i - n * L;
  const Cell cell = locate(pos, n, __ldg(res + l));
  // The 8 corners' features and weights.
  float v[8 * kF], w[8];
  if constexpr (kCorner) {
#pragma unroll
    for (int c = 0; c < 8; ++c) load_row<true>(table + row_offset<true>(cell, c, l, log2T), v + c * kF);
  } else {
    load_row<false>(table + row_offset<false>(cell, 0, l, log2T), v);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) w[c] = corner_weight(cell, c);
  float* dst = out + static_cast<size_t>(i) * kF;
#pragma unroll
  for (int f = 0; f < kF; ++f)
    dst[f] = corner_sum([&](int c) { return __fmul_rn(round_to<DT>(v[c * kF + f]), w[c]); });
}

template <bool kCorner, int DT>
__global__ void __launch_bounds__(kThreads)
    encode_bwd(const float* __restrict__ grad_out, const float* __restrict__ pos,
               const float* __restrict__ res, float* __restrict__ grad_table,
               int N, int L, int log2T) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N * L) return;
  const int n = i / L;
  const int l = i - n * L;
  const Cell cell = locate(pos, n, __ldg(res + l));
  float go[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) go[f] = __ldg(grad_out + static_cast<size_t>(i) * kF + f);
  // Corner c's cotangents, go * w rounded to the gather dtype.
  float v[8 * kF];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(cell, c);
#pragma unroll
    for (int f = 0; f < kF; ++f) v[c * kF + f] = round_to<DT>(__fmul_rn(go[f], w));
  }
  if constexpr (kCorner) {
#pragma unroll
    for (int c = 0; c < 8; ++c) add_row<true>(grad_table + row_offset<true>(cell, c, l, log2T), v + c * kF);
  } else {
    add_row<false>(grad_table + row_offset<false>(cell, 0, l, log2T), v);
  }
}

// Rounds every entry of the summed gradient to the gather dtype once.
template <int DT>
__global__ void __launch_bounds__(kThreads) round_entries(float* __restrict__ g, size_t count) {
  const size_t quads = count / 4;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  float4* g4 = reinterpret_cast<float4*>(g);
  for (size_t k = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; k < quads; k += stride) {
    float4 q = g4[k];
    q.x = round_to<DT>(q.x);
    q.y = round_to<DT>(q.y);
    q.z = round_to<DT>(q.z);
    q.w = round_to<DT>(q.w);
    g4[k] = q;
  }
  for (size_t k = quads * 4 + static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; k < count;
       k += stride)
    g[k] = round_to<DT>(g[k]);
}

unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

template <bool kCorner, int DT>
int launch(const float* table, const float* pos, const float* res, float* out,
           const float* grad_out, float* grad_table, int N, int L, int log2T,
           cudaStream_t s) {
  const unsigned blocks = blocks_for(static_cast<long long>(N) * L);
  if (grad_out == nullptr) {
    encode_fwd<kCorner, DT><<<blocks, kThreads, 0, s>>>(table, pos, res, out, N, L, log2T);
    return cudaGetLastError();
  }
  const size_t count = (static_cast<size_t>(L) << log2T) * kRow<kCorner>;
  cudaError_t err = cudaMemsetAsync(grad_table, 0, count * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if (N > 0)
    encode_bwd<kCorner, DT><<<blocks, kThreads, 0, s>>>(grad_out, pos, res, grad_table, N, L,
                                                        log2T);
  if constexpr (DT != kF32) {
    // At most kRoundBlocks blocks, each striding over the table.
    const unsigned want = blocks_for(static_cast<long long>(count / 4) + 1);
    round_entries<DT><<<want < kRoundBlocks ? want : kRoundBlocks, kThreads, 0, s>>>(grad_table,
                                                                                  count);
  }
  return cudaGetLastError();
}

template <bool kCorner>
int launch_dtype(int dtype, const float* table, const float* pos, const float* res,
                 float* out, const float* grad_out, float* grad_table, int N, int L,
                 int log2T, cudaStream_t s) {
  switch (dtype) {
    case kF32:
      return launch<kCorner, kF32>(table, pos, res, out, grad_out, grad_table, N, L, log2T, s);
    case kBF16:
      return launch<kCorner, kBF16>(table, pos, res, out, grad_out, grad_table, N, L, log2T, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward when grad_out is null: out [N, L * 2] from table [L, 2^log2T, W]
// (W = 16 in cell mode, 2 in corner mode) and positions [N, 3].  Backward
// otherwise: grad_table [L, 2^log2T, W] from grad_out [N, L * 2]; table and
// out are not read.  res holds the L levels' resolutions as float; dtype is
// the gather dtype (0 float32, 1 bfloat16).
extern "C" int hash_encode(const float* table, const float* pos, const float* res,
                           float* out, const float* grad_out, float* grad_table, int N,
                           int L, int log2T, int corner, int dtype, void* stream) {
  if (N < 0 || L <= 0 || log2T <= 0 || log2T > 30) return cudaErrorInvalidValue;
  if (N == 0 && grad_out == nullptr) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return corner ? launch_dtype<true>(dtype, table, pos, res, out, grad_out, grad_table, N, L,
                                     log2T, s)
                : launch_dtype<false>(dtype, table, pos, res, out, grad_out, grad_table, N, L,
                                      log2T, s);
}
