// Fused Marsaglia-Tsang Gamma and Dirichlet draws for Hopper (sm_90a).
//
// Replaces the XLA program of ldagroupedgibbssampler_tpu/ops/random.py:43
// (`_gamma_marsaglia`, 6 Python-unrolled rounds that XLA fuses into one
// elementwise kernel) and of `dirichlet` (:113) above it. Per element i
// with shape a:
//
//   a_eff = a < 1 ? a + 1 : a;   d = a_eff - 1/3;   c = rsqrt(9 d)
//   round r = 0..5 (Philox block at counter 8 i + r, words x, y, z):
//     u1, u2, u = (top 23 bits + 1/2) * 2^-23 of x, y, z   (in (0, 1))
//     x' = sqrt(-2 log u1) cos(2 pi u2)                       (Box-Muller)
//     v = (1 + c x')^3
//     accept if v > 0 and log u < x'^2 / 2 + d - d v + d log v
//   out = d v of the first accepted round, else the mode d;
//   a < 1: out *= exp(log(ub) / max(a, FLT_MIN)), ub from the block at
//   counter 8 i + 6 (the boost G(a) = G(a + 1) U^(1/a); a = 0 gives an
//   exact 0, Gamma(0) being a point mass at 0).
//
// The Dirichlet kernels floor each draw at 1e-30 (DIRICHLET_FLOOR) and
// normalise it over the last axis (one warp a row, one launch; or, for
// rows too few to fill the card, as phi [K, V] of the PCGS family, two
// launches: each row cut into chunks whose sums a second launch adds in a
// fixed order before the divide) or over axis 0 of a matrix (two
// launches: the draws with per-chunk column sums, then the column totals
// summed in a fixed order and the divide). No float
// atomics: every sum is taken in an order fixed by the launch shape. The
// shapes come as f32 concentrations or as int32 counts plus a prior (a
// scalar, or a vector along the last axis): a = f32(count) + prior, the
// same single f32 add as the callers' `counts.to(float32) + prior`.
//
// The key is the 64-bit seed read from device memory (drawn by the caller
// from its torch.Generator), the counter a function of the element's flat
// index and the round alone, so the draws do not depend on the launch
// shape and a captured CUDA graph replays them from a new seed. The
// arithmetic is written with __f*_rn intrinsics (no FMA contraction) in
// the order of ops/cuda_gamma.py::gamma_reference, which draws the same
// Philox words; the two differ only by the math library's last bits, so an
// element can differ where a round's accept test is a tie.
//
// What bounds it on the H100: at the ggs K=100 shapes (theta [11,269, 100],
// phi [20,000, 100]) the bytes: each element reads 4 B and writes 4 B, 25 MB
// in all, ~7.5 us at 3.35 TB/s; the arithmetic is a Philox block (integer
// multiplies) and 3-4 transcendentals per round, ~1.05 rounds on average.
// The design does one element a thread and leaves the round loop at the
// first accept (the later rounds cannot change the result), so a draw
// costs one pass over its input and output instead of the ~25 elementwise
// launches a round of the plain version.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kRounds = 6;
constexpr unsigned long long kBlocksPerElement = 8;   // rounds, then boost
constexpr float kInv23 = 1.1920928955078125e-7f;      // 2^-23
constexpr float kThird = 0.333333343f;                // f32(1 / 3)
constexpr float kTwoPi = 6.28318548f;                 // f32(2 pi)
constexpr float kFloor = 1e-30f;                      // DIRICHLET_FLOOR
constexpr int kThreads = 256;
constexpr int kRowWarps = 8;                          // rows a block
constexpr int kColTile = 32;                          // columns a block
constexpr int kColThreads = 8;                        // row threads a column
constexpr int kChunkRows = 128;                       // rows a block (axis 0)
constexpr int kLongThreads = 256;                     // a block of a long row
constexpr int kLongChunk = 2048;                      // elements a block

// (top 23 bits + 1/2) * 2^-23: in (0, 1), exact in f32
__device__ __forceinline__ float unit23(unsigned w) {
  return __fmul_rn(__fadd_rn(static_cast<float>(w >> 9), 0.5f), kInv23);
}

// Gamma(a, 1) of element i; *round gets the accepted round (kRounds: none)
__device__ __forceinline__ float marsaglia(float a, unsigned long long seed,
                                           long long i, int* round) {
  const bool small = a < 1.f;
  const float d = __fsub_rn(small ? __fadd_rn(a, 1.f) : a, kThird);
  const float c = rsqrtf(__fmul_rn(9.f, d));
  const unsigned long long base =
      static_cast<unsigned long long>(i) * kBlocksPerElement;
  float out = d;
  int acc = kRounds;
  for (int r = 0; r < kRounds; ++r) {
    const uint4 w = philox4(seed, base + r);
    const float x = __fmul_rn(sqrtf(__fmul_rn(-2.f, logf(unit23(w.x)))),
                              cosf(__fmul_rn(kTwoPi, unit23(w.y))));
    const float v1 = __fadd_rn(1.f, __fmul_rn(c, x));
    const float v = __fmul_rn(__fmul_rn(v1, v1), v1);
    if (v > 0.f) {
      const float rhs = __fadd_rn(
          __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, x), x), d),
                    __fmul_rn(d, v)),
          __fmul_rn(d, logf(v)));
      if (logf(unit23(w.z)) < rhs) {
        out = __fmul_rn(d, v);
        acc = r;
        break;
      }
    }
  }
  if (small) {
    const float ub = unit23(philox4(seed, base + kRounds).x);
    out = __fmul_rn(out, expf(__fdiv_rn(logf(ub), fmaxf(a, FLT_MIN))));
  }
  *round = acc;
  return out;
}

// The shape of element i: an f32 concentration, or f32(count) + prior with
// the prior a scalar or a vector along the last axis (of length `last`)
template <bool kCounts>
__device__ __forceinline__ float shape_at(const void* x,
                                          const float* __restrict__ prior_vec,
                                          float prior, long long i, int last) {
  if (!kCounts) return static_cast<const float*>(x)[i];
  const float p = prior_vec != nullptr ? prior_vec[i % last] : prior;
  return __fadd_rn(static_cast<float>(static_cast<const int*>(x)[i]), p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    gamma_kernel(const float* __restrict__ a,
                 const long long* __restrict__ seed, float* __restrict__ out,
                 int* __restrict__ rounds, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
  int r;
  out[i] = marsaglia(a[i], static_cast<unsigned long long>(seed[0]), i, &r);
  if (rounds != nullptr) rounds[i] = r;
}

// one warp a row of K: draw, floor, sum, divide
template <bool kCounts>
__global__ void __launch_bounds__(kRowWarps * 32)
    dirichlet_rows_kernel(const void* x, const float* __restrict__ prior_vec,
                          float prior, const long long* __restrict__ seed,
                          float* __restrict__ out, long long rows, int K) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const unsigned long long s = static_cast<unsigned long long>(seed[0]);
  const long long base = row * K;
  float sum = 0.f;
  for (int k = lane; k < K; k += 32) {
    int r;
    const float g = fmaxf(
        marsaglia(shape_at<kCounts>(x, prior_vec, prior, base + k, K), s,
                  base + k, &r),
        kFloor);
    out[base + k] = g;
    sum = __fadd_rn(sum, g);
  }
  sum = warp_sum(sum);
  for (int k = lane; k < K; k += 32)
    out[base + k] = __fdiv_rn(out[base + k], sum);
}

// axis 0 of [R, C], launch 1: a block draws rows [chunk * kChunkRows, +
// kChunkRows) of kColTile columns and writes each column's chunk sum
template <bool kCounts>
__global__ void __launch_bounds__(kColTile * kColThreads)
    dirichlet_cols_draw_kernel(const void* x,
                               const float* __restrict__ prior_vec,
                               float prior,
                               const long long* __restrict__ seed,
                               float* __restrict__ out,
                               float* __restrict__ partial, long long R,
                               int C) {
  __shared__ float sums[kColThreads][kColTile + 1];
  const int tx = threadIdx.x % kColTile, ty = threadIdx.x / kColTile;
  const int c = blockIdx.x * kColTile + tx;
  const long long r0 = static_cast<long long>(blockIdx.y) * kChunkRows;
  const long long r1 = r0 + kChunkRows < R ? r0 + kChunkRows : R;
  const unsigned long long s = static_cast<unsigned long long>(seed[0]);
  float sum = 0.f;
  if (c < C) {
    for (long long r = r0 + ty; r < r1; r += kColThreads) {
      const long long i = r * C + c;
      int rd;
      const float g = fmaxf(
          marsaglia(shape_at<kCounts>(x, prior_vec, prior, i, C), s, i, &rd),
          kFloor);
      out[i] = g;
      sum = __fadd_rn(sum, g);
    }
  }
  sums[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kColThreads; ++j) t = __fadd_rn(t, sums[j][tx]);
    partial[static_cast<long long>(blockIdx.y) * C + c] = t;
  }
}

// axis 0, launch 2: the column totals from the chunk sums (a fixed order),
// then this block's rows divided by them
__global__ void __launch_bounds__(kColTile * kColThreads)
    dirichlet_cols_normalise_kernel(float* __restrict__ out,
                                    const float* __restrict__ partial,
                                    long long R, int C, int chunks) {
  __shared__ float sums[kColThreads][kColTile + 1];
  const int tx = threadIdx.x % kColTile, ty = threadIdx.x / kColTile;
  const int c = blockIdx.x * kColTile + tx;
  float sum = 0.f;
  if (c < C)
    for (int j = ty; j < chunks; j += kColThreads)
      sum = __fadd_rn(sum, partial[static_cast<long long>(j) * C + c]);
  sums[ty][tx] = sum;
  __syncthreads();
  if (c >= C) return;
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < kColThreads; ++j) total = __fadd_rn(total, sums[j][tx]);
  const long long r0 = static_cast<long long>(blockIdx.y) * kChunkRows;
  const long long r1 = r0 + kChunkRows < R ? r0 + kChunkRows : R;
  for (long long r = r0 + ty; r < r1; r += kColThreads) {
    const long long i = r * C + c;
    out[i] = __fdiv_rn(out[i], total);
  }
}

// long rows, launch 1: block (chunk, row) draws elements [chunk *
// kLongChunk, + kLongChunk) of the row and writes their sum
template <bool kCounts>
__global__ void __launch_bounds__(kLongThreads)
    dirichlet_long_draw_kernel(const void* x,
                               const float* __restrict__ prior_vec,
                               float prior,
                               const long long* __restrict__ seed,
                               float* __restrict__ out,
                               float* __restrict__ partial, int K) {
  __shared__ float sums[kLongThreads / 32];
  const long long base = static_cast<long long>(blockIdx.y) * K;
  const int k0 = blockIdx.x * kLongChunk;
  const int k1 = min(k0 + kLongChunk, K);
  const unsigned long long s = static_cast<unsigned long long>(seed[0]);
  float sum = 0.f;
  for (int k = k0 + threadIdx.x; k < k1; k += kLongThreads) {
    int r;
    const float g = fmaxf(
        marsaglia(shape_at<kCounts>(x, prior_vec, prior, base + k, K), s,
                  base + k, &r),
        kFloor);
    out[base + k] = g;
    sum = __fadd_rn(sum, g);
  }
  sum = warp_sum(sum);
  if (threadIdx.x % 32 == 0) sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kLongThreads / 32; ++w) t = __fadd_rn(t, sums[w]);
    partial[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = t;
  }
}

// long rows, launch 2: the row's total from its chunk sums (in order),
// then this block's chunk divided by it
__global__ void __launch_bounds__(kLongThreads)
    dirichlet_long_normalise_kernel(float* __restrict__ out,
                                    const float* __restrict__ partial,
                                    int K) {
  __shared__ float total_s;
  const long long base = static_cast<long long>(blockIdx.y) * K;
  if (threadIdx.x == 0) {
    const float* p = partial + static_cast<long long>(blockIdx.y) * gridDim.x;
    float t = 0.f;
    for (unsigned j = 0; j < gridDim.x; ++j) t = __fadd_rn(t, p[j]);
    total_s = t;
  }
  __syncthreads();
  const float total = total_s;
  const int k0 = blockIdx.x * kLongChunk;
  const int k1 = min(k0 + kLongChunk, K);
  for (int k = k0 + threadIdx.x; k < k1; k += kLongThreads)
    out[base + k] = __fdiv_rn(out[base + k], total);
}

}  // namespace

// a, out: f32 [n]; seed: int64 [1]; rounds (nullable): int32 [n], each
// element's accepted round (6: none, the mode kept).
extern "C" int lda_gamma(const void* a, const void* seed, void* out,
                         void* rounds, long long n, int device,
                         void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kThreads - 1) / kThreads;
  gamma_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const long long*>(seed),
      static_cast<float*>(out), static_cast<int*>(rounds), n);
  return static_cast<int>(cudaGetLastError());
}

// x: f32 [rows, K] concentrations (counts == 0) or int32 [rows, K] counts
// (counts == 1) with prior_vec (nullable, f32 [K]) or the scalar prior;
// out: f32 [rows, K], each row floored and normalised.
extern "C" int lda_dirichlet_rows(const void* x, int counts,
                                  const void* prior_vec, float prior,
                                  const void* seed, void* out,
                                  long long rows, int K, int device,
                                  void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
  const auto kernel = counts ? dirichlet_rows_kernel<true>
                             : dirichlet_rows_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kRowWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(prior_vec), prior,
      static_cast<const long long*>(seed), static_cast<float*>(out), rows, K);
  return static_cast<int>(cudaGetLastError());
}

// As lda_dirichlet_rows for few long rows (rows < 65536), in two launches;
// partial: f32 [rows, ceil(K / 2048)] scratch (the chunk sums).
extern "C" int lda_dirichlet_long_rows(const void* x, int counts,
                                       const void* prior_vec, float prior,
                                       const void* seed, void* out,
                                       void* partial, long long rows, int K,
                                       int device, void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + kLongChunk - 1) / kLongChunk,
                  static_cast<unsigned>(rows));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto draw = counts ? dirichlet_long_draw_kernel<true>
                           : dirichlet_long_draw_kernel<false>;
  draw<<<grid, kLongThreads, 0, st>>>(
      x, static_cast<const float*>(prior_vec), prior,
      static_cast<const long long*>(seed), static_cast<float*>(out),
      static_cast<float*>(partial), K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dirichlet_long_normalise_kernel<<<grid, kLongThreads, 0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(partial), K);
  return static_cast<int>(cudaGetLastError());
}

// As lda_dirichlet_rows, normalised over axis 0 of [R, C]; partial: f32
// [ceil(R / 128), C] scratch (the chunk sums).
extern "C" int lda_dirichlet_cols(const void* x, int counts,
                                  const void* prior_vec, float prior,
                                  const void* seed, void* out, void* partial,
                                  long long R, int C, int device,
                                  void* stream) {
  cudaSetDevice(device);
  if (R <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const long long chunks = (R + kChunkRows - 1) / kChunkRows;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kColTile - 1) / kColTile,
                  static_cast<unsigned>(chunks));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto draw = counts ? dirichlet_cols_draw_kernel<true>
                           : dirichlet_cols_draw_kernel<false>;
  draw<<<grid, kColTile * kColThreads, 0, st>>>(
      x, static_cast<const float*>(prior_vec), prior,
      static_cast<const long long*>(seed), static_cast<float*>(out),
      static_cast<float*>(partial), R, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dirichlet_cols_normalise_kernel<<<grid, kColTile * kColThreads, 0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(partial), R, C,
      static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}
