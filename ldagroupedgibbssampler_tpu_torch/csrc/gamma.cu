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
// normalise it over the last axis (a block a tile of whole rows, one
// launch; or, for rows too few to fill the card or too long for a tile,
// as phi [K, V] of the PCGS family, two launches: each row cut into
// chunks whose sums a second launch adds in a fixed order before the
// divide) or over axis 0 of a matrix (two launches: the draws with
// per-tile column sums, then the column totals summed in a fixed order
// and the divide). No float atomics: every sum is taken in an order fixed
// by the launch shape. The shapes come as f32 concentrations or as int32
// counts plus a prior (a scalar, or a vector along the last axis):
// a = f32(count) + prior, the same single f32 add as the callers'
// `counts.to(float32) + prior`.
//
// The key is the 64-bit seed read from device memory (drawn by the caller
// from its torch.Generator), the counter a function of the element's flat
// index and the round alone, so the draws do not depend on the launch
// shape or on which thread runs which round, and a captured CUDA graph
// replays them from a new seed. The arithmetic is written with __f*_rn
// intrinsics (no FMA contraction) in the order of
// ops/cuda_gamma.py::gamma_reference, which draws the same Philox words;
// the two differ only by the math library's last bits, so an element can
// differ where a round's accept test is a tie.
//
// What bounds it on the H100: at the ggs K=100 shapes (theta [11,269,
// 100], phi [20,000, 100]) each element reads 4 B and writes 4 B, 25 MB in
// all, ~7.5 us at 3.35 TB/s; but each element also runs one or two Philox
// blocks (10 rounds of two 32 x 32 -> 64-bit multiplies, four 32-bit
// multiply operations a round) and ~5 transcendental calls a round, and
// the integer multiplies alone take ~15 us at 64 a clock on each of 132
// SMs. The design (the draw itself, `draw_tile`, sits in marsaglia.cuh,
// shared with csrc/vs_dirichlet.cu and csrc/hdp.cu):
//   - one element a thread: a block draws a tile of elements, whole rows
//     of the Dirichlet where they fit, in steps of its 256 threads;
//   - round 0 for every element; the ~4% that reject go to a queue in
//     shared memory (a warp's rejects appended together), and the later
//     rounds run over the queue, so a warp runs a second round only where
//     its 32 queued elements need one, not wherever one of 32 neighbours
//     rejects;
//   - the draws stay in shared memory until their sums are taken there in
//     an order fixed by the tile, and a row that fits the tile is divided
//     in the block and written once;
//   - over axis 0, a tile of whole rows where C <= 128, else 128 columns
//     wide, a constant, so that no index is divided by a runtime width;
//     the second launch's blocks re-sum their columns' tile sums, so a
//     block divides at least 512 rows and the grid stays near 2,048.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "marsaglia.cuh"

namespace {

constexpr int kThreads = 256;                         // every draw kernel
static_assert(kThreads == kTileThreads, "draw_tile runs on the whole block");
constexpr int kTile = 1024;                           // elementwise tile
constexpr int kLongChunk = 2048;                      // elements a block
constexpr int kColTileCols = 128;                     // axis 0, launch 1
constexpr int kNormCols = 32;                         // axis 0, launch 2:
constexpr int kNormRows = 512;                        // at least these rows
constexpr int kNormBlocks = 2048;                     // a block, these blocks
constexpr int kMaxShared = 48 * 1024;                 // a block's tile

// rows [r0, ...) and columns [c0, c0 + nc) of [R, C], nc <= kColTileCols:
// element e at row r0 + e / kColTileCols, column c0 + e % kColTileCols
struct ColTile {
  long long r0;
  int c0, nc, C;
  __device__ __forceinline__ bool valid(int e) const {
    return e % kColTileCols < nc;
  }
  __device__ __forceinline__ long long i(int e) const {
    return (r0 + e / kColTileCols) * C + k(e);
  }
  __device__ __forceinline__ int k(int e) const {
    return c0 + e % kColTileCols;
  }
};

// elementwise: a block draws elements [blockIdx.x * kTile, + kTile)
__global__ void __launch_bounds__(kThreads)
    gamma_kernel(const float* __restrict__ a,
                 const long long* __restrict__ seed, float* __restrict__ out,
                 int* __restrict__ rounds, long long n) {
  __shared__ float g_s[kTile];
  __shared__ int q_s[kTile];
  __shared__ int qn_s;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int E = static_cast<int>(n - base < kTile ? n - base : kTile);
  const Shapes shapes{a, nullptr, 0.f, false};
  draw_tile(shapes, Span{base, 0}, E, static_cast<unsigned long long>(seed[0]),
            false, g_s, q_s, &qn_s, rounds);
  for (int e = threadIdx.x; e < E; e += kThreads) out[base + e] = g_s[e];
}

// last axis, rows that fit a tile: a block draws rows [blockIdx.x * tr,
// + tr) of K, floors, sums each row (a warp a row, or the block where the
// tile is one row: each thread's in order, the xor butterfly, the warps
// in order) and writes each draw once, divided
__global__ void __launch_bounds__(kThreads)
    dirichlet_rows_kernel(Shapes shapes, const long long* __restrict__ seed,
                          float* __restrict__ out, long long rows, int K,
                          int tr) {
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);         // [tr * K]
  int* q_s = reinterpret_cast<int*>(g_s + tr * K);      // [tr * K]
  float* sum_s = reinterpret_cast<float*>(q_s + tr * K);  // [max(tr, 8)]
  __shared__ int qn_s;
  const long long r0 = static_cast<long long>(blockIdx.x) * tr;
  const int nrows = static_cast<int>(rows - r0 < tr ? rows - r0 : tr);
  const int E = nrows * K;
  draw_tile(shapes, Rows{r0 * K, K}, E,
            static_cast<unsigned long long>(seed[0]), true, g_s, q_s, &qn_s,
            nullptr);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (tr == 1) {
    float s = 0.f;
    for (int k = threadIdx.x; k < K; k += kThreads) s = __fadd_rn(s, g_s[k]);
    s = warp_sum(s);
    if (lane == 0) sum_s[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, sum_s[w]);
      sum_s[0] = t;
    }
  } else {
    for (int row = warp; row < nrows; row += kThreads / 32) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s = __fadd_rn(s, g_s[row * K + k]);
      s = warp_sum(s);
      if (lane == 0) sum_s[row] = s;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads)
    out[r0 * K + e] = __fdiv_rn(g_s[e], sum_s[e / K]);
}

// long rows, launch 1: block row * chunks + chunk draws elements
// [chunk * kLongChunk, + kLongChunk) of the row, floored, and writes
// them and their sum (each thread's in order, the xor butterfly, the
// warps in order)
__global__ void __launch_bounds__(kThreads)
    dirichlet_long_draw_kernel(Shapes shapes,
                               const long long* __restrict__ seed,
                               float* __restrict__ out,
                               float* __restrict__ partial, int K,
                               int chunks) {
  __shared__ float g_s[kLongChunk];
  __shared__ int q_s[kLongChunk];
  __shared__ float sums[kThreads / 32];
  __shared__ int qn_s;
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long base = row * K + static_cast<long long>(chunk) * kLongChunk;
  const int E = min(kLongChunk, K - chunk * kLongChunk);
  draw_tile(shapes, Span{base, chunk * kLongChunk}, E,
            static_cast<unsigned long long>(seed[0]), true, g_s, q_s, &qn_s,
            nullptr);
  float sum = 0.f;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    out[base + e] = g_s[e];
    sum = __fadd_rn(sum, g_s[e]);
  }
  sum = warp_sum(sum);
  if (threadIdx.x % 32 == 0) sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, sums[w]);
    partial[blockIdx.x] = t;
  }
}

// long rows, launch 2: the row's total from its chunk sums (in order),
// then this block's chunk divided by it
__global__ void __launch_bounds__(kThreads)
    dirichlet_long_normalise_kernel(float* __restrict__ out,
                                    const float* __restrict__ partial, int K,
                                    int chunks) {
  __shared__ float total_s;
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  if (threadIdx.x == 0) {
    const float* p = partial + row * chunks;
    float t = 0.f;
    for (int j = 0; j < chunks; ++j) t = __fadd_rn(t, p[j]);
    total_s = t;
  }
  __syncthreads();
  const float total = total_s;
  const long long base = row * K + static_cast<long long>(chunk) * kLongChunk;
  const int E = min(kLongChunk, K - chunk * kLongChunk);
  for (int e = threadIdx.x; e < E; e += kThreads)
    out[base + e] = __fdiv_rn(out[base + e], total);
}

// axis 0 of [R, C], launch 1: block rc * ctiles + ct draws rows [rc * tr,
// + tr) of columns [ct * tc, + tc) (tc = C, whole rows, or kColTileCols),
// floored, writes them and each column's sum over the tile's rows (in row
// order) as partial[rc, c]
__global__ void __launch_bounds__(kThreads)
    dirichlet_cols_draw_kernel(Shapes shapes,
                               const long long* __restrict__ seed,
                               float* __restrict__ out,
                               float* __restrict__ partial, long long R,
                               int C, int tr, int tc) {
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);         // [tr * tc]
  int* q_s = reinterpret_cast<int*>(g_s + tr * tc);     // [tr * tc]
  __shared__ int qn_s;
  const int ctiles = (C + tc - 1) / tc;
  const long long rc = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x % ctiles) * tc;
  const long long r0 = rc * tr;
  const int nrows = static_cast<int>(R - r0 < tr ? R - r0 : tr);
  const int ncols = min(tc, C - c0);
  const int E = nrows * tc;
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  if (tc == C) {
    const Rows idx{r0 * C, C};
    draw_tile(shapes, idx, E, key, true, g_s, q_s, &qn_s, nullptr);
    for (int e = threadIdx.x; e < E; e += kThreads) out[idx.i(e)] = g_s[e];
  } else {
    const ColTile idx{r0, c0, ncols, C};
    draw_tile(shapes, idx, E, key, true, g_s, q_s, &qn_s, nullptr);
    for (int e = threadIdx.x; e < E; e += kThreads)
      if (idx.valid(e)) out[idx.i(e)] = g_s[e];
  }
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s = __fadd_rn(s, g_s[r * tc + c]);
    partial[rc * C + c0 + c] = s;
  }
}

// axis 0, launch 2: block (column tile, row chunk) takes its columns'
// totals from the tile sums (each of 8 threads a column strided over the
// tiles in order, then the 8 in order) and divides its norm_rows rows by
// them
__global__ void __launch_bounds__(kThreads)
    dirichlet_cols_normalise_kernel(float* __restrict__ out,
                                    const float* __restrict__ partial,
                                    long long R, int C, int tiles,
                                    int norm_rows) {
  constexpr int kTy = kThreads / kNormCols;
  __shared__ float sums[kTy][kNormCols + 1];
  const int tx = threadIdx.x % kNormCols, ty = threadIdx.x / kNormCols;
  const int ctiles = (C + kNormCols - 1) / kNormCols;
  const int c = (blockIdx.x % ctiles) * kNormCols + tx;
  const long long r0 =
      static_cast<long long>(blockIdx.x / ctiles) * norm_rows;
  float sum = 0.f;
  if (c < C)
    for (int j = ty; j < tiles; j += kTy)
      sum = __fadd_rn(sum, partial[static_cast<long long>(j) * C + c]);
  sums[ty][tx] = sum;
  __syncthreads();
  if (c >= C) return;
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < kTy; ++j) total = __fadd_rn(total, sums[j][tx]);
  const long long r1 = r0 + norm_rows < R ? r0 + norm_rows : R;
  for (long long r = r0 + ty; r < r1; r += kTy) {
    const long long i = r * C + c;
    out[i] = __fdiv_rn(out[i], total);
  }
}

}  // namespace

// a, out: f32 [n]; seed: int64 [1]; rounds (nullable): int32 [n], each
// element's accepted round (6: none, the mode kept).
extern "C" int lda_gamma(const void* a, const void* seed, void* out,
                         void* rounds, long long n, int device,
                         void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kTile - 1) / kTile;
  gamma_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const long long*>(seed),
      static_cast<float*>(out), static_cast<int*>(rounds), n);
  return static_cast<int>(cudaGetLastError());
}

// x: f32 [rows, K] concentrations (counts == 0) or int32 [rows, K] counts
// (counts == 1) with prior_vec (nullable, f32 [K]) or the scalar prior;
// out: f32 [rows, K], each row floored and normalised; a block draws
// tile_rows whole rows (ops/cuda_gamma.py::row_tile).
extern "C" int lda_dirichlet_rows(const void* x, int counts,
                                  const void* prior_vec, float prior,
                                  const void* seed, void* out,
                                  long long rows, int K, int tile_rows,
                                  int device, void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = 8 * tile_rows * K + 4 * max(tile_rows, kThreads / 32);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + tile_rows - 1) / tile_rows;
  const Shapes shapes{x, static_cast<const float*>(prior_vec), prior,
                      counts != 0};
  dirichlet_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      shapes, static_cast<const long long*>(seed), static_cast<float*>(out),
      rows, K, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// As lda_dirichlet_rows for few or long rows, in two launches; partial:
// f32 [rows, ceil(K / 2048)] scratch (the chunk sums).
extern "C" int lda_dirichlet_long_rows(const void* x, int counts,
                                       const void* prior_vec, float prior,
                                       const void* seed, void* out,
                                       void* partial, long long rows, int K,
                                       int device, void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const int chunks = (K + kLongChunk - 1) / kLongChunk;
  const long long blocks = rows * chunks;
  const auto st = static_cast<cudaStream_t>(stream);
  const Shapes shapes{x, static_cast<const float*>(prior_vec), prior,
                      counts != 0};
  dirichlet_long_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(
      shapes, static_cast<const long long*>(seed), static_cast<float*>(out),
      static_cast<float*>(partial), K, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dirichlet_long_normalise_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                    0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(partial), K,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

// As lda_dirichlet_rows, normalised over axis 0 of [R, C]; a block of
// launch 1 draws a tile of tile_rows x tile_cols, tile_cols C or 128
// (ops/cuda_gamma.py::col_tile); partial: f32 [ceil(R / tile_rows), C]
// scratch (the tiles' column sums). A block of launch 2 divides at least
// 512 rows, more where that leaves more than 2048 blocks.
extern "C" int lda_dirichlet_cols(const void* x, int counts,
                                  const void* prior_vec, float prior,
                                  const void* seed, void* out, void* partial,
                                  long long R, int C, int tile_rows,
                                  int tile_cols, int device, void* stream) {
  cudaSetDevice(device);
  if (R <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = 8 * tile_rows * tile_cols;
  if (smem > kMaxShared || (tile_cols != C && tile_cols != kColTileCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (R + tile_rows - 1) / tile_rows;
  const long long blocks1 = tiles * ((C + tile_cols - 1) / tile_cols);
  const long long ctiles2 = (C + kNormCols - 1) / kNormCols;
  const long long chunks = std::max(
      1LL, std::min((R + kNormRows - 1) / kNormRows, kNormBlocks / ctiles2));
  const long long norm_rows = (R + chunks - 1) / chunks;
  const long long blocks2 = ((R + norm_rows - 1) / norm_rows) * ctiles2;
  const auto st = static_cast<cudaStream_t>(stream);
  const Shapes shapes{x, static_cast<const float*>(prior_vec), prior,
                      counts != 0};
  dirichlet_cols_draw_kernel<<<static_cast<unsigned>(blocks1), kThreads, smem,
                               st>>>(
      shapes, static_cast<const long long*>(seed), static_cast<float*>(out),
      static_cast<float*>(partial), R, C, tile_rows, tile_cols);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dirichlet_cols_normalise_kernel<<<static_cast<unsigned>(blocks2), kThreads,
                                    0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(partial), R, C,
      static_cast<int>(tiles), static_cast<int>(norm_rows));
  return static_cast<int>(cudaGetLastError());
}
