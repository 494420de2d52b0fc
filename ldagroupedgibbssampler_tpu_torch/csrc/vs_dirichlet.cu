// Variable-selection (spike-and-slab) Dirichlet rows for Hopper (sm_90a).
//
// Replaces the XLA program of ldagroupedgibbssampler_tpu/ops/random.py:262
// `vs_dirichlet` (vectorised form), with `_lgamma_ratio` (:206) and
// `vs_inclusion_prob` (:231), as `nzvsspalias` draws phi [K, V]. Per row
// of counts (N_kw in the `kv` layout):
//
//   n_k = sum of the row's counts, zeroPhi = #exact zeros of the previous
//   phi row (0 without one);
//   p = vs_inclusion_prob(zeroPhi, n_k): with a = zeroPhi beta,
//       log r = lgr(a) - lgr(a + n_k) + log(pi / (1 - pi)), lgr(x) =
//       lgamma(x + beta) - lgamma(x) below x = 8, Stirling's series above;
//       -inf where zeroPhi = 0 < n_k; p = sigmoid(log r), pi where n_k = 0;
//   each coordinate i: g ~ Gamma(count + beta) (csrc/marsaglia.cuh:
//   gamma.cu's draw, Philox blocks 8 i .. 8 i + 6), floored at 1e-30;
//   u = unit23 of word x of block 8 i + 7; included where count > 0 or
//   u <= p; excluded coordinates 0; the row divided by max(its sum,
//   1e-30).
//
// p repeats ops/random.py::vs_inclusion_prob op for op as PyTorch runs it
// on the card (a Python scalar over a tensor is the tensor's reciprocal
// times the scalar; x ** 3 is x x x), so the plain version
// (ops/cuda_gamma.py::vs_dirichlet_reference) includes the same
// coordinates. The reference's sequential zeroPhi chain stays plain
// PyTorch (`sequential=True`, the parity knob of the Geweke tests).
//
// One launch, a row a thread-block cluster (ops/cuda_gamma.py::
// vs_launch_shape: up to 8 blocks, a slice of at least 2,048 values each).
// Each block sums its slice's n_k (f64) and zeroPhi; the ranks' sums meet
// in distributed shared memory (cluster.map_shared_rank), in rank order,
// and every block computes p. Then, a chunk of the slice at a time: each
// value's uniform first (block 8 i + 7) and its inclusion, the excluded
// ones 0 and the included ones listed; gamma.cu's tile draw over the list
// alone (an excluded value is 0 whatever its Gamma, so its draw is
// skipped and every lane of a warp draws), floored; the slice kept in the
// block's shared memory. The row's f64 sum meets the same way (each
// block's in a fixed order, then the ranks in order), and each block
// divides its slice and writes it once. Every value's draws come from its
// own Philox blocks whatever the geometry, so phi is the same bit for bit
// on any cluster size but where the sum's order moves the f32 total by an
// ulp.
//
// What bounds it on the H100: at K = 100, V = 20,000 it reads N_kw and
// the previous phi (16 MB) and writes phi (8 MB), ~7 us at 3.35 TB/s; the
// uniforms' and the included values' Philox multiplies (~1.8 blocks an
// element) take ~9 us at 64 a clock an SM. 800 blocks of 256 threads fill
// the card's warp slots three quarters at K = 100; the time is the
// blocks' chains of draws and barriers, not the bytes, so a slice that
// fits is drawn as one chunk of the list (the fewest barriers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "marsaglia.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = kTileThreads;

// f32(count) + beta; the count int32 or f32
struct VsShapes {
  const void* x;
  bool ints;
  float beta;
  __device__ __forceinline__ float count(long long i) const {
    return ints ? static_cast<float>(static_cast<const int*>(x)[i])
                : static_cast<const float*>(x)[i];
  }
  __device__ __forceinline__ float at(long long i, int) const {
    return __fadd_rn(count(i), beta);
  }
};

// lgamma(x + b) - lgamma(x) as ops/random.py::_lgamma_ratio runs on the card
__device__ float lgamma_ratio(float x, float b) {
  if (x < 8.f) return __fsub_rn(lgammaf(__fadd_rn(x, b)), lgammaf(x));
  const float xs = fmaxf(x, 1.f);
  const float xb = __fadd_rn(xs, b);
  float s = __fmul_rn(__fsub_rn(xs, 0.5f),
                      log1pf(__fmul_rn(__fdiv_rn(1.f, xs), b)));
  s = __fadd_rn(s, __fmul_rn(logf(xb), b));
  s = __fsub_rn(s, b);
  s = __fadd_rn(s, __fsub_rn(__fdiv_rn(1.f, __fmul_rn(xb, 12.f)),
                             __fdiv_rn(1.f, __fmul_rn(xs, 12.f))));
  const float xb3 = __fmul_rn(__fmul_rn(xb, xb), xb);
  const float xs3 = __fmul_rn(__fmul_rn(xs, xs), xs);
  return __fsub_rn(s, __fsub_rn(__fdiv_rn(1.f, __fmul_rn(xb3, 360.f)),
                                __fdiv_rn(1.f, __fmul_rn(xs3, 360.f))));
}

__device__ float inclusion_prob(float zero_phi, float n_k, float beta,
                                float vs_prior, float log_odds) {
  if (n_k <= 0.f) return vs_prior;
  if (zero_phi <= 0.f) return 0.f;         // log r = -inf
  const float a = __fmul_rn(zero_phi, beta);
  const float log_r = __fadd_rn(
      __fsub_rn(lgamma_ratio(a, beta), lgamma_ratio(__fadd_rn(a, n_k), beta)),
      log_odds);
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-log_r)));
}

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (threadIdx.x % 32 == 0) warp_s[threadIdx.x / 32] = v;
  __syncthreads();
  T t = T(0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += warp_s[w];
  __syncthreads();
  return t;
}

// The sum over the cluster's ranks, in rank order, of each block's `part`
// (a shared variable, written before the call)
template <typename T>
__device__ __forceinline__ T cluster_sum(cg::cluster_group& cluster,
                                         T* part) {
  cluster.sync();
  T t = T(0);
  for (unsigned r = 0; r < cluster.num_blocks(); ++r)
    t += *cluster.map_shared_rank(part, r);
  return t;
}

// the listed values of a chunk of a row from flat index base: the Gamma
// draws of the included ones alone
struct Listed {
  long long base;
  int k0;
  const unsigned short* list;
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ long long i(int e) const { return base + list[e]; }
  __device__ __forceinline__ int k(int e) const { return k0 + list[e]; }
};

// A row of L over a cluster of C blocks (the cluster dimension of the
// launch): rank r draws the slice [r S, min((r + 1) S, L)), S = the slice
// length, its first `resident` values kept in this block's shared memory,
// the rest (rows longer than the shared memory holds) written to `out`
// and read back for the division.
__global__ void __launch_bounds__(kThreads)
    vs_kernel(VsShapes shapes, const float* __restrict__ prev,
              const long long* __restrict__ seed, float* __restrict__ out,
              unsigned char* __restrict__ zero, int L, int slice,
              int chunk, int resident, float vs_prior, float log_odds) {
  extern __shared__ float smem[];
  float* g_row = smem;                                    // [resident]
  int* q_s = reinterpret_cast<int*>(smem + resident);     // [chunk]
  float* g_list = smem + resident + chunk;                // [chunk]
  unsigned short* list =                                  // [chunk]
      reinterpret_cast<unsigned short*>(smem + resident + 2 * chunk);
  __shared__ int qn_s, ln_s;
  __shared__ double warp_d[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  __shared__ double nk_part, sum_part;
  __shared__ int zp_part;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long base =
      static_cast<long long>(blockIdx.x / cluster.num_blocks()) * L;
  const int lo = min(L, rank * slice), hi = min(L, lo + slice);
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  // the row's n_k and zeroPhi: this slice's, then the ranks' in order
  double nk = 0.0;
  int zp = 0;
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    nk += shapes.count(base + e);
    if (prev != nullptr && prev[base + e] == 0.f) ++zp;
  }
  nk = block_sum(nk, warp_d);
  zp = block_sum(zp, warp_i);
  if (threadIdx.x == 0) {
    nk_part = nk;
    zp_part = zp;
  }
  nk = cluster_sum(cluster, &nk_part);
  zp = cluster_sum(cluster, &zp_part);
  const float p = inclusion_prob(static_cast<float>(zp),
                                 static_cast<float>(nk), shapes.beta,
                                 vs_prior, log_odds);
  // the slice a chunk at a time, each element from its own Philox blocks
  // (8 i .. 8 i + 7): the inclusion test first, then the Gamma draws of
  // the included values alone, listed so that a warp's lanes all draw (an
  // excluded value is 0 whatever its Gamma)
  const unsigned lane = threadIdx.x % 32;
  double sum = 0.0;
  for (int t0 = lo; t0 < hi; t0 += chunk) {
    const int E = min(chunk, hi - t0);
    const bool kept = t0 - lo + E <= resident;
    float* g_s = g_row + (t0 - lo);
    if (threadIdx.x == 0) ln_s = 0;
    __syncthreads();
    for (int e0 = 0; e0 < E; e0 += kThreads) {
      const int e = e0 + threadIdx.x;
      bool include = false;
      if (e < E) {
        const long long i = base + t0 + e;
        const float u = unit23(philox4(
            key, static_cast<unsigned long long>(i) * kBlocksPerElement +
                     kRounds + 1).x);
        include = shapes.count(i) > 0.f || u <= p;
        if (zero != nullptr) zero[i] = !include;
        if (!include) {
          if (kept)
            g_s[e] = 0.f;
          else
            out[i] = 0.f;
        }
      }
      const unsigned b = __ballot_sync(kFull, include);
      if (b != 0) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&ln_s, __popc(b));
        at = __shfl_sync(kFull, at, 0);
        if (include)
          list[at + __popc(b & ((1u << lane) - 1u))] =
              static_cast<unsigned short>(e);
      }
    }
    __syncthreads();
    const int nl = ln_s;
    draw_tile(shapes, Listed{base + t0, t0, list}, nl, key, true, g_list, q_s,
              &qn_s, nullptr);
    for (int q = threadIdx.x; q < nl; q += kThreads) {
      if (kept)
        g_s[list[q]] = g_list[q];
      else
        out[base + t0 + list[q]] = g_list[q];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads)
      sum += kept ? g_s[e] : out[base + t0 + e];
  }
  sum = block_sum(sum, warp_d);
  if (threadIdx.x == 0) sum_part = sum;
  sum = cluster_sum(cluster, &sum_part);
  // no block leaves while another reads its partial sums
  cluster.sync();
  const float total = fmaxf(static_cast<float>(sum), kFloor);
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    const float g = e - lo < resident ? g_row[e - lo] : out[base + e];
    out[base + e] = __fdiv_rn(g, total);
  }
}

}  // namespace

// x: [rows, L] counts, int32 (ints == 1) or f32; prev: f32 [rows, L], the
// previous phi, or null (zeroPhi = 0); seed: int64 [1]; out: f32 [rows,
// L]; zero: bool [rows, L] (the excluded coordinates) or null; log_odds:
// f32(log(pi) - log1p(-pi)). The geometry (ops/cuda_gamma.py::
// vs_launch_shape): `cluster` blocks a row (1 to 8), each a slice of
// `slice` values drawn `chunk` at a time, the first `resident` of them in
// shared memory (all, or whole chunks), `smem` bytes of dynamic shared
// memory a block (4 resident + 10 chunk at least). A launch the card
// refuses returns its error.
extern "C" int lda_vs_dirichlet(const void* x, int ints, float beta,
                                const void* prev, const void* seed, void* out,
                                void* zero, long long rows, int L,
                                int cluster, int slice, int chunk,
                                int resident, int smem, float vs_prior,
                                float log_odds, int device, void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  if (cluster < 1 || cluster > 8 || slice < 1 || chunk < 1 ||
      chunk > 65536 || static_cast<long long>(cluster) * slice < L ||
      resident < 0 || (resident < slice && resident % chunk != 0) ||
      4LL * resident + 10LL * chunk > smem || rows * cluster > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      vs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, vs_kernel, VsShapes{x, ints != 0, beta},
      static_cast<const float*>(prev), static_cast<const long long*>(seed),
      static_cast<float*>(out), static_cast<unsigned char*>(zero), L, slice,
      chunk, resident, vs_prior, log_odds);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
