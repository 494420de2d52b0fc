// Polya-Urn phi rows and elementwise Poisson draws for Hopper (sm_90a).
//
// Replaces the XLA program of ldagroupedgibbssampler_tpu/ops/random.py:185
// `polya_urn_dirichlet` (and `poisson`, :336): per row of counts [rows, L]
// (N_kw in the `kv` layout, [K, V]),
//
//   c ~ Poisson(f32(count) + beta)      (csrc/discrete.cuh, element = flat
//                                         index)
//   phi = c / total, or 1/L where the row's total is 0,
//
// and, for the HDP family (ldagroupedgibbssampler_tpu/models/hdp.py:301),
// rows whose topic is inactive written as zeros in the same pass (their
// counts are not drawn). The zero mask (c == 0) is written only where the
// caller passes one. No Pallas kernel: the JAX package lets XLA fuse the
// draw and the normalisation; the port ran torch.poisson and ~4 launches.
//
// Two launches, as the long rows of csrc/gamma.cu: a block draws a chunk
// of 2,048 values of a row, writes them and their f64 sum; a second launch
// adds a row's chunk sums in order and divides its chunk. The totals are
// integers (exact in f64 in any order); the normalisation is one f32
// division, as the plain version's.
//
// What bounds it on the H100: at K = 100, V = 20,000 it reads N_kw (8 MB)
// and writes phi (8 MB), ~5 us at 3.35 TB/s, and draws 2M Poissons of one
// Philox block each (almost all lam = beta = 0.01, one inversion step):
// ~80M 32-bit multiplies, ~10 us at 64 a clock an SM. Operations bound it.

#include <cuda_runtime.h>

#include <cstdint>

#include "discrete.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;

// lam of element i: f32(count) + beta, count int32 or f32
struct Rates {
  const void* x;
  bool ints;
  float beta;
  __device__ __forceinline__ float at(long long i) const {
    const float c = ints ? static_cast<float>(static_cast<const int*>(x)[i])
                         : static_cast<const float*>(x)[i];
    return __fadd_rn(c, beta);
  }
};

__device__ __forceinline__ double block_sum(double v, double* warp_s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (threadIdx.x % 32 == 0) warp_s[threadIdx.x / 32] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += warp_s[w];
  return t;
}

__global__ void __launch_bounds__(kThreads)
    poisson_kernel(const float* __restrict__ lam,
                   const long long* __restrict__ seed, float* __restrict__ out,
                   long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (e >= n) return;
  out[e] = poisson_draw(static_cast<unsigned long long>(seed[0]),
                        static_cast<unsigned long long>(e), lam[e]);
}

// launch 1: block row * chunks + chunk draws its chunk of the row
__global__ void __launch_bounds__(kThreads)
    urn_draw_kernel(Rates rates, const unsigned char* __restrict__ active,
                    const long long* __restrict__ seed,
                    float* __restrict__ out, unsigned char* __restrict__ zero,
                    double* __restrict__ partial, int L, int chunks) {
  __shared__ double warp_s[kThreads / 32];
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long base = row * L + static_cast<long long>(chunk) * kChunk;
  const int E = min(kChunk, L - chunk * kChunk);
  const bool live = active == nullptr || active[row];
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  double sum = 0.0;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const long long i = base + e;
    const float c = live ? poisson_draw(key, static_cast<unsigned long long>(i),
                                        rates.at(i))
                         : 0.f;
    out[i] = c;
    if (zero != nullptr) zero[i] = c == 0.f;
    sum += c;
  }
  sum = block_sum(sum, warp_s);
  if (threadIdx.x == 0) partial[blockIdx.x] = sum;
}

// launch 2: the row's total from its chunk sums, in order; the divide
__global__ void __launch_bounds__(kThreads)
    urn_normalise_kernel(float* __restrict__ out,
                         const double* __restrict__ partial,
                         const unsigned char* __restrict__ active, int L,
                         int chunks) {
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long base = row * L + static_cast<long long>(chunk) * kChunk;
  const int E = min(kChunk, L - chunk * kChunk);
  if (active != nullptr && !active[row]) return;     // zeros already
  double t = 0.0;
  for (int j = 0; j < chunks; ++j) t += partial[row * chunks + j];
  const float total = static_cast<float>(t);
  const float uniform = LDA_F32(1.0 / L);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const long long i = base + e;
    out[i] = total > 0.f ? __fdiv_rn(out[i], fmaxf(total, 1.f)) : uniform;
  }
}

}  // namespace

// lam, out: f32 [n]; seed: int64 [1]. out = Poisson(lam) elementwise.
extern "C" int lda_poisson(const void* lam, const void* seed, void* out,
                           long long n, int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kThreads - 1) / kThreads;
  poisson_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lam), static_cast<const long long*>(seed),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// x: [rows, L] counts, int32 (ints == 1) or f32; beta: the prior; active:
// bool [rows] or null; seed: int64 [1]; out: f32 [rows, L]; zero: bool
// [rows, L] or null; partial: f64 [rows, ceil(L / 2048)] scratch.
extern "C" int lda_polya_urn(const void* x, int ints, float beta,
                             const void* active, const void* seed, void* out,
                             void* zero, void* partial, long long rows, int L,
                             int device, void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  const int chunks = (L + kChunk - 1) / kChunk;
  const long long blocks = rows * chunks;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* act = static_cast<const unsigned char*>(active);
  urn_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      Rates{x, ints != 0, beta}, act, static_cast<const long long*>(seed),
      static_cast<float*>(out), static_cast<unsigned char*>(zero),
      static_cast<double*>(partial), L, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  urn_normalise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<float*>(out), static_cast<const double*>(partial), act, L,
      chunks);
  return static_cast<int>(cudaGetLastError());
}
