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
// One launch, a block a row: the row's n_k and zeroPhi, then p once, then
// gamma.cu's tile draw over chunks of 2,048 with the inclusion test and
// the f64 row sum (fixed order), then the divide. What bounds it on the
// H100: at K = 100, V = 20,000 it reads N_kw and the previous phi (16 MB)
// and writes phi (8 MB), ~7 us at 3.35 TB/s; the Gamma draws' and the
// uniforms' Philox multiplies (~2.1 blocks an element, ~170M) take ~10 us
// at 64 a clock an SM. Operations bound it; a block a row puts 100 blocks
// on 132 streaming multiprocessors, which a later PR may split.

#include <cuda_runtime.h>

#include <cstdint>

#include "marsaglia.cuh"

namespace {

constexpr int kThreads = kTileThreads;
constexpr int kChunk = 2048;

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

__global__ void __launch_bounds__(kThreads)
    vs_kernel(VsShapes shapes, const float* __restrict__ prev,
              const long long* __restrict__ seed, float* __restrict__ out,
              unsigned char* __restrict__ zero, int L, float vs_prior,
              float log_odds) {
  __shared__ float g_s[kChunk];
  __shared__ int q_s[kChunk];
  __shared__ int qn_s;
  __shared__ double warp_d[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * L;
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  double nk = 0.0;
  int zp = 0;
  for (int e = threadIdx.x; e < L; e += kThreads) {
    nk += shapes.count(base + e);
    if (prev != nullptr && prev[base + e] == 0.f) ++zp;
  }
  nk = block_sum(nk, warp_d);
  zp = block_sum(zp, warp_i);
  const float p = inclusion_prob(static_cast<float>(zp),
                                 static_cast<float>(nk), shapes.beta,
                                 vs_prior, log_odds);
  double sum = 0.0;
  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int E = min(kChunk, L - t0);
    draw_tile(shapes, Span{base + t0, t0}, E, key, true, g_s, q_s, &qn_s,
              nullptr);
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const long long i = base + t0 + e;
      const float u = unit23(
          philox4(key, static_cast<unsigned long long>(i) * kBlocksPerElement
                           + kRounds + 1).x);
      const bool include = shapes.count(i) > 0.f || u <= p;
      const float g = include ? g_s[e] : 0.f;
      out[i] = g;
      if (zero != nullptr) zero[i] = !include;
      sum += g;
    }
    __syncthreads();
  }
  sum = block_sum(sum, warp_d);
  const float total = fmaxf(static_cast<float>(sum), kFloor);
  for (int e = threadIdx.x; e < L; e += kThreads)
    out[base + e] = __fdiv_rn(out[base + e], total);
}

}  // namespace

// x: [rows, L] counts, int32 (ints == 1) or f32; prev: f32 [rows, L], the
// previous phi, or null (zeroPhi = 0); seed: int64 [1]; out: f32 [rows,
// L]; zero: bool [rows, L] (the excluded coordinates) or null; log_odds:
// f32(log(pi) - log1p(-pi)).
extern "C" int lda_vs_dirichlet(const void* x, int ints, float beta,
                                const void* prev, const void* seed, void* out,
                                void* zero, long long rows, int L,
                                float vs_prior, float log_odds, int device,
                                void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  vs_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      VsShapes{x, ints != 0, beta}, static_cast<const float*>(prev),
      static_cast<const long long*>(seed), static_cast<float*>(out),
      static_cast<unsigned char*>(zero), L, vs_prior, log_odds);
  return static_cast<int>(cudaGetLastError());
}
