// The Marsaglia-Tsang Gamma draw of the port's draw kernels (csrc/gamma.cu,
// csrc/vs_dirichlet.cu, csrc/hdp.cu's GEM sticks), moved here from
// csrc/gamma.cu unchanged, so that every kernel that draws a Gamma draws
// gamma.cu's values from the same Philox words: element i at counter
// 8 i + r for round r = 0..5, the a < 1 boost at 8 i + 6 (8 i + 7 is left
// to the caller). ops/cuda_gamma.py::gamma_reference is the plain version.
// Everything here is internal linkage (see philox.cuh).

#pragma once

#include <cfloat>

#include "philox.cuh"

namespace {

constexpr int kRounds = 6;
constexpr unsigned long long kBlocksPerElement = 8;   // rounds, then boost
constexpr float kThird = 0.333333343f;                // f32(1 / 3)
constexpr float kTwoPi = 6.28318548f;                 // f32(2 pi)
constexpr float kFloor = 1e-30f;                      // DIRICHLET_FLOOR
constexpr int kTileThreads = 256;                     // threads of draw_tile

// The shape of element i, in column k of the last axis: an f32
// concentration, or f32(count) + prior with the prior a scalar or a vector
// along the last axis
struct Shapes {
  const void* x;
  const float* prior_vec;
  float prior;
  bool counts;

  __device__ __forceinline__ float at(long long i, int k) const {
    if (!counts) return static_cast<const float*>(x)[i];
    const float p = prior_vec != nullptr ? prior_vec[k] : prior;
    return __fadd_rn(static_cast<float>(static_cast<const int*>(x)[i]), p);
  }
};

// round r of the draw with (d, c) at Philox counter base + r: whether it
// accepts, and then *out = d v
__device__ __forceinline__ bool mt_round(float d, float c,
                                         unsigned long long seed,
                                         unsigned long long base, int r,
                                         float* out) {
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
      *out = __fmul_rn(d, v);
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ float mt_d(float a) {
  return __fsub_rn(a < 1.f ? __fadd_rn(a, 1.f) : a, kThird);
}

// the a < 1 boost of a draw g
__device__ __forceinline__ float boost(float a, float g,
                                       unsigned long long seed,
                                       unsigned long long base) {
  if (!(a < 1.f)) return g;
  const float ub = unit23(philox4(seed, base + kRounds).x);
  return __fmul_rn(g, expf(__fdiv_rn(logf(ub), fmaxf(a, FLT_MIN))));
}

// Draws the elements e < E of a tile for which idx.valid(e) (at flat
// index idx.i(e), in column idx.k(e) of the last axis) into g_s[e],
// floored at kFloor when `floor`: round 0 for every element, the
// rejected ones appended to the queue q_s (a warp's together), then
// rounds 1..5 over the queue, one element a thread. `rounds` (nullable)
// receives each element's accepted round (kRounds: none). Ends with a
// barrier.
template <class ShapesT, class Index>
__device__ __forceinline__ void draw_tile(const ShapesT& shapes, Index idx,
                                          int E, unsigned long long seed,
                                          bool floor, float* g_s, int* q_s,
                                          int* qn_s, int* rounds) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) *qn_s = 0;
  __syncthreads();
  for (int e0 = 0; e0 < E; e0 += kTileThreads) {
    const int e = e0 + threadIdx.x;
    bool retry = false;
    if (e < E && idx.valid(e)) {
      const long long i = idx.i(e);
      const float a = shapes.at(i, idx.k(e));
      const float d = mt_d(a);
      const unsigned long long base =
          static_cast<unsigned long long>(i) * kBlocksPerElement;
      float g;
      if (mt_round(d, rsqrtf(__fmul_rn(9.f, d)), seed, base, 0, &g)) {
        g = boost(a, g, seed, base);
        g_s[e] = floor ? fmaxf(g, kFloor) : g;
        if (rounds != nullptr) rounds[i] = 0;
      } else {
        retry = true;
      }
    }
    const unsigned b = __ballot_sync(kFull, retry);
    if (b != 0) {
      int at = 0;
      if (lane == 0) at = atomicAdd(qn_s, __popc(b));
      at = __shfl_sync(kFull, at, 0);
      if (retry) q_s[at + __popc(b & ((1u << lane) - 1u))] = e;
    }
  }
  __syncthreads();
  const int nq = *qn_s;
  for (int q = threadIdx.x; q < nq; q += kTileThreads) {
    const int e = q_s[q];
    const long long i = idx.i(e);
    const float a = shapes.at(i, idx.k(e));
    const float d = mt_d(a);
    const float c = rsqrtf(__fmul_rn(9.f, d));
    const unsigned long long base =
        static_cast<unsigned long long>(i) * kBlocksPerElement;
    float g = d;
    int acc = kRounds;
    for (int r = 1; r < kRounds; ++r)
      if (mt_round(d, c, seed, base, r, &g)) {
        acc = r;
        break;
      }
    g = boost(a, g, seed, base);
    g_s[e] = floor ? fmaxf(g, kFloor) : g;
    if (rounds != nullptr) rounds[i] = acc;
  }
  __syncthreads();
}

// elements [k0, ...) of a row from flat index base: the elementwise
// draw, a chunk of a long row
struct Span {
  long long base;
  int k0;
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ long long i(int e) const { return base + e; }
  __device__ __forceinline__ int k(int e) const { return k0 + e; }
};

// whole rows of K from flat index base, a multiple of K
struct Rows {
  long long base;
  int K;
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ long long i(int e) const { return base + e; }
  __device__ __forceinline__ int k(int e) const { return e % K; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

}  // namespace
