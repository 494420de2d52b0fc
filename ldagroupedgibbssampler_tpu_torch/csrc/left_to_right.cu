// Left-to-right held-out estimator (Wallach et al. 2009) for Hopper
// (sm_90a).
//
// Replaces the XLA program of
// ldagroupedgibbssampler_tpu/evaluation/marginal.py:38
// (`left_to_right_from_word_prob`, one lax.scan over token positions with
// a [R, D, K] particle-count carry). For each of R particles of each test
// document d, at each real position t (mask) with word w:
//
//   s_k   = (c_k + alpha_k) * wp[w, k]          (wp: [V, K], f32)
//   T     = s_0 + ... + s_{K-1};   p = T / (n + sum alpha)
//   ll_d += log(mean_r p + 1e-30)
//   z     = #{k : cdf_k <= u * T}, at most K - 1; a z with s_z = 0 moves
//           to the last k <= z with s_k > 0; c_z += 1; n += 1
//
// with c the particle's topic counts and n the document's real positions
// so far. theta_k = (c_k + alpha_k) / (n + sum alpha) is s_k / wp[w, k]
// over a factor common to every k, so T is sum_k theta_k wp[w, k] times
// (n + sum alpha) and the draw is the JAX function's z ~ theta_k wp[w, k].
// The draw is an inverse CDF from one 24-bit Philox uniform u per
// (position, particle, document), the z-draw's own contract, where the
// JAX function draws Gumbel-max over K noise values (ROADMAP C: a
// deliberate divergence, the same distribution). The Philox key is the
// 64-bit seed read from device memory, the counter d * 2^40 + t * 2^20 + r,
// so the draws do not depend on the launch shape or on the other
// documents of the split.
//
// Launch 1: one block a document and group of particles; the position
// loop runs inside the kernel. Each particle's counts live in shared
// memory (16-bit where the padded length is below 2^16, else 32-bit), one
// warp a particle at a time: lane l owns the contiguous topics
// [l S, (l + 1) S), S = ceil(K / 32), at a padded stride P = S | 1 so the
// lanes hit distinct banks; the word's row of wp and alpha are staged in
// shared memory in the same layout. A lane sums its range in order, a warp
// scan gives each lane's exclusive prefix and T, a ballot finds the lane
// whose range holds u T, and that lane walks its range again. The p of a
// block's particles are summed in a fixed order and written as
// psum[d, t, group]. Launch 2 (one block) sums the groups in order, takes
// the log of the mean and sums positions and documents in a fixed order:
// no float atomics, so the total is the same from run to run. Because the
// cdf is summed in this association, not in torch.cumsum's, a draw can
// differ from the plain version where u T lies on a cdf value (a tie).
//
// What bounds it on the H100: the operations. R D L K (t, r, d, k) terms
// of ~4 f32 operations each; the inputs (the padded test documents, the
// rows of wp they name, alpha) are a few MB. At K = 4096 a particle's
// counts take 8 KB, so a block holds a group of the document's particles
// and the groups meet in launch 2. The walk of the chosen lane is serial
// (up to S steps), about as long again as the first pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr float kInv24 = 5.9604644775390625e-8f;   // 2^-24
constexpr float kEps = 1e-30f;
constexpr int kTotalThreads = 1024;

__device__ __forceinline__ unsigned long long draw_counter(int d, int t,
                                                           int r) {
  return (static_cast<unsigned long long>(d) << 40)
         | (static_cast<unsigned long long>(t) << 20)
         | static_cast<unsigned long long>(r);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename Count>
__global__ void l2r_particles_kernel(
    const int* __restrict__ w_pad, const unsigned char* __restrict__ mask,
    const float* __restrict__ wp, const float* __restrict__ alpha,
    const long long* __restrict__ seed, float* __restrict__ psum,
    int* __restrict__ z_out, int D, int L, int K, int R, int G, int Rb,
    int S, int P) {
  extern __shared__ float4 smem4[];
  const int row = 32 * P;
  float* alpha_s = reinterpret_cast<float*>(smem4);
  float* w_s = alpha_s + row;
  float* p_s = w_s + row;
  Count* counts_s = reinterpret_cast<Count*>(p_s + ((Rb + 3) & ~3));
  __shared__ float asum_s;
  const int d = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int r0 = g * Rb;
  const int nr = min(Rb, R - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = blockDim.x / 32;
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  for (int i = threadIdx.x; i < row; i += blockDim.x) {
    const int k = (i / P) * S + i % P;
    alpha_s[i] = (i % P < S && k < K) ? alpha[k] : 0.f;
  }
  for (int i = threadIdx.x; i < nr * row; i += blockDim.x) counts_s[i] = 0;
  if (warp == 0) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s = __fadd_rn(s, alpha[k]);
    s = warp_sum(s);
    if (lane == 0) asum_s = s;
  }
  __syncthreads();
  const float asum = asum_s;
  const int base = lane * P;
  int n = 0;
  for (int t = 0; t < L; ++t) {
    const long long dt = static_cast<long long>(d) * L + t;
    if (!mask[dt]) continue;                     // the same for the block
    const float* wr = wp + static_cast<long long>(w_pad[dt]) * K;
    for (int i = threadIdx.x; i < row; i += blockDim.x) {
      const int k = (i / P) * S + i % P;
      w_s[i] = (i % P < S && k < K) ? wr[k] : 0.f;
    }
    __syncthreads();
    const float denom = __fadd_rn(static_cast<float>(n), asum);
    for (int rl = warp; rl < nr; rl += W) {
      Count* cnt = counts_s + rl * row;
      float part = 0.f;
      for (int j = 0; j < S; ++j)
        part = __fadd_rn(part, __fmul_rn(
            __fadd_rn(static_cast<float>(cnt[base + j]), alpha_s[base + j]),
            w_s[base + j]));
      float incl = part;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl = __fadd_rn(incl, y);
      }
      const float excl_up = __shfl_up_sync(kFull, incl, 1);
      const float excl = lane == 0 ? 0.f : excl_up;
      const float total = __shfl_sync(kFull, incl, 31);
      const int r = r0 + rl;
      const unsigned bits = philox_word0(key, draw_counter(d, t, r)) >> 8;
      const float target = __fmul_rn(
          __fmul_rn(static_cast<float>(bits), kInv24), total);
      const int first = __popc(__ballot_sync(kFull, incl <= target));
      int z = K - 1;
      if (first < 32) {
        // the topic whose prefix sum first passes the target, within the
        // chosen lane's range (its last topic if rounding leaves none)
        int zl = min(first * S + S, K) - 1;
        if (lane == first) {
          float s = excl;
          for (int j = 0; j < S && lane * S + j < K; ++j) {
            s = __fadd_rn(s, __fmul_rn(
                __fadd_rn(static_cast<float>(cnt[base + j]),
                          alpha_s[base + j]),
                w_s[base + j]));
            if (s > target) {
              zl = lane * S + j;
              break;
            }
          }
        }
        z = __shfl_sync(kFull, zl, first);
      }
      // The lanes' inclusive sums come from the scan, the walk's from the
      // lane's own order: where rounding puts them on either side of u T,
      // or u T rounds up to T, z can land on a topic whose s is 0 (an
      // inactive HDP topic, a zero in wp). Such a z moves to the last
      // topic at or below it with s > 0, as the plain version does.
      const int zi = (z / S) * P + z % S;
      if (__fmul_rn(__fadd_rn(static_cast<float>(cnt[zi]), alpha_s[zi]),
                    w_s[zi]) == 0.f) {                  // the same for the warp
        int cand = -1;
        for (int j = 0; j < S && lane * S + j <= z; ++j) {
          const float sk = __fmul_rn(
              __fadd_rn(static_cast<float>(cnt[base + j]), alpha_s[base + j]),
              w_s[base + j]);
          if (sk > 0.f) cand = lane * S + j;
        }
        cand = __reduce_max_sync(kFull, cand);
        if (cand >= 0) z = cand;
      }
      __syncwarp();                    // every lane has read cnt[z]
      if (lane == 0) {
        cnt[(z / S) * P + z % S] += 1;
        p_s[rl] = __fdiv_rn(total, denom);
        if (z_out != nullptr)
          z_out[(static_cast<long long>(t) * R + r) * D + d] = z;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int rl = 0; rl < nr; ++rl) s = __fadd_rn(s, p_s[rl]);
      psum[dt * G + g] = s;
    }
    ++n;
  }
}

// one block: for each document (a warp each, in turn) and each real
// position (a lane each), log(sum of the groups' p / R + 1e-30); the
// positions summed by the warp, the documents by the block
__global__ void __launch_bounds__(kTotalThreads)
    l2r_total_kernel(const float* __restrict__ psum,
                     const unsigned char* __restrict__ mask,
                     float* __restrict__ total, int D, int L, int G, int R) {
  __shared__ float warp_s[kTotalThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float num_r = static_cast<float>(R);
  float acc = 0.f;
  for (int d = warp; d < D; d += kTotalThreads / 32) {
    float ll = 0.f;
    for (int t = lane; t < L; t += 32) {
      const long long dt = static_cast<long long>(d) * L + t;
      if (!mask[dt]) continue;
      float s = 0.f;
      for (int g = 0; g < G; ++g) s = __fadd_rn(s, psum[dt * G + g]);
      ll = __fadd_rn(ll, logf(__fadd_rn(__fdiv_rn(s, num_r), kEps)));
    }
    acc = __fadd_rn(acc, warp_sum(ll));
  }
  if (lane == 0) warp_s[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kTotalThreads / 32; ++w) s = __fadd_rn(s, warp_s[w]);
    total[0] = s;
  }
}

template <typename Count>
int launch(const void* w_pad, const void* mask, const void* wp,
           const void* alpha, const void* seed, void* psum, void* z_out,
           int D, int L, int K, int R, int G, int Rb, int W, int S, int P,
           int smem, cudaStream_t stream) {
  const auto kernel = l2r_particles_kernel<Count>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(static_cast<long long>(D) * G), W * 32,
           smem, stream>>>(
      static_cast<const int*>(w_pad), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(wp), static_cast<const float*>(alpha),
      static_cast<const long long*>(seed), static_cast<float*>(psum),
      static_cast<int*>(z_out), D, L, K, R, G, Rb, S, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_pad: int32 [D, L]; mask: bool [D, L]; wp: f32 [V, K] (word
// probabilities, a word's row contiguous); alpha: f32 [K]; seed: int64
// [1]; psum: f32 [D, L, G] scratch; z_out (nullable): int32 [L, R, D];
// total: f32 [1]. The launch shape (G groups of Rb particles a document,
// W warps a block, S topics a lane at stride P, smem bytes of dynamic
// shared memory, 16- or 32-bit counts) comes from the wrapper
// (ops/cuda_left_to_right.py::launch_shape).
extern "C" int lda_left_to_right(const void* w_pad, const void* mask,
                                 const void* wp, const void* alpha,
                                 const void* seed, void* psum, void* z_out,
                                 void* total, int D, int L, int K, int R,
                                 int G, int Rb, int W, int S, int P,
                                 int smem, int wide_counts, int device,
                                 void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D > 0 && L > 0) {
    const int err =
        wide_counts
            ? launch<unsigned>(w_pad, mask, wp, alpha, seed, psum, z_out, D,
                               L, K, R, G, Rb, W, S, P, smem, st)
            : launch<unsigned short>(w_pad, mask, wp, alpha, seed, psum,
                                     z_out, D, L, K, R, G, Rb, W, S, P, smem,
                                     st);
    if (err != 0) return err;
  }
  l2r_total_kernel<<<1, kTotalThreads, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const unsigned char*>(mask),
      static_cast<float*>(total), D, L, G, R);
  return static_cast<int>(cudaGetLastError());
}
