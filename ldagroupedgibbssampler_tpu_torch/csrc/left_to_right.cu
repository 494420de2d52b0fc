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
// The design splits s_k = a_k + c_k wp[w, k] with a_k = alpha_k wp[w, k].
// The dense part is the same for every particle of the document, and c
// has at most n <= L nonzero entries. Launch 1 runs one block a document
// (and group of particles) with the position loop inside:
//   - the block stages the word's row of wp in shared memory with
//     cp.async, the next real position's row into a second buffer while
//     the current one is drawn (where two rows and one particle's list
//     do not fit, one buffer, refilled after each position's draws);
//   - the block computes the dense prefix A_k = a_0 + ... + a_k once a
//     position: warp v scans chunks of 32 topics (a shuffle scan, carried
//     from chunk to chunk), then adds the sum of warps 0..v-1's totals;
//   - one thread a particle: each particle keeps its nonzero counts as a
//     list of (topic, count) sorted by topic, 16 bits each (32 where K or
//     the padded length needs it), capacity min(K, L), in shared memory
//     (entry j of particle r at j * Rb + r). C = the list's c_j wp[w, t_j]
//     summed in list order, kept after every kStep-th entry;
//     T = A_{K-1} + C. The inverse CDF stays in topic order:
//     cdf_k = A_k + (the list's sum up to k). A binary search over the
//     runs of kStep entries finds the run where cdf first passes u T, the
//     thread walks that run, and in the segment between two listed topics
//     where cdf passes u T it binary-searches A: O(m) for C and
//     O(log m + kStep + log K) for the draw, for m listed topics, against
//     O(K) for the dense pass, and every thread of a warp runs about the
//     same steps;
//   - the p of a block's particles are summed in a fixed order (each
//     warp's xor butterfly, the warps in order) and written as
//     psum[d, t, group].
// Launch 2 (one block) sums the groups in order, takes the log of the mean
// and sums positions and documents in a fixed order: no float atomics, so
// the total is the same from run to run. Because the cdf is summed in
// this association, not in torch.cumsum's, a draw can differ from the
// plain version where u T lies on a cdf value (a tie), and where A's
// rounding puts u T between two equal cdf values the search can stop on a
// topic whose s is 0; the repair below moves it as the plain version does.
//
// What bounds it on the H100: the least work is reading the word rows
// (the split's distinct words x K x 4 B), the Philox block of each draw
// and the particles' sparse steps. The kernel is latency-bound instead: a
// block's position costs ~10^4 cycles, most of them the particles' chains
// of dependent shared-memory loads (C, the search, the list's insertion),
// and the lists' shared memory (100 x 88 entries x 4 B at the [4
// held-out] split) leaves 4 blocks, 16 warps, an SM at K = 100. A whole
// document's lists fit one block at K = 100 and at K = 4096, so the groups
// of launch 2 are one a document there.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr float kInv24 = 5.9604644775390625e-8f;   // 2^-24
constexpr float kEps = 1e-30f;
constexpr int kTotalThreads = 1024;
constexpr int kMaxWarps = 32;
constexpr int kStep = 4;                 // list entries a run (and a load)

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

// asynchronous global -> shared copies (sm_80 and later)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every group but the one committed last
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the block's copies of one word row of K floats (16 B pieces where the
// rows are 16 B aligned)
__device__ __forceinline__ void stage_row(float* dst, const float* src, int K,
                                          bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < K / 4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
}

// the first real position at or after t (L if none)
__device__ __forceinline__ int next_real(const unsigned char* __restrict__ m,
                                         int t, int L) {
  while (t < L && !m[t]) ++t;
  return t;
}

// the first k in [lo, hi] with A_k + c > target; A_hi + c > target
__device__ __forceinline__ int first_above(const float* A, int lo, int hi,
                                           float c, float target) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__fadd_rn(A[mid], c) > target) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// A_k = a_0 + ... + a_k, a_k = alpha_k wr[k], for the whole block: warp v
// scans its chunks of 32 topics (Hillis-Steele, then the carry of the
// chunks before: the carry of chunk i + 1 is the carry of chunk i plus
// chunk i's total), then adds the sum of the totals of warps 0..v-1 in
// order. Four chunks at a time, their scans interleaved. Ends with a
// barrier.
__device__ __forceinline__ void dense_prefix(const float* wr,
                                             const float* __restrict__ alpha,
                                             float* A, float* tot_s, int K) {
  constexpr int kBatch = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int nch = (K + 31) / 32;
  const int cpw = (nch + nw - 1) / nw;
  const int c0 = warp * cpw, c1 = min(c0 + cpw, nch);
  float carry = 0.f;
  for (int c = c0; c < c1; c += kBatch) {
    float x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = (c + i) * 32 + lane;
      x[i] = (c + i < c1 && k < K) ? __fmul_rn(__ldg(alpha + k), wr[k]) : 0.f;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float y = __shfl_up_sync(kFull, x[i], o);
        if (lane >= o) x[i] = __fadd_rn(x[i], y);
      }
    }
    float tot[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) tot[i] = __shfl_sync(kFull, x[i], 31);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = (c + i) * 32 + lane;
      if (c + i < c1 && k < K) A[k] = __fadd_rn(carry, x[i]);
      if (c + i < c1) carry = __fadd_rn(carry, tot[i]);
    }
  }
  if (lane == 0) tot_s[warp] = carry;
  __syncthreads();
  float off = 0.f;
  for (int v = 0; v < warp; ++v) off = __fadd_rn(off, tot_s[v]);
  if (warp > 0)
    for (int c = c0; c < c1; c += kBatch) {
      float x[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int k = (c + i) * 32 + lane;
        x[i] = (c + i < c1 && k < K) ? A[k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int k = (c + i) * 32 + lane;
        if (c + i < c1 && k < K) A[k] = __fadd_rn(off, x[i]);
      }
    }
  __syncthreads();
}

// Entry: (topic << kShift) | count, 16 + 16 or 32 + 32 bits; one thread a
// particle. bufs: word-row buffers, 2 (the next real position's row
// copied while this one is drawn) or 1 (where two do not fit: the next
// row copied after this position's draws).
template <typename Entry>
__global__ void l2r_particles_kernel(
    const int* __restrict__ w_pad, const unsigned char* __restrict__ mask,
    const float* __restrict__ wp, const float* __restrict__ alpha,
    const long long* __restrict__ seed, float* __restrict__ psum,
    int* __restrict__ z_out, int D, int L, int K, int R, int G, int Rb,
    int bufs, bool vec) {
  constexpr int kShift = 4 * static_cast<int>(sizeof(Entry));
  constexpr Entry kCount = (static_cast<Entry>(1) << kShift) - 1;
  extern __shared__ float4 smem4[];
  const int Kp = (K + 3) & ~3;
  const int Rb4 = (Rb + 3) & ~3;
  const int cap = max(1, min(K, L));
  float* wbuf = reinterpret_cast<float*>(smem4);     // [bufs][Kp]
  float* A = wbuf + bufs * Kp;                        // [Kp]
  int* m_s = reinterpret_cast<int*>(A + Kp);          // [Rb4]
  float* tot_s = reinterpret_cast<float*>(m_s + Rb4);  // [kMaxWarps]
  float* wsum_s = tot_s + kMaxWarps;                   // [kMaxWarps]
  Entry* lists = reinterpret_cast<Entry*>(wsum_s + kMaxWarps);  // [cap][Rb]
  // the list's running sum after every kStep-th entry: [cap / kStep][Rb]
  float* chk =
      reinterpret_cast<float*>(lists + static_cast<long long>(cap) * Rb);
  __shared__ float asum_s;
  const int d = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int r0 = g * Rb;
  const int nr = min(Rb, R - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  const unsigned char* md = mask + static_cast<long long>(d) * L;
  const int* wd = w_pad + static_cast<long long>(d) * L;
  for (int rl = threadIdx.x; rl < nr; rl += blockDim.x) m_s[rl] = 0;
  if (warp == 0) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s = __fadd_rn(s, alpha[k]);
    s = warp_sum(s);
    if (lane == 0) asum_s = s;
  }
  int t = next_real(md, 0, L);
  if (t < L)
    stage_row(wbuf, wp + static_cast<long long>(wd[t]) * K, K, vec);
  cp_async_commit();
  __syncthreads();
  const float asum = asum_s;
  int n = 0, buf = 0;
  while (t < L) {
    const int tn = next_real(md, t + 1, L);
    if (bufs == 2) {
      if (tn < L)
        stage_row(wbuf + (buf ^ 1) * Kp,
                  wp + static_cast<long long>(wd[tn]) * K, K, vec);
      cp_async_commit();
      cp_async_wait_prior();            // this position's row has landed
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* wr = wbuf + buf * Kp;
    dense_prefix(wr, alpha, A, tot_s, K);
    const float a_end = A[K - 1];
    const float denom = __fadd_rn(static_cast<float>(n), asum);
    float p_acc = 0.f;
    for (int rl = threadIdx.x; rl < nr; rl += blockDim.x) {
      Entry* lst = lists + rl;
      float* ck = chk + rl;
      const int m = m_s[rl];
      // C = the list's c_j wp[w, t_j] summed in list order (four entries'
      // loads issued together), kept after every kStep-th entry
      float c_all = 0.f;
      for (int j0 = 0; j0 < m; j0 += kStep) {
        Entry e[kStep];
        float w[kStep];
#pragma unroll
        for (int i = 0; i < kStep; ++i)
          e[i] = j0 + i < m ? lst[(j0 + i) * Rb] : 0;
#pragma unroll
        for (int i = 0; i < kStep; ++i)
          w[i] = wr[static_cast<int>(e[i] >> kShift)];
#pragma unroll
        for (int i = 0; i < kStep; ++i)
          if (j0 + i < m)
            c_all = __fadd_rn(c_all, __fmul_rn(
                static_cast<float>(e[i] & kCount), w[i]));
        if (j0 + kStep <= m) ck[(j0 / kStep) * Rb] = c_all;
      }
      const float total = __fadd_rn(a_end, c_all);
      const int r = r0 + rl;
      const unsigned bits = philox_word0(key, draw_counter(d, t, r)) >> 8;
      const float target = __fmul_rn(
          __fmul_rn(static_cast<float>(bits), kInv24), total);
      // The inverse CDF in topic order: cdf_k = A_k + C(k), C(k) the sum up
      // to the last listed topic <= k. A binary search over the runs of
      // kStep entries finds the first whose last entry's cdf passes u T;
      // the run is then walked from the sum before it: the segment before
      // each entry, then the entry. The walk stops on a listed topic or on
      // a segment [lo, hi] that the binary search of A takes (after the
      // walk, so a warp runs it once); past the runs, the segment after
      // the list. j ends as z's entry or where z goes.
      const int runs = m / kStep;
      int rlo = 0, rhi = runs;
      while (rlo < rhi) {
        const int mid = (rlo + rhi) >> 1;
        const int k =
            static_cast<int>(lst[(mid * kStep + kStep - 1) * Rb] >> kShift);
        if (__fadd_rn(A[k], ck[mid * Rb]) > target) rhi = mid;
        else rlo = mid + 1;
      }
      const int j1 = rlo * kStep, j2 = min(j1 + kStep, m);
      float c = rlo > 0 ? ck[(rlo - 1) * Rb] : 0.f;
      int lo = j1 > 0 ? static_cast<int>(lst[(j1 - 1) * Rb] >> kShift) + 1 : 0;
      int hi = K - 1, z = -1, j = m;
      bool listed = false, search = false;
      for (int i = j1; i < j2 && !listed && !search; ++i) {
        const Entry e = lst[i * Rb];
        const int k = static_cast<int>(e >> kShift);
        j = i;
        if (k > lo && __fadd_rn(A[k - 1], c) > target) {
          hi = k - 1;
          search = true;
        } else {
          c = __fadd_rn(c, __fmul_rn(static_cast<float>(e & kCount),
                                     wr[k]));
          if (__fadd_rn(A[k], c) > target) {
            z = k;
            listed = true;
          } else {
            lo = k + 1;
          }
        }
      }
      if (!listed && !search) {          // the segment after the list
        j = m;
        if (lo < K && __fadd_rn(a_end, c) > target) {
          search = true;
        } else {                         // u T rounds up to T: K - 1
          z = K - 1;
          listed = m > 0 && static_cast<int>(lst[(m - 1) * Rb] >> kShift) == z;
          if (listed) j = m - 1;
        }
      }
      if (search) z = first_above(A, lo, hi, c, target);
      // Where A's rounding or u T rounding up to T puts z on a topic whose
      // s is 0 (an inactive HDP topic, a zero in wp), z moves to the last
      // topic at or below it with s > 0, as the plain version does.
      const float cz = listed ? static_cast<float>(lst[j * Rb] & kCount) : 0.f;
      if (__fmul_rn(__fadd_rn(cz, __ldg(alpha + z)), wr[z]) == 0.f) {
        int jj = listed ? j : j - 1;     // the last entry at or below z
        for (int k = z; k >= 0; --k) {
          while (jj >= 0 && static_cast<int>(lst[jj * Rb] >> kShift) > k) --jj;
          const bool has =
              jj >= 0 && static_cast<int>(lst[jj * Rb] >> kShift) == k;
          const float cnt =
              has ? static_cast<float>(lst[jj * Rb] & kCount) : 0.f;
          if (__fmul_rn(__fadd_rn(cnt, __ldg(alpha + k)), wr[k]) > 0.f) {
            z = k;
            listed = has;
            j = has ? jj : jj + 1;
            break;
          }
        }
      }
      if (listed) {
        lst[j * Rb] += 1;
      } else {                           // entries j..m-1 move up one
        int q = m;
        for (; q - kStep >= j; q -= kStep) {
          Entry e[kStep];
#pragma unroll
          for (int i = 0; i < kStep; ++i) e[i] = lst[(q - 1 - i) * Rb];
#pragma unroll
          for (int i = 0; i < kStep; ++i) lst[(q - i) * Rb] = e[i];
        }
        for (; q > j; --q) lst[q * Rb] = lst[(q - 1) * Rb];
        lst[j * Rb] = (static_cast<Entry>(z) << kShift) | 1;
        m_s[rl] = m + 1;
      }
      p_acc = __fadd_rn(p_acc, __fdiv_rn(total, denom));
      if (z_out != nullptr)
        z_out[(static_cast<long long>(t) * R + r) * D + d] = z;
    }
    // the block's p: each warp's in the xor butterfly, the warps in order
    p_acc = warp_sum(p_acc);
    if (lane == 0) wsum_s[warp] = p_acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int v = 0; v < static_cast<int>(blockDim.x / 32); ++v)
        s = __fadd_rn(s, wsum_s[v]);
      psum[(static_cast<long long>(d) * L + t) * G + g] = s;
    }
    if (bufs == 1 && tn < L) {          // every read of the row is done
      stage_row(wbuf, wp + static_cast<long long>(wd[tn]) * K, K, vec);
      cp_async_commit();
    }
    ++n;
    buf ^= bufs - 1;
    t = tn;
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

template <typename Entry>
int launch(const void* w_pad, const void* mask, const void* wp,
           const void* alpha, const void* seed, void* psum, void* z_out,
           int D, int L, int K, int R, int G, int Rb, int W, int bufs,
           int smem, cudaStream_t stream) {
  const auto kernel = l2r_particles_kernel<Entry>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec =
      K % 4 == 0 && reinterpret_cast<std::uintptr_t>(wp) % 16 == 0;
  kernel<<<static_cast<unsigned>(static_cast<long long>(D) * G), W * 32,
           smem, stream>>>(
      static_cast<const int*>(w_pad), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(wp), static_cast<const float*>(alpha),
      static_cast<const long long*>(seed), static_cast<float*>(psum),
      static_cast<int*>(z_out), D, L, K, R, G, Rb, bufs, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_pad: int32 [D, L]; mask: bool [D, L]; wp: f32 [V, K] (word
// probabilities, a word's row contiguous); alpha: f32 [K]; seed: int64
// [1]; psum: f32 [D, L, G] scratch; z_out (nullable): int32 [L, R, D];
// total: f32 [1]. The launch shape (G groups of Rb particles a document,
// W warps a block, 1 or 2 word-row buffers, smem bytes of dynamic shared
// memory, 16- or 32-bit list entries) comes from the wrapper
// (ops/cuda_left_to_right.py::launch_shape), which sizes the lists at
// min(K, L) entries a particle.
extern "C" int lda_left_to_right(const void* w_pad, const void* mask,
                                 const void* wp, const void* alpha,
                                 const void* seed, void* psum, void* z_out,
                                 void* total, int D, int L, int K, int R,
                                 int G, int Rb, int W, int row_buffers,
                                 int smem, int wide_entries, int device,
                                 void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > kMaxWarps || row_buffers < 1 || row_buffers > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 0 && L > 0) {
    const int err =
        wide_entries
            ? launch<unsigned long long>(w_pad, mask, wp, alpha, seed, psum,
                                         z_out, D, L, K, R, G, Rb, W,
                                         row_buffers, smem, st)
            : launch<unsigned>(w_pad, mask, wp, alpha, seed, psum, z_out, D,
                               L, K, R, G, Rb, W, row_buffers, smem, st);
    if (err != 0) return err;
  }
  l2r_total_kernel<<<1, kTotalThreads, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const unsigned char*>(mask),
      static_cast<float*>(total), D, L, G, R);
  return static_cast<int>(cudaGetLastError());
}
