// The HDP step after the sweep for Hopper (sm_90a): the Antoniak table
// counts and the births, active mask and psi of the `ppu_hdplda`,
// `ppu_hlda` and `ppu_hdplda_all_topics` schemes.
//
// Replaces the XLA programs of ldagroupedgibbssampler_tpu/models/hdp.py
// `_step` after the z-sweep: `doc_count_ge_histogram` (:77) with
// `sample_table_counts` (:96), and `sample_birth_candidates` (:160),
// `_update_active` (:254; PoissonPolyaUrnHLDA's at :413), `gem_psi` (:129)
// or `poisson_psi` (:147) and the alpha update at the end of `_step`.
// No Pallas kernel: the JAX package lets XLA fuse these; the port ran them
// as ~100 eager launches an iteration (bincount, cumsum, torch.binomial,
// torch.poisson, two Gamma kernels).
//
// Table counts, two launches (`lda_hdp_table_counts`):
//   1. hist[k, c - 1] = #documents with clip(n_dk, 0, M) = c, c = 1..M.
//      A block reads a run of whole n_dk rows, coalesced, counts the
//      non-zero values into a [K, M] histogram in shared memory (K M 4 B:
//      ~68 KB at K = 100 and a longest document of 170) and adds its
//      non-zero cells to the global histogram with one atomic each. Where
//      the histogram does not fit the opt-in shared memory, every non-zero
//      n_dk is one global atomic (zeros are never counted: ge_j needs
//      c >= 1 only).
//   2. A block a topic: ge_j = sum_{c >= j} hist[k, c - 1] by a reverse
//      block scan in chunks of its threads, p_j = a_k / (a_k + j - 1) (1
//      where that denominator is not positive, clipped to [0, 1]; a_k is
//      alpha0 psi_k or one scalar for hlda), l_k = sum_j Binomial(ge_j,
//      p_j) (csrc/discrete.cuh, element k M + j - 1), summed in f32, exact
//      for integers. It zeroes the cells it read, so the scratch histogram
//      the wrapper keeps is zero for the next call without a fill.
//   Launch 2 is a programmatic dependent launch: its blocks are scheduled
//   while launch 1 runs (launch 1 allows them at its start; it is one
//   wave) and wait in `griddepcontrol.wait` until launch 1 has finished
//   and its writes are visible, so the second launch's latency overlaps
//   the first launch's work.
// Psi, one launch (`lda_hdp_psi`): a thread-block cluster of S =
// min(8, ceil(K / 512)) blocks, each taking P = ceil(K / S) topics with
// the least power of two of threads from 128 to 1024 that gives two a
// topic (K = 100: one block of 256; K = 4096: 8 blocks of 1024). After
// the table counts it is their second launch's programmatic dependent
// (`tables_kernel` allows it at its start): the births, which read only
// nk, the active mask and the seed, run before `wait_for_prerequisite`
// and write nothing to device memory, since the table counts may still
// read theirs.
//   births: n_add ~ Poisson(gamma) (element 1); for hdplda `budget`
//     candidates (element 2 + c, word x of block 0): geometric,
//     clip(floor(log u / log1p(-1 / (1 + gamma))), 0, K - 1), or uniform,
//     the high word of u32 K; the first min(n_add, budget) kept in shared
//     memory, and after the wait each topic counts its own. For hlda the
//     min(n_add, budget) lowest-indexed slots not in the data are born:
//     block scans of the free slots up to the slice's end find the index
//     past the take-th, below which each free slot is born.
//   active: (active & n_k > 0) | births > 0 (hdplda, hlda); unchanged
//     (all topics).
//   psi, GEM: nu_k ~ Beta(1 + l_k, gamma + sum_{j>k} l_j + 1e-30) as two
//     Marsaglia Gamma draws (csrc/marsaglia.cuh, gamma.cu's values: flat
//     element k and K + k) on two threads, clipped to [1e-7, 1 - 1e-7];
//     the sum above a block's slice by a block reduction (integers: exact
//     in any order); the exclusive scan of log1p(-nu) in f64, each block
//     starting at the slices below it (their totals added in rank order
//     through distributed shared memory); psi_k = exp(log nu_k + that),
//     normalised by the f64 total, the slices' totals added in rank order
//     by every block. Poisson: eta_k = Poisson(l_k) (element 2 + budget
//     + k) + births_k, psi = eta / sum eta, 1/K everywhere if that is 0.
//   alpha = alpha0 psi active.
// Counters: the Gamma draws take gamma.cu's 8 i + r (< 2^24 for K < 2^20),
// the discrete draws (e << 24) | r with e >= 1, so the two never meet.
//
// What bounds it on the H100: at 20NG K_max = 100 the table counts read
// n_dk once (4.5 MB, ~1.3 us at 3.35 TB/s) and make ~170 Binomial draws of
// the K M ~ 17,000 terms (the rest are exact); psi is K elements. Both are
// latency: two and one launches where the eager path took ~100. Launching
// dominates the table counts: each of their launches takes ~0.01 ms in
// turn with an empty body, against ~0.022 for both whole; one launch
// whose last block ran the second's scan and draws took 0.048-0.078 (one
// block cannot match 100), and a [K, 32] histogram or 8 loads in flight a
// thread gained nothing (PERF.md, Findings).
// The design keeps every intermediate (histogram, ge, p) out of device
// memory but the scratch histogram, and never syncs with the host (n_add
// stays on the device).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "dependent_launch.cuh"
#include "discrete.cuh"
#include "marsaglia.cuh"

namespace {

constexpr int kHistThreads = 512;
constexpr int kHistBlocks = 264;       // two a streaming multiprocessor:
                                       // one wave
constexpr int kTableThreads = 256;
constexpr int kPsiMinThreads = 128;    // psi: threads a block, at least
constexpr int kPsiMaxThreads = 1024;   // and at most
constexpr int kPsiSlice = 512;         // topics a block of a cluster, up to
                                       // kPsiMaxBlocks blocks
constexpr int kPsiMaxBlocks = 8;       // a portable cluster
constexpr int kBirthsNone = 0, kBirthsCandidates = 1, kBirthsLowest = 2;

// Exclusive scan of v over the block (blockDim.x == kT) and the block's
// total; warp_s holds kT / 32 values. Ends with a barrier.
template <int kT, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_s, T* total) {
  constexpr int kWarps = kT / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  T excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_s[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_s[lane] = w;
  }
  __syncthreads();
  const T before = warp > 0 ? warp_s[warp - 1] : T(0);
  *total = warp_s[kWarps - 1];
  __syncthreads();
  return before + excl;
}

// Gamma(a, 1) of flat element i: gamma.cu's draw (rounds 0..5, the boost)
__device__ __forceinline__ float gamma_draw(unsigned long long seed,
                                            long long i, float a) {
  const float d = mt_d(a);
  const float c = rsqrtf(__fmul_rn(9.f, d));
  const unsigned long long base =
      static_cast<unsigned long long>(i) * kBlocksPerElement;
  float g = d;
  for (int r = 0; r < kRounds; ++r)
    if (mt_round(d, c, seed, base, r, &g)) break;
  return boost(a, g, seed, base);
}

// table counts, launch 1: rows [blockIdx.x * rows, + rows) of n_dk
template <bool kShared>
__global__ void __launch_bounds__(kHistThreads)
    hist_kernel(const int* __restrict__ ndk, long long D, int K, int M,
                long long rows, int* __restrict__ hist) {
  extern __shared__ int h_s[];                     // [K M] when kShared
  allow_dependent_launch();
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  if (r0 >= D) return;
  const int nrows = static_cast<int>(D - r0 < rows ? D - r0 : rows);
  int* h = kShared ? h_s : hist;
  if (kShared) {
    for (int c = threadIdx.x; c < K * M; c += kHistThreads) h_s[c] = 0;
    __syncthreads();
  }
  const int* src = ndk + r0 * K;
  const int n = nrows * K;
  for (int e = threadIdx.x; e < n; e += kHistThreads) {
    const int v = src[e];
    if (v <= 0) continue;
    atomicAdd(h + (e % K) * M + min(v, M) - 1, 1);
  }
  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < K * M; c += kHistThreads)
      if (h_s[c] != 0) atomicAdd(hist + c, h_s[c]);
  }
}

// table counts, launch 2: a block a topic
__global__ void __launch_bounds__(kTableThreads)
    tables_kernel(int* __restrict__ hist, const float* __restrict__ a_vec,
                  float a_scalar, const long long* __restrict__ seed,
                  float* __restrict__ tables, int* __restrict__ ge_out, int K,
                  int M) {
  __shared__ int warp_i[kTableThreads / 32];
  __shared__ float warp_f[kTableThreads / 32];
  const int k = blockIdx.x;
  const float a = a_vec != nullptr ? a_vec[k] : a_scalar;
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  allow_dependent_launch();                         // psi's births
  wait_for_prerequisite();                          // launch 1's histogram
  int carry = 0;
  float l = 0.f;
  for (int top = M; top > 0; top -= kTableThreads) {
    const int j = top - static_cast<int>(threadIdx.x);   // descending j
    const long long idx = static_cast<long long>(k) * M + (j - 1);
    int h = 0;
    if (j >= 1) {
      h = hist[idx];
      hist[idx] = 0;
    }
    int total;
    const int ge = carry + block_exclusive_scan<kTableThreads>(h, warp_i,
                                                               &total) + h;
    carry += total;
    if (j < 1) continue;
    if (ge_out != nullptr) ge_out[idx] = ge;
    const float denom = __fsub_rn(__fadd_rn(a, static_cast<float>(j)), 1.f);
    float p = denom > 0.f ? __fdiv_rn(a, fmaxf(denom, LDA_F32(1e-30))) : 1.f;
    p = fminf(fmaxf(p, 0.f), 1.f);
    l = __fadd_rn(l, binomial_draw(key, static_cast<unsigned long long>(idx),
                                   static_cast<float>(ge), p));
  }
  // integers below 2^24: any order of the sum is exact
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    l = __fadd_rn(l, __shfl_xor_sync(kFull, l, o));
  if (threadIdx.x % 32 == 0) warp_f[threadIdx.x / 32] = l;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kTableThreads / 32; ++w) t = __fadd_rn(t, warp_f[w]);
    tables[k] = t;
  }
}

// elementwise Binomial(n, p): element e at flat index e
__global__ void __launch_bounds__(kTableThreads)
    binomial_kernel(const float* __restrict__ n, const float* __restrict__ p,
                    const long long* __restrict__ seed, float* __restrict__ out,
                    long long num) {
  const long long e = static_cast<long long>(blockIdx.x) * kTableThreads
                      + threadIdx.x;
  if (e >= num) return;
  out[e] = binomial_draw(static_cast<unsigned long long>(seed[0]),
                         static_cast<unsigned long long>(e), n[e], p[e]);
}

struct PsiArgs {
  const float* tables;
  const int* nk;                 // nullable where births_mode is none
  const unsigned char* active_in;
  const long long* seed;
  float* psi;
  unsigned char* active_out;
  float* alpha;
  int* births;
  int K, births_mode, gem, budget, geometric;
  float gamma, log1m_p, alpha0;
};

// The psi step of the cluster's slice of topics (see the header). kT
// threads a block; the cluster's S blocks take [rank P, rank P + P), P =
// ceil(K / S). Nothing is written to device memory before
// wait_for_prerequisite(): a dependent launch may start while the table
// counts still run and still read their operands.
template <int kT>
__global__ void __launch_bounds__(kT) psi_kernel(PsiArgs g) {
  namespace cg = cooperative_groups;
  extern __shared__ int cand_s[];          // [budget]: candidates mode
  __shared__ int warp_i[kT / 32];
  __shared__ double warp_d[kT / 32];
  __shared__ float a2_s[kT / 2], g2_s[kT / 2];
  __shared__ int take_s, limit_s;
  __shared__ double slice_s[2], carry_s[2];
  const cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int K = g.K, tid = threadIdx.x;
  const int per = (K + ranks - 1) / ranks;
  const int b0 = min(K, rank * per), b1 = min(K, b0 + per);
  const unsigned long long key = static_cast<unsigned long long>(g.seed[0]);
  // births: n_add, then the candidates (hdplda) or the index past the
  // take-th slot not in the data (hlda); they read nk, active and the seed
  if (tid == 0) {
    const int n_add = g.births_mode == kBirthsNone
                          ? 0
                          : static_cast<int>(poisson_draw(key, 1, g.gamma));
    take_s = min(n_add, g.budget);
    limit_s = take_s > 0 ? K : 0;
  }
  __syncthreads();
  const int take = take_s;
  if (g.births_mode == kBirthsCandidates) {
    for (int c = tid; c < take; c += kT) {
      const unsigned w = draw_block(key, 2 + c, 0).x;
      int cand;
      if (g.geometric) {
        const float x = floorf(
            __fdiv_rn(logf(fmaxf(unit23(w), LDA_F32(1e-12))), g.log1m_p));
        cand = static_cast<int>(
            fminf(fmaxf(x, 0.f), static_cast<float>(K - 1)));
      } else {
        cand = static_cast<int>(__umulhi(w, static_cast<unsigned>(K)));
      }
      cand_s[c] = cand;
    }
  } else if (g.births_mode == kBirthsLowest) {
    // the slots below b1 suffice: those of this slice are born where they
    // lie before the take-th free slot
    int carry = 0;
    for (int k0 = 0; k0 < b1 && carry < take; k0 += kT) {
      const int k = k0 + tid;
      const int free = k < K && !(g.active_in[k] && g.nk[k] > 0);
      int total;
      const int r = carry + block_exclusive_scan<kT>(free, warp_i, &total);
      if (free && r == take - 1) limit_s = k + 1;
      carry += total;
    }
  }
  __syncthreads();
  wait_for_prerequisite();                         // the table counts
  // the slice's births and active mask (each thread's topics b0 + tid +
  // i kT, the same in every loop below)
  for (int k = b0 + tid; k < b1; k += kT) {
    int born = 0;
    bool act;
    if (g.births_mode == kBirthsCandidates) {
      for (int c = 0; c < take; ++c) born += cand_s[c] == k;
      act = (g.active_in[k] && g.nk[k] > 0) || born > 0;
    } else if (g.births_mode == kBirthsLowest) {
      const bool in_data = g.active_in[k] && g.nk[k] > 0;
      born = !in_data && k < limit_s;
      act = in_data || born;
    } else {
      act = g.active_in[k];
    }
    g.births[k] = born;
    g.active_out[k] = act;
  }
  // psi, unnormalised, into g.psi; the slice's f64 total
  double part = 0.0;
  if (g.gem) {
    // sticks from the top topic down, a topic's two Gamma draws on two
    // threads (j of each half): rest_k = sum_{j > k} l_j (integers below
    // 2^53: exact in any order); nu_k kept in g.psi, log1p(-nu_k) in
    // g.alpha until the forward scan
    constexpr int kHalf = kT / 2;
    const int j = tid % kHalf, h = tid / kHalf;
    double above = 0.0, log1m = 0.0;
    if (b1 < K) {
      double v = 0.0;
      for (int k = b1 + tid; k < K; k += kT)
        v += static_cast<double>(g.tables[k]);
      block_exclusive_scan<kT>(v, warp_d, &above);
    }
    for (int top = b1 - 1; top >= b0; top -= kHalf) {
      const int k = top - j;
      const bool mine = k >= b0;
      const float lk = mine ? g.tables[k] : 0.f;
      double chunk;
      const double rest =
          above + block_exclusive_scan<kT>(
                      h == 0 && mine ? static_cast<double>(lk) : 0.0,
                      warp_d, &chunk);
      above += chunk;
      if (h == 0 && mine)
        a2_s[j] = __fadd_rn(
            __fadd_rn(g.gamma, fmaxf(static_cast<float>(rest), 0.f)),
            LDA_F32(1e-30));
      __syncthreads();
      float draw = 0.f;
      if (mine)
        draw = h == 0 ? gamma_draw(key, k, __fadd_rn(1.f, lk))
                      : gamma_draw(key, static_cast<long long>(K) + k,
                                   a2_s[j]);
      if (h == 1 && mine) g2_s[j] = draw;
      __syncthreads();
      if (h == 0 && mine) {
        float nu = __fdiv_rn(draw, fmaxf(__fadd_rn(draw, g2_s[j]), kFloor));
        nu = fminf(fmaxf(nu, LDA_F32(1e-7)), LDA_F32(1.0 - 1e-7));
        const float lm = log1pf(-nu);
        g.psi[k] = nu;
        g.alpha[k] = lm;
        log1m += lm;
      }
    }
    // the forward scan starts at the sum of log1p(-nu) of the slices
    // below, in rank order
    double before = 0.0;
    if (ranks > 1) {
      double slice;
      block_exclusive_scan<kT>(log1m, warp_d, &slice);
      if (tid == 0) slice_s[0] = slice;
      cluster.sync();
      if (tid == 0) {
        double c = 0.0;
        for (int q = 0; q < rank; ++q)
          c += *cluster.map_shared_rank(slice_s, q);
        carry_s[0] = c;
      }
    }
    __syncthreads();
    if (ranks > 1) before = carry_s[0];
    for (int k0 = b0; k0 < b1; k0 += kT) {
      const int k = k0 + tid;
      const double lm = k < b1 ? static_cast<double>(g.alpha[k]) : 0.0;
      double chunk;
      const double ex = before + block_exclusive_scan<kT>(lm, warp_d, &chunk);
      before += chunk;
      if (k >= b1) continue;
      const float raw =
          expf(__fadd_rn(logf(g.psi[k]), static_cast<float>(ex)));
      g.psi[k] = raw;
      part += raw;
    }
  } else {
    for (int k = b0 + tid; k < b1; k += kT) {
      const float eta = __fadd_rn(
          poisson_draw(key, 2ull + g.budget + k, g.tables[k]),
          static_cast<float>(g.births[k]));
      g.psi[k] = eta;
      part += eta;
    }
  }
  double sum;
  block_exclusive_scan<kT>(part, warp_d, &sum);
  if (ranks > 1) {
    // every block adds the slices' totals in rank order: the same total
    if (tid == 0) slice_s[1] = sum;
    cluster.sync();
    if (tid == 0) {
      double t = 0.0;
      for (int q = 0; q < ranks; ++q)
        t += cluster.map_shared_rank(slice_s, q)[1];
      carry_s[1] = t;
    }
    cluster.sync();                    // no block leaves while read
    sum = carry_s[1];
  }
  const float total_f = static_cast<float>(sum);
  const float uniform = LDA_F32(1.0 / K);
  for (int k = b0 + tid; k < b1; k += kT) {
    float psi;
    if (g.gem)
      psi = static_cast<float>(static_cast<double>(g.psi[k]) / sum);
    else
      psi = total_f > 0.f ? __fdiv_rn(g.psi[k], fmaxf(total_f, 1.f)) : uniform;
    g.psi[k] = psi;
    g.alpha[k] = __fmul_rn(__fmul_rn(g.alpha0, psi),
                           g.active_out[k] ? 1.f : 0.f);
  }
}

// The psi launch's geometry at K (ops/cuda_hdp.py::psi_launch_shape):
// blocks of a cluster, each taking ceil(K / blocks) topics, and threads a
// block, two a topic up to kPsiMaxThreads.
struct PsiShape {
  int blocks, threads;
};

PsiShape psi_shape(int K) {
  const int blocks = std::min(kPsiMaxBlocks, (K + kPsiSlice - 1) / kPsiSlice);
  const int per = (K + blocks - 1) / blocks;
  int threads = kPsiMinThreads;
  while (threads < 2 * per && threads < kPsiMaxThreads) threads *= 2;
  return {blocks, threads};
}

template <int kT>
cudaError_t launch_psi(const PsiArgs& args, int blocks, int smem,
                       bool dependent, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        psi_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  return launch_ex(psi_kernel<kT>, static_cast<unsigned>(blocks), kT,
                   static_cast<unsigned>(blocks), smem, dependent, st, args);
}

int max_optin_shared(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

}  // namespace

// n, p, out: f32 [num]; seed: int64 [1]. out = Binomial(n, p) elementwise.
extern "C" int lda_binomial(const void* n, const void* p, const void* seed,
                            void* out, long long num, int device,
                            void* stream) {
  cudaSetDevice(device);
  if (num <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (num + kTableThreads - 1) / kTableThreads;
  binomial_kernel<<<static_cast<unsigned>(blocks), kTableThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(n), static_cast<const float*>(p),
      static_cast<const long long*>(seed), static_cast<float*>(out), num);
  return static_cast<int>(cudaGetLastError());
}

// Whether launch 1 of the table counts counts in shared memory at (K, M).
extern "C" int lda_hdp_hist_shared(int K, int M, int device) {
  const long long bytes = 4LL * K * M;
  return bytes <= max_optin_shared(device) ? 1 : 0;
}

// out: int32 [1], launch 1's blocks an SM in the instance at (K, M).
extern "C" int lda_hdp_hist_blocks_per_sm(int K, int M, int shared,
                                          int device, void* out) {
  cudaSetDevice(device);
  if (!shared)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        static_cast<int*>(out), hist_kernel<false>, kHistThreads, 0));
  const int smem = 4 * K * M;
  const cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(out), hist_kernel<true>, kHistThreads, smem));
}

// ndk: int32 [D, K]; a_vec: f32 [K] or null (then a_scalar on every
// topic); seed: int64 [1]; hist: int32 [K, M] scratch, zero on entry and
// left zero; tables: f32 [K]; ge: int32 [K, M] or null. shared: 1 counts
// launch 1 in shared memory (lda_hdp_hist_shared must allow it), 0 in
// global memory.
extern "C" int lda_hdp_table_counts(const void* ndk, const void* a_vec,
                                    float a_scalar, const void* seed,
                                    void* hist, void* tables, void* ge,
                                    long long D, int K, int M, int shared,
                                    int device, void* stream) {
  cudaSetDevice(device);
  if (K <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  if (static_cast<long long>(K) * M > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D > 0) {
    const long long rows = (D + kHistBlocks - 1) / kHistBlocks;
    const long long blocks = (D + rows - 1) / rows;
    if (shared) {
      const int smem = 4 * K * M;
      if (smem > max_optin_shared(device))
        return static_cast<int>(cudaErrorInvalidValue);
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            hist_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      hist_kernel<true><<<static_cast<unsigned>(blocks), kHistThreads, smem,
                          st>>>(static_cast<const int*>(ndk), D, K, M, rows,
                                static_cast<int*>(hist));
    } else {
      hist_kernel<false><<<static_cast<unsigned>(blocks), kHistThreads, 0,
                           st>>>(static_cast<const int*>(ndk), D, K, M, rows,
                                 static_cast<int*>(hist));
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_dependent(
      tables_kernel, static_cast<unsigned>(K), kTableThreads, st,
      static_cast<int*>(hist), static_cast<const float*>(a_vec), a_scalar,
      static_cast<const long long*>(seed), static_cast<float*>(tables),
      static_cast<int*>(ge), K, M));
}

// tables: f32 [K]; nk: int32 [K] (null where births_mode is 0);
// active_in, active_out: bool [K]; seed: int64 [1]; psi, alpha: f32 [K];
// births: int32 [K]. births_mode 0 none (all topics), 1 candidates
// (hdplda; geometric 1 with log1m_p = f32(log1p(-1 / (1 + gamma))), or
// uniform), 2 the lowest slots not in the data (hlda); gem 1 the GEM
// sticks, 0 the Poisson psi. dependent 1: a programmatic dependent launch
// of the stream's previous launch, which must write none of nk,
// active_in and seed (the births read them before the wait): the table
// counts' second.
extern "C" int lda_hdp_psi(const void* tables, const void* nk,
                           const void* active_in, const void* seed, void* psi,
                           void* active_out, void* alpha, void* births, int K,
                           int births_mode, int gem, float gamma, int budget,
                           int geometric, float log1m_p, float alpha0,
                           int dependent, int device, void* stream) {
  cudaSetDevice(device);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  if (K >= (1 << 20) || budget < 0 || births_mode < 0 || births_mode > 2
      || (births_mode != kBirthsNone && nk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the candidates' list; past the opt-in shared memory, refused
  const long long list = births_mode == kBirthsCandidates ? 4LL * budget : 0;
  if (list > max_optin_shared(device) - 16 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  PsiArgs args{static_cast<const float*>(tables),
               static_cast<const int*>(nk),
               static_cast<const unsigned char*>(active_in),
               static_cast<const long long*>(seed),
               static_cast<float*>(psi),
               static_cast<unsigned char*>(active_out),
               static_cast<float*>(alpha),
               static_cast<int*>(births),
               K, births_mode, gem, budget, geometric,
               gamma, log1m_p, alpha0};
  const PsiShape shape = psi_shape(K);
  const auto st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(list);
  cudaError_t err;
  switch (shape.threads) {
    case 128:
      err = launch_psi<128>(args, shape.blocks, smem, dependent, st);
      break;
    case 256:
      err = launch_psi<256>(args, shape.blocks, smem, dependent, st);
      break;
    case 512:
      err = launch_psi<512>(args, shape.blocks, smem, dependent, st);
      break;
    default:
      err = launch_psi<kPsiMaxThreads>(args, shape.blocks, smem, dependent,
                                       st);
  }
  return static_cast<int>(err);
}
