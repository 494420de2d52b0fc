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
// Two launches:
//   1. A one-wave grid draws every value. The matrix's 32-column groups
//      (group g: row g / G, columns 32 (g mod G) .. + 31, G = ceil(L / 32))
//      are dealt to the blocks in turn, block g mod B, warp (g / B) mod 8
//      of it, round g / (8 B) (B as ops/cuda_polya_urn.py::
//      urn_launch_shape computes it),
//      so a heavy row, or a vocabulary's head wherever it lies, spreads
//      over every block. A warp draws its groups `rounds` at a time, the
//      fewest of kRounds that take all of them at once where one does:
//        a. the counts are loaded into shared memory while ten lanes of
//           warp 0 build a table of the inversion's f64 cdf terms s_0,
//           s_1, .. of the rates f32(c) + beta, c = 0..9, that lie in
//           (0, 10) (with the loop's own exp, __dmul_rn, __ddiv_rn and
//           __dadd_rn, so a search returns the loop's k bit for bit);
//        b. a value whose count is such an integer c searches row c with
//           its uniform (Philox block 0, word x) and is written, each
//           group's sum of these (counts below 24) one integer reduction;
//           any other value (PTRS, f32 counts that are not such
//           integers, NaN, a uniform past its row's last term) is queued;
//           an inactive row's values are 0, drawn nowhere;
//        c. the whole block draws the queue with csrc/discrete.cuh's
//           poisson_draw, each draw written and added to its group's
//           f64 sum.
//   2. A block a 2,048-value chunk of a row: the row's total from its
//      group sums (integers: exact in f64 in any order), one f32 division
//      a value, as the plain version's, 1/L where the total is 0, and the
//      zero mask; an inactive row stays 0. A programmatic dependent
//      launch (csrc/dependent_launch.cuh): scheduled while launch 1 runs,
//      it waits for launch 1's writes.
// So phi is the same bit for bit on any geometry.
//
// What bounds it on the H100: at K = 100, V = 20,000 it reads N_kw (8 MB)
// and writes phi (8 MB), ~5 us at 3.35 TB/s, and draws 2M Poissons of one
// Philox block each (almost all lam = beta = 0.01, no inversion step):
// ~80M 32-bit multiplies, ~5 us at 64 a clock an SM. The first design
// spent its time on the f64 exp of every value and on the blocks that
// held the head: an HDP chain's phi has one or a few rows that hold
// nearly every token (one row of the K_max = 100 chain holds 8,789 values
// of rate >= 10 and 11,000 of counts 1..9), which one block of it, or one
// cluster a row, draws value after value. The table and the dealt groups
// remove both; the second pass over phi (8 MB read back, mostly from L2)
// stays.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "dependent_launch.cuh"
#include "discrete.cuh"

namespace {

constexpr int kThreads = 256;         // every kernel's blocks
constexpr int kWarps = kThreads / 32;
// a warp's groups drawn together: the launch takes the first that holds
// all of them, or the last
constexpr int kRounds[] = {16, 24, 32, 48, 64};
constexpr int kChoices = sizeof(kRounds) / sizeof(kRounds[0]);
// launch 1's dynamic shared memory: a value (int) and a queue entry
// (uint16) a slot
constexpr int draw_smem(int rounds) { return 6 * rounds * kThreads; }
constexpr int kChunk = 2048;          // a row's values launch 2's block
                                      // divides
constexpr int kRates = 10;            // table rows: the counts 0..9
constexpr int kTab = 24;              // cdf terms a row (rate 9.99 past
                                      // the last: 1.2e-4 of its values)
constexpr int kSlow = 15;             // the class of a queued value
constexpr double kUMax = 1.0 - 1.0 / 16777216.0;   // the largest unit23

// lam of element i: f32(count) + beta, count int32 or f32
struct Rates {
  const void* x;
  bool ints;
  float beta;
  __device__ __forceinline__ float count(long long i) const {
    return ints ? static_cast<float>(static_cast<const int*>(x)[i])
                : static_cast<const float*>(x)[i];
  }
  __device__ __forceinline__ float at(long long i) const {
    return __fadd_rn(count(i), beta);
  }
};

// The rate f32(c) + beta of table row c, if the inversion draws it
// (0 < lam < 10)
__device__ __forceinline__ bool table_rate(float lam) {
  return lam > 0.f && lam < 10.f;
}

// The table row of a count: c where the count is an integer c = 0..9
// whose rate is on the table, else kSlow
__device__ __forceinline__ int rate_class(float count, float beta) {
  if (!(count >= 0.f && count < static_cast<float>(kRates)) ||
      count != floorf(count))
    return kSlow;
  return table_rate(__fadd_rn(count, beta)) ? static_cast<int>(count) : kSlow;
}

// The cdf terms s_0 .. of poisson_draw's inversion at lam, in its
// operations; 2.0 past the first term >= kUMax (no uniform exceeds it).
// A row that does not reach kUMax in kTab terms sends the uniforms past
// its last term to poisson_draw.
__device__ void build_row(double* tab, float lam) {
  const double l = lam;
  double p = exp(-l);
  double s = p;
  tab[0] = s;
  int k = 1;
  for (; k < kTab && s < kUMax; ++k) {
    p = __ddiv_rn(__dmul_rn(p, l), static_cast<double>(k));
    s = __dadd_rn(s, p);
    tab[k] = s;
  }
  for (; k < kTab; ++k) tab[k] = 2.0;
}

// The inversion's k for uniform u on a table row: the number of terms
// below u (the loop stops at the first s_k >= u), or kTab past the row
__device__ __forceinline__ int table_draw(const double* tab, double u) {
  int m = 0;
  while (m < kTab && tab[m] < u) ++m;
  return m;
}

// Append slot `s` for the lanes with `take` to the block's queue (every
// lane of the warp calls)
__device__ __forceinline__ void enqueue(bool take, int s,
                                        unsigned short* queue, int* qn) {
  const unsigned b = __ballot_sync(kFull, take);
  if (b == 0) return;
  const unsigned lane = threadIdx.x % 32;
  int at = 0;
  if (lane == 0) at = atomicAdd(qn, __popc(b));
  at = __shfl_sync(kFull, at, 0);
  if (take)
    queue[at + __popc(b & ((1u << lane) - 1u))] =
        static_cast<unsigned short>(s);
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

// A warp's groups, round by round: group g0 + u S (S = 8 B, the groups
// a round of the grid covers) as (row, 32-column group of the row), the
// division done once and the steps added (rows G < 2^31)
struct Groups {
  int row, q;
  int step_row, step_q, G;
  __device__ __forceinline__ Groups(long long g0, int S, int G_)
      : row(static_cast<int>(g0 / G_)), q(static_cast<int>(g0 % G_)),
        step_row(S / G_), step_q(S % G_), G(G_) {}
  __device__ __forceinline__ void next() {
    row += step_row;
    q += step_q;
    if (q >= G) {
      q -= G;
      ++row;
    }
  }
};

// Launch 1. Slot s = u kThreads + threadIdx.x holds the count of round u
// of a chunk of this thread's values; a queued value is named by its slot.
// 5 blocks an SM: the one wave of 660 holds K = 200's rows in one chunk.
__global__ void __launch_bounds__(kThreads, 5)
    urn_draw_kernel(Rates rates, const unsigned char* __restrict__ active,
                    const long long* __restrict__ seed,
                    float* __restrict__ out, double* __restrict__ gsum,
                    int L, int rows, int rounds) {
  extern __shared__ int val_s[];                    // [rounds kThreads]
  auto* queue = reinterpret_cast<unsigned short*>(  // [rounds kThreads]
      val_s + rounds * kThreads);
  __shared__ double tab_s[kRates * kTab];
  __shared__ int qn_s;
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int warp = static_cast<int>(threadIdx.x / 32);
  const int G = (L + 31) / 32;
  const int S = kWarps * static_cast<int>(gridDim.x);
  const long long groups = static_cast<long long>(rows) * G;
  const unsigned long long key = static_cast<unsigned long long>(seed[0]);
  allow_dependent_launch();                  // one wave: launch 2 may queue
  if (threadIdx.x == 0) qn_s = 0;
  // the table, by ten lanes of warp 0 while the warps load their counts
  if (warp == 0 && lane < kRates) {
    const float lam = __fadd_rn(static_cast<float>(lane), rates.beta);
    if (table_rate(lam)) build_row(tab_s + lane * kTab, lam);
  }
  // this warp's first group of a chunk starting at round t0
  auto first = [&](long long t0) {
    return t0 * S + static_cast<long long>(warp) * gridDim.x + blockIdx.x;
  };
  for (long long t0 = 0; t0 * S + blockIdx.x < groups; t0 += rounds) {
    // the chunk's rounds: warp 0's, the most a warp has
    const int R = static_cast<int>(
        min(static_cast<long long>(rounds),
            (groups - blockIdx.x + S - 1) / S - t0));
    // a. each value's count into its slot, 4 loads in flight
    Groups c0(first(t0), S, G);
#pragma unroll 4
    for (int u = 0; u < R; ++u, c0.next()) {
      const int col = c0.q * 32 + lane;
      val_s[u * kThreads + threadIdx.x] = __float_as_int(
          c0.row < rows && col < L
              ? rates.count(static_cast<long long>(c0.row) * L + col) : 0.f);
    }
    __syncthreads();                              // and the table is built
    // b. each value's draw: a table search where its count is on the
    // table and its uniform not past the row, written with the group's
    // sum of them (counts below kTab: one integer reduction); the others
    // queued
    Groups c1(first(t0), S, G);
#pragma unroll 1
    for (int u = 0; u < R; ++u, c1.next()) {
      if (c1.row >= rows) break;                  // warp-uniform
      const int s = u * kThreads + threadIdx.x;
      const int col = c1.q * 32 + lane;
      const long long i = static_cast<long long>(c1.row) * L + col;
      const bool in = col < L;
      const bool live = in && (active == nullptr || active[c1.row]);
      int m = 0;
      bool queued = false;
      if (live) {
        const int c = rate_class(__int_as_float(val_s[s]), rates.beta);
        queued = c == kSlow;
        if (!queued) {
          m = table_draw(tab_s + c * kTab,
                         unit23(draw_block(key,
                                           static_cast<unsigned long long>(i),
                                           0).x));
          queued = m == kTab;
        }
      }
      if (in && !queued) out[i] = static_cast<float>(m);
      const unsigned sum =
          __reduce_add_sync(kFull, queued ? 0u : static_cast<unsigned>(m));
      if (lane == 0)
        gsum[static_cast<long long>(c1.row) * G + c1.q] =
            static_cast<double>(sum);
      enqueue(queued, s, queue, &qn_s);
    }
    __syncthreads();
    // c. the queue: every thread of the block draws, writes its value and
    // adds it to its group's sum (integers: exact in f64 in any order)
    const int nq = qn_s;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const int s = queue[q];
      const int tid = s % kThreads;
      const long long g = (t0 + s / kThreads) * S
                          + static_cast<long long>(tid / 32) * gridDim.x
                          + blockIdx.x;
      const long long i = (g / G) * L + (g % G) * 32 + tid % 32;
      const float v =
          poisson_draw(key, static_cast<unsigned long long>(i), rates.at(i));
      out[i] = v;
      atomicAdd(gsum + g, static_cast<double>(v));
    }
    __syncthreads();
    if (threadIdx.x == 0) qn_s = 0;
  }
}

// Launch 2: block row * chunks + chunk divides its chunk of the row
__global__ void __launch_bounds__(kThreads)
    urn_normalise_kernel(float* __restrict__ out,
                         unsigned char* __restrict__ zero,
                         const double* __restrict__ gsum,
                         const unsigned char* __restrict__ active, int L,
                         int chunks) {
  __shared__ double warp_d[kWarps];
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long base = row * L + static_cast<long long>(chunk) * kChunk;
  const int E = min(kChunk, L - chunk * kChunk);
  if (active != nullptr && !active[row]) {          // zeros already
    if (zero != nullptr)
      for (int e = threadIdx.x; e < E; e += kThreads) zero[base + e] = 1;
    return;
  }
  wait_for_prerequisite();                          // launch 1's writes
  const int G = (L + 31) / 32;
  double t = 0.0;
  for (int q = threadIdx.x; q < G; q += kThreads) t += gsum[row * G + q];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  if (threadIdx.x % 32 == 0) warp_d[threadIdx.x / 32] = t;
  __syncthreads();
  t = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += warp_d[w];
  const float total = static_cast<float>(t);
  const float uniform = LDA_F32(1.0 / L);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const long long i = base + e;
    const float c = out[i];
    out[i] = total > 0.f ? __fdiv_rn(c, fmaxf(total, 1.f)) : uniform;
    if (zero != nullptr) zero[i] = c == 0.f;
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

// Launch 1's geometry for `rows` rows of L values on `device`: out: int32
// [4], its blocks (one wave, or one warp a group where there are fewer
// groups), rounds a chunk, blocks an SM and the card's multiprocessors.
// The rounds are the first of kRounds whose wave takes every warp's groups
// in one chunk, or the last; each choice's blocks an SM come from the
// occupancy calculator at its shared memory, once a device.
extern "C" int lda_polya_urn_geometry(long long rows, int L, int device,
                                      void* out) {
  static int sms[64] = {}, per_sm[64][kChoices] = {};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  if (sms[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        urn_draw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        draw_smem(kRounds[kChoices - 1]));
    for (int c = 0; c < kChoices && err == cudaSuccess; ++c)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[device][c], urn_draw_kernel, kThreads,
          draw_smem(kRounds[c]));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[device],
                                   cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) {
      sms[device] = 0;
      return static_cast<int>(err);
    }
  }
  const long long groups = rows * ((L + 31) / 32);
  int c = 0;
  while (c + 1 < kChoices &&
         static_cast<long long>(sms[device]) * per_sm[device][c] * kWarps *
                 kRounds[c] < groups)
    ++c;
  const long long wave =
      static_cast<long long>(sms[device]) * per_sm[device][c];
  int* o = static_cast<int*>(out);
  o[0] = static_cast<int>(std::min(wave, (groups + kWarps - 1) / kWarps));
  o[1] = kRounds[c];
  o[2] = per_sm[device][c];
  o[3] = sms[device];
  return 0;
}

// x: [rows, L] counts, int32 (ints == 1) or f32; beta: the prior; active:
// bool [rows] or null; seed: int64 [1]; out: f32 [rows, L]; zero: bool
// [rows, L] or null; gsum: f64 [rows ceil(L / 32)] scratch (each group's
// sum, written before it is read). Launch 1's grid: lda_polya_urn_geometry.
extern "C" int lda_polya_urn(const void* x, int ints, float beta,
                             const void* active, const void* seed, void* out,
                             void* zero, void* gsum, long long rows, int L,
                             int device, void* stream) {
  cudaSetDevice(device);
  if (rows <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  const int chunks = (L + kChunk - 1) / kChunk;
  if (rows * chunks > 0x7FFFFFFFLL || rows * ((L + 31) / 32) > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int shape[4];
  const int err0 = lda_polya_urn_geometry(rows, L, device, shape);
  if (err0 != 0) return err0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* act = static_cast<const unsigned char*>(active);
  urn_draw_kernel<<<static_cast<unsigned>(shape[0]), kThreads,
                    draw_smem(shape[1]), st>>>(
      Rates{x, ints != 0, beta}, act, static_cast<const long long*>(seed),
      static_cast<float*>(out), static_cast<double*>(gsum), L,
      static_cast<int>(rows), shape[1]);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(
      urn_normalise_kernel, static_cast<unsigned>(rows * chunks), kThreads,
      st, static_cast<float*>(out), static_cast<unsigned char*>(zero),
      static_cast<const double*>(gsum), act, L, chunks));
}
