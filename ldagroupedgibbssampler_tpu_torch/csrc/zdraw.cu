// Fused GGS z-draw + N_kw for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ldagroupedgibbssampler_tpu/ops/pallas_zdraw.py:_zdraw_kernel
// (fused_zdraw_nkw). For every slot of the layout-A cell blocks:
//
//   p_k   = theta[win_d * dspan + d_local, k] * phi[win_w * vspan + w_local, k]
//   cdf_k = p_0 + ... + p_k                   (f32)
//   u     = float(u24) * 2^-24 * cdf_{K-1}
//   z     = min(#{k : cdf_k <= u}, K - 1)     (z_old when the total is 0)
//   nkw[win_w * vspan + w_local, z] += 1      (slots with w_local < vspan)
//
// Contract kept from the TPU kernel:
//  - padding slots (w_local == vspan or d_local == dspan) matched no
//    one-hot row there, so their total was 0: they keep z_old. Here the
//    sentinel would index a real row of the next window, so it is masked
//    explicitly. A slot is counted in N_kw iff w_local < vspan, as there.
//  - a real token whose theta row is zero (a document random scan did not
//    select) has total 0, keeps z_old and IS counted with z_old.
//  - precise == 0: theta and phi are rounded to bf16 (round to nearest
//    even), multiplied in f32, and the product is rounded to bf16 before
//    the f32 prefix sum (pallas_zdraw.py:149). precise == 1: each table
//    value is rebuilt as bf16 hi + bf16 lo in f32, products and sums in
//    f32 (pallas_zdraw.py:146-149, 175-178).
//  - u24 is the top 24 bits of a random word. With the optional u24
//    operand the kernel uses it, exactly as the TPU kernel's test path.
//    Without it each slot draws Philox4x32-10 keyed by the 64-bit seed
//    (read from device memory) with the global slot index as the counter,
//    so the draws do not depend on the launch configuration.
//
// Design: one warp per slot; lanes stride over K, a warp inclusive scan
// (shfl_up) builds the cdf in shared memory, a ballot/popc pass counts
// cdf_k <= u, lane 0 writes z and does the N_kw atomicAdd. Padding slots
// (more than half of the slots at 128-wide spans) exit after reading their
// ids. The TPU kernel turned both row gathers into one-hot matrix products
// because TPU row gathers are slow; on Hopper the rows are gathered
// directly (each warp reads 2 * K * 4 contiguous bytes).
//
// What bounds it on the H100: bytes. Compulsory traffic is the slot
// arrays (w, d, z_old read, z written: 16 bytes per slot), the two tables
// read once (D*K*4 + V*K*4) and the N_kw table written once. The row
// gathers re-read table rows once per token; at 20NG scale both tables fit
// in the 50 MB L2, so those re-reads are L2 traffic (about 2*K*4 bytes per
// token), which is what this simple kernel pays above the bound. Grouping
// the tokens of a cell through shared memory is the later optimisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float split_round(float x) {
  const float hi = bf16_round(x);
  return hi + bf16_round(x - hi);
}

// Philox4x32-10 (Salmon et al., SC'11): first output word of the block at
// counter (ctr_lo, ctr_hi, 0, 0) under key (seed_lo, seed_hi).
__device__ __forceinline__ unsigned philox_word0(unsigned long long seed,
                                                 unsigned long long ctr) {
  unsigned c0 = static_cast<unsigned>(ctr);
  unsigned c1 = static_cast<unsigned>(ctr >> 32);
  unsigned c2 = 0u, c3 = 0u;
  unsigned k0 = static_cast<unsigned>(seed);
  unsigned k1 = static_cast<unsigned>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2);
    const unsigned lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

template <bool kPrecise>
__device__ __forceinline__ float slot_prob(float t, float p) {
  if (kPrecise) return split_round(t) * split_round(p);
  return bf16_round(bf16_round(t) * bf16_round(p));
}

template <bool kPrecise>
__global__ void zdraw_kernel(const int* __restrict__ w_local,
                             const int* __restrict__ d_local,
                             const int* __restrict__ z_old,
                             const float* __restrict__ theta,
                             const float* __restrict__ phi,
                             const int* __restrict__ win_w,
                             const int* __restrict__ win_d_chunks,
                             const int* __restrict__ u24,
                             const long long* __restrict__ seed,
                             int* __restrict__ z_out, int* __restrict__ nkw,
                             long long n, int block, int chunk, int vspan,
                             int dspan, int K, int D, int V) {
  extern __shared__ float cdf_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x)
                         * (blockDim.x >> 5) + warp;
  if (slot >= n) return;                       // uniform across the warp
  const int wl = w_local[slot];
  const int dl = d_local[slot];
  const int zo = z_old[slot];
  const bool w_ok = wl >= 0 && wl < vspan;
  const long long wrow = static_cast<long long>(win_w[slot / block]) * vspan
                         + wl;
  const long long drow =
      static_cast<long long>(win_d_chunks[slot / chunk]) * dspan + dl;
  const bool valid = w_ok && dl >= 0 && dl < dspan && wrow < V && drow < D;

  int z = zo;
  if (valid) {
    float* cdf = cdf_smem + static_cast<long long>(warp) * K;
    const float* th = theta + drow * K;
    const float* ph = phi + wrow * K;
    float carry = 0.f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      float s = k < K ? slot_prob<kPrecise>(th[k], ph[k]) : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += t;
      }
      s += carry;
      if (k < K) cdf[k] = s;
      carry = __shfl_sync(kFull, s, 31);
    }
    const float total = carry;
    if (total > 0.f) {
      const unsigned bits =
          u24 != nullptr
              ? static_cast<unsigned>(u24[slot])
              : philox_word0(static_cast<unsigned long long>(seed[0]),
                             static_cast<unsigned long long>(slot)) >> 8;
      const float u = static_cast<float>(bits) * 5.9604644775390625e-8f
                      * total;                 // u24 * 2^-24 * total
      __syncwarp();
      int cnt = 0;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        cnt += __popc(__ballot_sync(kFull, k < K && cdf[k] <= u));
      }
      z = min(cnt, K - 1);
    }
  }
  if (lane == 0) {
    z_out[slot] = z;
    if (w_ok && z >= 0 && z < K) atomicAdd(nkw + wrow * K + z, 1);
  }
}

}  // namespace

// w_local, d_local, z_old, u24 (nullable): int32 [n] (= [NB, chunks, chunk]);
// theta: f32 [D, K]; phi: f32 [V, K]; win_w: int32 [NB];
// win_d_chunks: int32 [NB * chunks]; seed: int64 [1];
// z_out: int32 [n]; nkw: int32 [nwin_w * vspan, K], zeroed by the caller.
extern "C" int lda_zdraw_nkw(const void* w_local, const void* d_local,
                             const void* z_old, const void* theta,
                             const void* phi, const void* win_w,
                             const void* win_d_chunks, const void* u24,
                             const void* seed, void* z_out, void* nkw,
                             long long n, int block, int chunk, int vspan,
                             int dspan, int K, int D, int V, int precise,
                             int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  // warps per block: 8, fewer when the per-warp cdf row is large
  const long long row_bytes = static_cast<long long>(K) * sizeof(float);
  int warps = 8;
  while (warps > 1 && warps * row_bytes > 48 * 1024) warps >>= 1;
  const long long smem = warps * row_bytes;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + warps - 1) / warps;
  auto kernel = precise ? zdraw_kernel<true> : zdraw_kernel<false>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<static_cast<unsigned>(blocks), warps * 32,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w_local), static_cast<const int*>(d_local),
      static_cast<const int*>(z_old), static_cast<const float*>(theta),
      static_cast<const float*>(phi), static_cast<const int*>(win_w),
      static_cast<const int*>(win_d_chunks), static_cast<const int*>(u24),
      static_cast<const long long*>(seed), static_cast<int*>(z_out),
      static_cast<int*>(nkw), n, block, chunk, vspan, dspan, K, D, V);
  return static_cast<int>(cudaGetLastError());
}
