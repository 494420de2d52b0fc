// Fused GGS z-draw + N_kw for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ldagroupedgibbssampler_tpu/ops/pallas_zdraw.py:_zdraw_kernel
// (fused_zdraw_nkw). For every real slot of the layout-A cell blocks:
//
//   p_k   = theta[win_d * dspan + d_local, k] * phi[win_w * vspan + w_local, k]
//   cdf_k = p_0 + ... + p_k                   (f32)
//   u     = float(u24) * 2^-24 * cdf_{K-1}
//   z     = min(#{k : cdf_k <= u}, K - 1)     (z_old when the total is 0)
//   nkw[win_w * vspan + w_local, z] += 1
//
// Contract kept from the TPU kernel:
//  - padding slots (w_local == vspan) matched no one-hot row there, so
//    their total was 0: they keep z_old and are not counted. Here they are
//    in no launch: the kernel walks the compact list of real slots, built
//    once at model set-up, and the wrapper copies z_old into z_out first.
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
// What bounds it on the H100: bytes, at the bound (the slot arrays, both
// tables and N_kw once: about 20 us at 20NG). The parent of this design
// ran one warp per slot, lanes across topics with a shuffle scan and a
// ballot count: 72% of its warps were padding, and each real token paid
// a chain of dependent shuffles per 32 topics. Timed in turns with one
// source of cost removed at a time (PERF.md §6), the padding
// cost 0.24 of its 1.00 ms, the N_kw atomics 0.12 and the L2 row gathers
// 0.17, while one token per thread over the real slots alone took it to
// 0.37 ms. So this design is that: one thread per real slot, which sums
// the K products of its theta and phi rows left to right (pass 1), then
// sums them again in the same order until the sum passes u (pass 2), and
// adds its one count to N_kw with a global atomic. Rows are read as
// float4 where K is a multiple of 4. A design that staged each layout
// block's phi window in shared memory, with a block-local N_kw histogram,
// was slower (0.43 ms): one block per layout block leaves the Zipf head
// window's full blocks to a few SMs, and the histogram saved nothing.
// The cdf is summed left to right, not in the parent's warp-scan
// association, so where a sum crosses u a token may differ from the plain
// version (a rounding tie). No shared memory: every K runs.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr float kInv24 = 5.9604644775390625e-8f;   // 2^-24
constexpr int kThreads = 256;

__device__ __forceinline__ float split_round(float x) {
  const float hi = bf16_round(x);
  return __fadd_rn(hi, bf16_round(__fsub_rn(x, hi)));
}

template <bool kPrecise>
__device__ __forceinline__ float slot_prob(float t, float p) {
  if (kPrecise) return __fmul_rn(split_round(t), split_round(p));
  return bf16_round(__fmul_rn(bf16_round(t), bf16_round(p)));
}

// The products of topics k .. k + kStep - 1 (kStep 4: one float4 load of
// each row, K a multiple of 4 and the rows 16-byte aligned).
template <bool kPrecise, int kStep>
__device__ __forceinline__ void probs_at(const float* __restrict__ th,
                                         const float* __restrict__ ph, int k,
                                         float* q) {
  if (kStep == 4) {
    const float4 t = *reinterpret_cast<const float4*>(th + k);
    const float4 p = *reinterpret_cast<const float4*>(ph + k);
    q[0] = slot_prob<kPrecise>(t.x, p.x);
    q[1] = slot_prob<kPrecise>(t.y, p.y);
    q[2] = slot_prob<kPrecise>(t.z, p.z);
    q[3] = slot_prob<kPrecise>(t.w, p.w);
  } else {
    q[0] = slot_prob<kPrecise>(th[k], ph[k]);
  }
}

template <bool kPrecise, int kStep>
__global__ void __launch_bounds__(kThreads)
    zdraw_kernel(const int* __restrict__ w_local,
                 const int* __restrict__ d_local,
                 const float* __restrict__ theta,
                 const float* __restrict__ phi,
                 const int* __restrict__ win_w,
                 const int* __restrict__ win_d_chunks,
                 const int* __restrict__ real_slots,
                 const int* __restrict__ u24,
                 const long long* __restrict__ seed, int* __restrict__ z_out,
                 int* __restrict__ nkw, long long n_real, int block,
                 int chunk, int vspan, int dspan, int K, int D, int V) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (g >= n_real) return;
  const long long slot = real_slots[g];
  const int wl = w_local[slot];
  const int dl = d_local[slot];
  const long long wrow = static_cast<long long>(win_w[slot / block]) * vspan
                         + wl;
  const long long drow =
      static_cast<long long>(win_d_chunks[slot / chunk]) * dspan + dl;
  int z = z_out[slot];                          // z_old, copied in
  if (dl < dspan && wrow < V && drow < D) {
    const float* th = theta + drow * K;
    const float* ph = phi + wrow * K;
    float q[kStep];
    float total = 0.f;
    for (int k = 0; k < K; k += kStep) {
      probs_at<kPrecise, kStep>(th, ph, k, q);
#pragma unroll
      for (int j = 0; j < kStep; ++j) total = __fadd_rn(total, q[j]);
    }
    if (total > 0.f) {
      const unsigned bits = slot_u24(u24, seed, slot);
      const float u = __fmul_rn(__fmul_rn(static_cast<float>(bits), kInv24),
                                total);
      // the first k whose prefix sum passes u (K when none does)
      float s = 0.f;
      int cnt = K;
      for (int k = 0; k < K && cnt == K; k += kStep) {
        probs_at<kPrecise, kStep>(th, ph, k, q);
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
          s = __fadd_rn(s, q[j]);
          if (s > u && cnt == K) cnt = k + j;
        }
      }
      z = min(cnt, K - 1);
      z_out[slot] = z;
    }
  }
  atomicAdd(nkw + wrow * K + z, 1);
}

template <bool kPrecise, int kStep>
void launch(const void* w_local, const void* d_local, const void* theta,
            const void* phi, const void* win_w, const void* win_d_chunks,
            const void* real_slots, const void* u24, const void* seed,
            void* z_out, void* nkw, long long n_real, int block, int chunk,
            int vspan, int dspan, int K, int D, int V, cudaStream_t stream) {
  const long long blocks = (n_real + kThreads - 1) / kThreads;
  zdraw_kernel<kPrecise, kStep><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(
      static_cast<const int*>(w_local), static_cast<const int*>(d_local),
      static_cast<const float*>(theta), static_cast<const float*>(phi),
      static_cast<const int*>(win_w), static_cast<const int*>(win_d_chunks),
      static_cast<const int*>(real_slots), static_cast<const int*>(u24),
      static_cast<const long long*>(seed), static_cast<int*>(z_out),
      static_cast<int*>(nkw), n_real, block, chunk, vspan, dspan, K, D, V);
}

// Whether the launch reads 4 topics a row load: K a multiple of 4 and both
// tables 16-byte aligned.
bool rows_vec4(int K, const void* theta, const void* phi) {
  return K % 4 == 0 && (reinterpret_cast<std::uintptr_t>(theta)
                        | reinterpret_cast<std::uintptr_t>(phi)) % 16 == 0;
}

}  // namespace

// w_local, d_local, u24 (nullable): int32 [n] (= [NB, chunks, chunk]);
// theta: f32 [D, K]; phi: f32 [V, K]; win_w: int32 [NB];
// win_d_chunks: int32 [NB * chunks]; real_slots: int32 [n_real], the real
// slots; seed: int64 [1]; z_out: int32 [n], holding z_old on entry; nkw:
// int32 [nwin_w * vspan, K], zeroed by the caller.
extern "C" int lda_zdraw_nkw(const void* w_local, const void* d_local,
                             const void* theta, const void* phi,
                             const void* win_w, const void* win_d_chunks,
                             const void* real_slots, const void* u24,
                             const void* seed, void* z_out, void* nkw,
                             long long n_real, int block, int chunk,
                             int vspan, int dspan, int K, int D, int V,
                             int precise, int device, void* stream) {
  cudaSetDevice(device);
  if (n_real <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec4 = rows_vec4(K, theta, phi);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto run = precise ? (vec4 ? launch<true, 4> : launch<true, 1>)
                           : (vec4 ? launch<false, 4> : launch<false, 1>);
  run(w_local, d_local, theta, phi, win_w, win_d_chunks, real_slots, u24,
      seed, z_out, nkw, n_real, block, chunk, vspan, dspan, K, D, V, st);
  return static_cast<int>(cudaGetLastError());
}

// The launch lda_zdraw_nkw makes at K on the tables theta and phi: out
// int64 [3] = (threads per block, dynamic shared memory bytes per block,
// topics per row load).
extern "C" int lda_zdraw_launch_shape(int K, const void* theta,
                                      const void* phi, void* out) {
  static_cast<long long*>(out)[0] = kThreads;
  static_cast<long long*>(out)[1] = 0;
  static_cast<long long*>(out)[2] = rows_vec4(K, theta, phi) ? 4 : 1;
  return 0;
}
