// LightLDA Metropolis-Hastings sweep (two-step MH per token, n_dk updated
// in the sweep) for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of ldagroupedgibbssampler_tpu/ops/
// pallas_lightlda.py: _mh_kernel (fused_lightlda_sweep, resident layout)
// and _mh_stream_kernel (fused_lightlda_sweep_streamed, streamed layout).
// One kernel serves both: only the layout and the per-document slot list
// differ (win_div selects how a slot finds its w-window, as in pcgs.cu).
//
// Per token, in the order the sweep visits it (the document's slot list),
// with tw / qw the word target / proposal rows of the token's type, bf16
// values read as f32, and every product rounded in f32 in this order:
//   nd_k  = table[k, d] - (k == z_old ? flag_d : 0)     (f32; own token out)
//   k1    = draw(qw row)                                 (word proposal)
//   take1 = u1 * ((nd_z * tw_z) * qw_1) < (nd_1 * tw_1) * qw_z, totq > 0
//   z1    = take1 ? k1 : z_old
//   ndq   = bf16(nd)
//   k2    = draw(ndq)                                    (doc proposal)
//   take2 = u2 * ((nd_z1 * tw_z1) * ndq_2) < (nd_2 * tw_2) * ndq_z1, totd > 0
//   z     = take2 ? k2 : z1
// where draw(p) is pcgs.cu's draw: f32 prefix sums inside 128-topic tiles,
// running tile offsets, u = u24 * 2^-24 * total, k = #{cdf_k <= u - off_t}
// clamped to the last topic with p_k > 0 (pallas_pcgs.py:70-132 without
// lastnz_const). The four uniforms of a token are the word draw, accept 1,
// doc draw and accept 2 (pallas_lightlda.py:93-160). z_old is kept when
// flag_d == 0; when z changes, table[z_old, d] -= 1 and table[z, d] += 1
// before the document's next token; N_kw[w, z] += 1 for every real slot.
//
// Design. tw and qw are fixed for the whole sweep and n_dk is per
// document, so documents are independent given the tables, as in the PCGS
// sweep: one warp owns one document, holds its n_dk + alpha column and one
// kpad-long cdf row in shared memory, walks the document's slots in slot
// order (the CSR lists doc_offsets / doc_slots, built on the host), and
// gathers one contiguous bf16 row of tw and of qw per token (both tables
// stay in the 50 MB L2 at 20NG scale). Given the same uniforms it draws
// the same z as the chunk-sequential TPU kernel, except where a cdf summed
// in another order crosses u.
//
// What bounds it on the H100: neither bytes nor operations. The bound is
// the input and output bytes (about 16 bytes per slot plus the tables),
// tens of microseconds at 20NG; each token is a chain of dependent steps
// inside its warp (two row gathers from L2, then two O(K) passes of
// shuffle scans and two of ballot counts where the PCGS sweep has one of
// each, scalar reads for the acceptance tests, the column update), so the
// kernel is bound by that chain's latency, hidden only by the other
// resident warps. One warp per document also waits on the longest one.
//
// Padding slots are in no slot list, so they are never read: they keep
// z_old (the wrapper copies z_old into z_out) and are never counted. Their
// sentinels (w_local = vspan, d_local = dspan) would index a real row of
// the next window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr float kInv24 = 5.9604644775390625e-8f;  // 2^-24

// The four 24-bit uniforms of a slot: the injected ones, laid out as the
// TPU kernel takes them ([NB, 4 * chunks, chunk]: slot (b, c, l) uses rows
// 4c .. 4c + 3 of block b), or the top 24 bits of the slot's four Philox
// words.
__device__ __forceinline__ uint4 slot_u24x4(const int* __restrict__ u24,
                                            const long long* __restrict__ seed,
                                            long long slot, int chunk,
                                            int chunks) {
  if (u24 != nullptr) {
    const long long block = static_cast<long long>(chunk) * chunks;
    const long long b = slot / block;
    const int rem = static_cast<int>(slot - b * block);
    const int c = rem / chunk;
    const int* p = u24 + 4 * b * block + 4LL * c * chunk + (rem - c * chunk);
    return make_uint4(p[0], p[chunk], p[2 * chunk], p[3 * chunk]);
  }
  const uint4 w = philox4(static_cast<unsigned long long>(seed[0]),
                          static_cast<unsigned long long>(slot));
  return make_uint4(w.x >> 8, w.y >> 8, w.z >> 8, w.w >> 8);
}

// One warp's tiled inverse-CDF draw over prob(k), k < K (zero up to kpad).
// cdf: the warp's kpad-long shared row. Returns the drawn topic (0 when
// total is 0, where the caller ignores it) and the total.
template <typename Prob>
__device__ __forceinline__ int warp_cdf_draw(const Prob& prob,
                                             float* __restrict__ cdf, int K,
                                             int ntile, unsigned bits,
                                             int lane, float& total) {
  total = 0.f;
  int last = -1;
  for (int t = 0; t < ntile; ++t) {
    float carry = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int k = t * 128 + g * 32 + lane;
      float p = 0.f;
      if (k < K) {
        p = prob(k);
        if (p > 0.f) last = k;
      }
      float s = p;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s = __fadd_rn(s, v);
      }
      s = __fadd_rn(s, carry);
      cdf[k] = s;
      carry = __shfl_sync(kFull, s, 31);
    }
    total = __fadd_rn(total, carry);
  }
  int k = 0;
  if (total > 0.f) {
    const int lastnz = __reduce_max_sync(kFull, last);
    const float u = __fmul_rn(__fmul_rn(static_cast<float>(bits), kInv24),
                              total);
    __syncwarp();
    int cnt = 0;
    float off = 0.f;
    for (int t = 0; t < ntile; ++t) {
      const float thr = __fsub_rn(u, off);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        cnt += __popc(__ballot_sync(kFull,
                                    cdf[t * 128 + g * 32 + lane] <= thr));
      }
      off = __fadd_rn(off, cdf[t * 128 + 127]);
    }
    k = min(cnt, lastnz);
  }
  __syncwarp();                       // the next draw rewrites cdf
  return k;
}

__global__ void lightlda_sweep_kernel(
    const int* __restrict__ w_local, const int* __restrict__ z_old,
    const int* __restrict__ win_w, const int* __restrict__ doc_offsets,
    const int* __restrict__ doc_slots, const __nv_bfloat16* __restrict__ tw,
    const __nv_bfloat16* __restrict__ qw, const int* __restrict__ u24,
    const long long* __restrict__ seed, float* __restrict__ table,
    int* __restrict__ z_out, int* __restrict__ nkw, int num_docs,
    long long dpad, int kpad, int K, int vspan, int win_div, int chunk,
    int chunks) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * (blockDim.x >> 5) + warp;
  if (d >= num_docs) return;                   // uniform across the warp
  float* col = smem + static_cast<long long>(warp) * 2 * kpad;
  float* cdf = col + kpad;
  const int beg = doc_offsets[d];
  const int end = doc_offsets[d + 1];
  const float flag = table[kpad * dpad + d];
  const bool selected = flag > 0.5f;
  if (selected) {
    for (int k = lane; k < K; k += 32) col[k] = table[k * dpad + d];
  }
  __syncwarp();
  const int ntile = kpad / 128;

  for (int base = beg; base < end; base += 32) {
    // each lane fetches one of the next 32 slots; the warp then walks them
    const int i = base + lane;
    const bool valid = i < end;
    const int slot = valid ? doc_slots[i] : 0;
    const int my_zo = valid ? z_old[slot] : 0;
    const long long my_wrow =
        valid ? static_cast<long long>(win_w[slot / win_div]) * vspan
                    + w_local[slot]
              : 0;
    const uint4 my_bits = (valid && selected)
                              ? slot_u24x4(u24, seed, slot, chunk, chunks)
                              : make_uint4(0u, 0u, 0u, 0u);
    int my_z = my_zo;
    const int n = min(32, end - base);
    for (int j = 0; selected && j < n; ++j) {
      const int zo = __shfl_sync(kFull, my_zo, j);
      const long long wrow = __shfl_sync(kFull, my_wrow, j);
      const unsigned b0 = __shfl_sync(kFull, my_bits.x, j);
      const unsigned b1 = __shfl_sync(kFull, my_bits.y, j);
      const unsigned b2 = __shfl_sync(kFull, my_bits.z, j);
      const unsigned b3 = __shfl_sync(kFull, my_bits.w, j);
      const __nv_bfloat16* twr = tw + wrow * K;
      const __nv_bfloat16* qwr = qw + wrow * K;
      const auto nd_of = [&](int k) {
        return k == zo ? __fsub_rn(col[k], flag) : col[k];
      };

      // MH step 1: word proposal k1 ~ qw row
      float totq;
      const int k1 = warp_cdf_draw(
          [&](int k) { return __bfloat162float(qwr[k]); }, cdf, K, ntile,
          b0, lane, totq);
      const float nd_z = nd_of(zo), nd_1 = nd_of(k1);
      const float tw_z = __bfloat162float(twr[zo]);
      const float tw_1 = __bfloat162float(twr[k1]);
      const float qw_z = __bfloat162float(qwr[zo]);
      const float qw_1 = __bfloat162float(qwr[k1]);
      const float u1 = __fmul_rn(static_cast<float>(b1), kInv24);
      const bool take1 =
          totq > 0.f &&
          __fmul_rn(u1, __fmul_rn(__fmul_rn(nd_z, tw_z), qw_1)) <
              __fmul_rn(__fmul_rn(nd_1, tw_1), qw_z);
      const int z1 = take1 ? k1 : zo;
      const float tw_z1 = take1 ? tw_1 : tw_z;
      const float nd_z1 = take1 ? nd_1 : nd_z;
      const float ndq_z1 = bf16_round(nd_z1);

      // MH step 2: doc proposal k2 ~ bf16(nd)
      float totd;
      const int k2 = warp_cdf_draw(
          [&](int k) { return bf16_round(nd_of(k)); }, cdf, K, ntile, b2,
          lane, totd);
      const float nd_2 = nd_of(k2);
      const float tw_2 = __bfloat162float(twr[k2]);
      const float ndq_2 = bf16_round(nd_2);
      const float u2 = __fmul_rn(static_cast<float>(b3), kInv24);
      const bool take2 =
          totd > 0.f &&
          __fmul_rn(u2, __fmul_rn(__fmul_rn(nd_z1, tw_z1), ndq_2)) <
              __fmul_rn(__fmul_rn(nd_2, tw_2), ndq_z1);
      const int z = take2 ? k2 : z1;

      __syncwarp();
      if (z != zo && lane == 0) {
        col[zo] = __fsub_rn(col[zo], 1.f);
        col[z] = __fadd_rn(col[z], 1.f);
      }
      __syncwarp();
      if (lane == j) my_z = z;
    }
    if (valid) {
      z_out[slot] = my_z;
      atomicAdd(nkw + my_wrow * K + my_z, 1);
    }
  }
  if (selected) {
    __syncwarp();
    for (int k = lane; k < K; k += 32) table[k * dpad + d] = col[k];
  }
}

}  // namespace

// w_local, z_old: int32 [n] slots of the layout, n = NB * chunks * chunk;
// win_w: int32, the w-window of slot s is win_w[s / win_div] (win_div is
// the block size for the resident layout, the chunk for the streamed one);
// doc_offsets int32 [num_docs + 1] and doc_slots int32 [N]: each
// document's real slots in visit order; tw, qw: bf16 [V, K]; u24
// (nullable): int32 [NB, 4 * chunks, chunk]; seed: int64 [1]; table: f32
// [kpad + 8, dpad], updated in place; z_out: int32 [n], holding z_old on
// entry; nkw: int32 [nwin_w * vspan, K], zeroed by the caller.
extern "C" int lda_lightlda_sweep(const void* w_local, const void* z_old,
                                  const void* win_w, const void* doc_offsets,
                                  const void* doc_slots, const void* tw,
                                  const void* qw, const void* u24,
                                  const void* seed, void* table, void* z_out,
                                  void* nkw, int num_docs, long long dpad,
                                  int kpad, int K, int vspan, int win_div,
                                  int chunk, int chunks, int device,
                                  void* stream) {
  cudaSetDevice(device);
  if (num_docs <= 0) return static_cast<int>(cudaGetLastError());
  // warps per block: 8, fewer when the per-warp column + cdf rows are large
  const long long warp_bytes = 2LL * kpad * sizeof(float);
  int warps = 8;
  while (warps > 1 && warps * warp_bytes > 48 * 1024) warps >>= 1;
  const long long smem = warps * warp_bytes;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(lightlda_sweep_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int blocks = (num_docs + warps - 1) / warps;
  lightlda_sweep_kernel<<<blocks, warps * 32, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w_local), static_cast<const int*>(z_old),
      static_cast<const int*>(win_w), static_cast<const int*>(doc_offsets),
      static_cast<const int*>(doc_slots),
      static_cast<const __nv_bfloat16*>(tw),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const int*>(u24),
      static_cast<const long long*>(seed), static_cast<float*>(table),
      static_cast<int*>(z_out), static_cast<int*>(nkw), num_docs, dpad, kpad,
      K, vspan, win_div, chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}
