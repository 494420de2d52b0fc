// PCGS sweep (partially collapsed Gibbs, phi fixed) for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of ldagroupedgibbssampler_tpu/ops/
// pallas_pcgs.py in their PCGS mode: _pcgs_kernel (fused_pcgs_sweep,
// resident layout) and _pcgs_stream_kernel (fused_pcgs_sweep_streamed,
// streamed layout). One kernel serves both: only the layout and the
// per-document slot list differ. The collapsed (ADLDA) mode of those
// kernels, with N_kw / n_k live between chunks, is not here.
//
// Per token, in the order the sweep visits it (the document's slot list):
//   nd_k  = table[k, d] - (k == z_old ? flag_d : 0)       (f32; own token out)
//   p_k   = bf16(nd_k * bf16(phi[w, k]))                   (product in f32)
//   cdf   = f32 prefix sums inside 128-topic tiles; off_t = sum of the
//           totals of the tiles before t; total = sum of all tile totals
//   u     = float(u24) * 2^-24 * total
//   z     = min(sum_t #{k in tile t : cdf_k <= u - off_t}, last k with p_k > 0)
//           (K - 1 in place of the last nonzero with positive_support)
//   z_old is kept when flag_d == 0 (document not selected) or total == 0;
//   when z changes, table[z_old, d] -= 1 and table[z, d] += 1 before the
//   document's next token; N_kw[w, z] += 1 for every real slot.
// table rows hold n_dk + alpha_k in f32 and row kpad holds the doc-mask
// flag, exactly as the TPU kernel keeps them, so the +-1 updates round the
// same way (pallas_pcgs.py:208-263, cdf_draw :70-132).
//
// Design. phi is fixed for the whole sweep, so documents are independent
// given phi and a token's draw depends only on its own document's earlier
// tokens. The TPU kernels got that per-document order from a
// chunk-sequential grid over sequential-safe blocks (no chunk holds two
// tokens of one document) and built every per-token gather as a one-hot
// matrix product against VMEM-resident or DMA-streamed windows. Here one
// warp owns one document: it holds the document's n_dk + alpha column in
// shared memory, walks the document's slots in slot order (CSR lists
// doc_offsets / doc_slots, built on the host), gathers one phi row per
// token (phi stays in the 50 MB L2 at 20NG scale), scans with shuffles,
// counts with ballots, and writes the column back once. Given the same
// uniforms it draws the same z as the chunk-sequential kernel, except
// where a cdf summed in another order crosses u.
//
// What bounds it on the H100: neither bytes nor operations. The bound is
// the input and output bytes (about 16 bytes per slot plus the tables),
// tens of microseconds at 20NG; the kernel is a chain of dependent
// per-token steps (phi row gather from L2, a shuffle scan per 32 topics,
// a ballot count, the column update) inside each warp, so it is bound by
// that chain's latency, hidden only by the other resident warps. One warp
// per document also waits on the longest document.
//
// Padding slots are not in any slot list, so they keep z_old (the wrapper
// copies z_old into z_out) and are never counted: their sentinels
// (w_local = vspan, d_local = dspan) would index a real row of the next
// window.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__global__ void pcgs_sweep_kernel(const int* __restrict__ w_local,
                                  const int* __restrict__ z_old,
                                  const int* __restrict__ win_w,
                                  const int* __restrict__ doc_offsets,
                                  const int* __restrict__ doc_slots,
                                  const float* __restrict__ phi,
                                  const int* __restrict__ u24,
                                  const long long* __restrict__ seed,
                                  float* __restrict__ table,
                                  int* __restrict__ z_out,
                                  int* __restrict__ nkw, int num_docs,
                                  long long dpad, int kpad, int K, int vspan,
                                  int win_div, int positive_support) {
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
    const unsigned my_bits =
        (valid && selected) ? slot_u24(u24, seed, slot) : 0u;
    int my_z = my_zo;
    const int n = min(32, end - base);
    for (int j = 0; selected && j < n; ++j) {
      const int zo = __shfl_sync(kFull, my_zo, j);
      const long long wrow = __shfl_sync(kFull, my_wrow, j);
      const unsigned bits = __shfl_sync(kFull, my_bits, j);
      const float* ph = phi + wrow * K;
      // pass 1: tile-local cdfs, tile totals, last nonzero topic
      float total = 0.f;
      int last = -1;
      for (int t = 0; t < ntile; ++t) {
        float carry = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int k = t * 128 + g * 32 + lane;
          float p = 0.f;
          if (k < K) {
            const float nd = k == zo ? __fsub_rn(col[k], flag) : col[k];
            p = bf16_round(__fmul_rn(nd, bf16_round(ph[k])));
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
      int z = zo;
      if (total > 0.f) {
        const int lastnz =
            positive_support ? K - 1 : __reduce_max_sync(kFull, last);
        const float u = __fmul_rn(
            __fmul_rn(static_cast<float>(bits), 5.9604644775390625e-8f),
            total);                                // u24 * 2^-24 * total
        __syncwarp();
        // pass 2: count cdf_k <= u - off_t over every tile
        int cnt = 0;
        float off = 0.f;
        for (int t = 0; t < ntile; ++t) {
          const float thr = __fsub_rn(u, off);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            cnt += __popc(__ballot_sync(
                kFull, cdf[t * 128 + g * 32 + lane] <= thr));
          }
          off = __fadd_rn(off, cdf[t * 128 + 127]);
        }
        z = min(cnt, lastnz);
      }
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

// w_local, z_old, u24 (nullable): int32 [n] slots of the layout;
// win_w: int32, the w-window of slot s is win_w[s / win_div] (win_div is
// the block size for the resident layout, the chunk for the streamed one);
// doc_offsets int32 [num_docs + 1] and doc_slots int32 [N]: each
// document's real slots in visit order; phi: f32 [V, K]; seed: int64 [1];
// table: f32 [kpad + 8, dpad], updated in place; z_out: int32 [n], holding
// z_old on entry; nkw: int32 [nwin_w * vspan, K], zeroed by the caller.
extern "C" int lda_pcgs_sweep(const void* w_local, const void* z_old,
                              const void* win_w, const void* doc_offsets,
                              const void* doc_slots, const void* phi,
                              const void* u24, const void* seed, void* table,
                              void* z_out, void* nkw, int num_docs,
                              long long dpad, int kpad, int K, int vspan,
                              int win_div, int positive_support, int device,
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
    cudaFuncSetAttribute(pcgs_sweep_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int blocks = (num_docs + warps - 1) / warps;
  pcgs_sweep_kernel<<<blocks, warps * 32, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w_local), static_cast<const int*>(z_old),
      static_cast<const int*>(win_w), static_cast<const int*>(doc_offsets),
      static_cast<const int*>(doc_slots), static_cast<const float*>(phi),
      static_cast<const int*>(u24), static_cast<const long long*>(seed),
      static_cast<float*>(table), static_cast<int*>(z_out),
      static_cast<int*>(nkw), num_docs, dpad, kpad, K, vspan, win_div,
      positive_support);
  return static_cast<int>(cudaGetLastError());
}
