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
// sweep: one warp owns one document, holds its n_dk + alpha column in
// shared memory and walks the document's slots in slot order (the CSR
// lists doc_offsets / doc_slots, built on the host). Given the same
// uniforms it draws the same z as the chunk-sequential TPU kernel, except
// where a cdf summed in another order crosses u.
//
// What bounds it on the H100: neither bytes nor operations (the bound is
// the input and output bytes, about 16 bytes per slot plus the tables:
// tens of microseconds at 20NG) but the latency of each warp's chain of
// dependent per-token steps, hidden only by the other resident warps. The
// parent of this design drew the word proposal inside that chain: a qw row
// gather, an O(K) shuffle scan and ballot count, then scalar tw/qw reads
// at z_old and k1 that waited on the draw, and a tw read that waited on
// k2, three L2 round trips a token (PERF.md §6). Yet k1 depends
// only on the token's word row and its uniform, never on n_dk. So:
//  - a pre-pass (word_cdf_kernel, one warp per word row, once per sweep)
//    builds the tiled cdf of every qw row with the chain's own warp scan,
//    and each row's total and last nonzero topic: [V, kpad] f32, 10.2 MB
//    at K=100, resident in the 50 MB L2;
//  - in each 32-slot prefetch of a document, every lane draws k1 for its
//    own slot by an upper-bound search per tile of its word's cdf row,
//    and loads tw and qw at z_old and k1, all off the chain;
//  - the chain keeps what depends on the live n_dk: the first test, the
//    doc-proposal scan (its cdf in registers when kpad == 128), tw at k2,
//    the second test and the column update. At kpad 128 the token's tw
//    row is loaded into registers at the start of its step, so the read
//    at k2 does not wait on L2 after the scan (at larger kpad tw[k2] is
//    read after the scan: prefetching the row into L1 measured 3% slower
//    at K=200, PERF.md §6);
//  - warp wi takes document doc_order[wi], longest first (built on the
//    host), so the last wave is not held by a long document. The order
//    changes no draw: documents are independent given the tables and the
//    uniforms are keyed by slot.
// The search counts #{cdf <= u - off_t} where the tile's cdf does not
// decrease. The warp scan sums each lane's prefix in its own association,
// so two neighbouring entries over a zero term can differ by an ulp; a u
// that lands exactly between them is a rounding tie like those the plain
// comparison allows already.
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

// One warp's tiled prefix sums of prob(k), k < K (zero up to kpad): the
// tile-local cdf of topic t * 128 + g * 32 + lane goes to out(t, g, k, s).
// Returns the total (the sum of the tile totals, in tile order); `last` is
// the lane's last topic with prob > 0 (-1 if none).
template <typename Prob, typename Out>
__device__ __forceinline__ float warp_tile_cdf(const Prob& prob,
                                               const Out& out, int K,
                                               int ntile, int lane,
                                               int& last) {
  float total = 0.f;
  last = -1;
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
      out(t, g, k, s);
      carry = __shfl_sync(kFull, s, 31);
    }
    total = __fadd_rn(total, carry);
  }
  return total;
}

// Pre-pass: one warp per word row r < V builds the tiled cdf of bf16 qw[r]
// (cdf [V, kpad], exactly the sums the chain's word draw used to make),
// its total and its last topic with qw > 0 (-1 when the row is all zero).
__global__ void word_cdf_kernel(const __nv_bfloat16* __restrict__ qw,
                                float* __restrict__ cdf,
                                float* __restrict__ tot,
                                int* __restrict__ lastnz, int V, int K,
                                int kpad) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= V) return;                          // uniform across the warp
  const __nv_bfloat16* q = qw + static_cast<long long>(r) * K;
  float* row = cdf + static_cast<long long>(r) * kpad;
  int last;
  const float total = warp_tile_cdf(
      [&](int k) { return __bfloat162float(q[k]); },
      [&](int, int, int k, float s) { row[k] = s; }, K, kpad / 128, lane,
      last);
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) {
    tot[r] = total;
    lastnz[r] = last;
  }
}

// The draw from a tabled cdf row for u (= u24 * 2^-24 * total): per tile,
// the number of entries <= u - off_t by an upper-bound search (the tile's
// cdf does not decrease), summed over the tiles; not clamped.
__device__ __forceinline__ int table_count(const float* __restrict__ row,
                                           int ntile, float u) {
  int cnt = 0;
  float off = 0.f;
  for (int t = 0; t < ntile; ++t) {
    const float* r = row + t * 128;
    const float thr = __fsub_rn(u, off);
    const float last = r[127];
    int c = 128;
    if (!(last <= thr)) {
      c = 0;
#pragma unroll
      for (int s = 64; s >= 1; s >>= 1) {
        if (r[c + s - 1] <= thr) c += s;
      }
    }
    cnt += c;
    off = __fadd_rn(off, last);
  }
  return cnt;
}

constexpr int kWarps = 8;     // warps a block, fewer when the rows are large

// kOneTile: kpad == 128, so the doc proposal's cdf and the token's tw row
// stay in registers (4 values a lane) and never go through memory. At most
// 64 registers a thread, so that four blocks of kWarps warps fit an SM:
// left to itself ptxas gave the kOneTile instance 69 and the sweep took 16%
// longer; __launch_bounds__(256, 4) gave it 56 and 5% longer (PERF.md
// §6).
template <bool kOneTile>
__global__ void __maxnreg__(64) lightlda_sweep_kernel(
    const int* __restrict__ w_local, const int* __restrict__ z_old,
    const int* __restrict__ win_w, const int* __restrict__ doc_offsets,
    const int* __restrict__ doc_slots, const int* __restrict__ doc_order,
    const __nv_bfloat16* __restrict__ tw,
    const __nv_bfloat16* __restrict__ qw, const float* __restrict__ qcdf,
    const float* __restrict__ qtot, const int* __restrict__ qlast,
    const int* __restrict__ u24, const long long* __restrict__ seed,
    float* __restrict__ table, int* __restrict__ z_out,
    int* __restrict__ nkw, int num_docs, long long dpad, int kpad, int K,
    int vspan, int win_div, int chunk, int chunks) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wi = blockIdx.x * (blockDim.x >> 5) + warp;
  if (wi >= num_docs) return;                  // uniform across the warp
  const int d = doc_order[wi];
  float* col = smem + static_cast<long long>(warp) * 2 * kpad;
  float* cdf = col + kpad;                     // unused when kOneTile
  const int beg = doc_offsets[d];
  const int end = doc_offsets[d + 1];
  const float flag = table[kpad * dpad + d];
  const bool selected = flag > 0.5f;
  if (selected) {
    for (int k = lane; k < K; k += 32) col[k] = table[k * dpad + d];
  }
  __syncwarp();
  const int ntile = kOneTile ? 1 : kpad / 128;

  for (int base = beg; base < end; base += 32) {
    // each lane fetches one of the next 32 slots and, off the chain, draws
    // its word proposal and reads tw and qw at z_old and k1
    const int i = base + lane;
    const bool valid = i < end;
    const int slot = valid ? doc_slots[i] : 0;
    const int my_zo = valid ? z_old[slot] : 0;
    const long long my_wrow =
        valid ? static_cast<long long>(win_w[slot / win_div]) * vspan
                    + w_local[slot]
              : 0;
    int my_k1 = 0;
    bool my_q = false;
    unsigned my_b2 = 0u, my_b3 = 0u, my_b1 = 0u;
    float my_twz = 0.f, my_tw1 = 0.f, my_qwz = 0.f, my_qw1 = 0.f;
    if (valid && selected) {
      const uint4 bits = slot_u24x4(u24, seed, slot, chunk, chunks);
      my_b1 = bits.y;
      my_b2 = bits.z;
      my_b3 = bits.w;
      const float totq = qtot[my_wrow];
      my_q = totq > 0.f;
      if (my_q) {
        const float u = __fmul_rn(
            __fmul_rn(static_cast<float>(bits.x), kInv24), totq);
        my_k1 = min(table_count(qcdf + my_wrow * kpad, ntile, u),
                    qlast[my_wrow]);
      }
      const __nv_bfloat16* twr = tw + my_wrow * K;
      const __nv_bfloat16* qwr = qw + my_wrow * K;
      my_twz = __bfloat162float(twr[my_zo]);
      my_tw1 = __bfloat162float(twr[my_k1]);
      my_qwz = __bfloat162float(qwr[my_zo]);
      my_qw1 = __bfloat162float(qwr[my_k1]);
    }
    int my_z = my_zo;
    const int n = min(32, end - base);
    for (int j = 0; selected && j < n; ++j) {
      const int zo = __shfl_sync(kFull, my_zo, j);
      const long long wrow = __shfl_sync(kFull, my_wrow, j);
      const __nv_bfloat16* twr = tw + wrow * K;
      // kOneTile: the token's tw row, loaded now so that tw at k2 is at
      // hand after the scan
      float twv[4];
      if (kOneTile) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int k = g * 32 + lane;
          twv[g] = k < K ? __bfloat162float(twr[k]) : 0.f;
        }
      }
      const int k1 = __shfl_sync(kFull, my_k1, j);
      const bool q = __shfl_sync(kFull, my_q, j);
      const unsigned b1 = __shfl_sync(kFull, my_b1, j);
      const unsigned b2 = __shfl_sync(kFull, my_b2, j);
      const unsigned b3 = __shfl_sync(kFull, my_b3, j);
      const float tw_z = __shfl_sync(kFull, my_twz, j);
      const float tw_1 = __shfl_sync(kFull, my_tw1, j);
      const float qw_z = __shfl_sync(kFull, my_qwz, j);
      const float qw_1 = __shfl_sync(kFull, my_qw1, j);
      const auto nd_of = [&](int k) {
        return k == zo ? __fsub_rn(col[k], flag) : col[k];
      };

      // MH step 1: accept the word proposal k1
      const float nd_z = nd_of(zo), nd_1 = nd_of(k1);
      const float u1 = __fmul_rn(static_cast<float>(b1), kInv24);
      const bool take1 =
          q && __fmul_rn(u1, __fmul_rn(__fmul_rn(nd_z, tw_z), qw_1)) <
                   __fmul_rn(__fmul_rn(nd_1, tw_1), qw_z);
      const int z1 = take1 ? k1 : zo;
      const float tw_z1 = take1 ? tw_1 : tw_z;
      const float nd_z1 = take1 ? nd_1 : nd_z;
      const float ndq_z1 = bf16_round(nd_z1);

      // MH step 2: doc proposal k2 ~ bf16(nd)
      float cdf1[4];                          // kOneTile: the cdf
      int last;
      const float totd = warp_tile_cdf(
          [&](int k) { return bf16_round(nd_of(k)); },
          [&](int, int g, int k, float s) {
            if (kOneTile) {
              cdf1[g] = s;
            } else {
              cdf[k] = s;
            }
          },
          K, ntile, lane, last);
      int k2 = 0;
      if (totd > 0.f) {
        const int lastnz = __reduce_max_sync(kFull, last);
        const float u = __fmul_rn(__fmul_rn(static_cast<float>(b2), kInv24),
                                  totd);
        int cnt = 0;
        if (kOneTile) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            cnt += __popc(__ballot_sync(kFull, cdf1[g] <= u));
          }
        } else {
          __syncwarp();
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
        }
        k2 = min(cnt, lastnz);
      }
      const float nd_2 = nd_of(k2);
      float tw_2;
      if (kOneTile) {
        // k2 is uniform across the warp: pick its register, then its lane
        const int g2 = k2 >> 5;
        const float mine = g2 == 0 ? twv[0] : g2 == 1 ? twv[1]
                                            : g2 == 2 ? twv[2] : twv[3];
        tw_2 = __shfl_sync(kFull, mine, k2 & 31);
      } else {
        tw_2 = __bfloat162float(twr[k2]);
      }
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

// warps per block and dynamic shared memory bytes per block of the sweep
void launch_shape(int kpad, int* warps, long long* smem) {
  const long long warp_bytes = 2LL * kpad * sizeof(float);
  int w = kWarps;
  while (w > 1 && w * warp_bytes > 48 * 1024) w >>= 1;
  *warps = w;
  *smem = w * warp_bytes;
}

}  // namespace

// qw: bf16 [V, K]; out: cdf f32 [V, kpad], tot f32 [V], lastnz int32 [V].
extern "C" int lda_lightlda_word_cdf(const void* qw, void* cdf, void* tot,
                                     void* lastnz, int V, int K, int kpad,
                                     int device, void* stream) {
  cudaSetDevice(device);
  if (V <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (V + kWarps - 1) / kWarps;
  word_cdf_kernel<<<blocks, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qw), static_cast<float*>(cdf),
      static_cast<float*>(tot), static_cast<int*>(lastnz), V, K, kpad);
  return static_cast<int>(cudaGetLastError());
}

// w_local, z_old: int32 [n] slots of the layout, n = NB * chunks * chunk;
// win_w: int32, the w-window of slot s is win_w[s / win_div] (win_div is
// the block size for the resident layout, the chunk for the streamed one);
// doc_offsets int32 [num_docs + 1] and doc_slots int32 [N]: each
// document's real slots in visit order; doc_order: int32 [num_docs], a
// permutation of the documents, the order in which warps take them; tw,
// qw: bf16 [V, K]; qcdf, qtot, qlast: lda_lightlda_word_cdf's outputs for
// qw; u24 (nullable): int32 [NB, 4 * chunks, chunk]; seed: int64 [1];
// table: f32 [kpad + 8, dpad], updated in place; z_out: int32 [n], holding
// z_old on entry; nkw: int32 [nwin_w * vspan, K], zeroed by the caller.
extern "C" int lda_lightlda_sweep(
    const void* w_local, const void* z_old, const void* win_w,
    const void* doc_offsets, const void* doc_slots, const void* doc_order,
    const void* tw, const void* qw, const void* qcdf, const void* qtot,
    const void* qlast,
    const void* u24, const void* seed, void* table, void* z_out, void* nkw,
    int num_docs, long long dpad, int kpad, int K, int vspan, int win_div,
    int chunk, int chunks, int device, void* stream) {
  cudaSetDevice(device);
  if (num_docs <= 0) return static_cast<int>(cudaGetLastError());
  int warps;
  long long smem;
  launch_shape(kpad, &warps, &smem);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kpad == 128 ? lightlda_sweep_kernel<true>
                                  : lightlda_sweep_kernel<false>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int blocks = (num_docs + warps - 1) / warps;
  kernel<<<blocks, warps * 32, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w_local), static_cast<const int*>(z_old),
      static_cast<const int*>(win_w), static_cast<const int*>(doc_offsets),
      static_cast<const int*>(doc_slots),
      static_cast<const int*>(doc_order),
      static_cast<const __nv_bfloat16*>(tw),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const float*>(qcdf),
      static_cast<const float*>(qtot), static_cast<const int*>(qlast),
      static_cast<const int*>(u24), static_cast<const long long*>(seed),
      static_cast<float*>(table), static_cast<int*>(z_out),
      static_cast<int*>(nkw), num_docs, dpad, kpad, K, vspan, win_div, chunk,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

// The sweep's launch shape for a table of kpad topic rows: out int64 [2] =
// (warps per block, dynamic shared memory bytes per block).
extern "C" int lda_lightlda_launch_shape(int kpad, void* out) {
  int warps;
  long long smem;
  launch_shape(kpad, &warps, &smem);
  static_cast<long long*>(out)[0] = warps;
  static_cast<long long*>(out)[1] = smem;
  return 0;
}
