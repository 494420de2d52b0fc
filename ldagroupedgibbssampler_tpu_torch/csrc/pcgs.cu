// PCGS sweep (partially collapsed Gibbs, phi fixed) and its collapsed
// (ADLDA) mode, for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of ldagroupedgibbssampler_tpu/ops/
// pallas_pcgs.py in both their modes: _pcgs_kernel (fused_pcgs_sweep,
// resident layout) and _pcgs_stream_kernel (fused_pcgs_sweep_streamed,
// streamed layout, untiled and K-tiled bodies). Only the layout and the
// per-document slot list differ between the two (win_div selects how a
// slot finds its w-window). The PCGS mode has its own kernel at kpad <= 256
// (pcgs_lane_kernel, below); the collapsed mode, and the PCGS mode above
// kpad 256, run the kernel template pcgs_sweep_kernel, whose kCollapsed
// instance replaces the `collapsed` branches of the TPU kernels
// (pallas_pcgs.py:142-149, 164-178, 215-229, 249-263 and 659-669,
// 684-689, 752-761, 800-807, 825-836, 853-858).
//
// Per token, in the order the sweep visits it (the document's slot list),
// with c_k = (k == z_old ? flag_d : 0):
//   nd_k  = table[k, d] - c_k                               (f32; own token out)
//   PCGS:      p_k = bf16(nd_k * bf16(phi[w, k]))            (product in f32)
//   collapsed: p_k = bf16(nd_k * (((f32(N_kw[w, k]) + beta) - c_k)
//                                 / (nkp[k] - c_k)))
//              with nkp[k] = V beta + n_k, IEEE division, products in the
//              association of pallas_pcgs.py:227-229 (the __f*_rn
//              intrinsics keep nvcc's -fmad=true from contracting them)
//   cdf   = f32 prefix sums inside 128-topic tiles; off_t = sum of the
//           totals of the tiles before t; total = sum of all tile totals
//   u     = float(u24) * 2^-24 * total
//   z     = min(sum_t #{k in tile t : cdf_k <= u - off_t}, last k with p_k > 0)
//           (K - 1 in place of the last nonzero with positive_support);
//           without positive_support a z with p_z = 0 (a count that passed
//           a lane boundary where two associations of one prefix sum meet
//           u) moves to the last k <= z with p_k > 0
//   z_old is kept when flag_d == 0 (document not selected) or total == 0;
//   when z changes, table[z_old, d] -= 1 and table[z, d] += 1 before the
//   document's next token. PCGS: N_kw[w, z] += 1 for every real slot.
//   Collapsed: N_kw[w, z_old] -= 1 and N_kw[w, z] += 1 (atomics, lane 0)
//   before the warp's next token, nkp[z_old] -= 1 and nkp[z] += 1 in the
//   warp's view and its unflushed moves (below); the wrapper seeds N_kw
//   with the sweep-entry counts and nkp with V beta + n_k, so N_kw ends as
//   entry + hist(z) - hist(z_old), which is what the TPU kernel returns
//   (pallas_pcgs.py:296-299), and nkp as V beta + n_k of that.
// table rows hold n_dk + alpha_k in f32 and row kpad holds the doc-mask
// flag, exactly as the TPU kernel keeps them, so the +-1 updates round the
// same way (pallas_pcgs.py:208-263, cdf_draw :70-132). The prefix sums may
// associate differently from the TPU kernel's and the plain version's;
// a token can then differ only where a sum crosses u (a rounding tie).
//
// Design. The TPU kernels got the per-document order from a
// chunk-sequential grid over sequential-safe blocks (no chunk holds two
// tokens of one document) and built every per-token gather as a one-hot
// matrix product against VMEM-resident or DMA-streamed windows. Here a
// warp owns a document and walks its slots in slot order (CSR lists
// doc_offsets / doc_slots, built on the host). Phi is fixed for the sweep
// and documents are independent given phi, so in the PCGS mode the draws
// do not depend on which warp takes which document, nor when.
//
// The PCGS mode at kpad <= 256 (pcgs_lane_kernel). Its parent kept the
// n_dk column in shared memory with lane l on topics l, l+32, ...: per
// token it gathered an f32 phi row and rounded it to bf16, ran one 5-step
// shuffle scan per 32 topics and one ballot count per 32 topics, and
// updated the column from lane 0 between two __syncwarp()s. Timed in
// turns with one source of cost removed at a time (PERF.md §6), the
// scans cost 0.12 of its 0.45 ms at K=100 (0.31 of 0.93 at K=200), the
// row gather and rounding 0.05 (0.13), index document order 0.02 (0.05),
// the N_kw atomics under 0.01, and ptxas's 72 registers at kpad 128 0.06.
// So:
//  - a lane owns 8 contiguous topics of a 128-topic tile, and keeps their
//    n_dk + alpha in registers for the whole document: loaded at its
//    start, stored at its end. 16 lanes hold a tile: at kpad 256 the
//    warp's document (lanes 0-15 on tile 0, 16-31 on tile 1); at kpad 128
//    two documents a warp, one a half, which take consecutive entries of
//    the longest-first order (nearly equal lengths): the warp walks the
//    longer one, and the shorter one's half idles at the end. The
//    own-token subtraction and the +-1 updates are predicated adds in the
//    lanes that own z_old and z, unrolled over the lane's topics (no
//    dynamically indexed register array, which would spill to local
//    memory), so there is no shared memory and no __syncwarp();
//  - per token each lane sums its topics' products in order, one 4-step
//    scan of the lane totals follows inside each 16-lane half, each lane
//    adds its exclusive offset and counts its own entries <= u - off_t,
//    and one __reduce_add_sync sums the counts (the two documents' counts
//    in the two 16-bit halves of one word). The last nonzero topic is a
//    per-lane maximum and a __reduce_max_sync, left out of the
//    positive-support instances;
//  - a pre-pass (phi_bf16_kernel, one thread per entry, once a sweep)
//    writes bf16(phi) as [V, kpad], zero-padded: 5.1 MB at K=100 and 10.2
//    MB at K=200, resident in the 50 MB L2. Each lane then reads its
//    topics of the token's row with one aligned 16-byte load, and nothing
//    is rounded per token;
//  - warp wi takes documents doc_order[wi] (kpad 256) or doc_order[2 wi]
//    and doc_order[2 wi + 1] (kpad 128), longest first (built on the
//    host), so the last wave is not held by a long document;
//  - the register count is pinned per instance (kPairRegs, kTileRegs).
// Timed in turns against lane-owned variants: 4 topics a lane with one
// document a warp at kpad 128 took 0.285 ms against 0.264 for two
// documents a warp; loading the next token's row a step ahead gained
// nothing once the pair instance no longer spilled (0.265, and 0.287 at
// the 88 registers it then needs unpinned) and cost 1% at kpad 256.
// What bounds it on the H100: neither bytes nor operations (the bound is
// the input and output bytes, tens of microseconds at 20NG) but each
// warp's chain of dependent per-token steps, word row load then scan then
// count, hidden only by the other resident warps.
//
// The collapsed mode and the PCGS mode above kpad 256 (pcgs_sweep_kernel):
// one warp owns one document and holds its n_dk + alpha column in shared
// memory (lane k % 32 on topic k), gathers one word row per token, scans
// with shuffles, counts with ballots, and writes the column back once. The
// document loop is grid-stride in index order, so a launch of one block of
// one warp (`serial`) walks every document in turn.
//
// Staleness contract of the collapsed mode. The TPU kernel draws each
// chunk of at most 128 tokens against the N_kw / n_k left by the chunk
// before it, because its grid runs in order on one core. Blocks here run
// in parallel and in no order, so that schedule cannot be replayed draw
// for draw. Instead:
// - N_kw lives in global memory: every token reads its word's row at draw
//   time and every changed token updates it with atomics at once, so the
//   word term is stale only by the other warps' moves in flight.
// - V beta + n_k is warp-local. Each warp keeps its view `nk` and its
//   unflushed net moves `dn` (K rows each) in shared memory. At the start
//   of every batch of at most 32 slots of a document it flushes `dn` into
//   the global nkp (one reduction per topic that moved), zeroes it, and
//   reloads `nk` from nkp; at the end of the document it flushes again.
//   Its own moves update `nk` and `dn` at once. So a draw's n_k misses
//   only the other warps' moves since its batch began; its own are in.
// That is a member of the AD-LDA family (Newman et al. 2009), fresher than
// the reference's whole-sweep replicas (ADLDA.java:176-332) and not the
// TPU's chunk schedule. The one-warp launch is the sequential collapsed
// chain (documents in index order) with this kernel's rounding: every
// reload reads back exactly the warp's own flushes, because lane k % 32
// both flushes and reloads topic k, in program order.
// The reads of N_kw and nkp bypass L1 (relaxed GPU-scope loads, which L2
// serves): L1 is not coherent with the L2 atomics, not even the warp's
// own, so an L1 hit could return a count from before the warp's last
// update and keep it for a whole sweep.
// nkp's f32 updates (+-1 in the view, integer deltas in the flush) are
// exact while its values stay below 2^24 with fractional parts on their
// ulp grid (Vbeta + n_k with an integer Vbeta, as at beta = 0.01,
// V = 20000), so the view and the flushed sums agree bit for bit.
//
// What bounds the collapsed mode on the H100: the same chain, plus one
// division per topic, an L2 row read of N_kw per token and two N_kw
// atomics per changed token. Its V beta + n_k was read by every token and
// updated by two atomics per move on the same K addresses (4 cache lines
// at K=100) by all resident warps at once; that queue, not the chain, set
// its pace (PERF.md: 7.3 ms with it, 1.8 ms without), hence the
// warp-local view: per batch of up to 32 tokens, one coalesced read and
// at most one reduction per topic. What remains above the chain is the
// same queue, smaller, on the N_kw rows of the Zipf head words, which stay
// live. At kpad == 128 the cdf stays in registers. One warp per document
// also waits on the longest document.
//
// Padding slots are not in any slot list, so they keep z_old (the wrapper
// copies z_old into z_out) and are never counted: their sentinels
// (w_local = vspan, d_local = dspan) would index a real row of the next
// window.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

// A live count: a relaxed load at GPU scope, served by L2 (never a stale
// L1 line); volatile with a memory clobber, so the compiler neither caches
// it across tokens nor moves it above the warp's last update.
__device__ __forceinline__ int load_live(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float load_live(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];"
               : "=f"(v) : "l"(p) : "memory");
  return v;
}

// f32 rows per warp in shared memory: the n_dk + alpha column and the cdf
// (unused at kpad == 128); the collapsed mode adds its view of
// V beta + n_k and its unflushed moves
template <bool kCollapsed>
constexpr int kWarpRows = kCollapsed ? 4 : 2;

// Collapsed mode: publish the warp's net moves (one reduction for each
// topic whose delta is nonzero) and zero them. Lane k % 32 owns topic k.
__device__ __forceinline__ void flush_moves(float* nkp, int* dn, int K,
                                            int lane) {
  for (int k = lane; k < K; k += 32) {
    const int m = dn[k];
    if (m != 0) {
      atomicAdd(nkp + k, static_cast<float>(m));
      dn[k] = 0;
    }
  }
}

// Collapsed mode: reload the warp's view of V beta + n_k, a 128-topic
// group's loads issued together. The same lane that flushed topic k reads
// it, after its reduction in program order, so the warp's own moves are
// always in; the barrier orders the view before lane 0's next update.
__device__ __forceinline__ void reload_view(const float* nkp, float* nk,
                                            int K, int lane) {
  for (int k0 = 0; k0 < K; k0 += 128) {
    float v[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int k = k0 + g * 32 + lane;
      v[g] = k < K ? load_live(nkp + k) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int k = k0 + g * 32 + lane;
      if (k < K) nk[k] = v[g];
    }
  }
  __syncwarp();
}

// kOneTile: kpad == 128, so the token's cdf stays in registers (4 values
// a lane) and never goes through shared memory.
template <bool kCollapsed, bool kOneTile>
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
                                  int* __restrict__ nkw,
                                  float* __restrict__ nkp, float beta,
                                  int num_docs, long long dpad, int kpad,
                                  int K, int vspan, int win_div,
                                  int positive_support) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* col = smem + static_cast<long long>(warp) * kWarpRows<kCollapsed>
                          * kpad;
  float* cdf = col + kpad;
  float* nk = cdf + kpad;                        // collapsed: the view
  int* dn = reinterpret_cast<int*>(nk + kpad);   // collapsed: net moves
  const int ntile = kOneTile ? 1 : kpad / 128;
  if (kCollapsed) {
    for (int k = lane; k < K; k += 32) dn[k] = 0;
  }

  // d is uniform across the warp
  for (int d = blockIdx.x * warps + warp; d < num_docs;
       d += gridDim.x * warps) {
    const int beg = doc_offsets[d];
    const int end = doc_offsets[d + 1];
    const float flag = table[kpad * dpad + d];
    const bool selected = flag > 0.5f;
    // collapsed: an unselected document neither draws nor counts
    if (kCollapsed && !selected) continue;
    if (selected) {
      for (int k = lane; k < K; k += 32) col[k] = table[k * dpad + d];
    }
    __syncwarp();

    for (int base = beg; base < end; base += 32) {
      if (kCollapsed) {
        flush_moves(nkp, dn, K, lane);
        reload_view(nkp, nk, K, lane);
      }
      // each lane fetches one of the next 32 slots; the warp walks them
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
        int* nw = nkw + wrow * K;
        // pass 1: tile-local cdfs, tile totals, last nonzero topic
        float total = 0.f;
        int last = -1;
        float cdf1[4];                       // kOneTile: the cdf
        for (int t = 0; t < ntile; ++t) {
          float carry = 0.f;
          // collapsed: the tile's live N_kw, all loads issued first, and
          // the warp's view of V beta + n_k
          int nwk[4];
          float nkk[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int k = t * 128 + g * 32 + lane;
            nwk[g] = kCollapsed && k < K ? load_live(nw + k) : 0;
            nkk[g] = kCollapsed && k < K ? nk[k] : 1.f;
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int k = t * 128 + g * 32 + lane;
            float p = 0.f;
            if (k < K) {
              const float c = k == zo ? flag : 0.f;
              const float nd = __fsub_rn(col[k], c);
              if (kCollapsed) {
                const float num = __fsub_rn(
                    __fadd_rn(static_cast<float>(nwk[g]), beta), c);
                const float den = __fsub_rn(nkk[g], c);
                p = bf16_round(__fmul_rn(nd, __fdiv_rn(num, den)));
              } else {
                p = bf16_round(__fmul_rn(nd, bf16_round(ph[k])));
              }
              if (p > 0.f) last = k;
            }
            float s = p;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const float v = __shfl_up_sync(kFull, s, off);
              if (lane >= off) s = __fadd_rn(s, v);
            }
            s = __fadd_rn(s, carry);
            if (kOneTile) {
              cdf1[g] = s;
            } else {
              cdf[k] = s;
            }
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
              total);                              // u24 * 2^-24 * total
          // pass 2: count cdf_k <= u - off_t over every tile
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
          z = min(cnt, lastnz);
          if (!kCollapsed && !positive_support) {
            // each 32-topic chunk's cdf is a Hillis-Steele scan, whose
            // association differs from topic to topic: as in
            // pcgs_lane_kernel, a count that passes into topics whose p is
            // 0 moves to the last topic at or below it with p > 0
            for (int c = z >> 5; c >= 0; --c) {
              const int k = c * 32 + lane;
              float p = 0.f;
              if (k <= z) {
                const float nd = __fsub_rn(col[k], k == zo ? flag : 0.f);
                p = bf16_round(__fmul_rn(nd, bf16_round(ph[k])));
              }
              const unsigned m = __ballot_sync(kFull, p > 0.f);
              if (m != 0u) {
                z = c * 32 + 31 - __clz(m);
                break;
              }
            }
          }
        }
        __syncwarp();
        if (z != zo && lane == 0) {
          col[zo] = __fsub_rn(col[zo], 1.f);
          col[z] = __fadd_rn(col[z], 1.f);
          if (kCollapsed) {
            atomicAdd(nw + zo, -1);
            atomicAdd(nw + z, 1);
            nk[zo] = __fsub_rn(nk[zo], 1.f);
            nk[z] = __fadd_rn(nk[z], 1.f);
            dn[zo] -= 1;
            dn[z] += 1;
          }
        }
        // orders lane 0's updates before every lane's next reads
        __syncwarp();
        if (lane == j) my_z = z;
      }
      if (valid) {
        z_out[slot] = my_z;
        if (!kCollapsed) atomicAdd(nkw + my_wrow * K + my_z, 1);
      }
    }
    if (selected) {
      __syncwarp();
      for (int k = lane; k < K; k += 32) table[k * dpad + d] = col[k];
      if (kCollapsed) flush_moves(nkp, dn, K, lane);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The PCGS mode at kpad <= 256: lane-owned topics (header, "The PCGS mode at
// kpad <= 256").
// ---------------------------------------------------------------------------

constexpr float kInv24 = 5.9604644775390625e-8f;  // 2^-24
constexpr int kLaneKpad = 256;   // largest kpad of the lane-owned instances
constexpr int kLaneWarps = 8;    // warps a block
constexpr int kPer = 8;          // topics a lane owns
// Registers a thread, pinned per instance (PERF.md §6, in turns on
// 20NG shapes): the two-document instance (kpad 128) needs 80 to spill
// nothing, and at 80 takes 0.264 ms where a cap of 64 (4 blocks an SM,
// 32 bytes spilled) took 0.275; the two-tile instance (kpad 256) takes
// 0.396 ms at 64 (24-32 bytes spilled, 4 blocks an SM) where 72, 80 or
// its own 80-86 (3 or 2 blocks) took 0.414-0.426.
constexpr int kPairRegs = 80;
constexpr int kTileRegs = 64;

// Pre-pass: out[v, k] = bf16(phi[v, k]) for k < K, 0 up to kpad.
__global__ void phi_bf16_kernel(const float* __restrict__ phi,
                                __nv_bfloat16* __restrict__ out, long long n,
                                int K, int kpad) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = i / kpad;
  const int k = static_cast<int>(i - v * kpad);
  out[i] = __float2bfloat16_rn(k < K ? phi[v * K + k] : 0.f);
}

// The lane's kPer consecutive bf16 values of a word row: one aligned
// 16-byte load, two values a word (the lower topic in the low half).
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         unsigned (&w)[kPer / 2]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// bf16 value i of the words w, as f32 (exact)
__device__ __forceinline__ float row_value(const unsigned (&w)[kPer / 2],
                                           int i) {
  const unsigned x = w[i >> 1];
  return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
}

// A segment of 16 lanes covers 128 topics: with kPair (kpad 128), one of
// the warp's two documents; else (kpad 256) one 128-topic tile of the
// warp's document. kLastNz: clamp to the last topic with p > 0 (else to
// K - 1).
template <bool kPair, bool kLastNz>
__global__ void __maxnreg__(kPair ? kPairRegs : kTileRegs) pcgs_lane_kernel(
    const int* __restrict__ w_local, const int* __restrict__ z_old,
    const int* __restrict__ win_w, const int* __restrict__ doc_offsets,
    const int* __restrict__ doc_slots, const int* __restrict__ doc_order,
    const __nv_bfloat16* __restrict__ phi16, const int* __restrict__ u24,
    const long long* __restrict__ seed, float* __restrict__ table,
    int* __restrict__ z_out, int* __restrict__ nkw, int num_docs,
    long long dpad, int kpad, int K, int vspan, int win_div) {
  constexpr int kSeg = 128 / kPer;               // lanes a segment
  constexpr int kDocs = kPair ? 2 : 1;           // documents a warp
  constexpr int kTiles = kPair ? 1 : 32 / kSeg;  // 128-topic tiles a document
  constexpr int kBatch = 32 / kDocs;             // slots a document fetches
  const int lane = threadIdx.x & 31;
  const int seg = lane / kSeg;
  const int sl = lane % kSeg;                    // lane in its segment
  const int h = kPair ? seg : 0;                 // the lane's document
  const int first = (kPair ? sl : lane) * kPer;  // the lane's first topic
  const int fetch = lane % kBatch;               // its slot in a batch
  const int warps = blockDim.x >> 5;
  const int groups = (num_docs + kDocs - 1) / kDocs;

  for (int wi = blockIdx.x * warps + (threadIdx.x >> 5); wi < groups;
       wi += gridDim.x * warps) {
    const int oi = wi * kDocs + h;
    const bool has = oi < num_docs;
    const int d = has ? doc_order[oi] : 0;
    const int beg = has ? doc_offsets[d] : 0;
    const int len = has ? doc_offsets[d + 1] - beg : 0;
    const float flag = has ? table[kpad * dpad + d] : 0.f;
    const bool selected = flag > 0.5f;
    // the lane's topics of the n_dk + alpha column
    float col[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = first + i;
      col[i] = selected && k < K ? table[k * dpad + d] : 0.f;
    }
    // the warp walks its longer document
    int steps = len;
    bool draws = selected;
    if (kPair) {
      steps = max(len, __shfl_xor_sync(kFull, len, 16));
      draws = __any_sync(kFull, selected);
    }

    for (int b = 0; b < steps; b += kBatch) {
      // each lane fetches one of its document's next kBatch slots
      const bool valid = b + fetch < len;
      const int slot = valid ? doc_slots[beg + b + fetch] : 0;
      const int my_zo = valid ? z_old[slot] : 0;
      const long long my_wrow =
          valid ? static_cast<long long>(win_w[slot / win_div]) * vspan
                      + w_local[slot]
                : 0;
      const unsigned my_bits =
          (valid && selected) ? slot_u24(u24, seed, slot) : 0u;
      int my_z = my_zo;
      const int n = min(kBatch, steps - b);
      for (int j = 0; draws && j < n; ++j) {
        const int src = h * kBatch + j;          // the lane that fetched it
        const int zo = __shfl_sync(kFull, my_zo, src);
        const long long wrow = __shfl_sync(kFull, my_wrow, src);
        const unsigned bits = __shfl_sync(kFull, my_bits, src);
        const bool act = selected && b + j < len;
        unsigned w[kPer / 2];
        load_row(phi16 + wrow * kpad + first, w);
        // the lane's products, summed in order
        float pre[kPer];
        float s = 0.f;
        int last = -1;
        unsigned nzbits = 0;          // kLastNz: the topics with p > 0
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int k = first + i;
          const float nd = k == zo ? __fsub_rn(col[i], flag) : col[i];
          const float p = bf16_round(__fmul_rn(nd, row_value(w, i)));
          if (kLastNz && p > 0.f) {
            last = k;
            nzbits |= 1u << i;
          }
          s = i == 0 ? p : __fadd_rn(s, p);
          pre[i] = s;
        }
        // inclusive scan of the lane totals inside the segment, then each
        // lane's exclusive offset
        float incl = s;
#pragma unroll
        for (int off = 1; off < kSeg; off <<= 1) {
          const float v = __shfl_up_sync(kFull, incl, off);
          if (sl >= off) incl = __fadd_rn(incl, v);
        }
        float excl = __shfl_up_sync(kFull, incl, 1);
        if (sl == 0) excl = 0.f;
        float total;
        float tile_off = 0.f;         // the totals of the tiles before
        if (kTiles == 2) {
          const float t0 = __shfl_sync(kFull, incl, kSeg - 1);
          total = __fadd_rn(t0, __shfl_sync(kFull, incl, 31));
          if (seg == 1) tile_off = t0;
        } else {
          total = __shfl_sync(kFull, incl, seg * kSeg + kSeg - 1);
        }
        const float u = __fmul_rn(
            __fmul_rn(static_cast<float>(bits), kInv24), total);
        const float thr = __fsub_rn(u, tile_off);
        unsigned cnt = 0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) cnt += __fadd_rn(excl, pre[i]) <= thr;
        int lastnz = K - 1;
        if (kPair) {
          // each half's count in its own 16 bits (at most 128 each)
          cnt = (__reduce_add_sync(kFull, cnt << (16 * seg)) >> (16 * seg))
                & 0xffffu;
          if (kLastNz) {
            const int l0 = __reduce_max_sync(kFull, seg == 0 ? last : -1);
            const int l1 = __reduce_max_sync(kFull, seg == 1 ? last : -1);
            lastnz = seg == 0 ? l0 : l1;
          }
        } else {
          cnt = __reduce_add_sync(kFull, cnt);
          if (kLastNz) lastnz = __reduce_max_sync(kFull, last);
        }
        int z = zo;
        if (act && total > 0.f) z = min(static_cast<int>(cnt), lastnz);
        if (kLastNz) {
          // The lanes' values are each lane's running sums after its
          // exclusive offset from the scan, so two associations of one sum
          // meet at every lane boundary: where u lies between them, the
          // count can pass over a lane's last topic into a run of topics
          // whose p is 0. z then moves to the last topic at or below it
          // with p > 0 (the plain version's cumsum is monotone and never
          // draws a zero); a z with p > 0 stays. The lane that owns z
          // sees whether its p is 0, and only then does the warp search.
          const int zi = z - first;
          const bool on_zero = act && total > 0.f && zi >= 0 && zi < kPer
                               && !((nzbits >> zi) & 1u);
          if (__any_sync(kFull, on_zero)) {
            const unsigned below =
                zi < 0 ? 0u
                       : (zi >= kPer - 1 ? nzbits
                                         : nzbits & ((2u << zi) - 1u));
            int cand = below ? first + 31 - __clz(below) : -1;
            if (kPair) {
              const int c0 = __reduce_max_sync(kFull, seg == 0 ? cand : -1);
              const int c1 = __reduce_max_sync(kFull, seg == 1 ? cand : -1);
              cand = seg == 0 ? c0 : c1;
            } else {
              cand = __reduce_max_sync(kFull, cand);
            }
            if (act && total > 0.f && cand >= 0) z = cand;
          }
        }
        // the lanes that own z_old and z update the column
        if (z != zo) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int k = first + i;
            if (k == zo) col[i] = __fsub_rn(col[i], 1.f);
            if (k == z) col[i] = __fadd_rn(col[i], 1.f);
          }
        }
        if (lane == src) my_z = z;
      }
      if (valid) {
        z_out[slot] = my_z;
        atomicAdd(nkw + my_wrow * K + my_z, 1);
      }
    }
    if (selected) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = first + i;
        if (k < K) table[k * dpad + d] = col[i];
      }
    }
  }
}

using LaneKernel = decltype(&pcgs_lane_kernel<true, true>);

// The lane-owned instance for kpad (128 or 256): topics a lane, documents
// a warp, and the kernel.
LaneKernel lane_instance(int kpad, int positive_support, int* per,
                         int* docs) {
  *per = kPer;
  *docs = kpad == 128 ? 2 : 1;
  if (kpad == 128) {
    return positive_support ? pcgs_lane_kernel<true, false>
                            : pcgs_lane_kernel<true, true>;
  }
  return positive_support ? pcgs_lane_kernel<false, false>
                          : pcgs_lane_kernel<false, true>;
}

// One instance's launch: `warps` warps per block, one document per warp,
// or (serial) one block of one warp walking every document, with `smem`
// bytes of dynamic shared memory per block.
template <bool kCollapsed>
void launch_shape(int kpad, int serial, int* warps, long long* smem) {
  // warps per block: 8, fewer when the per-warp rows are large
  const long long warp_bytes =
      static_cast<long long>(kWarpRows<kCollapsed>) * kpad * sizeof(float);
  int w = 8;
  while (w > 1 && w * warp_bytes > 48 * 1024) w >>= 1;
  if (serial) w = 1;
  *warps = w;
  *smem = w * warp_bytes;
}

// pcgs_sweep_kernel: the collapsed mode, and the PCGS mode above kpad 256
// (doc_order is not read: documents go in index order).
template <bool kCollapsed>
int launch(const void* w_local, const void* z_old, const void* win_w,
           const void* doc_offsets, const void* doc_slots, const void* phi,
           const void* u24, const void* seed, void* table, void* z_out,
           void* nkw, void* nkp, float beta, int num_docs, long long dpad,
           int kpad, int K, int vspan, int win_div, int positive_support,
           int serial, int device, void* stream) {
  cudaSetDevice(device);
  if (num_docs <= 0) return static_cast<int>(cudaGetLastError());
  int warps;
  long long smem;
  launch_shape<kCollapsed>(kpad, serial, &warps, &smem);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pcgs_sweep_kernel<kCollapsed, false>;
  if constexpr (kCollapsed) {
    if (kpad == 128) kernel = pcgs_sweep_kernel<true, true>;
  }
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int blocks = serial ? 1 : (num_docs + warps - 1) / warps;
  kernel<<<blocks, warps * 32, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w_local), static_cast<const int*>(z_old),
      static_cast<const int*>(win_w), static_cast<const int*>(doc_offsets),
      static_cast<const int*>(doc_slots), static_cast<const float*>(phi),
      static_cast<const int*>(u24), static_cast<const long long*>(seed),
      static_cast<float*>(table), static_cast<int*>(z_out),
      static_cast<int*>(nkw), static_cast<float*>(nkp), beta, num_docs, dpad,
      kpad, K, vspan, win_div, positive_support);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// phi: f32 [V, K]; out: bf16 [V, kpad], bf16(phi) zero-padded.
extern "C" int lda_pcgs_phi_bf16(const void* phi, void* out, int V, int K,
                                 int kpad, int device, void* stream) {
  cudaSetDevice(device);
  const long long n = static_cast<long long>(V) * kpad;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  phi_bf16_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi), static_cast<__nv_bfloat16*>(out), n, K,
      kpad);
  return static_cast<int>(cudaGetLastError());
}

// w_local, z_old, u24 (nullable): int32 [n] slots of the layout;
// win_w: int32, the w-window of slot s is win_w[s / win_div] (win_div is
// the block size for the resident layout, the chunk for the streamed one);
// doc_offsets int32 [num_docs + 1] and doc_slots int32 [N]: each
// document's real slots in visit order; doc_order: int32 [num_docs], a
// permutation of the documents, the order in which warps take them (read
// at kpad <= 256); phi: f32 [V, K] (read above kpad 256); phi16: bf16
// [V, kpad], lda_pcgs_phi_bf16's output (read at kpad <= 256); seed: int64
// [1]; table: f32 [kpad + 8, dpad], updated in place; z_out: int32 [n],
// holding z_old on entry; nkw: int32 [nwin_w * vspan, K], zeroed by the
// caller; serial != 0 launches one block of one warp.
extern "C" int lda_pcgs_sweep(const void* w_local, const void* z_old,
                              const void* win_w, const void* doc_offsets,
                              const void* doc_slots, const void* doc_order,
                              const void* phi, const void* phi16,
                              const void* u24, const void* seed, void* table,
                              void* z_out, void* nkw, int num_docs,
                              long long dpad, int kpad, int K, int vspan,
                              int win_div, int positive_support,
                              int serial, int device, void* stream) {
  if (kpad > kLaneKpad) {
    return launch<false>(w_local, z_old, win_w, doc_offsets, doc_slots, phi,
                         u24, seed, table, z_out, nkw, nullptr, 0.f,
                         num_docs, dpad, kpad, K, vspan, win_div,
                         positive_support, serial, device, stream);
  }
  cudaSetDevice(device);
  if (num_docs <= 0) return static_cast<int>(cudaGetLastError());
  int per, docs;
  const LaneKernel kernel = lane_instance(kpad, positive_support, &per,
                                          &docs);
  const int groups = (num_docs + docs - 1) / docs;
  const int warps = serial ? 1 : kLaneWarps;
  const int blocks = serial ? 1 : (groups + warps - 1) / warps;
  kernel<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w_local), static_cast<const int*>(z_old),
      static_cast<const int*>(win_w), static_cast<const int*>(doc_offsets),
      static_cast<const int*>(doc_slots), static_cast<const int*>(doc_order),
      static_cast<const __nv_bfloat16*>(phi16), static_cast<const int*>(u24),
      static_cast<const long long*>(seed), static_cast<float*>(table),
      static_cast<int*>(z_out), static_cast<int*>(nkw), num_docs, dpad, kpad,
      K, vspan, win_div);
  return static_cast<int>(cudaGetLastError());
}

// The collapsed (ADLDA) mode. Operands as lda_pcgs_sweep, without
// doc_order, phi and phi16, plus: nkw int32 [nwin_w * vspan, K] seeded with
// the sweep-entry counts and nkp f32 [K] seeded with V beta + n_k, both
// updated in place (the live counts); beta; serial != 0 launches one block
// of one warp.
extern "C" int lda_pcgs_collapsed_sweep(
    const void* w_local, const void* z_old, const void* win_w,
    const void* doc_offsets, const void* doc_slots, const void* u24,
    const void* seed, void* table, void* z_out, void* nkw, void* nkp,
    float beta, int num_docs, long long dpad, int kpad, int K, int vspan,
    int win_div, int positive_support, int serial, int device,
    void* stream) {
  return launch<true>(w_local, z_old, win_w, doc_offsets, doc_slots, nullptr,
                      u24, seed, table, z_out, nkw, nkp, beta, num_docs,
                      dpad, kpad, K, vspan, win_div, positive_support, serial,
                      device, stream);
}

// The launch shape of either mode for a table of kpad topic rows: out
// int64 [4] = (warps per block, dynamic shared memory bytes per block,
// topics a lane, documents a warp).
extern "C" int lda_pcgs_launch_shape(int kpad, int collapsed, int serial,
                                     void* out) {
  int warps, per = kpad / 32, docs = 1;
  long long smem = 0;
  if (collapsed) {
    launch_shape<true>(kpad, serial, &warps, &smem);
  } else if (kpad > kLaneKpad) {
    launch_shape<false>(kpad, serial, &warps, &smem);
  } else {
    lane_instance(kpad, 0, &per, &docs);
    warps = serial ? 1 : kLaneWarps;
  }
  long long* o = static_cast<long long*>(out);
  o[0] = warps;
  o[1] = smem;
  o[2] = per;
  o[3] = docs;
  return 0;
}
