// The alias-MH z-step of scheme ggs_aliasmh for Hopper (sm_90a).
//
// Replaces the XLA program of
// ldagroupedgibbssampler_tpu/models/ggs_aliasmh.py:89 (`alias_mh_rounds`,
// `aliasmh_rounds` word/doc MH step pairs over every canonical token,
// which XLA fuses into one program) with the table set-up and the z
// crossing of its `_step` (:247, the packed [., 2] tables; the gathers
// between the layout-A slots and the canonical token axis). Per canonical
// token t of document d and type w, with target p(k) = theta[d, k]
// phi[k, w] and the sweep-entry topics z_e:
//
//   word step: k* = z_e[uniform token of type w] if u_mix < n_w / (n_w +
//     K beta), else a uniform topic; q_w(k) = f32(N_kw[w, k]) + beta;
//   doc step: k* = z_e[uniform token of d] if u_mix < L_d / (L_d +
//     alpha_sum), else a uniform topic; q_d(k) = f32(n_dk[d, k]) +
//     alpha_sum / K (the uniform fallback's mass for any alpha vector);
//   accept if u_acc * max(t_c q(k*), 1e-38) < t(k*) q(z), in f32, with t_c
//   and both proposal densities of the current point carried across
//   steps, so only the proposed point costs gathers. Tokens of documents
//   that random scan did not select keep their z.
//
// The arithmetic is op for op that of ops/cuda_alias_mh.py::
// alias_mh_reference (which runs models/ggs_aliasmh.py::alias_mh_rounds):
// __f*_rn intrinsics, so no product is contracted into an FMA, and
// subnormals kept (no -ftz). The random words are Philox4x32-10 blocks
// keyed by the int64 seed in device memory, at counter (j << 32) | t with
// j = 4 r + 2 s + b for round r, step s (0 word, 1 doc) and block b = 0, 1,
// a function of (token, round, step) alone: block 0 gives u_mix (word x),
// the position's 62 bits (y, z) and the uniform topic's first word (w);
// block 1 the topic's second word (x) and u_acc (y). A uniform is
// (word >> 8) 2^-24; a position or a topic is 62 bits modulo its bound,
// exact (bias under 2^-30), reduced by a Barrett step whose reciprocal,
// floor((2^64 - 1) / bound), the corpus fixes: it is made once at set-up
// into a record a document and a record a type (ops/cuda_alias_mh.py::
// count_table: base, count, reciprocal), as the topics' is once a launch.
//
// Three launches an iteration, three entry points:
//   lda_alias_mh_entry: the sweep-entry topics gathered into canonical
//     order (z_slot[slot_of_can[t]]) and into type order, and the output
//     slot array zeroed (its padding slots stay 0). Every token's picks
//     read other tokens' entry topics, so this finishes before any round;
//   lda_alias_mh_rounds: one thread a canonical token, every round in
//     registers; the new z written straight to its layout-A slot; the
//     accepted tokens of each step counted by warp ballots into shared
//     memory and one atomic a block and step, when the caller asks;
//   lda_alias_mh_pack (packed mode): both [., 2] tables, (phi, f32(N_kw)
//     + beta) and (theta, f32(n_dk) + alpha_sum / K), written in one pass.
//
// What bounds it on the H100: at K=100 the four tables (~25 MB) sit in
// the 50 MB L2, and the bound is the Philox blocks' integer multiplies
// (8 blocks a token at 2 rounds, 40 multiplies each, 64 a clock an SM:
// ~0.026 ms for 1.35M tokens with every document selected) beside the
// streamed token operands (~28 B a token, ~0.011 ms). At K=4096 the
// tables are ~1 GB and every density is a random 32-byte sector from
// HBM: 20 a token unpacked, 10 packed. The rounds' pace follows the
// scattered 32-byte sectors a token reads from L2, not the multiplies
// (PERF.md §6 has the costs, timed one removed at a time).
// The design: the token operands are int32 and streamed once; a token's
// picks read the entry topics from the pre-pass's dense arrays, never
// through a slot map (one gather a pick); a proposal
// depends on the entry topics and the draws alone, not on which earlier
// steps accepted, so each batch of kBatch steps draws its proposals and
// issues their gathers together before its accept tests run in order on
// registers (one memory latency a batch, not one a step); a proposal of
// the entry topic reads the entry densities (the values a gather would
// return) and gathers nothing; the modulo is a multiply-high and two
// compares in the rounds; the packed mode reads one float2 a density, so
// one sector; the pack writes float4 pairs.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;                  // grid-stride kernels
constexpr float kInv24 = 5.9604644775390625e-8f;      // 2^-24
constexpr float kTiny = 1e-38f;                       // models' _TINY
constexpr int kBatch = 4;             // steps whose proposals go together

// (word >> 8) 2^-24: torch.rand's form, in [0, 1), exact in f32
__device__ __forceinline__ float unit24(unsigned w) {
  return __fmul_rn(static_cast<float>(w >> 8), kInv24);
}

// 62 random bits of two words: (hi 2^32 + lo) >> 2
__device__ __forceinline__ unsigned long long bits62(unsigned hi,
                                                     unsigned lo) {
  return (static_cast<unsigned long long>(hi) << 30) | (lo >> 2);
}

// the reciprocal of a count_table record: inv low, inv high
__device__ __forceinline__ unsigned long long inv_of(int4 rec) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(rec.w))
          << 32) | static_cast<unsigned>(rec.z);
}

// x mod m, exactly: q = floor(x inv / 2^64) lies within 2 below
// floor(x / m), so two conditional subtractions finish the remainder
__device__ __forceinline__ unsigned mod_exact(unsigned long long x,
                                              unsigned m,
                                              unsigned long long inv) {
  const unsigned long long q = __umul64hi(x, inv);
  unsigned long long r = x - q * m;
  if (r >= m) r -= m;
  if (r >= m) r -= m;
  return static_cast<unsigned>(r);
}

struct Tables {
  const float* phi;     // [V, K]
  const int* nkw;       // [V, K]
  const float* theta;   // [D, K]
  const int* ndk;       // [D, K]
  const float2* wk;     // packed [V K]: (phi, f32(N_kw) + beta)
  const float2* dk;     // packed [D K]: (theta, f32(n_dk) + alpha_sum / K)
};

// (phi[k, w], q_w(k)) at i = w K + k, and (theta[d, k], q_d(k)) at d K + k
template <bool kPacked>
__device__ __forceinline__ void word_density(const Tables& tb, long long i,
                                             float beta, float* p,
                                             float* q) {
  if (kPacked) {
    const float2 v = __ldg(tb.wk + i);
    *p = v.x;
    *q = v.y;
  } else {
    *p = __ldg(tb.phi + i);
    *q = __fadd_rn(static_cast<float>(__ldg(tb.nkw + i)), beta);
  }
}

template <bool kPacked>
__device__ __forceinline__ void doc_density(const Tables& tb, long long i,
                                            float au, float* p, float* q) {
  if (kPacked) {
    const float2 v = __ldg(tb.dk + i);
    *p = v.x;
    *q = v.y;
  } else {
    *p = __ldg(tb.theta + i);
    *q = __fadd_rn(static_cast<float>(__ldg(tb.ndk + i)), au);
  }
}

__global__ void __launch_bounds__(kThreads)
    entry_kernel(const int* __restrict__ z_slot,
                 const int* __restrict__ slot_of_can,
                 const int* __restrict__ slot_of_can_ty,
                 int* __restrict__ z_can, int* __restrict__ z_ty,
                 int* __restrict__ z_out, long long n, long long slots) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = tid; i < n; i += stride) {
    z_can[i] = z_slot[slot_of_can[i]];
    z_ty[i] = z_slot[slot_of_can_ty[i]];
  }
  // z_out comes from torch.empty: 16-byte aligned
  const long long n4 = slots / 4;
  int4* out4 = reinterpret_cast<int4*>(z_out);
  for (long long i = tid; i < n4; i += stride)
    out4[i] = make_int4(0, 0, 0, 0);
  for (long long i = 4 * n4 + tid; i < slots; i += stride) z_out[i] = 0;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads) rounds_kernel(
    const int* __restrict__ z_can, const int* __restrict__ z_ty,
    const int* __restrict__ slot_of_can, const int* __restrict__ tok_w,
    const int* __restrict__ tok_d, const int4* __restrict__ doc_tab,
    const int4* __restrict__ ty_tab, Tables tb,
    const bool* __restrict__ doc_mask, const float* __restrict__ alpha_sum,
    const float* __restrict__ au_p, float beta, float kbeta,
    const long long* __restrict__ seed_p, int* __restrict__ z_out,
    int* __restrict__ acc_counts, long long n, int K, int rounds,
    unsigned long long inv_k) {
  extern __shared__ int s_acc[];   // [rounds, 2] when counting
  const bool counting = acc_counts != nullptr;
  if (counting) {
    for (int i = threadIdx.x; i < 2 * rounds; i += blockDim.x) s_acc[i] = 0;
    __syncthreads();
  }
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = t < n;
  const unsigned lane = threadIdx.x & 31u;
  const int steps = 2 * rounds;
  int z0 = 0, w = 0, d = 0;
  bool upd = false;
  if (live) {
    z0 = z_can[t];
    w = tok_w[t];
    d = tok_d[t];
    upd = doc_mask == nullptr || doc_mask[d];
  }
  const unsigned long long seed =
      upd ? static_cast<unsigned long long>(*seed_p) : 0ULL;
  const unsigned long long tok = static_cast<unsigned long long>(t);
  // per-token operands of an updatable token: its document's and type's
  // records (base, count, reciprocal; a token's spans are never empty),
  // and the entry topic's densities (the carried state's start, and every
  // proposal of it)
  long long doc_base = 0, ty_base = 0;
  unsigned doc_hi = 1, ty_hi = 1;
  unsigned long long inv_doc = 0, inv_ty = 0;
  float p_w = 0.f, p_d = 0.f, au = 0.f;
  long long wK = 0, dK = 0;
  float ph0 = 0.f, th0 = 0.f, qw0 = 0.f, qd0 = 0.f;
  if (upd) {
    const int4 dr = __ldg(doc_tab + d);
    const int4 tr = __ldg(ty_tab + w);
    doc_base = dr.x;
    ty_base = tr.x;
    doc_hi = static_cast<unsigned>(dr.y);
    ty_hi = static_cast<unsigned>(tr.y);
    inv_doc = inv_of(dr);
    inv_ty = inv_of(tr);
    au = *au_p;
    wK = static_cast<long long>(w) * K;
    dK = static_cast<long long>(d) * K;
    word_density<kPacked>(tb, wK + z0, beta, &ph0, &qw0);
    doc_density<kPacked>(tb, dK + z0, au, &th0, &qd0);
    const float cw = static_cast<float>(ty_hi);
    const float ld = static_cast<float>(doc_hi);
    p_w = __fdiv_rn(cw, __fadd_rn(cw, kbeta));
    p_d = __fdiv_rn(ld, __fadd_rn(ld, *alpha_sum));
  }
  const float t0 = __fmul_rn(th0, ph0);
  int zz = z0;
  float t_c = t0, qw_c = qw0, qd_c = qd0;
  // each batch of kBatch steps: the proposals drawn, their densities
  // gathered, then the accept tests in order on registers
  for (int s0 = 0; s0 < steps; s0 += kBatch) {
    int kp[kBatch];
    float ua[kBatch], tn[kBatch], qwn[kBatch], qdn[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int step = s0 + i;   // round step / 2, word (even) or doc step
      kp[i] = z0;
      ua[i] = 0.f;
      if (upd && step < steps) {
        const unsigned long long j = 2ULL * step;
        const uint4 a = philox4(seed, (j << 32) | tok);
        const uint4 b = philox4(seed, ((j + 1) << 32) | tok);
        ua[i] = unit24(b.y);
        const bool word = (step & 1) == 0;
        if (unit24(a.x) < (word ? p_w : p_d)) {
          const unsigned long long x = bits62(a.y, a.z);
          kp[i] = word ? z_ty[ty_base + mod_exact(x, ty_hi, inv_ty)]
                       : z_can[doc_base + mod_exact(x, doc_hi, inv_doc)];
        } else {
          kp[i] = static_cast<int>(mod_exact(
              bits62(a.w, b.x), static_cast<unsigned>(K), inv_k));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      // the entry topic's densities are the values a gather would return
      tn[i] = t0;
      qwn[i] = qw0;
      qdn[i] = qd0;
      if (upd && s0 + i < steps && kp[i] != z0) {
        float phn, thn;
        word_density<kPacked>(tb, wK + kp[i], beta, &phn, &qwn[i]);
        doc_density<kPacked>(tb, dK + kp[i], au, &thn, &qdn[i]);
        tn[i] = __fmul_rn(thn, phn);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int step = s0 + i;
      if (step >= steps) break;
      const bool word = (step & 1) == 0;
      bool acc = false;
      if (upd) {
        const float q_new = word ? qwn[i] : qdn[i];
        const float q_cur = word ? qw_c : qd_c;
        acc = __fmul_rn(ua[i], fmaxf(__fmul_rn(t_c, q_new), kTiny)) <
              __fmul_rn(tn[i], q_cur);
        if (acc) {
          zz = kp[i];
          t_c = tn[i];
          qw_c = qwn[i];
          qd_c = qdn[i];
        }
      }
      if (counting) {
        const unsigned ballot = __ballot_sync(kFull, acc);
        if (lane == 0 && ballot != 0u) atomicAdd(s_acc + step, __popc(ballot));
      }
    }
  }
  if (live) z_out[slot_of_can[t]] = zz;
  if (counting) {
    __syncthreads();
    for (int i = threadIdx.x; i < steps; i += blockDim.x)
      if (s_acc[i] != 0) atomicAdd(acc_counts + i, s_acc[i]);
  }
}

// (x[i], f32(c[i]) + add) for i < n into out, float4 pairs where the
// three pointers are 16-byte aligned
__device__ __forceinline__ void pack_range(const float* __restrict__ x,
                                           const int* __restrict__ c,
                                           float add,
                                           float2* __restrict__ out,
                                           long long n, long long tid,
                                           long long stride) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(c) |
        reinterpret_cast<uintptr_t>(out)) & 15u) == 0) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
      const int4 k = __ldg(reinterpret_cast<const int4*>(c) + i);
      float4* o = reinterpret_cast<float4*>(out) + 2 * i;
      o[0] = make_float4(v.x, __fadd_rn(static_cast<float>(k.x), add), v.y,
                         __fadd_rn(static_cast<float>(k.y), add));
      o[1] = make_float4(v.z, __fadd_rn(static_cast<float>(k.z), add), v.w,
                         __fadd_rn(static_cast<float>(k.w), add));
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = make_float2(x[i], __fadd_rn(static_cast<float>(c[i]), add));
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const float* __restrict__ phi, const int* __restrict__ nkw,
                float beta, float2* __restrict__ wk, long long nw,
                const float* __restrict__ theta,
                const int* __restrict__ ndk, const float* __restrict__ au_p,
                float2* __restrict__ dk, long long nd) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  pack_range(phi, nkw, beta, wk, nw, tid, stride);
  pack_range(theta, ndk, *au_p, dk, nd, tid, stride);
}

template <bool kPacked>
void launch_rounds(unsigned blocks, size_t smem, cudaStream_t st,
                   const void* z_can, const void* z_ty,
                   const void* slot_of_can, const void* tok_w,
                   const void* tok_d, const void* doc_tab,
                   const void* ty_tab, const Tables& tb,
                   const void* doc_mask, const void* alpha_sum,
                   const void* au, float beta, float kbeta, const void* seed,
                   void* z_out, void* acc_counts, long long n, int K,
                   int rounds, unsigned long long inv_k) {
  rounds_kernel<kPacked><<<blocks, kThreads, smem, st>>>(
      static_cast<const int*>(z_can), static_cast<const int*>(z_ty),
      static_cast<const int*>(slot_of_can), static_cast<const int*>(tok_w),
      static_cast<const int*>(tok_d), static_cast<const int4*>(doc_tab),
      static_cast<const int4*>(ty_tab), tb, static_cast<const bool*>(doc_mask),
      static_cast<const float*>(alpha_sum), static_cast<const float*>(au),
      beta, kbeta, static_cast<const long long*>(seed),
      static_cast<int*>(z_out), static_cast<int*>(acc_counts), n, K, rounds,
      inv_k);
}

unsigned grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1 ? 1
                               : blocks > kMaxBlocks ? kMaxBlocks
                                                     : blocks);
}

}  // namespace

// z_slot: int32 [slots] (the layout-A z); slot_of_can, slot_of_can_ty:
// int32 [n]; z_can, z_ty: int32 [n] out; z_out: int32 [slots] out, zeroed.
extern "C" int lda_alias_mh_entry(const void* z_slot, const void* slot_of_can,
                                  const void* slot_of_can_ty, void* z_can,
                                  void* z_ty, void* z_out, long long n,
                                  long long slots, int device, void* stream) {
  cudaSetDevice(device);
  if (slots <= 0) return static_cast<int>(cudaGetLastError());
  const long long work = n > slots / 4 ? n : slots / 4;
  entry_kernel<<<grid_for(work), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(z_slot), static_cast<const int*>(slot_of_can),
      static_cast<const int*>(slot_of_can_ty), static_cast<int*>(z_can),
      static_cast<int*>(z_ty), static_cast<int*>(z_out), n, slots);
  return static_cast<int>(cudaGetLastError());
}

// The rounds over n canonical tokens (n < 2^32); doc_tab: int32 [D, 4],
// ty_tab: int32 [V, 4], the records (base, count, inv low, inv high) of
// ops/cuda_alias_mh.py::count_table. Unpacked (packed == 0):
// phi f32 [V, K], nkw int32 [V, K], theta f32 [D, K], ndk int32 [D, K];
// packed: wk float2 [V K], dk float2 [D K] (the others may be null).
// doc_mask: bool [D] or null (every document selected); alpha_sum, au:
// f32 [1]; seed: int64 [1]; z_out: int32 [slots] (lda_alias_mh_entry's);
// acc_counts: int32 [rounds, 2], zeroed, or null.
extern "C" int lda_alias_mh_rounds(
    const void* z_can, const void* z_ty, const void* slot_of_can,
    const void* tok_w, const void* tok_d, const void* doc_tab,
    const void* ty_tab, const void* phi, const void* nkw, const void* theta,
    const void* ndk, const void* wk, const void* dk, const void* doc_mask,
    const void* alpha_sum, const void* au, float beta, float kbeta,
    const void* seed, void* z_out, void* acc_counts, long long n, int K,
    int rounds, int packed, int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0 || rounds <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || n > 0xFFFFFFFFLL || 8LL * rounds > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb{static_cast<const float*>(phi), static_cast<const int*>(nkw),
                  static_cast<const float*>(theta),
                  static_cast<const int*>(ndk),
                  static_cast<const float2*>(wk),
                  static_cast<const float2*>(dk)};
  const unsigned long long inv_k = ~0ULL / static_cast<unsigned>(K);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const size_t smem = acc_counts != nullptr ? 8 * rounds : 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (packed != 0)
    launch_rounds<true>(blocks, smem, st, z_can, z_ty, slot_of_can, tok_w,
                        tok_d, doc_tab, ty_tab, tb, doc_mask, alpha_sum, au,
                        beta, kbeta, seed, z_out, acc_counts, n, K, rounds,
                        inv_k);
  else
    launch_rounds<false>(blocks, smem, st, z_can, z_ty, slot_of_can, tok_w,
                         tok_d, doc_tab, ty_tab, tb, doc_mask, alpha_sum, au,
                         beta, kbeta, seed, z_out, acc_counts, n, K, rounds,
                         inv_k);
  return static_cast<int>(cudaGetLastError());
}

// phi f32 [nw], nkw int32 [nw] -> wk float2 [nw]; theta f32 [nd], ndk int32
// [nd], au f32 [1] -> dk float2 [nd]: one launch for both tables.
extern "C" int lda_alias_mh_pack(const void* phi, const void* nkw, float beta,
                                 void* wk, long long nw, const void* theta,
                                 const void* ndk, const void* au, void* dk,
                                 long long nd, int device, void* stream) {
  cudaSetDevice(device);
  if (nw + nd <= 0) return static_cast<int>(cudaGetLastError());
  const long long work = (nw > nd ? nw : nd) / 4 + 1;
  pack_kernel<<<grid_for(work), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi), static_cast<const int*>(nkw), beta,
      static_cast<float2*>(wk), nw, static_cast<const float*>(theta),
      static_cast<const int*>(ndk), static_cast<const float*>(au),
      static_cast<float2*>(dk), nd);
  return static_cast<int>(cudaGetLastError());
}
