// Poisson and Binomial draws from in-kernel Philox, for the Polya-Urn phi
// (csrc/polya_urn.cu) and the HDP step after the sweep (csrc/hdp.cu).
//
// They replace the JAX package's `jax.random.poisson` and
// `jax.random.binomial` inside its fused XLA programs
// (ldagroupedgibbssampler_tpu/ops/random.py:336 `poisson`, :344
// `binomial`) with the regime split that those make:
//   - Poisson(lam): lam < 10 by inversion (one uniform, the sequential
//     search of the cdf in f64, where JAX multiplies uniforms, Knuth's
//     method: the same distribution from one word instead of lam + 1);
//     lam >= 10 by PTRS, Hoermann's transformed rejection (1993), as JAX
//     writes it; lam = 0 gives an exact 0;
//   - Binomial(n, p): n = 0, p = 0 and p = 1 exact; p >= 1/2 drawn as
//     n - Binomial(n, 1 - p); then with q = min(p, 1 - p), inversion by
//     geometric gaps where n q <= 10, else BTRS (Hoermann 1993), both as
//     JAX writes them, except that BTRS's Stirling tail is the series of
//     k itself above 9 (TensorFlow's random_binomial_op), where JAX's
//     evaluates it at k = 9.
// A NaN, a negative count or a p outside [0, 1] gives NaN.
//
// Random words: element e (a flat index the caller chooses) takes its
// round-r Philox4x32-10 block at counter (e << 24) | r under the 64-bit
// seed, so a draw depends on (seed, e) alone and not on the launch shape.
// A rejection round (PTRS, BTRS) takes words x and y of its block; the
// binomial inversion takes the four words of block r for its gaps 4 r ..
// 4 r + 3; the Poisson inversion word x of block 0. Uniforms are unit23
// of a word, in (0, 1). The arithmetic is written with __f*_rn intrinsics
// (no contraction) in the order of the plain versions
// (ops/cuda_polya_urn.py::poisson_reference, ops/cuda_hdp.py::
// binomial_reference), which draw the same words.

#pragma once

#include <cstdint>

#include "philox.cuh"

// A constant as the plain versions hold it: a Python float (double)
// rounded once to f32
#define LDA_F32(x) static_cast<float>(x)

namespace {

constexpr int kRoundBits = 24;        // rounds an element may take: 2^24
constexpr int kMaxRounds = 1 << 20;   // a cap no draw reaches
constexpr int kMaxInversion = 256;    // the f64 cdf passes 1 - 2^-24 by k ~ 35

// Stirling tail log k! - [(k + 1/2) log(k + 1) - (k + 1) + log(2 pi) / 2]
// at k = 0..9 (JAX's and TensorFlow's table)
__constant__ float kStirlingTail[10] = {
    LDA_F32(0.0810614667953272),  LDA_F32(0.0413406959554092),
    LDA_F32(0.0276779256849983),  LDA_F32(0.02079067210376509),
    LDA_F32(0.0166446911898211),  LDA_F32(0.0138761288230707),
    LDA_F32(0.0118967099458917),  LDA_F32(0.0104112652619720),
    LDA_F32(0.00925546218271273), LDA_F32(0.00833056343336287)};

__device__ __forceinline__ uint4 draw_block(unsigned long long seed,
                                            unsigned long long e, int r) {
  return philox4(seed, (e << kRoundBits) | static_cast<unsigned>(r));
}

__device__ __forceinline__ float stirling_tail(float k) {
  if (k <= 9.f) return kStirlingTail[static_cast<int>(k)];
  const float kp1 = __fadd_rn(k, 1.f);
  const float kp1sq = __fmul_rn(kp1, kp1);
  const float inner =
      __fsub_rn(LDA_F32(1.0 / 360), __fdiv_rn(LDA_F32(1.0 / 1260), kp1sq));
  return __fdiv_rn(
      __fsub_rn(LDA_F32(1.0 / 12), __fdiv_rn(inner, kp1sq)), kp1);
}

// Poisson(lam), f32 holding an integer
__device__ float poisson_draw(unsigned long long seed, unsigned long long e,
                              float lam) {
  if (!(lam >= 0.f)) return __int_as_float(0x7fc00000);   // NaN, lam < 0
  if (lam == 0.f || isinf(lam)) return lam;
  if (lam < 10.f) {
    const double u = unit23(draw_block(seed, e, 0).x);
    const double l = lam;
    double p = exp(-l);
    double s = p;
    int k = 0;
    while (u > s && k < kMaxInversion) {
      ++k;
      p = __ddiv_rn(__dmul_rn(p, l), static_cast<double>(k));
      s = __dadd_rn(s, p);
    }
    return static_cast<float>(k);
  }
  const float log_lam = logf(lam);
  const float b =
      __fadd_rn(LDA_F32(0.931), __fmul_rn(LDA_F32(2.53), sqrtf(lam)));
  const float a = __fadd_rn(-LDA_F32(0.059), __fmul_rn(LDA_F32(0.02483), b));
  const float inv_alpha = __fadd_rn(
      LDA_F32(1.1239), __fdiv_rn(LDA_F32(1.1328), __fsub_rn(b, LDA_F32(3.4))));
  const float v_r = __fsub_rn(LDA_F32(0.9277),
                              __fdiv_rn(LDA_F32(3.6224), __fsub_rn(b, 2.f)));
  for (int r = 0; r < kMaxRounds; ++r) {
    const uint4 w = draw_block(seed, e, r);
    const float u = __fsub_rn(unit23(w.x), 0.5f);
    const float v = unit23(w.y);
    const float us = __fsub_rn(0.5f, fabsf(u));
    const float k = floorf(__fadd_rn(
        __fadd_rn(__fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(2.f, a), us), b), u),
                  lam),
        LDA_F32(0.43)));
    if (us >= LDA_F32(0.07) && v <= v_r) return k;
    if (k < 0.f || (us < LDA_F32(0.013) && v > us)) continue;
    const float s = logf(__fdiv_rn(
        __fmul_rn(v, inv_alpha),
        __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
    const float t = __fsub_rn(__fadd_rn(-lam, __fmul_rn(k, log_lam)),
                              lgammaf(__fadd_rn(k, 1.f)));
    if (s <= t) return k;
  }
  return lam;                          // not reached
}

// Binomial(n, q) by geometric gaps, q < 1/2 and n q <= 10: the number of
// gaps ceil(log u / log(1 - q)) whose running sum stays at most n
__device__ float binomial_inversion(unsigned long long seed,
                                    unsigned long long e, float n, float q) {
  const float log1mq = log1pf(-q);
  float sum = 0.f;
  int num = 0;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  for (int i = 0; i < 4 * kMaxRounds; ++i) {
    if ((i & 3) == 0) w = draw_block(seed, e, i >> 2);
    const unsigned word =
        (i & 3) == 0 ? w.x : (i & 3) == 1 ? w.y : (i & 3) == 2 ? w.z : w.w;
    sum = __fadd_rn(sum, ceilf(__fdiv_rn(logf(unit23(word)), log1mq)));
    if (sum > n) break;
    ++num;
  }
  return static_cast<float>(num);
}

// Binomial(n, q) by BTRS, q < 1/2 and n q > 10
__device__ float binomial_btrs(unsigned long long seed, unsigned long long e,
                               float n, float q) {
  const float stddev = sqrtf(__fmul_rn(__fmul_rn(n, q), __fsub_rn(1.f, q)));
  const float b = __fadd_rn(LDA_F32(1.15), __fmul_rn(LDA_F32(2.53), stddev));
  const float a =
      __fadd_rn(__fadd_rn(-LDA_F32(0.0873), __fmul_rn(LDA_F32(0.0248), b)),
                __fmul_rn(LDA_F32(0.01), q));
  const float c = __fadd_rn(__fmul_rn(n, q), 0.5f);
  const float v_r = __fsub_rn(LDA_F32(0.92), __fdiv_rn(LDA_F32(4.2), b));
  const float r = __fdiv_rn(q, __fsub_rn(1.f, q));
  const float alpha = __fmul_rn(
      __fadd_rn(LDA_F32(2.83), __fdiv_rn(LDA_F32(5.1), b)), stddev);
  const float m = floorf(__fmul_rn(__fadd_rn(n, 1.f), q));
  const float nm1 = __fadd_rn(__fsub_rn(n, m), 1.f);   // n - m + 1
  const float head =
      __fmul_rn(__fadd_rn(m, 0.5f),
                logf(__fdiv_rn(__fadd_rn(m, 1.f), __fmul_rn(r, nm1))));
  for (int i = 0; i < kMaxRounds; ++i) {
    const uint4 w = draw_block(seed, e, i);
    const float u = __fsub_rn(unit23(w.x), 0.5f);
    const float v = unit23(w.y);
    const float us = __fsub_rn(0.5f, fabsf(u));
    const float k = floorf(__fadd_rn(
        __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(2.f, a), us), b), u), c));
    if (us >= LDA_F32(0.07) && v <= v_r) return k;
    if (k < 0.f || k > n) continue;
    const float vv = logf(__fdiv_rn(
        __fmul_rn(v, alpha), __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
    const float nk1 = __fadd_rn(__fsub_rn(n, k), 1.f);   // n - k + 1
    float ub = __fadd_rn(
        head, __fmul_rn(__fadd_rn(n, 1.f), logf(__fdiv_rn(nm1, nk1))));
    ub = __fadd_rn(ub, __fmul_rn(__fadd_rn(k, 0.5f),
                                 logf(__fdiv_rn(__fmul_rn(r, nk1),
                                                __fadd_rn(k, 1.f)))));
    ub = __fadd_rn(ub, stirling_tail(m));
    ub = __fadd_rn(ub, stirling_tail(__fsub_rn(n, m)));
    ub = __fsub_rn(ub, stirling_tail(k));
    ub = __fsub_rn(ub, stirling_tail(__fsub_rn(n, k)));
    if (vv <= ub) return k;
  }
  return m;                            // not reached
}

// Binomial(n, p), f32 holding an integer (n is floored first)
__device__ float binomial_draw(unsigned long long seed, unsigned long long e,
                               float n, float p) {
  if (!(n >= 0.f) || !(p >= 0.f) || !(p <= 1.f))
    return __int_as_float(0x7fc00000);                  // NaN
  n = floorf(n);
  if (n == 0.f || p == 0.f) return 0.f;
  if (p == 1.f || isinf(n)) return n;
  const bool flip = !(p < 0.5f);
  const float q = flip ? __fsub_rn(1.f, p) : p;
  const float k = __fmul_rn(n, q) <= 10.f ? binomial_inversion(seed, e, n, q)
                                          : binomial_btrs(seed, e, n, q);
  return flip ? __fsub_rn(n, k) : k;
}

}  // namespace
