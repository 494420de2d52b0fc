// Device helpers shared by the port's kernels: Philox4x32-10 and bf16
// rounding. Included by each .cu; everything here is internal linkage, so
// the sources still compile and link as separate units.
//
// ops/philox.py is the same generator in PyTorch tensor arithmetic (the
// plain versions draw identical words).

#pragma once

#include <cuda_bf16.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// The 24-bit uniform of a slot: the injected value when the caller passed
// one, else the top 24 bits of the slot's Philox word.
__device__ __forceinline__ unsigned slot_u24(const int* __restrict__ u24,
                                             const long long* __restrict__ seed,
                                             long long slot) {
  return u24 != nullptr
             ? static_cast<unsigned>(u24[slot])
             : philox_word0(static_cast<unsigned long long>(seed[0]),
                            static_cast<unsigned long long>(slot)) >> 8;
}

}  // namespace
