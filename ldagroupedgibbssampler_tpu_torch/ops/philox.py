"""Philox4x32-10 in PyTorch tensor arithmetic: the plain versions' copy of
the counter-based generator the CUDA kernels draw their uniforms from
(`csrc/philox.cuh`).

A kernel draws its 24-bit uniforms per token slot from the Philox block at
counter = global slot index, key = a 64-bit seed: the top 24 bits of the
first word (`philox_u24`: the z-draw and PCGS kernels), or of all four
(`philox_u24x4`: the LightLDA MH kernel, four uniforms per token). So the
draws do not depend on the launch configuration, and these functions
reproduce them word for word on any device.

The discrete samplers (csrc/discrete.cuh: Poisson, Binomial) take the
Philox block of element e and round r at counter (e << 24) | r
(`element_words`), so a draw depends on its element and round alone.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for uint32 values held in int64:
    the 64-bit product is split through 16-bit halves of m so nothing
    overflows int64."""
    lo = (x * m) & _MASK32              # int64 wraps mod 2^64: low bits hold
    hi = (x * (m >> 16) + ((x * (m & 0xFFFF)) >> 16)) >> 16
    return hi & _MASK32, lo


def philox4x32_10(counter_lo: torch.Tensor, counter_hi: torch.Tensor,
                  key_lo: torch.Tensor, key_hi: torch.Tensor):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    words; counter (counter_lo, counter_hi, 0, 0), key (key_lo, key_hi).
    Returns the four output words. Matches `philox_word0` in
    csrc/philox.cuh for the first word."""
    c0, c1 = counter_lo & _MASK32, counter_hi & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = key_lo & _MASK32, key_hi & _MASK32
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _slot_words(seed: torch.Tensor, num: int):
    s = seed.reshape(1).to(torch.int64)
    slot = torch.arange(num, dtype=torch.int64, device=seed.device)
    return philox4x32_10(slot, slot >> 32, s & _MASK32, (s >> 32) & _MASK32)


def philox_u24(seed: torch.Tensor, num: int) -> torch.Tensor:
    """The kernels' in-kernel uniforms: top 24 bits of the first Philox
    word at counter = slot index, key = the 64-bit seed. int32 [num]."""
    return (_slot_words(seed, num)[0] >> 8).to(torch.int32)


def philox_u24x4(seed: torch.Tensor, num: int) -> torch.Tensor:
    """Four uniforms per slot: the top 24 bits of each of the four Philox
    words at counter = slot index. int32 [num, 4]; column 0 is
    `philox_u24`."""
    return (torch.stack(_slot_words(seed, num), dim=1) >> 8).to(torch.int32)


ROUND_BITS = 24     # csrc/discrete.cuh's kRoundBits


def element_words(seed: torch.Tensor, element: torch.Tensor, round_):
    """The four words of element `element`'s round-`round_` Philox block
    in the discrete samplers of csrc/discrete.cuh: counter (element <<
    24) | round_, key `seed` (int64: one key, or one broadcast against
    `element`). int64 tensors holding uint32 words."""
    ctr = (element.to(torch.int64) << ROUND_BITS) | round_
    s = seed.to(torch.int64)
    s = s.reshape(1) if s.numel() == 1 else s
    return philox4x32_10(ctr, ctr >> 32, s & _MASK32, (s >> 32) & _MASK32)
