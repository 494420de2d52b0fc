"""Poisson draws and Polya-Urn phi rows: the CUDA kernels and their plain
versions.

Counterpart of the XLA program that the JAX package's
`ldagroupedgibbssampler_tpu/ops/random.py` fuses from `polya_urn_dirichlet`
(c ~ Poisson(beta + n) over [K, V], each row normalised by its total, 1/V
where that is 0) and of its `poisson`. The kernels are `csrc/polya_urn.cu`
(its header gives what bounds them on the H100 and the design) with the
Poisson sampler of `csrc/discrete.cuh`: inversion below lam = 10 (the cdf
searched in f64 from one uniform), Hoermann's PTRS from 10 up, as
`jax.random.poisson` splits them. `poisson` draws elementwise in one
launch; `polya_urn` draws, sums and normalises rows in two (a block a
2,048-value chunk of a row, then the divide), zeroing the rows of inactive
topics (the HDP family's `active`) in the same pass.

The random words: element e (its flat index) takes its round-r Philox
block at counter (e << 24) | r under `seed`, an int64 [1] tensor on the
device (drawn by the caller from its torch.Generator, so a captured CUDA
graph replays new draws). `poisson_reference` and `polya_urn_reference`
draw the same words and repeat the kernels' arithmetic op for op, so the
kernels are held to them count for count. They run the wrappers for CPU
tensors; the port's draws on the CPU (`ops/random.py`) keep their
generator path and never call them.

On a CUDA tensor each wrapper launches its kernel or raises; nothing here
syncs with the host.
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.cuda_gamma import _unit23
from ldagroupedgibbssampler_tpu_torch.ops.philox import element_words

CHUNK = 2048                 # values of a row a block of polya_urn draws
INVERSION_BELOW = 10.0       # Poisson: inversion below, PTRS from here
MAX_INVERSION = 256          # csrc/discrete.cuh's kMaxInversion


def _f32(c: float, like: torch.Tensor) -> torch.Tensor:
    """The constant c (a Python float rounded once to f32) in like's
    shape, for c / tensor: the kernels divide, where PyTorch's scalar
    c / t takes t's reciprocal and multiplies."""
    return torch.full_like(like, c)


def _ptrs(lam, seed, element):
    """Hoermann's PTRS (jax.random.poisson's `_poisson_rejection`), lam >=
    10: round r takes words x and y of the block (element, r)."""
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + _f32(1.1328, b) / (b - 3.4)
    v_r = 0.9277 - _f32(3.6224, b) / (b - 2.0)
    out = torch.full_like(lam, -1.0)
    pending = torch.ones(lam.shape, dtype=torch.bool, device=lam.device)
    r = 0
    while bool(pending.any()):
        idx = pending.nonzero().reshape(-1)
        key = seed if seed.numel() == 1 else seed[idx]
        w = element_words(key, element[idx], r)
        u = _unit23(w[0]) - 0.5
        v = _unit23(w[1])
        us = 0.5 - torch.abs(u)
        ai, bi, li = a[idx], b[idx], lam[idx]
        k = torch.floor((2 * ai / us + bi) * u + li + 0.43)
        s = torch.log(v * inv_alpha[idx] / (ai / (us * us) + bi))
        t = -li + k * log_lam[idx] - torch.lgamma(k + 1)
        accept1 = (us >= 0.07) & (v <= v_r[idx])
        reject = (k < 0) | ((us < 0.013) & (v > us))
        ok = accept1 | (~reject & (s <= t))
        out[idx[ok]] = k[ok]
        pending[idx[ok]] = False
        r += 1
    return out


def poisson_reference(lam, seed, element=None) -> torch.Tensor:
    """Plain PyTorch version of the Poisson kernel on lam's device:
    Poisson(lam) as f32 of lam's shape from the kernel's Philox words.
    `element`: each value's element index (default its flat index);
    `seed`: one int64 key, or keys of lam's shape. NaN for a NaN or
    negative lam, lam itself at 0 and inf."""
    lam = torch.as_tensor(lam).to(torch.float32)
    flat = lam.reshape(-1)
    dev = flat.device
    seed = seed.to(dev).reshape(-1)
    if element is None:
        element = torch.arange(flat.numel(), dtype=torch.int64, device=dev)
    element = element.to(dev).reshape(-1)
    out = torch.where(flat >= 0, flat, torch.nan)       # 0, inf, NaN kept
    key_of = (lambda m: seed) if seed.numel() == 1 else (lambda m: seed[m])
    inv = (flat > 0) & (flat < INVERSION_BELOW)
    if bool(inv.any()):
        m = inv.nonzero().reshape(-1)
        u = _unit23(element_words(key_of(m), element[m], 0)[0]).double()
        lam64 = flat[m].double()
        p = torch.exp(-lam64)
        s = p.clone()
        k = torch.zeros_like(p)
        for _ in range(MAX_INVERSION):
            act = u > s
            if not bool(act.any()):
                break
            k = torch.where(act, k + 1.0, k)
            p = torch.where(act, p * lam64 / k, p)
            s = torch.where(act, s + p, s)
        out[m] = k.to(torch.float32)
    rej = (flat >= INVERSION_BELOW) & torch.isfinite(flat)
    if bool(rej.any()):
        m = rej.nonzero().reshape(-1)
        out[m] = _ptrs(flat[m], key_of(m), element[m])
    return out.reshape(lam.shape)


def polya_urn_reference(counts, beta: float, seed, active=None,
                        zero_mask: bool = False):
    """Plain PyTorch version of the Polya-Urn kernel: c = Poisson(f32(count)
    + beta) at each value's flat index, rows normalised by their total
    (summed in f64; a single f32 division), 1/L where the total is 0; rows
    whose `active` entry is False are 0 and drawn nowhere. Returns (phi,
    the mask c == 0, or None)."""
    c = poisson_reference(torch.as_tensor(counts).to(torch.float32) + beta,
                          seed)
    if active is not None:
        c = torch.where(active.to(c.device)[..., None], c, 0.0)
    total = c.double().sum(dim=-1, keepdim=True).to(torch.float32)
    phi = torch.where(total > 0, c / total.clamp_min(1.0),
                      1.0 / c.shape[-1])
    if active is not None:
        phi = torch.where(active.to(c.device)[..., None], phi, 0.0)
    return phi, (c == 0 if zero_mask else None)


def _check_seed(seed, dev):
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)


def poisson(lam: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Poisson(lam) draws, f32 of lam's shape; seed: int64 [1] on lam's
    device."""
    if lam.device.type == "cpu":
        return poisson_reference(lam, seed)
    lib = _build.library()
    dev = lam.device
    lam = lam.to(torch.float32).contiguous()
    _check_seed(seed, dev)
    out = torch.empty_like(lam)
    if lam.numel() == 0:
        return out
    err = lib.lda_poisson(lam.data_ptr(), seed.data_ptr(), out.data_ptr(),
                          lam.numel(), dev.index, _build.stream(dev))
    _build.check(err, "lda_poisson")
    poisson.launches += 1
    return out


def polya_urn(counts: torch.Tensor, beta: float, seed: torch.Tensor,
              active: torch.Tensor | None = None, zero_mask: bool = False):
    """Polya-Urn rows over the last axis of counts (int32 counts, or
    floats), beta the prior; `active` (bool, one entry a row) zeroes the
    rows of inactive topics. Returns (phi f32 of counts' shape, the bool
    mask c == 0 where `zero_mask`, else None)."""
    if counts.device.type == "cpu":
        return polya_urn_reference(counts, beta, seed, active, zero_mask)
    lib = _build.library()
    dev = counts.device
    if counts.dim() == 0:
        raise ValueError("polya_urn draws rows: counts needs an axis")
    ints = not counts.dtype.is_floating_point
    x = (counts.to(torch.int32) if ints
         else counts.to(torch.float32)).contiguous()
    _check_seed(seed, dev)
    last = x.shape[-1]
    rows = x.numel() // max(last, 1)
    if active is not None:
        active = active.to(torch.bool).contiguous()
        _build.check_tensor("active", active, x.shape[:-1], torch.bool, dev)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    zero = (torch.empty(x.shape, dtype=torch.bool, device=dev)
            if zero_mask else None)
    if x.numel() == 0:
        return out, zero
    partial = torch.empty((rows, -(-last // CHUNK)), dtype=torch.float64,
                          device=dev)
    err = lib.lda_polya_urn(
        x.data_ptr(), int(ints), float(beta),
        None if active is None else active.data_ptr(), seed.data_ptr(),
        out.data_ptr(), None if zero is None else zero.data_ptr(),
        partial.data_ptr(), rows, last, dev.index, _build.stream(dev))
    _build.check(err, "lda_polya_urn")
    polya_urn.launches += 2
    return out, zero


# launches of the kernels (added where they launch, nowhere else; the rows
# are two launches); chip_smoke.py reads them to show that the main path
# ran the kernels
poisson.launches = 0
polya_urn.launches = 0
