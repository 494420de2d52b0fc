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
launch; `polya_urn` draws and normalises rows in two: a one-wave grid
draws every value, the matrix's 32-column groups dealt to its blocks in
turn (`urn_launch_shape`, `urn_deal`) so that a heavy row or a
vocabulary's head spreads over all of them, the values whose count is an
integer 0..9 drawn from a table of the inversion's cdf terms
(`inversion_table`), the others queued for the sampler, and writes the
counts with each group's sum; then a block a 2,048-value chunk of a row
divides by the row's total. The rows of inactive topics (the HDP
family's `active`) are zeroed and drawn nowhere.

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

import ctypes

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.cuda_gamma import _unit23
from ldagroupedgibbssampler_tpu_torch.ops.philox import element_words

INVERSION_BELOW = 10.0       # Poisson: inversion below, PTRS from here
MAX_INVERSION = 256          # csrc/discrete.cuh's kMaxInversion
# csrc/polya_urn.cu's rows
TABLE_RATES = 10             # table rows: the counts 0..9 (kRates)
TABLE_TERMS = 24             # cdf terms a row (kTab)
U_MAX = 1.0 - 2.0 ** -24     # the largest uniform (unit23)
URN_WARPS = 8                # warps of a block of the draw launch (kWarps)


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


def inversion_table(beta: float, device=None) -> torch.Tensor:
    """The rows' kernel's table, f64 [TABLE_RATES, TABLE_TERMS]: row c the
    inversion's cdf terms s_0, s_1, .. at lam = f32(c) + beta, as
    `poisson_reference` forms them (p = exp(-lam), then p lam / k added
    term by term), up to the first term >= U_MAX and 2.0 after it; a row
    whose rate is not in (0, 10) is all 2.0 (its counts are queued)."""
    lam = (torch.arange(TABLE_RATES, dtype=torch.float32, device=device)
           + beta).double()
    tab = torch.full((TABLE_RATES, TABLE_TERMS), 2.0, dtype=torch.float64,
                     device=device)
    for c in range(TABLE_RATES):
        lam_c = lam[c:c + 1]
        if not 0.0 < float(lam_c) < INVERSION_BELOW:
            continue
        p = torch.exp(-lam_c)
        s = p.clone()
        tab[c, 0] = s[0]
        for k in range(1, TABLE_TERMS):
            if float(s) >= U_MAX:
                break
            p = p * lam_c / k
            s = s + p
            tab[c, k] = s[0]
    return tab


def table_classes(counts, beta: float) -> torch.Tensor:
    """Each value's table row in the rows' kernel: its count where that
    is an integer c = 0..9 with f32(c) + beta in (0, 10), else -1 (the
    value is queued for the sampler)."""
    c = torch.as_tensor(counts).to(torch.float32)
    lam = c + beta
    on = ((c >= 0) & (c < TABLE_RATES) & (c == torch.floor(c))
          & (lam > 0) & (lam < INVERSION_BELOW))
    return torch.where(on, c, -1.0).to(torch.int64)


def table_search(table, classes, u) -> torch.Tensor:
    """The kernel's search: the number of terms of row `classes` below
    the uniform u (f64), TABLE_TERMS past the row, -1 where the class is
    -1."""
    rows = table[classes.clamp_min(0)]
    m = (rows < u[..., None]).to(torch.int64).cumprod(-1).sum(-1)
    return torch.where(classes >= 0, m, -1)


def urn_launch_shape(rows: int, num_cols: int, sms: int,
                     blocks_an_sm: int) -> int:
    """The draw launch's blocks for `rows` rows of num_cols values, as
    `lda_polya_urn_geometry` sizes them: one wave (`sms` times the blocks
    an SM holds at the chosen chunk's shared memory), or fewer where the
    rows have fewer 32-column groups than the wave has warps."""
    groups = rows * -(-num_cols // 32)
    return max(1, min(-(-groups // URN_WARPS), sms * blocks_an_sm))


def urn_deal(rows: int, num_cols: int, blocks: int) -> torch.Tensor:
    """Where the draw launch draws each 32-column group g of the rows (row
    g // G, columns 32 (g % G) .., G = ceil(num_cols / 32)): int64 [groups,
    3] of (block g % blocks, warp (g // blocks) % URN_WARPS, round g //
    (blocks URN_WARPS))."""
    g = torch.arange(rows * -(-num_cols // 32), dtype=torch.int64)
    return torch.stack([g % blocks, (g // blocks) % URN_WARPS,
                        g // (blocks * URN_WARPS)], dim=1)


def _check_seed(seed, dev):
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)


def urn_occupancy(rows: int, num_cols: int, device) -> dict:
    """The draw launch's geometry on `device` as `lda_polya_urn` launches
    it: its blocks, rounds a chunk (a warp's groups drawn together) and
    threads, the blocks an SM holds at that chunk's shared memory (the
    CUDA occupancy calculator) and the SMs."""
    out = (ctypes.c_int * 4)()
    err = _build.library().lda_polya_urn_geometry(
        rows, num_cols, torch.device(device).index or 0,
        ctypes.addressof(out))
    _build.check(err, "lda_polya_urn_geometry")
    return {"blocks": out[0], "rounds": out[1], "threads": 32 * URN_WARPS,
            "blocks_an_sm": out[2], "sms": out[3]}


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
    rows of inactive topics. Two launches (`urn_launch_shape`). Returns
    (phi f32 of counts' shape, the bool mask c == 0 where `zero_mask`,
    else None)."""
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
    gsum = torch.empty(rows * -(-last // 32), dtype=torch.float64,
                       device=dev)
    err = lib.lda_polya_urn(
        x.data_ptr(), int(ints), float(beta),
        None if active is None else active.data_ptr(), seed.data_ptr(),
        out.data_ptr(), None if zero is None else zero.data_ptr(),
        gsum.data_ptr(), rows, last, dev.index, _build.stream(dev))
    _build.check(err, "lda_polya_urn")
    polya_urn.launches += 2
    return out, zero


# launches of the kernels (added where they launch, nowhere else; the rows
# are two launches); chip_smoke.py reads them to show that the main path
# ran the kernels
poisson.launches = 0
polya_urn.launches = 0
