"""The HDP step after the sweep (table counts; births, active mask and
psi) and elementwise Binomial draws: the CUDA kernels and their plain
versions.

Counterpart of the XLA programs that the JAX package's
`ldagroupedgibbssampler_tpu/models/hdp.py::_step` runs after the z-sweep:
`doc_count_ge_histogram` with `sample_table_counts`, then
`sample_birth_candidates` / `_update_active`, `gem_psi` or `poisson_psi`
and alpha = alpha0 psi active. The kernels are `csrc/hdp.cu` (its header
gives what bounds them on the H100 and the design), with the Binomial and
Poisson samplers of `csrc/discrete.cuh` and the Gamma draw of
`csrc/marsaglia.cuh`:

  - `table_counts`: l_k = sum_j Binomial(#docs with n_dk >= j,
    a_k / (a_k + j - 1)), two launches (a [K, M] histogram of n_dk, then a
    block a topic: the reverse scan, the p's, the draws, the sum; the
    second a programmatic dependent launch, scheduled while the first
    runs);
  - `psi_step`: births, the active mask, psi (GEM or Poisson) and alpha,
    one launch of a cluster of up to 8 blocks sized to K
    (`psi_launch_shape`); after `table_counts` (`dependent=True`) a
    programmatic dependent launch of its second, whose births run while
    the table counts do;
  - `binomial`: Binomial(n, p) elementwise, one launch.

The random words: Binomial draw j of topic k is element k M + j - 1, so
the table counts' draws are `binomial_reference` of ge and p over [K, M];
in `psi_step` n_add is element 1, the birth candidates 2 + c, the Poisson
psi's eta_k 2 + budget + k (counter (e << 24) | round), and the GEM
sticks' Gamma draws flat elements k and K + k at gamma.cu's counters
8 i + r. `seed` is an int64 [1] tensor on the device, drawn by the caller
from its generator (`ops/random.py::kernel_seed`). The plain versions draw
the same words and repeat the kernels' arithmetic op for op (psi's scans
and sums in f64 on both sides); they run the wrappers for CPU tensors. The
HDP model on the CPU keeps its generator path (`models/hdp.py`) and never
calls them.

On a CUDA tensor each wrapper launches its kernel or raises; nothing here
syncs with the host (n_add stays on the device).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_gamma
from ldagroupedgibbssampler_tpu_torch.ops.cuda_gamma import _unit23
from ldagroupedgibbssampler_tpu_torch.ops.cuda_polya_urn import (
    _f32, poisson_reference)
from ldagroupedgibbssampler_tpu_torch.ops.philox import element_words

INVERSION_MAX_MEAN = 10.0    # Binomial: inversion where n min(p, 1-p) <= 10
BIRTHS = {"none": 0, "candidates": 1, "lowest": 2}
SAMPLERS = ("gem", "poisson")
DISTS = ("geometric", "uniform")
_EPS = 1e-30
_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092,
                  0.0276779256849983, 0.02079067210376509,
                  0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287)


# ---------------------------------------------------------------------------
# Binomial
# ---------------------------------------------------------------------------

def _stirling_tail(k):
    """log k! - [(k + 1/2) log(k + 1) - (k + 1) + log(2 pi) / 2]: the
    table up to 9, the series of k above (TensorFlow's; JAX evaluates the
    series at k = 9 there)."""
    table = torch.tensor(_STIRLING_TAIL, dtype=torch.float32,
                         device=k.device)
    kp1 = k + 1.0
    kp1sq = kp1 * kp1
    approx = (1.0 / 12 - (1.0 / 360 - _f32(1.0 / 1260, kp1sq) / kp1sq)
              / kp1sq) / kp1
    small = table[k.clamp(0.0, 9.0).to(torch.int64)]
    return torch.where(k <= 9.0, small, approx)


def _inversion(seed, element, n, q):
    """Binomial(n, q) by geometric gaps (jax.random.binomial's
    `_binomial_inversion`): gap i takes word i % 4 of block (element,
    i // 4); the count of gaps whose running sum stays at most n."""
    log1mq = torch.log1p(-q)
    total = torch.zeros_like(n)
    num = torch.zeros_like(n)
    pending = torch.ones(n.shape, dtype=torch.bool, device=n.device)
    i = 0
    while bool(pending.any()):
        idx = pending.nonzero().reshape(-1)
        key = seed if seed.numel() == 1 else seed[idx]
        word = element_words(key, element[idx], i >> 2)[i & 3]
        s = total[idx] + torch.ceil(torch.log(_unit23(word)) / log1mq[idx])
        total[idx] = s
        still = ~(s > n[idx])
        num[idx] += still.to(num.dtype)
        pending[idx] = still
        i += 1
    return num


def _btrs(seed, element, n, q):
    """Binomial(n, q) by BTRS (jax.random.binomial's `_btrs`, with the
    Stirling tail above): round r takes words x and y of block (element,
    r)."""
    stddev = torch.sqrt(n * q * (1.0 - q))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * q
    c = n * q + 0.5
    v_r = 0.92 - _f32(4.2, b) / b
    r = q / (1.0 - q)
    alpha = (2.83 + _f32(5.1, b) / b) * stddev
    m = torch.floor((n + 1.0) * q)
    nm1 = n - m + 1.0
    head = (m + 0.5) * torch.log((m + 1.0) / (r * nm1))
    tails = _stirling_tail(m), _stirling_tail(n - m)
    out = torch.full_like(n, -1.0)
    pending = torch.ones(n.shape, dtype=torch.bool, device=n.device)
    rnd = 0
    while bool(pending.any()):
        idx = pending.nonzero().reshape(-1)
        key = seed if seed.numel() == 1 else seed[idx]
        w = element_words(key, element[idx], rnd)
        u = _unit23(w[0]) - 0.5
        v = _unit23(w[1])
        us = 0.5 - torch.abs(u)
        ai, bi, ni = a[idx], b[idx], n[idx]
        k = torch.floor((2 * ai / us + bi) * u + c[idx])
        accept1 = (us >= 0.07) & (v <= v_r[idx])
        reject = (k < 0) | (k > ni)
        vv = torch.log(v * alpha[idx] / (ai / (us * us) + bi))
        nk1 = ni - k + 1.0
        ub = head[idx] + (ni + 1.0) * torch.log(nm1[idx] / nk1)
        ub = ub + (k + 0.5) * torch.log(r[idx] * nk1 / (k + 1.0))
        ub = ub + tails[0][idx]
        ub = ub + tails[1][idx]
        ub = ub - _stirling_tail(k)
        ub = ub - _stirling_tail(ni - k)
        ok = accept1 | (~reject & (vv <= ub))
        out[idx[ok]] = k[ok]
        pending[idx[ok]] = False
        rnd += 1
    return out


def binomial_reference(n, p, seed, element=None) -> torch.Tensor:
    """Plain PyTorch version of the Binomial kernel on n's device:
    Binomial(n, p) as f32 of the broadcast shape from the kernel's Philox
    words (`element`: each value's element index, default its flat index;
    `seed`: one int64 key, or keys of that shape). n is floored; n = 0, p
    = 0 and p = 1 are exact; p >= 1/2 is drawn as n - Binomial(n, 1 - p);
    NaN for a NaN or negative n or a p outside [0, 1]."""
    n = torch.as_tensor(n).to(torch.float32)
    p = torch.as_tensor(p).to(torch.float32).to(n.device)
    n, p = torch.broadcast_tensors(n, p)
    shape, dev = n.shape, n.device
    n, p = n.reshape(-1), p.reshape(-1)
    seed = seed.to(dev).reshape(-1)
    if element is None:
        element = torch.arange(n.numel(), dtype=torch.int64, device=dev)
    element = element.to(dev).reshape(-1)
    valid = (n >= 0) & (p >= 0) & (p <= 1)
    nf = torch.floor(n)
    out = torch.full_like(n, torch.nan)
    zero = valid & ((nf == 0) | (p == 0))
    whole = valid & ~zero & ((p == 1) | torch.isinf(nf))
    out[zero] = 0.0
    out[whole] = nf[whole]
    rest = valid & ~zero & ~whole
    flip = ~(p < 0.5)
    q = torch.where(flip, 1.0 - p, p)
    k = torch.zeros_like(n)
    key_of = (lambda m: seed) if seed.numel() == 1 else (lambda m: seed[m])
    for pick, draw in (((nf * q <= INVERSION_MAX_MEAN), _inversion),
                       (~(nf * q <= INVERSION_MAX_MEAN), _btrs)):
        m = (rest & pick).nonzero().reshape(-1)
        if m.numel():
            k[m] = draw(key_of(m), element[m], nf[m], q[m])
    drawn = torch.where(flip, nf - k, k)
    out[rest] = drawn[rest]
    return out.reshape(shape)


def _check_seed(seed, dev):
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)


def binomial(n: torch.Tensor, p: torch.Tensor,
             seed: torch.Tensor) -> torch.Tensor:
    """Binomial(n, p) draws, f32 of the broadcast shape; seed: int64 [1]
    on n's device."""
    if n.device.type == "cpu":
        return binomial_reference(n, p, seed)
    lib = _build.library()
    dev = n.device
    n, p = torch.broadcast_tensors(n.to(torch.float32),
                                   p.to(device=dev, dtype=torch.float32))
    n, p = n.contiguous(), p.contiguous()
    _check_seed(seed, dev)
    out = torch.empty_like(n)
    if n.numel() == 0:
        return out
    err = lib.lda_binomial(n.data_ptr(), p.data_ptr(), seed.data_ptr(),
                           out.data_ptr(), n.numel(), dev.index,
                           _build.stream(dev))
    _build.check(err, "lda_binomial")
    binomial.launches += 1
    return out


# ---------------------------------------------------------------------------
# table counts
# ---------------------------------------------------------------------------

def ge_reference(ndk, max_count: int) -> torch.Tensor:
    """ge[k, j - 1] = #docs with n_dk >= j for j = 1..max_count, int32
    [K, M]: the reverse cumulative sum of a per-topic histogram of the n_dk
    values (DocTopicTokenFreqTable.java:130-150), as the table-count
    kernels' first launch and scan compute it
    (models/hdp.py::doc_count_ge_histogram)."""
    ndk = torch.as_tensor(ndk)
    _d, k = ndk.shape
    clipped = ndk.clamp(0, max_count).to(torch.int64)
    flat = (torch.arange(k, device=ndk.device)[None, :] * (max_count + 1)
            + clipped).reshape(-1)
    hist = torch.bincount(flat, minlength=k * (max_count + 1))
    ge_all = hist.reshape(k, max_count + 1).flip(1).cumsum(dim=1).flip(1)
    return ge_all[:, 1:].to(torch.int32)


def table_probs(a, max_count: int, device) -> torch.Tensor:
    """p[k, j - 1] = a_k / (a_k + j - 1), 1 where that denominator is not
    positive, clipped to [0, 1] (models/hdp.py::sample_table_counts'). a:
    f32 [K]."""
    j = torch.arange(1, max_count + 1, dtype=torch.float32, device=device)
    a = a.to(device=device, dtype=torch.float32)
    denom = a[:, None] + j[None, :] - 1.0
    p = torch.where(denom > 0, a[:, None] / denom.clamp_min(_EPS), 1.0)
    return p.clamp(0.0, 1.0)


def _concentration(a, k: int, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor) and a.dim() == 1:
        return a.to(device=device, dtype=torch.float32)
    return torch.full((k,), float(a), dtype=torch.float32, device=device)


def table_counts_reference(ndk, a, max_count: int, seed,
                           return_ge: bool = False):
    """Plain PyTorch version of the table-count kernels: l_k = sum_j
    Binomial(ge[k, j - 1], p[k, j - 1]) as f32 [K], drawn at elements
    k M + j - 1. `a`: f32 [K] or one float for every topic. With
    `return_ge`, also ge."""
    ndk = torch.as_tensor(ndk)
    ge = ge_reference(ndk, max_count)
    p = table_probs(_concentration(a, ndk.shape[1], ndk.device), max_count,
                    ndk.device)
    tables = binomial_reference(ge.to(torch.float32), p, seed).sum(dim=1)
    return (tables, ge) if return_ge else tables


def hist_instance(num_topics: int, max_count: int, device) -> str:
    """The first launch's instance at (K, M): "shared" where the [K, M]
    histogram fits the opt-in shared memory, else "global"."""
    return ("shared" if _build.library().lda_hdp_hist_shared(
        num_topics, max_count, device.index) else "global")


def hist_blocks_per_sm(num_topics: int, max_count: int, instance: str,
                       device) -> int:
    """The table counts' first launch's blocks an SM of `device` in the
    instance at (K, M), from the CUDA occupancy calculator."""
    dev = torch.device(device)
    out = (ctypes.c_int * 1)()
    err = _build.library().lda_hdp_hist_blocks_per_sm(
        num_topics, max_count, int(instance == "shared"), dev.index or 0,
        ctypes.addressof(out))
    _build.check(err, "lda_hdp_hist_blocks_per_sm")
    return out[0]


def table_counts(ndk: torch.Tensor, a, max_count: int, seed: torch.Tensor,
                 ge: torch.Tensor | None = None,
                 instance: str | None = None,
                 hist: torch.Tensor | None = None) -> torch.Tensor:
    """Antoniak table counts l_k, f32 [K]. ndk: int32 [D, K]; a: f32 [K]
    (alpha0 psi) or one float (hlda's gamma); max_count: M, the j range;
    seed: int64 [1]. `ge`: optional int32 [K, M] that receives
    #docs with n_dk >= j (checks only). `instance`: "shared" or "global"
    for the first launch (default: `hist_instance`). `hist`: the
    histogram's scratch, int32 [K, M] of zeros; the second launch zeroes
    what it reads, so a caller that keeps one and passes it each call
    saves its fill (without one, a zeroed one is allocated)."""
    if ndk.device.type == "cpu":
        tables, g = table_counts_reference(ndk, a, max_count, seed, True)
        if ge is not None:
            ge.copy_(g)
        return tables
    lib = _build.library()
    dev = ndk.device
    d, k = ndk.shape
    ndk = ndk.to(torch.int32).contiguous()
    _check_seed(seed, dev)
    if max_count < 1:
        raise ValueError(f"max_count must be at least 1, got {max_count}")
    a_vec, a_scalar = None, 0.0
    if isinstance(a, torch.Tensor):
        a_vec = a.to(torch.float32).contiguous()
        _build.check_tensor("a", a_vec, (k,), torch.float32, dev)
    else:
        a_scalar = float(a)
    if ge is not None:
        _build.check_tensor("ge", ge, (k, max_count), torch.int32, dev)
    instance = instance or hist_instance(k, max_count, dev)
    if instance not in ("shared", "global"):
        raise ValueError(f"unknown instance {instance!r}")
    if hist is None:
        hist = torch.zeros((k, max_count), dtype=torch.int32, device=dev)
    _build.check_tensor("hist", hist, (k, max_count), torch.int32, dev)
    tables = torch.empty(k, dtype=torch.float32, device=dev)
    err = lib.lda_hdp_table_counts(
        ndk.data_ptr(), None if a_vec is None else a_vec.data_ptr(),
        a_scalar, seed.data_ptr(), hist.data_ptr(), tables.data_ptr(),
        None if ge is None else ge.data_ptr(), d, k, max_count,
        int(instance == "shared"), dev.index, _build.stream(dev))
    _build.check(err, "lda_hdp_table_counts")
    table_counts.launches += 2
    return tables


# ---------------------------------------------------------------------------
# births, active mask, psi, alpha
# ---------------------------------------------------------------------------

def _log1m_p(gamma: float) -> float:
    """f32 log(1 - p) of the geometric index prior, p = 1 / (1 + gamma)."""
    return float(torch.tensor(math.log1p(-1.0 / (1.0 + gamma)),
                              dtype=torch.float32))


def _check_options(births, sampler, dist):
    if births not in BIRTHS:
        raise ValueError(f"unknown birth rule {births!r}")
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown psi sampler {sampler!r}")
    if dist not in DISTS:
        raise ValueError(f"unknown hdp_gamma_dist {dist!r}")


def psi_reference(tables, nk, active, seed, *, gamma: float, budget: int,
                  births: str, sampler: str, dist: str = "geometric",
                  alpha0: float = 1.0):
    """Plain PyTorch version of the psi kernel. tables f32 [..., K]; nk
    int [..., K] (None where births is "none"); active bool [..., K];
    seed: one int64 key, or one a row of [...]. Returns (psi, active,
    alpha, births int32), each [..., K]."""
    _check_options(births, sampler, dist)
    tables = torch.as_tensor(tables).to(torch.float32)
    dev = tables.device
    k_max = tables.shape[-1]
    rows = tables.shape[:-1]
    key = seed.to(dev).reshape(-1)
    key = key.reshape(*rows, 1) if key.numel() > 1 else key
    one = torch.ones(rows + (1,), dtype=torch.int64, device=dev)
    active = torch.as_tensor(active).to(dev).to(torch.bool).expand(
        tables.shape)
    born = torch.zeros(tables.shape, dtype=torch.int32, device=dev)
    if births == "none":
        active_out = active.clone()
    else:
        n_add = poisson_reference(torch.full(rows + (1,), gamma,
                                             device=dev),
                                  key.expand(rows + (1,)), one)[..., 0]
        take = n_add.clamp_max(budget)
        in_data = active & (torch.as_tensor(nk).to(dev) > 0)
        if births == "candidates":
            c = torch.arange(budget, device=dev)
            word = element_words(key, (2 + c).expand(rows + (budget,)),
                                 0)[0]
            if dist == "geometric":
                u = _unit23(word).clamp_min(1e-12)
                x = torch.floor(torch.log(u) / _log1m_p(gamma))
                cand = x.clamp(0.0, k_max - 1).to(torch.int64)
            else:
                cand = (word * k_max) >> 32
            valid = (c < take[..., None]).to(torch.int32)
            born = born.scatter_add(-1, cand, valid)
            active_out = in_data | (born > 0)
        else:
            free = ~in_data
            rank = torch.cumsum(free.to(torch.int64), dim=-1) - free.to(
                torch.int64)
            new = free & (rank < take[..., None])
            born = new.to(torch.int32)
            active_out = in_data | new
    if sampler == "gem":
        t64 = tables.double()
        rest = (t64.flip(-1).cumsum(-1).flip(-1) - t64).to(torch.float32)
        a1 = 1.0 + tables
        a2 = gamma + rest.clamp_min(0.0) + _EPS
        counters = torch.arange(2 * k_max, dtype=torch.int64, device=dev)
        g = _gamma_at(torch.cat([a1, a2], dim=-1), key,
                      counters * cuda_gamma.BLOCKS_PER_ELEMENT)
        g1, g2 = g[..., :k_max], g[..., k_max:]
        nu = (g1 / (g1 + g2).clamp_min(cuda_gamma.DIRICHLET_FLOOR)).clamp(
            1e-7, 1.0 - 1e-7)
        log1m = torch.log1p(-nu).double()
        ex = (torch.cumsum(log1m, dim=-1) - log1m).to(torch.float32)
        raw = torch.exp(torch.log(nu) + ex)
        total = raw.double().sum(dim=-1, keepdim=True)
        psi = (raw.double() / total).to(torch.float32)
    else:
        element = 2 + budget + torch.arange(k_max, device=dev)
        eta = poisson_reference(tables, key.expand(tables.shape),
                                element.expand(tables.shape))
        eta = eta + born.to(torch.float32)
        total = eta.double().sum(dim=-1, keepdim=True).to(torch.float32)
        psi = torch.where(total > 0, eta / total.clamp_min(1.0),
                          1.0 / k_max)
    alpha = alpha0 * psi * active_out.to(torch.float32)
    return psi, active_out, alpha, born


def _gamma_at(a, key, base):
    """gamma_reference's draw of shapes `a` at the counters `base` (8 i)
    under `key` (one, or one a row)."""
    d, c = cuda_gamma.mt_setup(a)
    out = d.clone()
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for r in range(cuda_gamma.ROUNDS):
        ok, g = cuda_gamma.mt_round(d, c, key, base + r)
        out = torch.where(ok & ~done, g, out)
        done |= ok
    return cuda_gamma.mt_boost(a, out, key, base)


# csrc/hdp.cu's psi launch: a cluster of up to PSI_MAX_BLOCKS blocks of
# PSI_SLICE topics or more, PSI_MIN_THREADS to PSI_MAX_THREADS threads a
# block (a power of two), two a topic where they reach
PSI_MIN_THREADS, PSI_MAX_THREADS = 128, 1024
PSI_SLICE = 512
PSI_MAX_BLOCKS = 8


def psi_launch_shape(num_topics: int) -> dict:
    """The psi kernel's launch at K = num_topics: its blocks (one cluster),
    threads a block, and each block's topics [b0, b1) in rank order."""
    k = int(num_topics)
    blocks = min(PSI_MAX_BLOCKS, -(-k // PSI_SLICE))
    per = -(-k // blocks)
    threads = PSI_MIN_THREADS
    while threads < 2 * per and threads < PSI_MAX_THREADS:
        threads *= 2
    return {"blocks": blocks, "threads": threads,
            "slices": [(min(k, b * per), min(k, b * per + per))
                       for b in range(blocks)]}


def psi_step(tables: torch.Tensor, nk: torch.Tensor | None,
             active: torch.Tensor, seed: torch.Tensor, *, gamma: float,
             budget: int, births: str, sampler: str,
             dist: str = "geometric", alpha0: float = 1.0,
             dependent: bool = False):
    """Births, the active mask, psi and alpha = alpha0 psi active from the
    table counts, in one launch. tables: f32 [K]; nk: int32 [K] (may be
    None where births is "none"); active: bool [K]; seed: int64 [1].
    births: "none" (all topics), "candidates" (hdplda: n_add ~
    Poisson(gamma) indices from the `dist` prior, at most `budget`) or
    "lowest" (hlda: the n_add lowest slots not in the data); sampler:
    "gem" or "poisson". `dependent`: launched as a programmatic dependent
    of the stream's previous launch, which must be `table_counts`' second
    (the births read nk, active and seed before waiting for it). Returns
    (psi f32, active bool, alpha f32, births int32), each [K]."""
    _check_options(births, sampler, dist)
    if nk is None and births != "none":
        raise ValueError(f"births {births!r} needs the topic totals nk")
    if tables.device.type == "cpu":
        return psi_reference(tables, nk, active, seed, gamma=gamma,
                             budget=budget, births=births, sampler=sampler,
                             dist=dist, alpha0=alpha0)
    lib = _build.library()
    dev = tables.device
    tables = tables.to(torch.float32).contiguous()
    k = tables.numel()
    _build.check_tensor("tables", tables, (k,), torch.float32, dev)
    _check_seed(seed, dev)
    active = active.to(torch.bool).contiguous()
    _build.check_tensor("active", active, (k,), torch.bool, dev)
    if nk is not None:
        nk = nk.to(torch.int32).contiguous()
        _build.check_tensor("nk", nk, (k,), torch.int32, dev)
    psi = torch.empty(k, dtype=torch.float32, device=dev)
    alpha = torch.empty_like(psi)
    active_out = torch.empty_like(active)
    born = torch.empty(k, dtype=torch.int32, device=dev)
    err = lib.lda_hdp_psi(
        tables.data_ptr(), None if nk is None else nk.data_ptr(),
        active.data_ptr(), seed.data_ptr(), psi.data_ptr(),
        active_out.data_ptr(), alpha.data_ptr(), born.data_ptr(), k,
        BIRTHS[births], int(sampler == "gem"), float(gamma), int(budget),
        int(dist == "geometric"), _log1m_p(gamma), float(alpha0),
        int(dependent), dev.index, _build.stream(dev))
    _build.check(err, "lda_hdp_psi")
    psi_step.launches += 1
    return psi, active_out, alpha, born


# launches of the kernels (added where they launch, nowhere else; the
# table counts are two launches); chip_smoke.py reads them to show that
# the main path ran the kernels
binomial.launches = 0
table_counts.launches = 0
psi_step.launches = 0
