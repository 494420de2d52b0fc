"""Walker alias tables — O(1) categorical sampling.

The port's counterpart of `ldagroupedgibbssampler_tpu/ops/alias.py`, with
a `torch.Generator` in place of the JAX key; draws run on the generator's
device. Replaces `util/WalkerAliasTable.java:4-9` (interface),
`util/GentleAliasMethod.java` / `util/OptimizedGentleAliasMethod.java:9`
(Vose construction + `generateSample(u)`), and
`types/PoissonFixedCoeffSampler.java` (precomputed Poisson(λ) alias).

The samplers draw z in their kernels and need no alias table; the table is
for a distribution drawn from many times between rebuilds (fixed Poisson
coefficients, host-side tools). `build_alias_table` is NumPy;
`alias_sample` draws a batch (two gathers and a compare per draw).
"""

from __future__ import annotations

import numpy as np
import torch


def build_alias_table(probs) -> tuple[np.ndarray, np.ndarray]:
    """Vose/Walker construction. Returns (prob[n], alias[n]) such that a
    draw is: i ~ U{0..n-1}; return i if u < prob[i] else alias[i]
    (OptimizedGentleAliasMethod.java:42-92 `generateAliasTable`)."""
    p = np.asarray(probs, np.float64)
    if p.sum() <= 0:
        raise ValueError("probabilities must sum to a positive value")
    n = len(p)
    scaled = p / p.sum() * n
    prob = np.zeros(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
    for i in small:  # numerical leftovers
        prob[i] = 1.0
    return prob, alias


def alias_sample(prob, alias, generator: torch.Generator,
                 shape=()) -> torch.Tensor:
    """Vectorised draws from a built table — the `generateSample(u)` step
    (OptimizedGentleAliasMethod.java:94-107), batched on the generator's
    device."""
    dev = generator.device
    prob = torch.as_tensor(prob, dtype=torch.float32, device=dev)
    alias = torch.as_tensor(alias, dtype=torch.int64, device=dev)
    i = torch.randint(0, prob.shape[0], tuple(shape), generator=generator,
                      device=dev)
    u = torch.rand(tuple(shape), generator=generator, device=dev)
    return torch.where(u < prob[i], i, alias[i]).to(torch.int32)


class WalkerAliasTable:
    """Object parity with util/WalkerAliasTable.java:4-9:
    initTable / generateSample / reGenerateAliasTable."""

    def __init__(self, probs=None):
        self.prob = None
        self.alias = None
        if probs is not None:
            self.init_table(probs)

    def init_table(self, probs):
        self.prob, self.alias = build_alias_table(probs)
        return self

    # reGenerateAliasTable in the reference reuses buffers; here it's a
    # rebuild (buffer reuse is meaningless for NumPy)
    regenerate = init_table

    def generate_sample(self, generator: torch.Generator,
                        shape=()) -> np.ndarray:
        if self.prob is None:
            raise RuntimeError("init_table first")
        return alias_sample(self.prob, self.alias, generator,
                            shape).cpu().numpy()


class PoissonFixedCoeffSampler:
    """O(1) Poisson(λ) draws from a precomputed alias table over
    {0..cutoff}, mirroring types/PoissonFixedCoeffSampler.java (used by the
    Polya-Urn fixed-coefficient path for counts below
    `alias_poisson_threshold`, LDAConfiguration.java:44)."""

    def __init__(self, lam: float, cutoff: int | None = None):
        self.lam = float(lam)
        if cutoff is None:
            cutoff = int(lam + 10.0 * max(np.sqrt(lam), 1.0))
        ks = np.arange(cutoff + 1)
        log_pmf = ks * np.log(max(lam, 1e-300)) - lam - (
            np.cumsum(np.concatenate([[0.0], np.log(np.maximum(ks[1:], 1))])))
        pmf = np.exp(log_pmf - log_pmf.max())
        self.table = WalkerAliasTable(pmf)

    def next_poisson(self, generator: torch.Generator,
                     shape=()) -> np.ndarray:
        return self.table.generate_sample(generator, shape)
