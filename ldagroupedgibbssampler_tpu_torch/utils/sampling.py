"""Host-side sampling / sorting utilities.

Replaces `util/SystematicSampling.java:6` (frequency-proportional
systematic sampling), `util/WithoutReplacementSampler.java:7-28` /
`util/IndexSampler.java`, and `util/IndexSorter.java` /
`util/IntArraySortUtils.java` (descending count-index sort for type
frequency tables). These are corpus-preparation helpers — plain NumPy is
the right tool; nothing here runs per-iteration on device. The port's copy
of `ldagroupedgibbssampler_tpu/utils/sampling.py`.
"""

from __future__ import annotations

import numpy as np


def systematic_sample(weights, n: int, rng=None) -> np.ndarray:
    """Systematic (fixed-interval) sampling of `n` indices with inclusion
    probability proportional to `weights` (SystematicSampling.java:57-76).
    Items with weight >= the sampling interval are always included."""
    rng = rng or np.random.default_rng()
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if total <= 0 or n <= 0:
        return np.zeros(0, np.int64)
    cum = np.cumsum(w) / total
    start = rng.uniform(0, 1.0 / n)
    points = start + np.arange(n) / n
    idx = np.searchsorted(cum, points, side="right")
    return np.unique(np.clip(idx, 0, len(w) - 1))


def sample_without_replacement(population_size: int, n: int,
                               rng=None) -> np.ndarray:
    """Uniform sample of `n` distinct indices
    (WithoutReplacementSampler.java:7-28)."""
    rng = rng or np.random.default_rng()
    return rng.choice(population_size, size=min(n, population_size),
                      replace=False)


def index_sorter(counts) -> np.ndarray:
    """Indices of `counts` in DESCENDING count order, ties by index
    (IndexSorter.getSortedIndices semantics)."""
    counts = np.asarray(counts)
    return np.argsort(-counts, kind="stable").astype(np.int64)
