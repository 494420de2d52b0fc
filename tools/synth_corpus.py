"""The synthetic 20-Newsgroups corpus of bench.py, shared by chip_smoke.py
and the tools: D documents of Poisson(MEAN_LEN) tokens (at least 5), types
drawn Zipf(1.1) over a vocabulary of V."""

from __future__ import annotations

import numpy as np

D, V = 11269, 20000
MEAN_LEN = 120


def synth_corpus(Corpus, seed=0):
    """The corpus as a `Corpus` (the port's class, passed in so that this
    module imports neither torch nor the port)."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(5, rng.poisson(MEAN_LEN, D)).astype(np.int64)
    n = int(lengths.sum())
    probs = 1.0 / np.arange(1, V + 1, dtype=np.float64) ** 1.1
    probs /= probs.sum()
    tokens = rng.choice(V, size=n, p=probs).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return Corpus(tokens=tokens, doc_offsets=offsets,
                  vocab=[f"w{i}" for i in range(V)])
