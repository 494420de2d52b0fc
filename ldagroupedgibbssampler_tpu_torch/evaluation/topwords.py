"""Top-word extraction and reweightings.

Mirrors the LDAUtils word-ranking family (util/LDAUtils.java):
  - `top_words` (:874) — by per-topic count/probability
  - `top_relevance_words` (:566) — LDAvis lambda-relevance:
        r = lambda*log p(w|k) + (1-lambda)*log(p(w|k)/p(w))
Host-side NumPy on [K, V] matrices read back from the device.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def _topk_words(score_kv: np.ndarray, vocab, n: int):
    out = []
    for k in range(score_kv.shape[0]):
        idx = np.argsort(-score_kv[k])[:n]
        out.append([vocab[i] for i in idx])
    return out


def top_words(nkw_or_phi, vocab, n: int = 20):
    """Top-n words per topic by mass (LDAUtils.getTopWords:874)."""
    return _topk_words(np.asarray(nkw_or_phi, np.float64), vocab, n)


def top_relevance_words(phi, vocab, n: int = 20, lam: float = 0.6):
    """Relevance-reweighted top words (LDAUtils.getTopRelevanceWords:566;
    `lambda` config key, LAMBDA_DEFAULT=0.6)."""
    phi = np.asarray(phi, np.float64)
    p_w = np.maximum(phi.mean(axis=0), _EPS)
    rel = lam * np.log(phi + _EPS) + (1 - lam) * np.log(
        (phi + _EPS) / p_w[None, :])
    return _topk_words(rel, vocab, n)
