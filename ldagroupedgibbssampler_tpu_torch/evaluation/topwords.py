"""Top-word extraction and reweightings.

Mirrors the LDAUtils word-ranking family (util/LDAUtils.java):
  - `top_words` (:874) — by per-topic count/probability
  - `top_relevance_words` (:566) — LDAvis lambda-relevance:
        r = lambda*log p(w|k) + (1-lambda)*log(p(w|k)/p(w))
  - `top_distinctive_words` (:592) — KL(p(k|w) || p(k)) weighting
  - `top_salient_words` (:619) — p(w) * distinctiveness
  - `calc_k1` (:785) — word-topic probability matrices (:687-872)
Host-side NumPy on [K, V] matrices read back from the device: the port's
copy of `ldagroupedgibbssampler_tpu/evaluation/topwords.py`.
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


def top_word_indices(nkw_or_phi, n: int = 20):
    mat = np.asarray(nkw_or_phi, np.float64)
    return np.argsort(-mat, axis=1)[:, :n]


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


def _distinctiveness(phi):
    """KL(p(k|w) || p(k)) per word (LDAUtils.getTopDistinctiveWords:592)."""
    phi = np.asarray(phi, np.float64)
    num_topics = phi.shape[0]
    p_k_given_w = phi / np.maximum(phi.sum(axis=0, keepdims=True), _EPS)
    p_k = 1.0 / num_topics
    return np.sum(p_k_given_w * np.log((p_k_given_w + _EPS) / p_k), axis=0)


def top_distinctive_words(phi, vocab, n: int = 20):
    dist = _distinctiveness(phi)
    idx = np.argsort(-dist)[:n]
    return [vocab[i] for i in idx]


def top_salient_words(phi, vocab, n: int = 20):
    """Saliency = p(w) * distinctiveness (LDAUtils.getTopSalientWords:619)."""
    phi = np.asarray(phi, np.float64)
    p_w = phi.mean(axis=0)
    sal = p_w * _distinctiveness(phi)
    idx = np.argsort(-sal)[:n]
    return [vocab[i] for i in idx]


def calc_k1(phi, n: int = 20):
    """K1 word-probability matrix for the top words per topic
    (LDAUtils.calcK1:785)."""
    phi = np.asarray(phi, np.float64)
    idx = top_word_indices(phi, n)
    return np.take_along_axis(phi, idx, axis=1), idx
