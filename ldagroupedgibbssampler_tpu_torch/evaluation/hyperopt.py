"""Hyperparameter optimisation: Minka fixed-point updates.

The port's copy of `ldagroupedgibbssampler_tpu/evaluation/hyperopt.py`.
Replaces MALLET `Dirichlet.learnSymmetricConcentration` / `learnParameters`
as used by ModifiedSimpleLDA.optimizeAlpha/optimizeBeta
(topics/ModifiedSimpleLDA.java:812-905):

  - alpha (asymmetric): fixed point on the doc-topic count matrix
        alpha_k <- alpha_k * (sum_d psi(n_dk + alpha_k) - D psi(alpha_k))
                           / (sum_d psi(n_d + alphaSum) - D psi(alphaSum))
  - symmetric concentration (used for beta, and alpha when
    `symmetric_alpha=true`): same update with all categories tied.

Host-side NumPy with `torch.special.digamma` in float64; the inputs are
count histograms, and this runs once per hyperopt interval.
"""

from __future__ import annotations

import numpy as np
import torch


def _digamma(x):
    return torch.special.digamma(
        torch.as_tensor(np.asarray(x, np.float64))).numpy()


def learn_dirichlet_parameters(alpha: np.ndarray, counts: np.ndarray,
                               lengths: np.ndarray, iterations: int = 200,
                               tol: float = 1e-6) -> np.ndarray:
    """Asymmetric Minka fixed point. counts[D, K] observation histograms,
    lengths[D] their row sums. Returns updated alpha[K] (MALLET
    Dirichlet.learnParameters as called at ModifiedSimpleLDA.java:812-861)."""
    alpha = np.asarray(alpha, np.float64).copy()
    counts = np.asarray(counts, np.float64)
    lengths = np.asarray(lengths, np.float64)
    n_docs = counts.shape[0]
    for _ in range(iterations):
        denom = np.sum(_digamma(lengths + alpha.sum())) \
            - n_docs * _digamma(alpha.sum())
        if denom <= 0:
            break
        numer = np.sum(_digamma(counts + alpha[None, :]), axis=0) \
            - n_docs * _digamma(alpha)
        new_alpha = alpha * np.maximum(numer, 1e-10) / denom
        new_alpha = np.maximum(new_alpha, 1e-8)
        if np.max(np.abs(new_alpha - alpha)) < tol:
            alpha = new_alpha
            break
        alpha = new_alpha
    return alpha


def learn_symmetric_concentration(counts: np.ndarray, lengths: np.ndarray,
                                  num_categories: int, concentration: float,
                                  iterations: int = 200,
                                  tol: float = 1e-6) -> float:
    """Symmetric Minka fixed point for the *total* concentration given
    count histograms (MALLET Dirichlet.learnSymmetricConcentration, used for
    beta at ModifiedSimpleLDA.java:863-905). Returns the per-category value.

    counts[M, C] histogram rows, lengths[M] row totals. `concentration` is
    the current per-category value.
    """
    counts = np.asarray(counts, np.float64)
    lengths = np.asarray(lengths, np.float64)
    n_rows = counts.shape[0]
    per_cat = float(concentration)
    for _ in range(iterations):
        total = per_cat * num_categories
        denom = num_categories * (
            np.sum(_digamma(lengths + total)) - n_rows * _digamma(total))
        numer = np.sum(_digamma(counts + per_cat)) \
            - n_rows * num_categories * _digamma(per_cat)
        if denom <= 0 or numer <= 0:
            break
        new = per_cat * numer / denom
        new = max(new, 1e-8)
        if abs(new - per_cat) < tol:
            per_cat = new
            break
        per_cat = new
    return per_cat
