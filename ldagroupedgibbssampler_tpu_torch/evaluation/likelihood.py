"""Model log-likelihood and log-posterior, computed on the tensors' device.

The port's copy of `ldagroupedgibbssampler_tpu/evaluation/likelihood.py`
with `torch.lgamma`:

  - `model_log_likelihood`: collapsed Dirichlet-multinomial marginal
    p(w, z | alpha, beta), mirroring ModifiedSimpleLDA.modelLogLikelihood
    (topics/ModifiedSimpleLDA.java:228-324). Computed from the count
    matrices alone — no token loop.
  - `log_posterior`: the Doss & George augmented-state log posterior
    log p(z, theta, phi | w) up to a constant, mirroring
    SerialCollapsedLDA.computeLogPosterior (topics/SerialCollapsedLDA.java:
    371-433), with the same 1e-12 stability epsilon.
  - `matrix_density`: fraction of non-zero entries
    (LDAUtils.calculateMatrixDensity:1734).
  - `perplexity`: exp(-LL / N) (LDAUtils.perplexityToFile:914).

All sums are float32, as in the JAX package; results are 0-d tensors.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def model_log_likelihood(ndk, nkw, alpha, beta: float) -> torch.Tensor:
    """Collapsed LL of (w, z); `ndk` [D, K], `nkw` [K, V]. `alpha` may be
    scalar (symmetric) or [K].

      sum_d [ sum_k lgamma(alpha_k + n_dk) - lgamma(alphaSum + n_d) ]
      + D [ lgamma(alphaSum) - sum_k lgamma(alpha_k) ]
      + sum_k [ sum_w lgamma(beta + n_kw) - lgamma(V beta + n_k) ]
      + K [ lgamma(V beta) - V lgamma(beta) ]

    The sums run over the topics with alpha_k > 0 or n_k > 0. A topic with
    alpha_k = 0 and n_k = 0 (an inactive HDP topic) adds lgamma(0) -
    lgamma(0) = 0 to every document in the limit, and nothing to the topic
    part; the formula as written would give inf - inf = NaN, which is what
    the JAX package returns for such a state. Every LDA state has
    alpha_k > 0 on all topics and is unchanged. A topic with alpha_k = 0
    and n_k > 0 (an active HDP topic whose Poisson psi draw came out 0) is
    left as the formula gives it: its true term is -inf (lgamma(alpha_k)
    -> inf with some n_dk > 0), which the float sums give as NaN.
    """
    ndk = _f32(ndk)
    nkw = _f32(nkw).to(ndk.device)
    alpha = _f32(alpha).to(ndk.device).expand(ndk.shape[1])
    keep = topics_kept(nkw, alpha)
    return (doc_log_likelihood(ndk, alpha, keep)
            + topic_log_likelihood(nkw, beta, keep))


def topics_kept(nkw, alpha) -> torch.Tensor:
    """bool [K]: the topics with alpha_k > 0 or n_k > 0, over which the
    sums of `model_log_likelihood` run (`nkw` [K, V] f32, `alpha` [K])."""
    return (alpha > 0) | (nkw.sum(dim=1) > 0)


def doc_log_likelihood(ndk, alpha, keep) -> torch.Tensor:
    """The documents' terms of `model_log_likelihood`: a sum over the rows
    of `ndk` [D, K] f32, so that the ranks of a sharded scheme add up the
    terms of their own documents."""
    alpha_sum = alpha.sum()
    doc_lengths = ndk.sum(dim=1)
    return (torch.where(keep, torch.lgamma(alpha[None, :] + ndk), 0.0).sum()
            - torch.lgamma(alpha_sum + doc_lengths).sum()
            + ndk.shape[0] * (torch.lgamma(alpha_sum)
                              - torch.where(keep, torch.lgamma(alpha),
                                            0.0).sum()))


def topic_log_likelihood(nkw, beta: float, keep) -> torch.Tensor:
    """The topics' terms of `model_log_likelihood` (`nkw` [K, V] f32)."""
    num_types = nkw.shape[1]
    beta = float(beta)
    nk = nkw.sum(dim=1)
    return (torch.where(keep[:, None], torch.lgamma(beta + nkw), 0.0).sum()
            - torch.where(keep, torch.lgamma(num_types * beta + nk),
                          0.0).sum()
            + keep.sum() * (torch.lgamma(_f32(num_types * beta))
                            - num_types * torch.lgamma(_f32(beta))))


def log_posterior(ndk, nkw, theta, phi, alpha, beta: float) -> torch.Tensor:
    """Doss & George log posterior of the augmented state
    (SerialCollapsedLDA.java:371-433); `ndk`/`theta` [D, K], `nkw`/`phi`
    [K, V]. The reference's per-doc m_djt accumulation collapses to
    N_kw."""
    theta = _f32(theta)
    return (word_log_posterior(nkw, phi, beta, theta.device)
            + doc_log_posterior(ndk, theta, alpha))


def word_log_posterior(nkw, phi, beta: float, device) -> torch.Tensor:
    """The topics' terms of `log_posterior` (`nkw` / `phi` [K, V])."""
    log_phi = torch.log(_f32(phi).to(device) + _EPS)
    return ((_f32(nkw).to(device) * log_phi).sum()
            + (float(beta) - 1.0) * log_phi.sum())


def doc_log_posterior(ndk, theta, alpha) -> torch.Tensor:
    """The documents' terms of `log_posterior` (`ndk` / `theta` [D, K]), a
    sum over their rows."""
    theta = _f32(theta)
    dev = theta.device
    return ((_f32(ndk).to(dev) + _f32(alpha).to(dev) - 1.0)
            * torch.log(theta + _EPS)).sum()


def matrix_density(mat) -> torch.Tensor:
    """Fraction of non-zero entries (LDAUtils.java:1734-1770): the float32
    count times the float32 reciprocal of the size, as jnp.mean computes
    it, so the stats rows of the two packages agree digit for digit."""
    nonzero = (torch.as_tensor(mat) != 0).to(torch.float32)
    return nonzero.sum() * torch.tensor(1.0 / max(nonzero.numel(), 1),
                                        dtype=torch.float32)


def perplexity(held_out_ll: float, num_tokens: int) -> float:
    """exp(-LL / N) (LDAUtils.perplexityToFile:914)."""
    return math.exp(-held_out_ll / max(num_tokens, 1))
