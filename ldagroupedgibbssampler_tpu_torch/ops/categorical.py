"""Vectorised categorical draws: Gumbel-max and inverse CDF.

The port's counterpart of `ldagroupedgibbssampler_tpu/ops/categorical.py`,
with a `torch.Generator` in place of the JAX key; the draws run on the
generator's device. The reference draws each token's topic with a
sequential inverse-CDF scan over K scores (UncollapsedParallelLDA.java:
1519-1531) or an O(1) Walker alias table (util/OptimizedGentleAliasMethod.
java:94-107). The Gumbel-max trick draws a whole block of rows at once:
add iid Gumbel noise to the log-scores and take an argmax over the
category axis — exact categorical sampling of the same target. The port's
samplers draw z in their kernels; these are the device-wide helpers.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = np.float32(-1e30)


def _gumbel(like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """iid standard Gumbel noise of `like`'s shape and dtype,
    -log(-log(u)) with u uniform on [tiny, 1) as jax.random.gumbel draws
    it."""
    u = torch.rand(like.shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(like.dtype).tiny)))


def gumbel_categorical(log_scores: torch.Tensor, generator: torch.Generator,
                       axis: int = -1) -> torch.Tensor:
    """One categorical sample per row of unnormalised log-scores:
    P(z=k) ∝ exp(log_scores[k]) (UncollapsedParallelLDA.java:1519-1531)."""
    return torch.argmax(log_scores + _gumbel(log_scores, generator),
                        dim=axis).to(torch.int32)


def masked_gumbel_categorical(log_scores: torch.Tensor, mask: torch.Tensor,
                              generator: torch.Generator,
                              axis: int = -1) -> torch.Tensor:
    """Gumbel-max over only the positions where mask is True: masked-out
    categories have probability exactly 0 (sparse Polya-Urn phi, HDP
    inactive topics)."""
    return torch.argmax(
        torch.where(mask, log_scores + _gumbel(log_scores, generator),
                    float(NEG_INF)), dim=axis).to(torch.int32)


def inverse_cdf_categorical(scores: torch.Tensor, generator: torch.Generator,
                            axis: int = -1) -> torch.Tensor:
    """Inverse-CDF draw: u * sum(scores), then the first index where the
    running cumsum exceeds it (one uniform per row, as the reference's
    scan, topics/EfficientUncollapsedParallelLDA.java:86-100)."""
    total = scores.sum(dim=axis, keepdim=True)
    u = torch.rand(total.shape, generator=generator, dtype=scores.dtype,
                   device=scores.device) * total
    cdf = scores.cumsum(dim=axis)
    # argmax returns the first maximal index
    return torch.argmax((cdf > u).to(torch.uint8), dim=axis).to(torch.int32)
