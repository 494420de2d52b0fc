"""Gamma, Dirichlet and Polya-Urn draws for the theta/phi steps.

The port's copy of `ldagroupedgibbssampler_tpu/ops/random.py`
(`_gamma_marsaglia`, `gamma`, `dirichlet`, `DIRICHLET_FLOOR`,
`polya_urn_dirichlet`) in plain
PyTorch: a fixed-round vectorised Marsaglia-Tsang sampler, elementwise over
the whole [D, K] or [V, K] concentration matrix, on whatever device the
concentration lives on. The reference draws each coordinate with a scalar
rejection loop (cc/mallet/util/ParallelRandoms.java:60-83).

Random bits come from an explicit `torch.Generator` on the same device;
the draws differ from the JAX package's bit for bit (another PRNG) but not
in distribution.
"""

from __future__ import annotations

import torch

# Floor applied to Dirichlet coordinates, mirroring the Double.MIN_VALUE floor
# the reference applies to avoid exact zeros in phi/theta
# (types/ParallelDirichlet.java:46-70), as a float32-friendly tiny value.
DIRICHLET_FLOOR = 1e-30

# Fixed rejection rounds. Acceptance per round is >= ~0.95 for every boosted
# shape (a_eff >= 1), so all rounds reject with probability <= 0.05^6 ~
# 1.6e-8 per element; those rare elements keep the mode d.
_MARSAGLIA_ROUNDS = 6


def _gamma_marsaglia(a: torch.Tensor, generator: torch.Generator,
                     rounds: int = _MARSAGLIA_ROUNDS) -> torch.Tensor:
    """Vectorised Marsaglia-Tsang Gamma(a, 1) with `rounds` unrolled
    rejection rounds, starting at the mode d, then the u^(1/a) boost for
    a < 1 (ParallelRandoms.rgamma's alpha<1 path) in exp/log form."""
    a = a.to(torch.float32)
    shape, device = a.shape, a.device
    tiny = torch.finfo(torch.float32).tiny
    a_eff = torch.where(a < 1.0, a + 1.0, a)
    d = a_eff - (1.0 / 3.0)
    c = torch.rsqrt(9.0 * d)
    # `out` starts at the mode d: kept only in the ~1.6e-8 all-reject tail
    out = d.clone()
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    for _ in range(rounds):
        x = torch.randn(shape, generator=generator, device=device)
        v1 = 1.0 + c * x
        v = v1 * v1 * v1
        u = torch.rand(shape, generator=generator,
                       device=device).clamp_min_(tiny)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.where(v > 0, v, 1.0)))
        out = torch.where(ok & ~accepted, d * v, out)
        accepted |= ok
    ub = torch.rand(shape, generator=generator, device=device).clamp_min_(tiny)
    # a < 1 boost: G(a) = G(a+1) * U^(1/a); the exp/log form stays finite
    # and maps a -> 0 to an exact 0 draw (Gamma(0) is a point mass at 0)
    boost = torch.where(a < 1.0, torch.exp(torch.log(ub) / a.clamp_min(tiny)),
                        1.0)
    return out * boost


def gamma(shape_param, generator: torch.Generator) -> torch.Tensor:
    """Gamma(shape_param, 1) draws, elementwise, float32."""
    return _gamma_marsaglia(torch.as_tensor(shape_param), generator)


def dirichlet(concentration, generator: torch.Generator) -> torch.Tensor:
    """Dirichlet draw(s) along the last axis: rows normalised over the last
    axis, floored at DIRICHLET_FLOOR like the reference's ParallelDirichlet
    (types/ParallelDirichlet.java:46-70)."""
    g = _gamma_marsaglia(torch.as_tensor(concentration), generator)
    g = g.clamp_min(DIRICHLET_FLOOR)
    return g / g.sum(dim=-1, keepdim=True)


def polya_urn_dirichlet(counts, beta: float, generator: torch.Generator):
    """Polya-Urn phi rows: normalised Poisson(beta + n) counts.

    The port's copy of the JAX package's `polya_urn_dirichlet`, after
    types/PolyaUrnDirichlet.java:23-48 (`nextDistributionWithSparseness`):
    each coordinate draws c ~ Poisson(beta + n_kw), rows are normalised by
    their total, and coordinates with c == 0 stay exactly zero. A row whose
    draws are all zero falls back to uniform.

    Returns (phi rows, zero mask marking the exact zeros).
    """
    lam = torch.as_tensor(counts).to(torch.float32) + beta
    c = torch.poisson(lam, generator=generator)
    total = c.sum(dim=-1, keepdim=True)
    safe = torch.where(total > 0, c / total.clamp_min(1.0),
                       1.0 / c.shape[-1])
    return safe, c == 0
