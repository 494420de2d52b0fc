"""Gamma, Dirichlet, Polya-Urn and variable-selection draws for the
theta/phi steps, and the Poisson / Binomial / Beta helpers of the HDP
family.

The port's copy of `ldagroupedgibbssampler_tpu/ops/random.py`
(`_gamma_marsaglia`, `gamma`, `dirichlet`, `log_dirichlet`,
`DIRICHLET_FLOOR`, `conditional_dirichlet`, `polya_urn_dirichlet`, `_lgamma_ratio`, `vs_inclusion_prob`,
`vs_dirichlet`, `poisson`, `binomial`, `beta`) in plain
PyTorch: a fixed-round vectorised Marsaglia-Tsang sampler, elementwise over
the whole [D, K] or [V, K] concentration matrix, on whatever device the
concentration lives on. The reference draws each coordinate with a scalar
rejection loop (cc/mallet/util/ParallelRandoms.java:60-83).

Random bits come from an explicit `torch.Generator` on the same device;
the draws differ from the JAX package's bit for bit (another PRNG) but not
in distribution. On a CUDA tensor every Gamma draw, and the Dirichlet's
floor and normalisation with it, is the hand-written kernel of
`ops/cuda_gamma.py` (csrc/gamma.cu), where the JAX package has XLA fuse
the rounds into one program; so are the Poisson and Binomial draws
(`ops/cuda_polya_urn.py`, `ops/cuda_hdp.py`), the Polya-Urn rows
(csrc/polya_urn.cu) and the vectorised VS-Dirichlet rows
(csrc/vs_dirichlet.cu). Each kernel draw's Philox key is one int64 drawn
from the generator (`kernel_seed`), so a captured CUDA graph replays new
draws. On a CPU tensor the draws are the plain PyTorch code below, from
the generator.
"""

from __future__ import annotations

import math

import torch

from ldagroupedgibbssampler_tpu_torch.ops import (cuda_gamma, cuda_hdp,
                                                  cuda_polya_urn)

# Floor applied to Dirichlet coordinates, mirroring the Double.MIN_VALUE floor
# the reference applies to avoid exact zeros in phi/theta
# (types/ParallelDirichlet.java:46-70), as a float32-friendly tiny value.
DIRICHLET_FLOOR = 1e-30

# Fixed rejection rounds, the Gamma kernel's too. Acceptance per round is
# >= ~0.95 for every boosted shape (a_eff >= 1), so all rounds reject with
# probability <= 0.05^6 ~ 1.6e-8 per element; those rare elements keep the
# mode d.
_MARSAGLIA_ROUNDS = cuda_gamma.ROUNDS


def kernel_seed(generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """The Philox key of one kernel draw: int64 [1] on the device, from
    the generator (no host sync)."""
    return kernel_seeds(generator, device, 1)


def kernel_seeds(generator: torch.Generator, device: torch.device,
                 n: int) -> torch.Tensor:
    """The Philox keys of n kernel draws in one launch: int64 [n] on the
    device, from the generator (no host sync); key i is the view
    [i:i + 1]."""
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=device, dtype=torch.int64)


def _gamma_marsaglia(a: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Vectorised Marsaglia-Tsang Gamma(a, 1) with _MARSAGLIA_ROUNDS
    unrolled rejection rounds, starting at the mode d, then the u^(1/a)
    boost for a < 1 (ParallelRandoms.rgamma's alpha<1 path) in exp/log
    form. On a CUDA tensor: the Gamma kernel."""
    a = a.to(torch.float32)
    if a.device.type != "cpu":
        return cuda_gamma.gamma(a, kernel_seed(generator, a.device))
    return _gamma_eager(a, generator)


def _gamma_eager(a: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """The plain PyTorch draw of float32 `a` from the generator, about 25
    elementwise launches a round on any device: the CPU's path."""
    shape, device = a.shape, a.device
    tiny = torch.finfo(torch.float32).tiny
    a_eff = torch.where(a < 1.0, a + 1.0, a)
    d = a_eff - (1.0 / 3.0)
    c = torch.rsqrt(9.0 * d)
    # `out` starts at the mode d: kept only in the ~1.6e-8 all-reject tail
    out = d.clone()
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    for _ in range(_MARSAGLIA_ROUNDS):
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


def dirichlet(concentration, generator: torch.Generator, dim: int = -1,
              prior=None) -> torch.Tensor:
    """Dirichlet draw(s) normalised over `dim` (the last axis by default;
    axis 0 of a matrix for phi in [V, K] orientation), floored at
    DIRICHLET_FLOOR like the reference's ParallelDirichlet
    (types/ParallelDirichlet.java:46-70). With `prior` (a float, or a
    tensor along the last axis), `concentration` holds counts and the
    concentration is counts.to(float32) + prior. On a CUDA tensor: the
    Dirichlet kernel, one launch (two for axis 0)."""
    x = torch.as_tensor(concentration)
    if x.device.type != "cpu":
        return cuda_gamma.dirichlet(x, kernel_seed(generator, x.device),
                                    dim, prior)
    conc = x if prior is None else x.to(torch.float32) + prior
    g = _gamma_marsaglia(conc, generator)
    g = g.clamp_min(DIRICHLET_FLOOR)
    return g / g.sum(dim=dim, keepdim=True)


def log_dirichlet(concentration, generator: torch.Generator) -> torch.Tensor:
    """log of a Dirichlet draw along the last axis, in log space:
    log(max(Gamma, DIRICHLET_FLOOR)) minus its logsumexp, so that tiny
    concentrations (beta = 0.01) do not underflow. The Gamma draw is
    `gamma`'s (on a CUDA tensor the Gamma kernel), so that exp of the
    result is `dirichlet` of the same generator state up to rounding: the
    logs are taken in float64 and the result rounded once to float32."""
    g = gamma(concentration, generator).clamp_min(DIRICHLET_FLOOR)
    log_g = g.to(torch.float64).log()
    return (log_g - torch.logsumexp(log_g, dim=-1, keepdim=True)).to(
        torch.float32)


def conditional_dirichlet(previous, concentration, mask,
                          generator: torch.Generator) -> torch.Tensor:
    """Redraw only the coordinates where `mask` is True, along the last
    axis.

    Mirrors types/ConditionalDirichlet.java (`nextConditionalDistribution`,
    used by UncollapsedParallelLDA.java:1326-1329 for partial phi updates):
    given an existing Dirichlet draw `previous`, redraw the masked subset
    from its conditional distribution and rescale so the row still sums to
    1. The conditional of a Dirichlet sub-vector given the rest is a scaled
    Dirichlet: redraw sub ~ Dir(conc[mask]), give it total mass
    B ~ Beta(sum(conc[mask]), sum(conc[~mask])) and scale the kept block by
    (1 - B) / its current mass.

    B is clamped to [1e-7, 1 - 1e-7]: with a tiny keep-block concentration
    the float32 Beta draw can round to exactly 1, and the kept entries
    would become 0, losing the positive support the sweep kernel's
    `positive_support` path relies on (`models/pcgs.py`, `adlda.py`). The
    clamp is below the float32 Beta draw's own granularity.
    """
    previous = torch.as_tensor(previous).to(torch.float32)
    conc = torch.as_tensor(concentration).to(torch.float32)
    mask = torch.as_tensor(mask, device=conc.device).to(torch.bool)
    conc_sub_sum = torch.where(mask, conc, 0.0).sum(dim=-1, keepdim=True)
    conc_keep_sum = torch.where(mask, 0.0, conc).sum(dim=-1, keepdim=True)
    b = beta(conc_sub_sum.clamp_min(1e-6), conc_keep_sum.clamp_min(1e-6),
             generator).clamp(1e-7, 1.0 - 1e-7)
    # a fresh Dirichlet over the masked block (masked-out coordinates 0)
    g = _gamma_marsaglia(torch.where(mask, conc, 1.0), generator)
    g = torch.where(mask, g.clamp_min(DIRICHLET_FLOOR), 0.0)
    sub = g / g.sum(dim=-1, keepdim=True).clamp_min(DIRICHLET_FLOOR)
    keep_mass_now = torch.where(mask, 0.0, previous).sum(dim=-1,
                                                          keepdim=True)
    keep_scale = torch.where(keep_mass_now > 0, (1.0 - b) / keep_mass_now
                             .clamp_min(DIRICHLET_FLOOR), 0.0)
    out = torch.where(mask, b * sub, previous * keep_scale)
    # degenerate rows (everything masked) take the fresh draw
    return torch.where(mask.all(dim=-1, keepdim=True), sub, out)


def polya_urn_dirichlet(counts, beta: float, generator: torch.Generator,
                        zero_mask: bool = True):
    """Polya-Urn phi rows: normalised Poisson(beta + n) counts.

    The port's copy of the JAX package's `polya_urn_dirichlet`, after
    types/PolyaUrnDirichlet.java:23-48 (`nextDistributionWithSparseness`):
    each coordinate draws c ~ Poisson(beta + n_kw), rows are normalised by
    their total, and coordinates with c == 0 stay exactly zero. A row whose
    draws are all zero falls back to uniform. On a CUDA tensor: the
    Polya-Urn kernel, two launches.

    Returns (phi rows, zero mask marking the exact zeros; None unless
    `zero_mask`).
    """
    counts = torch.as_tensor(counts)
    if counts.device.type != "cpu":
        return cuda_polya_urn.polya_urn(
            counts, beta, kernel_seed(generator, counts.device),
            zero_mask=zero_mask)
    lam = counts.to(torch.float32) + beta
    c = torch.poisson(lam, generator=generator)
    total = c.sum(dim=-1, keepdim=True)
    safe = torch.where(total > 0, c / total.clamp_min(1.0),
                       1.0 / c.shape[-1])
    return safe, (c == 0 if zero_mask else None)


def _lgamma_ratio(x, b):
    """lgamma(x + b) - lgamma(x), stable in float32 for large x.

    Differencing float32 lgamma loses all precision once x is large
    (lgamma(1e6) ~ 1.3e7, whose ulp eats the O(b log x) difference), so
    for x >= 8 the ratio comes from Stirling's series with log1p, every
    term O(b log x):

        (x - 1/2) log1p(b/x) + b log(x+b) - b
        + [1/(12(x+b)) - 1/(12x)] - [1/(360(x+b)^3) - 1/(360 x^3)]

    (truncation error < 3e-8 at x = 8). Below x = 8 the direct difference
    is accurate; x <= 0 keeps lgamma's +inf (MALLET's
    logGammaStirling(0) = +inf).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    small = torch.lgamma(x + b) - torch.lgamma(x)
    xs = x.clamp_min(1.0)     # guards the asymptotic branch's 1/x at x < 8
    xb = xs + b
    asym = ((xs - 0.5) * torch.log1p(b / xs) + b * torch.log(xb) - b
            + (1.0 / (12.0 * xb) - 1.0 / (12.0 * xs))
            - (1.0 / (360.0 * xb ** 3) - 1.0 / (360.0 * xs ** 3)))
    return torch.where(x < 8.0, small, asym)


def vs_inclusion_prob(zero_phi, n_k, beta: float, vs_prior: float):
    """Posterior inclusion probability p(I_kv = 1) of the VS Dirichlet
    (VSDirichlet.calculateIndicatorProbIsOne, types/VSDirichlet.java:
    96-120): with a = zero_phi * beta, the prior mass on the row's
    currently-zero coordinates,

        r = G(a+b) G(a+n) / (G(a+b+n) G(a)) * pi / (1 - pi),  p = r / (1+r)

    for b = beta, n = n_k. zero_phi = 0 with n_k > 0 gives p = 0 exactly
    (logGammaStirling(0) = +inf); n_k = 0 gives vs_prior, the limit the
    formula takes for every zero_phi > 0 (the reference's NaN corner
    zero_phi = n_k = 0 included)."""
    zero_phi = torch.as_tensor(zero_phi, dtype=torch.float32)
    n_k = torch.as_tensor(n_k, dtype=torch.float32).to(zero_phi.device)
    a = zero_phi * beta
    log_odds = math.log(vs_prior) - math.log1p(-vs_prior)
    log_r = _lgamma_ratio(a, beta) - _lgamma_ratio(a + n_k, beta) + log_odds
    log_r = torch.where((zero_phi <= 0) & (n_k > 0), -math.inf, log_r)
    return torch.where(n_k <= 0, vs_prior, torch.sigmoid(log_r))


def vs_dirichlet(counts, beta: float, vs_prior: float,
                 generator: torch.Generator, previous_phi=None,
                 sequential: bool = False):
    """Variable-selection (spike-and-slab) Dirichlet rows
    (VSDirichlet.nextDistribution, types/VSDirichlet.java:35-93):
    coordinates with positive counts draw Gamma(count + beta); zero-count
    ones are included with probability `vs_inclusion_prob`, driven by the
    row's number of zero coordinates in `previous_phi` (zeroPhi; None
    means a dense previous draw, zeroPhi = 0) and its total n_k; excluded
    coordinates are exact zeros.

    The default holds zeroPhi fixed over the row, so every indicator draws
    at once. `sequential=True` is the reference's chain, which updates
    zeroPhi after every coordinate: a Python loop over the columns,
    vectorised over the rows, for the parity tests only. On a CUDA tensor
    the default form is the VS-Dirichlet kernel, one launch; the
    sequential chain stays this plain PyTorch on any device.

    Returns (row probabilities, zero mask)."""
    counts = torch.as_tensor(counts)
    if counts.device.type != "cpu" and not sequential:
        prev = (None if previous_phi is None
                else torch.as_tensor(previous_phi).to(counts.device))
        return cuda_gamma.vs_dirichlet(
            counts, beta, vs_prior, kernel_seed(generator, counts.device),
            prev, zero_mask=True)
    counts = counts.to(torch.float32)
    dev = counts.device
    n_k = counts.sum(dim=-1, keepdim=True)
    if previous_phi is None:
        prev_zero = torch.zeros(counts.shape, dtype=torch.bool, device=dev)
    else:
        prev_zero = torch.as_tensor(previous_phi).to(dev) == 0.0
    zero_phi = prev_zero.sum(dim=-1, keepdim=True).to(torch.float32)
    g = _gamma_marsaglia(counts + beta, generator)
    u = torch.rand(counts.shape, generator=generator, device=dev)
    if sequential:
        include = torch.empty(counts.shape, dtype=torch.bool, device=dev)
        zp = zero_phi[..., 0]
        for i in range(counts.shape[-1]):
            c_i, pz_i = counts[..., i], prev_zero[..., i]
            inc_zero = u[..., i] <= vs_inclusion_prob(zp, n_k[..., 0], beta,
                                                      vs_prior)
            include[..., i] = (c_i > 0) | inc_zero
            # zeroPhi + 1 when a nonzero coordinate draws I = 0, - 1 when
            # a zero one draws I = 1
            zp = (zp + ((c_i == 0) & ~inc_zero & ~pz_i).to(torch.float32)
                  - ((c_i == 0) & inc_zero & pz_i).to(torch.float32))
    else:
        p = vs_inclusion_prob(zero_phi, n_k, beta, vs_prior)
        include = (counts > 0) | (u <= p)
    g = torch.where(include, g.clamp_min(DIRICHLET_FLOOR), 0.0)
    probs = g / g.sum(dim=-1, keepdim=True).clamp_min(DIRICHLET_FLOOR)
    return probs, ~include


def poisson(lam, generator: torch.Generator) -> torch.Tensor:
    """Poisson(lam) draws, elementwise, float32 (types/PolyaUrnDirichlet.
    java:96-, types/PoissonFixedCoeffSampler.java). On a CUDA tensor: the
    Poisson kernel (csrc/polya_urn.cu)."""
    lam = torch.as_tensor(lam).to(torch.float32)
    if lam.device.type != "cpu":
        return cuda_polya_urn.poisson(lam, kernel_seed(generator, lam.device))
    return torch.poisson(lam, generator=generator)


def binomial(n, p, generator: torch.Generator) -> torch.Tensor:
    """Binomial(n, p) draws, elementwise, float32 (types/BinomialSampler.
    java). On a CUDA tensor: the Binomial kernel (csrc/hdp.cu)."""
    n = torch.as_tensor(n).to(torch.float32)
    p = torch.as_tensor(p).to(torch.float32).to(n.device)
    if n.device.type != "cpu":
        return cuda_hdp.binomial(n, p.expand_as(n),
                                 kernel_seed(generator, n.device))
    return torch.binomial(n, p.expand_as(n).contiguous(),
                          generator=generator)


def beta(a, b, generator: torch.Generator) -> torch.Tensor:
    """Beta(a, b) draws (util/ParallelRandoms.java:46-50) as the ratio of
    two Marsaglia gammas, broadcasting a against b."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32).to(a.device)
    a, b = torch.broadcast_tensors(a, b)
    g1 = _gamma_marsaglia(a, generator)
    g2 = _gamma_marsaglia(b, generator)
    return g1 / (g1 + g2).clamp_min(DIRICHLET_FLOOR)
