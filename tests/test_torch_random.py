"""The port's Gamma/Dirichlet draws: the checks of tests/test_random_ops.py
(test_dirichlet_moments, test_gamma_ks_small_shape) on the torch sampler,
plus the exact 0 draw as the shape goes to 0."""

import numpy as np
import torch
from scipy import stats

from ldagroupedgibbssampler_tpu_torch.ops import random as rnd


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_dirichlet_moments():
    conc = torch.tensor([0.5, 1.0, 3.0, 10.0])
    draws = rnd.dirichlet(conc.expand(20000, 4), _gen()).numpy()
    total = float(conc.sum())
    mean_theory = conc.numpy() / total
    var_theory = mean_theory * (1 - mean_theory) / (total + 1)
    np.testing.assert_allclose(draws.mean(0), mean_theory, atol=0.01)
    np.testing.assert_allclose(draws.var(0), var_theory, atol=0.01)
    np.testing.assert_allclose(draws.sum(1), 1.0, atol=1e-5)


def test_gamma_ks_small_shape():
    """KS at shape 0.05 (the beta=0.01 regime), conditioned on draws above
    the float32 flush-to-zero floor, as the JAX package's test does."""
    shape = 0.05
    draws = rnd.gamma(torch.full((50000,), shape), _gen(1)).double().numpy()
    eps = 1e-30
    kept = draws[draws > eps]
    assert len(kept) > 40000
    f_eps = stats.gamma.cdf(eps, shape)
    ks = stats.kstest(kept, lambda x: (stats.gamma.cdf(x, shape) - f_eps)
                      / (1.0 - f_eps))
    assert ks.pvalue > 1e-3, ks


def test_gamma_ks_moderate_shapes():
    for shape in (0.5, 3.0, 40.0):
        draws = rnd.gamma(torch.full((20000,), shape), _gen(2)).numpy()
        ks = stats.kstest(draws, lambda x: stats.gamma.cdf(x, shape))
        assert ks.pvalue > 1e-3, (shape, ks)


def test_gamma_zero_shape_is_exact_zero():
    """Gamma(a) tends to a point mass at 0 as a -> 0: the exp/log boost
    maps a = 0 to exactly 0 instead of nan."""
    g = rnd.gamma(torch.tensor([0.0] * 1000 + [1e-12] * 10 + [1.0]), _gen(3))
    assert torch.isfinite(g).all()
    assert (g[:1000] == 0).all()
    assert g[-1] > 0
    # the Dirichlet floors such coordinates instead of dividing by zero
    d = rnd.dirichlet(torch.tensor([[0.0, 0.0, 5.0]]), _gen(4))
    assert torch.isfinite(d).all() and d[0, 2] > 0.99


def test_polya_urn_dirichlet_sparse_and_normalised():
    """tests/test_random_ops.py::test_polya_urn_dirichlet_sparse_and_
    normalised on the port: rows normalise, zero-count coordinates stay
    exactly zero with probability e^-beta, and the zero mask marks them;
    the nonzero coordinates have the Poisson(beta + n) mean."""
    counts = torch.tensor([[100, 0, 5, 0, 0, 1, 0, 0, 0, 0]] * 4000,
                          dtype=torch.float32)
    probs, zero_mask = rnd.polya_urn_dirichlet(counts, 0.01, _gen(3))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    assert zero_mask[:, 1].float().mean() > 0.9
    assert torch.equal(zero_mask, probs == 0)
    # P(c = 0) = exp(-(beta + n)) for each coordinate
    frac_zero = zero_mask.float().mean(0).numpy()
    expect = np.exp(-(counts[0].numpy() + 0.01))
    np.testing.assert_allclose(frac_zero, expect, atol=0.02)
    # an all-zero row falls back to uniform
    probs0, _ = rnd.polya_urn_dirichlet(torch.zeros(3, 5), 0.0, _gen())
    np.testing.assert_allclose(probs0.numpy(), 0.2)
