"""The port's Gamma/Dirichlet draws: the checks of tests/test_random_ops.py
(test_dirichlet_moments, test_gamma_ks_small_shape) on the torch sampler,
plus the exact 0 draw as the shape goes to 0; the VS Dirichlet's
deterministic parts against the JAX functions, and the Poisson, Binomial,
Beta and VS draws by their moments and frequencies."""

import numpy as np
import pytest
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


# ---------------------------------------------------------------------------
# The VS Dirichlet's deterministic parts against the JAX functions, and the
# Poisson / Binomial / Beta / VS draws statistically
# ---------------------------------------------------------------------------

def _jax_rnd():
    from ldagroupedgibbssampler_tpu.ops import random as jax_rnd
    return jax_rnd


def test_lgamma_ratio_matches_jax():
    """_lgamma_ratio on both sides of its x = 8 branch and at x up to 1e6
    (rtol 1e-5: float32 lgamma and log1p in another library). Below x = 8
    the ratio is a difference of two float32 lgamma values of order 1,
    which the two libraries round a few ulps apart: atol 1e-6 there."""
    x = np.concatenate([[0.01, 0.5, 1.0, 3.0, 7.99, 8.0, 8.01, 20.0],
                        np.geomspace(10.0, 1e6, 25)]).astype(np.float32)
    small = x < 8.0
    for b in (0.01, 0.5, 3.0):
        ours = rnd._lgamma_ratio(torch.as_tensor(x), b).numpy()
        ref = np.asarray(_jax_rnd()._lgamma_ratio(x, b))
        np.testing.assert_allclose(ours[small], ref[small], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ours[~small], ref[~small], rtol=1e-5)


def test_vs_inclusion_prob_matches_jax_on_a_grid_with_its_edges():
    """vs_inclusion_prob over zero_phi x n_k with the edges zero_phi = 0
    (p = 0 where n_k > 0) and n_k = 0 (p = vs_prior), n_k up to 1e6
    (rtol 1e-5)."""
    zero_phi = np.array([0, 1, 2, 5, 50, 800, 5000, 19999], np.float32)
    n_k = np.array([0, 1, 3, 10, 100, 1e3, 1e4, 1e5, 1e6], np.float32)
    zp, nk = np.meshgrid(zero_phi, n_k, indexing="ij")
    for beta, prior in ((0.01, 0.5), (0.1, 0.2), (1.0, 0.9)):
        ours = rnd.vs_inclusion_prob(torch.as_tensor(zp),
                                     torch.as_tensor(nk), beta,
                                     prior).numpy()
        ref = np.asarray(_jax_rnd().vs_inclusion_prob(zp, nk, beta, prior))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-12)
        assert (ours[0, 1:] == 0).all()             # zero_phi = 0, n_k > 0
        np.testing.assert_allclose(ours[:, 0], prior, rtol=1e-6)


def test_poisson_binomial_beta_moments():
    """Mean and variance of 200,000 draws of each against the formulas
    (5 standard errors), and the exact edges Binomial(n, 0) = 0,
    Binomial(n, 1) = n, Poisson(0) = 0."""
    n = 200_000
    g = _gen(11)
    for lam in (0.3, 4.0, 150.0):
        x = rnd.poisson(torch.full((n,), lam), g).double()
        assert abs(x.mean() - lam) < 5 * (lam / n) ** 0.5, lam
        assert abs(x.var() / lam - 1) < 0.03, lam
    for cnt, p in ((10, 0.3), (400, 0.02), (37, 0.9)):
        x = rnd.binomial(torch.full((n,), float(cnt)), torch.tensor(p),
                         g).double()
        var = cnt * p * (1 - p)
        assert abs(x.mean() - cnt * p) < 5 * (var / n) ** 0.5, (cnt, p)
        assert abs(x.var() / var - 1) < 0.03, (cnt, p)
    edge = rnd.binomial(torch.tensor([7.0, 7.0, 0.0]),
                        torch.tensor([0.0, 1.0, 1.0]), g)
    assert edge.tolist() == [0.0, 7.0, 0.0]
    assert (rnd.poisson(torch.zeros(100), g) == 0).all()
    for a, b in ((1.0, 1.0), (0.5, 3.0), (10.0, 0.2), (1.0, 1e-30)):
        x = rnd.beta(torch.full((n,), a), torch.tensor(b), g).double()
        mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
        assert abs(x.mean() - mean) < 5 * (var / n) ** 0.5 + 1e-6, (a, b)
        if var > 1e-6:
            assert abs(x.var() / var - 1) < 0.05, (a, b)
        assert ((x >= 0) & (x <= 1)).all()
    ks = stats.kstest(rnd.beta(torch.full((20000,), 0.5), torch.tensor(3.0),
                               _gen(12)).numpy(),
                      lambda v: stats.beta.cdf(v, 0.5, 3.0))
    assert ks.pvalue > 1e-3, ks


@pytest.mark.parametrize("sequential", [False, True])
def test_vs_dirichlet_inclusion_frequencies(sequential):
    """Zero-count coordinates are included with vs_inclusion_prob's
    probability. Rows of one topic count 20 on coordinate 0 and zeros
    elsewhere, with a previous draw zero on 3 of 8 coordinates: the
    vectorised form includes each zero-count coordinate with p(zeroPhi =
    3, n_k = 20); the sequential chain's first zero-count coordinate
    (1, previously zero) sees the same p. Counted coordinates are always
    included, rows normalise, and the zero mask marks the exact zeros."""
    rows, v = 40_000, 8
    counts = torch.zeros((rows, v))
    counts[:, 0] = 20.0
    prev = torch.ones((rows, v))
    prev[:, [1, 4, 6]] = 0.0
    probs, zero = rnd.vs_dirichlet(counts, 0.1, 0.5, _gen(21),
                                   previous_phi=prev, sequential=sequential)
    p = float(rnd.vs_inclusion_prob(torch.tensor(3.0), torch.tensor(20.0),
                                    0.1, 0.5))
    assert 0.05 < p < 0.95
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(zero, probs == 0)
    assert not zero[:, 0].any()
    freq = (~zero).double().mean(0).numpy()
    se = (p * (1 - p) / rows) ** 0.5
    cols = [1] if sequential else range(1, v)
    for i in cols:
        assert abs(freq[i] - p) < 5 * se, (i, freq[i], p)
    # a dense previous draw (zeroPhi = 0) gives p = 0 exactly: the
    # vectorised form excludes every zero-count coordinate, the sequential
    # chain its first one (after which zeroPhi = 1)
    _, zero0 = rnd.vs_dirichlet(counts[:100], 0.1, 0.5, _gen(22),
                                sequential=sequential)
    excluded = zero0[:, 1] if sequential else zero0[:, 1:]
    assert excluded.all() and not zero0[:, 0].any()
