"""Geweke "getting it right" checks (Geweke 2004) of the PyTorch port, on
the CPU: the port's copies of tests/test_geweke.py's `test_geweke_ggs`,
its `ggs_test` negative control and `test_geweke_pcgs`.

A marginal-conditional simulator (ancestral draws of phi, theta, z, w) and
a successive-conditional chain (the port's `sample(1)` alternated with a
data-replication draw w ~ Cat(phi_z), fed back through
`swap_corpus_tokens`) must share every marginal if and only if the
transition leaves p(latents | w) invariant. The harness (statistics,
batch-means z-scores, thinned KS) is the JAX test's, unchanged; only the
model under it is the port's, through its plain sweep versions.
"""

import numpy as np
import pytest
from scipy import stats as sps

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model

# thousands of sampler steps per chain: the slow tier
pytestmark = pytest.mark.slow

D, L, V, K = 6, 8, 8, 2
ALPHA, BETA = 0.8, 0.6
VOCAB = [f"w{i}" for i in range(V)]
STATS = ["theta00", "phi00", "frac_z0", "frac_w0"]


def _stats(theta00, phi00, z, w):
    return (theta00, phi00, float(np.mean(z == 0)), float(np.mean(w == 0)))


def _mc_draws(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        phi = rng.dirichlet(np.full(V, BETA), K)          # [K, V]
        theta = rng.dirichlet(np.full(K, ALPHA), D)       # [D, K]
        z = np.array([rng.choice(K, p=theta[d]) for d in range(D)
                      for _ in range(L)])
        w = np.array([rng.choice(V, p=phi[k]) for k in z])
        out.append(_stats(theta[0, 0], phi[0, 0], z, w))
    return np.array(out)


def _resample_w(rng, phi, z):
    """w_i ~ Cat(phi[z_i]) vectorised (phi rows renormalised in f64)."""
    p = phi[z].astype(np.float64)
    cdf = np.cumsum(p, axis=1)
    u = rng.random(len(z)) * cdf[:, -1]
    return np.minimum((cdf <= u[:, None]).sum(axis=1), V - 1).astype(np.int32)


def _corpus(w):
    return Corpus.from_token_lists(
        [list(w[d * L:(d + 1) * L]) for d in range(D)], VOCAB)


def _sc_series(scheme, steps, burn, seed):
    """Post-burn-in series of the 4 statistics from one SC chain."""
    rng = np.random.default_rng(seed)
    phi0 = rng.dirichlet(np.full(V, BETA), K)
    theta0 = rng.dirichlet(np.full(K, ALPHA), D)
    z = np.array([rng.choice(K, p=theta0[d]) for d in range(D)
                  for _ in range(L)]).astype(np.int32)
    w = np.array([rng.choice(V, p=phi0[k]) for k in z], np.int32)
    m = create_model(LDAConfig(scheme=scheme, topics=K, alpha=ALPHA,
                               beta=BETA, seed=seed, exec_time=-1,
                               device="cpu"))
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    out = []
    for s in range(steps):
        m.sample(1)
        z = m.get_z_indicators()
        phi = m.get_phi()[:K]                              # [K, V]
        theta00 = (float(m.state.theta[0, 0])
                   if m.state.theta is not None else np.nan)
        if s >= burn:
            out.append(_stats(theta00, phi[0, 0], z, w))
        w = _resample_w(rng, phi, z)
        m.swap_corpus_tokens(_corpus(w))
    return np.array(out)


def _geweke_z(mc_col, sc_col, nbatch=20):
    """Mean-difference z-score with a batch-means SC standard error."""
    n = len(sc_col) // nbatch * nbatch
    bm = sc_col[:n].reshape(nbatch, -1).mean(axis=1)
    se2 = mc_col.var() / len(mc_col) + bm.var(ddof=1) / nbatch
    return float((mc_col.mean() - sc_col.mean()) / np.sqrt(se2))


def _agree(mc, sc, cols, label, zmax=5.0, ks_alpha=1e-4, thin=20):
    for i in cols:
        z = _geweke_z(mc[:, i], sc[:, i])
        assert abs(z) < zmax, (label, STATS[i], z,
                               mc[:, i].mean(), sc[:, i].mean())
        p = sps.ks_2samp(mc[:, i], sc[::thin, i]).pvalue
        assert p > ks_alpha, (label, STATS[i], p)


def test_geweke_ggs():
    """The port's GGS transition leaves the joint invariant: all four
    statistics agree."""
    mc = _mc_draws(4000, seed=101)
    sc = _sc_series("ggs", steps=2600, burn=200, seed=202)
    _agree(mc, sc, [0, 1, 2, 3], "ggs")


def test_geweke_ggs_test_variant_fails():
    """Negative control: the invalid `ggs_test` (stale theta) must fail
    the same check, so the harness has the power to reject a broken
    transition."""
    mc = _mc_draws(4000, seed=103)
    sc = _sc_series("ggs_test", steps=1200, burn=200, seed=204)
    zs = [abs(_geweke_z(mc[:, i], sc[:, i])) for i in range(4)]
    assert max(zs) > 10.0, zs


def test_geweke_pcgs():
    """The port's PCGS transition (the sweep with in-document n_dk
    updates, then phi | z, w) leaves the collapsed-theta joint invariant:
    phi_00, topic-0 fraction and word-0 frequency agree."""
    mc = _mc_draws(4000, seed=105)
    sc = _sc_series("pcgs", steps=2600, burn=200, seed=206)
    _agree(mc, sc, [1, 2, 3], "pcgs")
