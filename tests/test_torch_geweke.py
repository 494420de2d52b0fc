"""Geweke "getting it right" checks (Geweke 2004) of the PyTorch port, on
the CPU: the port's copies of tests/test_geweke.py's `test_geweke_ggs`,
its `ggs_test` negative control, `test_geweke_pcgs`, `test_geweke_cgs`,
`test_geweke_lightpclda`, `test_geweke_lightpclda_w2_count_proposal`,
`test_geweke_lightcollapsed`, `test_geweke_adlda_collapsed_interpret`,
`test_geweke_ggs_aliasmh`, `test_geweke_ggs_aliasmh_asym_alpha` with
its negative control, `test_geweke_uncollapsed_unsmoothed_phi_deviates`,
`test_geweke_nzvsspalias_sequential`, `test_geweke_polyaurn_phi_atoms`,
`test_geweke_hdp_all_topics`, `test_geweke_hdp_dynamic_birth_death` and
`test_geweke_hlda_dynamic_contiguous_growth`, each with the JAX test's
bars (the measured deviations of the reference's approximations pinned in
direction and size, as there).

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


def test_geweke_cgs():
    """The serial collapsed oracle (scheme `collapsed`): the collapsed
    z-sweep leaves p(z | w) invariant and the augmented phi / theta draws
    are exact conditionals, so all four statistics agree."""
    mc = _mc_draws(4000, seed=107)
    sc = _sc_series("collapsed", steps=2600, burn=200, seed=208)
    _agree(mc, sc, [0, 1, 2, 3], "collapsed")


def test_geweke_adlda():
    """Scheme `adlda` through the collapsed sweep's plain version. The
    JAX package's test (`test_geweke_adlda_collapsed_interpret`) pins a
    bounded bias, because its interpreted kernel draws each chunk against
    counts stale within the chunk. The port's plain version is the
    sequential chain, whose counts are never stale, so it is held to the
    exact-chain bar: phi_00, topic-0 fraction and word-0 frequency
    agree (phi is its diagnostic Dir(N_kw + beta) draw)."""
    mc = _mc_draws(4000, seed=503)
    sc = _sc_series("adlda", steps=2000, burn=200, seed=504)
    _agree(mc, sc, [1, 2, 3], "adlda")


def test_geweke_lightpclda():
    """LightLDA-style Metropolis-Hastings within Gibbs: the port's MH sweep
    (word proposal from phi, doc proposal from bf16(n_dk^-i + alpha)) must
    leave the target invariant, then phi | z, w. No theta in the MH
    family's state."""
    mc = _mc_draws(4000, seed=109)
    sc = _sc_series("lightpclda", steps=2600, burn=200, seed=210)
    _agree(mc, sc, [1, 2, 3], "lightpclda")


def test_geweke_lightpclda_w2_count_proposal():
    """Scheme `lightpcldaw2`: the word proposal comes from the sweep-entry
    type-topic counts N_kw + beta instead of phi, a different proposal
    whose acceptance ratio must still leave the target invariant."""
    mc = _mc_draws(4000, seed=307)
    sc = _sc_series("lightpcldaw2", steps=2000, burn=200, seed=308)
    _agree(mc, sc, [1, 2, 3], "lightpcldaw2")


def test_geweke_lightcollapsed():
    """Scheme `lightcollapsed`: the collapsed target with sweep-entry
    counts as word target and proposal. At this corpus size the sweep
    staleness is negligible and the transition must reproduce the joint
    (phi is its diagnostic Dir(N_kw + beta) draw)."""
    mc = _mc_draws(4000, seed=307)
    sc = _sc_series("lightcollapsed", steps=2000, burn=200, seed=310)
    _agree(mc, sc, [1, 2, 3], "lightcollapsed")


def test_geweke_ggs_aliasmh():
    """Scheme `ggs_aliasmh`: theta exact, z by count-proposal MH rounds
    from the sweep-entry z, phi exact. A valid MH-within-Gibbs kernel
    leaves the same joint invariant as exact GGS: all four statistics
    agree."""
    mc = _mc_draws(4000, seed=601)
    sc = _sc_series("ggs_aliasmh", steps=2600, burn=200, seed=602)
    _agree(mc, sc, [0, 1, 2, 3], "ggs_aliasmh")


# The symmetric-alpha run above cannot tell the uniform fallback's true
# density per topic (alpha_sum / K) from alpha_k: under a symmetric alpha
# they coincide. These runs use alpha = [0.3, 1.5], as tests/test_geweke.py.
ALPHA_VEC = np.array([0.3, 1.5])


def _mc_draws_asym(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        phi = rng.dirichlet(np.full(V, BETA), K)
        theta = rng.dirichlet(ALPHA_VEC, D)
        z = np.array([rng.choice(K, p=theta[d]) for d in range(D)
                      for _ in range(L)])
        w = np.array([rng.choice(V, p=phi[k]) for k in z])
        out.append(_stats(theta[0, 0], phi[0, 0], z, w))
    return np.array(out)


def _sc_series_asym(steps, burn, seed, buggy=False):
    """SC chain of the port's ggs_aliasmh with state.alpha = ALPHA_VEC.
    `buggy=True` patches the doc proposal's density to n_dk + alpha_k (the
    proposal itself still falls back uniformly), on the test side only:
    the negative control."""
    import torch

    from ldagroupedgibbssampler_tpu_torch.models import ggs_aliasmh as gam

    rng = np.random.default_rng(seed)
    phi0 = rng.dirichlet(np.full(V, BETA), K)
    theta0 = rng.dirichlet(ALPHA_VEC, D)
    z = np.array([rng.choice(K, p=theta0[d]) for d in range(D)
                  for _ in range(L)]).astype(np.int32)
    w = np.array([rng.choice(V, p=phi0[k]) for k in z], np.int32)
    m = create_model(LDAConfig(scheme="ggs_aliasmh", topics=K,
                               alpha=float(ALPHA_VEC.mean()), beta=BETA,
                               seed=seed, exec_time=-1, device="cpu"))
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    m.state.alpha = torch.as_tensor(ALPHA_VEC, dtype=torch.float32)

    orig = gam.alias_mh_rounds
    if buggy:
        a_corr = torch.as_tensor(ALPHA_VEC - ALPHA_VEC.sum() / K,
                                 dtype=torch.float32)

        def patched(zz, gw, gd, *rest, **kw):
            def gd2(k):
                t, q = gd(k)
                return t, q + a_corr[k]
            return orig(zz, gw, gd2, *rest, **kw)
        gam.alias_mh_rounds = patched
    try:
        out = []
        for s in range(steps):
            m.sample(1)
            z = m.get_z_indicators()
            phi = m.get_phi()[:K]
            theta00 = float(m.state.theta[0, 0])
            if s >= burn:
                out.append(_stats(theta00, phi[0, 0], z, w))
            w = _resample_w(rng, phi, z)
            m.swap_corpus_tokens(_corpus(w))
    finally:
        gam.alias_mh_rounds = orig
    return np.array(out)


def test_geweke_ggs_aliasmh_asym_alpha():
    """ggs_aliasmh under an asymmetric alpha = [0.3, 1.5]: the acceptance
    ratio's doc-proposal density must be the uniform fallback's true mass
    per topic, alpha_sum / K, for the chain to stay exact."""
    mc = _mc_draws_asym(4000, seed=811)
    sc = _sc_series_asym(steps=2600, burn=200, seed=812)
    _agree(mc, sc, [0, 1, 2, 3], "ggs_aliasmh_asym")


def test_geweke_ggs_aliasmh_asym_alpha_negative_control():
    """Power check: the density n_dk + alpha_k against the uniform
    fallback must fail the same check (the JAX test's bars: z below -8 on
    the topic-0 fraction and below -3.5 on theta_00)."""
    mc = _mc_draws_asym(4000, seed=811)
    sc = _sc_series_asym(steps=2600, burn=200, seed=813, buggy=True)
    z_frac = _geweke_z(mc[:, 2], sc[:, 2])
    z_th = _geweke_z(mc[:, 0], sc[:, 0])
    assert z_frac < -8.0, z_frac
    assert z_th < -3.5, z_th


def test_geweke_uncollapsed_unsmoothed_phi_deviates():
    """Negative control from the reference's own code comment: scheme
    `uncollapsed` draws phi ~ Dir(n_k) without beta smoothing
    (UncollapsedParallelLDA.java:1313-1315), so against the
    beta-smoothed joint its phi marginal must deviate."""
    mc = _mc_draws(4000, seed=111)
    sc = _sc_series("uncollapsed", steps=1200, burn=200, seed=212)
    zs = [abs(_geweke_z(mc[:, i], sc[:, i])) for i in [1, 2, 3]]
    assert max(zs) > 10.0, zs


def _sc_series_ex(scheme, steps, burn, seed, stat_fn, k_eff=K,
                  cfg_kw=None, model_patch=None):
    """tests/test_geweke.py::_sc_series_ex on the port: a custom topic
    count, config keys, a per-step statistic `stat_fn(model, phi, z, w)`
    and a hook that patches the model before add_instances."""
    rng = np.random.default_rng(seed)
    phi0 = rng.dirichlet(np.full(V, BETA), k_eff)
    theta0 = rng.dirichlet(np.full(k_eff, 1.0), D)
    z = np.array([rng.choice(k_eff, p=theta0[d]) for d in range(D)
                  for _ in range(L)]).astype(np.int32)
    w = np.array([rng.choice(V, p=phi0[k]) for k in z], np.int32)
    kw = dict(alpha=ALPHA, beta=BETA)
    kw.update(cfg_kw or {})
    m = create_model(LDAConfig(scheme=scheme, topics=k_eff, seed=seed,
                               exec_time=-1, device="cpu", **kw))
    if model_patch:
        model_patch(m)
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    out = []
    for s in range(steps):
        m.sample(1)
        z = m.get_z_indicators()
        phi = m.get_phi()[:k_eff]
        if s >= burn:
            out.append(stat_fn(m, phi, z, w))
        w = _resample_w(rng, phi, z)
        m.swap_corpus_tokens(_corpus(w))
    return np.array(out)


def _stats4(m, phi, z, w):
    return (phi[0, 0], float(np.mean(z == 0)), float(np.mean(w == 0)),
            float(np.mean(phi == 0.0)))


def test_geweke_nzvsspalias_sequential():
    """VS (spike-and-slab) phi with the reference's sequential zeroPhi
    chain (`vs_sequential = True`) against the spike-and-slab joint
    (I_kv ~ Bern(pi), rows conditioned nonempty, phi_k ~ Dir(beta) on the
    support). phi_00, topic-0 fraction and word-0 frequency agree; the
    phi zero fraction carries the JAX test's bounded bias (the reference
    counts currently-zero coordinates where the exact conditional would
    count included ones)."""
    pi = 0.5
    rng = np.random.default_rng(301)
    out = []
    for _ in range(4000):
        inc = rng.random((K, V)) < pi
        while not (inc.sum(axis=1) > 0).all():
            inc = rng.random((K, V)) < pi
        phi = np.zeros((K, V))
        for k in range(K):
            s = np.flatnonzero(inc[k])
            phi[k, s] = rng.dirichlet(np.full(len(s), BETA))
        theta = rng.dirichlet(np.full(K, ALPHA), D)
        z = np.array([rng.choice(K, p=theta[d]) for d in range(D)
                      for _ in range(L)])
        w = np.array([rng.choice(V, p=phi[k]) for k in z])
        out.append(_stats4(None, phi, z, w))
    mc = np.array(out)

    def patch(m):
        m.vs_sequential = True
    sc = _sc_series_ex("nzvsspalias", steps=2000, burn=200, seed=302,
                       stat_fn=_stats4, model_patch=patch)
    for i in (0, 1, 2):
        z = _geweke_z(mc[:, i], sc[:, i])
        assert abs(z) < 5.0, (i, z)
        assert sps.ks_2samp(mc[:, i], sc[::20, i]).pvalue > 1e-4, i
    z3 = _geweke_z(mc[:, 3], sc[:, 3])
    assert 0.0 < abs(z3) < 9.0, z3
    assert abs(mc[:, 3].mean() - sc[:, 3].mean()) < 0.05, (
        mc[:, 3].mean(), sc[:, 3].mean())


def test_geweke_polyaurn_phi_atoms():
    """Polya-Urn phi (normalised Poisson counts): every mean agrees with
    the plain-LDA joint (phi00, frac_z0, frac_w0), the z and word shapes
    agree, and phi00's shape deviates by its atom at exactly 0 (a phi zero
    fraction above 0.1, KS rejects), as the JAX test pins."""
    mc = _mc_draws(4000, seed=303)[:, [1, 2, 3]]
    sc = _sc_series_ex("polyaurn", steps=2000, burn=200, seed=304,
                       stat_fn=_stats4)
    for i in (0, 1, 2):
        z = _geweke_z(mc[:, i], sc[:, i])
        assert abs(z) < 5.0, (i, z)
    for i in (1, 2):
        assert sps.ks_2samp(mc[:, i], sc[::20, i]).pvalue > 1e-4, i
    assert sc[:, 3].mean() > 0.1, sc[:, 3].mean()
    assert sps.ks_2samp(mc[:, 0], sc[::20, 0]).pvalue < 1e-3


def test_geweke_hdp_all_topics():
    """`ppu_hdplda_all_topics`: truncated-GEM psi, the PCGS sweep with
    alpha0 psi as its alpha, Antoniak table counts, psi ~ GEM posterior,
    Polya-Urn phi, against psi from the truncated stick prior, phi ~
    Dir(beta), theta ~ Dir(alpha0 psi). psi_0, topic-0 fraction, word-0
    frequency and the phi00 mean agree; phi00's shape carries the
    Polya-Urn atom at zero."""
    kmax, alpha0, gamma = 4, 2.0, 1.0
    rng = np.random.default_rng(305)
    out = []
    for _ in range(4000):
        b = np.clip(rng.beta(1.0, gamma, kmax), 1e-7, 1 - 1e-7)
        psi = b * np.concatenate([[1.0], np.cumprod(1 - b)[:-1]])
        psi = psi / psi.sum()
        phi = rng.dirichlet(np.full(V, BETA), kmax)
        sh = rng.gamma(np.maximum(alpha0 * psi, 1e-8), 1.0, (D, kmax))
        theta = sh / np.maximum(sh.sum(axis=1, keepdims=True), 1e-300)
        z = np.array([rng.choice(kmax, p=theta[d]) for d in range(D)
                      for _ in range(L)])
        w = np.array([rng.choice(V, p=phi[k]) for k in z])
        out.append((phi[0, 0], float(np.mean(z == 0)),
                    float(np.mean(w == 0)), float(psi[0])))
    mc = np.array(out)

    def hdp_stats(m, phi, z, w):
        return (phi[0, 0], float(np.mean(z == 0)), float(np.mean(w == 0)),
                float(m.state.psi[0]))
    sc = _sc_series_ex("ppu_hdplda_all_topics", steps=2000, burn=200,
                       seed=306, stat_fn=hdp_stats, k_eff=kmax,
                       cfg_kw=dict(alpha=alpha0, hdp_gamma=gamma,
                                   hdp_start_topics=kmax))
    for i in range(4):
        z = _geweke_z(mc[:, i], sc[:, i])
        assert abs(z) < 5.0, (i, z)
    for i in (1, 2, 3):
        assert sps.ks_2samp(mc[:, i], sc[::20, i]).pvalue > 1e-4, i
    assert sps.ks_2samp(mc[:, 0], sc[::20, 0]).pvalue < 1e-3


HDP_KMAX, HDP_ALPHA0, HDP_GAMMA = 4, 2.0, 1.0


def _hdp_mc_draws(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = np.clip(rng.beta(1.0, HDP_GAMMA, HDP_KMAX), 1e-7, 1 - 1e-7)
        psi = b * np.concatenate([[1.0], np.cumprod(1 - b)[:-1]])
        psi = psi / psi.sum()
        phi = rng.dirichlet(np.full(V, BETA), HDP_KMAX)
        sh = rng.gamma(np.maximum(HDP_ALPHA0 * psi, 1e-8), 1.0,
                       (D, HDP_KMAX))
        theta = sh / np.maximum(sh.sum(axis=1, keepdims=True), 1e-300)
        z = np.array([rng.choice(HDP_KMAX, p=theta[d]) for d in range(D)
                      for _ in range(L)])
        w = np.array([rng.choice(V, p=phi[k]) for k in z])
        out.append((phi[0, 0], float(np.mean(z == 0)),
                    float(np.mean(w == 0)), float(psi[0]),
                    float(len(np.unique(z)))))
    return np.array(out)


def _hdp_sc_series(scheme, steps, burn, seed):
    """The dynamic HDP chains from a truncated-GEM ancestral start, all
    K_max topics active; statistics (phi00, frac_z0, frac_w0, psi0,
    occupied topics)."""
    rng = np.random.default_rng(seed)
    b = np.clip(rng.beta(1.0, HDP_GAMMA, HDP_KMAX), 1e-7, 1 - 1e-7)
    psi0 = b * np.concatenate([[1.0], np.cumprod(1 - b)[:-1]])
    psi0 = psi0 / psi0.sum()
    phi0 = rng.dirichlet(np.full(V, BETA), HDP_KMAX)
    sh = rng.gamma(np.maximum(HDP_ALPHA0 * psi0, 1e-8), 1.0, (D, HDP_KMAX))
    theta0 = sh / sh.sum(axis=1, keepdims=True)
    z = np.array([rng.choice(HDP_KMAX, p=theta0[d]) for d in range(D)
                  for _ in range(L)]).astype(np.int32)
    w = np.array([rng.choice(V, p=phi0[k]) for k in z], np.int32)
    m = create_model(LDAConfig(scheme=scheme, topics=HDP_KMAX,
                               alpha=HDP_ALPHA0, beta=BETA, seed=seed,
                               exec_time=-1, hdp_gamma=HDP_GAMMA,
                               hdp_start_topics=HDP_KMAX, device="cpu"))
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    out = []
    for s in range(steps):
        m.sample(1)
        z = m.get_z_indicators()
        phi = m.get_phi()[:HDP_KMAX]
        if s >= burn:
            out.append((phi[0, 0], float(np.mean(z == 0)),
                        float(np.mean(w == 0)), float(m.state.psi[0]),
                        float(len(np.unique(z)))))
        # after a sweep no token sits on a dead (phi-zeroed) topic, so
        # the data-replication draw is well defined
        w = _resample_w(rng, phi, z)
        m.swap_corpus_tokens(_corpus(w))
    return np.array(out)


def test_geweke_hdp_dynamic_birth_death():
    """`ppu_hdplda`: phi00 and frac_w0 agree with the truncated-GEM joint;
    the birth and death policy concentrates topic mass (fewer occupied
    topics, psi_0 and frac_z0 above the ancestral draw), pinned in
    direction and size as the JAX test pins it."""
    mc = _hdp_mc_draws(4000, 601)
    sc = _hdp_sc_series("ppu_hdplda", steps=2000, burn=200, seed=602)
    for i in (0, 2):
        z = _geweke_z(mc[:, i], sc[:, i])
        assert abs(z) < 5.0, (i, z)
    z_occ = _geweke_z(mc[:, 4], sc[:, 4])
    assert z_occ > 8.0, z_occ
    assert 1.0 <= sc[:, 4].mean() < mc[:, 4].mean(), sc[:, 4].mean()
    assert sc[:, 3].mean() > mc[:, 3].mean()
    assert sc[:, 1].mean() > mc[:, 1].mean()


def test_geweke_hlda_dynamic_contiguous_growth():
    """`ppu_hlda`: frac_w0 agrees; the Poisson psi with contiguous
    rebirth spreads topic mass (psi_0 and frac_z0 below the size-ordered
    GEM draw, occupancy close), pinned as the JAX test pins it."""
    mc = _hdp_mc_draws(4000, 601)
    sc = _hdp_sc_series("ppu_hlda", steps=2000, burn=200, seed=602)
    z_w0 = _geweke_z(mc[:, 2], sc[:, 2])
    assert abs(z_w0) < 5.0, z_w0
    z_psi = _geweke_z(mc[:, 3], sc[:, 3])
    assert z_psi > 5.0, z_psi
    assert sc[:, 3].mean() < mc[:, 3].mean()
    z_z0 = _geweke_z(mc[:, 1], sc[:, 1])
    assert z_z0 > 5.0, z_z0
    z_occ = _geweke_z(mc[:, 4], sc[:, 4])
    assert abs(z_occ) < 8.0, z_occ
    assert sc[:, 4].mean() >= mc[:, 4].mean() - 0.5
