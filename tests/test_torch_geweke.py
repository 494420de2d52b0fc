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
direction and size, as there); and two chains of the card's check with no
JAX counterpart: the vectorised VS rows, run in both packages, and
`spalias_priors`.

A marginal-conditional simulator (ancestral draws of phi, theta, z, w) and
a successive-conditional chain (the port's `sample(1)` alternated with a
data-replication draw w ~ Cat(phi_z), fed back through
`swap_corpus_tokens`) must share every marginal if and only if the
transition leaves p(latents | w) invariant. The harness (statistics,
batch-means z-scores, thinned KS) is the JAX test's, unchanged, and lives
in tools/card_geweke_check.py, which runs the same chains on the card;
only the model under it is the port's, here through its plain versions.
"""

import pytest
from scipy import stats as sps

from tools.card_geweke_check import (HDP_ALPHA0, HDP_GAMMA, HDP_KMAX, SV,
                                     _agree, _geweke_z, _hdp_mc_draws,
                                     _hdp_sc_series, _hdp_stats,
                                     _judge_nzvs, _mc_draws, _mc_draws_asym,
                                     _sc_series, _sc_series_asym,
                                     _sc_series_ex, _stats4, _vs_mc_draws,
                                     stat_table)

# thousands of sampler steps per chain: the slow tier
pytestmark = pytest.mark.slow

CPU = "cpu"


def test_geweke_ggs():
    """The port's GGS transition leaves the joint invariant: all four
    statistics agree."""
    mc = _mc_draws(4000, seed=101)
    sc = _sc_series("ggs", steps=2600, burn=200, seed=202, device=CPU)
    _agree(mc, sc, [0, 1, 2, 3], "ggs")


def test_geweke_ggs_test_variant_fails():
    """Negative control: the invalid `ggs_test` (stale theta) must fail
    the same check, so the harness has the power to reject a broken
    transition."""
    mc = _mc_draws(4000, seed=103)
    sc = _sc_series("ggs_test", steps=1200, burn=200, seed=204, device=CPU)
    zs = [abs(_geweke_z(mc[:, i], sc[:, i])) for i in range(4)]
    assert max(zs) > 10.0, zs


def test_geweke_pcgs():
    """The port's PCGS transition (the sweep with in-document n_dk
    updates, then phi | z, w) leaves the collapsed-theta joint invariant:
    phi_00, topic-0 fraction and word-0 frequency agree."""
    mc = _mc_draws(4000, seed=105)
    sc = _sc_series("pcgs", steps=2600, burn=200, seed=206, device=CPU)
    _agree(mc, sc, [1, 2, 3], "pcgs")


def test_geweke_cgs():
    """The serial collapsed oracle (scheme `collapsed`): the collapsed
    z-sweep leaves p(z | w) invariant and the augmented phi / theta draws
    are exact conditionals, so all four statistics agree."""
    mc = _mc_draws(4000, seed=107)
    sc = _sc_series("collapsed", steps=2600, burn=200, seed=208, device=CPU)
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
    sc = _sc_series("adlda", steps=2000, burn=200, seed=504, device=CPU)
    _agree(mc, sc, [1, 2, 3], "adlda")


def test_geweke_lightpclda():
    """LightLDA-style Metropolis-Hastings within Gibbs: the port's MH sweep
    (word proposal from phi, doc proposal from bf16(n_dk^-i + alpha)) must
    leave the target invariant, then phi | z, w. No theta in the MH
    family's state."""
    mc = _mc_draws(4000, seed=109)
    sc = _sc_series("lightpclda", steps=2600, burn=200, seed=210, device=CPU)
    _agree(mc, sc, [1, 2, 3], "lightpclda")


def test_geweke_lightpclda_w2_count_proposal():
    """Scheme `lightpcldaw2`: the word proposal comes from the sweep-entry
    type-topic counts N_kw + beta instead of phi, a different proposal
    whose acceptance ratio must still leave the target invariant."""
    mc = _mc_draws(4000, seed=307)
    sc = _sc_series("lightpcldaw2", steps=2000, burn=200, seed=308, device=CPU)
    _agree(mc, sc, [1, 2, 3], "lightpcldaw2")


def test_geweke_lightcollapsed():
    """Scheme `lightcollapsed`: the collapsed target with sweep-entry
    counts as word target and proposal. At this corpus size the sweep
    staleness is negligible and the transition must reproduce the joint
    (phi is its diagnostic Dir(N_kw + beta) draw)."""
    mc = _mc_draws(4000, seed=307)
    sc = _sc_series("lightcollapsed", steps=2000, burn=200, seed=310,
                    device=CPU)
    _agree(mc, sc, [1, 2, 3], "lightcollapsed")


def test_geweke_ggs_aliasmh():
    """Scheme `ggs_aliasmh`: theta exact, z by count-proposal MH rounds
    from the sweep-entry z, phi exact. A valid MH-within-Gibbs kernel
    leaves the same joint invariant as exact GGS: all four statistics
    agree."""
    mc = _mc_draws(4000, seed=601)
    sc = _sc_series("ggs_aliasmh", steps=2600, burn=200, seed=602,
                        device=CPU)
    _agree(mc, sc, [0, 1, 2, 3], "ggs_aliasmh")


# The symmetric-alpha run above cannot tell the uniform fallback's true
# density per topic (alpha_sum / K) from alpha_k: under a symmetric alpha
# they coincide. These runs use alpha = [0.3, 1.5] (the harness's
# ALPHA_VEC), as tests/test_geweke.py.
def test_geweke_ggs_aliasmh_asym_alpha():
    """ggs_aliasmh under an asymmetric alpha = [0.3, 1.5]: the acceptance
    ratio's doc-proposal density must be the uniform fallback's true mass
    per topic, alpha_sum / K, for the chain to stay exact."""
    mc = _mc_draws_asym(4000, seed=811)
    sc = _sc_series_asym(steps=2600, burn=200, seed=812, device=CPU)
    _agree(mc, sc, [0, 1, 2, 3], "ggs_aliasmh_asym")


def test_geweke_ggs_aliasmh_asym_alpha_negative_control():
    """Power check: the density n_dk + alpha_k against the uniform
    fallback must fail the same check (the JAX test's bars: z below -8 on
    the topic-0 fraction and below -3.5 on theta_00)."""
    mc = _mc_draws_asym(4000, seed=811)
    sc = _sc_series_asym(steps=2600, burn=200, seed=813, device=CPU,
                         buggy=True)
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
    sc = _sc_series("uncollapsed", steps=1200, burn=200, seed=212,
                    device=CPU)
    zs = [abs(_geweke_z(mc[:, i], sc[:, i])) for i in [1, 2, 3]]
    assert max(zs) > 10.0, zs


def test_geweke_nzvsspalias_sequential():
    """VS (spike-and-slab) phi with the reference's sequential zeroPhi
    chain (`vs_sequential = True`) against the spike-and-slab joint
    (I_kv ~ Bern(pi), rows conditioned nonempty, phi_k ~ Dir(beta) on the
    support). phi_00, topic-0 fraction and word-0 frequency agree; the
    phi zero fraction carries the JAX test's bounded bias (the reference
    counts currently-zero coordinates where the exact conditional would
    count included ones)."""
    mc = _vs_mc_draws(4000, 301)

    def patch(m):
        m.vs_sequential = True
    sc = _sc_series_ex("nzvsspalias", steps=2000, burn=200, seed=302,
                       stat_fn=_stats4, device=CPU, model_patch=patch)
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
                       stat_fn=_stats4, device=CPU)
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
    mc = _hdp_mc_draws(4000, 305)[:, :4]
    sc = _sc_series_ex("ppu_hdplda_all_topics", steps=2000, burn=200,
                       seed=306, stat_fn=_hdp_stats, device=CPU,
                       k_eff=HDP_KMAX,
                       cfg_kw=dict(alpha=HDP_ALPHA0, hdp_gamma=HDP_GAMMA,
                                   hdp_start_topics=HDP_KMAX))
    for i in range(4):
        z = _geweke_z(mc[:, i], sc[:, i])
        assert abs(z) < 5.0, (i, z)
    for i in (1, 2, 3):
        assert sps.ks_2samp(mc[:, i], sc[::20, i]).pvalue > 1e-4, i
    assert sps.ks_2samp(mc[:, 0], sc[::20, 0]).pvalue < 1e-3


def test_geweke_hdp_dynamic_birth_death():
    """`ppu_hdplda`: phi00 and frac_w0 agree with the truncated-GEM joint;
    the birth and death policy concentrates topic mass (fewer occupied
    topics, psi_0 and frac_z0 above the ancestral draw), pinned in
    direction and size as the JAX test pins it."""
    mc = _hdp_mc_draws(4000, 601)
    sc = _hdp_sc_series("ppu_hdplda", steps=2000, burn=200, seed=602,
                        device=CPU)
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
    sc = _hdp_sc_series("ppu_hlda", steps=2000, burn=200, seed=602,
                        device=CPU)
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


def test_geweke_nzvsspalias_vectorised():
    """The vectorised VS rows (`vs_sequential = False`, the default; on
    the card the kernel of csrc/vs_dirichlet.cu), in both packages
    through the same harness at the sequential test's seeds and length:
    phi_00, topic-0 fraction and word-0 frequency agree, and the phi zero
    fraction carries the same kind of bounded bias as the sequential
    chain, pinned in direction and size (SC below MC: 0 < z < 9, a gap
    of 0 to 0.05). The card's chain is held to these bars
    (tools/card_geweke_check.py::_judge_nzvs)."""
    import test_geweke as jax_harness

    mc = _vs_mc_draws(4000, 301)
    sc_port = _sc_series_ex("nzvsspalias", steps=2000, burn=200, seed=302,
                            stat_fn=_stats4, device=CPU)
    sc_jax = jax_harness._sc_series_ex("nzvsspalias", steps=2000, burn=200,
                                       seed=302, stat_fn=jax_harness._stats4)
    for label, sc in (("port", sc_port), ("jax", sc_jax)):
        table = stat_table(mc, sc, SV)
        failed = [bar for bar, ok in _judge_nzvs(table, mc, sc) if not ok]
        assert not failed, (label, failed, table)


def test_geweke_spalias_priors():
    """Scheme `spalias_priors` without a prior file: phi ~ Dir(N_k + beta)
    through the elementwise Gamma draw (on the card the Gamma kernel, the
    only scheme step that launches it), then the PCGS sweep: phi_00,
    topic-0 fraction and word-0 frequency agree."""
    mc = _mc_draws(4000, seed=113)
    sc = _sc_series("spalias_priors", steps=2000, burn=200, seed=214,
                    device=CPU)
    _agree(mc, sc, [1, 2, 3], "spalias_priors")


class _TruncatedGemPsi:
    """The all-topics psi step made exact for the truncated, renormalised
    stick prior: an independence Metropolis-Hastings step whose proposal
    is `gem_psi`'s draw (nu_k ~ Beta(1 + l_k, gamma + sum_{j>k} l_j), the
    K_max sticks renormalised) and whose target carries the factor that
    draw leaves out, (the sticks' sum S)^-L with L = sum_k l_k. It accepts
    with probability min(1, (S / S')^L), S the current sticks' sum and S'
    the proposal's; a draw with no tables (the chain's first) is taken."""

    def __init__(self):
        self.current = None       # (S, psi)

    def __call__(self, tables, gamma, generator):
        import torch

        from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

        rest = tables.flip(-1).cumsum(dim=-1).flip(-1) - tables
        b = rnd.beta(1.0 + tables, gamma + rest.clamp_min(0.0) + 1e-30,
                     generator).clamp(1e-7, 1.0 - 1e-7)
        log1m = torch.log1p(-b)
        raw = torch.exp(torch.log(b) + torch.cumsum(log1m, dim=-1) - log1m)
        s_new = raw.sum()
        tables_n = float(tables.sum())
        if self.current is not None and tables_n > 0:
            s_old, psi_old = self.current
            u = float(torch.rand((), generator=generator))
            if u >= float(s_old / s_new) ** tables_n:
                return psi_old
        self.current = (s_new, raw / s_new)
        return raw / s_new


@pytest.mark.parametrize("restored", [False, True],
                         ids=["gem_step", "truncation_restored"])
def test_geweke_hdp_all_topics_psi_drift(restored, monkeypatch):
    """`ppu_hdplda_all_topics`' psi0 and topic-0 fraction sit above the
    MC draws: over SC seeds 306-321 at the chain's 2000 steps the mean z
    (MC minus SC) of each is below -1. The psi step is the cause: made
    exact for the truncated prior (`_TruncatedGemPsi`), the same chains
    lose the drift (|mean z| < 1). Both packages' `gem_psi` leave the
    same factor out (tests/test_torch_card_quality.py::
    test_gem_psi_step_omits_the_truncation_factor_in_both_packages); the
    card's chain drifts as the CPU's does (PERF.md §6)."""
    import numpy as np
    import torch

    from ldagroupedgibbssampler_tpu_torch.models import hdp as port_hdp

    if restored:
        monkeypatch.setattr(port_hdp, "gem_psi", _TruncatedGemPsi())
    # sixteen chains of tiny steps: one host thread is several times
    # faster than a thread pool per op
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mc = _hdp_mc_draws(4000, 305)[:, :4]
    zs = []
    try:
        for seed in range(306, 322):
            sc = _sc_series_ex("ppu_hdplda_all_topics", steps=2000,
                               burn=200, seed=seed, stat_fn=_hdp_stats,
                               device=CPU, k_eff=HDP_KMAX,
                               cfg_kw=dict(alpha=HDP_ALPHA0,
                                           hdp_gamma=HDP_GAMMA,
                                           hdp_start_topics=HDP_KMAX))
            zs.append([_geweke_z(mc[:, i], sc[:, i]) for i in (1, 3)])
    finally:
        torch.set_num_threads(threads)
    mean = np.mean(zs, axis=0)            # frac_z0, psi0
    print(f"mean z over the seeds: frac_z0 {mean[0]:+.2f}, psi0 "
          f"{mean[1]:+.2f}")
    if restored:
        assert np.all(np.abs(mean) < 1.0), (mean, zs)
    else:
        assert np.all(mean < -1.0), (mean, zs)
