"""The chain-level checks of the port, tools/card_geweke_check.py (Geweke
"getting it right" chains through every sampling kernel) and
tools/card_bf16_gate.py (the bf16 z-draw against precise seeds), on the
CPU at a cut size: the harness is the JAX test's bit for bit, the
predictive interval is the JAX script's, both tools run end to end and
report what they check, every launch counter is named by a chain, and a
`cuda` request without a card raises. The chains at full length run on
the card (chip_smoke.py phase 9) and, through the plain versions, in
tests/test_torch_geweke.py's slow tier."""

import functools
import json

import numpy as np
import pytest
import torch
from scipy import stats as sps

import test_geweke as jax_harness
from ldagroupedgibbssampler_tpu_torch.models.fusion import launch_counters
from tools import card_bf16_gate as gate
from tools import card_geweke_check as cg


@pytest.mark.parametrize("name, seed", [("_mc_draws", 101),
                                        ("_mc_draws_asym", 811),
                                        ("_hdp_mc_draws", 601)])
def test_mc_simulators_bit_equal_to_the_jax_harness(name, seed):
    ours = getattr(cg, name)(40, seed)
    theirs = getattr(jax_harness, name)(40, seed)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs,
                                                         equal_nan=True)


def test_geweke_z_and_resampling_bit_equal_to_the_jax_harness():
    rng = np.random.default_rng(7)
    mc, sc = rng.normal(0.3, 1.0, 400), rng.normal(0.0, 2.0, 1237)
    assert cg._geweke_z(mc, sc) == jax_harness._geweke_z(mc, sc)
    assert cg._geweke_z(mc, sc, 7) == jax_harness._geweke_z(mc, sc, 7)
    phi = rng.dirichlet(np.full(cg.V, 0.6), cg.K).astype(np.float32)
    z = rng.integers(0, cg.K, cg.D * cg.L)
    assert np.array_equal(
        cg._resample_w(np.random.default_rng(3), phi, z),
        jax_harness._resample_w(np.random.default_rng(3), phi, z))


def test_stat_table_is_the_harness_statistics():
    rng = np.random.default_rng(11)
    mc, sc = rng.random((300, 4)), rng.random((900, 4))
    t = cg.stat_table(mc, sc, cg.S3)
    assert list(t) == ["phi00", "frac_z0", "frac_w0"]
    assert t["frac_z0"]["z"] == cg._geweke_z(mc[:, 2], sc[:, 2])
    assert t["frac_w0"]["ks_p"] == sps.ks_2samp(mc[:, 3],
                                                sc[::20, 3]).pvalue


def test_t_quantile_is_scipys():
    assert gate.T_CRIT_995_DF5 == pytest.approx(sps.t.ppf(0.995, 5),
                                                abs=1e-3)
    assert gate.N_PRECISE_SEEDS - 1 == 5


def _half_width(values):
    pv = np.asarray(values, float)
    return 4.032 * pv.std(ddof=1) * np.sqrt(1.0 + 1.0 / len(pv))


@pytest.mark.parametrize("offset, passes", [(0.0, True), (0.999, True),
                                            (-0.999, True), (1.001, False),
                                            (-1.001, False), (3.0, False)])
def test_predictive_check_at_the_interval_edge(offset, passes):
    precise = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]      # mean 3.5, sd 1.8708
    half = _half_width(precise)
    assert half == pytest.approx(4.032 * 1.8708287 * 1.0801234, rel=1e-6)
    c = gate.predictive_check(3.5 + offset * half, precise)
    assert c["pass"] is passes
    assert c["precise_mean"] == 3.5 and c["df"] == 5
    assert c["interval_half_width"] == pytest.approx(half, rel=1e-12)
    assert c["abs_delta"] == pytest.approx(abs(offset) * half, rel=1e-12)
    assert c["t_stat"] == pytest.approx(abs(offset) * 4.032, rel=1e-9)


def test_bf16_seed_is_not_a_precise_seed():
    # a chain's seed fixes its initial z and its kernel keys: a precise
    # chain of the bf16 chain's seed would be its near-twin, not an
    # independent member of the ensemble
    assert gate.BF16_SEED not in gate.PRECISE_SEEDS
    assert len(set(gate.PRECISE_SEEDS)) == gate.N_PRECISE_SEEDS
    assert 0 not in gate.PRECISE_SEEDS + (gate.BF16_SEED,)   # the clock


def test_predictive_check_of_a_constant_ensemble():
    assert gate.predictive_check(2.0, [2.0] * 6)["pass"]
    assert not gate.predictive_check(2.001, [2.0] * 6)["pass"]


def test_gini_of_topic_sizes():
    assert gate.nk_gini([5.0, 5.0, 5.0]) == 0.0
    # one topic holds everything: mean |x_i - x_j| = 2 * 9 / 9, over 2 * 3
    assert gate.nk_gini([9.0, 0.0, 0.0]) == pytest.approx(2.0 / 3.0)


def test_geweke_check_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "geweke.json"
    rc = cg.main(["--device", "cpu", "--chains", "ggs_bf16,pcgs",
                  "--steps", "60", "--burn", "20", "--draws", "200",
                  "--out", str(out)])
    assert rc in (0, 1)
    reports = json.loads(out.read_text())
    assert [r["name"] for r in reports] == ["ggs_bf16", "pcgs"]
    for r in reports:
        assert r["steps"] == 60 and r["burn"] == 20
        assert r["device"] == "cpu" and r["seconds"] > 0
        assert r["counters_missing"] == []       # held on the card only
        assert r["checks"] and all(np.isfinite(s["z"]) and 0 <= s["ks_p"]
                                   for s in r["stats"].values())
    assert list(reports[0]["stats"]) == cg.STATS
    assert list(reports[1]["stats"]) == cg.STATS[1:]
    text = capsys.readouterr().out
    assert "ggs_bf16: theta00 z=" in text and "(60 steps" in text
    assert "Geweke check" in text


def test_seed_sweep_reports_bar_shares_on_the_cpu(capsys):
    rc = cg.main(["--device", "cpu", "--chains", "ppu_hdplda_all_topics",
                  "--seeds", "306,307", "--steps", "60", "--burn", "20",
                  "--draws", "200"])
    assert rc in (0, 1)
    text = capsys.readouterr().out
    assert "ppu_hdplda_all_topics seed 307: phi00 z=" in text
    assert "(60 steps" in text               # the pinned chain cut too
    for thin in cg.SWEEP_THINS:
        assert (f"ppu_hdplda_all_topics (cpu, 60 steps, 2 seeds) thinned "
                f"by {thin}, the share of (seed, offset) pairs") in text
    assert "mean z over the seeds (how many positive): phi00" in text


def test_offset_checks_count_each_thinning_offset():
    c = cg.CHAINS["pcgs"]
    rng = np.random.default_rng(5)
    mc, sc = rng.random((300, 4)), rng.random((400, 4))
    met = cg.offset_checks(c, mc, sc, 4)
    bars = [bar for bar, _ in c.judge(cg.stat_table(mc, sc, c.stats), mc,
                                      sc)]
    assert list(met) == bars and all(0 <= n <= 4 for n in met.values())
    # one offset: the judge's verdict on the series thinned by 1
    alone = dict(c.judge(cg.stat_table(mc, sc, c.stats, thin=1), mc, sc))
    assert cg.offset_checks(c, mc, sc, 1) == {b: int(ok)
                                              for b, ok in alone.items()}


def test_steps_cut_only_the_exact_chains():
    for c in cg.CHAINS.values():
        steps, burn = cg.chain_length(c, 1400, 100)
        if c.kind == "exact":
            assert (steps, burn) == (1400, 100)
        else:
            assert (steps, burn) == (c.steps, c.burn)
        assert cg.chain_length(c) == (c.steps, c.burn)
    assert {n for n, c in cg.CHAINS.items() if c.kind == "power"} == {
        "ggs_test", "uncollapsed"}


def test_bf16_gate_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "gate.json"
    rc = gate.main(["--device", "cpu", "--docs", "60", "--topics", "5",
                    "--iters", "4", "--ll-every", "2", "--particles", "5",
                    "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == (0 if report["gate_pass"] else 1)
    assert sorted(report["checks"]) == sorted(gate.CHECKS)
    assert len(report["runs"]) == 1 + gate.N_PRECISE_SEEDS
    for c in report["checks"].values():
        assert np.isfinite(c["bf16"]) and c["n_precise_seeds"] == 6
    bf16 = report["runs"][f"bf16_seed{gate.BF16_SEED}"]
    assert len(bf16["ll_traj"]) == 2 and bf16["held_out_ll"] < 0
    text = capsys.readouterr().out
    assert "held_out_ll: bf16" in text and "half-width" in text


def test_every_launch_counter_is_named_by_a_chain_or_the_gate():
    names = {fn.__name__ + ("" if attr == "launches" else " collapsed")
             for fn, attr in launch_counters()}
    chained = set().union(*(c.counters for c in cg.CHAINS.values()))
    assert chained <= names and set(gate.COUNTERS) <= names
    assert set(cg.UNCHAINED_COUNTERS) == names - chained
    assert sorted(names - chained - set(gate.COUNTERS)) == [
        "binomial", "pairwise_elementwise", "pairwise_ks", "poisson"]
    assert all(cg.UNCHAINED_COUNTERS.values())


GEM_TABLES = ((0, 0, 0, 0), (10, 0, 0, 0), (5, 5, 5, 5))
GEM_DRAWS = 20_000


def _truncated_gem_psi0(tables, n, seed):
    """E[psi_0 | tables] and its standard error under the truncated,
    renormalised stick prior of `_hdp_mc_draws` (K_max sticks nu_k ~
    Beta(1, gamma), psi the sticks' masses over their sum): prior draws
    weighted by prod_k psi_k^l_k."""
    rng = np.random.default_rng(seed)
    b = np.clip(rng.beta(1.0, cg.HDP_GAMMA, (n, len(tables))), 1e-7,
                1 - 1e-7)
    raw = b * np.concatenate([np.ones((n, 1)),
                              np.cumprod(1 - b, axis=1)[:, :-1]], axis=1)
    psi0 = raw[:, 0] / raw.sum(axis=1)
    logw = np.log(raw / raw.sum(axis=1, keepdims=True)) @ np.asarray(
        tables, float)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    mean = float(w @ psi0)
    return mean, float(np.sqrt(w @ (psi0 - mean) ** 2 * (w @ w)))


@functools.cache
def _gem_psi0_draws():
    """psi_0 of GEM_DRAWS psi steps for each row of GEM_TABLES, from the
    port's `gem_psi` and from the JAX package's."""
    import jax
    import jax.numpy as jnp

    from ldagroupedgibbssampler_tpu.models import hdp as jax_hdp
    from ldagroupedgibbssampler_tpu_torch.models import hdp as port_hdp

    rows = np.repeat(np.asarray(GEM_TABLES, np.float32), GEM_DRAWS, axis=0)
    port = port_hdp.gem_psi(torch.from_numpy(rows), cg.HDP_GAMMA,
                            torch.Generator().manual_seed(1))[:, 0].numpy()
    keys = jax.random.split(jax.random.PRNGKey(2), len(rows))
    theirs = np.asarray(jax.jit(jax.vmap(
        lambda k, t: jax_hdp.gem_psi(k, t, cg.HDP_GAMMA)))(
            keys, jnp.asarray(rows))[:, 0])
    return (port.reshape(len(GEM_TABLES), -1),
            theirs.reshape(len(GEM_TABLES), -1))


@pytest.mark.parametrize("row", range(len(GEM_TABLES)))
def test_gem_psi_step_omits_the_truncation_factor_in_both_packages(row):
    """The all-topics HDP psi step (`gem_psi` in both packages, after the
    reference's GEMBasedPsiSampler) draws nu_k ~ Beta(1 + l_k, gamma +
    sum_{j>k} l_j) and renormalises the K_max sticks. Under the truncated,
    renormalised prior that `_hdp_mc_draws` and the chain's first psi
    use, the exact posterior given the tables carries one more factor,
    (the sticks' sum)^-L with L = sum_k l_k, which the step leaves out:
    with tables it gives psi_0 more than the exact posterior (~0.006 at
    these rows), the two packages alike; with none it draws the prior.
    This is why the ppu_hdplda_all_topics chains' psi0 and frac_z0 sit
    above the MC draws on the CPU and on the card."""
    tables = GEM_TABLES[row]
    exact, exact_se = _truncated_gem_psi0(tables, 400_000, row)
    for got in (d[row] for d in _gem_psi0_draws()):
        se = float(np.hypot(got.std() / np.sqrt(len(got)), exact_se))
        gap = float(got.mean()) - exact
        if sum(tables) == 0:       # the prior: no factor to leave out
            assert abs(gap) < 4 * se, (gap, se)
        else:
            assert 6 * se < gap < 0.02, (gap, se)
    port, theirs = (d[row] for d in _gem_psi0_draws())
    assert abs(port.mean() - theirs.mean()) < 4 * np.hypot(
        port.std(), theirs.std()) / np.sqrt(GEM_DRAWS)


@pytest.mark.parametrize("tool", ["geweke", "gate"])
def test_cuda_request_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = cg.main if tool == "geweke" else gate.main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--device", "cuda"])
