#!/usr/bin/env python3
"""Geweke "getting it right" checks (Geweke 2004) of the port's sampling
kernels, on the card or on the CPU: the port of the JAX package's
benchmarks/tpu_geweke_check.py, widened to every sampling kernel.

A marginal-conditional simulator (ancestral draws of phi, theta, z, w) and
a successive-conditional chain (the port's `sample(1)` alternated with a
data-replication draw w ~ Cat(phi_z), fed back through
`swap_corpus_tokens`) must share every marginal if and only if the
transition leaves p(latents | w) invariant. The harness (the statistics,
the batch-means z-score, the thinned KS) is tests/test_geweke.py's,
unchanged; tests/test_torch_geweke.py runs the same harness on the CPU,
where the port's plain versions draw.

On the card the chain runs the kernels: the in-kernel Philox keys drawn
once a call from the chain's generator, the bf16 z-draw, the layouts
rebuilt by every `swap_corpus_tokens`, the streamed layouts forced at
K=2, the parallel launch of the collapsed sweep, the vectorised VS rows
and the HDP step's launches. Each chain of CHAINS names the launch
counters (`models/fusion.py::launch_counters`) its steps must move; on the
card a chain whose named counters did not all rise over its `sample(1)`
calls fails, as does one that misses its bar. Each bar is the bar of the
chain's CPU counterpart in tests/test_torch_geweke.py, at its length but
for ppu_hdplda_all_topics (HDP_ALL_TOPICS_STEPS).

Run from the repository root:

    python3 tools/card_geweke_check.py [--device cuda|cpu] [--chains a,b]
        [--steps N] [--burn N] [--draws N] [--jobs N] [--seeds a-b]
        [--out FILE]

`--steps` and `--burn` apply to the chains held to the exact bar only; a
control or a chain whose bar pins a deviation keeps its own length.
`--draws` sets the marginal-conditional draws (4000 by default).
`--jobs` runs the chains in that many spawned processes. A `cuda` request
without a card raises. Prints one line a chain (its statistics, steps and
seconds) and exits non-zero if any chain fails.

`--seeds a-b` (or `a,b,c`) measures how often the chains meet their bars:
each chain runs at each of those successive-conditional seeds (its
marginal-conditional draws stay the table's), `--steps` and `--burn` then
set the length of every chain, and the last lines give, for each chain
and bar, the share of (seed, offset) pairs that meet it when the series
is read from each offset of its thinning by 20 (as the bars read it) and
by 10, and each statistic's mean z over the seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Callable

import numpy as np
from scipy import stats as sps

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from ldagroupedgibbssampler_tpu_torch.config.lda_config import (  # noqa: E402
    LDAConfig)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus  # noqa: E402
from ldagroupedgibbssampler_tpu_torch.models.fusion import (  # noqa: E402
    launch_counters)
from ldagroupedgibbssampler_tpu_torch.models.registry import (  # noqa: E402
    create_model)
from ldagroupedgibbssampler_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)

D, L, V, K = 6, 8, 8, 2
ALPHA, BETA = 0.8, 0.6
VOCAB = [f"w{i}" for i in range(V)]
STATS = ["theta00", "phi00", "frac_z0", "frac_w0"]
# the asymmetric alpha of the ggs_aliasmh chain (tests/test_geweke.py)
ALPHA_VEC = np.array([0.3, 1.5])
# the spike-and-slab joint's inclusion probability (models/nzvs.py)
VS_PI = 0.5
HDP_KMAX, HDP_ALPHA0, HDP_GAMMA = 4, 2.0, 1.0
MC_DRAWS = 4000


# ---------------------------------------------------------------------------
# marginal-conditional simulators
# ---------------------------------------------------------------------------
def _stats(theta00, phi00, z, w):
    return (theta00, phi00, float(np.mean(z == 0)), float(np.mean(w == 0)))


def _mc_draws(n, seed, alpha=None):
    """Ancestral draws of the LDA joint, theta ~ Dir(alpha) (ALPHA in
    every topic by default)."""
    alpha = np.full(K, ALPHA) if alpha is None else alpha
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        phi = rng.dirichlet(np.full(V, BETA), K)          # [K, V]
        theta = rng.dirichlet(alpha, D)                   # [D, K]
        z = np.array([rng.choice(K, p=theta[d]) for d in range(D)
                      for _ in range(L)])
        w = np.array([rng.choice(V, p=phi[k]) for k in z])
        out.append(_stats(theta[0, 0], phi[0, 0], z, w))
    return np.array(out)


def _mc_draws_asym(n, seed):
    return _mc_draws(n, seed, ALPHA_VEC)


def _stats4(m, phi, z, w):
    return (phi[0, 0], float(np.mean(z == 0)), float(np.mean(w == 0)),
            float(np.mean(phi == 0.0)))


def _vs_mc_draws(n, seed):
    """The spike-and-slab joint: I_kv ~ Bern(pi), rows conditioned
    nonempty, phi_k ~ Dir(beta) on the support, theta, z, w ancestral;
    the statistics of `_stats4`."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        inc = rng.random((K, V)) < VS_PI
        while not (inc.sum(axis=1) > 0).all():
            inc = rng.random((K, V)) < VS_PI
        phi = np.zeros((K, V))
        for k in range(K):
            s = np.flatnonzero(inc[k])
            phi[k, s] = rng.dirichlet(np.full(len(s), BETA))
        theta = rng.dirichlet(np.full(K, ALPHA), D)
        z = np.array([rng.choice(K, p=theta[d]) for d in range(D)
                      for _ in range(L)])
        w = np.array([rng.choice(V, p=phi[k]) for k in z])
        out.append(_stats4(None, phi, z, w))
    return np.array(out)


def _hdp_mc_draws(n, seed):
    """psi from the truncated stick prior at K_max 4, phi ~ Dir(beta),
    theta ~ Dir(alpha0 psi), z, w ancestral; statistics (phi00, frac_z0,
    frac_w0, psi0, occupied topics)."""
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


# ---------------------------------------------------------------------------
# successive-conditional chains
# ---------------------------------------------------------------------------
def _resample_w(rng, phi, z):
    """w_i ~ Cat(phi[z_i]) vectorised (phi rows renormalised in f64)."""
    p = phi[z].astype(np.float64)
    cdf = np.cumsum(p, axis=1)
    u = rng.random(len(z)) * cdf[:, -1]
    return np.minimum((cdf <= u[:, None]).sum(axis=1), V - 1).astype(np.int32)


def _corpus(w):
    return Corpus.from_token_lists(
        [list(w[d * L:(d + 1) * L]) for d in range(D)], VOCAB)


def counter_values() -> dict:
    """Every launch counter of the port's wrappers, by wrapper and mode
    (chip_smoke.py's names)."""
    return {fn.__name__ + ("" if attr == "launches" else " collapsed"):
            getattr(fn, attr) for fn, attr in launch_counters()}


def _run(m, w, rng, steps, burn, stat_fn, k_eff, launches=None):
    """The chain from the model's current state: `steps` times sample(1),
    the statistic `stat_fn(model, phi, z, w)` after the burn-in, the
    data-replication draw and the swap. `launches`, a dict, gains each
    counter's rise over the sample(1) calls."""
    out = []
    for s in range(steps):
        before = counter_values() if launches is not None else None
        m.sample(1)
        if launches is not None:
            for name, v in counter_values().items():
                launches[name] = launches.get(name, 0) + v - before[name]
        z = m.get_z_indicators()
        phi = m.get_phi()[:k_eff]
        if s >= burn:
            out.append(stat_fn(m, phi, z, w))
        w = _resample_w(rng, phi, z)
        m.swap_corpus_tokens(_corpus(w))
    return np.array(out)


def _stats_theta(m, phi, z, w):
    theta00 = (float(m.state.theta[0, 0])
               if m.state.theta is not None else np.nan)
    return _stats(theta00, phi[0, 0], z, w)


def _sc_series(scheme, steps, burn, seed, device, cfg_kw=None,
               model_patch=None, launches=None):
    """Post-burn-in series of the 4 statistics from one SC chain."""
    rng = np.random.default_rng(seed)
    phi0 = rng.dirichlet(np.full(V, BETA), K)
    theta0 = rng.dirichlet(np.full(K, ALPHA), D)
    z = np.array([rng.choice(K, p=theta0[d]) for d in range(D)
                  for _ in range(L)]).astype(np.int32)
    w = np.array([rng.choice(V, p=phi0[k]) for k in z], np.int32)
    m = create_model(LDAConfig(scheme=scheme, topics=K, alpha=ALPHA,
                               beta=BETA, seed=seed, exec_time=-1,
                               device=device, **(cfg_kw or {})))
    if model_patch:
        model_patch(m)
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    return _run(m, w, rng, steps, burn, _stats_theta, K, launches)


def _sc_series_asym(steps, burn, seed, device, buggy=False, launches=None):
    """SC chain of the port's ggs_aliasmh with state.alpha = ALPHA_VEC.
    `buggy=True` patches the doc proposal's density to n_dk + alpha_k
    (the proposal itself still falls back uniformly) in the plain MH
    rounds: the negative control, which only the CPU runs (the card's
    z-step is the kernel)."""
    import torch

    from ldagroupedgibbssampler_tpu_torch.models import ggs_aliasmh as gam

    if buggy and device != "cpu":
        raise ValueError("the patched MH rounds run on the CPU only")
    rng = np.random.default_rng(seed)
    phi0 = rng.dirichlet(np.full(V, BETA), K)
    theta0 = rng.dirichlet(ALPHA_VEC, D)
    z = np.array([rng.choice(K, p=theta0[d]) for d in range(D)
                  for _ in range(L)]).astype(np.int32)
    w = np.array([rng.choice(V, p=phi0[k]) for k in z], np.int32)
    m = create_model(LDAConfig(scheme="ggs_aliasmh", topics=K,
                               alpha=float(ALPHA_VEC.mean()), beta=BETA,
                               seed=seed, exec_time=-1, device=device))
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    m.state.alpha = torch.as_tensor(ALPHA_VEC, dtype=torch.float32,
                                    device=m.device)

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
        return _run(m, w, rng, steps, burn, _stats_theta, K, launches)
    finally:
        gam.alias_mh_rounds = orig


def _sc_series_ex(scheme, steps, burn, seed, stat_fn, device, k_eff=K,
                  cfg_kw=None, model_patch=None, launches=None):
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
                               exec_time=-1, device=device, **kw))
    if model_patch:
        model_patch(m)
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    return _run(m, w, rng, steps, burn, stat_fn, k_eff, launches)


def _hdp_stats(m, phi, z, w):
    return (phi[0, 0], float(np.mean(z == 0)), float(np.mean(w == 0)),
            float(m.state.psi[0]))


def _hdp_occupancy_stats(m, phi, z, w):
    return _hdp_stats(m, phi, z, w) + (float(len(np.unique(z))),)


def _hdp_sc_series(scheme, steps, burn, seed, device, launches=None):
    """The dynamic HDP chains from a truncated-GEM ancestral start, all
    K_max topics active; statistics (phi00, frac_z0, frac_w0, psi0,
    occupied topics). After a sweep no token sits on a dead
    (phi-zeroed) topic, so the data-replication draw is well defined."""
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
                               hdp_start_topics=HDP_KMAX, device=device))
    m.add_instances(_corpus(w))
    m.set_z_indicators(z)
    return _run(m, w, rng, steps, burn, _hdp_occupancy_stats, HDP_KMAX,
                launches)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------
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


def stat_table(mc, sc, stats, thin=20) -> dict:
    """name -> z, KS p-value (SC thinned by `thin`) and both means, for
    each (name, column) of `stats`."""
    out = {}
    for name, i in stats:
        out[name] = {
            "z": _geweke_z(mc[:, i], sc[:, i]),
            "ks_p": float(sps.ks_2samp(mc[:, i], sc[::thin, i]).pvalue),
            "mc_mean": float(mc[:, i].mean()),
            "sc_mean": float(sc[:, i].mean())}
    return out


# ---------------------------------------------------------------------------
# the chains and their bars
# ---------------------------------------------------------------------------
STATS4 = ["phi00", "frac_z0", "frac_w0", "phi_zero"]
GEM_STATS = ["phi00", "frac_z0", "frac_w0", "psi0"]
HDP_STATS = GEM_STATS + ["occupancy"]


def _exact(cols, zmax=5.0):
    """|z| < zmax and KS p > 1e-4 on each of `cols`."""
    def judge(t, mc, sc):
        return ([(f"|z {c}| < {zmax:g}", abs(t[c]["z"]) < zmax)
                 for c in cols]
                + [(f"ks {c} > 1e-4", t[c]["ks_p"] > 1e-4) for c in cols])
    return judge


def _power(cols):
    """The negative control: the largest |z| over `cols` above 10."""
    def judge(t, mc, sc):
        return [("max |z| > 10", max(abs(t[c]["z"]) for c in cols) > 10.0)]
    return judge


def _judge_nzvs(t, mc, sc):
    """The vectorised VS chain: phi00, frac_z0 and frac_w0 agree; the phi
    zero fraction's deviation pinned in direction and size (SC below MC),
    the bars that the JAX package's and the port's CPU chains both meet
    (tests/test_torch_geweke.py::test_geweke_nzvsspalias_vectorised)."""
    zero = t["phi_zero"]
    gap = zero["mc_mean"] - zero["sc_mean"]
    return (_exact(STATS4[:3])(t, mc, sc)
            + [("0 < z phi_zero < 9", 0.0 < zero["z"] < 9.0),
               ("0 < mc - sc phi_zero < 0.05", 0.0 < gap < 0.05)])


def _judge_polyaurn(t, mc, sc):
    return ([(f"|z {c}| < 5", abs(t[c]["z"]) < 5.0) for c in STATS4[:3]]
            + [(f"ks {c} > 1e-4", t[c]["ks_p"] > 1e-4)
               for c in STATS4[1:3]]
            + [("sc phi_zero > 0.1", float(sc[:, 3].mean()) > 0.1),
               ("ks phi00 < 1e-3", t["phi00"]["ks_p"] < 1e-3)])


def _judge_hdp_all_topics(t, mc, sc):
    return ([(f"|z {c}| < 5", abs(t[c]["z"]) < 5.0) for c in GEM_STATS]
            + [(f"ks {c} > 1e-4", t[c]["ks_p"] > 1e-4)
               for c in GEM_STATS[1:]]
            + [("ks phi00 < 1e-3", t["phi00"]["ks_p"] < 1e-3)])


def _judge_hdplda(t, mc, sc):
    occ = t["occupancy"]
    return ([(f"|z {c}| < 5", abs(t[c]["z"]) < 5.0)
             for c in ("phi00", "frac_w0")]
            + [("z occupancy > 8", occ["z"] > 8.0),
               ("1 <= sc occupancy < mc",
                1.0 <= occ["sc_mean"] < occ["mc_mean"]),
               ("sc psi0 > mc", t["psi0"]["sc_mean"] > t["psi0"]["mc_mean"]),
               ("sc frac_z0 > mc",
                t["frac_z0"]["sc_mean"] > t["frac_z0"]["mc_mean"])])


def _judge_hlda(t, mc, sc):
    occ = t["occupancy"]
    return [("|z frac_w0| < 5", abs(t["frac_w0"]["z"]) < 5.0),
            ("z psi0 > 5", t["psi0"]["z"] > 5.0),
            ("sc psi0 < mc", t["psi0"]["sc_mean"] < t["psi0"]["mc_mean"]),
            ("z frac_z0 > 5", t["frac_z0"]["z"] > 5.0),
            ("|z occupancy| < 8", abs(occ["z"]) < 8.0),
            ("sc occupancy >= mc - 0.5",
             occ["sc_mean"] >= occ["mc_mean"] - 0.5)]


def _streamed(m):
    """Force the streamed layout at K=2 (set before add_instances, as the
    JAX script forces its K-tiled body)."""
    m._fused_mode = lambda: "streamed"


@dataclasses.dataclass(frozen=True)
class Chain:
    """One chain of the check. `series(steps, burn, seed, device,
    launches)` runs the SC chain, `mc(n, seed)` the MC simulator (its
    columns `mc_cols`, all if None); `stats` names the (statistic,
    column) pairs of `stat_table`, and `judge(table, mc, sc)` lists (bar,
    passed). `kind` is "exact" (only the exact bar: `--steps` / `--burn`
    may cut it), "power" (a negative control) or "pinned" (a deviation
    pinned in direction and size); those two keep their length.
    `counters` must rise on the card."""
    name: str
    series: Callable
    mc: Callable
    mc_seed: int
    sc_seed: int
    stats: tuple
    judge: Callable
    counters: tuple
    steps: int
    burn: int = 200
    kind: str = "exact"
    mc_cols: tuple | None = None


def _plain(scheme, **cfg_kw):
    def series(steps, burn, seed, device, launches):
        return _sc_series(scheme, steps, burn, seed, device, cfg_kw=cfg_kw,
                          launches=launches)
    return series


def _forced_streamed(scheme):
    def series(steps, burn, seed, device, launches):
        return _sc_series(scheme, steps, burn, seed, device,
                          model_patch=_streamed, launches=launches)
    return series


def _ex(scheme, stat_fn, k_eff=K, **cfg_kw):
    def series(steps, burn, seed, device, launches):
        return _sc_series_ex(scheme, steps, burn, seed, stat_fn, device,
                             k_eff=k_eff, cfg_kw=cfg_kw, launches=launches)
    return series


def _hdp(scheme):
    def series(steps, burn, seed, device, launches):
        return _hdp_sc_series(scheme, steps, burn, seed, device, launches)
    return series


def _asym(steps, burn, seed, device, launches):
    return _sc_series_asym(steps, burn, seed, device, launches=launches)


ROWS_GGS = ("fused_zdraw_nkw", "blocked_label_counts", "dirichlet")
ROWS_MH = ("entry_topics", "mh_rounds", "pack_tables",
           "blocked_label_counts", "dirichlet")
HDP_ROWS = ("fused_pcgs_sweep", "table_counts", "psi_step", "polya_urn")
# (name, column) of each series the judges read
S4 = tuple(zip(STATS, range(4)))
S3 = S4[1:]                       # no theta in the chain's state
SV = tuple(zip(STATS4, range(4)))
SP = SV[:3]                       # the MC series has no phi_zero
SG = tuple(zip(GEM_STATS, range(4)))
SH = tuple(zip(HDP_STATS, range(5)))
N4, N3 = tuple(STATS), tuple(STATS[1:])
# ppu_hdplda_all_topics runs longer than its CPU test's 2000 steps. Its
# pinned atom (KS of phi00 on the series thinned by 20 below 1e-3) is met
# by ~3/4 of 2000-step chains over seeds and by nearly all at 3800. Its
# KS bars on frac_z0 and psi0 are not exact for it: the psi step (both
# packages' `gem_psi`) leaves out the truncation factor, so psi0 and
# frac_z0 drift above the MC draws on either device and those bars fail
# more often the longer the chain (`--seeds` measures both).
HDP_ALL_TOPICS_STEPS = 3800

CHAINS = {c.name: c for c in [
    Chain("ggs_bf16", _plain("ggs"), _mc_draws, 101, 202, S4, _exact(N4),
          ROWS_GGS, 2600),
    Chain("ggs_precise", _plain("ggs", zdraw_precise=True), _mc_draws,
          101, 202, S4, _exact(N4), ROWS_GGS, 2600),
    Chain("ggs_test", _plain("ggs_test"), _mc_draws, 103, 204, S4,
          _power(N4), ("fused_zdraw_nkw",), 1200, kind="power"),
    Chain("pcgs", _plain("pcgs"), _mc_draws, 105, 206, S3, _exact(N3),
          ("fused_pcgs_sweep", "dirichlet"), 2600),
    Chain("pcgs_streamed", _forced_streamed("pcgs"), _mc_draws, 105, 207,
          S3, _exact(N3), ("fused_pcgs_sweep_streamed", "dirichlet"), 2600),
    Chain("uncollapsed", _plain("uncollapsed"), _mc_draws, 111, 212, S3,
          _power(N3), ("fused_pcgs_sweep", "dirichlet"), 1200,
          kind="power"),
    Chain("spalias_priors", _plain("spalias_priors"), _mc_draws, 113, 214,
          S3, _exact(N3), ("fused_pcgs_sweep", "gamma"), 2000),
    Chain("lightpclda", _plain("lightpclda"), _mc_draws, 109, 210, S3,
          _exact(N3), ("fused_lightlda_sweep", "dirichlet"), 2600),
    Chain("lightpclda_streamed", _forced_streamed("lightpclda"), _mc_draws,
          109, 211, S3, _exact(N3),
          ("fused_lightlda_sweep_streamed", "dirichlet"), 2600),
    Chain("lightpcldaw2", _plain("lightpcldaw2"), _mc_draws, 307, 308, S3,
          _exact(N3), ("fused_lightlda_sweep", "dirichlet"), 2000),
    Chain("lightcollapsed", _plain("lightcollapsed"), _mc_draws, 307, 310,
          S3, _exact(N3), ("fused_lightlda_sweep", "dirichlet"), 2000),
    # the collapsed sweep's parallel launch draws a chunk against counts
    # stale within the chunk: the JAX package's on-chip bar for this body
    # (benchmarks/tpu_geweke_check.py, adlda_collapsed)
    Chain("adlda", _plain("adlda"), _mc_draws, 503, 504, S3,
          _exact(N3, zmax=9.0), ("fused_pcgs_sweep collapsed", "dirichlet"),
          2000),
    Chain("adlda_streamed", _forced_streamed("adlda"), _mc_draws, 503, 505,
          S3, _exact(N3, zmax=9.0),
          ("fused_pcgs_sweep_streamed collapsed", "dirichlet"), 2000),
    Chain("ggs_aliasmh", _plain("ggs_aliasmh"), _mc_draws, 601, 602, S4,
          _exact(N4), ROWS_MH, 2600),
    Chain("ggs_aliasmh_asym", _asym, _mc_draws_asym, 811, 812, S4,
          _exact(N4), ROWS_MH, 2600),
    Chain("nzvsspalias", _ex("nzvsspalias", _stats4), _vs_mc_draws, 301,
          302, SV, _judge_nzvs, ("fused_pcgs_sweep", "vs_dirichlet"), 2000,
          kind="pinned"),
    Chain("polyaurn", _ex("polyaurn", _stats4), _mc_draws, 303, 304, SP,
          _judge_polyaurn, ("fused_pcgs_sweep", "polya_urn"), 2000,
          kind="pinned", mc_cols=(1, 2, 3)),
    Chain("ppu_hdplda_all_topics",
          _ex("ppu_hdplda_all_topics", _hdp_stats, k_eff=HDP_KMAX,
              alpha=HDP_ALPHA0, hdp_gamma=HDP_GAMMA,
              hdp_start_topics=HDP_KMAX),
          _hdp_mc_draws, 305, 306, SG, _judge_hdp_all_topics, HDP_ROWS,
          HDP_ALL_TOPICS_STEPS, kind="pinned", mc_cols=(0, 1, 2, 3)),
    Chain("ppu_hdplda", _hdp("ppu_hdplda"), _hdp_mc_draws, 601, 602, SH,
          _judge_hdplda, HDP_ROWS, 2000, kind="pinned"),
    Chain("ppu_hlda", _hdp("ppu_hlda"), _hdp_mc_draws, 601, 602, SH,
          _judge_hlda, HDP_ROWS, 2000, kind="pinned"),
]}

# counters that no chain names, each with its reason (the gate's chains
# name left_to_right: tools/card_bf16_gate.py::COUNTERS)
UNCHAINED_COUNTERS = {
    "left_to_right": "the held-out estimator, which no transition runs",
    "pairwise_elementwise": "the apps' distances; no transition launches "
                            "it",
    "pairwise_ks": "the apps' distances; no transition launches it",
    "binomial": "the elementwise Binomial of ops/random.py::binomial, "
                "which only the CPU's eager HDP step calls; on the card "
                "table_counts draws its Binomials in the kernel",
    "poisson": "the elementwise Poisson of ops/random.py::poisson, which "
               "only the CPU's eager HDP step calls; on the card psi_step "
               "and polya_urn draw their Poissons in the kernels",
}


def chain_length(c: Chain, steps=None, burn=None, every=False) -> tuple:
    """(steps, burn) of a run: `steps` / `burn` cut or lengthen a chain
    held to the exact bar only, or any chain with `every`; a control or
    a pinned chain otherwise keeps its own."""
    if c.kind != "exact" and not every:
        return c.steps, c.burn
    return steps or c.steps, burn or c.burn


SWEEP_THINS = (20, 10)


def offset_checks(c: Chain, mc, sc, thin: int) -> dict:
    """bar -> how many of the `thin` offsets of the series, read thinned
    by `thin` from that offset, meet it."""
    met: dict = {}
    for off in range(thin):
        table = stat_table(mc, sc[off:], c.stats, thin=thin)
        for bar, ok in c.judge(table, mc, sc[off:]):
            met[bar] = met.get(bar, 0) + bool(ok)
    return met


def run_chain(name: str, device: str, steps: int | None = None,
              burn: int | None = None, draws: int = MC_DRAWS,
              seed: int | None = None) -> dict:
    """One chain: its statistics against its MC draws, its bar, its
    launches over the sample(1) calls, steps, seconds and ms a step. A
    `seed` other than the chain's own runs it at that SC seed, at the
    length `steps` / `burn` whatever its kind, and adds its
    `offset_checks` for each of SWEEP_THINS."""
    c = CHAINS[name]
    swept = seed is not None
    seed = c.sc_seed if seed is None else seed
    steps, burn = chain_length(c, steps, burn, every=swept)
    t0 = time.perf_counter()
    mc = c.mc(draws, c.mc_seed)
    if c.mc_cols is not None:
        mc = mc[:, list(c.mc_cols)]
    mc_s = time.perf_counter() - t0
    launches: dict = {}
    t0 = time.perf_counter()
    sc = c.series(steps, burn, seed, device, launches)
    sc_s = time.perf_counter() - t0
    table = stat_table(mc, sc, c.stats)
    checks = [(bar, bool(ok)) for bar, ok in c.judge(table, mc, sc)]
    missing = ([n for n in c.counters if launches.get(n, 0) <= 0]
               if device != "cpu" else [])
    return {"name": name, "kind": c.kind, "device": device, "seed": seed,
            "steps": steps, "burn": burn, "mc_draws": draws, "stats": table,
            "checks": checks,
            "offset_checks": ({thin: offset_checks(c, mc, sc, thin)
                               for thin in SWEEP_THINS} if swept else {}),
            "launches": {n: launches.get(n, 0) for n in c.counters},
            "counters_missing": missing, "mc_seconds": mc_s,
            "seconds": sc_s, "ms_per_step": sc_s / steps * 1e3,
            "ok": all(ok for _, ok in checks) and not missing}


def chain_line(r: dict) -> str:
    """One chain's statistics, steps and seconds, and its verdict."""
    stats = ", ".join(f"{s} z={v['z']:+.2f} ks={v['ks_p']:.1e}"
                      for s, v in r["stats"].items())
    failed = [bar for bar, ok in r["checks"] if not ok]
    failed += [f"counter {n} did not rise" for n in r["counters_missing"]]
    seed = f" seed {r['seed']}" if r["offset_checks"] else ""
    return (f"{r['name']}{seed}: {stats} ({r['steps']} steps, "
            f"{r['seconds']:.1f} s, {r['ms_per_step']:.2f} ms/step) "
            + ("pass" if r["ok"] else "FAIL " + "; ".join(failed)))


def one_thread() -> None:
    """A worker's torch on one host thread: the chains' host work is
    small, and a pool of processes each spinning a thread a core would
    oversubscribe the host."""
    import torch
    torch.set_num_threads(1)


def run(names, device: str, steps=None, burn=None, draws=MC_DRAWS,
        jobs: int = 1, echo=print, seeds=None) -> list:
    """The chains `names`, each at its own seed or at each of `seeds`,
    in `jobs` spawned processes when above 1 (the longest first); `echo`
    gets each chain's line as it ends. Returns the reports in the order
    of `names` (then of `seeds`)."""
    resolve_device(device)
    unknown = sorted(set(names) - set(CHAINS))
    if unknown:
        raise ValueError(f"unknown chains {unknown}; known: {sorted(CHAINS)}")
    if device != "cpu":
        # build the kernels once, before the workers load them
        from ldagroupedgibbssampler_tpu_torch.ops import _build
        _build.build()
    work = [(n, s) for n in names for s in (seeds or [None])]
    reports = {}
    if jobs <= 1:
        for n, s in work:
            reports[n, s] = run_chain(n, device, steps, burn, draws, s)
            echo(chain_line(reports[n, s]))
    else:
        order = sorted(work, key=lambda w: -CHAINS[w[0]].steps)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx,
                                 initializer=one_thread) as pool:
            futs = {pool.submit(run_chain, n, device, steps, burn, draws,
                                s): (n, s) for n, s in order}
            for f in as_completed(futs):
                reports[futs[f]] = f.result()
                echo(chain_line(reports[futs[f]]))
    return [reports[w] for w in work]


def sweep_lines(reports) -> list:
    """For each chain of a seed sweep: the share of (seed, offset) pairs
    meeting each bar, thinned by each of SWEEP_THINS, and each
    statistic's mean z over the seeds with the count of positive z."""
    lines = []
    for name in dict.fromkeys(r["name"] for r in reports):
        rs = [r for r in reports if r["name"] == name]
        head = (f"{name} ({rs[0]['device']}, {rs[0]['steps']} steps, "
                f"{len(rs)} seeds)")
        for thin in SWEEP_THINS:
            met = {b: sum(r["offset_checks"][thin][b] for r in rs)
                   / (thin * len(rs)) for b in rs[0]["offset_checks"][thin]}
            lines.append(f"{head} thinned by {thin}, the share of (seed, "
                         "offset) pairs meeting each bar: "
                         + ", ".join(f"{b} {v:.3f}" for b, v in met.items()))
        zs = {s: [r["stats"][s]["z"] for r in rs] for s in rs[0]["stats"]}
        lines.append(f"{head} mean z over the seeds (how many positive): "
                     + ", ".join(f"{s} {np.mean(z):+.2f} "
                                 f"({sum(v > 0 for v in z)})"
                                 for s, z in zs.items()))
    return lines


def _seeds(text: str) -> list | None:
    if not text:
        return None
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chains", default=",".join(CHAINS),
                    help="comma-separated names of CHAINS")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--burn", type=int, default=None)
    ap.add_argument("--draws", type=int, default=MC_DRAWS)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--seeds", default="", help="a-b or a,b,c: run each "
                    "chain at these SC seeds and report how often it "
                    "meets its bars")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    names = [n for n in args.chains.split(",") if n]
    reports = run(names, args.device, args.steps, args.burn, args.draws,
                  args.jobs, seeds=_seeds(args.seeds))
    for line in sweep_lines(reports) if args.seeds else ():
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    failed = [r["name"] for r in reports if not r["ok"]]
    print("Geweke check " + (f"FAILED: {', '.join(failed)}" if failed
                             else "passed") + f" ({args.device})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
