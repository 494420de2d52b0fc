"""The rest of the sampler base on the CPU, against the JAX package where
the result is deterministic: the stats row and its densities, hyperopt,
the topic index and topic batch masks and the topic diagnostics CSV
(exact, or to the stated tolerance); the conditional Dirichlet
(statistical); paranoid checks, timings, distances, phi means and the
binary dumps (the port alone); and two faults of the JAX package that the
port does not share."""

import os
import time

import jax
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.evaluation import (
    diagnostics as jax_diagnostics)
from ldagroupedgibbssampler_tpu.evaluation import hyperopt as jax_hyperopt
from ldagroupedgibbssampler_tpu.models import randomscan as jax_randomscan
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu.utils import matrix_io as jax_matrix_io
from ldagroupedgibbssampler_tpu.utils.logging_utils import (
    RunLogger as JaxRunLogger)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation import diagnostics
from ldagroupedgibbssampler_tpu_torch.evaluation import hyperopt
from ldagroupedgibbssampler_tpu_torch.models import randomscan
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.utils import matrix_io
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import RunLogger

CFG = dict(topics=3, alpha=0.5, beta=0.01, exec_time=-1, token_block=512)
DENSITY_KEYS = dict(log_type_topic_density=True, log_document_density=True,
                    log_phi_density=True, topic_interval=1)


@pytest.fixture(scope="module")
def corpus():
    """tests/conftest.py's synthetic_corpus, as a port Corpus."""
    rng = np.random.default_rng(42)
    vocab = [f"w{k}_{i}" for k in range(3) for i in range(10)]
    docs = []
    for d in range(60):
        main = rng.integers(0, 10, 36) + (d % 3) * 10
        noise = rng.integers(0, len(vocab), 4)
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(docs, vocab)


def _jax_corpus(c):
    return JaxCorpus(tokens=c.tokens, doc_offsets=c.doc_offsets,
                     vocab=c.vocab)


def _port(corpus, scheme="ggs", logger=None, **kw):
    cfg = LDAConfig(scheme=scheme, device="cpu", **{"seed": 7, **CFG, **kw})
    return create_model(cfg, logger=logger).add_instances(corpus)


def _both_on_one_state(corpus, tmp_path, scheme, **kw):
    """A port chain's state written as a checkpoint and loaded into a JAX
    sampler of the same config: (port model, JAX model)."""
    pm = _port(corpus, scheme, **kw)
    pm.sample(4)
    path = str(tmp_path / f"{scheme}.npz")
    pm.save_checkpoint(path)
    jm = jax_create_model(JaxConfig(scheme=scheme, **{"seed": 7, **CFG,
                                                      **kw}))
    jm.add_instances(_jax_corpus(corpus))
    jm.load_checkpoint(path)
    return pm, jm


# ---------------------------------------------------------------------------
# the stats row (the port fault repaired first)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["ggs", "pcgs", "polyaurn"])
def test_stats_header_and_densities_equal_jax(corpus, tmp_path, scheme):
    """The logging step of an iteration (`_periodic_logging`) on one state
    in both packages: the same stats.txt header and density columns."""
    pm, jm = _both_on_one_state(corpus, tmp_path, scheme, **DENSITY_KEYS)
    rows = []
    for name, model, logger_cls in (("port", pm, RunLogger),
                                    ("jax", jm, JaxRunLogger)):
        model.logger = logger_cls(str(tmp_path / name))
        model._periodic_logging(5, time.perf_counter())
        model.logger.close()
        with open(tmp_path / name / "stats.txt") as f:
            rows.append([ln.rstrip("\n").split("\t") for ln in f])
    (header_p, vals_p), (header_j, vals_j) = rows
    assert header_p == header_j
    assert vals_p[0] == vals_j[0] == "5"
    assert vals_p[-3:] == vals_j[-3:]
    assert all(float(v) >= 0 for v in vals_p[-3:])


def test_device_metrics_row_writes_dashes_on_the_cpu(corpus, tmp_path):
    m = _port(corpus, logger=RunLogger(str(tmp_path)), topic_interval=100)
    m._periodic_logging(100, time.perf_counter())
    m.logger.close()
    line = open(tmp_path / "log-detail-metrics.txt").read().strip()
    assert line == ("100\tbytes_in_use=-\tpeak_bytes_in_use=-\t"
                    "bytes_limit=-\tnum_allocs=-")


# ---------------------------------------------------------------------------
# hyperopt
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hyperopt_equals_jax(seed):
    """The fixed points equal the JAX functions' to rtol 1e-5: both stop
    once a step moves every value by less than tol = 1e-6 (absolute), and
    the JAX package evaluates digamma in float32, so the two may stop one
    step apart (measured: up to 2e-6 relative on alpha of order 0.1)."""
    rng = np.random.default_rng(seed)
    ndk = rng.poisson(rng.gamma(0.3, 10, (60, 8)))
    nkw = rng.poisson(rng.gamma(0.1, 10, (8, 30)))
    alpha = np.full(8, 0.5)
    np.testing.assert_allclose(
        hyperopt.learn_dirichlet_parameters(alpha, ndk, ndk.sum(1)),
        jax_hyperopt.learn_dirichlet_parameters(alpha, ndk, ndk.sum(1)),
        rtol=1e-5)
    for counts, cats, conc in ((nkw, 30, 0.01), (ndk, 8, 0.5)):
        assert hyperopt.learn_symmetric_concentration(
            counts, counts.sum(1), cats, conc) == pytest.approx(
            jax_hyperopt.learn_symmetric_concentration(
                counts, counts.sum(1), cats, conc), rel=1e-5)


@pytest.mark.parametrize("symmetric", [False, True])
def test_hyperopt_runs_in_the_loop(corpus, symmetric):
    """hyperparam_optim_interval=5: after iteration 5 alpha and beta are
    the fixed points of the state the chain had then (the same seed
    without hyperopt is that chain)."""
    plain = _port(corpus, symmetric_alpha=symmetric)
    plain.sample(5)
    tuned = _port(corpus, symmetric_alpha=symmetric,
                  hyperparam_optim_interval=5)
    tuned.sample(5)
    ndk = plain.get_document_topic_matrix()
    nkw = plain.get_topic_type_counts()
    if symmetric:
        a = hyperopt.learn_symmetric_concentration(ndk, ndk.sum(1), 3, 0.5)
        want = np.full(3, a, np.float32)
    else:
        want = hyperopt.learn_dirichlet_parameters(np.full(3, 0.5), ndk,
                                                   ndk.sum(1))
    np.testing.assert_allclose(tuned.get_alpha(), want, rtol=1e-6)
    b = hyperopt.learn_symmetric_concentration(nkw, nkw.sum(1), 30, 0.01)
    assert tuned.state.beta == pytest.approx(b, rel=1e-6)
    assert tuned.state.beta != 0.01


# ---------------------------------------------------------------------------
# conditional Dirichlet (tests/test_random_ops.py:110 and :126, copied)
# ---------------------------------------------------------------------------
def test_conditional_dirichlet_preserves_unmasked_proportions():
    gen = torch.Generator().manual_seed(0)
    conc = torch.full((8,), 2.0)
    prev = rnd.dirichlet(conc, gen)
    mask = torch.tensor([True, True] + [False] * 6)
    out = rnd.conditional_dirichlet(prev, conc, mask, gen)
    assert float(out.sum()) == pytest.approx(1.0, abs=1e-5)
    prev_keep, out_keep = prev.numpy()[2:], out.numpy()[2:]
    np.testing.assert_allclose(out_keep / out_keep.sum(),
                               prev_keep / prev_keep.sum(), rtol=1e-5)


def test_conditional_dirichlet_marginal_distribution():
    """Redrawing a subset many times reproduces the Dirichlet marginal
    means of the masked block."""
    gen = torch.Generator().manual_seed(1)
    conc = torch.tensor([1.0, 2.0, 3.0, 4.0])
    mask = torch.tensor([True, True, False, False])
    prev = rnd.dirichlet(conc, gen)
    draws = rnd.conditional_dirichlet(prev.expand(20000, 4),
                                      conc.expand(20000, 4), mask, gen)
    assert float(draws[:, 0].mean()) == pytest.approx(0.1, abs=0.01)
    assert float(draws[:, 1].mean()) == pytest.approx(0.2, abs=0.01)


def test_conditional_dirichlet_keeps_positive_support():
    """A keep block of tiny concentration (the unsmoothed 1e-7) would let
    the float32 Beta draw round to 1 and zero the kept entries; the clamp
    keeps every entry positive."""
    gen = torch.Generator().manual_seed(2)
    conc = torch.tensor([[50.0, 50.0, 1e-7, 1e-7]]).expand(4096, 4)
    prev = torch.full((4096, 4), 0.25)
    out = rnd.conditional_dirichlet(prev, conc,
                                    torch.tensor([True, True, False, False]),
                                    gen)
    assert bool((out > 0).all())
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# the topic index and topic batch builders
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["all", "delta_n", "mandelbrot",
                                  "proportional",
                                  "top_words_random_fraction",
                                  "mixed_mandelbrot_delta_n", "meta"])
def test_topic_index_masks_equal_jax(corpus, name):
    kw = dict(seed=11, topic_index_building_scheme=name, full_phi_period=4,
              instability_period=3, percent_top_tokens=0.3)
    ours = randomscan.make_topic_index_builder(LDAConfig(**kw), corpus)
    ref = jax_randomscan.make_topic_index_builder(JaxConfig(**kw),
                                                  _jax_corpus(corpus))
    rng = np.random.default_rng(5)
    delta = None
    for it in range(1, 21):
        a, b = ours.type_mask(it, delta), ref.type_mask(it, delta)
        assert a.dtype == b.dtype == bool and np.array_equal(a, b), it
        delta = rng.random(corpus.num_types) < 0.4


@pytest.mark.parametrize("scheme,frac", [("percentage", 0.5),
                                         ("percentage", 0.34),
                                         ("even", 1.0)])
def test_topic_batch_masks_equal_jax(scheme, frac):
    kw = dict(seed=3, topics=10, topic_batch_building_scheme=scheme,
              percentage_split_size_topic=frac)
    ours = randomscan.make_topic_batch_builder(LDAConfig(**kw))
    ref = jax_randomscan.make_topic_batch_builder(JaxConfig(**kw))
    for it in range(1, 21):
        assert np.array_equal(ours.topic_mask(it), ref.topic_mask(it))


def test_unknown_topic_builders_raise(corpus):
    with pytest.raises(ValueError, match="topic_index_building_scheme"):
        _port(corpus, topic_index_building_scheme="bogus")
    with pytest.raises(ValueError, match="topic_batch_building_scheme"):
        _port(corpus, topic_batch_building_scheme="bogus")


@pytest.mark.parametrize("scheme", ["ggs", "ggs_aliasmh", "pcgs",
                                    "uncollapsed", "lightpclda", "polyaurn",
                                    "nzvsspalias", "spalias_priors"])
def test_type_mask_redraws_only_its_columns(corpus, scheme):
    """Mandelbrot builder (the 30% most frequent types, never a full
    sweep): after one iteration every phi column outside the mask is its
    previous value times one factor per topic row."""
    m = _port(corpus, scheme, topic_index_building_scheme="mandelbrot",
              percent_top_tokens=0.3, full_phi_period=0)
    m.sample(2)
    prev = m.get_phi().astype(np.float64)
    mask = m.topic_index_builder.type_mask(3)
    assert 0 < mask.sum() < corpus.num_types
    m.sample(1)
    phi = m.get_phi().astype(np.float64)
    np.testing.assert_allclose(phi.sum(1), 1.0, atol=1e-5)
    kept, old = phi[:, ~mask], prev[:, ~mask]
    assert np.array_equal(kept == 0, old == 0)
    ratio = np.where(old > 0, kept / np.where(old > 0, old, 1.0), np.nan)
    spread = np.nanmax(ratio, 1) / np.nanmin(ratio, 1) - 1.0
    assert spread.max() < 1e-4, spread
    assert not np.allclose(phi[:, mask], prev[:, mask])


@pytest.mark.parametrize("scheme", ["ggs", "pcgs"])
def test_topic_batch_keeps_unselected_rows(corpus, scheme):
    m = _port(corpus, scheme, topics=6, topic_batch_building_scheme=
              "percentage", percentage_split_size_topic=0.5)
    twin = randomscan.make_topic_batch_builder(m.config)
    twin.topic_mask(1)
    rows = twin.topic_mask(2)                  # the rows iteration 2 draws
    m.sample(1)
    prev = m.get_phi()
    m.sample(1)
    phi = m.get_phi()
    assert rows.sum() == 3
    assert np.array_equal(phi[~rows], prev[~rows])
    assert not np.allclose(phi[rows], prev[rows])


@pytest.mark.parametrize("scheme", ["ggs", "pcgs"])
def test_delta_n_types_are_the_types_whose_counts_moved(corpus, scheme):
    """The delta-N builder's input is a [V] mask in both orientations (the
    JAX package reduces over the wrong axis of GGS's [V, K] counts)."""
    m = _port(corpus, scheme, topic_index_building_scheme="delta_n",
              instability_period=1)
    m.sample(2)
    prev = m.get_topic_type_counts()
    m.sample(1)
    moved = (m.get_topic_type_counts() != prev).any(axis=0)
    assert m._last_delta_types.shape == (corpus.num_types,)
    assert np.array_equal(m._last_delta_types, moved)
    m.sample(3)


def test_jax_delta_n_on_ggs_fails_where_the_port_runs(corpus):
    """A fault of the reference: its GGS with a delta-N builder raises,
    since `any(nkw != prev_nkw, axis=0)` over [V, K] gives a [K] type
    mask (JAX `models/base.py:405-406`)."""
    kw = dict(topic_index_building_scheme="delta_n", instability_period=1)
    jm = jax_create_model(JaxConfig(scheme="ggs", seed=7, **CFG, **kw))
    jm.add_instances(_jax_corpus(corpus))
    with pytest.raises(ValueError, match="broadcast"):
        jm.sample(4)
    pm = _port(corpus, "ggs", **kw)
    pm.sample(4)
    assert np.isfinite(pm.model_log_likelihood())


# ---------------------------------------------------------------------------
# paranoid checks (tests/test_agreement.py:76-88, on the port)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["ggs", "pcgs", "adlda", "spalias"])
def test_paranoid_invariants_hold(corpus, scheme):
    model = _port(corpus, scheme, paranoid=True)
    model.sample(10)
    assert model.get_topic_type_counts().sum() == corpus.num_tokens


@pytest.mark.parametrize("corruption,match", [
    ("total", "nkw_sum_ok"), ("moved", "recount of z")])
def test_paranoid_catches_a_corrupted_nkw(corpus, corruption, match):
    """One extra count breaks the sums; one count moved between two types
    of a topic keeps every sum and marginal and only the recount of z
    sees it."""
    model = _port(corpus, "pcgs", paranoid=True)
    model.sample(2)
    nkw = model.state.nkw.clone()       # [K, V]
    if corruption == "total":
        nkw[0, 0] += 1
    else:
        v_from = int(torch.nonzero(nkw[0] > 0)[0])
        v_to = (v_from + 1) % corpus.num_types
        nkw[0, v_from] -= 1
        nkw[0, v_to] += 1
    model.state.nkw = nkw
    with pytest.raises(AssertionError, match=match):
        model._paranoid_checks()


# ---------------------------------------------------------------------------
# measure_timing and doc-topic distances (tests/test_tui_drivers.py:120-182
# on the synthetic corpus: the JAX copies need the absent cats.txt)
# ---------------------------------------------------------------------------
def test_measure_timing_writes_timings_and_trace(tmp_path, corpus):
    logger = RunLogger.create_run_suite(str(tmp_path), "t")
    m = _port(corpus, logger=logger, measure_timing=True, topic_interval=-1)
    m.sample(6)
    logger.close()
    rows = open(os.path.join(logger.run_dir, "timings.txt")).read() \
        .strip().split("\n")
    assert len(rows) == 6 and rows[0].startswith("iteration_1\t")
    trace = os.path.join(logger.run_dir, "timing_data", "trace.json")
    assert os.path.getsize(trace) > 0


def test_compute_doc_topic_distances(tmp_path, corpus):
    logger = RunLogger.create_run_suite(str(tmp_path), "d")
    m = _port(corpus, logger=logger, topic_interval=2, start_diagnostic=1,
              compute_doc_topic_distances=True)
    m.sample(4)
    logger.close()
    for fn, rows_len in (("min_doc_distances.csv", corpus.num_docs),
                         ("min_topic_distances.csv", 3)):
        lines = open(os.path.join(logger.run_dir, fn)).read().strip() \
            .split("\n")
        assert len(lines) == 2              # iterations 2 and 4
        vals = lines[-1].split(",")
        assert len(vals) == rows_len + 1 and vals[0] == "4"
        assert all(float(v) > 0 for v in vals[1:])
        x = (m.state.theta.numpy() if fn.startswith("min_doc")
             else m.get_phi()).astype(np.float64)
        d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        got = np.array([float(v) for v in vals[1:]])
        np.testing.assert_allclose(got, d.min(1), rtol=2e-3)


# ---------------------------------------------------------------------------
# phi means and the binary dumps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["ggs", "pcgs"])
def test_phi_means_are_the_mean_of_the_kept_draws(corpus, scheme):
    m = _port(corpus, scheme, save_phi_means=True, phi_mean_burnin=20,
              phi_mean_thin=2)
    snaps = {}
    m.post_iteration = lambda: snaps.__setitem__(m.state.iteration,
                                                 m.get_phi().copy())
    m.sample(10)
    # burn-in int(10 * 20%) = 2 iterations, then every 2nd: 4, 6, 8, 10
    want = np.mean([snaps[i] for i in (4, 6, 8, 10)], axis=0)
    got = m.get_phi_means()
    assert got.shape == (3, corpus.num_types)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_jax_phi_means_read_a_donated_buffer_where_the_port_runs(corpus):
    """A fault of the reference: its phi-mean sum holds the state's phi,
    whose buffer the next step donates (JAX `models/base.py:594-596`), so
    the following iteration raises."""
    jm = jax_create_model(JaxConfig(scheme="pcgs", seed=7,
                                    save_phi_means=True, **CFG))
    jm.add_instances(_jax_corpus(corpus))
    with pytest.raises(RuntimeError, match="deleted"):
        jm.sample(4)
    pm = _port(corpus, "pcgs", save_phi_means=True)
    pm.sample(4)
    assert pm.get_phi_means().shape == (3, corpus.num_types)


def test_interval_dumps_read_back(tmp_path, corpus):
    """diagnostic_interval writes phi / N / M in the reference's binary
    format (the same bytes as the JAX writers'), and z; the readers of both
    packages give the matrices back."""
    logger = RunLogger(str(tmp_path / "run"))
    m = _port(corpus, "pcgs", logger=logger, diagnostic_interval=(2, 3),
              dn_diagnostic_interval=(3, 3))
    snaps = {}
    m.post_iteration = lambda: snaps.__setitem__(m.state.iteration, (
        m.get_phi().copy(), m.get_topic_type_counts().copy(),
        m.get_document_topic_matrix().copy(), m.get_z_indicators().copy()))
    m.sample(4)
    logger.close()
    run = str(tmp_path / "run")
    v, d = corpus.num_types, corpus.num_docs
    for it in (2, 3):
        phi, nkw, ndk, z = snaps[it]
        for name, mat, rows, cols, kind in (
                ("phi", phi, 3, v, "double"), ("N", nkw, 3, v, "int"),
                ("M", ndk, d, 3, "int")):
            fn = os.path.join(run, f"{name}_{rows}_{cols}_{it:05d}.BINARY")
            reader = f"read_binary_{kind}_matrix"
            got = getattr(matrix_io, reader)(fn, rows, cols)
            assert np.array_equal(got, mat.astype(got.dtype))
            assert np.array_equal(
                getattr(jax_matrix_io, reader)(fn, rows, cols), got)
            ref = getattr(jax_matrix_io, f"write_binary_{kind}_matrix")(
                mat, it, str(tmp_path / name))
            assert open(ref, "rb").read() == open(fn, "rb").read()
        zc = np.loadtxt(os.path.join(run, f"z_{it}.csv"), delimiter=",")
        assert np.array_equal(zc.astype(np.int32), z)
    delta = open(os.path.join(run, "delta_n.txt")).read().split()
    assert delta[0] == "3" and int(delta[1]) == int(
        np.abs(snaps[3][1].astype(np.int64) - snaps[2][1]).sum())
    assert sorted(f for f in os.listdir(run) if f.endswith(".BINARY")) == [
        f"{n}_{r}_{c}_{it:05d}.BINARY" for n, r, c in (
            ("M", d, 3), ("N", 3, v), ("phi", 3, v)) for it in (2, 3)]


# ---------------------------------------------------------------------------
# topic diagnostics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["ggs", "pcgs"])
def test_topic_diagnostics_csv_equals_jax(corpus, tmp_path, scheme):
    pm, jm = _both_on_one_state(corpus, tmp_path, scheme)
    ours = diagnostics.topic_diagnostics_csv(pm, corpus, 10)
    ref = jax_diagnostics.topic_diagnostics_csv(jm, _jax_corpus(corpus), 10)
    assert len(ours) == 4 and ours == ref


def test_print_intervals(corpus, tmp_path, capsys):
    m = _port(corpus, logger=RunLogger(str(tmp_path)),
              print_ndocs_interval=(2, 2), print_ndocs_cnt=2,
              print_ntopwords_interval=(3, 3), print_ntopwords_cnt=4)
    m.sample(3)
    out = capsys.readouterr().out
    assert out.count("doc-topic means") == 1
    assert "Iteration 2 doc-topic means:" in out
    tops = [ln for ln in out.splitlines() if ln.startswith("Iteration 3 topic")]
    assert len(tops) == 3 and all(len(ln.split(": ")[1].split()) == 4
                                  for ln in tops)
