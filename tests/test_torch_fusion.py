"""Iteration fusion (`scan_chunk`) of the port on the CPU: the decisions
against the JAX base's (which iterations form a group), and chains with
fusion on bit-equal to the same chains single-stepped. On a CPU device a
fused group runs its iterations one by one through the same `_step`, so
these tests hold the grouping, the masks and the logging to the JAX rule;
`chip_smoke.py` `[4 fused]` holds the captured CUDA graphs to
single-stepping on the card."""

import glob
import os

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.fusion import FIELDS, FusedSteps
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.tui import parallel_lda
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import RunLogger

CFG = dict(topics=3, alpha=0.5, beta=0.05, seed=13, exec_time=-1,
           token_block=256)
DOC_SCAN = dict(batch_building_scheme="percentage",
                percentage_split_size_doc=0.5)


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


def _port(corpus, scheme="ggs", logger=None, **kw):
    cfg = LDAConfig(scheme=scheme, device="cpu", **{**CFG, **kw})
    return create_model(cfg, logger=logger).add_instances(corpus)


def _jax(corpus, scheme="ggs", **kw):
    m = jax_create_model(JaxConfig(scheme=scheme, **{**CFG, **kw}))
    return m.add_instances(JaxCorpus(tokens=corpus.tokens,
                                     doc_offsets=corpus.doc_offsets,
                                     vocab=corpus.vocab))


# each condition of the JAX base's `_fusable_chunk`, on a ggs run with
# scan_chunk 4 unless the case says otherwise
CONDITIONS = {
    "fusable": {},
    "scan_chunk_1": dict(scan_chunk=1),
    "paranoid": dict(paranoid=True),
    "measure_timing": dict(measure_timing=True),
    "save_phi_means": dict(save_phi_means=True),
    "hyperopt": dict(hyperparam_optim_interval=5),
    "topic_index_mandelbrot": dict(topic_index_building_scheme="mandelbrot"),
    "topic_batch_percentage": dict(topic_batch_building_scheme="percentage",
                                   percentage_split_size_topic=0.5),
    "percentage_split_topic": dict(percentage_split_size_topic=0.5),
    "delta_n": dict(scheme="pcgs", topic_index_building_scheme="delta_n"),
    "doc_random_scan": DOC_SCAN,
    "hook_hdp": dict(scheme="ppu_hdplda"),
    "collapsed": dict(scheme="collapsed"),
}


@pytest.mark.parametrize("case", list(CONDITIONS))
def test_fusable_chunk_equals_jax(case, corpus):
    kw = {"scheme": "ggs", "scan_chunk": 4, **CONDITIONS[case]}
    port = _port(corpus, **kw)
    jm = _jax(corpus, **kw)
    assert port._fusable_chunk() == jm._fusable_chunk()
    expect = 4 if case in ("fusable", "doc_random_scan", "collapsed") else 1
    assert port._fusable_chunk() == expect


@pytest.mark.parametrize("with_logger", [False, True])
def test_fusable_span_equals_jax(with_logger):
    """Groups over iterations 1-30 (and 95-130, across the logger's
    it % 100 cadence) with the likelihood, diagnostic, delta-N and print
    windows set."""
    kw = dict(topic_interval=7, diagnostic_interval=(12, 13),
              dn_diagnostic_interval=(3, 3), print_ndocs_interval=(20, 20),
              print_ntopwords_interval=(25, 26), scan_chunk=4)
    port = create_model(LDAConfig(scheme="ggs", device="cpu", **kw))
    jm = jax_create_model(JaxConfig(scheme="ggs", **kw))
    if with_logger:
        # only whether a logger is present matters to the event rule
        port.logger = jm.logger = object()
    for lo, hi in ((1, 30), (95, 130)):
        spans = [port._fusable_span(it, hi, 4) for it in range(lo, hi + 1)]
        assert spans == [jm._fusable_span(it, hi, 4)
                         for it in range(lo, hi + 1)]
        assert 4 in spans and 1 in spans
    events = [port._iteration_has_event(it) for it in range(95, 106)]
    assert events[5] is with_logger          # iteration 100


@pytest.fixture
def group_sizes(monkeypatch):
    """The sizes of the fused groups that sample() runs."""
    sizes = []
    run = FusedSteps.run

    def spy(self, doc_masks):
        sizes.append(len(doc_masks))
        return run(self, doc_masks)
    monkeypatch.setattr(FusedSteps, "run", spy)
    return sizes


@pytest.mark.parametrize("scheme, extra", [
    ("ggs", {}), ("pcgs", {}), ("adlda", {}), ("lightpclda", {}),
    ("ggs_aliasmh", {}), ("polyaurn", {}), ("collapsed", {}),
    ("ggs", DOC_SCAN)],
    ids=["ggs", "pcgs", "adlda", "lightpclda", "ggs_aliasmh", "polyaurn",
         "collapsed", "ggs_doc_random_scan"])
def test_scan_chunk_fusion_bit_identical(scheme, extra, corpus,
                                         group_sizes):
    """scan_chunk 3 over 7 iterations (two groups of 3 and a single tail)
    is bit-equal to single-stepping: the port's copy of
    tests/test_e2e_samplers.py::test_scan_chunk_fusion_bit_identical."""
    def run(chunk):
        m = _port(corpus, scheme, scan_chunk=chunk, topic_interval=-1,
                  **extra)
        m.sample(7)
        return m

    one = run(1)
    assert group_sizes == []
    fused = run(3)
    assert group_sizes == [3, 3]
    assert one.state.iteration == fused.state.iteration == 7
    for f in FIELDS:
        a, b = getattr(one.state, f), getattr(fused.state, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    np.testing.assert_array_equal(one.get_z_indicators(),
                                  fused.get_z_indicators())


@pytest.mark.parametrize("chunk", [3, 4])
def test_scan_chunk_respects_logging_events(chunk, tmp_path, corpus,
                                            group_sizes):
    """Fusion never swallows a logging iteration: likelihood.txt equals
    the single-stepped run's (the port's copy of
    tests/test_e2e_samplers.py::test_scan_chunk_respects_logging_events;
    with chunk 3 the groups 1-3 and 5-7 are fused between the events)."""
    def run(c):
        logger = RunLogger.create_run_suite(str(tmp_path), f"c{c}")
        m = _port(corpus, "ggs", logger=logger, scan_chunk=c,
                  topic_interval=4)
        m.sample(10)
        with open(os.path.join(logger.run_dir, "likelihood.txt")) as f:
            return f.read()

    text = run(1)
    assert text.count("\n") == 2
    assert run(chunk) == text
    assert group_sizes == ([3, 3] if chunk == 3 else [])


@pytest.mark.parametrize("chunk", [1, 3])
def test_abort_file_stops_at_a_group_boundary(chunk, tmp_path, monkeypatch,
                                              corpus):
    """An `abort` file in the working directory is read once a group, as
    the JAX base reads it: the run stops after the first group."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "abort").write_text("")
    port = _port(corpus, "ggs", scan_chunk=chunk, topic_interval=-1)
    port.sample(7)
    jm = _jax(corpus, "ggs", scan_chunk=chunk, topic_interval=-1)
    jm.sample(7)
    assert port.state.iteration == int(jm.state.iteration) == chunk


def _write_run(tmp_path, scan_chunk):
    rng = np.random.default_rng(0)
    themes = [["cat", "lynx", "leopard", "tiger", "kitten", "paw"],
              ["car", "engine", "wheel", "road", "drive", "fuel"],
              ["tree", "leaf", "forest", "branch", "root", "pine"]]
    docs = tmp_path / "docs.txt"
    with open(docs, "w") as f:
        for d in range(60):
            words = [themes[d % 3][i] for i in rng.integers(0, 6, 25)]
            f.write(f"docno:{d}\tL{d % 3}\t{' '.join(words)}\n")
    cfg = tmp_path / "run.cfg"
    cfg.write_text(
        f"configs = one\nno_runs = 1\nexperiment_out_dir = {tmp_path}/runs\n"
        f"exec_time = 300\niterations = 20\ntopics = 3\nalpha = 1\n"
        f"beta = 0.01\ndataset = {docs}\nrare_threshold = 0\nseed = 2019\n"
        f"topic_interval = 10\nstart_diagnostic = 1\nstoplist =\n"
        f"device = cpu\nscan_chunk = {scan_chunk}\n\n[one]\nscheme = ggs\n")
    return str(cfg)


def test_cli_scan_chunk_writes_the_same_series(tmp_path, group_sizes):
    """The experiment CLI with scan_chunk = 5 in the run config writes the
    likelihood and log-posterior series of the run with 1."""
    out = {}
    for chunk in (1, 5):
        work = tmp_path / f"c{chunk}"
        work.mkdir()
        parallel_lda.main([f"--run_cfg={_write_run(work, chunk)}"])
        run = glob.glob(str(work / "runs" / "RunSuite*" / "Runone-*"))[0]
        out[chunk] = [open(os.path.join(run, fn)).read()
                      for fn in ("likelihood.txt", "log_posterior.txt")]
    assert group_sizes == [5, 5]
    assert out[1][0].count("\n") == 2
    assert out[5] == out[1]
