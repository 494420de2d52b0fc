"""The port's secondary CLI drivers and the helpers only they use, on the
CPU against the JAX package: the ASCII and row/column matrix files, the
top-word reweightings, co-document counts, Timing and sub-loggers; the
cross-validation and train/test datasets given the JAX models' states and
the same fold-in (every file byte-equal), BM25 search, type mass and the
svmlight export (files byte-equal); the drivers' bodies on the port's own
chains with the bars of tests/test_tui_drivers.py; and each of the seven
drivers' `main` on a small text corpus with `--device=cpu`."""

import glob
import os

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config import LDAConfig as JaxConfig
from ldagroupedgibbssampler_tpu.evaluation import topwords as jax_topwords
from ldagroupedgibbssampler_tpu.evaluation.diagnostics import (
    TopicDiagnostics as JaxDiagnostics)
from ldagroupedgibbssampler_tpu.tui import bm25_search as jax_bm25_search
from ldagroupedgibbssampler_tpu.tui import svmlight_export as jax_svmlight
from ldagroupedgibbssampler_tpu.tui import topic_mass as jax_topic_mass
from ldagroupedgibbssampler_tpu.tui import train_test as jax_train_test
from ldagroupedgibbssampler_tpu.tui import xvalidation as jax_xvalidation
from ldagroupedgibbssampler_tpu.utils import matrix_io as jax_matrix_io
from ldagroupedgibbssampler_tpu.utils.logging_utils import (
    RunLogger as JaxRunLogger)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation import (calc_k1,
                                                         top_distinctive_words,
                                                         top_salient_words,
                                                         top_word_indices)
from ldagroupedgibbssampler_tpu_torch.evaluation.diagnostics import (
    TopicDiagnostics)
from ldagroupedgibbssampler_tpu_torch.tui import (bm25_search, kl_classifier,
                                                  lda_similarity,
                                                  svmlight_export,
                                                  topic_mass, train_test,
                                                  xvalidation)
from ldagroupedgibbssampler_tpu_torch.utils import Timing, matrix_io
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import RunLogger
from torch_apps_support import (  # noqa: F401 (an autouse fixture)
    assert_same_fold_in_inputs, carry_jax_models, doc_lists, jax_corpus,
    one_torch_thread, patch_fold_in, planted)

# token_block 512: fold-in's plain versions run over fewer padding slots
KW = dict(topics=3, alpha=0.5, beta=0.01, seed=11, iterations=15,
          exec_time=-1, folds=2, token_block=512)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _same_tree(a: str, b: str):
    """Both directories hold the same relative file names, byte-equal."""
    def files(root):
        return sorted(os.path.relpath(p, root) for p in glob.glob(
            os.path.join(root, "**", "*"), recursive=True)
            if os.path.isfile(p))
    assert files(a) == files(b) and files(a)
    for rel in files(a):
        assert _read(os.path.join(a, rel)) == _read(os.path.join(b, rel)), rel


# ---------------------------------------------------------------------------
# helpers the drivers use
# ---------------------------------------------------------------------------
def test_matrix_files_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    m = rng.standard_normal((5, 7)) * 1e3
    m[1, 2] = 1 / 3
    ints = rng.integers(-50, 50, (4, 6))
    for mod, tag in ((matrix_io, "port"), (jax_matrix_io, "jax")):
        mod.write_ascii_double_matrix(m, str(tmp_path / tag / "d.csv"))
        mod.write_ascii_int_matrix(ints, str(tmp_path / tag / "i.csv"),
                                   sep="\t")
        mod.write_binary_double_matrix_rows(m, 3, str(tmp_path / tag / "r"),
                                            [4, 0, 2])
        mod.write_binary_double_matrix_cols(m, 3, str(tmp_path / tag / "c"),
                                            [6, 1])
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    np.testing.assert_array_equal(
        matrix_io.read_ascii_double_matrix(str(tmp_path / "port" / "d.csv")),
        m)
    np.testing.assert_array_equal(matrix_io.read_ascii_int_matrix(
        str(tmp_path / "port" / "i.csv"), sep="\t"), ints)


def test_topword_reweightings_equal_jax():
    rng = np.random.default_rng(8)
    phi = rng.dirichlet(np.full(40, 0.3), 5)
    vocab = [f"v{i}" for i in range(40)]
    np.testing.assert_array_equal(top_word_indices(phi, 7),
                                  jax_topwords.top_word_indices(phi, 7))
    assert top_distinctive_words(phi, vocab, 9) == \
        jax_topwords.top_distinctive_words(phi, vocab, 9)
    assert top_salient_words(phi, vocab, 9) == \
        jax_topwords.top_salient_words(phi, vocab, 9)
    for a, b in zip(calc_k1(phi, 6), jax_topwords.calc_k1(phi, 6)):
        np.testing.assert_array_equal(a, b)


def test_codocument_matrix_equals_jax():
    c = planted()
    rng = np.random.default_rng(1)
    nkw = rng.integers(0, 20, (3, c.num_types))
    ndk = rng.integers(0, 20, (c.num_docs, 3))
    ours = TopicDiagnostics(nkw, ndk, c, num_top_words=6)
    ref = JaxDiagnostics(nkw, ndk, jax_corpus(c), num_top_words=6)
    for k in range(3):
        a, b = ours.codocument_matrix(k), ref.codocument_matrix(k)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_timing_and_sub_logger(tmp_path):
    timing = Timing()
    with timing.time("a"):
        pass
    with timing.time("b"):
        pass
    assert [name for name, _ in timing.events] == ["a", "b"]
    assert all(ms >= 0.0 for _, ms in timing.events)
    sub = RunLogger(str(tmp_path / "run")).sub_logger("fold-3")
    sub.save_lines("x.txt", ["1", "2"])
    assert _read(tmp_path / "run" / "fold-3" / "x.txt") == b"1\n2\n"


# ---------------------------------------------------------------------------
# the drivers' bodies, given the JAX models' states: files byte-equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("doc_ids", [False, True], ids=["index", "names"])
def test_xvalidation_given_the_same_state_writes_the_jax_files(
        doc_ids, tmp_path, monkeypatch):
    corpus = planted(doc_ids=doc_ids)
    carry_jax_models(monkeypatch, [jax_xvalidation], [xvalidation])
    seen = patch_fold_in(monkeypatch, [jax_xvalidation], [xvalidation])
    jax_xvalidation.create_xvalidation_dataset(
        jax_corpus(corpus), 2, JaxConfig(scheme="ggs", **KW),
        JaxRunLogger(str(tmp_path / "jax")), scheme="ggs")
    out = xvalidation.create_xvalidation_dataset(
        corpus, 2, LDAConfig(scheme="ggs", device="cpu", **KW),
        RunLogger(str(tmp_path / "port")), scheme="ggs")
    assert [os.path.basename(d) for d, _ in out] == ["fold-1", "fold-2"]
    assert_same_fold_in_inputs(seen, [11 + 101] * 2)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    ids = []
    for fold_dir, _ in out:
        with open(os.path.join(fold_dir, "test-ids.txt")) as f:
            ids += [ln.strip() for ln in f if ln.strip()]
    assert len(set(ids)) == corpus.num_docs


@pytest.mark.parametrize("ids", ["every_fifth", "none_match"])
def test_train_test_given_the_same_state_writes_the_jax_files(
        ids, tmp_path, monkeypatch):
    corpus = planted(doc_ids=True)
    ids_file = tmp_path / "test_ids.txt"
    ids_file.write_text("\n".join(f"doc{i}" for i in range(0, 60, 5))
                        if ids == "every_fifth" else "nodoc\n")
    carry_jax_models(monkeypatch, [jax_xvalidation], [xvalidation])
    seen = patch_fold_in(monkeypatch, [jax_xvalidation], [xvalidation])
    jax_train_test.run_train_test(
        JaxConfig(scheme="ggs", test_ids_filename=str(ids_file), **KW),
        jax_corpus(corpus), JaxRunLogger(str(tmp_path / "jax")),
        scheme="ggs")
    train_test.run_train_test(
        LDAConfig(scheme="ggs", test_ids_filename=str(ids_file),
                  device="cpu", **KW),
        corpus, RunLogger(str(tmp_path / "port")), scheme="ggs")
    assert_same_fold_in_inputs(seen, [11 + 101])
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    m = _read(tmp_path / "port" / "test-doc_topic_means.csv").splitlines()
    assert len(m) == (12 if ids == "every_fifth" else 0)


def test_bm25_search_equals_jax(tmp_path):
    corpus = planted(doc_ids=True)
    cfg = LDAConfig(device="cpu", **KW)
    idx, scores = bm25_search.run_search(cfg, corpus,
                                         RunLogger(str(tmp_path / "p")))
    jidx, jscores = jax_bm25_search.run_search(
        JaxConfig(**KW), jax_corpus(corpus), JaxRunLogger(str(tmp_path / "j")))
    np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-5)
    gap = np.abs(jscores[:, 0] - jscores[:, 1]) > 1e-4
    np.testing.assert_array_equal(idx[gap, 0], jidx[gap, 0])
    n_train = corpus.num_docs - corpus.num_docs // 2
    assert idx.shape == (n_train, 2)
    # a doc's best match is usually itself (it is in the index)
    self_in_top2 = ((idx[:, 0] == np.arange(n_train))
                    | (idx[:, 1] == np.arange(n_train)))
    assert self_in_top2.mean() > 0.5
    lines = _read(tmp_path / "p" / "bm25_results.csv").decode().splitlines()
    assert lines[0] == "query_id,best_id,best_score,second_id,second_score"
    assert len(lines) == n_train + 1


def test_topic_mass_equals_jax(tmp_path):
    corpus = planted()
    cum = topic_mass.run_topic_mass(None, corpus,
                                    RunLogger(str(tmp_path / "port")),
                                    print_every=4)
    ref = jax_topic_mass.run_topic_mass(None, jax_corpus(corpus),
                                        JaxRunLogger(str(tmp_path / "jax")),
                                        print_every=4)
    assert np.array_equal(cum, ref) and cum[-1] == pytest.approx(1.0)
    assert np.all(np.diff(cum) >= -1e-12)
    np.testing.assert_array_equal(topic_mass.type_mass_cumsum(corpus), cum)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_rare_words_experiment_equals_jax(tmp_path):
    path = tmp_path / "docs.txt"
    rng = np.random.default_rng(6)
    words = [a + b for a in "abcde" for b in "fghijk"]
    path.write_text("".join(
        f"d{d}\tX\t{' '.join(words[i] for i in rng.zipf(1.5, 25) % 30)}\n"
        for d in range(20)))
    rows = topic_mass.rare_words_experiment(str(path), [0, 2, 4])
    assert rows == jax_topic_mass.rare_words_experiment(str(path), [0, 2, 4])
    assert rows[0]["vocab"] > rows[2]["vocab"]
    assert rows[0]["corpus_tokens"] >= rows[1]["corpus_tokens"]


def test_svmlight_export_equals_jax(tmp_path):
    """Token rows, vocabulary and svmlight files byte-equal to the JAX
    package's, round-tripping to the corpus (an empty document included)."""
    base = planted()
    docs = doc_lists(base) + [[]]
    corpus = Corpus.from_token_lists(docs, base.vocab)
    out = svmlight_export.export_corpus(
        corpus, RunLogger(str(tmp_path / "port")), "sub1", svmlight=True)
    jax_svmlight.export_corpus(jax_corpus(corpus),
                               JaxRunLogger(str(tmp_path / "jax")), "sub1",
                               svmlight=True)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert svmlight_export.read_token_index_corpus(out["corpus"]) == docs
    assert svmlight_export.read_svmlight_corpus(out["svmlight"]) == docs
    assert svmlight_export.doc_svmlight_string([3, 1, 3], 2) == "2 3:1 1:1"
    assert svmlight_export.doc_token_index_string([3, 1, 3]) == "3, 1, 3"


# ---------------------------------------------------------------------------
# the drivers' bodies on the port's own chains
# ---------------------------------------------------------------------------
def test_kl_classifier_driver(tmp_path):
    cfg = LDAConfig(device="cpu", **{**KW, "iterations": 40})
    combined = kl_classifier.run_classification(
        cfg, planted(), RunLogger(str(tmp_path)), folds=2)
    assert combined.total == 60
    assert combined.average_accuracy >= 0.6
    assert os.path.exists(tmp_path / "last-confusion-matrix.csv")


def test_lda_similarity_driver(tmp_path):
    cfg = LDAConfig(device="cpu", **{**KW, "iterations": 30})
    corpus = planted()
    out = lda_similarity.run_similarity(cfg, corpus, RunLogger(str(tmp_path)))
    assert out.shape == (30, 2)
    lines = _read(tmp_path / "similarities.csv").decode().splitlines()
    assert lines[0] == "test_id,closest_train_id,distance"
    assert len(lines) == 31
    # the nearest training document shares the test document's theme
    labels = np.asarray([int(c) for c in corpus.labels])
    same = [labels[int(t)] == labels[int(r)]
            for t, r, _ in (ln.split(",") for ln in lines[1:])]
    assert np.mean(same) >= 0.8


# ---------------------------------------------------------------------------
# each driver's main on a text corpus
# ---------------------------------------------------------------------------
THEMES = [["cat", "lynx", "leopard", "tiger", "kitten", "paw", "purr"],
          ["car", "engine", "wheel", "road", "drive", "fuel", "brake"],
          ["tree", "leaf", "forest", "branch", "root", "oak", "pine"]]


@pytest.fixture(scope="module")
def run_cfg(tmp_path_factory):
    work = tmp_path_factory.mktemp("drivers")
    rng = np.random.default_rng(1)
    with open(work / "docs.txt", "w") as f:
        for d in range(45):
            words = [THEMES[d % 3][i] for i in rng.integers(0, 7, 30)]
            words += [THEMES[rng.integers(0, 3)][rng.integers(0, 7)]
                      for _ in range(3)]
            f.write(f"docno:{d}\tL{d % 3}\t{' '.join(words)}\n")
    (work / "test_ids.txt").write_text("1\n4\n9\n")
    cfg = work / "run.cfg"
    cfg.write_text(
        f"configs = demo\nno_runs = 1\nexperiment_out_dir = {work}/runs\n"
        f"iterations = 15\ntopics = 3\nalpha = 0.5\nbeta = 0.01\n"
        f"dataset = {work}/docs.txt\nrare_threshold = 0\nseed = 11\n"
        f"folds = 2\nstoplist =\ntoken_block = 512\n"
        f"test_ids_filename = {work}/test_ids.txt\n\n[demo]\nscheme = ggs\n")
    return cfg


def _run_dir(root, driver):
    dirs = glob.glob(os.path.join(root, "runs", "RunSuite*", "Rundemo-*"))
    assert len(dirs) == 1, (driver, dirs)
    return dirs[0]


def _rows_sum_to_one(path, atol=1e-9):
    m = np.loadtxt(path, delimiter=",", ndmin=2)
    np.testing.assert_allclose(m.sum(axis=1), 1.0, rtol=0, atol=atol)
    return m


DRIVERS = {"xvalidation": xvalidation, "train_test": train_test,
           "kl_classifier": kl_classifier, "lda_similarity": lda_similarity,
           "bm25_search": bm25_search, "topic_mass": topic_mass,
           "svmlight_export": svmlight_export}


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_main_on_the_cpu(driver, run_cfg, tmp_path):
    """Each driver's main with --device=cpu (`--multi_corpus` runs on the
    card in chip_smoke.py `[6 cli apps]`; on the CPU its classifier is
    held to the JAX one in tests/test_torch_classify.py)."""
    out = tmp_path / "runs"
    DRIVERS[driver].main([f"--run_cfg={run_cfg}", "--device=cpu",
                          f"--experiment_out_dir={out}"])
    run = _run_dir(tmp_path, driver)
    files = set(os.listdir(run))
    if driver == "xvalidation":
        assert {"fold-1", "fold-2"} <= files
        for fold in ("fold-1", "fold-2"):
            fd = os.path.join(run, fold)
            assert {"train-ids.txt", "test-ids.txt", "train-phi_means.csv"} \
                <= set(os.listdir(fd))
            _rows_sum_to_one(os.path.join(fd, "train-doc_topic_means.csv"))
            _rows_sum_to_one(os.path.join(fd, "test-doc_topic_means.csv"))
            # phi is float32 on the device
            _rows_sum_to_one(os.path.join(fd, "train-phi_means.csv"), 1e-6)
    elif driver == "train_test":
        assert _read(os.path.join(run, "test-ids.txt")) == b"1\n4\n9\n"
        assert _rows_sum_to_one(os.path.join(
            run, "test-doc_topic_means.csv")).shape == (3, 3)
    elif driver == "kl_classifier":
        lines = _read(os.path.join(run, "last-confusion-matrix.csv")
                      ).decode().splitlines()
        assert lines[-1].endswith(",45")
        diag = sum(int(lines[1 + i].split(",")[1 + i]) for i in range(3))
        assert diag / 45 >= 0.8, lines
    elif driver == "lda_similarity":
        lines = _read(os.path.join(run, "similarities.csv")).splitlines()
        assert len(lines) == 1 + 23         # the test half of 45
    elif driver == "bm25_search":
        lines = _read(os.path.join(run, "bm25_results.csv")).splitlines()
        assert len(lines) == 1 + 22         # the train half, queried
    elif driver == "topic_mass":
        assert "type_mass_cumsum.csv" in files
    else:
        assert {"demo-corpus.txt", "demo-vocabulary.txt",
                "demo-corpus.svmlight"} <= files


@pytest.mark.parametrize("driver", ["xvalidation", "kl_classifier",
                                    "lda_similarity", "bm25_search"])
def test_driver_main_asks_for_cuda(driver, run_cfg, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DRIVERS[driver].main([f"--run_cfg={run_cfg}",
                              f"--experiment_out_dir={tmp_path}"])
