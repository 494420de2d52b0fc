"""The port's classification layer on the CPU against the JAX package: the
confusion matrix (values and CSV equal), both KL classifiers given the JAX
models' states and the same fold-in (centroids, scores, predictions), and
the planted-class bar of tests/test_similarity_classify.py on the port's
own chains."""

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.classify import kl_classifier as jax_klc
from ldagroupedgibbssampler_tpu.classify.confusion import (
    EnhancedConfusionMatrix as JaxConfusion)
from ldagroupedgibbssampler_tpu.config import LDAConfig as JaxConfig
from ldagroupedgibbssampler_tpu_torch.classify import (
    EnhancedConfusionMatrix, KLDivergenceClassifier,
    KLDivergenceClassifierMultiCorpus)
from ldagroupedgibbssampler_tpu_torch.classify import (
    kl_classifier as port_klc)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from torch_apps_support import (  # noqa: F401 (an autouse fixture)
    assert_same_fold_in_inputs, carry_jax_models, jax_corpus,
    one_torch_thread, patch_fold_in, planted)

# token_block 512: fold-in's plain versions run over fewer padding slots
KW = dict(topics=3, alpha=0.5, beta=0.01, seed=7, exec_time=-1,
          token_block=512)


@pytest.mark.parametrize("names", [None, ["x", "y", "z"]])
def test_confusion_matrix_equals_jax(names):
    rng = np.random.default_rng(2)
    t1, p1 = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
    t2, p2 = rng.integers(0, 3, 25), rng.integers(0, 3, 25)
    ours = [EnhancedConfusionMatrix(t1, p1, names),
            EnhancedConfusionMatrix(t2, p2, names)]
    ref = [JaxConfusion(t1, p1, names), JaxConfusion(t2, p2, names)]
    ours.append(EnhancedConfusionMatrix.combined(ours))
    ref.append(JaxConfusion.combined(ref))
    for a, b in zip(ours, ref):
        assert np.array_equal(a.values, b.values)
        assert (a.total, a.num_correct, a.class_names) == (
            b.total, b.num_correct, b.class_names)
        assert a.average_accuracy == b.average_accuracy
        assert a.to_csv() == b.to_csv() and a.to_csv(";") == b.to_csv(";")
        assert str(a) == str(b)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_classifier_given_the_same_state_equals_jax(multi, monkeypatch):
    """JAX and port classifiers trained to one state (each JAX chain
    carried into the port) and given one fold-in give equal centroids,
    scores within 1e-5 and the same predictions."""
    corpus = planted()
    test = planted(num_docs=15, seed=5)
    made = carry_jax_models(monkeypatch, port_modules=[port_klc])
    seen = patch_fold_in(monkeypatch, [jax_klc], [port_klc])
    jcls = (jax_klc.KLDivergenceClassifierMultiCorpus if multi
            else jax_klc.KLDivergenceClassifier)
    pcls = (KLDivergenceClassifierMultiCorpus if multi
            else KLDivergenceClassifier)
    ref = jcls(JaxConfig(scheme="spalias", **KW), fold_in_iterations=12)
    ref.train(jax_corpus(corpus), iterations=15)
    assert len(made) == (3 if multi else 1)
    ours = pcls(LDAConfig(scheme="spalias", device="cpu", **KW),
                fold_in_iterations=12)
    ours.train(corpus, iterations=15)
    assert made == [] and ours.class_names == ref.class_names
    if multi:
        for c in ref.class_names:
            np.testing.assert_allclose(ours.centroids_per_class[c],
                                       ref.centroids_per_class[c],
                                       rtol=0, atol=1e-12)
            # the port keeps phi and alpha of each class model, on the host
            phi, alpha = ours.models[c]
            assert isinstance(phi, np.ndarray)
            np.testing.assert_array_equal(phi, np.asarray(
                ref.models[c].get_phi()))
    else:
        np.testing.assert_allclose(ours.centroids, ref.centroids, rtol=0,
                                   atol=1e-12)
    cm_ref = ref.evaluate(jax_corpus(test))
    cm = ours.evaluate(test)
    seeds = [7 + 31 + ci for ci in range(3)] if multi else [7 + 31]
    assert_same_fold_in_inputs(seen, seeds)
    want = ref.score(jax_corpus(test))
    got = ours.score(test)
    assert got.shape == want.shape == (15, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(want, 1))
    assert np.array_equal(cm.values, cm_ref.values)
    assert cm.to_csv() == cm_ref.to_csv()
    if not multi:
        np.testing.assert_array_equal(ours.sampled_test_topics,
                                      ref.sampled_test_topics)


def test_planted_classes():
    cfg = LDAConfig(scheme="spalias", iterations=60, device="cpu", **KW)
    clf = KLDivergenceClassifier(cfg, fold_in_iterations=60)
    clf.train(planted(), iterations=60)
    cm = clf.evaluate(planted())
    # planted 3-class disjoint-vocab corpus: should be near-perfect
    assert cm.average_accuracy >= 0.8, cm.to_csv()


def test_unseen_classes_extend_the_labels_and_labels_are_required():
    corpus = planted(num_docs=30)
    train = corpus.subset(np.flatnonzero(np.asarray(corpus.labels) != "2"))
    cfg = LDAConfig(scheme="ggs", iterations=10, device="cpu", **KW)
    clf = KLDivergenceClassifier(cfg, scheme="ggs", fold_in_iterations=10)
    clf.train(train, iterations=10)
    cm = clf.evaluate(corpus.subset(np.arange(6)))
    assert cm.class_names == ["0", "1", "2"]
    assert cm.values[2].sum() == 2 and cm.values[:, 2].sum() == 0
    unlabelled = corpus.subset(np.arange(6))
    unlabelled.labels = []
    with pytest.raises(ValueError, match="labels"):
        clf.train(unlabelled)
    with pytest.raises(RuntimeError, match="train"):
        KLDivergenceClassifier(cfg).score(corpus)


def test_cross_validate_runs_one_trial_a_fold():
    corpus = planted(num_docs=30)
    cfg = LDAConfig(scheme="ggs", iterations=10, device="cpu", **KW)
    trials = KLDivergenceClassifierMultiCorpus(
        cfg, scheme="ggs", fold_in_iterations=10).cross_validate(
            corpus, folds=2, iterations=10)
    assert len(trials) == 2
    assert sum(t.total for t in trials) == 30
    assert EnhancedConfusionMatrix.combined(trials).total == 30


def test_classifier_asks_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        KLDivergenceClassifier(LDAConfig())
