"""Topic-space document classification by symmetric-KL to class centroids.

The port's counterpart of `ldagroupedgibbssampler_tpu/classify/
kl_classifier.py`. Replaces ``cc.mallet.classify.KLDivergenceClassifier``
(classify/KLDivergenceClassifier.java:24-) and
``KLDivergenceClassifierMultiCorpus`` (KLDivergenceClassifierMultiCorpus.java:20-).

Reference behaviour reproduced:
  - train(): fit a Spalias sampler on the full training set, compute per-
    class centroids as the alpha-smoothed mean zbar of the class's docs,
    (sum + alpha) / count (KLDivergenceClassifier.java:calculateCentroids).
  - classify(): fold the test doc into the trained phi (sampleZGivenPhi,
    300 iterations), normalise its zbar with alpha, score each class as
    1 / max(symmetric-KL(centroid, doc), 1e-12) (classify:48-56).
  - MultiCorpus variant trains ONE sampler PER CLASS and folds the test
    doc into each class's model, scoring against that model's centroid.

All test documents fold in at once (`evaluation/foldin.py`, on the z-draw
and count kernels of the config's device) and the (num_classes ×
num_test) symmetric-KL matrix is one device call; centroids and the zbar
normalisation stay on the host in float64, as in the JAX package. Fold-in
draws from a `torch.Generator` on that device seeded with the config's
effective seed + 31 (+ the class index in the multi-corpus variant), where
the JAX package uses `jax.random.key` with the same offsets.

The multi-corpus variant keeps of each class model only what fold-in
needs, its phi and alpha on the host (`models[class] = (phi, alpha)`), and
drops the sampler once its centroid is taken, so one class model at a time
holds device memory (the JAX package keeps every model).
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.classify.confusion import (
    EnhancedConfusionMatrix)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
    cross_validation_folds)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.foldin import fold_in
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.similarity.distances import Distance
from ldagroupedgibbssampler_tpu_torch.utils.device import resolve_device


def _class_index(labels):
    names = sorted(set(labels))
    idx = {c: i for i, c in enumerate(names)}
    return names, np.asarray([idx[c] for c in labels], np.int64)


def _require_labels(corpus: Corpus):
    if not corpus.labels:
        raise ValueError("training corpus needs labels")


def _fold_in_ndk(phi, corpus: Corpus, alpha, cfg: LDAConfig, seed: int,
                 iterations: int, device) -> torch.Tensor:
    """n_dk of `corpus` folded into `phi` ([K, V]) on `device`, over cell
    blocks of the config's token_block and spans."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return fold_in(torch.as_tensor(phi, device=device), corpus, alpha, gen,
                   iterations=iterations, token_block=cfg.token_block,
                   vocab_span=cfg.vocab_span, doc_span=cfg.doc_span).ndk


def _smoothed_zbar(ndk, alpha: float) -> np.ndarray:
    """zbar of the fold-in's n_dk, normalised with alpha as in classify()
    (KLDivergenceClassifier.java), float64 on the host."""
    ndk = ndk.cpu().numpy().astype(np.float64)
    zbar = ndk / np.maximum(ndk.sum(axis=1, keepdims=True), 1.0)
    zbar = zbar + alpha
    zbar /= zbar.sum(axis=1, keepdims=True)
    return zbar


class KLDivergenceClassifier:
    def __init__(self, config: LDAConfig, scheme: str = "spalias",
                 fold_in_iterations: int = 300):
        self.config = config
        self.scheme = scheme
        self.fold_in_iterations = fold_in_iterations
        self.alpha = float(config.alpha)
        self.dist = Distance("kl", device=config.device)
        self.trained_sampler = None
        self.class_names: list[str] = []
        self.centroids: np.ndarray | None = None   # (C, K)
        self.sampled_test_topics: np.ndarray | None = None

    def train(self, corpus: Corpus, iterations: int | None = None):
        _require_labels(corpus)
        model = create_model(self.config, self.scheme)
        model.add_instances(corpus)
        model.sample(iterations or self.config.iterations)
        self.trained_sampler = model
        self.class_names, y = _class_index(corpus.labels)
        zbar = model.get_zbar()                     # (D, K)
        C = len(self.class_names)
        sums = np.zeros((C, zbar.shape[1]))
        np.add.at(sums, y, zbar)
        cnt = np.bincount(y, minlength=C).astype(np.float64)
        # (sum + alpha) / count — the reference's exact normalisation
        # (calculateCentroids, KLDivergenceClassifier.java)
        self.centroids = (sums + self.alpha) / cnt[:, None]
        return model

    def _test_doc_topics(self, test_corpus: Corpus) -> np.ndarray:
        model = self.trained_sampler
        ndk = _fold_in_ndk(model.get_phi(), test_corpus, model.get_alpha(),
                           self.config, self.config.effective_seed() + 31,
                           self.fold_in_iterations, model.device)
        return _smoothed_zbar(ndk, self.alpha)

    def score(self, test_corpus: Corpus) -> np.ndarray:
        """(num_test, num_classes) scores = 1 / symmetric KL."""
        if self.trained_sampler is None:
            raise RuntimeError("call train() first")
        docs = self._test_doc_topics(test_corpus)
        self.sampled_test_topics = docs
        D = self.dist.pairwise(self.centroids, docs)      # (C, T)
        return (1.0 / np.maximum(D.T, 1e-12))             # (T, C)

    def classify(self, test_corpus: Corpus) -> np.ndarray:
        """Predicted class index per test doc."""
        return np.argmax(self.score(test_corpus), axis=1)

    def evaluate(self, test_corpus: Corpus):
        """Classify + confusion matrix against the corpus's own labels."""
        if not test_corpus.labels:
            raise ValueError("test corpus needs labels")
        pred = self.classify(test_corpus)
        # classes unseen in training (possible in small CV folds) extend the
        # label set; they can never be predicted, only missed
        names = list(self.class_names) + sorted(
            set(test_corpus.labels) - set(self.class_names))
        idx = {c: i for i, c in enumerate(names)}
        y = np.asarray([idx[c] for c in test_corpus.labels], np.int64)
        return EnhancedConfusionMatrix(y, pred, names)

    def cross_validate(self, corpus: Corpus, folds: int = 5,
                       iterations: int | None = None):
        """k-fold cross-validation returning one confusion matrix ("trial")
        per fold (Classifier.crossValidate as used by
        tui/KLClassifier.java:126-131). Re-trains from scratch each fold."""
        trials = []
        for train_idx, test_idx in cross_validation_folds(
                corpus.num_docs, folds, seed=self.config.effective_seed()):
            fold_clf = type(self)(self.config, scheme=self.scheme,
                                  fold_in_iterations=self.fold_in_iterations)
            fold_clf.train(corpus.subset(train_idx), iterations=iterations)
            trials.append(fold_clf.evaluate(corpus.subset(test_idx)))
        return trials


class KLDivergenceClassifierMultiCorpus(KLDivergenceClassifier):
    """One sampler per class (KLDivergenceClassifierMultiCorpus.java:105-118):
    fold the test docs into EVERY class model and score each against that
    model's own centroid."""

    def train(self, corpus: Corpus, iterations: int | None = None):
        _require_labels(corpus)
        self.class_names, y = _class_index(corpus.labels)
        self.models = {}
        self.centroids_per_class = {}
        for ci, cname in enumerate(self.class_names):
            sub = corpus.subset(np.flatnonzero(y == ci))
            model = create_model(self.config, self.scheme)
            model.add_instances(sub)
            model.sample(iterations or self.config.iterations)
            zbar = model.get_zbar()
            self.models[cname] = (model.get_phi(), model.get_alpha())
            self.centroids_per_class[cname] = (
                (zbar.sum(axis=0) + self.alpha) / zbar.shape[0])
        return self.models

    def score(self, test_corpus: Corpus) -> np.ndarray:
        if not getattr(self, "models", None):
            raise RuntimeError("call train() first")
        device = resolve_device(self.config.device)
        T = test_corpus.num_docs
        scores = np.zeros((T, len(self.class_names)))
        for ci, cname in enumerate(self.class_names):
            phi, alpha = self.models[cname]
            ndk = _fold_in_ndk(phi, test_corpus, alpha, self.config,
                               self.config.effective_seed() + 31 + ci,
                               self.fold_in_iterations, device)
            zbar = _smoothed_zbar(ndk, self.alpha)
            cen = self.centroids_per_class[cname][None, :]
            D = self.dist.pairwise(zbar, cen)[:, 0]
            scores[:, ci] = 1.0 / np.maximum(D, 1e-12)
        return scores
