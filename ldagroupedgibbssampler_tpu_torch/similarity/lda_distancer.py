"""Document similarity in topic space.

The port's counterpart of `ldagroupedgibbssampler_tpu/similarity/
lda_distancer.py`. Replaces ``cc.mallet.similarity.LDADistancer``
(LDADistancer.java:15-185): train a sampler on the training corpus, fold
held-out documents into the trained phi, and measure distances between the
held-out theta and every training document's theta. The reference folds
in one document at a time (fresh SpaliasUncollapsedParallelLDA + 2000
sampleZGivenPhi iterations per query, LDADistancer.java:distance); here
every query folds in at once (`evaluation/foldin.py`, on the z-draw and
count kernels, over cell blocks of the config's token_block and spans)
and the full (num_test × num_train) distance matrix is computed on the
model's device in tiles (`similarity/distances.py`).

Fold-in draws from a `torch.Generator` on the model's device seeded with
the config's effective seed + 17, where the JAX package uses
`jax.random.key(seed + 17)`: the same seed offset, other draws.

Zero-length documents follow the reference: distance 0 if both docs are
empty, +inf if exactly one is (LDADistancer.java:distance zero-length
branches).
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.foldin import fold_in
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.similarity.distances import Distance


class LDADistancer:
    """`train()` then `distance()`; `set_dist` switches the metric
    (default symmetric KL, LDADistancer.java:30). Runs on the config's
    device."""

    def __init__(self, config: LDAConfig, distance: str = "kl",
                 scheme: str | None = None):
        self.config = config
        self.dist = Distance(distance, device=config.device)
        # reference hard-codes Spalias (LDADistancer.java:train); any
        # registered scheme works here
        self.scheme = scheme or "spalias"
        self.trained_sampler = None
        self.train_thetas = None
        self._train_lengths = None
        self.sampled_test_topics = None

    def set_dist(self, distance: str):
        self.dist = Distance(distance, device=self.config.device)

    def train(self, corpus: Corpus, iterations: int | None = None):
        self.train_corpus = corpus
        model = create_model(self.config, self.scheme)
        model.add_instances(corpus)
        model.sample(iterations or self.config.iterations)
        self.trained_sampler = model
        self.train_thetas = model.get_theta_estimate()
        self._train_lengths = corpus.doc_lengths()
        return model

    def distance(self, test_corpus: Corpus, fold_in_iterations: int = 200
                 ) -> np.ndarray:
        """(num_test, num_train) distance matrix."""
        model = self.trained_sampler
        if model is None:
            raise RuntimeError("call train() first")
        cfg = self.config
        gen = torch.Generator(device=model.device)
        gen.manual_seed(cfg.effective_seed() + 17)
        theta_test = fold_in(
            torch.as_tensor(model.get_phi(), device=model.device),
            test_corpus, model.get_alpha(), gen,
            iterations=fold_in_iterations, token_block=cfg.token_block,
            vocab_span=cfg.vocab_span, doc_span=cfg.doc_span).theta_mean
        self.sampled_test_topics = theta_test.cpu().numpy()
        D = self.dist.pairwise(theta_test, self.train_thetas)
        # zero-length doc handling (reference semantics)
        test_len = test_corpus.doc_lengths()
        both = (test_len[:, None] == 0) & (self._train_lengths[None, :] == 0)
        either = (test_len[:, None] == 0) ^ (self._train_lengths[None, :] == 0)
        D = np.where(either, np.inf, D)
        D = np.where(both, 0.0, D)
        return D

    def closest(self, test_corpus: Corpus, n: int = 1,
                fold_in_iterations: int = 200):
        """Indices of the n nearest training docs per test doc (ranked on
        the host, so ties fall as in the JAX package)."""
        D = self.distance(test_corpus, fold_in_iterations)
        order = np.argsort(D, axis=1)[:, :n]
        return order, np.take_along_axis(D, order, axis=1)
