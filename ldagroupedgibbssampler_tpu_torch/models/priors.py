"""Anchor-word topic priors, scheme `spalias_priors`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/priors.py`.
Reference: topics/SpaliasUncollapsedParallelWithPriors.java. Prior-spec
file format (one line per topic, `#` comments):

    <topic>, word1, word2, ...

Each listed word is *anchored* to that topic: it is zeroed out of every
other topic's phi row unless another line also keeps it there
(extractPriorSpec, :125-167, toZeroOut minus toKeep). Unknown words warn
and are skipped (:88-94); a topic or a word whose prior is all zero raises
(ensureConsistentPriors, :102-121).

The prior is a [K, V] 0/1 mask multiplied into the phi concentration
before the Gamma draw, so masked coordinates come out exactly 0 and the
sweep kernel (csrc/pcgs.cu, `positive_support` off) gives them zero
probability.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.models.pcgs import (
    UncollapsedParallelLDA)
from ldagroupedgibbssampler_tpu_torch.models.polyaurn import (
    keep_unmasked_columns)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

_EPS = 1e-30


def parse_prior_spec(lines, num_topics: int):
    """-> (keep[topic] sets, zero_out[topic] sets) of words
    (extractPriorSpec semantics)."""
    to_keep = [set() for _ in range(num_topics)]
    to_zero = [set() for _ in range(num_topics)]
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        spec = [s.strip() for s in line.split(",")]
        topic = int(spec[0])
        for word in spec[1:]:
            if not word:
                continue
            for k in range(num_topics):
                (to_keep if k == topic else to_zero)[k].add(word)
    for k in range(num_topics):
        to_zero[k] -= to_keep[k]
    return to_keep, to_zero


def calculate_priors(path: str, num_topics: int, vocab: list[str]
                     ) -> np.ndarray:
    """[K, V] 0/1 prior matrix (calculatePriors, :74-99)."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    _keep, zero_out = parse_prior_spec(lines, num_topics)
    index = {w: i for i, w in enumerate(vocab)}
    priors = np.ones((num_topics, len(vocab)), np.float32)
    warned = set()
    for k in range(num_topics):
        for word in zero_out[k]:
            idx = index.get(word)
            if idx is None:
                if word not in warned:
                    print(f"WARNING: calculate_priors: Word \"{word}\" does "
                          "not exist in the dictionary!", file=sys.stderr)
                    warned.add(word)
                continue
            priors[k, idx] = 0.0
    _ensure_consistent_priors(priors, vocab)
    return priors


def _ensure_consistent_priors(priors: np.ndarray, vocab):
    if (priors.sum(axis=1) == 0).any():
        raise ValueError("Inconsistent prior spec, one topic has all Zero "
                         "priors!")
    zero_cols = np.where(priors.sum(axis=0) == 0)[0]
    if len(zero_cols):
        words = [vocab[i] for i in zero_cols]
        raise ValueError(f"Inconsistent prior spec, '{words}' has all Zero "
                         "priors!")


class SpaliasUncollapsedParallelWithPriors(UncollapsedParallelLDA):
    smooth_phi = True
    # prior-masked phi coordinates are exact zeros: the kernel must clamp
    # to the last nonzero topic
    fused_positive_support = False

    def add_instances(self, corpus):
        self.topic_priors = None
        if self.config.topic_prior_filename:
            self.topic_priors = torch.as_tensor(
                calculate_priors(self.config.topic_prior_filename,
                                 self.config.topics, corpus.vocab),
                device=self.device)
        return super().add_instances(corpus)

    def get_topic_priors(self):
        """LDASamplerWithPriors.getTopicPriors
        (topics/LDASamplerWithPriors.java:3-5): the [K, V] mask, or None
        without a prior file."""
        return (None if self.topic_priors is None
                else self.topic_priors.cpu().numpy())

    def _sample_phi(self, nkw, beta, type_mask=None, prev_phi=None):
        """phi_k ~ Dir((N_k + beta) * prior_k): masked coordinates exactly
        0, the others floored at 1e-30 (priors.py:109-126)."""
        conc = nkw.to(torch.float32) + beta
        if self.topic_priors is not None:
            conc = conc * self.topic_priors
        g = torch.where(conc > 0, rnd.gamma(conc, self.generator)
                        .clamp_min(_EPS), 0.0)
        phi = g / g.sum(dim=-1, keepdim=True).clamp_min(_EPS)
        return keep_unmasked_columns(phi, type_mask, prev_phi)

    _initial_phi = _sample_phi
