"""Random-scan work selection (replaces reference L5,
cc.mallet.topics.randomscan — SURVEY.md §2.3); the port's copy of
`ldagroupedgibbssampler_tpu/models/randomscan.py`, NumPy with the same
seeds, so every builder gives the JAX package's masks.

The reference's *document batch builders* decide which documents each
iteration resamples, its *topic index builders* which vocabulary types get
fresh phi values, and its *topic batch builders* which phi rows. In the
thread-pool design they drive work splitting; on a device the device is
the parallelism, so each builder reduces to a boolean mask handed to the
step:

  - doc_mask[D]   — tokens of unselected docs keep their z (their counts
    are still included globally, exactly like unsampled batches in the
    Java version).
  - type_mask[V]  — phi columns outside the mask keep their previous
    values via a conditional-Dirichlet redraw (types/ConditionalDirichlet
    .java semantics, UncollapsedParallelLDA.java:1317-1329).
  - topic_mask[K] — phi rows outside the mask keep their previous draw.

Builder selection by config key mirrors BatchBuilderFactory.java:20-45 /
TopicIndexBuilderFactory.java:11-14 (FQCNs are mapped to short names by the
config parser).
"""

from __future__ import annotations

import numpy as np

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig


# ---------------------------------------------------------------------------
# document batch builders (randomscan/document/*)
# ---------------------------------------------------------------------------
class DocumentBatchBuilder:
    def __init__(self, config: LDAConfig, num_docs: int):
        self.config = config
        self.num_docs = num_docs
        self.rng = np.random.default_rng(config.effective_seed() ^ 0x5EED)

    def doc_mask(self, iteration: int) -> np.ndarray:
        raise NotImplementedError


class EvenSplitBatchBuilder(DocumentBatchBuilder):
    """Full sweep every iteration — the reference's even split assigns *all*
    docs, merely partitioned over threads (EvenSplitBatchBuilder.java:30-60);
    the device replaces the partitioning."""

    def doc_mask(self, iteration: int) -> np.ndarray:
        return np.ones(self.num_docs, bool)


class PercentageBatchBuilder(DocumentBatchBuilder):
    """Random `percentage_split_size_doc` fraction per iteration without
    replacement (PercentageBatchBuilder.java)."""

    def doc_mask(self, iteration: int) -> np.ndarray:
        frac = float(self.config.percentage_split_size_doc)
        n = max(1, int(round(self.num_docs * frac)))
        mask = np.zeros(self.num_docs, bool)
        mask[self.rng.choice(self.num_docs, size=n, replace=False)] = True
        return mask


class AdaptiveBatchBuilder(PercentageBatchBuilder):
    """Percentage builder + full sweeps during the instability period
    (AdaptiveBatchBuilder.java:26-36)."""

    def doc_mask(self, iteration: int) -> np.ndarray:
        if iteration <= self.config.instability_period:
            return np.ones(self.num_docs, bool)
        return super().doc_mask(iteration)


class FixedSplitBatchBuilder(DocumentBatchBuilder):
    """Cyclic schedule of fractions from `fixed_split_size_doc`
    (FixedSplitBatchBuilder.java; Configuration-README.txt:118-121)."""

    def doc_mask(self, iteration: int) -> np.ndarray:
        fracs = self.config.fixed_split_size_doc or (1.0,)
        frac = float(fracs[(iteration - 1) % len(fracs)])
        if frac >= 1.0:
            return np.ones(self.num_docs, bool)
        n = max(1, int(round(self.num_docs * frac)))
        mask = np.zeros(self.num_docs, bool)
        mask[self.rng.choice(self.num_docs, size=n, replace=False)] = True
        return mask


_DOC_BUILDERS = {
    "even": EvenSplitBatchBuilder,
    "percentage": PercentageBatchBuilder,
    "adaptive": AdaptiveBatchBuilder,
    "fixed": FixedSplitBatchBuilder,
}


def make_document_batch_builder(config: LDAConfig,
                                num_docs: int) -> DocumentBatchBuilder:
    cls = _DOC_BUILDERS.get(config.batch_building_scheme)
    if cls is None:
        raise ValueError(
            f"unknown batch_building_scheme {config.batch_building_scheme!r};"
            f" known: {sorted(_DOC_BUILDERS)}")
    return cls(config, num_docs)


# ---------------------------------------------------------------------------
# topic index builders (randomscan/topic/*TopicIndexBuilder.java)
# ---------------------------------------------------------------------------
class TopicIndexBuilder:
    def __init__(self, config: LDAConfig, corpus):
        self.config = config
        self.num_types = corpus.num_types
        self.type_freq = corpus.type_frequencies()
        self.rng = np.random.default_rng(config.effective_seed() ^ 0x70B1C)

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        raise NotImplementedError

    def _all(self) -> np.ndarray:
        return np.ones(self.num_types, bool)


class AllWordsTopicIndexBuilder(TopicIndexBuilder):
    """Resample the full phi (AllWordsTopicIndexBuilder.java:21-27)."""

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        return self._all()


class DeltaNTopicIndexBuilder(TopicIndexBuilder):
    """Only types whose counts changed last sweep; full phi every
    `full_phi_period`; everything during `instability_period`
    (DeltaNTopicIndexBuilder.java:25-39)."""

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        cfg = self.config
        if iteration <= cfg.instability_period or delta_types is None:
            return self._all()
        if cfg.full_phi_period > 0 and iteration % cfg.full_phi_period == 0:
            return self._all()
        return np.asarray(delta_types, bool)


class MandelbrotTopicIndexBuilder(TopicIndexBuilder):
    """Top `percent_top_tokens` fraction of most frequent types
    (MandelbrotTopicIndexBuilder.java:27-52), full phi every
    `full_phi_period`."""

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        cfg = self.config
        if cfg.full_phi_period > 0 and iteration % cfg.full_phi_period == 0:
            return self._all()
        n = max(1, int(round(self.num_types * cfg.percent_top_tokens)))
        mask = np.zeros(self.num_types, bool)
        mask[np.argsort(-self.type_freq)[:n]] = True
        return mask


class ProportionalTopicIndexBuilder(TopicIndexBuilder):
    """Systematic sampling of types proportional to corpus frequency
    (ProportionalTopicIndexBuilder.java:30-51; util/SystematicSampling.java
    :57-76)."""

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        freq = np.maximum(self.type_freq.astype(np.float64), 1e-12)
        inclusion = freq / freq.sum()
        n = max(1, int(round(self.num_types
                             * self.config.percent_top_tokens)))
        # systematic (fixed-interval) sampling over the cumulative scale
        cum = np.cumsum(inclusion)
        start = self.rng.uniform(0, 1.0 / n)
        points = start + np.arange(n) / n
        idx = np.searchsorted(cum, points)
        mask = np.zeros(self.num_types, bool)
        mask[np.clip(idx, 0, self.num_types - 1)] = True
        return mask


class TopWordsRandomFractionTopicIndexBuilder(TopicIndexBuilder):
    """80%: top-X fraction with X ~ Beta(2, 5) (mode 0.2); 20%: all words
    (TopWordsRandomFractionTopicIndexBuilder.java;
    Configuration-README.txt:127-134)."""

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        if self.rng.uniform() < 0.2:
            return self._all()
        frac = self.rng.beta(2.0, 5.0)
        n = max(1, int(round(self.num_types * frac)))
        mask = np.zeros(self.num_types, bool)
        mask[np.argsort(-self.type_freq)[:n]] = True
        return mask


class MixedMandelbrotDeltaNTopicIndexBuilder(TopicIndexBuilder):
    """Alternates Mandelbrot and DeltaN
    (MixedMandelbrotDeltaNTopicIndexBuilder.java:6)."""

    def __init__(self, config, corpus):
        super().__init__(config, corpus)
        self._mandelbrot = MandelbrotTopicIndexBuilder(config, corpus)
        self._delta = DeltaNTopicIndexBuilder(config, corpus)

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        builder = self._mandelbrot if iteration % 2 else self._delta
        return builder.type_mask(iteration, delta_types)


class MetaTopicIndexBuilder(TopicIndexBuilder):
    """Round-robin over a configured list of sub-builders
    (MetaTopicIndexBuilder.java:10-60, config key
    `sub_topic_index_builders`)."""

    def __init__(self, config, corpus, sub_builders=None):
        super().__init__(config, corpus)
        names = sub_builders or getattr(config, "sub_topic_index_builders",
                                        None) or ("delta_n", "mandelbrot")
        self.builders = [_TOPIC_INDEX_BUILDERS[n](config, corpus)
                         for n in names]
        self._idx = 0

    def type_mask(self, iteration: int, delta_types=None) -> np.ndarray:
        builder = self.builders[self._idx]
        self._idx = (self._idx + 1) % len(self.builders)
        return builder.type_mask(iteration, delta_types)


_TOPIC_INDEX_BUILDERS = {
    "all": AllWordsTopicIndexBuilder,
    "delta_n": DeltaNTopicIndexBuilder,
    "mandelbrot": MandelbrotTopicIndexBuilder,
    "proportional": ProportionalTopicIndexBuilder,
    "top_words_random_fraction": TopWordsRandomFractionTopicIndexBuilder,
    "mixed_mandelbrot_delta_n": MixedMandelbrotDeltaNTopicIndexBuilder,
    "meta": MetaTopicIndexBuilder,
}


def make_topic_index_builder(config: LDAConfig, corpus) -> TopicIndexBuilder:
    cls = _TOPIC_INDEX_BUILDERS.get(config.topic_index_building_scheme)
    if cls is None:
        raise ValueError(
            "unknown topic_index_building_scheme "
            f"{config.topic_index_building_scheme!r}; "
            f"known: {sorted(_TOPIC_INDEX_BUILDERS)}")
    return cls(config, corpus)


# ---------------------------------------------------------------------------
# topic batch builders (randomscan/topic/*TopicBatchBuilder.java)
# ---------------------------------------------------------------------------
class TopicBatchBuilder:
    """Which phi ROWS (topics) get redrawn each iteration. The reference
    additionally partitions the selected rows over phi-sampler threads
    (EvenSplitTopicBatchBuilder.java:28-55) — partitioning is a no-op on
    device, so only the row-selection semantics remain. Rows of phi are
    independent Dirichlets given the counts, so keeping an unselected row's
    previous value is the exact conditional."""

    def __init__(self, config: LDAConfig):
        self.config = config
        self.num_topics = config.topics
        self.rng = np.random.default_rng(config.effective_seed() ^ 0x70BB)

    def topic_mask(self, iteration: int) -> np.ndarray:
        raise NotImplementedError


class EvenSplitTopicBatchBuilder(TopicBatchBuilder):
    """All topic rows every iteration (EvenSplitTopicBatchBuilder.java)."""

    def topic_mask(self, iteration: int) -> np.ndarray:
        return np.ones(self.num_topics, bool)


class PercentageTopicBatchBuilder(TopicBatchBuilder):
    """Redraw ceil(percentage_split_size_topic × K) random topic rows per
    iteration (PercentageTopicBatchBuilder.java:10-45)."""

    def topic_mask(self, iteration: int) -> np.ndarray:
        frac = float(self.config.percentage_split_size_topic)
        if frac >= 1.0:
            return np.ones(self.num_topics, bool)
        n = max(1, int(np.ceil(self.num_topics * frac)))
        mask = np.zeros(self.num_topics, bool)
        mask[self.rng.choice(self.num_topics, size=n, replace=False)] = True
        return mask


_TOPIC_BATCH_BUILDERS = {
    "even": EvenSplitTopicBatchBuilder,
    "percentage": PercentageTopicBatchBuilder,
}


def make_topic_batch_builder(config: LDAConfig) -> TopicBatchBuilder:
    cls = _TOPIC_BATCH_BUILDERS.get(config.topic_batch_building_scheme)
    if cls is None:
        raise ValueError(
            "unknown topic_batch_building_scheme "
            f"{config.topic_batch_building_scheme!r}; "
            f"known: {sorted(_TOPIC_BATCH_BUILDERS)}")
    return cls(config)
