"""Random-scan work selection (replaces reference L5,
cc.mallet.topics.randomscan — SURVEY.md §2.3).

The reference's *document batch builders* decide which documents each
iteration resamples. In the thread-pool design they drive work splitting;
on a device the device is the parallelism, so each builder reduces to a
boolean doc_mask[D] handed to the step: tokens of unselected docs keep
their z (their counts are still included globally, exactly like unsampled
batches in the Java version).

Builder selection by config key mirrors BatchBuilderFactory.java:20-45
(FQCNs are mapped to short names by the config parser). The topic index and
topic batch builders of the JAX package are not ported yet: the port's GGS
accepts only their defaults, which select every type and every topic.
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
