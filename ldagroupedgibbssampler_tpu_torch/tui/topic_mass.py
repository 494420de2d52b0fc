"""Type-mass / rare-words corpus experiments.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/topic_mass.py`:
host NumPy, the same files.
Replaces ``cc.mallet.topics.tui.TopicMassExperiment``
(tui/TopicMassExperiment.java:49-190): after loading the corpus, print the
cumulative type-frequency mass curve (getTypeMassCumSum, sampled every 50
types, :127-137) and the rare-words table (vocab size / corpus size vs
rare-word threshold, rareWordsExperiment :142-190).

Usage:
    python -m ldagroupedgibbssampler_tpu_torch.tui.topic_mass --run_cfg=<cfg>
"""

from __future__ import annotations

import numpy as np

from ldagroupedgibbssampler_tpu_torch.similarity.corpus_statistics import (
    CorpusStatistics)


def type_mass_cumsum(corpus) -> np.ndarray:
    """Cumulative corpus mass of types in descending-frequency order
    (UncollapsedParallelLDA.getTypeMassCumSum via CorpusStatistics)."""
    return CorpusStatistics(corpus).type_frequency_cumsum


def run_topic_mass(cfg, corpus, logger, print_every: int = 50):
    cumsum = type_mass_cumsum(corpus)
    lines = ["type_fraction,cumulative_mass"]
    for i in range(0, len(cumsum), print_every):
        frac = i / len(cumsum)
        print(f"CumSum[{frac:.4f}]: {cumsum[i]}")
        lines.append(f"{frac:.6f},{cumsum[i]:.6f}")
    logger.save_lines("type_mass_cumsum.csv", lines)
    print(f"Tot sum: {corpus.num_tokens} "
          f"Alphabet size: {corpus.num_types}")
    return cumsum


def rare_words_experiment(dataset_path: str, thresholds, stoplist=None):
    """Vocab/corpus size per rare-word threshold
    (rareWordsExperiment, TopicMassExperiment.java:142-190)."""
    from ldagroupedgibbssampler_tpu_torch.corpus import load_dataset
    rows = []
    for th in thresholds:
        c = load_dataset(dataset_path, stoplist_path=stoplist,
                         rare_threshold=int(th))
        rows.append({"rare_threshold": int(th), "vocab": c.num_types,
                     "corpus_tokens": c.num_tokens, "docs": c.num_docs})
        print(f"Rare word threshold: {th}  Vocabulary size: {c.num_types}  "
              f"Corpus size: {c.num_tokens}  Instances: {c.num_docs}")
    return rows


def main(argv=None):
    from ldagroupedgibbssampler_tpu_torch.tui.common import iterate_runs

    def body(cfg, corpus, logger):
        return run_topic_mass(cfg, corpus, logger)

    return iterate_runs(argv, body, "TopicMassExperiment")


if __name__ == "__main__":
    main()
