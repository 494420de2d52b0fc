"""Topic-space document similarity driver.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/lda_similarity.py`,
on the config's device (`similarity/lda_distancer.py`).
Replaces ``cc.mallet.topics.tui.LDASimilarity`` (tui/LDASimilarity.java:28-):
2-fold split, train an LDADistancer on the training half, fold the test half
in, and report each test doc's closest training documents (the reference
prints the query/closest doc text pairs; we write a CSV of
test-id, closest-train-id, distance).

Usage:
    python -m ldagroupedgibbssampler_tpu_torch.tui.lda_similarity \
        --run_cfg=<cfg> [--device=cpu]
"""

from __future__ import annotations

import numpy as np

from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
    cross_validation_folds)
from ldagroupedgibbssampler_tpu_torch.similarity import LDADistancer


def run_similarity(cfg, corpus, logger, distance: str = "kl"):
    (train_idx, test_idx), *_ = cross_validation_folds(
        corpus.num_docs, max(cfg.folds, 2), seed=cfg.effective_seed())
    train = corpus.subset(train_idx)
    test = corpus.subset(test_idx)
    distancer = LDADistancer(cfg, distance=distance)
    distancer.train(train, iterations=cfg.iterations)
    order, dists = distancer.closest(test, n=1)
    lines = ["test_id,closest_train_id,distance"]
    for ti, (oi, di) in enumerate(zip(order[:, 0], dists[:, 0])):
        t_name = (corpus.doc_ids[test_idx[ti]] if corpus.doc_ids
                  else str(int(test_idx[ti])))
        tr_name = (corpus.doc_ids[train_idx[oi]] if corpus.doc_ids
                   else str(int(train_idx[oi])))
        lines.append(f"{t_name},{tr_name},{di:.6g}")
        if ti < 10:
            print(f"Test doc {t_name} closest to train doc {tr_name} "
                  f"(distance {di:.4g})")
    logger.save_lines("similarities.csv", lines)
    return np.stack([order[:, 0], dists[:, 0]], axis=1)


def main(argv=None):
    from ldagroupedgibbssampler_tpu_torch.tui.common import iterate_runs

    def body(cfg, corpus, logger):
        return run_similarity(cfg, corpus, logger)

    return iterate_runs(argv, body, "LDASimilarity")


if __name__ == "__main__":
    main()
