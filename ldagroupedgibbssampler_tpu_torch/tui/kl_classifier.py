"""Cross-validated KL-divergence document classification driver.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/kl_classifier.py`,
on the config's device (`classify/kl_classifier.py`).
Replaces ``cc.mallet.topics.tui.KLClassifier`` (tui/KLClassifier.java:25-):
5-fold cross-validation of KLDivergenceClassifier (or the per-class-model
MultiCorpus variant with --multi_corpus), printing per-fold accuracies, the
combined confusion matrix, and saving the matrix as CSV.

Usage:
    python -m ldagroupedgibbssampler_tpu_torch.tui.kl_classifier \
        --run_cfg=<cfg> [--folds=5] [--multi_corpus] [--device=cpu]
"""

from __future__ import annotations

from ldagroupedgibbssampler_tpu_torch.classify import (
    EnhancedConfusionMatrix, KLDivergenceClassifier,
    KLDivergenceClassifierMultiCorpus)


def run_classification(cfg, corpus, logger, multi_corpus: bool = False,
                       folds: int | None = None):
    cls = (KLDivergenceClassifierMultiCorpus if multi_corpus
           else KLDivergenceClassifier)
    clf = cls(cfg)
    trials = clf.cross_validate(corpus, folds or cfg.folds or 5)
    accs = [t.average_accuracy for t in trials]
    combined = EnhancedConfusionMatrix.combined(trials)
    print("Combined Confusion Matrix:\n" + str(combined))
    print("X-validation: [" + ", ".join(f"{a:.4f}" for a in accs)
          + f"] average: {sum(accs) / len(accs):.4f}")
    logger.save_lines("last-confusion-matrix.csv",
                      combined.to_csv(",").splitlines())
    return combined


def main(argv=None):
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    multi = "--multi_corpus" in argv
    argv = [a for a in argv if a != "--multi_corpus"]

    from ldagroupedgibbssampler_tpu_torch.tui.common import iterate_runs

    def body(cfg, corpus, logger):
        return run_classification(cfg, corpus, logger, multi_corpus=multi)

    return iterate_runs(argv, body, "KLClassifier")


if __name__ == "__main__":
    main()
