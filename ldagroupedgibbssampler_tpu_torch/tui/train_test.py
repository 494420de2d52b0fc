"""Train/test split runner keyed by an id file.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/train_test.py`.
Replaces ``cc.mallet.topics.tui.ParallelLDATrainTest``
(tui/ParallelLDATrainTest.java:26-199): read `test_ids_filename` (one doc
id per line), split the corpus into train/test by those ids, train on the
training split, fold the test split into the trained phi, write train-/test-
doc-topic matrices and ids, on the config's device (fold-in as in
`tui/xvalidation.py`).

Usage:
    python -m ldagroupedgibbssampler_tpu_torch.tui.train_test \
        --run_cfg=<cfg> [--test_ids_filename=<ids.txt> --device=cpu]
"""

from __future__ import annotations

import numpy as np

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.tui.xvalidation import (
    _row_ids, sample_test_set, sample_training_set)


def extract_train_test(corpus: Corpus, test_ids: list[str]):
    """extractTrainTestInstances (ParallelLDATrainTest.java:139-165):
    membership by instance name (doc id); docs without ids fall back to
    their index string."""
    wanted = {s.strip() for s in test_ids if s.strip()}
    names = (corpus.doc_ids if corpus.doc_ids
             else [str(i) for i in range(corpus.num_docs)])
    is_test = np.asarray([str(n) in wanted for n in names], bool)
    return (corpus.subset(np.flatnonzero(~is_test)),
            corpus.subset(np.flatnonzero(is_test)),
            np.flatnonzero(~is_test), np.flatnonzero(is_test))


def run_train_test(cfg, corpus: Corpus, logger, scheme: str = "spalias"):
    if not cfg.test_ids_filename:
        raise ValueError("test_ids_filename is required")
    with open(cfg.test_ids_filename) as f:
        test_ids = f.readlines()
    train, test, train_idx, test_idx = extract_train_test(corpus, test_ids)
    print(f"Training set contains: {train.num_docs} instances")
    print(f"Test set contains: {test.num_docs} instances")
    model = sample_training_set(train, cfg, logger, scheme)
    sample_test_set(test, model.get_phi(), model.get_alpha(), cfg, logger)
    logger.save_lines("train-ids.txt", _row_ids(corpus, train_idx))
    logger.save_lines("test-ids.txt", _row_ids(corpus, test_idx))
    return model


def main(argv=None):
    from ldagroupedgibbssampler_tpu_torch.tui.common import iterate_runs

    def body(cfg, corpus, logger):
        return run_train_test(cfg, corpus, logger)

    return iterate_runs(argv, body, "ParallelLDATrainTest")


if __name__ == "__main__":
    main()
