"""Cross-validation fold dataset creator.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/xvalidation.py`.
Replaces ``cc.mallet.topics.tui.XValidationCreator``
(tui/XValidationCreator.java:20-160): per fold, train a sampler on the
training split, fold the held-out split into the trained phi, and write
`train-/test-` doc-topic mean matrices plus row-id files to a per-fold log
directory (`fold-<n>`). The trained-phi fold-in runs all test docs at once
(`evaluation/foldin.py`, on the z-draw and count kernels of the config's
device) instead of a fresh per-fold Spalias instance; it draws from a
`torch.Generator` on that device seeded with the config's effective seed
+ 101, where the JAX package uses `jax.random.key(seed + 101)`.

Usage:
    python -m ldagroupedgibbssampler_tpu_torch.tui.xvalidation \
        --run_cfg=<cfg> [--folds=N --device=cpu ...]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
    cross_validation_folds)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.foldin import fold_in
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.utils.device import resolve_device
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import RunLogger
from ldagroupedgibbssampler_tpu_torch.utils.matrix_io import (
    write_ascii_double_matrix)


def _row_ids(corpus: Corpus, indices) -> list[str]:
    """extractRowIds (XValidationCreator.java:149-156): instance names."""
    if corpus.doc_ids:
        return [str(corpus.doc_ids[i]) for i in indices]
    return [str(int(i)) for i in indices]


def sample_training_set(train: Corpus, cfg: LDAConfig, logger: RunLogger,
                        scheme: str = "spalias"):
    """sampleTrainingset (XValidationCreator.java:89-119): train, write
    train- doc-topic means + phi means + ids."""
    model = create_model(cfg, scheme)
    model.add_instances(train)
    model.sample(cfg.iterations)
    write_ascii_double_matrix(
        model.get_zbar(),
        os.path.join(logger.run_dir, "train-" + cfg.doc_topic_mean_filename))
    pm = model.get_phi_means()
    write_ascii_double_matrix(
        pm if pm is not None else model.get_phi(),
        os.path.join(logger.run_dir, "train-" + cfg.phi_mean_filename))
    return model


def sample_test_set(test: Corpus, phi, alpha, cfg: LDAConfig,
                    logger: RunLogger):
    """sampleTestset (XValidationCreator.java:122-147): fold test docs into
    the trained phi ([K, V]), on the config's device, and write test-
    doc-topic means."""
    device = resolve_device(cfg.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.effective_seed() + 101)
    ndk = fold_in(torch.as_tensor(phi, dtype=torch.float32, device=device),
                  test, alpha, gen, iterations=cfg.iterations,
                  token_block=cfg.token_block, vocab_span=cfg.vocab_span,
                  doc_span=cfg.doc_span).ndk
    ndk = ndk.cpu().numpy().astype(np.float64)
    zbar = ndk / np.maximum(ndk.sum(axis=1, keepdims=True), 1.0)
    write_ascii_double_matrix(
        zbar,
        os.path.join(logger.run_dir, "test-" + cfg.doc_topic_mean_filename))
    return zbar


def create_xvalidation_dataset(corpus: Corpus, folds: int, cfg: LDAConfig,
                               logger: RunLogger, scheme: str = "spalias"):
    """createXValidationDataset (XValidationCreator.java:72-87)."""
    out = []
    for fold, (train_idx, test_idx) in enumerate(
            cross_validation_folds(corpus.num_docs, folds,
                                   seed=cfg.effective_seed())):
        fold_logger = logger.sub_logger(f"fold-{fold + 1}")
        train = corpus.subset(train_idx)
        test = corpus.subset(test_idx)
        model = sample_training_set(train, cfg, fold_logger, scheme)
        sample_test_set(test, model.get_phi(), model.get_alpha(), cfg,
                        fold_logger)
        fold_logger.save_lines("train-ids.txt", _row_ids(corpus, train_idx))
        fold_logger.save_lines("test-ids.txt", _row_ids(corpus, test_idx))
        out.append((fold_logger.run_dir, model))
    return out


def main(argv=None):
    from ldagroupedgibbssampler_tpu_torch.tui.common import iterate_runs

    def body(cfg, corpus, logger):
        return create_xvalidation_dataset(corpus, cfg.folds, cfg, logger)

    return iterate_runs(argv, body, "XValidationCreator")


if __name__ == "__main__":
    main()
