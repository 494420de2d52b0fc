"""Held-out evaluation dataset construction: the port's copy of
`ldagroupedgibbssampler_tpu/corpus/perplexity.py` (the same splits for the
same seed).

`build_perplexity_split` mirrors util/PerplexityDatasetBuilder.java:18-52:
pick a test fold of documents, split each test document's tokens in half —
the first half is folded into estimation, the second is scored — so
perplexity can be computed on unseen halves of partially seen documents.

`cross_validation_folds` mirrors tui/XValidationCreator.java:20: shuffle doc
indices and emit K (train, test) index splits.
"""

from __future__ import annotations

import numpy as np

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus


def build_perplexity_split(corpus: Corpus, test_fraction: float = 0.1,
                           seed: int = 0):
    """Returns (train_corpus, test_estimate_corpus, test_eval_corpus).

    Test docs are removed from training; each is halved token-wise
    (PerplexityDatasetBuilder.java:18-52 interleaves; we take a random
    half-split per doc which has the same exchangeable-bag semantics).
    """
    rng = np.random.default_rng(seed)
    n_test = max(1, int(round(corpus.num_docs * test_fraction)))
    perm = rng.permutation(corpus.num_docs)
    test_idx, train_idx = np.sort(perm[:n_test]), np.sort(perm[n_test:])

    train = corpus.subset(train_idx)
    est_docs, eval_docs, labels, ids = [], [], [], []
    for d in test_idx:
        s, e = corpus.doc_offsets[d], corpus.doc_offsets[d + 1]
        toks = corpus.tokens[s:e].copy()
        rng.shuffle(toks)
        half = len(toks) // 2
        est_docs.append(list(toks[:half]))
        eval_docs.append(list(toks[half:]))
        labels.append(corpus.labels[d] if corpus.labels else "X")
        ids.append(corpus.doc_ids[d] if corpus.doc_ids else str(d))
    est = Corpus.from_token_lists(est_docs, corpus.vocab, labels, ids)
    evl = Corpus.from_token_lists(eval_docs, corpus.vocab, labels, ids)
    return train, est, evl


def cross_validation_folds(num_docs: int, folds: int, seed: int = 0):
    """K-fold (train_indices, test_indices) splits
    (tui/XValidationCreator.java:20)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_docs)
    out = []
    for f in range(folds):
        test = np.sort(perm[f::folds])
        train = np.sort(np.setdiff1d(perm, test))
        out.append((train, test))
    return out
