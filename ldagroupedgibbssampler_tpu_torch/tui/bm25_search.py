"""BM25 nearest-document search driver.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/bm25_search.py`,
on the config's device (`similarity/bm25.py`).
Replaces ``cc.mallet.topics.tui.BM25Search`` (tui/BM25Search.java:24-205):
2-fold split, index the training half with corpus statistics, and find each
query doc's highest-BM25-scoring training doc — but as ONE batched score
matrix on device (similarity/bm25.py) instead of the reference's
O(docs² × V) scalar loop.

Usage:
    python -m ldagroupedgibbssampler_tpu_torch.tui.bm25_search \
        --run_cfg=<cfg> [--device=cpu]
"""

from __future__ import annotations

from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
    cross_validation_folds)
from ldagroupedgibbssampler_tpu_torch.similarity import BM25Searcher


def run_search(cfg, corpus, logger):
    (train_idx, _), *_ = cross_validation_folds(
        corpus.num_docs, max(cfg.folds, 2), seed=cfg.effective_seed())
    train = corpus.subset(train_idx)
    searcher = BM25Searcher(train, device=cfg.device)
    # the reference queries the TRAIN docs against themselves
    # (tui/BM25Search.java:117 "for (Instance instance : train)")
    idx, scores = searcher.search(train, top_n=2)
    lines = ["query_id,best_id,best_score,second_id,second_score"]
    names = ([corpus.doc_ids[i] for i in train_idx] if corpus.doc_ids
             else [str(int(i)) for i in train_idx])
    for q in range(train.num_docs):
        lines.append(f"{names[q]},{names[idx[q, 0]]},{scores[q, 0]:.4f},"
                     f"{names[idx[q, 1]]},{scores[q, 1]:.4f}")
        if q < 10:
            print(f"Query doc {names[q]}: closest {names[idx[q, 0]]} "
                  f"(BM25 {scores[q, 0]:.2f})")
    logger.save_lines("bm25_results.csv", lines)
    return idx, scores


def main(argv=None):
    from ldagroupedgibbssampler_tpu_torch.tui.common import iterate_runs

    def body(cfg, corpus, logger):
        return run_search(cfg, corpus, logger)

    return iterate_runs(argv, body, "BM25Search")


if __name__ == "__main__":
    main()
