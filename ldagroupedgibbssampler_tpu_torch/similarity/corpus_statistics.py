"""Corpus statistics + inverted index for BM25 search.

Replaces ``cc.mallet.similarity.CorpusStatistics`` (CorpusStatistics.java:13-183),
which walks every document on a ForkJoinPool accumulating AtomicInteger
type counts / doc frequencies / an inverted index. The ragged `Corpus`
layout makes every one of those a single vectorised NumPy pass:

  - type_counts[V]        = bincount(tokens)
  - doc_freqs[V]          = bincount(unique (doc, type) pairs by type)
  - inverted index        = CSR arrays (indptr[V+1], doc_ids[nnz]) built by
                            sorting the unique (type, doc) pairs — the
                            reference's int[V][] postings lists
  - type_frequency_index  = types sorted by descending count
                            (via IndexSorter, CorpusStatistics.java:95-99)
  - type_frequency_cumsum = normalised cumulative mass in that order

The port's copy of `ldagroupedgibbssampler_tpu/similarity/
corpus_statistics.py`: host NumPy, the same arrays.
"""

from __future__ import annotations

import numpy as np

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus


class CorpusStatistics:
    def __init__(self, corpus: Corpus):
        self.corpus = corpus
        V = corpus.num_types
        self.corpus_size = corpus.num_docs
        self.corpus_word_count = corpus.num_tokens
        self.avg_doc_len = (corpus.num_tokens / corpus.num_docs
                            if corpus.num_docs else 0.0)
        self.type_counts = np.bincount(corpus.tokens, minlength=V).astype(
            np.int64)

        # unique (type, doc) pairs + their counts -> doc frequencies and a
        # CSR inverted index. The reference's `invertedIndex[type][doc]` is a
        # dense V×D count matrix (CorpusStatistics.java:101-117,140-150);
        # CSR holds the same information in O(nnz).
        doc_ids = corpus.token_doc_ids()
        D = corpus.num_docs
        flat = corpus.tokens.astype(np.int64) * D + doc_ids.astype(np.int64)
        uniq, cnt = np.unique(flat, return_counts=True)
        pairs = np.stack([uniq // D, uniq % D], axis=1)
        self.doc_freqs = np.bincount(pairs[:, 0], minlength=V).astype(np.int64)
        # CSR postings: indptr per type, columns = doc ids (sorted), values =
        # per-doc counts of that type
        self.inv_indptr = np.zeros(V + 1, np.int64)
        np.cumsum(self.doc_freqs, out=self.inv_indptr[1:])
        self.inv_doc_ids = pairs[:, 1].astype(np.int32)
        self.inv_counts = cnt.astype(np.int32)

        # descending frequency order + cumulative mass
        self.type_frequency_index = np.argsort(-self.type_counts,
                                               kind="stable").astype(np.int32)
        csum = np.cumsum(self.type_counts[self.type_frequency_index],
                         dtype=np.float64)
        self.type_frequency_cumsum = (csum / csum[-1] if csum.size and
                                      csum[-1] > 0 else csum)

    # ---- reference getter surface (CorpusStatistics.java:120-183) -----
    def size(self) -> int:
        return self.corpus_size

    def get_avg_doc_len(self) -> float:
        return self.avg_doc_len

    def get_type_counts(self) -> np.ndarray:
        return self.type_counts

    def get_doc_freqs(self) -> np.ndarray:
        return self.doc_freqs

    def postings(self, type_id: int):
        """(doc_ids, counts) for documents containing `type_id`."""
        s, e = self.inv_indptr[type_id], self.inv_indptr[type_id + 1]
        return self.inv_doc_ids[s:e], self.inv_counts[s:e]

    def term_doc_counts(self) -> np.ndarray:
        """Dense [V, D] count matrix — the reference's invertedIndex
        (CorpusStatistics.java:140-150). Only materialise for small corpora;
        the BM25 scorer works from bags directly."""
        out = np.zeros((self.corpus.num_types, self.corpus.num_docs),
                       np.int32)
        for v in range(self.corpus.num_types):
            docs, cnts = self.postings(v)
            out[v, docs] = cnts
        return out

    def query_candidates(self, query_types) -> np.ndarray:
        """Union of postings for the query's types — the candidate set a
        BM25 search needs to score (reference scores all docs; scoring only
        candidates is strictly faster with identical ranking, since docs
        with no query term score 0)."""
        rows = [self.postings(int(t))[0] for t in np.unique(query_types)]
        if not rows:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(rows)).astype(np.int32)
