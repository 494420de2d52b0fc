"""Similarity layer — batched device equivalents of ``cc.mallet.similarity``
(the port's counterpart of `ldagroupedgibbssampler_tpu/similarity/`)."""

from ldagroupedgibbssampler_tpu_torch.similarity.bm25 import (BM25Searcher,
                                                              bm25f,
                                                              bm25fext, idf)
from ldagroupedgibbssampler_tpu_torch.similarity.corpus_statistics import (
    CorpusStatistics)
from ldagroupedgibbssampler_tpu_torch.similarity.distances import (
    DISTANCES, Distance, pairwise)
from ldagroupedgibbssampler_tpu_torch.similarity.lda_distancer import (
    LDADistancer)

__all__ = ["BM25Searcher", "bm25f", "bm25fext", "idf", "CorpusStatistics",
           "DISTANCES", "Distance", "pairwise", "LDADistancer"]
