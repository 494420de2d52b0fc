"""Evaluation: likelihoods, held-out estimators, fold-in, diagnostics and
top-word extraction."""

from ldagroupedgibbssampler_tpu_torch.evaluation.topwords import (  # noqa: F401
    calc_k1, top_distinctive_words, top_relevance_words, top_salient_words,
    top_word_indices, top_words)
