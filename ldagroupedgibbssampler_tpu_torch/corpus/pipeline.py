"""Corpus building: tokenize -> vocabulary pruning -> Corpus.

Mirrors the reference's two-sweep loaders (util/LDAUtils.java):
  - `loadDataset` dispatch (:136-186): directory vs single file; TF-IDF-keep
    vs rare-prune vocabulary.
  - `loadInstancesPrune` (:212-331): count pass, drop types occurring fewer
    than `rare_threshold` times in the corpus.
  - `loadInstancesKeep` (:332-467): keep the top `tfidf_vocab_size` types by
    corpus TF-IDF score (pipe/TfIdfPipe.java:15, score formula per
    Configuration-README.txt:74-79: tf * log(D / df)).
"""

from __future__ import annotations

import math
import os
from collections import Counter

import numpy as np

from ldagroupedgibbssampler_tpu_torch.corpus import native_loader
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.corpus.tokenizer import (load_stoplist,
                                                               tokenize)
from ldagroupedgibbssampler_tpu_torch.corpus.uci import (RawDoc,
                                                         read_directory,
                                                         read_uci_file)


def prune_rare(doc_tokens: list[list[str]], threshold: int) -> set[str]:
    """Types kept after rare-word pruning: corpus frequency >= threshold
    (util/LDAUtils.java:212-331). threshold <= 0 keeps everything."""
    counts = Counter(t for doc in doc_tokens for t in doc)
    if threshold <= 0:
        return set(counts)
    return {t for t, c in counts.items() if c >= threshold}


def keep_tfidf_top(doc_tokens: list[list[str]], vocab_size: int) -> set[str]:
    """Top-N types by TF-IDF = tf_corpus * log(D / df)
    (pipe/TfIdfPipe.java; Configuration-README.txt:74-79)."""
    tf: Counter = Counter()
    df: Counter = Counter()
    n_docs = len(doc_tokens)
    for doc in doc_tokens:
        tf.update(doc)
        df.update(set(doc))
    scored = sorted(
        ((tf[t] * math.log(max(n_docs, 1) / df[t]), t) for t in tf),
        reverse=True)
    return {t for _score, t in scored[:vocab_size]}


def _build_corpus_native(raw_docs, stoplist, rare_threshold: int,
                         tokenizer_mode: str, max_doc_tokens,
                         keep_empty_docs: bool) -> Corpus:
    """Native (C++) fast path: tokenize + vocabulary in one call
    (native/fast_tokenizer.cpp), then rare-prune / remap on the id arrays.
    Bit-identical to the Python path (tests/test_torch_native.py)."""
    texts = [d.text for d in raw_docs]
    tokens, offsets, nvocab = native_loader.tokenize_corpus_native(
        texts, stoplist, mode=tokenizer_mode, max_tokens=max_doc_tokens)
    if rare_threshold > 0 and len(nvocab):
        counts = np.bincount(tokens, minlength=len(nvocab))
        kept = counts >= rare_threshold
        # compact remap preserves first-occurrence order (the native ids
        # are already in first-occurrence order)
        new_id = np.cumsum(kept) - 1
        keep_tok = kept[tokens]
        cum = np.concatenate([[0], np.cumsum(keep_tok, dtype=np.int64)])
        lengths = cum[offsets[1:]] - cum[offsets[:-1]]
        tokens = new_id[tokens[keep_tok]].astype(np.int32)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        nvocab = [w for w, k in zip(nvocab, kept) if k]
    if not keep_empty_docs:
        lengths = np.diff(offsets)
        keep_doc = lengths > 0
        # tokens stay contiguous; dropping empty docs only shrinks offsets
        offsets = np.concatenate([[0], np.cumsum(lengths[keep_doc])])
        raw_docs = [d for d, k in zip(raw_docs, keep_doc) if k]
    return Corpus(tokens=tokens, doc_offsets=offsets, vocab=list(nvocab),
                  labels=[d.label for d in raw_docs],
                  doc_ids=[d.doc_id for d in raw_docs])


def build_corpus(raw_docs: list[RawDoc], stoplist_path: str | None = None,
                 rare_threshold: int = 0, tfidf_vocab_size: int = -1,
                 tokenizer_mode: str = "simple", min_token_len: int = 2,
                 max_doc_tokens: int | None = None,
                 vocab: list[str] | None = None,
                 keep_empty_docs: bool = False,
                 native: bool = True) -> Corpus:
    """Tokenize + prune + integerise.

    If `vocab` is given (e.g. building a test set against a trained model's
    alphabet, LDAUtils.loadInstancesKeep's keep-alphabet path), pruning is
    skipped and out-of-vocabulary tokens are dropped.

    The C++ tokenizer (native/fast_tokenizer.cpp) handles the common path
    (no explicit vocab, no TF-IDF, default min token length, ASCII text)
    when a compiler is present, as in the JAX package; `native=False`
    forces the pure-Python reference implementation.
    """
    stoplist = load_stoplist(stoplist_path)
    # The C++ path classifies ASCII only; non-ASCII corpora need the
    # Python tokenizer's full unicodedata categories.
    if (native and vocab is None and tfidf_vocab_size <= 0
            and min_token_len == 2
            and all(d.text.isascii() for d in raw_docs)
            and native_loader.native_available()):
        return _build_corpus_native(raw_docs, stoplist, rare_threshold,
                                    tokenizer_mode, max_doc_tokens,
                                    keep_empty_docs)
    doc_tokens = [tokenize(d.text, stoplist, mode=tokenizer_mode,
                           min_len=min_token_len, max_tokens=max_doc_tokens)
                  for d in raw_docs]

    if vocab is None:
        if tfidf_vocab_size and tfidf_vocab_size > 0:
            kept = keep_tfidf_top(doc_tokens, tfidf_vocab_size)
        else:
            kept = prune_rare(doc_tokens, rare_threshold)
        # Stable id assignment: first-occurrence order, like a MALLET Alphabet.
        vocab = []
        index: dict[str, int] = {}
        for doc in doc_tokens:
            for t in doc:
                if t in kept and t not in index:
                    index[t] = len(vocab)
                    vocab.append(t)
    else:
        index = {t: i for i, t in enumerate(vocab)}

    ids, labels, doc_ids = [], [], []
    for d, doc in zip(raw_docs, doc_tokens):
        doc_int = [index[t] for t in doc if t in index]
        if not doc_int and not keep_empty_docs:
            continue
        ids.append(doc_int)
        labels.append(d.label)
        doc_ids.append(d.doc_id)
    return Corpus.from_token_lists(ids, vocab, labels=labels, doc_ids=doc_ids)


def load_dataset(path: str, stoplist_path: str | None = None,
                 rare_threshold: int = 0, tfidf_vocab_size: int = -1,
                 file_regex: str = r".*\.txt$", vocab: list[str] | None = None,
                 **tokenizer_kw) -> Corpus:
    """Dispatch on file-vs-directory like LDAUtils.loadDataset
    (util/LDAUtils.java:136-186)."""
    if os.path.isdir(path):
        raw = read_directory(path, file_regex=file_regex)
    else:
        raw = read_uci_file(path)
    return build_corpus(raw, stoplist_path=stoplist_path,
                        rare_threshold=rare_threshold,
                        tfidf_vocab_size=tfidf_vocab_size, vocab=vocab,
                        **tokenizer_kw)
