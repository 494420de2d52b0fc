"""ctypes bindings for the native corpus tokenizer (native/fast_tokenizer.cpp
of this package).

The port's own copy of the JAX package's `corpus/native_loader.py`, with
the same signature and output. The shared library is built at first use
by `corpus/_native_build.py`. `native_available()` is False when no C++
compiler is present, and callers then take the pure-Python tokenizer
(corpus/tokenizer.py), which remains the executable specification:
tests/test_torch_native.py asserts token-for-token equality between the
two paths.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ldagroupedgibbssampler_tpu_torch.corpus import _native_build

_MODES = {"simple": 0, "numeric": 1, "connector": 2,
          "connector_numeric": 3}
_I64 = ctypes.c_int64
_SIGNATURES = (
    ("tokenize_corpus", ctypes.c_void_p,
     (ctypes.c_char_p, ctypes.POINTER(_I64), _I64, ctypes.c_char_p, _I64,
      ctypes.c_int, _I64)),
    ("corpus_num_tokens", _I64, (ctypes.c_void_p,)),
    ("corpus_num_docs", _I64, (ctypes.c_void_p,)),
    ("corpus_vocab_size", _I64, (ctypes.c_void_p,)),
    ("corpus_copy_tokens", None,
     (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32))),
    ("corpus_copy_offsets", None, (ctypes.c_void_p, ctypes.POINTER(_I64))),
    ("corpus_vocab_blob", _I64, (ctypes.c_void_p, ctypes.c_char_p)),
    ("corpus_free", None, (ctypes.c_void_p,)),
)


def native_available() -> bool:
    """Whether the native tokenizer can run: a C++ compiler is present
    (the library builds at the first call)."""
    return _native_build.compiler_available()


def tokenize_corpus_native(texts: list[str], stoplist=frozenset(),
                           mode: str = "simple",
                           max_tokens: int | None = None):
    """Tokenize all documents in one native call.

    Returns (tokens int32[N], doc_offsets int64[D+1], vocab list[str]) with
    semantics identical to tokenizer.tokenize applied per document
    (vocabulary ids assigned in first-appearance order, matching the
    Python pipeline's ordering).
    """
    if not native_available():
        raise RuntimeError("native tokenizer unavailable: no C++ compiler")
    lib = _native_build.library("fast_tokenizer", _SIGNATURES)
    # one blob, documents separated by one NUL byte (transparent to the
    # tokenizer); offsets[d] is where document d's bytes start
    blob = "\x00".join(texts).encode("utf-8", errors="replace")
    lengths = np.fromiter(
        (len(t) if t.isascii() else len(t.encode("utf-8", errors="replace"))
         for t in texts), np.int64, count=len(texts))
    offsets = np.zeros(len(texts) + 1, np.int64)
    np.cumsum(lengths + 1, out=offsets[1:])
    offsets[-1] = len(blob)
    stop_blob = "\n".join(sorted(stoplist)).encode("utf-8")
    handle = lib.tokenize_corpus(
        blob, offsets.ctypes.data_as(ctypes.POINTER(_I64)), len(texts),
        stop_blob, len(stop_blob), _MODES[mode],
        -1 if max_tokens is None else int(max_tokens))
    try:
        n = lib.corpus_num_tokens(handle)
        d = lib.corpus_num_docs(handle)
        tokens = np.zeros(n, np.int32)
        doc_offsets = np.zeros(d + 1, np.int64)
        if n:
            lib.corpus_copy_tokens(
                handle, tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        lib.corpus_copy_offsets(
            handle, doc_offsets.ctypes.data_as(ctypes.POINTER(_I64)))
        size = lib.corpus_vocab_blob(handle, None)
        buf = ctypes.create_string_buffer(size)
        lib.corpus_vocab_blob(handle, buf)
        vocab = buf.raw.decode("utf-8").split("\n")[:-1] if size else []
    finally:
        lib.corpus_free(handle)
    _native_build.calls["tokenize_corpus_native"] += 1
    return tokens, doc_offsets, vocab
