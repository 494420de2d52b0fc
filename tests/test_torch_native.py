"""The port's native (C++) corpus builders against its Python / NumPy paths
and against the JAX package's native modules: the tokenizer in all four
modes, rare pruning, the ASCII / vocabulary / TF-IDF / token-length
conditions of the dispatch, the cell-block and stream-block builders field
by field, the 1M-token switch of both builders, and the build helper
(a library named by its source's hash, built by several workers at once,
a failing compiler raising). Skips only when no C++ compiler is present,
as tests/test_native_loader.py does."""

import concurrent.futures
import inspect

import numpy as np
import pytest

from ldagroupedgibbssampler_tpu.corpus import native_blocks as jax_nb
from ldagroupedgibbssampler_tpu.corpus import pipeline as jax_pipeline
from ldagroupedgibbssampler_tpu.corpus import ragged as jax_ragged
from ldagroupedgibbssampler_tpu.corpus.native_loader import (
    tokenize_corpus_native as jax_tokenize_native)
from ldagroupedgibbssampler_tpu.corpus.uci import RawDoc as JaxRawDoc
from ldagroupedgibbssampler_tpu_torch.corpus import (_native_build,
                                                     native_blocks,
                                                     native_loader, ragged)
from ldagroupedgibbssampler_tpu_torch.corpus.pipeline import build_corpus
from ldagroupedgibbssampler_tpu_torch.corpus.tokenizer import tokenize
from ldagroupedgibbssampler_tpu_torch.corpus.uci import RawDoc

pytestmark = pytest.mark.skipif(not native_loader.native_available(),
                                reason="no C++ compiler (g++) on PATH")

MODES = ("simple", "numeric", "connector", "connector_numeric")
TEXTS = [
    "The Cat sat on the MAT. The cat!",
    "dogs-and_cats co-exist 123 a xy",
    "",
    "short a b cd ef ef ef",
    "snake_case x2y 4th c3po +plus+ a|b $dollar^ back`tick (par) [brk]",
    "tab\tsep\nline\rbreak q\x00nul mixed_123_case CAPS_LOCK",
]
CELL_CASES = [(700, 90, 5000, 1024, 128, 128, 128),
              (50, 10, 200, 256, 16, 8, 64),
              (1000, 50, 900, 512, 64, 16, 128),
              (300, 500, 8000, 1024, 128, 512, 128)]
STREAM_CASES = [(700, 90, 5000, 1024, 128, 128, 128),
                (50, 10, 200, 256, 16, 8, 64),
                (1000, 50, 900, 512, 64, 16, 128),
                (300, 500, 8000, 1024, 128, 128, 128),
                (40, 7, 31, 256, 128, 128, 128)]


def _texts(num_docs=60, seed=0):
    """ASCII documents drawing on every character class of the tokenizer."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "Beta", "gamma_ray", "x", "tiger-paw", "purr42", "oak",
             "a1b2", "__init__", "it's", "e.g.", "$50", "C++", "x^2",
             "road", "BRAKE", "q", "mid~way", "tab\there"]
    return [" ".join(words[i] for i in rng.integers(0, len(words),
                                                   rng.integers(0, 40)))
            for _ in range(num_docs)]


def _python_ids(texts, stoplist=frozenset(), mode="simple", max_tokens=None):
    """The Python tokenizer's ids, first-appearance vocabulary."""
    vocab, index, ids = [], {}, []
    for t in texts:
        row = []
        for tok in tokenize(t, stoplist, mode=mode, max_tokens=max_tokens):
            if tok not in index:
                index[tok] = len(vocab)
                vocab.append(tok)
            row.append(index[tok])
        ids.append(row)
    return ids, vocab


def _raw(texts, cls=RawDoc):
    return [cls(doc_id=str(i), label=f"L{i % 3}", text=t)
            for i, t in enumerate(texts)]


def _same_corpus(a, b):
    assert a.vocab == b.vocab
    assert a.tokens.dtype == b.tokens.dtype
    assert np.array_equal(a.tokens, b.tokens)
    assert a.doc_offsets.dtype == b.doc_offsets.dtype
    assert np.array_equal(a.doc_offsets, b.doc_offsets)
    assert a.labels == b.labels and a.doc_ids == b.doc_ids


def _same_fields(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name
    assert (a.nwin_w, a.nwin_d, a.vspan, a.dspan, a.chunk) == (
        b.nwin_w, b.nwin_d, b.vspan, b.dspan, b.chunk)


def _calls(name):
    return _native_build.calls[name]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stop,cap", [(frozenset(), None),
                                      (frozenset({"the", "cat", "oak"}), 3)])
def test_tokenizer_parity(mode, stop, cap):
    texts = TEXTS + _texts(seed=len(mode))
    before = _calls("tokenize_corpus_native")
    tokens, offsets, vocab = native_loader.tokenize_corpus_native(
        texts, stoplist=stop, mode=mode, max_tokens=cap)
    assert _calls("tokenize_corpus_native") == before + 1
    py_ids, py_vocab = _python_ids(texts, stoplist=stop, mode=mode,
                                   max_tokens=cap)
    assert vocab == py_vocab
    assert tokens.dtype == np.int32 and offsets.dtype == np.int64
    assert np.array_equal(tokens, [t for doc in py_ids for t in doc])
    assert np.array_equal(np.diff(offsets), [len(d) for d in py_ids])
    if cap is not None:
        assert np.diff(offsets).max() <= cap
    jt, jo, jv = jax_tokenize_native(texts, stoplist=stop, mode=mode,
                                     max_tokens=cap)
    assert jv == vocab
    assert np.array_equal(jt, tokens) and np.array_equal(jo, offsets)


def test_tokenizer_of_no_documents():
    tokens, offsets, vocab = native_loader.tokenize_corpus_native([])
    assert tokens.shape == (0,) and np.array_equal(offsets, [0])
    assert vocab == []


@pytest.mark.parametrize("threshold", [0, 2, 3])
@pytest.mark.parametrize("keep_empty", [False, True])
def test_rare_prune_parity(threshold, keep_empty):
    texts = TEXTS + _texts(seed=7)
    kw = dict(rare_threshold=threshold, stoplist_path=None,
              keep_empty_docs=keep_empty)
    before = _calls("tokenize_corpus_native")
    cn = build_corpus(_raw(texts), **kw)
    assert _calls("tokenize_corpus_native") == before + 1
    cp = build_corpus(_raw(texts), native=False, **kw)
    assert _calls("tokenize_corpus_native") == before + 1
    _same_corpus(cn, cp)
    _same_corpus(cn, jax_pipeline.build_corpus(_raw(texts, JaxRawDoc), **kw))


@pytest.mark.parametrize("case,native", [
    (dict(), True),
    (dict(non_ascii=True), False),
    (dict(vocab=True), False),
    (dict(tfidf_vocab_size=20), False),
    (dict(min_token_len=3), False),
    (dict(native=False), False),
])
def test_dispatch_conditions_equal_jax(case, native, monkeypatch, tmp_path):
    """The native tokenizer runs under exactly the JAX conditions: ASCII
    text, no vocabulary, no TF-IDF, min_token_len 2, native not refused;
    the corpus is the same either way and equals the JAX package's."""
    texts = _texts(seed=3)
    if case.get("non_ascii"):
        texts[5] += " café naïve"
    kw = {k: v for k, v in case.items() if k != "non_ascii"}
    stop = tmp_path / "stop.txt"
    stop.write_text("oak\nroad\n")
    kw["stoplist_path"] = str(stop)
    if kw.get("vocab"):
        kw["vocab"] = ["alpha", "oak", "tiger", "purr", "gamma_ray"]
    jax_took = []
    real = jax_pipeline._build_corpus_native
    monkeypatch.setattr(jax_pipeline, "_build_corpus_native",
                        lambda *a, **k: jax_took.append(1) or real(*a, **k))
    before = _calls("tokenize_corpus_native")
    ours = build_corpus(_raw(texts), **kw)
    took = _calls("tokenize_corpus_native") - before
    ref = jax_pipeline.build_corpus(_raw(texts, JaxRawDoc), **kw)
    assert took == len(jax_took) == int(native)
    _same_corpus(ours, ref)
    if native:
        _same_corpus(ours, build_corpus(_raw(texts), native=False, **kw))


def test_without_a_compiler_the_python_path_runs(monkeypatch):
    texts = _texts(seed=11)
    expect = build_corpus(_raw(texts), rare_threshold=2)
    monkeypatch.setattr(_native_build, "CXX", "no-such-compiler-on-path")
    assert not native_loader.native_available()
    assert not native_blocks.native_available()
    assert not native_blocks.stream_native_available()
    before = dict(_native_build.calls)
    _same_corpus(build_corpus(_raw(texts), rare_threshold=2), expect)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 50, 400).astype(np.int32)
    docs = np.sort(rng.integers(0, 9, 400)).astype(np.int32)
    kw = dict(block=256, vspan=16, dspan=8, chunk=64)
    assert native_blocks.build_cell_blocks_native(toks, docs, 50, 9,
                                                  **kw) is None
    assert native_blocks.build_stream_blocks_native(toks, docs, 50, 9,
                                                    **kw) is None
    b = ragged.build_stream_blocks(toks, docs, 50, 9, native_threshold=0,
                                   **kw)
    _same_fields(b, ragged.build_stream_blocks_seq(toks, docs, 50, 9, **kw),
                 ("w_local", "d_local", "mask", "flat_index",
                  "win_w_chunks", "win_d_chunks"))
    assert dict(_native_build.calls) == before


def _case_arrays(case, seed):
    v, d, n = case[:3]
    rng = np.random.default_rng(seed)
    toks = np.minimum(rng.integers(0, v, n),
                      rng.integers(0, v, n)).astype(np.int32)
    docs = np.sort(rng.integers(0, d, n)).astype(np.int32)
    return toks, docs


CELL_FIELDS = ("w_local", "doc_ids", "mask", "win_w", "first_w",
               "flat_index", "d_local_a", "win_d_chunks", "src_chunks",
               "d_local", "win_d", "first_d")
STREAM_FIELDS = ("w_local", "d_local", "mask", "flat_index", "win_w_chunks",
                 "win_d_chunks")


@pytest.mark.parametrize("case", CELL_CASES)
def test_cell_blocks_native_bit_identical(case):
    v, d, _, block, vspan, dspan, chunk = case
    toks, docs = _case_arrays(case, seed=1)
    kw = dict(block=block, vspan=vspan, dspan=dspan, chunk=chunk)
    before = _calls("build_cell_blocks_native")
    a = native_blocks.build_cell_blocks_native(toks, docs, v, d, **kw)
    assert a is not None
    assert _calls("build_cell_blocks_native") == before + 1
    _same_fields(a, ragged.build_cell_blocks(toks, docs, v, d, **kw),
                 CELL_FIELDS)
    _same_fields(a, ragged.build_cell_blocks_reference(toks, docs, v, d,
                                                       **kw), CELL_FIELDS)
    _same_fields(a, jax_nb.build_cell_blocks_native(toks, docs, v, d, **kw),
                 CELL_FIELDS)
    _same_fields(a, jax_ragged.build_cell_blocks(toks, docs, v, d, **kw),
                 CELL_FIELDS)


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_blocks_native_bit_identical(case):
    v, d, _, block, vspan, dspan, chunk = case
    toks, docs = _case_arrays(case, seed=2)
    kw = dict(block=block, vspan=vspan, dspan=dspan, chunk=chunk)
    before = _calls("build_stream_blocks_native")
    a = native_blocks.build_stream_blocks_native(toks, docs, v, d, **kw)
    assert a is not None
    assert _calls("build_stream_blocks_native") == before + 1
    _same_fields(a, ragged.build_stream_blocks_seq(toks, docs, v, d, **kw),
                 STREAM_FIELDS)
    _same_fields(a, jax_nb.build_stream_blocks_native(toks, docs, v, d,
                                                      **kw), STREAM_FIELDS)
    _same_fields(a, jax_ragged.build_stream_blocks_seq(toks, docs, v, d,
                                                       **kw), STREAM_FIELDS)


def test_native_builders_refuse_what_jax_refuses():
    """A block that is not a multiple of chunk (both builders), or a d-span
    above chunk (stream blocks): None, as the JAX builders return."""
    toks, docs = _case_arrays((50, 10, 200), seed=3)
    kw = dict(block=200, vspan=16, dspan=8, chunk=64)
    assert native_blocks.build_cell_blocks_native(toks, docs, 50, 10,
                                                  **kw) is None
    assert jax_nb.build_cell_blocks_native(toks, docs, 50, 10, **kw) is None
    kw = dict(block=256, vspan=16, dspan=128, chunk=64)
    assert native_blocks.build_stream_blocks_native(toks, docs, 50, 10,
                                                    **kw) is None
    assert jax_nb.build_stream_blocks_native(toks, docs, 50, 10,
                                             **kw) is None


@pytest.mark.parametrize("builder", ["cell", "stream"])
@pytest.mark.parametrize("n", [999_999, 1_000_000])
def test_native_switch_at_one_million_tokens_as_in_jax(builder, n,
                                                       monkeypatch):
    """Both builders take the native path from 1,000,000 tokens on and the
    NumPy path below, as the JAX package's do (its native calls recorded
    through its module), with the same output."""
    rng = np.random.default_rng(n)
    v, d = 5000, 3000
    toks = rng.integers(0, v, n).astype(np.int32)
    docs = np.sort(rng.integers(0, d, n)).astype(np.int32)
    kw = dict(block=4096, vspan=128, dspan=128, chunk=128)
    name = f"build_{builder}_blocks"
    jax_took = []
    real = getattr(jax_nb, f"{name}_native")
    monkeypatch.setattr(jax_nb, f"{name}_native",
                        lambda *a, **k: jax_took.append(1) or real(*a, **k))
    before = _calls(f"{name}_native")
    ours = getattr(ragged, name)(toks, docs, v, d, **kw)
    took = _calls(f"{name}_native") - before
    ref = getattr(jax_ragged, name)(toks, docs, v, d, **kw)
    assert took == len(jax_took) == int(n >= 1_000_000)
    _same_fields(ours, ref, CELL_FIELDS if builder == "cell"
                 else STREAM_FIELDS)


def test_thresholds_equal_jax():
    jax_default = inspect.signature(
        jax_ragged.build_stream_blocks).parameters["native_threshold"].default
    ours = inspect.signature(
        ragged.build_stream_blocks).parameters["native_threshold"].default
    assert ours == jax_default == ragged.NATIVE_THRESHOLD == 1_000_000
    assert "n >= 1_000_000" in inspect.getsource(jax_ragged.build_cell_blocks)


def test_sources_are_copies_of_the_jax_packages():
    """The port builds its own copies of the repo's native sources, which
    are unchanged."""
    import pathlib
    root = pathlib.Path(_native_build.NATIVE_DIR).parents[1] / "native"
    for name in ("fast_tokenizer", "cell_blocks", "stream_blocks"):
        ours = (_native_build.NATIVE_DIR / f"{name}.cpp").read_bytes()
        assert ours == (root / f"{name}.cpp").read_bytes(), name


def test_library_named_by_source_hash_and_built_once_by_many(monkeypatch,
                                                             tmp_path):
    """Four builders at once into an empty directory: one library, named
    lib<name>-<hash>.so, no temporary file left; a second build reuses it;
    other flags give another name."""
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(_native_build.build, ["stream_blocks"] * 4))
    assert len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert paths[0].name.startswith("libstream_blocks-")
    mtime = paths[0].stat().st_mtime_ns
    assert _native_build.build("stream_blocks") == paths[0]
    assert paths[0].stat().st_mtime_ns == mtime
    monkeypatch.setattr(_native_build, "CXX_FLAGS",
                        _native_build.CXX_FLAGS + ["-DUNUSED_FLAG"])
    assert _native_build.library_path("stream_blocks") != paths[0]


def test_a_failing_compiler_raises_with_its_stderr(monkeypatch, tmp_path):
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native_build, "CXX_FLAGS",
                        _native_build.CXX_FLAGS + ["-DX=", "-include",
                                                   "no_such_header.h"])
    with pytest.raises(RuntimeError, match="no_such_header"):
        _native_build.build("cell_blocks")
    assert list(tmp_path.iterdir()) == []


def test_build_corpus_native_false_is_the_python_path():
    texts = _texts(seed=5)
    before = _calls("tokenize_corpus_native")
    c = build_corpus(_raw(texts), native=False)
    assert _calls("tokenize_corpus_native") == before
    ids, vocab = _python_ids(texts)
    assert c.vocab == vocab
    kept = [row for row in ids if row]
    assert np.array_equal(c.tokens, [t for row in kept for t in row])
