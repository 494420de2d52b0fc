"""The port's similarity layer on the CPU against the JAX package: the 14
distance metrics on the same inputs (exact zeros included), the tiled
evaluation against the untiled one, the products' independence of the TF32
flag, CorpusStatistics (equal arrays), BM25 (scores with and without the
doc-length quirk), LDADistancer given the JAX model's state and the same
fold-in, and the planted-corpus bars of tests/test_similarity_classify.py
on the port's own chains."""

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config import LDAConfig as JaxConfig
from ldagroupedgibbssampler_tpu.similarity import bm25 as jax_bm25
from ldagroupedgibbssampler_tpu.similarity import distances as jax_distances
from ldagroupedgibbssampler_tpu.similarity import (
    lda_distancer as jax_lda_distancer)
from ldagroupedgibbssampler_tpu.similarity.corpus_statistics import (
    CorpusStatistics as JaxCorpusStatistics)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.foldin import fold_in
from ldagroupedgibbssampler_tpu_torch.similarity import (BM25Searcher,
                                                         CorpusStatistics,
                                                         DISTANCES, Distance,
                                                         LDADistancer, bm25f,
                                                         bm25fext, idf,
                                                         pairwise)
from ldagroupedgibbssampler_tpu_torch.similarity import distances
from ldagroupedgibbssampler_tpu_torch.similarity import (
    lda_distancer as port_lda_distancer)
from torch_apps_support import (  # noqa: F401 (an autouse fixture)
    assert_same_fold_in_inputs, carry_jax_models, doc_lists, jax_corpus,
    one_torch_thread, patch_fold_in, planted)

# the JAX tests' own bars (tests/test_similarity_classify.py)
LOOSE = {"hellinger", "euclidean", "statistical", "t", "uber"}
PRODUCTS = ("kl", "hellinger", "euclidean", "cosine", "statistical")


def _probs(rng, n, k):
    """Probability rows with exact zeros: ~30% of the coordinates, the
    first two columns of every row (Canberra's 0/0), and row 0 supported
    on the upper half only."""
    x = rng.gamma(1.0, 1.0, (n, k))
    x[rng.random((n, k)) < 0.3] = 0.0
    x[:, :2] = 0.0
    x[0, :k // 2] = 0.0
    x[0, k // 2:] += 0.1
    return x / x.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def xy():
    """(M, N, K) = (7, 9, 12); Y's row 1 is supported on the lower half
    only, so the pair (0, 1) has an empty intersection (Jaccard's 0, KL's
    dropped terms everywhere)."""
    rng = np.random.default_rng(0)
    X, Y = _probs(rng, 7, 12), _probs(rng, 9, 12)
    Y[1, 6:] = 0.0
    Y[1, :6] = rng.gamma(1.0, 1.0, 6) + 0.1
    Y[1] /= Y[1].sum()
    return X, Y


@pytest.mark.parametrize("name", sorted(DISTANCES))
def test_distance_equals_jax(xy, name):
    X, Y = xy
    ref = np.asarray(jax_distances.DISTANCES[name](X, Y))
    got = pairwise(name, X, Y, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (7, 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 if name in LOOSE else 1e-5)
    dist = Distance(name, device="cpu")
    np.testing.assert_array_equal(dist.pairwise(X, Y), got.numpy())
    assert dist.calculate(X[2], Y[3]) == pytest.approx(float(ref[2, 3]),
                                                       abs=1e-4)


@pytest.mark.parametrize("name", sorted(DISTANCES))
def test_tiled_equals_untiled(xy, name, monkeypatch):
    """A budget of 1 byte forces tiles of one row pair; the result equals
    one untiled call."""
    X, Y = xy
    whole = pairwise(name, X, Y, device="cpu")
    calls = []
    fn = DISTANCES[name]
    if fn.temps:
        real = fn.block
        monkeypatch.setattr(fn, "block",
                            lambda x, y: calls.append(x.shape[0] * y.shape[0])
                            or real(x, y))
    monkeypatch.setattr(distances, "WORKING_SET_BYTES", 1)
    tiled = pairwise(name, X, Y, device="cpu")
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    # tiled metrics ran one pair a tile; the products needed no tile
    assert calls == ([1] * 63 if fn.temps else [])


def test_tile_sizes_follow_the_budget(monkeypatch):
    """Each tile's (m, n, K) intermediates stay within the budget."""
    X = torch.rand(50, 16)
    Y = torch.rand(40, 16)
    sizes = []
    real = distances.js.block
    monkeypatch.setattr(distances.js, "block", lambda x, y: sizes.append(
        (x.shape[0], y.shape[0])) or real(x, y))
    budget = distances.js.temps * 4 * 16 * 40 * 3      # 3 rows of all Y
    monkeypatch.setattr(distances, "WORKING_SET_BYTES", budget)
    out = distances.js(X, Y)
    assert out.shape == (50, 40)
    assert sizes[0] == (3, 40) and len(sizes) == 17
    assert all(m * n * 16 * 4 * distances.js.temps <= budget
               for m, n in sizes)


@pytest.mark.parametrize("name", PRODUCTS)
def test_products_ignore_the_tf32_flag(xy, name):
    """The metrics built on products give one result whatever the
    process's TF32 flag, and put the flag back."""
    X, Y = xy
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = pairwise(name, X, Y, device="cpu")
        torch.backends.cuda.matmul.allow_tf32 = True
        on = pairwise(name, X, Y, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(on, off)


def test_exact_matmul_restores_the_flag_on_error():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(ZeroDivisionError):
            with distances.exact_matmul():
                assert torch.backends.cuda.matmul.allow_tf32 is False
                raise ZeroDivisionError
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_identical_vectors_and_unknown_name(xy):
    v = xy[0][3]
    for name in ("kl", "js", "hellinger", "manhattan", "chebychev",
                 "canberra", "cosine", "ks"):
        assert Distance(name, device="cpu").calculate(v, v) == \
            pytest.approx(0.0, abs=1e-5), name
    # euclidean is sqrt(|x|^2 + |y|^2 - 2 x.y), as in the JAX package: at
    # x == y the square root of the float32 cancellation, whose size is
    # sqrt(eps * |x|^2) ~ 3e-4 here, not 0
    assert Distance("euclidean", device="cpu").calculate(v, v) < \
        np.sqrt(np.finfo(np.float32).eps * 4 * (v @ v))
    with pytest.raises(ValueError, match="unknown distance"):
        Distance("bogus", device="cpu")


@pytest.mark.parametrize("make", [
    lambda: Distance("kl"),
    lambda: pairwise("kl", np.ones((1, 2)), np.ones((1, 2))),
    lambda: BM25Searcher(Corpus.from_token_lists([[0]], ["a"])),
    lambda: LDADistancer(LDAConfig()),
], ids=["Distance", "pairwise", "BM25Searcher", "LDADistancer"])
def test_entry_points_ask_for_cuda(make, monkeypatch):
    """The default device is cuda, and without a card that raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make()


def _mini_corpus():
    # doc0: a a b | doc1: b c | doc2: a
    return Corpus.from_token_lists([[0, 0, 1], [1, 2], [0]], ["a", "b", "c"])


@pytest.mark.parametrize("which", ["mini", "planted"])
def test_corpus_statistics_equal_jax(which):
    c = _mini_corpus() if which == "mini" else planted()
    ours, ref = CorpusStatistics(c), JaxCorpusStatistics(jax_corpus(c))
    for name in ("type_counts", "doc_freqs", "inv_indptr", "inv_doc_ids",
                 "inv_counts", "type_frequency_index",
                 "type_frequency_cumsum"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (ours.corpus_size, ours.corpus_word_count, ours.avg_doc_len) == (
        ref.corpus_size, ref.corpus_word_count, ref.avg_doc_len)
    assert np.array_equal(ours.term_doc_counts(), ref.term_doc_counts())
    assert np.array_equal(ours.query_candidates([0, 2]),
                          ref.query_candidates([0, 2]))
    if which == "mini":
        np.testing.assert_array_equal(ours.type_counts, [3, 2, 1])
        np.testing.assert_array_equal(ours.postings(0)[0], [0, 2])


def test_bm25_term_scores_equal_jax():
    rng = np.random.default_rng(5)
    tf, dl = rng.integers(0, 6, 20) * 1.0, rng.integers(1, 30, 20) * 1.0
    df, qtf = rng.integers(1, 10, 20) * 1.0, rng.integers(1, 4, 20) * 1.0
    for ours, ref in (
            (idf(10.0, torch.as_tensor(df, dtype=torch.float32)),
             jax_bm25.idf(10.0, df.astype(np.float32))),
            (bm25f(torch.as_tensor(tf), 10.0, torch.as_tensor(dl), 12.5,
                   torch.as_tensor(df, dtype=torch.float32)),
             jax_bm25.bm25f(tf, 10.0, dl, 12.5, df)),
            (bm25fext(tf, 10.0, dl, 12.5, qtf, df),
             jax_bm25.bm25fext(tf, 10.0, dl, 12.5, qtf, df))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    # the idf floor of 0.1 (df so high that idf < 0)
    K = 1.2 * ((1 - 0.75) + 0.75 * 5 / 4)
    assert float(bm25f(1.0, 10.0, 5.0, 4.0, 9.0)) == pytest.approx(
        (2.2 * 1) / (K + 1) * 0.1, rel=1e-5)


@pytest.mark.parametrize("quirk", [False, True], ids=["doclen", "quirk"])
def test_bm25_score_and_search_equal_jax(quirk):
    train = planted(doc_len=30)
    queries = planted(num_docs=12, doc_len=25, seed=3)
    ours = BM25Searcher(train, reference_doclen_quirk=quirk, device="cpu")
    ref = jax_bm25.BM25Searcher(jax_corpus(train),
                                reference_doclen_quirk=quirk)
    got, want = ours.score(queries), ref.score(jax_corpus(queries))
    assert got.shape == (12, 60) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    idx, top = ours.search(queries, top_n=3)
    jidx, _ = ref.search(jax_corpus(queries), top_n=3)
    srt = -np.sort(-want, axis=1)
    untied = np.abs(srt[:, :3] - srt[:, 1:4]).min(axis=1) > 1e-4
    assert untied.sum() >= 6
    np.testing.assert_array_equal(idx[untied], jidx[untied])
    np.testing.assert_array_equal(top, np.take_along_axis(got, idx, 1))


def test_bm25_self_retrieval():
    rng = np.random.default_rng(3)
    V, D = 50, 12
    docs = [list(np.concatenate([rng.integers(d * 4, d * 4 + 4, 30),
                                 rng.integers(0, V, 5)])) for d in range(D)]
    corpus = Corpus.from_token_lists(docs, [f"w{i}" for i in range(V)])
    idx, scores = BM25Searcher(corpus, device="cpu").search(corpus, top_n=1)
    assert (idx[:, 0] == np.arange(D)).mean() >= 0.9
    assert np.all(scores > 0)


def _with_empty_docs():
    """The planted corpus with an empty document appended (train) and a
    query set of 8 planted documents plus an empty one (test)."""
    c = planted()
    train = Corpus.from_token_lists(doc_lists(c) + [[]], c.vocab,
                                    labels=list(c.labels) + ["0"])
    q = planted(num_docs=8, seed=9)
    test = Corpus.from_token_lists(doc_lists(q) + [[]], c.vocab)
    return train, test


@pytest.mark.parametrize("scheme", ["spalias", "ggs"])
def test_distancer_given_the_same_state_equals_jax(scheme, monkeypatch):
    """JAX and port distancers trained to one state (the JAX chain's,
    carried into the port) and given one fold-in give one distance
    matrix, with the zero-length cells (inf, 0) equal."""
    train, test = _with_empty_docs()
    carry_jax_models(monkeypatch, port_modules=[port_lda_distancer])
    seen = patch_fold_in(monkeypatch, [jax_lda_distancer],
                         [port_lda_distancer])
    kw = dict(topics=3, alpha=0.5, beta=0.01, seed=7, iterations=15,
              exec_time=-1)
    ref = jax_lda_distancer.LDADistancer(JaxConfig(scheme=scheme, **kw),
                                         scheme=scheme)
    ref.train(jax_corpus(train), iterations=15)
    ours = port_lda_distancer.LDADistancer(
        LDAConfig(scheme=scheme, device="cpu", **kw), scheme=scheme)
    ours.train(train, iterations=15)
    np.testing.assert_array_equal(ours.train_thetas, ref.train_thetas)
    want = ref.distance(jax_corpus(test), fold_in_iterations=12)
    got = ours.distance(test, fold_in_iterations=12)
    assert_same_fold_in_inputs(seen, [7 + 17])
    assert got.shape == want.shape == (9, 61)
    for cells in (np.isinf, lambda d: d == 0):
        np.testing.assert_array_equal(cells(got), cells(want))
    assert np.isinf(got[:8, 60]).all() and np.isinf(got[8, :60]).all()
    assert got[8, 60] == 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours.sampled_test_topics,
                                  ref.sampled_test_topics)
    # ranking on the host: the same order where the distances are untied
    order, _ = ours.closest(test, n=1, fold_in_iterations=12)
    jorder, _ = ref.closest(jax_corpus(test), n=1, fold_in_iterations=12)
    np.testing.assert_array_equal(order[:8], jorder[:8])


def test_distancer_planted_classes_nearer():
    cfg = LDAConfig(scheme="spalias", topics=3, alpha=0.5, beta=0.01,
                    seed=7, iterations=40, exec_time=-1, device="cpu")
    corpus = planted()
    distancer = LDADistancer(cfg)
    distancer.train(corpus, iterations=40)
    D = distancer.distance(corpus.subset(np.arange(6)), fold_in_iterations=30)
    assert D.shape == (6, 60) and np.all(np.isfinite(D))
    labels = np.asarray([int(c) for c in corpus.labels])
    same = np.asarray([D[i, labels == labels[i]].mean() for i in range(6)])
    other = np.asarray([D[i, labels != labels[i]].mean() for i in range(6)])
    assert (same < other).mean() >= 0.8
    distancer.set_dist("hellinger")
    assert distancer.dist.name == "hellinger"


def test_distancer_zero_length_docs():
    """Empty documents through the port's cell blocks in ggs training and
    fold-in: +inf against a non-empty document, 0 against an empty one."""
    vocab = ["a", "b"]
    train = Corpus.from_token_lists([[0, 1, 0], [], [1, 1]], vocab)
    cfg = LDAConfig(scheme="ggs", topics=2, alpha=0.5, beta=0.01, seed=3,
                    iterations=10, exec_time=-1, device="cpu")
    distancer = LDADistancer(cfg, scheme="ggs")
    distancer.train(train, iterations=10)
    D = distancer.distance(Corpus.from_token_lists([[0], []], vocab),
                           fold_in_iterations=10)
    assert D[0, 1] == np.inf and D[1, 0] == np.inf and D[1, 2] == np.inf
    assert D[1, 1] == 0.0
    assert np.isfinite(D[0, [0, 2]]).all()


def test_fold_in_recovers_planted_mixture_and_empty_docs():
    V, K = 8, 2
    phi = np.zeros((K, V))
    phi[0, :4] = 0.25
    phi[1, 4:] = 0.25
    corpus = Corpus.from_token_lists(
        [[0, 1, 2, 3, 0, 1], [4, 5, 6, 7, 4, 5], [0, 1, 4, 5], []],
        [f"w{i}" for i in range(V)])
    gen = torch.Generator().manual_seed(0)
    res = fold_in(torch.as_tensor(phi, dtype=torch.float32), corpus, 0.1,
                  gen, iterations=50)
    ndk, theta = res.ndk.numpy(), res.theta_mean.numpy()
    np.testing.assert_array_equal(ndk.sum(axis=1), [6, 6, 4, 0])
    assert theta[0, 0] > 0.9 and theta[1, 1] > 0.9
    assert 0.2 < theta[2, 0] < 0.8


def test_fold_in_of_no_documents_is_empty_as_in_jax():
    """A corpus with no documents (an id file that matches none) folds in
    to empty n_dk and theta, as the JAX fold-in returns."""
    import jax
    from ldagroupedgibbssampler_tpu.evaluation.foldin import (
        fold_in as jax_fold_in)
    corpus = Corpus.from_token_lists([], ["a", "b", "c"])
    phi = np.full((2, 3), 1 / 3)
    res = fold_in(torch.as_tensor(phi, dtype=torch.float32), corpus, 0.1,
                  torch.Generator().manual_seed(0), iterations=3)
    ndk, theta = jax_fold_in(jax.random.key(0), phi, jax_corpus(corpus), 0.1,
                             iterations=3)
    assert res.ndk.shape == ndk.shape == (0, 2)
    assert res.theta_mean.shape == theta.shape == (0, 2)
    assert res.nkw_vk.shape == (3, 2) and int(res.nkw_vk.sum()) == 0
    assert res.flat_z().shape == (0,)
