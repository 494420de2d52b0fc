"""Held-out evaluation of the port on the CPU against the JAX package: the
perplexity split and padded layouts (exact), the left-to-right estimator
(given the JAX function's own Gumbel draws), fold-in on the plain versions
of the z-draw and count kernels (statistical), sample_z_given_phi, the
chain left untouched by held-out evaluation, and the CLI's test_dataset."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.corpus import perplexity as jax_perplexity
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.evaluation import foldin as jax_foldin
from ldagroupedgibbssampler_tpu.evaluation import marginal as jax_marginal
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus import perplexity
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation import marginal
from ldagroupedgibbssampler_tpu_torch.evaluation.foldin import fold_in
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.tui import parallel_lda

CFG = dict(topics=3, alpha=0.5, beta=0.01, exec_time=-1, token_block=512)


def _planted(num_docs=60, doc_len=40, seed=42):
    """tests/conftest.py's synthetic_corpus (3 planted topics, 10 types
    each), as a port Corpus with labels and ids."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{k}_{i}" for k in range(3) for i in range(10)]
    docs = []
    for d in range(num_docs):
        k = d % 3
        main = rng.integers(0, 10, int(doc_len * 0.9)) + k * 10
        noise = rng.integers(0, len(vocab), doc_len - len(main))
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(docs, vocab,
                                   labels=[str(d % 3) for d in range(num_docs)],
                                   doc_ids=[f"d{d}" for d in range(num_docs)])


def _jax_corpus(c: Corpus) -> JaxCorpus:
    return JaxCorpus(tokens=c.tokens, doc_offsets=c.doc_offsets,
                     vocab=c.vocab, labels=list(c.labels),
                     doc_ids=list(c.doc_ids))


def _same_corpus(a, b):
    return (np.array_equal(a.tokens, b.tokens)
            and np.array_equal(a.doc_offsets, b.doc_offsets)
            and list(a.vocab) == list(b.vocab)
            and list(a.labels) == list(b.labels)
            and list(a.doc_ids) == list(b.doc_ids))


def _true_phi():
    phi = np.full((3, 30), 1e-3)
    for k in range(3):
        phi[k, k * 10:(k + 1) * 10] = 1.0
    return phi / phi.sum(1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    return _planted()


# ---------------------------------------------------------------------------
# the split and the padded layouts: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_perplexity_split_and_folds_equal_jax(corpus, seed):
    ours = perplexity.build_perplexity_split(corpus, 0.2, seed=seed)
    ref = jax_perplexity.build_perplexity_split(_jax_corpus(corpus), 0.2,
                                                seed=seed)
    for a, b in zip(ours, ref):
        assert _same_corpus(a, b)
    for (tr_a, te_a), (tr_b, te_b) in zip(
            perplexity.cross_validation_folds(corpus.num_docs, 5, seed),
            jax_perplexity.cross_validation_folds(corpus.num_docs, 5, seed)):
        assert np.array_equal(tr_a, tr_b) and np.array_equal(te_a, te_b)


@pytest.mark.parametrize("layout", ["to_padded", "flat_padded", "subset"])
def test_padded_layouts_and_subset_equal_jax(corpus, layout):
    jc = _jax_corpus(corpus)
    if layout == "subset":
        idx = np.array([5, 0, 17, 59, 3])
        assert _same_corpus(corpus.subset(idx), jc.subset(idx))
        return
    for arg in (1, 8, 64) if layout == "to_padded" else (1, 256, 512):
        for a, b in zip(getattr(corpus, layout)(arg),
                        getattr(jc, layout)(arg)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the left-to-right estimator
# ---------------------------------------------------------------------------
def _jax_gumbel(key, length, shape):
    """The JAX estimator's own per-position noise: split(key, L), one
    gumbel draw of [R, D, K] per position."""
    keys = jax.random.split(key, length)

    def noise(t):
        return torch.as_tensor(np.array(jax.random.gumbel(
            keys[t], shape, jnp.float32)))
    return noise


@pytest.mark.parametrize("form", ["counts", "word_prob"])
def test_estimator_equals_jax_given_its_gumbel_draws(corpus, form):
    test = corpus.subset(np.arange(0, 60, 4))
    w_pad, mask_pad = test.to_padded()
    r, k = 16, 3
    rng = np.random.default_rng(3)
    nkw = rng.integers(0, 40, (k, 30)).astype(np.int32)
    nk = nkw.sum(1).astype(np.int32)
    alpha = np.array([0.3, 0.5, 0.9], np.float32)
    key = jax.random.key(11)
    noise = _jax_gumbel(key, w_pad.shape[1], (r, test.num_docs, k))
    if form == "counts":
        ref = float(jax_marginal.left_to_right_from_counts(
            key, jnp.asarray(w_pad), jnp.asarray(mask_pad),
            jnp.asarray(nkw), jnp.asarray(nk), jnp.asarray(alpha), 0.01, r))
        got = float(marginal.left_to_right_from_counts(
            w_pad, mask_pad, torch.as_tensor(nkw), torch.as_tensor(nk),
            alpha, 0.01, r, gumbel=noise))
    else:
        phi = _true_phi().astype(np.float32)
        ref = float(jax_marginal.left_to_right_from_word_prob(
            key, jnp.asarray(w_pad), jnp.asarray(mask_pad), jnp.asarray(phi),
            jnp.asarray(alpha), r))
        got = float(marginal.left_to_right_from_word_prob(
            w_pad, mask_pad, torch.as_tensor(phi), alpha, r, gumbel=noise))
    assert got == pytest.approx(ref, rel=1e-5)


def test_estimator_on_length_one_documents_is_the_closed_form():
    """With one token a document the estimate is exact:
    log sum_k (alpha_k / sum alpha) p(w|k), whatever the noise."""
    vocab = [f"w{i}" for i in range(6)]
    test = Corpus.from_token_lists([[0], [3], [5], [2]], vocab)
    phi = np.random.default_rng(0).dirichlet(np.ones(6), 4)
    alpha = np.array([0.1, 0.4, 1.0, 2.5])
    gen = torch.Generator().manual_seed(0)
    got = marginal.left_to_right_log_likelihood(test, phi, alpha,
                                                num_particles=8,
                                                generator=gen)
    want = sum(np.log((alpha / alpha.sum()) @ phi[:, w])
               for w in (0, 3, 5, 2))
    assert got == pytest.approx(want, rel=1e-5)


def test_true_phi_beats_uniform_phi(corpus):
    """As tests/test_likelihood.py::test_left_to_right_sane."""
    gen = torch.Generator().manual_seed(0)
    alpha = np.full(3, 0.5)
    ll_true = marginal.left_to_right_log_likelihood(
        corpus, _true_phi(), alpha, num_particles=16, generator=gen)
    ll_unif = marginal.left_to_right_log_likelihood(
        corpus, np.full((3, 30), 1.0 / 30), alpha, num_particles=16,
        generator=gen)
    assert ll_true > ll_unif + 100, (ll_true, ll_unif)


def test_held_out_ll_of_a_jax_state_equals_jax(corpus, tmp_path):
    """A JAX ggs chain's checkpoint loaded into the port gives the JAX
    sampler's own held-out LL (100 particles) given the JAX noise."""
    train, _est, evl = perplexity.build_perplexity_split(corpus, 0.2, seed=2)
    jm = jax_create_model(JaxConfig(scheme="ggs", seed=5, **CFG))
    jm.add_instances(_jax_corpus(train))
    jm.sample(8)
    jm.add_test_instances(_jax_corpus(evl))
    ref = jm._held_out_log_likelihood()
    path = str(tmp_path / "jax_state.npz")
    jm.save_checkpoint(path)
    key = jax.random.fold_in(jm.state.key, 7919)
    pm = create_model(LDAConfig(scheme="ggs", seed=5, device="cpu", **CFG))
    pm.add_instances(train).load_checkpoint(path)
    pm.add_test_instances(evl)
    noise = _jax_gumbel(key, evl.to_padded()[0].shape[1],
                        (100, evl.num_docs, 3))
    assert pm._held_out_log_likelihood(gumbel=noise) == pytest.approx(
        ref, rel=1e-5)


# ---------------------------------------------------------------------------
# fold-in on the z-draw and count kernels (their plain versions here)
# ---------------------------------------------------------------------------
def test_fold_in_recovers_planted_topics_as_jax(corpus):
    phi = _true_phi()
    gen = torch.Generator().manual_seed(0)
    res = fold_in(torch.as_tensor(phi, dtype=torch.float32), corpus, 0.5,
                  gen, iterations=100, token_block=512)
    _ndk, theta_ref = jax_foldin.fold_in(jax.random.key(0), phi,
                                         _jax_corpus(corpus), 0.5,
                                         iterations=100)
    theta = res.theta_mean.numpy()
    np.testing.assert_allclose(theta.sum(1), 1.0, atol=1e-5)
    planted = np.arange(corpus.num_docs) % 3
    assert np.array_equal(theta.argmax(1), planted)
    assert np.array_equal(theta_ref.argmax(1), planted)
    assert np.abs(theta - theta_ref).mean() < 0.05
    # the counts are those of the returned z
    z = res.flat_z()
    ndk = np.zeros((corpus.num_docs, 3), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    nkw = np.zeros((30, 3), np.int64)
    np.add.at(nkw, (corpus.tokens, z), 1)
    assert np.array_equal(res.ndk.numpy(), ndk)
    assert np.array_equal(res.nkw_vk.numpy(), nkw)


def test_fold_in_draws_tokens_whose_phi_column_is_zero(corpus):
    """phi is floored at 1e-30 as the JAX log(max(phi, 1e-30)) is: a type
    with phi 0 in every topic still gets its tokens drawn, never left at
    their initial z."""
    phi = _true_phi()
    phi[:, 0] = 0.0
    gen = torch.Generator().manual_seed(1)
    res = fold_in(torch.as_tensor(phi, dtype=torch.float32), corpus, 0.5,
                  gen, iterations=4, token_block=512)
    z = res.flat_z()[corpus.tokens == 0]
    docs = corpus.token_doc_ids()[corpus.tokens == 0]
    # the floor leaves theta to decide: the document's planted topic
    assert (z == docs % 3).mean() > 0.8


@pytest.mark.parametrize("scheme", ["ggs", "pcgs", "ggs_aliasmh",
                                    "polyaurn"])
def test_sample_z_given_phi_counts_equal_a_recount(corpus, scheme):
    m = create_model(LDAConfig(scheme=scheme, seed=4, device="cpu", **CFG))
    m.add_instances(corpus)
    m.sample(3)
    phi = m.get_phi().copy()
    m.sample_z_given_phi(10)
    z = m.get_z_indicators()
    nkw = np.zeros((30, 3), np.int64)
    np.add.at(nkw, (corpus.tokens, z), 1)
    ndk = np.zeros((corpus.num_docs, 3), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    assert np.array_equal(m.get_topic_type_counts().T, nkw)
    assert np.array_equal(m.get_document_topic_matrix(), ndk)
    assert np.array_equal(m.get_tokens_per_topic(), nkw.sum(0))
    assert np.array_equal(m.get_phi(), phi)           # phi held fixed
    theta = m.get_fold_in_theta()
    assert theta.shape == (corpus.num_docs, 3)
    np.testing.assert_allclose(theta.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("scheme", ["ggs", "pcgs"])
def test_held_out_evaluation_leaves_the_chain_untouched(corpus, scheme):
    train, _est, evl = perplexity.build_perplexity_split(corpus, 0.2, seed=3)
    series = []
    for with_test in (False, True):
        m = create_model(LDAConfig(scheme=scheme, seed=9, device="cpu",
                                   topic_interval=2, **CFG))
        m.add_instances(train)
        if with_test:
            m.add_test_instances(evl)
        m.sample(8)
        series.append(m.get_log_likelihoods())
        held = m.get_held_out_log_likelihoods()
    assert series[0] == series[1]
    assert [it for it, _ in held] == [2, 4, 6, 8]
    assert all(np.isfinite(v) and v < 0 for _, v in held)


def test_cli_with_test_dataset_writes_held_out_series(tmp_path):
    rng = np.random.default_rng(0)
    themes = [["cat", "lynx", "leopard", "tiger", "kitten", "paw"],
              ["car", "engine", "wheel", "road", "drive", "fuel"],
              ["tree", "leaf", "forest", "branch", "root", "pine"]]
    for name, n in (("docs.txt", 60), ("test.txt", 12)):
        with open(tmp_path / name, "w") as f:
            for d in range(n):
                words = [themes[d % 3][i] for i in rng.integers(0, 6, 25)]
                f.write(f"docno:{d}\tL{d % 3}\t{' '.join(words)}\n")
    cfg = tmp_path / "run.cfg"
    cfg.write_text(
        f"configs = one\nno_runs = 1\nexperiment_out_dir = {tmp_path}/runs\n"
        f"exec_time = 300\niterations = 20\ntopics = 3\nalpha = 1\n"
        f"beta = 0.01\ndataset = {tmp_path}/docs.txt\n"
        f"test_dataset = {tmp_path}/test.txt\nrare_threshold = 0\n"
        f"seed = 2019\ntopic_interval = 10\nstart_diagnostic = 1\n"
        f"stoplist =\n\n[one]\nscheme = ggs\n")
    parallel_lda.main([f"--run_cfg={cfg}", "--device=cpu"])
    run = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runone-*"))
    assert len(run) == 1
    rows = [ln.split("\t") for ln in
            open(os.path.join(run[0], "test_held_out_log_likelihood.txt"))]
    assert [int(r[0]) for r in rows] == [10, 20]
    assert all(np.isfinite(float(r[1])) for r in rows)
    assert os.path.exists(os.path.join(run[0], "topic_diagnostics.csv"))
