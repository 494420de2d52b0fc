"""The slice end to end on the CPU: the port's GGS (plain versions of both
kernels) against the JAX package's GGS on the planted-topic corpus."""

import jax
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.evaluation.likelihood import (
    log_posterior as jax_log_posterior,
    model_log_likelihood as jax_model_log_likelihood)
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.likelihood import (
    log_posterior)
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model

ITERS = 50
CFG = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1, token_block=512)


@pytest.fixture(scope="module")
def corpus():
    """tests/conftest.py's synthetic_corpus, as a port Corpus."""
    rng = np.random.default_rng(42)
    num_topics, types_per_topic, num_docs, doc_len = 3, 10, 60, 40
    vocab = [f"w{k}_{i}" for k in range(num_topics)
             for i in range(types_per_topic)]
    docs = []
    for d in range(num_docs):
        k = d % num_topics
        main = rng.integers(0, types_per_topic, int(doc_len * 0.9)) \
            + k * types_per_topic
        noise = rng.integers(0, len(vocab), doc_len - len(main))
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(docs, vocab)


@pytest.fixture(scope="module")
def jax_model(corpus):
    """One JAX GGS instance; chains restart through add_instances(key=...),
    so its compiled step is shared by every chain of this module."""
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
    jc = JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                   vocab=corpus.vocab)
    model = jax_create_model(JaxConfig(scheme="ggs", seed=7,
                                       topic_interval=ITERS, **CFG))
    return model, jc


def _port(corpus, scheme="ggs", **kw):
    cfg = LDAConfig(scheme=scheme, seed=7, device="cpu", **{**CFG, **kw})
    return create_model(cfg).add_instances(corpus)


def _recounts(corpus, z, num_topics=3):
    nkw = np.zeros((corpus.num_types, num_topics), np.int64)
    np.add.at(nkw, (corpus.tokens, z), 1)
    ndk = np.zeros((corpus.num_docs, num_topics), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    return nkw, ndk


def test_port_ggs_counts_exact_and_topics_recovered(corpus):
    model = _port(corpus, topic_interval=10)
    model.sample(ITERS)
    assert model.state.iteration == ITERS
    nkw, ndk = _recounts(corpus, model.get_z_indicators())
    assert np.array_equal(model.get_topic_type_counts().T, nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=0))
    assert model.get_tokens_per_topic().sum() == corpus.num_tokens
    np.testing.assert_allclose(model.get_phi().sum(axis=1), 1.0, atol=1e-5)
    blocks = model.get_topic_type_counts().reshape(3, 3, 10).sum(axis=2)
    purity = blocks.max(axis=1) / blocks.sum(axis=1)
    assert purity.min() > 0.9, purity
    assert sorted(blocks.argmax(axis=1)) == [0, 1, 2]   # one topic each
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert len(lls) == ITERS // 10 and lls[-1] > lls[0]


def test_port_ll_within_jax_seed_spread(corpus, jax_model):
    model, jc = jax_model
    finals = []
    for seed in range(5):
        model._ll_history = []
        model.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        model.sample(ITERS)
        finals.append(model.get_log_likelihoods()[-1][1])
    port = _port(corpus)
    port.sample(ITERS)
    ll = port.model_log_likelihood()
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, finals)


def test_checkpoint_carried_across_from_jax(corpus, jax_model, tmp_path):
    model, jc = jax_model
    model._ll_history = []
    model.add_instances(jc, key=jax.random.key(3, impl="rbg"))
    model.sample(3)
    path = str(tmp_path / "jax_ckpt.npz")
    model.save_checkpoint(path)
    port = _port(corpus)
    port.load_checkpoint(path)
    assert port.state.iteration == 3
    assert np.array_equal(port.get_topic_type_counts(),
                          model.get_topic_type_counts())
    assert np.array_equal(port.get_document_topic_matrix(),
                          model.get_document_topic_matrix())
    assert np.array_equal(port.get_tokens_per_topic(),
                          model.get_tokens_per_topic())
    assert np.array_equal(port.get_z_indicators(), model.get_z_indicators())
    jst = model.state
    assert port.model_log_likelihood() == pytest.approx(float(
        jax_model_log_likelihood(jst.ndk, jst.nkw.T, jst.alpha,
                                 float(jst.beta))), rel=1e-5)
    st = port.state
    lp = float(log_posterior(st.ndk, st.nkw.T, st.theta, st.phi.T,
                             st.alpha, st.beta))
    lp_ref = float(jax_log_posterior(jst.ndk, jst.nkw.T, jst.theta,
                                     jst.phi.T, jst.alpha, float(jst.beta)))
    assert lp == pytest.approx(lp_ref, rel=1e-5)
    port.sample(2)                      # the loaded chain runs on
    nkw, ndk = _recounts(corpus, port.get_z_indicators())
    assert np.array_equal(port.get_topic_type_counts().T, nkw)
    assert np.array_equal(port.get_document_topic_matrix(), ndk)


def test_checkpoint_round_trip_and_bad_counts_raise(corpus, tmp_path):
    port = _port(corpus)
    port.sample(4)
    path = str(tmp_path / "port_ckpt.npz")
    port.save_checkpoint(path)
    other = _port(corpus)
    other.load_checkpoint(path)
    for get in ("get_topic_type_counts", "get_document_topic_matrix",
                "get_z_indicators", "get_phi"):
        assert np.array_equal(getattr(other, get)(), getattr(port, get)())
    with np.load(path) as d:
        arrays = dict(d)
    arrays["ndk"] = arrays["ndk"].copy()
    arrays["ndk"][0, 0] += 1
    with pytest.raises(ValueError, match="ndk"):
        other.state_from_numpy(arrays)


def test_set_z_and_phi(corpus):
    model = _port(corpus)
    z = np.random.default_rng(9).integers(0, 3, corpus.num_tokens)
    model.set_z_indicators(z)
    assert np.array_equal(model.get_z_indicators(), z)
    nkw, ndk = _recounts(corpus, z)
    assert np.array_equal(model.get_topic_type_counts().T, nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=0))
    np.testing.assert_allclose(model.get_phi().sum(axis=1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="one topic per token"):
        model.set_z_indicators(z[:-1])
    phi = np.random.default_rng(1).dirichlet(np.ones(corpus.num_types), 3)
    model.set_phi(phi, vocab=corpus.vocab)
    np.testing.assert_allclose(model.get_phi(), phi, rtol=1e-6)
    with pytest.raises(ValueError, match="vocabulary"):
        model.set_phi(phi, vocab=corpus.vocab[::-1])


def test_ggs_test_keeps_theta_ggs_redraws(corpus):
    for scheme, same in (("ggs_test", True), ("ggs", False)):
        model = _port(corpus, scheme=scheme)
        before = model.state.theta.clone()
        model.sample(1)
        assert torch.equal(model.state.theta, before) is same, scheme


def test_random_scan_unselected_docs_keep_z(corpus):
    """A document mask (random scan) keeps theta rows and z of unselected
    documents; their tokens still count."""
    model = _port(corpus)
    st = model.state
    z_before = model.get_z_indicators()
    theta_before = st.theta.clone()
    doc_mask = torch.arange(corpus.num_docs) % 2 == 0
    model._step(st, doc_mask)
    z_after = model.get_z_indicators()
    unsel = ~doc_mask.numpy()[corpus.token_doc_ids()]
    assert np.array_equal(z_after[unsel], z_before[unsel])
    assert not np.array_equal(z_after[~unsel], z_before[~unsel])
    assert torch.equal(st.theta[~doc_mask], theta_before[~doc_mask])
    nkw, ndk = _recounts(corpus, z_after)
    assert np.array_equal(model.get_topic_type_counts().T, nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)


def test_unported_options_raise(corpus):
    """Every key of the JAX single-device runner is ported now: the keys
    that raised here before are accepted, and only a builder name that
    neither package knows raises."""
    for kw in (dict(hyperparam_optim_interval=5),
               dict(topic_index_building_scheme="delta_n"),
               dict(topic_batch_building_scheme="percentage",
                    percentage_split_size_topic=0.5),
               dict(paranoid=True), dict(measure_timing=True),
               dict(save_phi_means=True),
               dict(compute_doc_topic_distances=True),
               dict(diagnostic_interval=(1, 2)),
               dict(dn_diagnostic_interval=(1, 2)),
               dict(print_ndocs_interval=(1, 2)),
               dict(print_ntopwords_interval=(1, 2))):
        _port(corpus, **kw)
    with pytest.raises(ValueError, match="topic_index_building_scheme"):
        _port(corpus, topic_index_building_scheme="bogus")
