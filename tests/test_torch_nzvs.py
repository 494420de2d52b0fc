"""Scheme `nzvsspalias` on the port: the variable-selection phi draw gets
the phi its sweep used, the chain keeps exact zeros out of the draws, and
its likelihood lies within the JAX scheme's seed spread."""

import jax
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

ITERS = 50
CFG = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1, token_block=512)



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: several test workers
    share the host's cores, and torch's default of one thread a core then
    slows every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

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


def _port(corpus, **kw):
    cfg = LDAConfig(scheme="nzvsspalias", device="cpu",
                    **{"seed": 7, **CFG, **kw})
    return create_model(cfg).add_instances(corpus)


def _assert_counts_exact(model, corpus):
    z = model.get_z_indicators()
    nkw = np.zeros((3, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    ndk = np.zeros((corpus.num_docs, 3), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    assert np.array_equal(model.get_topic_type_counts(), nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=1))


@pytest.mark.parametrize("sequential", [False, True])
def test_chain_draws_only_on_the_support(corpus, sequential):
    """Counts exact, exact zeros in phi, no token drawn onto a (k, w)
    whose phi was 0 in the sweep that drew it, planted topics recovered,
    a rising likelihood; the same with the reference's sequential zeroPhi
    chain."""
    model = _port(corpus, topic_interval=10)
    model.vs_sequential = sequential
    model.sample(ITERS - 1)
    phi = model.get_phi()
    assert (phi == 0).any()
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, atol=1e-5)
    model.sample(1)
    z = model.get_z_indicators()
    live = phi.sum(axis=0)[corpus.tokens] > 0
    assert (phi[z, corpus.tokens][live] > 0).all()
    _assert_counts_exact(model, corpus)
    blocks = model.get_topic_type_counts().reshape(3, 3, 10).sum(axis=2)
    purity = blocks.max(axis=1) / blocks.sum(axis=1)
    assert purity.min() > 0.9, purity
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert len(lls) == ITERS // 10 and lls[-1] > lls[0]
    assert 0.0 < model.get_phi_density() < 1.0


def test_phi_draw_is_given_the_phi_of_its_sweep(corpus, monkeypatch):
    """Each iteration's VS draw gets the phi the sweep just used (its
    zeros drive the inclusion probability); the initial draw and
    set_z_indicators' redraw get None (a dense previous draw)."""
    seen = []
    real = rnd.vs_dirichlet

    def spy(counts, beta, vs_prior, generator, previous_phi=None,
            sequential=False):
        seen.append(None if previous_phi is None else previous_phi.clone())
        return real(counts, beta, vs_prior, generator,
                    previous_phi=previous_phi, sequential=sequential)

    monkeypatch.setattr(rnd, "vs_dirichlet", spy)
    model = _port(corpus)
    assert seen == [None]
    for _ in range(3):
        before = model.state.phi.clone()
        model.sample(1)
        assert torch.equal(seen[-1], before)
        assert not torch.equal(model.state.phi, before)
    model.set_z_indicators(model.get_z_indicators())
    assert seen[-1] is None and len(seen) == 5


def test_ll_within_jax_seed_spread(corpus):
    """The port's model LL at iteration 50 (the median of 10 port chains)
    lies within the range of 10 JAX chains of the scheme, widened by 3
    standard deviations. Ten, not five: the chains end in a few modes
    some nats apart, five JAX seeds can all find the same one (a band of
    width 0), and the port's chains change with the float reductions'
    thread count."""
    jm = jax_create_model(JaxConfig(scheme="nzvsspalias", seed=7,
                                    topic_interval=ITERS, **CFG))
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
    jc = JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                   vocab=corpus.vocab)
    finals = []
    for seed in range(10):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        jm.sample(ITERS)
        finals.append(jm.get_log_likelihoods()[-1][1])
    lls = []
    for seed in range(10):
        port = _port(corpus, seed=seed)
        port.sample(ITERS)
        lls.append(port.model_log_likelihood())
    ll = float(np.median(lls))
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, finals)
