"""Scheme `spalias_priors` on the port: the prior-spec parser and the
[K, V] prior mask exactly against the JAX functions, the inconsistent-spec
errors, and the chain on the planted-topic corpus (the sweep kernel's
plain version) against the JAX scheme."""

import jax
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.models import priors as jax_priors
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models import priors
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model

ITERS = 50
CFG = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1, token_block=512)
SPEC = ["# anchors of the planted topics\n",
        "0, w0_0, w0_1, w0_2\n",
        "1, w1_0, w1_1\n",
        "\n",
        "2, w2_0, w2_1, , w2_2\n",
        "1, w0_2\n"]          # w0_2 kept by topics 0 and 1



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


@pytest.fixture(scope="module")
def spec_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("priors") / "priors.txt"
    path.write_text("".join(SPEC))
    return str(path)


def _jax_corpus(corpus):
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
    return JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                     vocab=corpus.vocab)


def _port(corpus, spec_file, **kw):
    cfg = LDAConfig(scheme="spalias_priors", device="cpu",
                    topic_prior_filename=spec_file,
                    **{"seed": 7, **CFG, **kw})
    return create_model(cfg).add_instances(corpus)


@pytest.mark.parametrize("num_topics", [3, 5])
def test_parse_prior_spec_matches_jax(num_topics):
    assert priors.parse_prior_spec(SPEC, num_topics) == \
        jax_priors.parse_prior_spec(SPEC, num_topics)
    keep, zero = priors.parse_prior_spec(SPEC, num_topics)
    assert keep[1] == {"w1_0", "w1_1", "w0_2"}
    assert "w0_2" not in zero[0] and "w0_2" not in zero[1]
    assert "w0_2" in zero[2]


def test_calculate_priors_matches_jax(corpus, spec_file, tmp_path, capsys):
    """The [K, V] mask, bit for bit, with an unknown word warned about and
    skipped."""
    ours = priors.calculate_priors(spec_file, 3, corpus.vocab)
    ref = jax_priors.calculate_priors(spec_file, 3, corpus.vocab)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    # each topic loses the other topics' anchors but its own: 5 words
    assert (ours.sum(axis=1) == 30 - 5).all()
    unknown = tmp_path / "unknown.txt"
    unknown.write_text("0, w0_0, nosuchword\n")
    ours = priors.calculate_priors(str(unknown), 3, corpus.vocab)
    assert "nosuchword" in capsys.readouterr().err
    assert np.array_equal(ours, jax_priors.calculate_priors(
        str(unknown), 3, corpus.vocab))


@pytest.mark.parametrize("spec,vocab,match", [
    # topic 1 loses both words of the vocabulary
    ("0, a\n0, b\n", ["a", "b"], "one topic has all Zero"),
    # `a` is anchored to a topic the model does not have: zeroed on all
    ("5, a\n", ["a", "b", "c"], r"\['a'\]' has all Zero")])
def test_inconsistent_specs_raise_as_in_jax(tmp_path, spec, vocab, match):
    """A topic whose every word is zeroed, and a word zeroed on every
    topic, raise in both packages with the same message."""
    path = tmp_path / "bad.txt"
    path.write_text(spec)
    for calc in (priors.calculate_priors, jax_priors.calculate_priors):
        with pytest.raises(ValueError, match=match):
            calc(str(path), 2, vocab)


def test_chain_keeps_masked_coordinates_empty(corpus, spec_file):
    """The port's chain: counts exact, phi exactly 0 wherever the mask is
    0 and positive elsewhere, no token on a masked (topic, word) pair,
    the anchors' topics recovered, and a rising likelihood."""
    model = _port(corpus, spec_file, topic_interval=10)
    mask = model.get_topic_priors()
    assert np.array_equal(mask, priors.calculate_priors(spec_file, 3,
                                                        corpus.vocab))
    model.sample(ITERS)
    z = model.get_z_indicators()
    nkw = np.zeros((3, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    assert np.array_equal(model.get_topic_type_counts(), nkw)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=1))
    phi = model.get_phi()
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, atol=1e-5)
    assert (phi[mask == 0] == 0).all() and (phi[mask > 0] > 0).all()
    assert (mask[z, corpus.tokens] > 0).all()
    # topic k holds the planted block of its anchors
    blocks = nkw.reshape(3, 3, 10).sum(axis=2)
    assert (blocks.argmax(axis=1) == np.arange(3)).all(), blocks
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert lls[-1] > lls[0]


def test_without_a_prior_file_runs_unmasked(corpus):
    cfg = LDAConfig(scheme="spalias_priors", device="cpu", seed=3, **CFG)
    model = create_model(cfg).add_instances(corpus)
    assert model.get_topic_priors() is None
    model.sample(5)
    assert (model.get_phi() > 0).all()


def test_ll_within_jax_seed_spread(corpus, spec_file):
    """The port's model LL at iteration 50 (the median of 10 port chains)
    lies within the range of 10 JAX chains of the scheme with the same
    prior file, widened by 3 standard deviations. Ten, not five: the
    chains end in a few modes some nats apart, five JAX seeds can all
    find the same one (a band of width 0), and the port's chains change
    with the float reductions' thread count."""
    jm = jax_create_model(JaxConfig(scheme="spalias_priors", seed=7,
                                    topic_interval=ITERS,
                                    topic_prior_filename=spec_file, **CFG))
    jc = _jax_corpus(corpus)
    finals = []
    for seed in range(10):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        jm.sample(ITERS)
        finals.append(jm.get_log_likelihoods()[-1][1])
    lls = []
    for seed in range(10):
        port = _port(corpus, spec_file, seed=seed)
        port.sample(ITERS)
        lls.append(port.model_log_likelihood())
    ll = float(np.median(lls))
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, finals)
