"""The ADLDA slice end to end on the CPU: the serial collapsed oracle
(`ops/kernels.py::cgs_serial_sweep`, scheme `collapsed`) against the JAX
package's with the same uniforms, schemes `adlda` and `collapsed` on the
planted-topic corpus against the JAX `collapsed` chains, the collapsed
layout rule against the JAX package's ADLDA gate, and JAX checkpoints
carried across.

On a CPU device `adlda` runs the sweep kernel's plain version, which is
the sequential collapsed chain over the layout's visit order, so it is
held to the same bars as the serial oracle."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.models.adlda import ADLDA as JaxADLDA
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu.ops.kernels import (
    cgs_serial_sweep as jax_cgs_serial_sweep)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models import fused_sweep
from ldagroupedgibbssampler_tpu_torch.models.adlda import ADLDA
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import cuda_pcgs
from ldagroupedgibbssampler_tpu_torch.ops.kernels import cgs_serial_sweep

ITERS = 30
CFG = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1, token_block=512)
SCHEMES = ["adlda", "collapsed"]
# z may differ from JAX's only where a cdf or a sum taken in another order
# crosses u (a float tie), and on the later tokens of that chain
MAX_DISAGREE = 0.001


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


def _jax_corpus(corpus):
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
    return JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                     vocab=corpus.vocab)


def _port(corpus, scheme="adlda", **kw):
    cfg = LDAConfig(scheme=scheme, device="cpu", **{"seed": 7, **CFG, **kw})
    return create_model(cfg).add_instances(corpus)


def _recounts(corpus, z, num_topics=3):
    nkw = np.zeros((num_topics, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    ndk = np.zeros((corpus.num_docs, num_topics), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    return nkw, ndk


def _assert_counts_exact(model, corpus):
    nkw, ndk = _recounts(corpus, model.get_z_indicators())
    assert np.array_equal(model.get_topic_type_counts(), nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=1))
    assert model.get_tokens_per_topic().sum() == corpus.num_tokens


@pytest.mark.parametrize("K", [3, 100])
def test_cgs_serial_sweep_matches_jax(K):
    """One serial collapsed sweep over a random corpus, every 5th document
    masked out, from a random z: the port's `cgs_serial_sweep` given the
    JAX sweep's own uniforms (jax.random.uniform of its key) draws the
    same z on at least 99.9% of tokens, with counts equal to a recount of
    its z."""
    rng = np.random.default_rng(K)
    docs = [list(rng.integers(0, 80, rng.integers(3, 40)))
            for _ in range(30)]
    c = Corpus.from_token_lists(docs, [f"w{i}" for i in range(80)])
    w, d = c.tokens.astype(np.int32), c.token_doc_ids().astype(np.int32)
    mask = (d % 5) != 0
    z = rng.integers(0, K, c.num_tokens).astype(np.int32)
    nkw, ndk = _recounts(c, z, K)
    alpha = np.full(K, 0.3, np.float32)
    beta = 0.05
    key = jax.random.key(K)
    u = np.array(jax.random.uniform(key, (c.num_tokens,), jnp.float32))
    outs_j = jax_cgs_serial_sweep(
        key, jnp.asarray(w), jnp.asarray(d), jnp.asarray(mask),
        jnp.asarray(z), jnp.asarray(ndk, jnp.int32),
        jnp.asarray(nkw, jnp.int32), jnp.asarray(nkw.sum(1), jnp.int32),
        jnp.asarray(alpha), jnp.float32(beta))
    t = torch.as_tensor
    outs_p = cgs_serial_sweep(
        t(w), t(d), t(mask), t(z), t(ndk.astype(np.int32)),
        t(nkw.astype(np.int32)), t(nkw.sum(1).astype(np.int32)), t(alpha),
        beta, u=t(u))
    zj, zp = np.asarray(outs_j[3]), outs_p[3].numpy()
    assert int((zj != zp).sum()) <= MAX_DISAGREE * c.num_tokens
    assert np.array_equal(zp[~mask], z[~mask])
    assert (zp[mask] != z[mask]).any()
    nkw_p, ndk_p = _recounts(c, zp, K)
    assert np.array_equal(outs_p[0].numpy(), ndk_p)
    assert np.array_equal(outs_p[1].numpy(), nkw_p)
    assert np.array_equal(outs_p[2].numpy(), nkw_p.sum(1))
    if np.array_equal(zj, zp):
        for a, b in zip(outs_j[:3], outs_p[:3]):
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_port_counts_exact_and_topics_recovered(corpus, scheme):
    model = _port(corpus, scheme, topic_interval=10)
    if scheme == "adlda":
        assert model._mode == "resident"
    ll0 = model.model_log_likelihood()
    model.sample(20)
    assert model.state.iteration == 20
    _assert_counts_exact(model, corpus)
    np.testing.assert_allclose(model.get_phi().sum(axis=1), 1.0, atol=1e-5)
    blocks = model.get_topic_type_counts().reshape(3, 3, 10).sum(axis=2)
    purity = blocks.max(axis=1) / blocks.sum(axis=1)
    assert purity.min() > 0.9, purity
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert len(lls) == 2 and min(lls) > ll0


@pytest.fixture(scope="module")
def jax_collapsed_finals(corpus):
    """Model LL at iteration ITERS of 5 JAX `collapsed` chains (the serial
    CGS oracle, an XLA scan) from seeds 100-104."""
    jm = jax_create_model(JaxConfig(scheme="collapsed", seed=7,
                                    topic_interval=ITERS, **CFG))
    jc = _jax_corpus(corpus)
    finals = []
    for seed in range(5):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        jm.sample(ITERS)
        finals.append(jm.get_log_likelihoods()[-1][1])
    return finals


@pytest.mark.parametrize("scheme", SCHEMES)
def test_port_ll_within_jax_collapsed_seed_spread(corpus, scheme,
                                                  jax_collapsed_finals):
    """The port's model LL at iteration 30 (the median of 3 port chains:
    the small corpus has a few local modes, a few nats apart) lies within
    the range of the 5 JAX `collapsed` chains at iteration 30, widened by
    3 standard deviations of those 5."""
    lls = []
    for seed in range(3):
        port = _port(corpus, scheme, seed=seed)
        port.sample(ITERS)
        lls.append(port.model_log_likelihood())
    ll = float(np.median(lls))
    finals = jax_collapsed_finals
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, lls, finals)


@pytest.mark.parametrize("topics,vocab_span", [(100, 128), (200, 128),
                                               (1000, 512), (4096, 128)])
def test_collapsed_layout_rule_follows_jax_adlda(topics, vocab_span):
    """The port's `adlda` layout is the JAX package's ADLDA gate, which
    counts the live-count operands (`_streamed_collapsed`), on the 20NG
    document count: resident at K=100, streamed at K=200, the same vspan
    and block at K=1000, and at K=4096 the streamed layout with its block
    capped at 1024."""
    docs = SimpleNamespace(num_docs=11269)
    jm = JaxADLDA(JaxConfig(scheme="adlda", topics=topics,
                            vocab_span=vocab_span, zdraw_kernel="interpret"))
    jm.corpus = docs
    port = ADLDA(LDAConfig(scheme="adlda", topics=topics,
                           vocab_span=vocab_span, device="cpu"))
    port.corpus = docs
    assert port._fused_mode() == jm._fused_mode()
    assert port._streamed_vspan() == jm._streamed_vspan() > 0
    assert port._streamed_block() == jm._streamed_block()
    expect = {100: "resident", 200: "streamed", 1000: "streamed",
              4096: "streamed"}[topics]
    assert port._fused_mode() == expect
    if topics == 4096:
        assert port._streamed_block() == 1024


@pytest.mark.parametrize("scheme", SCHEMES)
def test_checkpoint_carried_across_from_jax(corpus, tmp_path, scheme):
    """A JAX `adlda` or `collapsed` checkpoint (z in corpus order, nkw and
    phi [K, V]) loads into the port with equal counts, phi and z, and runs
    on with exact counts."""
    jm = jax_create_model(JaxConfig(scheme=scheme, seed=7, **CFG))
    jm.add_instances(_jax_corpus(corpus), key=jax.random.key(3, impl="rbg"))
    jm.sample(3)
    path = str(tmp_path / f"jax_{scheme}.npz")
    jm.save_checkpoint(path)
    port = _port(corpus, scheme)
    port.load_checkpoint(path)
    assert port.state.iteration == 3
    for get in ("get_topic_type_counts", "get_document_topic_matrix",
                "get_tokens_per_topic", "get_z_indicators", "get_phi"):
        assert np.array_equal(getattr(port, get)(),
                              np.asarray(getattr(jm, get)())), get
    port.sample(2)
    _assert_counts_exact(port, corpus)


@pytest.fixture(params=["resident", "streamed"])
def layout(request, monkeypatch):
    if request.param == "streamed":
        monkeypatch.setattr(fused_sweep, "_FUSED_PCGS_VMEM_BUDGET", 1)
    return request.param


def test_adlda_random_scan_and_plain_version(corpus, layout):
    """`adlda` on either layout: a random-scan step keeps the unselected
    documents' z and their counts; the sweep goes through the CPU
    wrapper's plain collapsed version, so no launch counter moves."""
    model = _port(corpus)
    assert model._mode == layout
    st = model.state
    z_before = model.get_z_indicators()
    doc_mask = torch.arange(corpus.num_docs) % 2 == 0
    model._step(st, doc_mask)
    z_after = model.get_z_indicators()
    unsel = ~doc_mask.numpy()[corpus.token_doc_ids()]
    assert np.array_equal(z_after[unsel], z_before[unsel])
    assert not np.array_equal(z_after[~unsel], z_before[~unsel])
    _assert_counts_exact(model, corpus)
    for fn in (cuda_pcgs.fused_pcgs_sweep,
               cuda_pcgs.fused_pcgs_sweep_streamed):
        assert fn.launches == fn.collapsed_launches == 0


def test_adlda_sweep_is_the_serial_chain(corpus):
    """On the CPU `_serial_sweep` (the one-warp launch on the card)
    changes nothing: the plain version is the sequential chain already."""
    chains = []
    for serial in (False, True):
        model = _port(corpus)
        model._serial_sweep = serial
        model.sample(2)
        chains.append(model.get_z_indicators())
    assert np.array_equal(*chains)


def test_collapsed_flat_layout_and_random_scan(corpus):
    """Scheme `collapsed` keeps z in canonical token order; set/get z
    round-trips, and a random-scan step moves only selected documents."""
    model = _port(corpus, "collapsed")
    assert model.state.z.shape == (corpus.num_tokens,)
    assert model.state.theta.shape == (corpus.num_docs, 3)
    z = np.random.default_rng(9).integers(0, 3, corpus.num_tokens)
    model.set_z_indicators(z)
    assert np.array_equal(model.get_z_indicators(), z)
    _assert_counts_exact(model, corpus)
    doc_mask = torch.arange(corpus.num_docs) % 3 == 0
    model._step(model.state, doc_mask)
    z_after = model.get_z_indicators()
    unsel = ~doc_mask.numpy()[corpus.token_doc_ids()]
    assert np.array_equal(z_after[unsel], z[unsel])
    assert not np.array_equal(z_after[~unsel], z[~unsel])
    _assert_counts_exact(model, corpus)
    np.testing.assert_allclose(model.state.theta.sum(dim=1).numpy(), 1.0,
                               atol=1e-5)
