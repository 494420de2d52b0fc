"""The slice end to end on the CPU: the port's LightLDA MH family (the MH
sweep kernel's plain version) against the JAX package's schemes on the
planted-topic corpus, the layout rule with two word tables, a JAX
checkpoint carried across, and the model wiring of both layouts."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.models.lightlda import (
    LightPCLDA as JaxLightPCLDA)
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu.ops import pallas_lightlda
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models import fused_sweep
from ldagroupedgibbssampler_tpu_torch.models.lightlda import LightPCLDA
from ldagroupedgibbssampler_tpu_torch.models.pcgs import (
    LDAPartiallyCollapsedGibbsSampler)
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import cuda_lightlda

ITERS = 50
CFG = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1, token_block=512)
SCHEMES = ["lightpclda", "lightpcldaw2", "lightcollapsed"]


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


def _port(corpus, scheme="lightpclda", **kw):
    cfg = LDAConfig(scheme=scheme, device="cpu", **{"seed": 7, **CFG, **kw})
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
    assert model.get_tokens_per_topic().sum() == corpus.num_tokens


@pytest.mark.parametrize("scheme", SCHEMES)
def test_port_counts_exact_and_topics_recovered(corpus, scheme):
    model = _port(corpus, scheme, topic_interval=10)
    model.sample(ITERS)
    assert model.state.iteration == ITERS
    _assert_counts_exact(model, corpus)
    np.testing.assert_allclose(model.get_phi().sum(axis=1), 1.0, atol=1e-5)
    blocks = model.get_topic_type_counts().reshape(3, 3, 10).sum(axis=2)
    purity = blocks.max(axis=1) / blocks.sum(axis=1)
    assert purity.min() > 0.9, purity
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert len(lls) == ITERS // 10 and lls[-1] > lls[0]


def _inject_uniforms(sweep):
    """The JAX MH sweep with four jax.random uniforms per slot injected
    (keyed by the sweep's seed operand). The JAX models' interpret mode
    passes none to the MH kernel, and the interpreter's in-kernel PRNG
    then gives zeros; with injected uniforms the interpreted chain runs
    the kernel's algorithm with real randomness."""
    def wrapped(w3, d3, z_old, table, tw, qw, seed, *windows, **kw):
        nb, chunks, chunk = w3.shape
        u24 = jax.random.randint(jax.random.PRNGKey(seed[0]),
                                 (nb, 4 * chunks, chunk), 0, 2 ** 24,
                                 jnp.int32)
        return sweep(w3, d3, z_old, table, tw, qw, seed, *windows, u24,
                     **kw)
    return wrapped


def test_port_ll_within_jax_seed_spread(corpus, monkeypatch):
    """The port's `lightpclda` model LL at iteration 30 (the median of 5
    port chains) lies within the range of 5 JAX chains of the same scheme
    running the interpreted Pallas MH kernel (zdraw_kernel="interpret",
    uniforms injected), widened by 3 standard deviations."""
    iters = 30
    for name in ("fused_lightlda_sweep", "fused_lightlda_sweep_streamed"):
        monkeypatch.setattr(pallas_lightlda, name, _inject_uniforms(
            getattr(pallas_lightlda, name)))
    jm = jax_create_model(JaxConfig(scheme="lightpclda", seed=7,
                                    topic_interval=iters,
                                    zdraw_kernel="interpret", **CFG))
    jc = _jax_corpus(corpus)
    finals = []
    for seed in range(5):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        assert jm._fused_mode() == "resident"
        jm.sample(iters)
        finals.append(jm.get_log_likelihoods()[-1][1])
    lls = []
    for seed in range(5):
        port = _port(corpus, seed=seed)
        port.sample(iters)
        lls.append(port.model_log_likelihood())
    ll = float(np.median(lls))
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, lls, finals)


@pytest.mark.parametrize("topics,vocab_span", [(100, 128), (200, 128),
                                               (1000, 512), (4096, 128)])
def test_layout_rule_with_two_word_tables(topics, vocab_span):
    """The port's layout for the MH family is the JAX package's gate with
    two word tables on the 20NG document count: resident at K=100,
    streamed at K=200, a narrower streamed vspan than the PCGS family's
    at K=1000 with vocab_span 512, and at K=4096, where the JAX package
    has no fused MH sweep, the streamed layout at vspan 128 with the block
    uncapped (the PCGS family caps it at 1024 there)."""
    docs = SimpleNamespace(num_docs=11269)
    jm = JaxLightPCLDA(JaxConfig(scheme="lightpclda", topics=topics,
                                 vocab_span=vocab_span,
                                 zdraw_kernel="interpret"))
    jm.corpus = docs
    port = LightPCLDA(LDAConfig(scheme="lightpclda", topics=topics,
                                vocab_span=vocab_span, device="cpu"))
    port.corpus = docs
    pcgs = LDAPartiallyCollapsedGibbsSampler(LDAConfig(
        topics=topics, vocab_span=vocab_span, device="cpu"))
    pcgs.corpus = docs
    assert port._streamed_block() == jm._streamed_block() == 4096
    assert port._streamed_vspan() == jm._streamed_vspan()
    if topics == 4096:
        assert jm._fused_mode() is None
        assert port._fused_mode() == "streamed"
        assert port._streamed_vspan() == 0      # taken as vspan 128
        assert pcgs._streamed_block() == 1024
    else:
        assert port._fused_mode() == jm._fused_mode()
    if topics == 1000:
        assert jm._fused_mode() == "streamed"
        assert port._streamed_vspan() == 256 < pcgs._streamed_vspan()


def test_layout_at_large_k_runs_streamed(corpus, monkeypatch):
    """A model whose JAX counterpart would have no fused sweep builds the
    streamed layout at vspan 128 and its sweep goes to the streamed
    wrapper."""
    monkeypatch.setattr(fused_sweep, "_FUSED_PCGS_VMEM_BUDGET", 1)
    monkeypatch.setattr(fused_sweep, "_STREAMED_VMEM_BUDGET", 1)
    calls = []
    ref = cuda_lightlda.fused_lightlda_sweep_streamed_reference

    def spy(*a, **kw):
        calls.append(kw["vspan"])
        return ref(*a, **kw)
    monkeypatch.setattr(cuda_lightlda,
                        "fused_lightlda_sweep_streamed_reference", spy)
    model = _port(corpus)
    assert model._mode == "streamed" and model._vspan == 128
    assert model._streamed_vspan() == 0
    model.sample(2)
    assert calls == [128, 128]
    _assert_counts_exact(model, corpus)


def test_checkpoint_carried_across_from_jax(corpus, tmp_path):
    """A JAX `lightpclda` checkpoint (z in corpus order, nkw and phi
    [K, V]) loads into the port with equal counts, phi and z, and runs
    on."""
    jm = jax_create_model(JaxConfig(scheme="lightpclda", seed=7, **CFG))
    jm.add_instances(_jax_corpus(corpus), key=jax.random.key(3, impl="rbg"))
    jm.sample(3)
    path = str(tmp_path / "jax_lightpclda.npz")
    jm.save_checkpoint(path)
    port = _port(corpus)
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


@pytest.mark.parametrize("scheme", SCHEMES)
def test_layout_wiring_random_scan_keeps_unselected(corpus, layout, scheme):
    model = _port(corpus, scheme)
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


def test_layout_wiring_cpu_runs_plain_version(corpus, layout):
    """On CPU tensors the wrappers take the plain version: the kernel's
    launch counters stay at zero while the chain runs."""
    model = _port(corpus, "lightcollapsed")
    model.sample(2)
    assert model.state.z.device.type == "cpu"
    assert (cuda_lightlda.fused_lightlda_sweep.launches,
            cuda_lightlda.fused_lightlda_sweep_streamed.launches) == (0, 0)


def test_word_tables_of_each_scheme(corpus):
    """The word target / proposal tables each scheme hands the sweep, from
    its sweep-entry state (models/lightlda.py of the JAX package)."""
    tables = {}
    for scheme in SCHEMES:
        model = _port(corpus, scheme)
        model.sample(2)
        st = model.state
        tw, qw = model._word_tables(st)
        assert tw.shape == qw.shape == (corpus.num_types, 3)
        assert tw.is_contiguous() and qw.is_contiguous()
        tables[scheme] = (tw, qw, st)
    tw, qw, st = tables["lightpclda"]
    assert tw is qw and torch.equal(tw, st.phi.T)
    tw, qw, st = tables["lightpcldaw2"]
    assert torch.equal(tw, st.phi.T)
    assert torch.equal(qw, st.nkw.T.to(torch.float32) + st.beta)
    tw, qw, st = tables["lightcollapsed"]
    ref = ((st.beta + st.nkw.T.to(torch.float32))
           / (st.beta * corpus.num_types + st.nk.to(torch.float32)))
    assert tw is qw and torch.equal(tw, ref)
