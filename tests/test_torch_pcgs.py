"""The slice end to end on the CPU: the port's PCGS family (the sweep
kernel's plain version) against the JAX package's schemes on the
planted-topic corpus, checkpoints carried across, and the model wiring of
both layouts."""

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
from ldagroupedgibbssampler_tpu_torch.models import fused_sweep
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import cuda_pcgs

ITERS = 50
CFG = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1, token_block=512)
SCHEMES = ["pcgs", "uncollapsed", "efficient_uncollapsed", "spalias",
           "polyaurn"]


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


def _port(corpus, scheme="pcgs", **kw):
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


@pytest.mark.parametrize("scheme", SCHEMES)
def test_port_counts_exact_and_topics_recovered(corpus, scheme):
    model = _port(corpus, scheme, topic_interval=10)
    model.sample(ITERS)
    assert model.state.iteration == ITERS
    _assert_counts_exact(model, corpus)
    phi = model.get_phi()
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, atol=1e-5)
    blocks = model.get_topic_type_counts().reshape(3, 3, 10).sum(axis=2)
    purity = blocks.max(axis=1) / blocks.sum(axis=1)
    assert purity.min() > 0.9, purity
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert len(lls) == ITERS // 10 and lls[-1] > lls[0]
    if scheme == "polyaurn":
        # exact zeros in phi, and no token drawn onto a (k, w) whose phi
        # was 0 in the sweep that drew it (phi is redrawn after the sweep)
        assert (phi == 0).any()
        model.sample(1)
        z = model.get_z_indicators()
        assert (phi[z, corpus.tokens] > 0).all()
        assert 0.0 < model.get_phi_density() < 1.0


@pytest.mark.parametrize("scheme", ["pcgs", "uncollapsed", "polyaurn"])
def test_port_ll_within_jax_seed_spread(corpus, scheme):
    """The port's model LL at iteration 50 (the median of 5 port chains:
    this small corpus has a few local modes, a few nats apart) lies within
    the range of 5 JAX chains of the same scheme, widened by 3 standard
    deviations."""
    jm = jax_create_model(JaxConfig(scheme=scheme, seed=7,
                                    topic_interval=ITERS, **CFG))
    jc = _jax_corpus(corpus)
    finals = []
    for seed in range(5):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        jm.sample(ITERS)
        finals.append(jm.get_log_likelihoods()[-1][1])
    lls = []
    for seed in range(5):
        port = _port(corpus, scheme, seed=seed)
        port.sample(ITERS)
        lls.append(port.model_log_likelihood())
    ll = float(np.median(lls))
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, finals)


def test_checkpoint_carried_across_from_jax(corpus, tmp_path):
    """A JAX `pcgs` checkpoint (z in corpus order, nkw and phi [K, V])
    loads into the port with equal counts, phi and z, and runs on."""
    jm = jax_create_model(JaxConfig(scheme="pcgs", seed=7, **CFG))
    jm.add_instances(_jax_corpus(corpus), key=jax.random.key(3, impl="rbg"))
    jm.sample(3)
    path = str(tmp_path / "jax_pcgs.npz")
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


def test_checkpoint_round_trip_and_bad_counts_raise(corpus, tmp_path):
    port = _port(corpus, "polyaurn")
    port.sample(4)
    path = str(tmp_path / "port_pcgs.npz")
    port.save_checkpoint(path)
    other = _port(corpus, "polyaurn")
    other.load_checkpoint(path)
    for get in ("get_topic_type_counts", "get_document_topic_matrix",
                "get_z_indicators", "get_phi"):
        assert np.array_equal(getattr(other, get)(), getattr(port, get)())
    with np.load(path) as d:
        arrays = dict(d)
    arrays["nkw"] = arrays["nkw"].copy()
    arrays["nkw"][0, 0] += 1
    with pytest.raises(ValueError, match="nkw"):
        other.state_from_numpy(arrays)


@pytest.fixture(params=["resident", "streamed"])
def layout(request, monkeypatch):
    if request.param == "streamed":
        monkeypatch.setattr(fused_sweep, "_FUSED_PCGS_VMEM_BUDGET", 1)
    return request.param


def test_layout_wiring_set_get_z(corpus, layout):
    model = _port(corpus)
    assert model._mode == layout
    z = np.random.default_rng(9).integers(0, 3, corpus.num_tokens)
    model.set_z_indicators(z)
    assert np.array_equal(model.get_z_indicators(), z)
    _assert_counts_exact(model, corpus)
    np.testing.assert_allclose(model.get_phi().sum(axis=1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="one topic per token"):
        model.set_z_indicators(z[:-1])
    model.sample(3)
    _assert_counts_exact(model, corpus)


def test_layout_wiring_random_scan_keeps_unselected(corpus, layout):
    model = _port(corpus)
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
    before = (cuda_pcgs.fused_pcgs_sweep.launches,
              cuda_pcgs.fused_pcgs_sweep_streamed.launches)
    model = _port(corpus, "uncollapsed")
    model.sample(2)
    assert model.state.z.device.type == "cpu"
    assert (cuda_pcgs.fused_pcgs_sweep.launches,
            cuda_pcgs.fused_pcgs_sweep_streamed.launches) == before == (0, 0)


def test_layout_choice_follows_jax_rule():
    """The JAX package's layout rule, kept for the visit order: resident
    for 20NG at K=100, streamed at K=200 (the table is over 10 MiB),
    streamed at vspan 128 where the JAX package has no fused sweep."""
    docs = 11269
    assert fused_sweep.fused_pcgs_vmem_bytes(docs, 100, 128) \
        <= fused_sweep._FUSED_PCGS_VMEM_BUDGET
    assert fused_sweep.fused_pcgs_vmem_bytes(docs, 200, 128) \
        > fused_sweep._FUSED_PCGS_VMEM_BUDGET
    assert fused_sweep.fused_pcgs_streamed_vmem_bytes(200, 128, 128, 4096) \
        <= fused_sweep._STREAMED_VMEM_BUDGET

    class Probe(fused_sweep.FusedPCGSSweepMixin):
        def __init__(self, topics, num_docs):
            self.config = LDAConfig(topics=topics, device="cpu")
            self.corpus = Corpus.from_token_lists([[0]] * num_docs, ["w"])
    assert Probe(100, docs)._fused_mode() == "resident"
    assert Probe(200, docs)._fused_mode() == "streamed"
    wide = Probe(9000, docs)
    assert wide._fused_mode() == "streamed"
    assert wide._streamed_vspan() == 0          # no JAX fused sweep here
    assert wide._streamed_block() == 1024
