"""The sampler's public interface on the CPU against the JAX package: the
lifecycle hooks and iteration listeners (the call sequence of a run, and
the fusion gates they set), the getters on a state carried across from a
JAX chain, and the small host functions (`tokenize_docs`,
`predicate_filter`, `Corpus.document_frequencies`,
`padded_doc_topic_counts`, `log_dirichlet`), each on the same seeded
inputs through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.corpus import tokenizer as jax_tokenizer
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.models.ggs import (
    LDAGroupedGibbsSampler as JaxGGS)
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu.ops import counts as jax_counts
from ldagroupedgibbssampler_tpu.ops import random as jax_random
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus import tokenizer
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.base import TorchLDASampler
from ldagroupedgibbssampler_tpu_torch.models.ggs import (
    LDAGroupedGibbsSampler)
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.counts import (
    padded_doc_topic_counts)

CFG = dict(topics=3, alpha=0.5, beta=0.05, seed=13, exec_time=-1,
           token_block=256)
HOOKS = ("pre_sample", "post_sample", "pre_iteration", "pre_z", "post_z",
         "pre_phi", "post_phi", "post_iteration")


@pytest.fixture(scope="module")
def corpus():
    """tests/conftest.py's synthetic_corpus, as a port Corpus."""
    rng = np.random.default_rng(42)
    vocab = [f"w{k}_{i}" for k in range(3) for i in range(10)]
    docs = []
    for d in range(60):
        main = rng.integers(0, 10, 36) + (d % 3) * 10
        noise = rng.integers(0, len(vocab), 4)
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(docs, vocab)


def _jax_corpus(corpus):
    return JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                     vocab=corpus.vocab)


def _recording(cls):
    """A subclass of `cls` whose every hook appends its name to
    `self.calls`."""
    def hook(name):
        def fn(self):
            self.calls.append(name)
        return fn
    return type(f"Recording{cls.__name__}", (cls,),
                {h: hook(h) for h in HOOKS})


# ---------------------------------------------------------------------
# hooks and listeners
# ---------------------------------------------------------------------
@pytest.mark.parametrize("scan_chunk", [1, 4])
def test_hook_and_listener_sequence_equals_jax(corpus, scan_chunk):
    """4 iterations with the likelihood every 2: the port calls its hooks
    and a listener in the JAX run's order (pre_phi never), and the
    overridden hooks keep scan_chunk 4 from fusing in both."""
    kw = dict(CFG, topic_interval=2, scan_chunk=scan_chunk)
    port = _recording(LDAGroupedGibbsSampler)(
        LDAConfig(scheme="ggs", device="cpu", **kw))
    jm = _recording(JaxGGS)(JaxConfig(scheme="ggs", **kw))
    for m in (port, jm):
        m.calls = []
        m.add_iteration_listener(
            lambda model, it: model.calls.append(("listener", it)))
    port.add_instances(corpus)
    jm.add_instances(_jax_corpus(corpus))
    port.sample(4)
    jm.sample(4)
    per_iteration = ["pre_iteration", "pre_z", "post_z", "post_phi",
                     "post_iteration"]
    expected = (["pre_sample"]
                + [c for it in range(1, 5)
                   for c in per_iteration + [("listener", it)]]
                + ["post_sample"])
    assert jm.calls == expected
    assert port.calls == jm.calls
    assert port.fused_steps is None
    assert port.state.iteration == int(jm.state.iteration) == 4


def test_listener_sees_the_model_after_each_iteration(corpus):
    """A listener gets the model itself, its state at the iteration it is
    told, and may stop the run by abort()."""
    model = create_model(LDAConfig(scheme="ggs", device="cpu",
                                   topic_interval=-1, **CFG))
    model.add_instances(corpus)
    seen = []

    def listener(m, it):
        seen.append((m is model, it, m.state.iteration))
        if it == 3:
            m.abort()
    model.add_iteration_listener(listener)
    model.sample(6)
    assert seen == [(True, it, it) for it in (1, 2, 3)]
    assert model.get_abort()


# each case of the fusion gate: a hook overridden alone, a listener, the
# HDP family's own post_iteration, and none of them
GATES = [*HOOKS, "listener", "ppu_hdplda", "none"]


def _gated(make, scheme, case):
    model = make(scheme)
    if case in HOOKS:
        model.__class__ = type("Hooked", (type(model),),
                               {case: lambda self: None})
    elif case == "listener":
        model.add_iteration_listener(lambda m, it: None)
    return model


@pytest.mark.parametrize("case", GATES)
def test_fusable_chunk_gates_equal_jax(case):
    """`_fusable_chunk()` is 1 in both packages for each per-iteration hook
    overridden alone, a listener and ppu_hdplda, and scan_chunk with none
    of these; overriding pre_sample or post_sample leaves fusion on, as in
    JAX."""
    fused = case in ("none", "pre_sample", "post_sample")
    scheme = "ppu_hdplda" if case == "ppu_hdplda" else "ggs"
    kw = dict(CFG, scan_chunk=5)
    port = _gated(lambda s: create_model(
        LDAConfig(scheme=s, device="cpu", **kw)), scheme, case)
    jm = _gated(lambda s: jax_create_model(JaxConfig(scheme=s, **kw)),
                scheme, case)
    assert port._fusable_chunk() == jm._fusable_chunk()
    assert port._fusable_chunk() == (5 if fused else 1)
    if case in HOOKS:
        assert getattr(type(port), case) is not getattr(TorchLDASampler,
                                                        case)


def test_hooks_run_in_unfused_iterations_only(corpus):
    """pre_sample and post_sample overridden alone leave fusion on: scan
    chunk 3 over 7 iterations with the likelihood every 7 runs two fused
    groups (1-3, 4-6) and iteration 7 between one call of each."""
    cls = type("RunHooks", (LDAGroupedGibbsSampler,), {
        "pre_sample": lambda self: self.calls.append("pre_sample"),
        "post_sample": lambda self: self.calls.append("post_sample")})
    model = cls(LDAConfig(scheme="ggs", device="cpu", topic_interval=7,
                          scan_chunk=3, **CFG))
    model.calls = []
    model.add_instances(corpus)
    model.sample(7)
    assert model.fused_steps.groups == 2
    assert model.calls == ["pre_sample", "post_sample"]


# ---------------------------------------------------------------------
# getters on a state carried across from the JAX chain
# ---------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["ggs", "pcgs"])
def test_getters_equal_jax_on_a_carried_state(corpus, scheme, tmp_path):
    """get_beta, get_type_topic_matrix and get_abort of the port equal the
    JAX model's on the JAX chain's state after 3 iterations, carried into
    the port by `state_from_numpy` (nkw in each scheme's orientation: [V,
    K] for ggs, [K, V] for pcgs)."""
    kw = dict(CFG, topic_interval=-1, beta=0.03)
    jm = jax_create_model(JaxConfig(scheme=scheme, **kw))
    jm.add_instances(_jax_corpus(corpus))
    jm.sample(3)
    path = str(tmp_path / "jax.npz")
    jm.save_checkpoint(path)
    port = create_model(LDAConfig(scheme=scheme, device="cpu", **kw))
    port.add_instances(corpus)
    with np.load(path) as d:
        port.state = port.state_from_numpy(dict(d))
    assert isinstance(port.get_beta(), float)
    assert port.get_beta() == jm.get_beta()
    ttm = port.get_type_topic_matrix()
    assert ttm.shape == (corpus.num_types, 3)
    assert np.array_equal(ttm, jm.get_type_topic_matrix())
    assert np.array_equal(ttm, port.get_topic_type_counts().T)
    assert port.get_abort() is jm.get_abort() is False
    port.abort()
    jm.abort()
    assert port.get_abort() is jm.get_abort() is True


# ---------------------------------------------------------------------
# the small host functions, bit-equal to JAX on seeded inputs
# ---------------------------------------------------------------------
def _seeded_texts(seed=5, docs=40):
    """Texts of words, numbers, underscores, dashes and punctuation."""
    rng = np.random.default_rng(seed)
    pieces = ["cat", "Lynx", "x86_64", "3rd", "a", "re-use", "naïve",
              "ip.addr", "__init__", "2019", "café", "ok!", "b", "tiger's"]
    return [" ".join(rng.choice(pieces, rng.integers(0, 30)))
            for _ in range(docs)]


@pytest.mark.parametrize("mode", ["simple", "numeric", "connector",
                                  "connector_numeric"])
def test_tokenize_docs_equals_jax(mode):
    texts = _seeded_texts()
    stop = frozenset({"cat"})
    for kw in (dict(mode=mode), dict(mode=mode, stoplist=stop, min_len=3,
                                     max_tokens=7)):
        got = tokenizer.tokenize_docs(texts, **kw)
        assert got == jax_tokenizer.tokenize_docs(texts, **kw)
        assert got == [tokenizer.tokenize(t, **kw) for t in texts]


def test_predicate_filter_equals_jax():
    """The JAX test's case (tests/test_corpus_config.py), then seeded
    documents under a seeded predicate."""
    docs = [["alpha", "beta", "gamma"], ["beta", "delta"]]
    pred = lambda t: t.startswith("b") or t == "delta"  # noqa: E731
    assert tokenizer.predicate_filter(docs, pred) == [["beta"],
                                                      ["beta", "delta"]]
    docs = tokenizer.tokenize_docs(_seeded_texts(seed=9), mode="numeric")
    keep = set(np.random.default_rng(2).choice(
        sorted({t for d in docs for t in d}), 5, replace=False))
    got = tokenizer.predicate_filter(docs, keep.__contains__)
    assert got == jax_tokenizer.predicate_filter(docs, keep.__contains__)
    assert sum(map(len, got)) > 0


def test_document_frequencies_equal_jax():
    """A seeded corpus with empty documents, repeated types and types that
    occur nowhere: every count and the dtype bit-equal."""
    rng = np.random.default_rng(11)
    lengths = rng.integers(0, 30, 200)
    lengths[::17] = 0
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    tokens = rng.zipf(1.3, offsets[-1]) % 150
    vocab = [f"t{i}" for i in range(160)]
    df = Corpus(tokens=tokens, doc_offsets=offsets,
                vocab=vocab).document_frequencies()
    ref = JaxCorpus(tokens=tokens, doc_offsets=offsets,
                    vocab=vocab).document_frequencies()
    assert df.dtype == ref.dtype == np.int64
    assert np.array_equal(df, ref)
    assert df[150:].sum() == 0 and df.max() <= 200 - (lengths == 0).sum()


def test_padded_doc_topic_counts_equal_jax():
    rng = np.random.default_rng(4)
    d, length, k = 37, 23, 11
    z = rng.integers(0, k, (d, length)).astype(np.int32)
    mask = rng.random((d, length)) < 0.7
    mask[3] = False
    got = padded_doc_topic_counts(torch.as_tensor(z), torch.as_tensor(mask),
                                  k)
    ref = np.asarray(jax_counts.padded_doc_topic_counts(
        jnp.asarray(z), jnp.asarray(mask), k))
    assert got.dtype == torch.int32 and got.shape == (d, k)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy().sum(axis=1), mask.sum(axis=1))


CONC = np.array([0.01, 0.5, 1.0, 3.0, 10.0], np.float32)
DRAWS = 20_000


def test_log_dirichlet_normalised_and_mean_matches_jax():
    """20,000 draws of Dir(0.01, 0.5, 1, 3, 10): every row's logsumexp
    within 1e-6 of 0 (float64 logs rounded once to float32), and the mean
    of exp within 4 standard errors of conc / conc.sum() and of the JAX
    log_dirichlet's mean over as many draws."""
    gen = torch.Generator()
    gen.manual_seed(17)
    conc = torch.as_tensor(CONC).expand(DRAWS, -1)
    x = rnd.log_dirichlet(conc, gen)
    assert x.dtype == torch.float32 and x.shape == (DRAWS, 5)
    lse = torch.logsumexp(x.double(), dim=-1)
    assert float(lse.abs().max()) <= 1e-6
    p = x.double().exp().numpy()
    jx = np.asarray(jax_random.log_dirichlet(
        jax.random.key(17), jnp.broadcast_to(jnp.asarray(CONC), (DRAWS, 5))),
        np.float64)
    assert np.abs(np.log(np.exp(jx).sum(axis=1))).max() <= 1e-5
    q = np.exp(jx)
    se_p = p.std(axis=0) / np.sqrt(DRAWS)
    se_q = q.std(axis=0) / np.sqrt(DRAWS)
    assert (np.abs(p.mean(axis=0) - CONC / CONC.sum()) <= 4 * se_p).all()
    assert (np.abs(p.mean(axis=0) - q.mean(axis=0))
            <= 4 * np.sqrt(se_p ** 2 + se_q ** 2)).all()


def test_log_dirichlet_is_the_log_of_dirichlet():
    """From one generator state, exp(log_dirichlet) is `dirichlet`'s draw
    within 1e-5 relative: both take the same Gamma draws (on the card the
    Gamma and Dirichlet kernels share their Philox words)."""
    conc = torch.as_tensor(np.random.default_rng(3).random((64, 40))
                           * 2 + 0.01, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(5)
    state = gen.get_state()
    x = rnd.log_dirichlet(conc, gen)
    gen.set_state(state)
    want = rnd.dirichlet(conc, gen).double()
    rel = ((x.double().exp() - want).abs() / want).max()
    assert float(rel) <= 1e-5
