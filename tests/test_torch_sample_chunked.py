"""`sample_chunked` and `_multi_step_fn` of the port's GGS family on the
CPU: the chain equal to `sample()` with `scan_chunk` set to the chunk and
no logging event, the rounding up to whole chunks held to the JAX GGS,
one kept `FusedSteps` across calls, no hook or listener, the state's
fields read before every call, and the sharded GGS schemes (1-rank
meshes), whose steps are never captured. On the CPU a chunk runs its
steps one by one; `chip_smoke.py` `[4 sample_chunked]` holds the kept
CUDA graph to `sample()` on the card."""

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.fusion import FIELDS, FusedSteps
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model

# no likelihood event, so that sample() fuses every whole group
CFG = dict(topics=4, alpha=0.5, beta=0.05, seed=21, exec_time=-1,
           token_block=256, topic_interval=-1)


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


def _port(corpus, scheme="ggs", **kw):
    cfg = LDAConfig(scheme=scheme, device="cpu", **{**CFG, **kw})
    return create_model(cfg).add_instances(corpus)


def _assert_same_chain(a, b):
    assert a.state.iteration == b.state.iteration
    for f in FIELDS:
        x, y = getattr(a.state, f), getattr(b.state, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    assert np.array_equal(a.get_z_indicators(), b.get_z_indicators())


@pytest.mark.parametrize("scheme, iterations, chunk", [
    ("ggs", 10, 10), ("ggs_aliasmh", 10, 10), ("ggs", 12, 4),
    ("ggs_aliasmh", 9, 3), ("ggs_test", 6, 3)])
def test_sample_chunked_equals_sample_with_scan_chunk(corpus, scheme,
                                                      iterations, chunk):
    """sample_chunked(n, chunk) is bit-equal to sample(n) with scan_chunk
    = chunk: z, n_dk, N_kw, n_k, phi, theta and the iteration."""
    chunked = _port(corpus, scheme)
    assert chunked.sample_chunked(iterations, chunk=chunk) is chunked
    fused = _port(corpus, scheme, scan_chunk=chunk)
    fused.sample(iterations)
    assert fused.fused_steps.groups == iterations // chunk
    _assert_same_chain(chunked, fused)
    assert chunked.chunked_steps.groups == iterations // chunk


def test_sample_chunked_rounds_up_to_whole_chunks_as_jax(corpus):
    """25 iterations in chunks of 10 run 30, in the JAX GGS and the
    port."""
    jm = jax_create_model(JaxConfig(scheme="ggs", **CFG))
    jm.add_instances(JaxCorpus(tokens=corpus.tokens,
                               doc_offsets=corpus.doc_offsets,
                               vocab=corpus.vocab))
    jm.sample_chunked(25, chunk=10)
    port = _port(corpus).sample_chunked(25, chunk=10)
    assert int(jm.state.iteration) == port.state.iteration == 30
    assert port.chunked_steps.groups == 3


@pytest.mark.parametrize("iterations, chunk, expect", [
    (0, 10, 0), (1, 10, 10), (20, 10, 20), (7, 3, 9), (5, 1, 5)])
def test_sample_chunked_iteration_counts(corpus, iterations, chunk, expect):
    port = _port(corpus).sample_chunked(iterations, chunk=chunk)
    assert port.state.iteration == expect


def test_multi_step_fn_keeps_one_fused_steps(corpus):
    """Two _multi_step_fn(10) callables and a sample_chunked share one
    FusedSteps kept by the model, which captures nothing on the CPU; a
    sample() between them uses its own and leaves the kept one alone;
    release_chunked() and a new layout drop it."""
    model = _port(corpus, scan_chunk=5)
    first = model._multi_step_fn(10)
    kept = model.chunked_steps
    assert isinstance(kept, FusedSteps)
    first()
    model._multi_step_fn(10)()
    model.sample(5)
    assert model.fused_steps is not kept
    model.sample_chunked(10)
    assert model.chunked_steps is kept
    assert kept.groups == 3 and kept.captures == 0 and kept.graphs == {}
    assert model.state.iteration == 35
    model.release_chunked()
    assert model.chunked_steps is None
    model._multi_step_fn(2)
    assert model.chunked_steps is not kept
    again = model.chunked_steps
    model.add_instances(corpus)
    assert model.chunked_steps is None and again.graphs == {}


def test_multi_step_fn_needs_add_instances():
    model = create_model(LDAConfig(scheme="ggs", device="cpu", **CFG))
    with pytest.raises(RuntimeError, match="add_instances"):
        model._multi_step_fn(10)


def test_sample_chunked_runs_no_hook_or_listener(corpus):
    """No hook, no listener, no likelihood: a chunk is n bare steps."""
    calls = []
    hooks = ("pre_sample", "post_sample", "pre_iteration", "pre_z",
             "post_z", "pre_phi", "post_phi", "post_iteration")
    model = _port(corpus, topic_interval=1)
    model.__class__ = type("Hooked", (type(model),), {
        h: (lambda name: lambda self: calls.append(name))(h) for h in hooks})
    model.add_iteration_listener(lambda m, it: calls.append(("l", it)))
    model.sample_chunked(6, chunk=3)
    assert calls == [] and model.get_log_likelihoods() == []
    assert model.state.iteration == 6


def test_state_set_between_calls_is_honoured(corpus):
    """Chunks around a sample(), a set_z_indicators and a set_phi give the
    chain that single-stepping gives through the same calls."""
    rng = np.random.default_rng(8)
    z = rng.integers(0, 4, corpus.num_tokens)
    phi = rng.dirichlet(np.ones(corpus.num_types), 4)

    def run(model, chunk):
        model.sample_chunked(4, chunk=2) if chunk else model.sample(4)
        model.sample(3)
        model.set_z_indicators(z)
        model.sample_chunked(2, chunk=2) if chunk else model.sample(2)
        model.set_phi(phi, vocab=corpus.vocab)
        model.sample_chunked(4, chunk=2) if chunk else model.sample(4)
        return model
    a, b = run(_port(corpus), True), run(_port(corpus), False)
    _assert_same_chain(a, b)
    assert a.state.iteration == 13


@pytest.mark.parametrize("scheme", ["sharded_ggs", "vocab_sharded_ggs"])
def test_sharded_ggs_chunks_single_step(corpus, scheme):
    """The sharded GGS schemes (1-rank meshes here) inherit sample_chunked;
    their steps are not captured (`_capturable_step` False), so a chunk
    runs its steps one by one: the chain equals sample() with scan_chunk
    = chunk, and the getters answer for the whole model."""
    kw = dict(vocab_span=4, doc_span=16)
    a = _port(corpus, scheme, **kw).sample_chunked(6, chunk=3)
    b = _port(corpus, scheme, scan_chunk=3, **kw)
    b.sample(6)
    assert not a._capturable_step
    assert a.chunked_steps.captures == 0
    _assert_same_chain(a, b)
    ttm = a.get_type_topic_matrix()
    assert ttm.shape == (corpus.num_types, 4)
    ref = np.zeros_like(ttm)
    np.add.at(ref, (corpus.tokens, a.get_z_indicators()), 1)
    assert np.array_equal(ttm, ref)
