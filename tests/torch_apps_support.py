"""Shared pieces of the port's app tests (`tests/test_torch_similarity.py`,
`test_torch_classify.py`, `test_torch_tui_drivers.py`): the planted
corpus of `tests/conftest.py::synthetic_corpus` as a port Corpus, its JAX
twin, an autouse fixture that runs each test on one torch thread, and two
test-side patches that give the JAX app and the port app
the same state:

- `carry_jax_models`: every model the JAX app trains is recorded, and the
  port app's `create_model` returns port models whose `sample()` takes the
  next recorded JAX model's state (`state_from_numpy`, the port's
  weight-carrying function) instead of running a chain;
- `patch_fold_in`: both packages' `fold_in` symbols in the given app
  modules return the same (n_dk, theta mean), drawn on the host from the
  call's index, and record the phi and seeds they were given.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models import registry as port_registry


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread, the worker's count restored after:
    the plain versions issue many small ops, which run faster on one
    thread than across a pool that the other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def planted(num_docs=60, doc_len=40, seed=42, doc_ids=False) -> Corpus:
    """tests/conftest.py's synthetic_corpus (3 planted topics with 10 types
    each, 90% on-topic words) as a port Corpus with labels."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{k}_{i}" for k in range(3) for i in range(10)]
    docs = []
    for d in range(num_docs):
        k = d % 3
        main = rng.integers(0, 10, int(doc_len * 0.9)) + k * 10
        noise = rng.integers(0, len(vocab), doc_len - len(main))
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(
        docs, vocab, labels=[str(d % 3) for d in range(num_docs)],
        doc_ids=[f"doc{d}" for d in range(num_docs)] if doc_ids else None)


def jax_corpus(c: Corpus) -> JaxCorpus:
    return JaxCorpus(tokens=c.tokens, doc_offsets=c.doc_offsets,
                     vocab=list(c.vocab), labels=list(c.labels),
                     doc_ids=list(c.doc_ids))


def doc_lists(c) -> list:
    return [list(c.tokens[c.doc_offsets[d]:c.doc_offsets[d + 1]])
            for d in range(c.num_docs)]


def jax_state_arrays(jm) -> dict:
    """A JAX model's state in the checkpoint format (what its
    `save_checkpoint` writes, without the file)."""
    st = jm.state
    return dict(z=jm.get_z_indicators(), ndk=np.array(st.ndk),
                nkw=np.array(st.nkw), nk=np.array(st.nk),
                phi=np.array(st.phi),
                theta=(np.array(st.theta) if st.theta is not None
                       else np.zeros(0)),
                alpha=np.array(st.alpha), beta=np.array(st.beta),
                iteration=np.array(st.iteration))


def carry_jax_models(monkeypatch, jax_modules=(), port_modules=()) -> list:
    """Record every model the JAX apps create (through the JAX registry or
    the given JAX modules' `create_model`), and make the given port
    modules' `create_model` return port models that take the recorded JAX
    states in order when sampled. Returns the list of JAX models not yet
    taken."""
    import ldagroupedgibbssampler_tpu.models.registry as jax_registry
    real = jax_registry.create_model
    made: list = []

    def jax_create(*args, **kwargs):
        model = real(*args, **kwargs)
        made.append(model)
        return model

    monkeypatch.setattr(jax_registry, "create_model", jax_create)
    for mod in jax_modules:
        if hasattr(mod, "create_model"):
            monkeypatch.setattr(mod, "create_model", jax_create)

    def port_create(cfg, scheme=None, **kwargs):
        model = port_registry.create_model(cfg, scheme, **kwargs)

        def sample(iterations=None):
            model.state = model.state_from_numpy(
                jax_state_arrays(made.pop(0)))
            return model
        model.sample = sample
        return model

    for mod in port_modules:
        monkeypatch.setattr(mod, "create_model", port_create)
    return made


def fake_fold(corpus, num_topics: int, call: int):
    """(n_dk int32, theta mean float32) for `corpus`: each document's
    tokens spread over the topics by a multinomial from a seeded
    Dirichlet, the same for the same call index."""
    rng = np.random.default_rng(1000 + call)
    lengths = np.diff(np.asarray(corpus.doc_offsets))
    theta = rng.dirichlet(np.full(num_topics, 0.7), len(lengths))
    ndk = np.asarray([rng.multinomial(n, p) for n, p in zip(lengths, theta)],
                     np.int32).reshape(len(lengths), num_topics)
    return ndk, theta.astype(np.float32)


def patch_fold_in(monkeypatch, jax_modules, port_modules) -> dict:
    """Patch `fold_in` in the given JAX and port app modules to return
    `fake_fold` of the call's index on each side; record what each side
    passed (phi, alpha, iterations and, for the port, the generator's
    seed and device)."""
    seen = {"jax": [], "port": []}

    def jax_fold(key, phi, corpus, alpha, iterations=100, burnin=None,
                 token_block=256):
        seen["jax"].append(dict(phi=np.asarray(phi), alpha=np.asarray(alpha),
                                iterations=iterations))
        return fake_fold(corpus, np.asarray(phi).shape[0],
                         len(seen["jax"]) - 1)

    def port_fold(phi_kv, corpus, alpha, generator, iterations=100,
                  burnin=None, **kwargs):
        seen["port"].append(dict(
            phi=phi_kv.cpu().numpy(), alpha=np.asarray(alpha),
            iterations=iterations, seed=generator.initial_seed(),
            device=str(phi_kv.device), gen_device=str(generator.device)))
        ndk, theta = fake_fold(corpus, phi_kv.shape[0],
                               len(seen["port"]) - 1)
        return types.SimpleNamespace(ndk=torch.as_tensor(ndk),
                                     theta_mean=torch.as_tensor(theta))

    for mod in jax_modules:
        monkeypatch.setattr(mod, "fold_in", jax_fold)
    for mod in port_modules:
        monkeypatch.setattr(mod, "fold_in", port_fold)
    return seen


def assert_same_fold_in_inputs(seen, seeds):
    """Both sides folded in with the same phi, alpha and iterations, and
    the port's generators were seeded as listed."""
    assert len(seen["jax"]) == len(seen["port"]) == len(seeds)
    for j, p, seed in zip(seen["jax"], seen["port"], seeds):
        np.testing.assert_array_equal(p["phi"], j["phi"])
        np.testing.assert_array_equal(p["alpha"], j["alpha"])
        assert p["iterations"] == j["iterations"]
        assert p["seed"] == seed
        assert p["device"] == p["gen_device"] == "cpu"
