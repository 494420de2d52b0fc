"""The port's likelihoods against the JAX package's (rtol 1e-5: float32
lgamma sums taken in another order)."""

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.evaluation import likelihood as jax_ll
from ldagroupedgibbssampler_tpu_torch.evaluation import likelihood as ll


def _random_counts(rng, num_docs=20, num_topics=4, num_types=50,
                   tokens=2000):
    z = rng.integers(0, num_topics, tokens)
    w = rng.integers(0, num_types, tokens)
    d = rng.integers(0, num_docs, tokens)
    ndk = np.zeros((num_docs, num_topics), np.int32)
    nkw = np.zeros((num_topics, num_types), np.int32)
    np.add.at(ndk, (d, z), 1)
    np.add.at(nkw, (z, w), 1)
    return ndk, nkw


@pytest.mark.parametrize("shape", [(20, 4, 50, 2000), (300, 30, 900, 40000)])
@pytest.mark.parametrize("symmetric", [True, False])
def test_likelihoods_match_jax(shape, symmetric):
    rng = np.random.default_rng(sum(shape) + symmetric)
    num_docs, num_topics, num_types, _ = shape
    ndk, nkw = _random_counts(rng, *shape)
    alpha = (np.float32(0.7) if symmetric else
             rng.uniform(0.05, 2.0, num_topics).astype(np.float32))
    beta = 0.05
    theta = rng.dirichlet(np.ones(num_topics), num_docs).astype(np.float32)
    phi = rng.dirichlet(np.ones(num_types), num_topics).astype(np.float32)
    ours = float(ll.model_log_likelihood(torch.as_tensor(ndk),
                                         torch.as_tensor(nkw),
                                         torch.as_tensor(alpha), beta))
    ref = float(jax_ll.model_log_likelihood(ndk, nkw, alpha, beta))
    assert ours == pytest.approx(ref, rel=1e-5)
    a_vec = np.broadcast_to(alpha, (num_topics,)).astype(np.float32)
    ours = float(ll.log_posterior(ndk, nkw, theta, phi, a_vec, beta))
    ref = float(jax_ll.log_posterior(ndk, nkw, theta, phi, a_vec, beta))
    assert ours == pytest.approx(ref, rel=1e-5)


def test_density_and_perplexity():
    m = np.array([[0, 1, 2], [0, 0, 3]])
    assert float(ll.matrix_density(torch.as_tensor(m))) == pytest.approx(
        float(jax_ll.matrix_density(m)))
    assert ll.perplexity(-1000.0, 200) == pytest.approx(
        jax_ll.perplexity(-1000.0, 200), rel=1e-6)
