"""The Polya-Urn, Poisson and VS-Dirichlet kernels' plain versions on the
CPU (ops/cuda_polya_urn.py, csrc/polya_urn.cu; ops/cuda_gamma.py::
vs_dirichlet, csrc/vs_dirichlet.cu): the Poisson sampler against scipy on
both sides of its switch at 10 and at its edges, against
jax.random.poisson; the Polya-Urn and VS rows against the JAX package's
`polya_urn_dirichlet` and `vs_dirichlet` in their zero patterns and
moments, the uniform row, the HDP family's inactive rows; the words each
draw takes; ops/random.py's hand-off of tensors off the CPU to the
wrappers, which launch or raise; and the `polyaurn` and `nzvsspalias`
chains with their phi drawn by the kernels' plain versions against the
JAX chains' likelihoods.

Tolerances: masks and uniform rows exact; distributions by chi-square or
two-sample KS at p > 1e-4, frequencies and means within 5 standard
errors; rows sum to 1 within 1e-5 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu.ops import random as jax_rnd
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import (_build, cuda_gamma,
                                                  cuda_polya_urn)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(v):
    return torch.tensor([v], dtype=torch.int64)


def _z(a, b, n_a, n_b):
    """Two-sample z of the means of a and b."""
    return (a.mean() - b.mean()) / np.sqrt(a.var() / n_a + b.var() / n_b
                                           + 1e-300)


# ---------------------------------------------------------------------------
# Poisson
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.01, 0.5, 9.99, 10.0, 37.5, 5000.0])
def test_poisson_follows_scipy_by_chi_square(lam):
    """40,000 draws of Poisson(lam) against scipy.stats.poisson by
    chi-square (cells of expectation below 5 pooled; p > 1e-4), and their
    mean within 5 standard errors: inversion below 10, PTRS from 10."""
    m = 40_000
    draws = cuda_polya_urn.poisson_reference(torch.full((m,), lam),
                                             _seed(int(lam * 100) + 3))
    draws = draws.numpy()
    assert (draws == np.round(draws)).all() and draws.min() >= 0
    top = int(lam + 12 * lam ** 0.5 + 20)
    assert draws.max() < top
    pmf = stats.poisson.pmf(np.arange(top), lam)
    obs = np.bincount(draws.astype(np.int64), minlength=top)
    exp = pmf * m
    big = exp >= 5
    o = np.append(obs[big], obs[~big].sum())
    e = np.append(exp[big], exp[~big].sum())
    chi2 = float(((o - e) ** 2 / e).sum())
    assert stats.chi2.sf(chi2, o.size - 1) > 1e-4
    assert abs(draws.mean() - lam) < 5 * (lam / m) ** 0.5


def test_poisson_edges_and_its_element_alone():
    """lam = 0 gives 0 and inf gives inf exactly, NaN and a negative lam
    NaN; a draw is a function of (seed, element) alone."""
    lam = torch.tensor([0.0, float("inf"), float("nan"), -1.0, 3.0, 50.0])
    out = cuda_polya_urn.poisson_reference(lam, _seed(1)).numpy()
    assert out[0] == 0 and np.isinf(out[1]) and np.isnan(out[2:4]).all()
    gen = torch.Generator().manual_seed(4)
    lam = torch.rand(500, generator=gen) * 30
    whole = cuda_polya_urn.poisson_reference(lam, _seed(9))
    perm = torch.randperm(500, generator=gen)
    assert torch.equal(cuda_polya_urn.poisson_reference(
        lam[perm], _seed(9), element=perm), whole[perm])


def test_poisson_matches_jax_poisson_by_two_sample_ks():
    """Against jax.random.poisson itself (the package's ops/random.py::
    poisson) below and above the switch: 20,000 draws each, KS p > 1e-4."""
    for lam in (3.0, 40.0):
        ref = np.asarray(jax_rnd.poisson(jax.random.key(int(lam)),
                                         jnp.full((20_000,), lam)))
        ours = cuda_polya_urn.poisson_reference(torch.full((20_000,), lam),
                                                _seed(int(lam) + 1)).numpy()
        assert stats.ks_2samp(ours, ref).pvalue > 1e-4, lam


# ---------------------------------------------------------------------------
# Polya-Urn rows
# ---------------------------------------------------------------------------

ROW = [100, 0, 5, 0, 0, 1, 0, 0, 0, 0]


def test_polya_urn_zero_pattern_and_moments_match_jax():
    """4,000 rows of counts ROW at beta 0.01, the plain version against
    the JAX polya_urn_dirichlet: each coordinate's share of exact zeros
    and its mean within 5 standard errors of the JAX draws'; rows sum to
    1; the zero mask is exactly c == 0 (phi == 0 here)."""
    rows = 4000
    counts = np.tile(np.array(ROW, np.int32), (rows, 1))
    ref, ref_zero = jax_rnd.polya_urn_dirichlet(jax.random.key(3),
                                                jnp.asarray(counts), 0.01)
    ref, ref_zero = np.asarray(ref), np.asarray(ref_zero)
    phi, zero = cuda_polya_urn.polya_urn_reference(
        torch.as_tensor(counts), 0.01, _seed(33), zero_mask=True)
    np.testing.assert_allclose(phi.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(zero, phi == 0)
    ours, ours_zero = phi.numpy(), zero.numpy()
    for i in range(len(ROW)):
        zf = _z(ours_zero[:, i].astype(float), ref_zero[:, i].astype(float),
                rows, rows)
        zm = _z(ours[:, i], ref[:, i], rows, rows)
        assert abs(zf) < 5 and abs(zm) < 5, (i, zf, zm)


def test_polya_urn_uniform_and_inactive_rows():
    """A row whose draws are all 0 (counts 0, beta 0) is 1/L exactly, as
    in JAX; rows of inactive topics are 0 with every coordinate in the
    mask, and the active rows are the draws without the mask; the wrapper
    on CPU tensors is the plain version and makes the mask only on
    request."""
    uniform, _ = cuda_polya_urn.polya_urn_reference(torch.zeros(3, 5), 0.0,
                                                    _seed(2))
    ref, _ = jax_rnd.polya_urn_dirichlet(jax.random.key(0),
                                         jnp.zeros((3, 5)), 0.0)
    np.testing.assert_array_equal(uniform.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(uniform.numpy(), np.float32(0.2))
    counts = torch.randint(0, 4, (6, 40), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(5))
    active = torch.tensor([True, False, True, True, False, True])
    full, _ = cuda_polya_urn.polya_urn(counts, 0.01, _seed(7))
    phi, zero = cuda_polya_urn.polya_urn(counts, 0.01, _seed(7), active,
                                         zero_mask=True)
    assert (phi[~active] == 0).all() and zero[~active].all()
    assert torch.equal(phi[active], full[active])
    assert cuda_polya_urn.polya_urn(counts, 0.01, _seed(7))[1] is None
    want = cuda_polya_urn.polya_urn_reference(counts, 0.01, _seed(7),
                                              active, True)
    assert torch.equal(phi, want[0]) and torch.equal(zero, want[1])


# ---------------------------------------------------------------------------
# VS-Dirichlet rows
# ---------------------------------------------------------------------------

def test_vs_uniforms_and_gammas_take_each_elements_own_blocks():
    """Element i's Gamma is gamma_reference's (blocks 8 i .. 8 i + 6) and
    its inclusion uniform is word x of block 8 i + 7, by hand."""
    seed = 0x0BAD_CAFE_1234
    i = 37
    u = cuda_gamma.vs_uniforms((50,), _seed(seed))
    t = torch.tensor([8 * i + 7], dtype=torch.int64)
    w = philox4x32_10(t, t >> 32, torch.tensor([seed & 0xFFFFFFFF]),
                      torch.tensor([seed >> 32]))[0]
    assert float(u[i]) == float(((w >> 9).to(torch.float32) + 0.5)
                                * 2.0 ** -23)
    counts = torch.zeros((5, 10), dtype=torch.int32)
    counts[:, 0] = 3
    phi, excl = cuda_gamma.vs_dirichlet_reference(counts, 0.5, 0.5,
                                                  _seed(seed),
                                                  zero_mask=True)
    g = cuda_gamma.gamma_reference(counts.to(torch.float32) + 0.5,
                                   _seed(seed))
    # no previous phi: zeroPhi = 0 < n_k, so only the counted coordinate
    assert excl[:, 1:].all() and not excl[:, 0].any()
    np.testing.assert_allclose(phi[:, 0].numpy(), 1.0)
    assert (g > 0).all()


def test_vs_dirichlet_inclusion_and_moments_match_jax():
    """Rows of one topic count 20 on coordinate 0, a previous draw zero on
    3 of 8 coordinates, beta 0.1, pi 0.5: 20,000 rows of the plain version
    against the JAX vs_dirichlet (vectorised): each coordinate's
    inclusion frequency and mean within 5 standard errors; the counted
    coordinate always included; rows sum to 1; the mask is exactly the
    excluded coordinates (phi == 0)."""
    rows, v = 20_000, 8
    counts = np.zeros((rows, v), np.float32)
    counts[:, 0] = 20.0
    prev = np.ones((rows, v), np.float32)
    prev[:, [1, 4, 6]] = 0.0
    ref, ref_zero = jax_rnd.vs_dirichlet(jax.random.key(5), counts, 0.1, 0.5,
                                         previous_phi=prev)
    ref, ref_zero = np.asarray(ref), np.asarray(ref_zero)
    phi, zero = cuda_gamma.vs_dirichlet_reference(
        torch.as_tensor(counts), 0.1, 0.5, _seed(55),
        torch.as_tensor(prev), zero_mask=True)
    np.testing.assert_allclose(phi.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(zero, phi == 0) and not zero[:, 0].any()
    ours, ours_zero = phi.numpy(), zero.numpy()
    for i in range(v):
        zf = _z(ours_zero[:, i].astype(float), ref_zero[:, i].astype(float),
                rows, rows)
        zm = _z(ours[:, i], ref[:, i], rows, rows)
        assert abs(zf) < 5 and abs(zm) < 5, (i, zf, zm)


def test_vs_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's rows, with
    the mask only on request; integer and float counts draw alike."""
    counts = torch.randint(0, 3, (4, 30), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    prev = (torch.rand(4, 30, generator=torch.Generator().manual_seed(2))
            > 0.4).to(torch.float32)
    got, none = cuda_gamma.vs_dirichlet(counts, 0.01, 0.3, _seed(4), prev)
    want, mask = cuda_gamma.vs_dirichlet_reference(counts, 0.01, 0.3,
                                                   _seed(4), prev, True)
    assert none is None and torch.equal(got, want)
    assert torch.equal(mask, want == 0)
    assert torch.equal(cuda_gamma.vs_dirichlet_reference(
        counts.to(torch.float32), 0.01, 0.3, _seed(4), prev)[0], want)


# ---------------------------------------------------------------------------
# ops/random.py off the CPU; no fallback
# ---------------------------------------------------------------------------

def test_random_hands_tensors_off_the_cpu_to_the_kernels(monkeypatch):
    """ops/random.py gives a tensor off the CPU (meta tensors stand in
    for the card) to the kernel wrappers with a kernel seed: Poisson,
    Polya-Urn (its mask only on request) and the vectorised VS rows; the
    sequential VS chain stays plain."""
    meta = torch.device("meta")
    seed = torch.empty(1, dtype=torch.int64, device=meta)
    calls = []
    monkeypatch.setattr(rnd, "kernel_seed", lambda gen, dev: seed)
    monkeypatch.setattr(cuda_polya_urn, "poisson", lambda lam, s: calls.append(
        ("poisson", lam.device.type, s is seed)) or lam)
    monkeypatch.setattr(cuda_polya_urn, "polya_urn",
                        lambda c, b, s, zero_mask: calls.append(
                            ("urn", b, zero_mask, s is seed)) or (c, None))
    monkeypatch.setattr(cuda_gamma, "vs_dirichlet",
                        lambda c, b, pi, s, prev, zero_mask: calls.append(
                            ("vs", b, pi, prev is None, zero_mask))
                        or (c, None))
    x = torch.empty((3, 4), device=meta)
    rnd.poisson(x, None)
    rnd.polya_urn_dirichlet(x, 0.01, None)
    rnd.polya_urn_dirichlet(x, 0.01, None, zero_mask=False)
    rnd.vs_dirichlet(x, 0.1, 0.5, None)
    assert calls == [("poisson", "meta", True), ("urn", 0.01, True, True),
                     ("urn", 0.01, False, True), ("vs", 0.1, 0.5, True, True)]


def test_wrappers_off_the_cpu_launch_or_raise(monkeypatch, tmp_path):
    """A failed build raises; an entry point that returns a CUDA error
    raises and counts no launch; no wrapper falls back."""
    meta = torch.device("meta")
    x = torch.empty((4, 6), device=meta)
    counts = torch.empty((4, 6), dtype=torch.int32, device=meta)
    seed = torch.empty(1, dtype=torch.int64, device=meta)
    calls = ((lambda: cuda_polya_urn.poisson(x, seed), "lda_poisson"),
             (lambda: cuda_polya_urn.polya_urn(counts, 0.01, seed),
              "lda_polya_urn"),
             (lambda: cuda_gamma.vs_dirichlet(counts, 0.01, 0.5, seed, x),
              "lda_vs_dirichlet"))

    def no_nvcc():
        raise RuntimeError("nvcc failed (test)")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "libldakernels-test.so")
    _build.library.cache_clear()
    try:
        for call, _ in calls:
            with pytest.raises(RuntimeError, match="nvcc failed"):
                call()
    finally:
        _build.library.cache_clear()

    class FailingLibrary:
        def __getattr__(self, name):
            return lambda *args: 700        # cudaErrorIllegalAddress
    monkeypatch.setattr(_build, "library", lambda: FailingLibrary())
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    fns = (cuda_polya_urn.poisson, cuda_polya_urn.polya_urn,
           cuda_gamma.vs_dirichlet)
    before = [f.launches for f in fns]
    for call, name in calls:
        with pytest.raises(RuntimeError, match=f"{name} failed"):
            call()
    assert [f.launches for f in fns] == before


# ---------------------------------------------------------------------------
# the chains with phi from the kernels' plain versions
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("scheme", ["polyaurn", "nzvsspalias"])
def test_chain_ll_with_the_kernels_draws_within_jax_seed_spread(
        corpus, monkeypatch, scheme):
    """ops/random.py's card path on the CPU (the wrappers' plain versions
    from a kernel seed of the chain's generator): the model LL at
    iteration 50, the median of 10 chains, within the range of 10 JAX
    chains widened by 3 standard deviations (as tests/test_torch_nzvs.py
    holds the generator path); every phi draw went through the wrapper;
    phi keeps exact zeros."""
    drawn = []

    def urn(counts, beta, generator, zero_mask=True):
        drawn.append("urn")
        return cuda_polya_urn.polya_urn(
            counts, beta, rnd.kernel_seed(generator, counts.device),
            zero_mask=zero_mask)

    def vs(counts, beta, vs_prior, generator, previous_phi=None,
           sequential=False):
        drawn.append("vs")
        return cuda_gamma.vs_dirichlet(
            counts, beta, vs_prior, rnd.kernel_seed(generator,
                                                    counts.device),
            previous_phi, zero_mask=True)
    monkeypatch.setattr(rnd, "polya_urn_dirichlet", urn)
    monkeypatch.setattr(rnd, "vs_dirichlet", vs)
    iters = 50
    cfg = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1,
               token_block=512)
    jm = jax_create_model(JaxConfig(scheme=scheme, seed=7,
                                    topic_interval=iters, **cfg))
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JC
    jc = JC(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
            vocab=corpus.vocab)
    finals = []
    for seed in range(10):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        jm.sample(iters)
        finals.append(jm.get_log_likelihoods()[-1][1])
    lls = []
    for seed in range(10):
        port = create_model(LDAConfig(scheme=scheme, seed=seed,
                                      device="cpu", **cfg))
        port.add_instances(corpus).sample(iters)
        lls.append(port.model_log_likelihood())
        assert (port.get_phi() == 0).any()
    want = "urn" if scheme == "polyaurn" else "vs"
    assert drawn.count(want) == 10 * (iters + 1)
    ll_ = float(np.median(lls))
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll_ <= hi + 3 * sd, (ll_, finals)
