"""The HDP step's kernels' plain versions on the CPU (ops/cuda_hdp.py,
csrc/hdp.cu): the ge histogram equal to the JAX package's, the Binomial
sampler against scipy in both regimes, at the switch and at its exact
edges, the table counts and the psi step (births, active mask, GEM and
Poisson psi) against the JAX functions' draws in distribution, hlda's
births on the lowest free slots exactly, the wrappers' refusal to fall
back off the CPU, and the HDP chains run through the kernels' path (their
plain versions) against the JAX chains' likelihoods.

Tolerances: counts and masks exact; distributions by chi-square or
two-sample KS at p > 1e-4 and means within 5 standard errors; psi sums to 1
within 1e-5 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.evaluation import likelihood as jax_ll
from ldagroupedgibbssampler_tpu.models import hdp as jax_hdp
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu.ops import random as jax_rnd
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models import hdp
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_hdp
from ldagroupedgibbssampler_tpu_torch.ops import cuda_polya_urn
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(v):
    return torch.tensor([v], dtype=torch.int64)


def _keys(n, seed=0):
    return jax.random.split(jax.random.key(seed), n)


def _chi2_pvalue(draws, pmf):
    """Chi-square p of integer draws against pmf (over 0..len(pmf) - 1),
    the cells of expectation below 5 pooled into one."""
    obs = np.bincount(draws.astype(np.int64), minlength=len(pmf))
    assert obs.size == len(pmf), "a draw beyond the support"
    exp = pmf * draws.size
    big = exp >= 5
    o = np.append(obs[big], obs[~big].sum())
    e = np.append(exp[big], exp[~big].sum())
    keep = e > 0
    chi2 = float(((o[keep] - e[keep]) ** 2 / e[keep]).sum())
    return float(stats.chi2.sf(chi2, keep.sum() - 1))


# ---------------------------------------------------------------------------
# ge and the Binomial sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_count", [4, 9])
def test_ge_equals_the_jax_histogram_with_counts_above_m(max_count):
    """ge[k, j - 1] = #docs with n_dk >= j equals the JAX package's
    doc_count_ge_histogram exactly, where n_dk exceeds M too, from the
    plain version and from the wrapper's `ge` output on the CPU."""
    ndk = np.random.default_rng(1).integers(0, 13, (60, 7)).astype(np.int32)
    ref = np.asarray(jax_hdp.doc_count_ge_histogram(jnp.asarray(ndk),
                                                    max_count))
    ours = cuda_hdp.ge_reference(torch.as_tensor(ndk), max_count)
    assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)
    out = torch.empty((7, max_count), dtype=torch.int32)
    cuda_hdp.table_counts(torch.as_tensor(ndk), torch.rand(7), max_count,
                          _seed(3), ge=out)
    assert np.array_equal(out.numpy(), ref)


# (n, p): inversion, the switch n q = 10 (inversion), just above it
# (BTRS), BTRS, p > 1/2 by symmetry in both regimes, a large n at small q
BINOMIAL_CASES = [(6, 0.3), (40, 0.25), (41, 0.25), (400, 0.1), (90, 0.8),
                  (15, 0.9), (5000, 0.002)]


@pytest.mark.parametrize("n,p", BINOMIAL_CASES)
def test_binomial_follows_scipy_by_chi_square(n, p):
    """40,000 draws of Binomial(n, p) against scipy.stats.binom by
    chi-square (p > 1e-4), and their mean within 5 standard errors."""
    m = 40_000
    draws = cuda_hdp.binomial_reference(torch.full((m,), float(n)),
                                        torch.full((m,), p),
                                        _seed(17 + n)).numpy()
    assert (draws == np.round(draws)).all()
    pmf = stats.binom.pmf(np.arange(n + 1), n, p)
    assert _chi2_pvalue(draws, pmf) > 1e-4
    se = (n * p * (1 - p) / m) ** 0.5
    assert abs(draws.mean() - n * p) < 5 * se


def test_binomial_exact_edges_floor_and_nan():
    """n = 0, p = 0 give 0 and p = 1 gives n exactly; n is floored; a
    negative n, a NaN or a p outside [0, 1] give NaN."""
    n = torch.tensor([0.0, 7.0, 7.6, 12.0, -1.0, 5.0, 5.0, float("nan")])
    p = torch.tensor([0.4, 0.0, 1.0, 1.0, 0.5, 1.5, float("nan"), 0.5])
    out = cuda_hdp.binomial_reference(n, p, _seed(5)).numpy()
    np.testing.assert_array_equal(out[:4], [0.0, 0.0, 7.0, 12.0])
    assert np.isnan(out[4:]).all()
    drawn = cuda_hdp.binomial_reference(torch.full((500,), 9.9),
                                        torch.full((500,), 0.5), _seed(6))
    assert drawn.max() <= 9 and drawn.min() >= 0


def test_binomial_draw_depends_on_its_element_alone():
    """A draw is a function of (seed, element): the same values drawn in
    another order with their element indexes, or one at a time, are the
    same draws (both regimes)."""
    gen = torch.Generator().manual_seed(2)
    n = torch.randint(0, 300, (600,), generator=gen).float()
    p = torch.rand(600, generator=gen)
    seed = _seed(0x7777)
    whole = cuda_hdp.binomial_reference(n, p, seed)
    perm = torch.randperm(600, generator=gen)
    again = cuda_hdp.binomial_reference(n[perm], p[perm], seed,
                                        element=perm)
    assert torch.equal(again, whole[perm])
    for i in (0, 17, 599):
        one = cuda_hdp.binomial_reference(n[i:i + 1], p[i:i + 1], seed,
                                          element=torch.tensor([i]))
        assert torch.equal(one, whole[i:i + 1])


# ---------------------------------------------------------------------------
# table counts
# ---------------------------------------------------------------------------

def test_table_counts_match_the_jax_draws_by_two_sample_ks():
    """40 documents, 3 topics: 3,000 JAX draws of sample_table_counts
    (3,000 keys) against 3,000 of the plain version (one Philox seed,
    the topics tiled 3,000 times, so each tile draws its own elements):
    per topic KS p > 1e-4 and means within 5 standard errors."""
    rng = np.random.default_rng(7)
    ndk = rng.integers(0, 7, size=(40, 3)).astype(np.int32)
    avec = np.array([0.4, 1.3, 2.5], np.float32)
    m, reps = int(ndk.max()), 3000
    ref = np.asarray(jax.vmap(lambda k: jax_hdp.sample_table_counts(
        k, jnp.asarray(ndk), jnp.asarray(avec), m))(_keys(reps, 1)))
    ours = cuda_hdp.table_counts_reference(
        torch.as_tensor(np.tile(ndk, (1, reps))),
        torch.as_tensor(np.tile(avec, reps)), m, _seed(99)).numpy()
    ours = ours.reshape(reps, 3)
    for t in range(3):
        zm = ((ours[:, t].mean() - ref[:, t].mean())
              / np.sqrt(ours[:, t].var() / reps + ref[:, t].var() / reps))
        assert abs(zm) < 5.0, (t, zm)
        assert stats.ks_2samp(ours[:, t], ref[:, t]).pvalue > 1e-4, t


def test_table_counts_zero_concentration_and_scalar_gamma():
    """a_k = 0 gives l_k = ge_1 (#docs with n_dk >= 1) exactly, as the
    JAX function does; a topic with no token draws 0; one float for every
    topic (hlda's gamma) draws what the vector of that float draws."""
    ndk = torch.tensor([[0, 3, 2, 0], [0, 1, 0, 4], [0, 0, 5, 1]],
                       dtype=torch.int32)
    a = torch.tensor([0.0, 0.0, 0.0, 1.5])
    for m in (5, 40):
        tab, ge = cuda_hdp.table_counts_reference(ndk, a, m, _seed(m), True)
        assert torch.equal(tab[:3], ge[:3, 0].to(torch.float32))
        assert tab[0] == 0 and 2 <= tab[3] <= 5
        ref = jax_hdp.sample_table_counts(jax.random.key(m),
                                          jnp.asarray(ndk.numpy()),
                                          jnp.asarray(a.numpy()), m)
        np.testing.assert_array_equal(np.asarray(ref)[:3], tab[:3].numpy())
    one = cuda_hdp.table_counts_reference(ndk, 1.25, 6, _seed(1))
    vec = cuda_hdp.table_counts_reference(ndk, torch.full((4,), 1.25), 6,
                                          _seed(1))
    assert torch.equal(one, vec)


# ---------------------------------------------------------------------------
# births, active mask, psi
# ---------------------------------------------------------------------------

def _psi_rows(tables, seeds, **kw):
    rows = len(seeds)
    k = tables.shape[-1]
    t = torch.as_tensor(np.tile(tables, (rows, 1)))
    return cuda_hdp.psi_reference(
        t, torch.zeros((rows, k), dtype=torch.int32),
        torch.ones((rows, k), dtype=torch.bool),
        torch.as_tensor(seeds, dtype=torch.int64), **kw)


def test_gem_psi_matches_the_jax_gem_psi():
    """The GEM sticks (births "none", as all topics draws them): 4,000
    rows, one Philox seed each, against 4,000 JAX gem_psi keys: means
    within 5 standard errors, KS p > 1e-4 on the first and last stick,
    rows summing to 1."""
    tables = np.array([9.0, 0.0, 4.0, 1.0], np.float32)
    gamma, n = 1.3, 4000
    ref = np.asarray(jax.vmap(lambda k: jax_hdp.gem_psi(
        k, jnp.asarray(tables), gamma))(_keys(n, 2)))
    psi, active, alpha, born = _psi_rows(
        tables, np.arange(1, n + 1) * 7919, gamma=gamma, budget=4,
        births="none", sampler="gem", alpha0=0.5)
    ours = psi.numpy()
    np.testing.assert_allclose(ours.sum(1), 1.0, atol=1e-5)
    assert active.all() and not born.any()
    assert torch.equal(alpha, 0.5 * psi)
    for t in range(4):
        zm = ((ours[:, t].mean() - ref[:, t].mean())
              / np.sqrt(ours[:, t].var() / n + ref[:, t].var() / n))
        assert abs(zm) < 5.0, (t, zm)
    for t in (0, 3):
        assert stats.ks_2samp(ours[:, t], ref[:, t]).pvalue > 1e-4, t


def test_poisson_psi_matches_the_jax_poisson_psi():
    """The Poisson psi without births: 4,000 rows against 4,000 JAX
    poisson_psi keys, means within 5 standard errors and KS on a
    4-decimal grid; the all-zero row is uniform."""
    tables = np.array([6.0, 0.0, 2.0], np.float32)
    n = 4000
    ref = np.asarray(jax.vmap(lambda k: jax_hdp.poisson_psi(
        k, jnp.asarray(tables), jnp.zeros(3, jnp.int32)))(_keys(n, 3)))
    ours = _psi_rows(tables, np.arange(1, n + 1) * 31, gamma=1.0, budget=4,
                     births="none", sampler="poisson")[0].numpy()
    for t in range(3):
        zm = ((ours[:, t].mean() - ref[:, t].mean())
              / np.sqrt(ours[:, t].var() / n + ref[:, t].var() / n + 1e-30))
        assert abs(zm) < 5.0, (t, zm)
        assert stats.ks_2samp(np.round(ours[:, t].astype(np.float64), 4),
                              np.round(ref[:, t].astype(np.float64),
                                       4)).pvalue > 1e-4, t
    empty = cuda_hdp.psi_reference(torch.zeros(5), None,
                                   torch.ones(5, dtype=torch.bool),
                                   _seed(4), gamma=1.0, budget=4,
                                   births="none", sampler="poisson")[0]
    np.testing.assert_allclose(empty.numpy(), 0.2)


@pytest.mark.parametrize("dist", ["geometric", "uniform"])
def test_birth_candidates_match_the_jax_draws(dist):
    """hdplda's births (no topic in the data): the number born and the
    index each lands on, 3,000 rows against 3,000 JAX
    sample_birth_candidates keys (gamma 1, K 32, budget 16): the totals'
    means within 5 standard errors and KS p > 1e-4, the indices by a
    chi-square contingency test p > 1e-4; a topic is active iff born."""
    n, k_max, budget = 3000, 32, 16
    ref = np.asarray(jax.vmap(lambda key: jax_hdp.sample_birth_candidates(
        key, 1.0, k_max, budget, dist))(_keys(n, 4)))
    psi, active, alpha, born = cuda_hdp.psi_reference(
        torch.zeros((n, k_max)), torch.zeros((n, k_max), dtype=torch.int32),
        torch.zeros((n, k_max), dtype=torch.bool),
        torch.arange(1, n + 1, dtype=torch.int64) * 104729, gamma=1.0,
        budget=budget, births="candidates", sampler="poisson", dist=dist)
    ours = born.numpy()
    assert torch.equal(active, born > 0)
    tot_o, tot_r = ours.sum(1), ref.sum(1)
    zm = (tot_o.mean() - tot_r.mean()) / np.sqrt(
        tot_o.var() / n + tot_r.var() / n)
    assert abs(zm) < 5.0 and stats.ks_2samp(tot_o, tot_r).pvalue > 1e-4
    table = np.stack([ours.sum(0), ref.sum(0)])
    table = table[:, table.sum(0) >= 10]
    assert stats.chi2_contingency(table)[1] > 1e-4
    np.testing.assert_allclose(psi.sum(1).numpy(), 1.0, atol=1e-5)


def test_hlda_births_take_the_lowest_slots_not_in_the_data():
    """hlda: the min(n_add, budget) lowest-indexed slots that are not
    active with tokens are born, exactly, n_add ~ Poisson(gamma) the
    draw at element 1; the active mask is the slots in the data and the
    born ones; the Poisson psi carries each birth's pseudo-table; alpha is
    alpha0 psi on the active topics and 0 elsewhere; psi sums to 1."""
    k_max, budget, gamma = 24, 5, 3.0
    rng = np.random.default_rng(11)
    seen = set()
    for s in range(40):
        active = torch.as_tensor(rng.random(k_max) < 0.5)
        nk = torch.as_tensor(rng.integers(0, 3, k_max).astype(np.int32))
        tables = torch.as_tensor(
            rng.integers(0, 6, k_max).astype(np.float32)) * (nk > 0)
        seed = _seed(1000 + s)
        psi, act, alpha, born = cuda_hdp.psi_reference(
            tables, nk, active, seed, gamma=gamma, budget=budget,
            births="lowest", sampler="poisson", alpha0=0.7)
        n_add = int(cuda_polya_urn.poisson_reference(
            torch.tensor([gamma]), seed, torch.tensor([1]))[0])
        in_data = active & (nk > 0)
        free = (~in_data).nonzero().reshape(-1)[:min(n_add, budget)]
        want = torch.zeros(k_max, dtype=torch.int32)
        want[free] = 1
        assert torch.equal(born, want) and torch.equal(act, in_data | (
            want > 0))
        assert float(psi.sum()) == pytest.approx(1.0, abs=1e-5)
        assert (psi[born > 0] > 0).all()
        assert torch.equal(alpha, 0.7 * psi * act.to(torch.float32))
        seen.add(min(n_add, budget))
    assert len(seen) >= 3      # several birth counts, the budget among them


def test_psi_step_on_the_cpu_is_the_plain_version_and_checks_options():
    """The wrapper on CPU tensors returns the plain version's values; an
    unknown birth rule, sampler or index prior raises."""
    tables = torch.tensor([3.0, 0.0, 1.0, 7.0])
    nk = torch.tensor([2, 0, 0, 5], dtype=torch.int32)
    active = torch.tensor([True, False, True, True])
    kw = dict(gamma=1.0, budget=3, births="candidates", sampler="gem",
              dist="uniform", alpha0=0.5)
    got = cuda_hdp.psi_step(tables, nk, active, _seed(8), **kw)
    want = cuda_hdp.psi_reference(tables, nk, active, _seed(8), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for bad in (dict(births="all"), dict(sampler="dirichlet"),
                dict(dist="zipf")):
        with pytest.raises(ValueError, match="unknown"):
            cuda_hdp.psi_step(tables, nk, active, _seed(8), **{**kw, **bad})


# ---------------------------------------------------------------------------
# no fallback off the CPU
# ---------------------------------------------------------------------------

def test_wrappers_off_the_cpu_launch_or_raise(monkeypatch, tmp_path):
    """A tensor off the CPU launches the kernel or raises (meta tensors
    stand in for the card): a failed build raises, an entry point that
    returns a CUDA error raises and counts no launch; ops/random.py hands
    Binomial draws off the CPU to the kernel wrapper with a kernel seed."""
    meta = torch.device("meta")
    ndk = torch.empty((6, 4), dtype=torch.int32, device=meta)
    tables = torch.empty(4, device=meta)
    active = torch.empty(4, dtype=torch.bool, device=meta)
    nk = torch.empty(4, dtype=torch.int32, device=meta)
    seed = torch.empty(1, dtype=torch.int64, device=meta)
    calls = (
        (lambda: cuda_hdp.binomial(tables, tables, seed), "lda_binomial"),
        (lambda: cuda_hdp.table_counts(ndk, 0.5, 3, seed),
         "lda_hdp_table_counts"),
        (lambda: cuda_hdp.psi_step(tables, nk, active, seed, gamma=1.0,
                                   budget=2, births="candidates",
                                   sampler="gem"), "lda_hdp_psi"))

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
    fns = (cuda_hdp.binomial, cuda_hdp.table_counts, cuda_hdp.psi_step)
    before = [f.launches for f in fns]
    for call, name in calls:
        with pytest.raises(RuntimeError, match=f"{name} failed"):
            call()
    assert [f.launches for f in fns] == before

    got = []
    monkeypatch.setattr(rnd, "kernel_seed", lambda gen, dev: seed)
    monkeypatch.setattr(cuda_hdp, "binomial", lambda n, p, s: got.append(
        (n.device.type, tuple(p.shape), s is seed)) or n)
    rnd.binomial(torch.empty((2, 3), device=meta),
                 torch.empty(3, device=meta), None)
    assert got == [("meta", (2, 3), True)]


# ---------------------------------------------------------------------------
# the HDP chains through the kernels' path (their plain versions on the CPU)
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


@pytest.fixture
def kernel_path(monkeypatch):
    """The HDP models' card path on the CPU: _step runs
    _kernel_after_sweep, whose wrappers take their plain versions for CPU
    tensors, with the kernel seeds drawn from the chain's generator."""
    cls = hdp.PoissonPolyaUrnHDPLDAInfiniteTopics
    calls = []
    real = cls._kernel_after_sweep

    def spy(self, *args):
        calls.append(type(self).__name__)
        return real(self, *args)
    monkeypatch.setattr(cls, "_eager_after_sweep", spy)
    return calls


def _recount(model, corpus):
    k = model.config.topics
    z = model.get_z_indicators()
    nkw = np.zeros((k, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    ndk = np.zeros((corpus.num_docs, k), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    return nkw, ndk


@pytest.mark.parametrize("scheme", ["ppu_hdplda", "ppu_hlda",
                                    "ppu_hdplda_all_topics"])
def test_kernel_path_keeps_the_hdp_invariants(corpus, kernel_path, scheme):
    """20 iterations of each scheme through the kernels' path: every step
    took it; counts exact against a recount of z; inactive topics have
    alpha 0, zero phi rows and no token; psi sums to 1; topics were born
    (hdplda, hlda) and hlda's active set is contiguous from 0 (its births
    take the lowest free slots)."""
    cfg = LDAConfig(scheme=scheme, topics=10, alpha=1.0, beta=0.01, seed=3,
                    exec_time=-1, topic_interval=20, device="cpu",
                    hdp_start_topics=1, hdp_gamma=1.0)
    model = create_model(cfg).add_instances(corpus)
    model.sample(20)
    assert len(kernel_path) == 20
    nkw, ndk = _recount(model, corpus)
    assert np.array_equal(model.get_topic_type_counts(), nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    active = model.get_active_mask()
    assert (model.get_alpha()[~active] == 0).all()
    assert (model.get_phi()[~active] == 0).all()
    assert (model.get_tokens_per_topic()[~active] == 0).all()
    assert float(model.get_psi().sum()) == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(model.get_phi()[active].sum(1), 1.0,
                               atol=1e-5)
    if scheme != "ppu_hdplda_all_topics":
        assert max(model.get_active_topic_history()) >= 2
    if scheme == "ppu_hlda":
        assert not active[int(active.sum()):].any()


def test_kernel_path_chain_ll_within_jax_seed_spread(corpus, kernel_path):
    """ppu_hdplda through the kernels' path: the median model LL at
    iteration 40 of 5 chains lies within the range of 5 JAX chains
    widened by 3 standard deviations (the JAX LL on its active topics, as
    tests/test_torch_hdp.py::test_ll_within_jax_seed_spread holds the
    generator path)."""
    iters = 40
    kw = dict(topics=10, alpha=1.0, beta=0.01, exec_time=-1,
              hdp_start_topics=1, hdp_gamma=1.0)
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JC
    jm = jax_create_model(JaxConfig(scheme="ppu_hdplda", seed=7,
                                    topic_interval=iters, **kw))
    jc = JC(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
            vocab=corpus.vocab)
    finals = []
    for seed in range(5):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(200 + seed, impl="rbg"))
        jm.sample(iters)
        st = jm.state
        keep = np.asarray(st.alpha) > 0
        finals.append(float(jax_ll.model_log_likelihood(
            np.asarray(st.ndk)[:, keep], np.asarray(jm._nkw_kv())[keep],
            np.asarray(st.alpha)[keep], float(st.beta))))
    lls = []
    for seed in range(5):
        port = create_model(LDAConfig(scheme="ppu_hdplda", seed=seed,
                                      device="cpu", **kw))
        port.add_instances(corpus).sample(iters)
        lls.append(port.model_log_likelihood())
    assert len(kernel_path) == 5 * iters
    ll_ = float(np.median(lls))
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll_ <= hi + 3 * sd, (ll_, finals)


def test_binomial_regimes_match_jax_binomial_by_two_sample_ks():
    """The plain Binomial against jax.random.binomial itself (the
    package's ops/random.py::binomial) at an inversion and a BTRS case:
    20,000 draws each, two-sample KS p > 1e-4."""
    for n, p in ((12, 0.3), (300, 0.4)):
        ref = np.asarray(jax_rnd.binomial(jax.random.key(n),
                                          jnp.full((20_000,), float(n)),
                                          jnp.float32(p)))
        ours = cuda_hdp.binomial_reference(torch.full((20_000,), float(n)),
                                           torch.full((20_000,), p),
                                           _seed(n)).numpy()
        assert stats.ks_2samp(ours, ref).pvalue > 1e-4, (n, p)
