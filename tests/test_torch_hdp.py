"""The HDP family on the port (`ppu_hdplda`, `ppu_hlda`,
`ppu_hdplda_all_topics`) against the JAX package: the deterministic pieces
exactly, the table-count and psi draws by exact distributional tests (the
JAX package's tests/test_geweke.py:625-757, fast enough for this tier),
the birth draws statistically, the z-sweep (the sweep kernel's plain
version) against the interpreted Pallas kernel on an alpha with exact
zeros and zero phi rows, the scheme dynamics of tests/test_hdp.py,
likelihoods against JAX chains, checkpoints both ways, and the
likelihood's alpha_k = 0 rule. Also the extended cases of
tests/test_e2e_samplers.py for the five schemes of this slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.evaluation import likelihood as jax_ll
from ldagroupedgibbssampler_tpu.models import hdp as jax_hdp
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu.ops.pallas_pcgs import (
    fused_pcgs_sweep as jax_sweep,
    fused_pcgs_sweep_streamed as jax_sweep_streamed)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation import likelihood as ll
from ldagroupedgibbssampler_tpu_torch.models import fused_sweep, hdp
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model

HDP_SCHEMES = ["ppu_hdplda", "ppu_hlda", "ppu_hdplda_all_topics"]



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


def _jax_corpus(corpus):
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
    return JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                     vocab=corpus.vocab)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _run_hdp(scheme, corpus, iterations=30, alpha=1.0, **kw):
    """tests/test_hdp.py::_run_hdp on the port."""
    kw.setdefault("hdp_start_topics", 1)
    kw.setdefault("hdp_gamma", 1.0)
    cfg = LDAConfig(scheme=scheme, topics=10, alpha=alpha, beta=0.01,
                    iterations=iterations, seed=5, exec_time=-1,
                    topic_interval=iterations, device="cpu", **kw)
    model = create_model(cfg).add_instances(corpus)
    model.sample(iterations)
    return model


def _assert_counts_exact(model, corpus):
    k = model.config.topics
    z = model.get_z_indicators()
    nkw = np.zeros((k, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    ndk = np.zeros((corpus.num_docs, k), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    assert np.array_equal(model.get_topic_type_counts(), nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=1))


# ---------------------------------------------------------------------------
# deterministic pieces, exactly against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_count", [10, 4])
def test_doc_count_ge_histogram_matches_jax(max_count):
    """D(j, k) = #docs with n_dk >= j, equal to the JAX function and to
    the naive [D, K, M] broadcast (max_count 4 clips the larger counts)."""
    ndk = np.random.default_rng(0).integers(0, 7, (50, 8)).astype(np.int32)
    ours = hdp.doc_count_ge_histogram(torch.as_tensor(ndk), max_count)
    ref = np.asarray(jax_hdp.doc_count_ge_histogram(jnp.asarray(ndk),
                                                    max_count))
    assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)
    j = np.arange(1, max_count + 1)
    assert np.array_equal(
        ours.numpy(), (ndk[:, :, None] >= j[None, None, :]).sum(axis=0))


def test_calc_k_matches_jax():
    """calc_k's first-index-exceeding convention, equal to the JAX
    function on ties, zeros, empty input and every percentile edge (the
    cases of tests/test_e2e_samplers.py::test_hdp_k_percentile_statistic
    included)."""
    rng = np.random.default_rng(3)
    cases = [[100, 100, 100, 0], [90, 5, 5], [0, 0], [], [7],
             list(rng.integers(0, 50, 30)), list(rng.zipf(1.5, 40))]
    for tokens in cases:
        for pct in (0.0, 0.5, 0.8, 0.99, 1.0):
            assert hdp.calc_k(pct, tokens) == jax_hdp.calc_k(pct, tokens), \
                (tokens, pct)
    assert hdp.calc_k(0.8, [100, 100, 100, 0]) == 2
    assert hdp.calc_k(0.5, [90, 5, 5]) == 0
    assert hdp.calc_k(0.99, [0, 0]) == 2


# ---------------------------------------------------------------------------
# the draws: the exact tests of tests/test_geweke.py:625-757 on the port
# (batched over topics or rows instead of vmapped keys), and the births
# ---------------------------------------------------------------------------

def _stirling_unsigned(n):
    s = np.zeros((n + 1, n + 1))
    s[0, 0] = 1.0
    for m in range(1, n + 1):
        for l_ in range(1, m + 1):
            s[m, l_] = s[m - 1, l_ - 1] + (m - 1) * s[m - 1, l_]
    return s


def _antoniak_pmf(n, a):
    """P(L = l | n customers, concentration a) = S(n, l) a^l / (a)_n."""
    pmf = _stirling_unsigned(n)[n] * a ** np.arange(n + 1) \
        / np.prod(a + np.arange(n))
    return pmf / pmf.sum()


def test_sample_table_counts_antoniak_exact():
    """tests/test_geweke.py::test_hdp_sample_table_counts_antoniak_exact:
    (1) one document of 6 customers at a = 0.7 against the analytic
    Antoniak pmf by chi-square (20,000 draws, as 20,000 one-document
    topics of one call); (2) 40 documents and 3 topics against an
    independent numpy per-document Bernoulli CRP, moments by z < 5 and
    shapes by KS (8,000 draws each)."""
    n_cust, a = 6, 0.7
    draws = hdp.sample_table_counts(
        torch.full((1, 20000), n_cust, dtype=torch.int32),
        torch.full((20000,), a), n_cust, _gen(11)).numpy()
    pmf = _antoniak_pmf(n_cust, a)
    obs = np.bincount(draws.astype(int), minlength=n_cust + 1).astype(float)
    exp = pmf * len(draws)
    keep = exp > 5
    chi2 = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    assert sps.chi2.sf(chi2, int(keep.sum()) - 1) > 1e-4, (obs, exp)

    rng = np.random.default_rng(7)
    ndk = rng.integers(0, 7, size=(40, 3)).astype(np.int32)
    avec = np.array([0.4, 1.3, 2.5], np.float32)
    m, reps = int(ndk.max()), 8000
    ours = hdp.sample_table_counts(
        torch.as_tensor(np.tile(ndk, (1, reps))),
        torch.as_tensor(np.tile(avec, reps)), m, _gen(12)).numpy()
    ours = ours.reshape(reps, 3)
    ref = np.zeros((reps, 3))
    for t in range(3):
        ge = [(ndk[:, t] >= j).sum() for j in range(1, m + 1)]
        ps = avec[t] / (avec[t] + np.arange(m))
        ref[:, t] = sum(rng.binomial(int(g), p, size=reps)
                        for g, p in zip(ge, ps))
    for t in range(3):
        zm = ((ours[:, t].mean() - ref[:, t].mean())
              / np.sqrt(ours[:, t].var() / reps + ref[:, t].var() / reps))
        assert abs(zm) < 5.0, (t, zm)
        assert sps.ks_2samp(ours[:, t], ref[:, t]).pvalue > 1e-4, t


def test_sample_table_counts_zero_alpha_topics_have_no_tables():
    """An inactive topic (a_k = 0, n_dk = 0 everywhere) draws l_k = 0,
    a_k = 0 with tokens draws exactly #docs with n_dk >= 1 (p = 1 at
    j = 1, 0 beyond), and a longer j range than any n_dk changes
    nothing."""
    ndk = torch.tensor([[0, 3, 2], [0, 1, 0], [0, 0, 5]], dtype=torch.int32)
    a = torch.tensor([0.0, 0.0, 1.5])
    for m in (5, 40):
        tab = hdp.sample_table_counts(ndk, a, m, _gen(m))
        assert tab[0] == 0 and tab[1] == 2 and 1 <= tab[2] <= 2 + 5


def test_gem_psi_exact():
    """tests/test_geweke.py::test_hdp_gem_psi_exact: per-component means
    (z < 5) and KS of psi_0 and psi_{K-1} against an independent numpy
    stick-breaking posterior, 20,000 draws (rows of one call)."""
    tables = np.array([9.0, 0.0, 4.0, 1.0], np.float32)
    gamma, n = 1.3, 20000
    ours = hdp.gem_psi(torch.as_tensor(np.tile(tables, (n, 1))), gamma,
                       _gen(21)).numpy()
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, atol=1e-5)
    rng = np.random.default_rng(22)
    rest = np.concatenate([np.cumsum(tables[::-1])[::-1][1:], [0.0]])
    b = np.clip(rng.beta(1.0 + tables, gamma + rest, size=(n, 4)),
                1e-7, 1 - 1e-7)
    sticks = b * np.concatenate(
        [np.ones((n, 1)), np.cumprod(1 - b, axis=1)[:, :-1]], axis=1)
    ref = sticks / sticks.sum(axis=1, keepdims=True)
    for t in range(4):
        zm = ((ours[:, t].mean() - ref[:, t].mean())
              / np.sqrt(ours[:, t].var() / n + ref[:, t].var() / n))
        assert abs(zm) < 5.0, (t, zm)
    for t in (0, 3):
        assert sps.ks_2samp(ours[:, t], ref[:, t]).pvalue > 1e-4, t


def test_poisson_psi_exact():
    """tests/test_geweke.py::test_hdp_poisson_psi_exact (with
    tests/test_hdp.py's proportionality and birth-mass checks): means
    (z < 5) and KS on a 4-decimal grid against numpy, 20,000 draws."""
    tables = np.array([6.0, 0.0, 2.0], np.float32)
    births = np.array([0, 1, 0], np.int32)
    n = 20000
    ours = hdp.poisson_psi(torch.as_tensor(np.tile(tables, (n, 1))),
                           torch.as_tensor(births), _gen(31)).numpy()
    rng = np.random.default_rng(32)
    eta = rng.poisson(tables, size=(n, 3)) + births[None, :]
    tot = eta.sum(axis=1, keepdims=True)
    ref = np.where(tot > 0, eta / np.maximum(tot, 1.0), 1.0 / 3)
    for t in range(3):
        zm = ((ours[:, t].mean() - ref[:, t].mean())
              / np.sqrt(ours[:, t].var() / n + ref[:, t].var() / n))
        assert abs(zm) < 5.0, (t, zm)
        assert sps.ks_2samp(np.round(ours[:, t].astype(np.float64), 4),
                            np.round(ref[:, t], 4)).pvalue > 1e-4, t
    assert (ours[:, 1] > 0).all()       # the born topic's +1 increment
    psi = hdp.poisson_psi(torch.tensor([[100.0, 300.0, 0.0, 600.0]] * 2000),
                          torch.zeros(4, dtype=torch.int32), _gen(33))
    np.testing.assert_allclose(psi.mean(0).numpy(), [0.1, 0.3, 0.0, 0.6],
                               atol=0.01)
    empty = hdp.poisson_psi(torch.zeros(5), torch.zeros(5), _gen(34))
    np.testing.assert_allclose(empty.numpy(), 0.2)


def test_birth_candidates_geometric_vs_uniform():
    """tests/test_hdp.py::test_birth_candidates_geometric_vs_uniform: about
    Poisson(1) births an iteration under both priors, the geometric one on
    the low indices, the uniform one spread; an unknown prior raises."""
    g = _gen(41)
    geo = np.stack([hdp.sample_birth_candidates(1.0, 32, 16, "geometric",
                                                g, "cpu").numpy()
                    for _ in range(300)])
    uni = np.stack([hdp.sample_birth_candidates(1.0, 32, 16, "uniform",
                                                g, "cpu").numpy()
                    for _ in range(300)])
    assert 0.7 < geo.sum(1).mean() < 1.3
    assert 0.7 < uni.sum(1).mean() < 1.3
    assert geo.sum(0)[:4].sum() > 0.8 * geo.sum()
    assert uni.sum(0)[16:].sum() > 0.25 * uni.sum()
    with pytest.raises(ValueError, match="hdp_gamma_dist"):
        hdp.sample_birth_candidates(1.0, 32, 16, "zipf", g, "cpu")


# ---------------------------------------------------------------------------
# the HDP z-sweep against the interpreted Pallas kernel
# ---------------------------------------------------------------------------

@pytest.fixture(params=["resident", "streamed"])
def layout(request, monkeypatch):
    if request.param == "streamed":
        monkeypatch.setattr(fused_sweep, "_FUSED_PCGS_VMEM_BUDGET", 1)
    return request.param


def test_hdp_sweep_matches_interpreted_kernel(corpus, layout):
    """The port's ppu_hdplda sweep, its operands built by the model with
    alpha exactly 0 on 6 of 10 topics whose phi rows are all zero (as
    inactive HDP topics are) and Polya-Urn zeros in the live rows, every
    4th document unselected, against the JAX package's fused_pcgs_sweep
    (interpret mode) given the same injected uniforms: z equal on every
    slot, N_kw and the n_dk table equal, no token on a dead topic."""
    cfg = LDAConfig(scheme="ppu_hdplda", topics=10, alpha=2.0, beta=0.01,
                    seed=3, exec_time=-1, token_block=512, device="cpu")
    model = create_model(cfg).add_instances(corpus)
    assert model._mode == layout
    rng = np.random.default_rng(5)
    live = np.array([0, 2, 5, 7])
    model.set_z_indicators(rng.choice(live, corpus.num_tokens))
    st = model.state
    psi = np.zeros(10, np.float32)
    psi[live] = rng.dirichlet(np.ones(4))
    alpha = torch.as_tensor(np.float32(2.0) * psi)
    phi = torch.zeros((10, corpus.num_types))
    phi[live] = hdp.rnd.polya_urn_dirichlet(st.nkw[live], 0.01, _gen(6))[0]
    # the exact zeros of Polya-Urn rows at a real corpus's rare words
    phi[live] *= torch.as_tensor(rng.random((4, corpus.num_types)) > 0.3)
    doc_mask = torch.arange(corpus.num_docs) % 4 != 0
    table = model._ndk_table(st.ndk, alpha, doc_mask)
    u24 = torch.as_tensor(rng.integers(0, 2 ** 24, tuple(st.z.shape)),
                          dtype=torch.int32)
    fn, args, kw = model._sweep_call(st.z, table, phi.T.contiguous(),
                                     torch.tensor([9]), u24)
    assert kw["positive_support"] is False
    z_p, nkw_p, table_p = (t.numpy() for t in fn(*args, **kw))

    a = [jnp.asarray(t.numpy()) for t in args]
    common = dict(nwin_w=kw["nwin_w"], nwin_d=kw["nwin_d"],
                  vspan=kw["vspan"], dspan=kw["dspan"], num_topics=10,
                  positive_support=False,
                  interpret=jax.default_backend() != "tpu")
    seed = jnp.asarray([9], jnp.int32)
    if layout == "resident":
        out = jax_sweep(*a[:5], seed, *a[6:9], a[11], None, None, **common)
    else:
        out = jax_sweep_streamed(*a[:5], seed, *a[6:8], a[10], None, None,
                                 **common)
    z_j, nkw_j, table_j = (np.asarray(t) for t in out)
    assert np.array_equal(z_p, z_j)
    assert np.array_equal(nkw_p, nkw_j)
    assert np.array_equal(table_p, table_j)
    real = model._slot_mask.numpy()
    sel = real & doc_mask.numpy()[model._slot_d.numpy()]
    assert (z_p[sel] != st.z.numpy()[sel]).any()
    assert np.isin(z_p[real], live).all()
    ndk = np.rint(table_p[:10, :corpus.num_docs].T
                  - alpha.numpy()[None, :]).astype(np.int64)
    zc = np.zeros(corpus.num_tokens, np.int64)
    zc[model._flat_index[model._flat_index >= 0]] = \
        z_p.reshape(-1)[model._flat_index >= 0]
    ref = np.zeros((corpus.num_docs, 10), np.int64)
    np.add.at(ref, (corpus.token_doc_ids(), zc), 1)
    assert np.array_equal(ndk, ref)


# ---------------------------------------------------------------------------
# scheme dynamics: tests/test_hdp.py:91-152 and test_e2e_samplers.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("psi_sampler", ["gem", "poisson"])
def test_hdplda_trajectory_grows_and_stabilises(psi_sampler, corpus):
    """ppu_hdplda grows from one start topic to cover the 3 planted ones
    and stabilises, under both psi samplers."""
    model = _run_hdp("ppu_hdplda", corpus, iterations=60, alpha=5.0,
                     hdp_gamma=5.0, hdp_psi_sampler=psi_sampler)
    hist = model.get_active_topic_history()
    assert len(hist) == 60 and hist[-1] >= 3, hist[-5:]
    assert int((model.get_tokens_per_topic() > 0).sum()) >= 3
    tail = hist[-15:]
    assert max(tail) - min(tail) <= 5, tail
    _assert_counts_exact(model, corpus)


def test_hdplda_contracts_from_full_start(corpus):
    """Topic death: from all 10 topics active the active count drifts down
    towards the data's support."""
    hist = _run_hdp("ppu_hdplda", corpus, iterations=60,
                    hdp_start_topics=10).get_active_topic_history()
    assert 3 <= hist[-1] < 10


@pytest.mark.parametrize("scheme", ["ppu_hdplda", "ppu_hlda"])
def test_active_mask_consistency(corpus, scheme):
    """Inactive topics carry zero prior mass, zero phi rows and no token;
    topics with tokens stay active."""
    model = _run_hdp(scheme, corpus, iterations=15)
    st = model.state
    active = model.get_active_mask()
    assert (model.get_alpha()[~active] == 0).all()
    assert (model.get_phi()[~active] == 0).all()
    nk = model.get_tokens_per_topic()
    assert active[nk > 0].all() and (nk[~active] == 0).all()
    assert st.theta is None and tuple(st.psi.shape) == (10,)


def test_hlda_births_take_lowest_inactive_indices(corpus):
    """ppu_hlda grows contiguously: with start 1 it reaches the 3 planted
    topics, and every iteration's births are the lowest inactive slots."""
    model = _run_hdp("ppu_hlda", corpus, iterations=60, alpha=5.0,
                     hdp_gamma=5.0)
    assert model.get_active_mask().sum() >= 3
    assert model.get_active_topic_history()[-1] >= 3
    st = model.state
    before = st.active & (st.nk > 0)
    active, births = model._update_active(st, st.nk)
    born = torch.nonzero(births).flatten()
    free = torch.nonzero(~before).flatten()
    assert torch.equal(born, free[:born.numel()])
    assert torch.equal(active, before | births.bool())


def test_all_topics_activates_topics_and_k_percentile(corpus):
    """tests/test_e2e_samplers.py::test_hdp_activates_topics and
    ::test_hdp_k_percentile_statistic: the all-topics scheme grows from one
    start topic to the 3 planted ones, keeps every topic active, and
    records calc_k every iteration."""
    model = _run_hdp("ppu_hdplda_all_topics", corpus, iterations=40)
    hist = model.get_active_topic_history()
    assert hist[0] >= 1 and 3 <= hist[-1] <= 10, hist[-5:]
    assert model.get_active_mask().all()
    kp = model.get_k_percentile_history()
    assert len(kp) == 40 and all(0 <= k <= 10 for k in kp)
    assert kp[-1] == hdp.calc_k(0.8, model.get_tokens_per_topic())
    assert model.get_topic_occurrence_count().max() <= 40


@pytest.mark.parametrize("scheme", ["nzvsspalias", "spalias_priors",
                                    *HDP_SCHEMES])
def test_extended_scheme_runs(corpus, scheme):
    """tests/test_e2e_samplers.py::test_extended_scheme_runs for this
    slice's schemes: 8 iterations at K=3 keep exact counts."""
    cfg = LDAConfig(scheme=scheme, topics=3, alpha=1.0, beta=0.01,
                    iterations=8, seed=7, exec_time=-1, topic_interval=8,
                    token_block=512, device="cpu")
    model = create_model(cfg).add_instances(corpus)
    model.sample(8)
    assert model.state.iteration == 8
    _assert_counts_exact(model, corpus)
    z = model.get_z_indicators()
    assert z.min() >= 0 and z.max() < 3
    assert np.isfinite(model.model_log_likelihood())


# ---------------------------------------------------------------------------
# chains against the JAX package
# ---------------------------------------------------------------------------

def _ll_active(ndk, nkw, alpha, beta):
    """The JAX likelihood on the alpha_k > 0 columns."""
    keep = np.asarray(alpha) > 0
    return float(jax_ll.model_log_likelihood(
        np.asarray(ndk)[:, keep], np.asarray(nkw)[keep],
        np.asarray(alpha)[keep], float(beta)))


@pytest.mark.parametrize("scheme", ["ppu_hdplda_all_topics", "ppu_hdplda"])
def test_ll_within_jax_seed_spread(corpus, scheme):
    """The port's model LL at iteration 40 (the median of 10 port chains)
    lies within the range of 10 JAX chains, widened by 3 standard
    deviations (ten, as in tests/test_torch_nzvs.py): the all-topics scheme by the JAX package's own LL, the
    dynamic one by the JAX LL on its active (alpha_k > 0) topics, since
    the JAX LL of such a state is NaN."""
    iters = 40
    kw = dict(topics=10, alpha=1.0, beta=0.01, exec_time=-1,
              hdp_start_topics=1, hdp_gamma=1.0)
    jm = jax_create_model(JaxConfig(scheme=scheme, seed=7,
                                    topic_interval=iters, **kw))
    jc = _jax_corpus(corpus)
    finals = []
    for seed in range(10):
        jm._ll_history = []
        jm.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        jm.sample(iters)
        st = jm.state
        # no token on an inactive topic (the JAX CPU sweep can put one
        # there: test_zero_total_token_keeps_z_where_the_jax_xla_sweep_
        # moves_it), so the active columns hold every token
        assert (np.asarray(st.nk)[~np.asarray(st.active)] == 0).all()
        finals.append(_ll_active(st.ndk, jm._nkw_kv(), st.alpha, st.beta))
    lls = []
    for seed in range(10):
        port = create_model(LDAConfig(scheme=scheme, seed=seed,
                                      device="cpu", **kw))
        port.add_instances(corpus).sample(iters)
        lls.append(port.model_log_likelihood())
    ll_ = float(np.median(lls))
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll_ <= hi + 3 * sd, (ll_, finals)


def test_zero_total_token_keeps_z_where_the_jax_xla_sweep_moves_it():
    """A token whose conditional is 0 on every topic (its word's phi
    column is 0 wherever alpha_k + n_dk > 0, as Polya-Urn rows make it for
    rare words) keeps its z in the port's sweep, as the kernels' contract
    and the JAX Pallas kernel keep it. The JAX package's off-TPU XLA sweep
    (ops/kernels.py::doc_sequential_sweep, which its HDP chains run on the
    CPU) clamps it to topic K - 1 instead, even where that topic is
    inactive (alpha 0, phi row 0): so its CPU HDP chains are held to the
    port only on corpora without such tokens (the planted corpus here)."""
    from ldagroupedgibbssampler_tpu.ops.kernels import doc_sequential_sweep
    c = Corpus.from_token_lists([[0, 1, 1, 0]], ["a", "b"])
    cfg = LDAConfig(scheme="ppu_hdplda", topics=4, alpha=1.0, beta=0.01,
                    seed=1, exec_time=-1, device="cpu")
    model = create_model(cfg).add_instances(c)
    model.set_z_indicators(np.zeros(4, np.int32))
    alpha = torch.tensor([1.0, 0.0, 0.0, 0.0])
    phi = torch.zeros((4, 2))
    phi[0, 1] = 1.0                             # word "a": column all 0
    z, ndk, _ = model._fused_zsweep(model.state.z, model.state.ndk, alpha,
                                    phi.T.contiguous(), None)
    zc = np.zeros(4, np.int32)
    zc[model._flat_index[model._flat_index >= 0]] = \
        z.numpy().reshape(-1)[model._flat_index >= 0]
    assert zc.tolist() == [0, 0, 0, 0]
    _, z_jax = doc_sequential_sweep(
        jax.random.key(0), jnp.asarray([[0, 1, 1, 0]]),
        jnp.ones((1, 4), bool), jnp.zeros((1, 4), jnp.int32),
        jnp.asarray([[4, 0, 0, 0]], jnp.int32), jnp.asarray(phi.T.numpy()),
        jnp.asarray(alpha.numpy()), jnp.ones((1,), bool))
    assert np.asarray(z_jax).tolist() == [[3, 0, 0, 3]]


def test_likelihood_drops_inactive_topics_where_jax_gives_nan(corpus):
    """The JAX package's LL of a ppu_hdplda state (K=10, alpha 1, seed 7,
    5 iterations) is NaN: inactive topics have alpha_k = 0 and
    lgamma(0) - lgamma(0) is inf - inf. The port's LL of the same state is
    the JAX LL on the alpha_k > 0 columns (rtol 1e-5); a state with
    alpha_k = 0 on a topic that holds tokens stays non-finite."""
    jm = jax_create_model(JaxConfig(scheme="ppu_hdplda", topics=10,
                                    alpha=1.0, beta=0.01, seed=7,
                                    exec_time=-1, topic_interval=5))
    jm.add_instances(_jax_corpus(corpus))
    jm.sample(5)
    st = jm.state
    alpha, nkw = np.array(st.alpha), np.array(jm._nkw_kv())
    ndk = np.array(st.ndk)
    assert (alpha == 0).any() and (nkw.sum(axis=1)[alpha == 0] == 0).all()
    assert np.isnan(jm.get_log_likelihoods()[-1][1])
    ours = float(ll.model_log_likelihood(torch.as_tensor(ndk),
                                         torch.as_tensor(nkw),
                                         torch.as_tensor(alpha),
                                         float(st.beta)))
    assert np.isfinite(ours)
    assert ours == pytest.approx(_ll_active(ndk, nkw, alpha, st.beta),
                                 rel=1e-5)
    occupied = int(np.argmax(nkw.sum(axis=1)))
    bad = alpha.copy()
    bad[occupied] = 0.0
    assert not np.isfinite(float(ll.model_log_likelihood(
        torch.as_tensor(ndk), torch.as_tensor(nkw), torch.as_tensor(bad),
        float(st.beta))))


def test_checkpoint_port_to_jax_and_back(corpus, tmp_path):
    """A port ppu_hdplda checkpoint (z in corpus order, psi, tables,
    active, no theta) loads into the JAX package with equal state and runs
    on there; a JAX checkpoint loads into the port with equal state and
    runs on with exact counts; a file whose counts disagree with its z
    raises."""
    port = _run_hdp("ppu_hdplda", corpus, iterations=4)
    path = str(tmp_path / "port.npz")
    port.save_checkpoint(path)
    jcfg = JaxConfig(scheme="ppu_hdplda", topics=10, alpha=1.0, beta=0.01,
                     seed=5, exec_time=-1, hdp_start_topics=1,
                     hdp_gamma=1.0)
    jm = jax_create_model(jcfg).add_instances(_jax_corpus(corpus))
    jm.load_checkpoint(path)
    for name in ("psi", "tables", "active", "alpha", "ndk", "nk"):
        assert np.array_equal(np.asarray(getattr(jm.state, name)),
                              np.asarray(getattr(port.state, name))), name
    assert np.array_equal(jm.get_z_indicators(), port.get_z_indicators())
    assert np.array_equal(np.asarray(jm._nkw_kv()),
                          port.get_topic_type_counts())
    assert int(jm.state.iteration) == 4
    jm.sample(2)

    path = str(tmp_path / "jax.npz")
    jm.save_checkpoint(path)
    other = create_model(port.config).add_instances(corpus)
    other.load_checkpoint(path)
    assert other.state.iteration == 6
    for name in ("psi", "tables", "active", "alpha", "ndk", "nk"):
        assert np.array_equal(getattr(other.state, name).numpy(),
                              np.asarray(getattr(jm.state, name))), name
    assert np.array_equal(other.get_z_indicators(), jm.get_z_indicators())
    assert np.array_equal(other.get_phi(), np.asarray(jm.get_phi()))
    other.sample(2)
    _assert_counts_exact(other, corpus)
    assert (other.get_tokens_per_topic()[~other.get_active_mask()] == 0).all()

    with np.load(path) as d:
        arrays = dict(d)
    arrays["ndk"] = arrays["ndk"].copy()
    arrays["ndk"][0, 0] += 1
    with pytest.raises(ValueError, match="ndk"):
        other.state_from_numpy(arrays)


def _zipf_corpus(num_docs, num_types, seed=0):
    """bench.py's synthetic recipe at a small size: Poisson(120) lengths,
    Zipf(1.1) types."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(5, rng.poisson(120, num_docs))
    probs = 1.0 / np.arange(1, num_types + 1) ** 1.1
    tokens = rng.choice(num_types, size=int(lengths.sum()),
                        p=probs / probs.sum()).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return Corpus(tokens=tokens, doc_offsets=offsets,
                  vocab=[f"w{i}" for i in range(num_types)])


@pytest.mark.slow
def test_hdplda_ll_falls_while_topics_are_born_as_in_the_jax_kernel_chain():
    """On a Zipf corpus (100 documents, V=3,000; K_max=100, alpha 0.5, one
    start topic, as chip_smoke.py runs 20NG) the likelihood of a
    ppu_hdplda chain falls over its first 12 iterations while topics are
    born, in the JAX package's chain with its Pallas sweep interpreted
    (the TPU path, uniforms injected) as in the port's: a born topic's
    alpha_k = alpha0 psi_k is of order 1e-3, and each document it enters
    costs about log alpha_k. Both keep every token on an active topic and
    end with 2-10 active topics. The LL trajectories are printed."""
    c = _zipf_corpus(100, 3000)
    kw = dict(scheme="ppu_hdplda", topics=100, alpha=0.5, beta=0.01,
              exec_time=-1, hdp_start_topics=1, hdp_gamma=1.0)
    jm = jax_create_model(JaxConfig(seed=2019, zdraw_kernel="interpret",
                                    **kw))
    jm.add_instances(_jax_corpus(c))
    traj = [_ll_active(jm.state.ndk, jm._nkw_kv(), jm.state.alpha, 0.01)]
    for _ in range(12):
        jm.sample(1)
        st = jm.state
        assert (np.asarray(st.nk)[~np.asarray(st.active)] == 0).all()
        traj.append(_ll_active(st.ndk, jm._nkw_kv(), st.alpha, 0.01))
    active = int(np.asarray(jm.state.active).sum())
    print(f"JAX (interpreted kernel): LL {np.round(traj, 1).tolist()}, "
          f"{active} active topics")
    assert traj[-1] < traj[0] and 2 <= active <= 10
    for seed in (2019, 2020, 2021):
        port = create_model(LDAConfig(seed=seed, topic_interval=1,
                                      device="cpu", **kw)).add_instances(c)
        ll0 = port.model_log_likelihood()
        port.sample(12)
        lls = [ll0] + [v for _, v in port.get_log_likelihoods()]
        hist = port.get_active_topic_history()
        print(f"port seed {seed}: LL {np.round(lls, 1).tolist()}, active "
              f"topics {hist}")
        assert lls[-1] < lls[0] and 2 <= hist[-1] <= 10
        assert (port.get_tokens_per_topic()[~port.get_active_mask()]
                == 0).all()
