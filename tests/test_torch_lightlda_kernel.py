"""The LightLDA MH sweep's plain versions (ops/cuda_lightlda.py) against the
JAX Pallas kernels run in interpret mode with the same injected uniforms,
as tests/test_pallas_lightlda.py::_run_mh runs them (the interpreted
kernels run the true chunk schedule), and the sweep's semantics on the
plain version's Philox path: count semantics, the exact two-step MH
transition distribution and in-sweep n_dk visibility; the pre-pass's plain
version and the word proposal drawn from its table; the document order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from ldagroupedgibbssampler_tpu.ops.pallas_lightlda import (
    fused_lightlda_sweep as jax_sweep,
    fused_lightlda_sweep_streamed as jax_sweep_streamed)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import (
    Corpus, build_stream_blocks_seq, doc_visit_order, longest_first)
from ldagroupedgibbssampler_tpu_torch.ops import cuda_lightlda
from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import (
    FLAG_ROWS, cdf_draw, kpad_of)
from ldagroupedgibbssampler_tpu_torch.ops.philox import (
    philox_u24, philox_u24x4)

# z may differ from the interpreted kernel only where a cdf summed in
# another order crosses u (a float tie), and on the later tokens of that
# document: at most 0.1% of tokens
MAX_DISAGREE = 0.001


def _rand_corpus(seed=0, docs=70, vocab=300, max_len=60):
    rng = np.random.default_rng(seed)
    toks = [list(rng.integers(0, vocab, rng.integers(3, max_len)))
            for _ in range(docs)]
    return Corpus.from_token_lists(toks, [f"w{i}" for i in range(vocab)])


class Case:
    """One MH sweep's operands, made with numpy from a seed, in the layout
    both packages take (resident `cell_blocks_seq` or streamed
    `build_stream_blocks_seq`, 512-token blocks, 128-wide spans), with four
    injected uniforms per slot in the JAX layout [NB, 4 * chunks, chunk]."""

    def __init__(self, c, K, z_flat, doc_mask, tw, qw, alpha, streamed,
                 seed=123):
        if streamed:
            b = build_stream_blocks_seq(c.tokens, c.token_doc_ids(),
                                        c.num_types, c.num_docs, block=512)
            self.d_local = b.d_local
        else:
            b = c.cell_blocks_seq(block=512)
            self.d_local = b.d_local_a
        self.c, self.b, self.K, self.streamed = c, b, K, streamed
        self.alpha, self.doc_mask, self.tw, self.qw = alpha, doc_mask, tw, qw
        nb = b.w_local.shape[0]
        self.sh3 = (nb, b.w_local.shape[1] // b.chunk, b.chunk)
        self.fi3 = b.flat_index.reshape(self.sh3)
        self.z_flat = z_flat
        self.z_old = np.zeros(self.sh3, np.int32)
        real = self.fi3 >= 0
        self.z_old[real] = z_flat[self.fi3[real]]
        ndk = np.zeros((c.num_docs, K), np.int64)
        np.add.at(ndk, (c.token_doc_ids(), z_flat), 1)
        self.kpad = kpad_of(K)
        self.table = np.zeros((self.kpad + FLAG_ROWS, b.nwin_d * 128),
                              np.float32)
        self.table[:K, :c.num_docs] = (ndk + alpha).T
        self.table[self.kpad, :c.num_docs] = doc_mask
        self.seed = seed
        nb, chunks, chunk = self.sh3
        self.u24 = np.random.default_rng(seed).integers(
            0, 2 ** 24, (nb, 4 * chunks, chunk), dtype=np.int64
        ).astype(np.int32)
        self.visit = doc_visit_order(self.d_local, b.win_d_chunks,
                                     dspan=128, chunk=128,
                                     num_docs=c.num_docs)

    def flat(self, z3):
        out = np.zeros(self.c.num_tokens, np.int32)
        real = self.fi3 >= 0
        out[self.fi3[real]] = np.asarray(z3)[real]
        return out

    def port(self, inject=True, fn=None):
        t = torch.as_tensor
        b = self.b
        ops = (t(b.w_local.reshape(self.sh3)),
               t(self.d_local.reshape(self.sh3)), t(self.z_old),
               t(self.table), t(self.tw), t(self.qw),
               torch.tensor([self.seed], dtype=torch.int64))
        if self.streamed:
            fn = fn or cuda_lightlda.fused_lightlda_sweep_streamed
            ops += (t(b.win_w_chunks), t(b.win_d_chunks))
        else:
            fn = fn or cuda_lightlda.fused_lightlda_sweep
            ops += (t(b.win_w), t(b.first_w), t(b.win_d_chunks))
        ops += (t(self.visit[0]), t(self.visit[1]),
                t(self.u24) if inject else None)
        kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=128, dspan=128,
                  num_topics=self.K)
        if fn in (cuda_lightlda.fused_lightlda_sweep,
                  cuda_lightlda.fused_lightlda_sweep_streamed):
            kw["doc_order"] = t(longest_first(self.visit[0]))
        z, nkw, table = fn(*ops, **kw)
        return z.numpy(), nkw.numpy(), table.numpy()

    def jax(self):
        b = self.b
        a = jnp.asarray
        common = (a(b.w_local.reshape(self.sh3)),
                  a(self.d_local.reshape(self.sh3)), a(self.z_old),
                  a(self.table), a(self.tw), a(self.qw),
                  a([self.seed], jnp.int32))
        kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=128, dspan=128,
                  num_topics=self.K,
                  interpret=jax.default_backend() != "tpu")
        if self.streamed:
            z, nkw, table = jax_sweep_streamed(
                *common, a(b.win_w_chunks), a(b.win_d_chunks), a(self.u24),
                **kw)
        else:
            z, nkw, table = jax_sweep(
                *common, a(b.win_w), a(b.first_w), a(b.win_d_chunks),
                a(self.u24), **kw)
        return np.asarray(z), np.asarray(nkw), np.asarray(table)

    def check_counts(self, z3, nkw, table):
        """N_kw is the histogram of z, the table a recount of z plus
        alpha, the flag row survives, and padding slots and unselected
        documents keep z."""
        c, K = self.c, self.K
        z = self.flat(z3)
        ref_nkw = np.zeros((c.num_types, K), np.int64)
        np.add.at(ref_nkw, (c.tokens, z), 1)
        assert np.array_equal(nkw[:c.num_types].astype(np.int64), ref_nkw)
        assert not nkw[c.num_types:].any()
        dall = c.token_doc_ids()
        ref_ndk = np.zeros((c.num_docs, K), np.int64)
        np.add.at(ref_ndk, (dall, z), 1)
        got = table[:K, :c.num_docs].T - self.alpha[None, :]
        assert np.array_equal(np.rint(got).astype(np.int64), ref_ndk)
        np.testing.assert_allclose(got, ref_ndk, atol=1e-3)
        assert np.array_equal(table[self.kpad, :c.num_docs], self.doc_mask)
        pads = self.fi3 < 0
        assert np.array_equal(np.asarray(z3)[pads], self.z_old[pads])
        unsel = self.doc_mask[dall] == 0
        assert np.array_equal(z[unsel], self.z_flat[unsel])
        return z


def _case(K, streamed, seed=0):
    """A random corpus with a partial doc mask; phi-like target tables with
    exact zeros (topics 1, 4, 7, ... absent from every row, so both draws'
    last-nonzero clamp matters) and a different proposal table."""
    rng = np.random.default_rng(2000 + K + 7 * streamed)
    c = _rand_corpus(seed)
    V = c.num_types
    alpha = np.full(K, 0.4, np.float32)
    tw = rng.dirichlet(np.full(V, 0.1), K).T.astype(np.float32)
    qw = rng.dirichlet(np.full(V, 0.3), K).T.astype(np.float32)
    zero = np.zeros(K, bool)
    zero[1::3] = True
    zero[0] = False
    tw[:, zero] = 0.0
    qw[:, zero] = 0.0
    z_flat = rng.choice(np.flatnonzero(~zero), c.num_tokens).astype(np.int32)
    doc_mask = np.ones(c.num_docs, np.float32)
    doc_mask[::4] = 0.0
    return Case(c, K, z_flat, doc_mask, tw, qw, alpha, streamed)


@pytest.mark.parametrize("K", [5, 100, 130])
@pytest.mark.parametrize("streamed", [False, True])
def test_plain_version_matches_interpreted_kernel(K, streamed):
    case = _case(K, streamed)
    z_p, nkw_p, table_p = case.port()
    z_j, nkw_j, table_j = case.jax()
    zp, zj = case.flat(z_p), case.flat(z_j)
    disagree = int((zp != zj).sum())
    print(f"K={K} streamed={streamed}: {disagree} of {case.c.num_tokens} "
          "tokens disagree")
    assert disagree <= MAX_DISAGREE * case.c.num_tokens
    z = case.check_counts(z_p, nkw_p, table_p)
    case.check_counts(z_j, nkw_j, table_j)
    support = case.tw.sum(axis=0) > 0
    assert support[z].all()                # the last-nonzero clamps
    # the documents whose tokens all agree have bit-equal table columns
    dall = case.c.token_doc_ids()
    same = np.ones(case.c.num_docs, bool)
    same[dall[zp != zj]] = False
    assert np.array_equal(table_p[:, :case.c.num_docs][:, same],
                          table_j[:, :case.c.num_docs][:, same])
    moved = case.doc_mask[dall] > 0
    assert (zp[moved] != case.z_flat[moved]).any()


def _boundary_words(threshold, wide=1000, fine=16):
    """24-bit uniforms around an acceptance threshold: `wide` values over
    +-0.5% of it and every value within `fine` steps of it."""
    t = int(threshold * 2 ** 24)
    near = np.arange(t - fine, t + fine + 1)
    spread = np.linspace(t * 0.995, t * 1.005, wide).astype(np.int64)
    return np.concatenate([near, spread])


@pytest.mark.parametrize("streamed", [False, True])
def test_acceptance_boundaries_match_interpreted_kernel(streamed):
    """Both MH acceptance tests at their boundaries, against the
    interpreted Pallas kernel. One-token documents of one type at z = 0
    with K = 2 and non-bf16-exact alpha and tables; the draws are pinned
    (word and doc proposal both topic 1), and the accept uniform sweeps
    the threshold: step 1 in group A (step 2 then keeps z1), step 2 in
    group B (step 1 rejects). Every token must agree exactly, which holds
    only with the same f32 association, bf16 rounding and the bf16(nd)
    doc-proposal correction; each group must see both outcomes."""
    alpha = np.array([0.3, 0.7], np.float32)
    tw = np.array([[0.4, 0.2]], np.float32)
    qw = np.array([[0.3, 0.5]], np.float32)
    nd = np.array([np.float32(1.0) + alpha[0] - np.float32(1.0), alpha[1]],
                  np.float64)
    twq, qwq, ndq = _bf16_np(tw)[0], _bf16_np(qw)[0], _bf16_np(nd)
    t1 = (nd[1] * twq[1] * qwq[0]) / (nd[0] * twq[0] * qwq[1])
    t2 = (nd[1] * twq[1] * ndq[0]) / (nd[0] * twq[0] * ndq[1])
    assert t1 < 1 and t2 < 1
    top = 2 ** 24 - 1
    group_a = _boundary_words(t1)
    group_b = _boundary_words(t2)
    words = np.concatenate([
        np.stack([np.full_like(group_a, top), group_a,
                  np.full_like(group_a, top), np.full_like(group_a, top)], 1),
        np.stack([np.full_like(group_b, top), np.full_like(group_b, top),
                  np.full_like(group_b, top), group_b], 1)])
    D = len(words)
    c = Corpus.from_token_lists([[0]] * D, ["w0"])
    case = Case(c, 2, np.zeros(D, np.int32), np.ones(D, np.float32), tw, qw,
                alpha, streamed)
    nb, chunks, chunk = case.sh3
    per_slot = np.zeros((nb * chunks * chunk, 4), np.int64)
    fi = case.fi3.reshape(-1)
    per_slot[fi >= 0] = words[fi[fi >= 0]]
    case.u24 = (per_slot.reshape(nb, chunks, chunk, 4).transpose(0, 1, 3, 2)
                .reshape(nb, 4 * chunks, chunk).astype(np.int32))
    zp = case.flat(case.port()[0])
    zj = case.flat(case.jax()[0])
    assert np.array_equal(zp, zj), np.flatnonzero(zp != zj)
    for g in (zp[:len(group_a)], zp[len(group_a):]):
        assert 0 < g.sum() < len(g)


@pytest.mark.parametrize("streamed", [False, True])
def test_mh_count_semantics(streamed):
    """tests/test_pallas_lightlda.py::test_mh_count_semantics on the plain
    version's Philox path: unselected documents keep z, selected ones
    move, N_kw and the table are exact recounts. The Philox path is the
    injected path fed the kernel's four Philox words per slot in the JAX
    layout."""
    rng = np.random.default_rng(1)
    c = Corpus.from_token_lists(
        [list(rng.integers(0, 300, rng.integers(3, 60)))
         for _ in range(70)], [f"w{i}" for i in range(300)])
    K, V = 7, 300
    alpha = np.full(K, 0.4, np.float32)
    z_flat = rng.integers(0, K, c.num_tokens).astype(np.int32)
    doc_mask = np.ones(c.num_docs, np.float32)
    doc_mask[::3] = 0.0
    phi = rng.dirichlet(np.full(V, 0.1), K).T.astype(np.float32)  # [V, K]
    case = Case(c, K, z_flat, doc_mask, phi, phi, alpha, streamed)
    z3, nkw, table = case.port(inject=False)
    z = case.check_counts(z3, nkw, table)
    sel = doc_mask[c.token_doc_ids()] > 0
    assert (z[sel] != z_flat[sel]).any()
    nb, chunks, chunk = case.sh3
    words = philox_u24x4(torch.tensor([case.seed]), nb * chunks * chunk)
    case.u24 = (words.numpy().reshape(nb, chunks, chunk, 4)
                .transpose(0, 1, 3, 2).reshape(nb, 4 * chunks, chunk))
    z3_inj, nkw_inj, table_inj = case.port(inject=True)
    assert np.array_equal(z3_inj, z3)
    assert np.array_equal(nkw_inj, nkw)
    assert np.array_equal(table_inj, table)


def _mh_oracle(z0, nd, tw_w, qw_w):
    """tests/test_pallas_lightlda.py::_mh_oracle: the exact distribution of
    z2 after one two-step MH transition from z0 with fixed nd (=
    n^{-i}+alpha), word target column tw_w and proposal column qw_w,
    enumerating all (k1, accept, k2, accept) paths. The doc proposal draws
    from ndq = bf16(nd) and its acceptance uses ndq for the proposal ratio
    and nd for the target, as the kernel does."""
    K = len(nd)
    ndq = torch.tensor(nd, dtype=torch.float32).to(torch.bfloat16).double()
    ndq = ndq.numpy()
    q1 = qw_w / qw_w.sum()
    qd = ndq / ndq.sum()
    p1 = np.zeros(K)  # distribution of z1
    for k1 in range(K):
        a1 = min(1.0, (nd[k1] * tw_w[k1] * qw_w[z0])
                 / (nd[z0] * tw_w[z0] * qw_w[k1]))
        p1[k1] += q1[k1] * a1
        p1[z0] += q1[k1] * (1 - a1)
    p2 = np.zeros(K)
    for z1 in range(K):
        if p1[z1] == 0:
            continue
        for k2 in range(K):
            a2 = min(1.0, (nd[k2] * tw_w[k2] * ndq[z1])
                     / (nd[z1] * tw_w[z1] * ndq[k2]))
            p2[k2] += p1[z1] * qd[k2] * a2
            p2[z1] += p1[z1] * qd[k2] * (1 - a2)
    return p2


def _bf16_np(x):
    return torch.tensor(x).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("alpha_row", [
    [0.5, 1.0, 2.0, 0.25, 1.25],   # bf16-exact alphas (ndq == nd)
    [0.1, 0.3, 0.7, 0.11, 0.23],   # non-bf16-exact: exercises the
                                   # quantised doc-proposal correction
])
def test_mh_transition_distribution(alpha_row, streamed):
    """tests/test_pallas_lightlda.py::test_mh_transition_distribution on
    the Philox path: chi-square of one sweep's draws for single-token
    documents against the exactly enumerated two-step MH transition
    (bf16-quantised tables, as the kernel uses)."""
    D, K = 8000, 5
    c = Corpus.from_token_lists([[0]] * D, ["w0", "w1"])
    alpha = np.array(alpha_row, np.float32)
    tw = np.array([[0.5, 0.1, 0.3, 0.05, 0.05],
                   [0.1, 0.4, 0.1, 0.2, 0.2]], np.float32)   # [V=2, K]
    qw = np.array([[0.2, 0.3, 0.1, 0.25, 0.15],
                   [0.3, 0.1, 0.2, 0.2, 0.2]], np.float32)
    # single token, z0=0: after the own-count decrement nd = alpha
    p = _mh_oracle(0, alpha.astype(np.float64), _bf16_np(tw)[0],
                   _bf16_np(qw)[0])
    case = Case(c, K, np.zeros(D, np.int32), np.ones(D, np.float32), tw, qw,
                alpha, streamed, seed=33)
    z_out = case.flat(case.port(inject=False)[0])
    obs = np.bincount(z_out, minlength=K).astype(np.float64)
    chi2 = float(((obs - p * D) ** 2 / (p * D)).sum())
    assert sps.chi2.sf(chi2, K - 1) > 1e-4, (obs, p * D)


@pytest.mark.parametrize("streamed", [False, True])
def test_mh_sequential_concentration(streamed):
    """tests/test_pallas_lightlda.py::test_mh_sequential_concentration on
    the Philox path: with uniform word terms and tiny alpha the doc
    proposal must concentrate each document onto few topics, which only
    happens if the n_dk updates apply within the sweep."""
    rng = np.random.default_rng(3)
    D, L, K, V = 40, 40, 8, 50
    c = Corpus.from_token_lists(
        [list(rng.integers(0, V, L)) for _ in range(D)],
        [f"w{i}" for i in range(V)])
    alpha = np.full(K, 1e-4, np.float32)
    uni = np.full((V, K), 1.0 / V, np.float32)
    case = Case(c, K, np.zeros(c.num_tokens, np.int32),
                np.ones(D, np.float32), uni, uni, alpha, streamed, seed=17)
    z_out = case.flat(case.port(inject=False)[0])
    dall = c.token_doc_ids()
    shares = [np.bincount(z_out[dall == d], minlength=K).max() / L
              for d in range(D)]
    assert np.mean(shares) >= 0.6, np.mean(shares)


def test_philox_u24x4_word0_is_philox_u24():
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64)
    four = philox_u24x4(seed, 1000)
    assert four.shape == (1000, 4) and four.dtype == torch.int32
    assert torch.equal(four[:, 0], philox_u24(seed, 1000))
    assert int(four.min()) >= 0 and int(four.max()) < 2 ** 24
    # the four words are distinct streams
    assert len({tuple(four[:, j].tolist()) for j in range(4)}) == 4


@pytest.mark.parametrize("streamed", [False, True])
def test_wrapper_takes_plain_version_on_cpu(streamed):
    case = _case(6, streamed, seed=2)
    ref = (cuda_lightlda.fused_lightlda_sweep_streamed_reference if streamed
           else cuda_lightlda.fused_lightlda_sweep_reference)
    for a, r in zip(case.port(), case.port(fn=ref)):
        assert np.array_equal(a, r)
    assert cuda_lightlda.fused_lightlda_sweep.launches == 0
    assert cuda_lightlda.fused_lightlda_sweep_streamed.launches == 0


def _qw_rows(K, seed=5):
    """bf16-rounded proposal rows with exact zeros: row 0 all zero, row 1
    zero over its last topics, the rest with scattered zeros."""
    rng = np.random.default_rng(seed + K)
    qw = rng.gamma(0.5, 1.0, (12, K)).astype(np.float32)
    qw[rng.random((12, K)) < 0.3] = 0.0
    qw[0] = 0.0
    qw[1, K // 2:] = 0.0
    qw[1, 0] = max(qw[1, 0], 0.5)
    return _bf16_np(qw).astype(np.float32)


@pytest.mark.parametrize("K", [5, 100, 130, 200])
def test_word_cdf_table_reference(K):
    """The MH pre-pass's plain version: per row the f32 prefix sums inside
    128-topic tiles padded with zeros to kpad, the total as the tile
    totals summed in tile order, and the last topic with qw > 0 (-1 for an
    all-zero row), against a float64 recount."""
    qw = _qw_rows(K)
    kpad = kpad_of(K)
    cdf, total, lastnz = cuda_lightlda.word_cdf_table_reference(
        torch.as_tensor(qw), kpad)
    assert cdf.shape == (12, kpad) and cdf.dtype == torch.float32
    padded = np.zeros((12, kpad))
    padded[:, :K] = qw
    ref = padded.reshape(12, kpad // 128, 128).cumsum(axis=2)
    np.testing.assert_allclose(cdf.numpy().reshape(ref.shape), ref,
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(total.numpy(), qw.sum(axis=1, dtype=np.float64),
                               rtol=1e-6, atol=0)
    want = [max(np.flatnonzero(r), default=-1) for r in qw]
    assert lastnz.tolist() == want
    assert want[0] == -1 and want[1] < K // 2
    assert float(total[0]) == 0.0
    # the cdf does not decrease inside a tile, as the kernel's search needs
    assert (np.diff(cdf.numpy().reshape(ref.shape), axis=2) >= 0).all()


@pytest.mark.parametrize("K", [5, 100, 130, 200])
def test_tabled_draw_equals_cdf_draw(K):
    """The word proposal drawn from the pre-pass's table (an upper-bound
    search per tile, clamped to the last nonzero topic; 0 for an all-zero
    row) equals `cuda_pcgs.cdf_draw` over the same rows and uniforms for
    every token, uniforms at both ends of [0, 2^24) included."""
    qw = torch.as_tensor(_qw_rows(K))
    kpad = kpad_of(K)
    rng = np.random.default_rng(K)
    rows = torch.as_tensor(rng.integers(0, 12, 4000))
    u24 = torch.as_tensor(np.concatenate([
        rng.integers(0, 2 ** 24, 3998), [0, 2 ** 24 - 1]]).astype(np.int32))
    table = cuda_lightlda.word_cdf_table_reference(qw, kpad)
    k, tot = cuda_lightlda.tabled_draw_reference(*table, rows, u24)
    k_ref, tot_ref = cdf_draw(qw[rows], u24, kpad)
    assert torch.equal(tot, tot_ref)
    assert torch.equal(k, k_ref)
    assert (k[rows == 0] == 0).all()
    assert (k[rows == 1] < K // 2).all()
    live = tot > 0
    assert (qw[rows[live], k[live]] > 0).all()


def test_word_cdf_table_wrapper_takes_plain_version_on_cpu():
    qw = torch.as_tensor(_qw_rows(100))
    got = cuda_lightlda.word_cdf_table(qw.to(torch.bfloat16), 128)
    ref = cuda_lightlda.word_cdf_table_reference(qw, 128)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("streamed", [False, True])
def test_longest_first(streamed):
    """The document order the model hands the MH kernel: int32, a
    permutation of the documents, lengths not increasing, ties in index
    order. (That no draw depends on it is checked on the card, where the
    kernel runs it: chip_smoke.py `[3 lightlda]`.)"""
    case = _case(7, streamed, seed=4)
    offsets = case.visit[0]
    order = longest_first(offsets)
    lengths = np.diff(offsets)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(case.c.num_docs))
    assert (np.diff(lengths[order]) <= 0).all()
    tie = lengths[order][1:] == lengths[order][:-1]
    assert (order[1:][tie] > order[:-1][tie]).all()
    assert lengths[order[0]] == lengths.max()
