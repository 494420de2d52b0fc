"""The PCGS sweep's plain versions (ops/cuda_pcgs.py) against the JAX
Pallas kernels run in interpret mode with the same injected uniforms, as
tests/test_pallas_pcgs.py::_run_sweep runs them — the interpreted kernels
run the true chunk schedule, so this checks the port's per-document order
independently of the argument that documents are independent given phi —
and the sweep's semantics on the plain version's Philox path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from ldagroupedgibbssampler_tpu.ops.pallas_pcgs import (
    fused_pcgs_sweep as jax_sweep,
    fused_pcgs_sweep_streamed as jax_sweep_streamed)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import (
    Corpus, build_stream_blocks_seq, doc_visit_order)
from ldagroupedgibbssampler_tpu_torch.ops import cuda_pcgs
from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import FLAG_ROWS, kpad_of
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24

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
    """One sweep's operands, made with numpy from a seed, in the layout
    both packages take (resident `cell_blocks_seq` or streamed
    `build_stream_blocks_seq`, 512-token blocks, 128-wide spans)."""

    def __init__(self, c, K, z_flat, doc_mask, phi, alpha, streamed,
                 seed=123):
        if streamed:
            b = build_stream_blocks_seq(c.tokens, c.token_doc_ids(),
                                        c.num_types, c.num_docs, block=512)
            self.d_local, self.win = b.d_local, b.win_w_chunks
        else:
            b = c.cell_blocks_seq(block=512)
            self.d_local, self.win = b.d_local_a, b.win_w
        self.c, self.b, self.K, self.streamed = c, b, K, streamed
        self.alpha, self.doc_mask, self.phi = alpha, doc_mask, phi
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
        self.u24 = np.random.default_rng(seed).integers(
            0, 2 ** 24, self.sh3, dtype=np.int64).astype(np.int32)
        self.visit = doc_visit_order(self.d_local, b.win_d_chunks,
                                     dspan=128, chunk=128,
                                     num_docs=c.num_docs)

    def flat(self, z3):
        out = np.zeros(self.c.num_tokens, np.int32)
        real = self.fi3 >= 0
        out[self.fi3[real]] = np.asarray(z3)[real]
        return out

    def port(self, inject=True, positive_support=False, fn=None):
        t = torch.as_tensor
        b = self.b
        ops = (t(b.w_local.reshape(self.sh3)),
               t(self.d_local.reshape(self.sh3)), t(self.z_old),
               t(self.table), t(self.phi),
               torch.tensor([self.seed], dtype=torch.int64))
        if self.streamed:
            fn = fn or cuda_pcgs.fused_pcgs_sweep_streamed
            ops += (t(b.win_w_chunks), t(b.win_d_chunks))
        else:
            fn = fn or cuda_pcgs.fused_pcgs_sweep
            ops += (t(b.win_w), t(b.first_w), t(b.win_d_chunks))
        ops += (t(self.visit[0]), t(self.visit[1]),
                t(self.u24) if inject else None)
        z, nkw, table = fn(*ops, nwin_w=b.nwin_w, nwin_d=b.nwin_d,
                           vspan=128, dspan=128, num_topics=self.K,
                           positive_support=positive_support)
        return z.numpy(), nkw.numpy(), table.numpy()

    def jax(self, positive_support=False, force_ktile=False):
        b = self.b
        a = jnp.asarray
        common = (a(b.w_local.reshape(self.sh3)),
                  a(self.d_local.reshape(self.sh3)), a(self.z_old),
                  a(self.table), a(self.phi),
                  a([self.seed], jnp.int32))
        kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=128, dspan=128,
                  num_topics=self.K, positive_support=positive_support,
                  interpret=jax.default_backend() != "tpu")
        if self.streamed:
            z, nkw, table = jax_sweep_streamed(
                *common, a(b.win_w_chunks), a(b.win_d_chunks),
                a(self.u24), force_ktile=force_ktile, **kw)
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


def _case(K, streamed, positive_support, seed=0):
    rng = np.random.default_rng(1000 + K + 7 * streamed)
    c = _rand_corpus(seed)
    V = c.num_types
    alpha = np.full(K, 0.4, np.float32)
    phi = rng.dirichlet(np.full(V, 0.1), K).T.astype(np.float32)
    if positive_support:
        z_flat = rng.integers(0, K, c.num_tokens).astype(np.int32)
    else:
        # exact zeros in phi (Polya-Urn-style support): topics 0, 3, 6, ...
        support = np.zeros(K, bool)
        support[::3] = True
        phi[:, ~support] = 0.0
        z_flat = rng.choice(np.flatnonzero(support),
                            c.num_tokens).astype(np.int32)
    doc_mask = np.ones(c.num_docs, np.float32)
    doc_mask[::4] = 0.0
    return Case(c, K, z_flat, doc_mask, phi, alpha, streamed)


@pytest.mark.parametrize("K", [5, 100, 130])
@pytest.mark.parametrize("positive_support", [True, False])
@pytest.mark.parametrize("streamed", [False, True])
def test_plain_version_matches_interpreted_kernel(K, positive_support,
                                                  streamed):
    case = _case(K, streamed, positive_support)
    z_p, nkw_p, table_p = case.port(positive_support=positive_support)
    z_j, nkw_j, table_j = case.jax(positive_support=positive_support)
    zp, zj = case.flat(z_p), case.flat(z_j)
    disagree = int((zp != zj).sum())
    print(f"K={K} streamed={streamed} positive_support={positive_support}:"
          f" {disagree} of {case.c.num_tokens} tokens disagree")
    assert disagree <= MAX_DISAGREE * case.c.num_tokens
    z = case.check_counts(z_p, nkw_p, table_p)
    case.check_counts(z_j, nkw_j, table_j)
    if not positive_support:
        support = case.phi.sum(axis=0) > 0
        assert support[z].all()            # the last-nonzero clamp
    # the documents whose tokens all agree have bit-equal table columns
    dall = case.c.token_doc_ids()
    same = np.ones(case.c.num_docs, bool)
    same[dall[zp != zj]] = False
    assert np.array_equal(table_p[:, :case.c.num_docs][:, same],
                          table_j[:, :case.c.num_docs][:, same])
    moved = case.doc_mask[dall] > 0
    assert (zp[moved] != case.z_flat[moved]).any()


def test_plain_version_matches_ktiled_streamed_kernel():
    """The JAX streamed kernel's K-tiled body (force_ktile) at K=130, two
    topic tiles: it takes its total from a sum of the probs tiles and its
    offsets from the tile cdfs; the port keeps the untiled body's
    arithmetic and must agree all the same."""
    case = _case(130, True, True, seed=4)
    z_p, _, table_p = case.port(positive_support=True)
    z_j, nkw_j, table_j = case.jax(positive_support=True, force_ktile=True)
    zp, zj = case.flat(z_p), case.flat(z_j)
    disagree = int((zp != zj).sum())
    print(f"K-tiled body: {disagree} of {case.c.num_tokens} disagree")
    assert disagree <= MAX_DISAGREE * case.c.num_tokens
    case.check_counts(z_j, nkw_j, table_j)


@pytest.mark.parametrize("streamed", [False, True])
def test_philox_path_count_semantics(streamed):
    """test_fused_sweep_count_semantics (tests/test_pallas_pcgs.py:101) on
    the plain version's Philox path, whose uniforms are the kernel's."""
    rng = np.random.default_rng(1)
    c = _rand_corpus(1)
    K, V = 7, c.num_types
    alpha = np.full(K, 0.4, np.float32)
    z_flat = rng.integers(0, K, c.num_tokens).astype(np.int32)
    doc_mask = np.ones(c.num_docs, np.float32)
    doc_mask[::3] = 0.0
    phi = rng.dirichlet(np.full(V, 0.1), K).T.astype(np.float32)
    case = Case(c, K, z_flat, doc_mask, phi, alpha, streamed)
    z3, nkw, table = case.port(inject=False)
    z = case.check_counts(z3, nkw, table)
    sel = doc_mask[c.token_doc_ids()] > 0
    assert (z[sel] != z_flat[sel]).any()
    # the Philox path is the injected path fed the kernel's Philox words
    case.u24 = philox_u24(torch.tensor([case.seed]),
                          int(np.prod(case.sh3))).numpy().reshape(case.sh3)
    z3_inj, _, table_inj = case.port(inject=True)
    assert np.array_equal(z3_inj, z3)
    assert np.array_equal(table_inj, table)


@pytest.mark.parametrize("K,streamed", [(5, False), (5, True), (200, False)])
def test_philox_draw_distribution(K, streamed):
    """test_fused_sweep_draw_distribution (tests/test_pallas_pcgs.py:131):
    chi-square of single-token documents against the exact conditional
    (n_dk^-i + alpha_k) * phi[k][w] = alpha_k * phi[k][w]; K=200 spans two
    topic tiles."""
    rng = np.random.default_rng(13 + K)
    D = 4000
    c = Corpus.from_token_lists([[0]] * D, ["w0", "w1"])
    alpha = (rng.gamma(1.0, 1.0, K) + 0.05).astype(np.float32)
    phi = np.stack([rng.uniform(0.2, 1.0, K),
                    rng.uniform(0.2, 1.0, K)]).astype(np.float32)
    case = Case(c, K, np.zeros(D, np.int32), np.ones(D, np.float32), phi,
                alpha, streamed, seed=9)
    z, _, _ = case.port(inject=False)
    p = alpha * phi[0]
    p = p / p.sum()
    edges = np.linspace(0, K, min(K, 8) + 1).astype(int)
    obs = np.add.reduceat(np.bincount(case.flat(z), minlength=K),
                          edges[:-1])
    exp = np.add.reduceat(p * D, edges[:-1])
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert sps.chi2.sf(chi2, len(exp) - 1) > 1e-4, (obs, exp)


@pytest.mark.parametrize("streamed", [False, True])
def test_philox_sequential_updates(streamed):
    """test_fused_sweep_sequential_updates (tests/test_pallas_pcgs.py:154):
    with uniform phi and a tiny alpha, each document's tokens pile onto
    the topic its first-drawn token takes, which only happens if the n_dk
    updates apply within the sweep."""
    rng = np.random.default_rng(3)
    D, L, K = 40, 30, 8
    c = Corpus.from_token_lists(
        [list(rng.integers(0, 50, L)) for _ in range(D)],
        [f"w{i}" for i in range(50)])
    case = Case(c, K, np.zeros(c.num_tokens, np.int32),
                np.ones(D, np.float32), np.full((50, K), 1 / 50, np.float32),
                np.full(K, 1e-4, np.float32), streamed, seed=17)
    z = case.flat(case.port(inject=False)[0])
    dall = c.token_doc_ids()
    for d in range(D):
        zs = z[dall == d]
        assert np.bincount(zs, minlength=K).max() / len(zs) >= 0.8, d


@pytest.mark.parametrize("streamed", [False, True])
def test_wrapper_takes_plain_version_on_cpu(streamed):
    case = _case(6, streamed, True, seed=2)
    ref = (cuda_pcgs.fused_pcgs_sweep_streamed_reference if streamed
           else cuda_pcgs.fused_pcgs_sweep_reference)
    for a, r in zip(case.port(), case.port(fn=ref)):
        assert np.array_equal(a, r)
    assert cuda_pcgs.fused_pcgs_sweep.launches == 0
    assert cuda_pcgs.fused_pcgs_sweep_streamed.launches == 0


def test_collapsed_mode_raises():
    case = _case(6, False, True, seed=2)
    with pytest.raises(NotImplementedError, match="ADLDA"):
        case.port(fn=lambda *a, **kw: cuda_pcgs.fused_pcgs_sweep(
            *a, nk_plus=torch.ones(6), beta=0.1, **kw))
