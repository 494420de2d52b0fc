"""The PCGS sweep's plain versions (ops/cuda_pcgs.py) against the JAX
Pallas kernels run in interpret mode with the same injected uniforms, as
tests/test_pallas_pcgs.py::_run_sweep runs them — the interpreted kernels
run the true chunk schedule, so this checks the port's per-document order
independently of the argument that documents are independent given phi —
and the sweep's semantics on the plain version's Philox path.

The collapsed (ADLDA) mode's plain version is the sequential chain. The
interpreted kernels replay it whenever one document is selected (each
chunk then holds at most one drawing token), so that is where the two are
held to each other; its bookkeeping, freshness and draw distribution are
checked on their own."""

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
    Corpus, build_stream_blocks_seq, doc_visit_order, longest_first)
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

    def port(self, inject=True, positive_support=False, fn=None,
             nk_plus=None, beta=None, nk_out=None, doc_order="longest"):
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
        if nk_plus is not None:
            ops += (t(nk_plus), beta)
        kw = {} if nk_out is None else {"nk_out": nk_out}
        if fn in (cuda_pcgs.fused_pcgs_sweep,
                  cuda_pcgs.fused_pcgs_sweep_streamed):
            # the PCGS mode's document order: longest first unless given
            if not isinstance(doc_order, str):
                kw["doc_order"] = doc_order
            elif nk_plus is None:
                kw["doc_order"] = t(longest_first(self.visit[0]))
        z, nkw, table = fn(*ops, nwin_w=b.nwin_w, nwin_d=b.nwin_d,
                           vspan=128, dspan=128, num_topics=self.K,
                           positive_support=positive_support, **kw)
        return z.numpy(), nkw.numpy(), table.numpy()

    def jax(self, positive_support=False, force_ktile=False, nk_plus=None,
            beta=None):
        b = self.b
        a = jnp.asarray
        common = (a(b.w_local.reshape(self.sh3)),
                  a(self.d_local.reshape(self.sh3)), a(self.z_old),
                  a(self.table), a(self.phi),
                  a([self.seed], jnp.int32))
        kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=128, dspan=128,
                  num_topics=self.K, positive_support=positive_support,
                  interpret=jax.default_backend() != "tpu")
        coll = (None if nk_plus is None else a(nk_plus, jnp.float32), beta)
        if self.streamed:
            z, nkw, table = jax_sweep_streamed(
                *common, a(b.win_w_chunks), a(b.win_d_chunks),
                a(self.u24), *coll, force_ktile=force_ktile, **kw)
        else:
            z, nkw, table = jax_sweep(
                *common, a(b.win_w), a(b.first_w), a(b.win_d_chunks),
                a(self.u24), *coll, **kw)
        return np.asarray(z), np.asarray(nkw), np.asarray(table)

    def check_counts(self, z3, nkw, table):
        """N_kw is the histogram of z (unless nkw is None), the table a
        recount of z plus alpha, the flag row survives, and padding slots
        and unselected documents keep z."""
        c, K = self.c, self.K
        z = self.flat(z3)
        if nkw is not None:
            ref_nkw = np.zeros((c.num_types, K), np.int64)
            np.add.at(ref_nkw, (c.tokens, z), 1)
            assert np.array_equal(nkw[:c.num_types].astype(np.int64),
                                  ref_nkw)
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


# ---------------------------------------------------------------------------
# The PCGS mode's kernel at kpad <= 256: its bf16 word table, the
# association of its prefix sums, its document order
# ---------------------------------------------------------------------------

# topics a lane owns in csrc/pcgs.cu's lane-owned kernel (a document's
# 128-topic tile on 16 lanes: at kpad 128 a warp holds two documents)
LANE_TOPICS = 8


@pytest.mark.parametrize("K", [5, 100, 130, 200])
def test_phi_bf16_table_is_rounded_phi_zero_padded(K):
    """The pre-pass's plain version (and the CPU path of the wrapper) is
    bf16(phi) zero-padded to [V, kpad], as the plain sweep rounds phi."""
    rng = np.random.default_rng(K)
    phi = torch.as_tensor(rng.dirichlet(np.full(57, 0.1), K).T
                          .astype(np.float32))
    kpad = kpad_of(K)
    ref = cuda_pcgs.phi_bf16_table_reference(phi, kpad)
    assert ref.dtype == torch.bfloat16 and tuple(ref.shape) == (57, kpad)
    assert torch.equal(ref[:, :K].float(), cuda_pcgs._bf16(phi))
    assert not ref[:, K:].float().any()
    assert torch.equal(cuda_pcgs.phi_bf16_table(phi, kpad), ref)


def _lane_model_draw(p, u24, kpad, per, lastnz):
    """The kernel's draw in its own association, on the host: each of
    kpad / per lanes sums its `per` contiguous topics in order, a
    Hillis-Steele scan of the lane totals runs inside each 128-topic
    segment (128 / per lanes), each lane adds its exclusive offset to its
    prefix sums, the tile totals are summed in tile order, and the count of
    entries <= u - off_t is clamped to `lastnz` (int64 [n]). Returns (k,
    total)."""
    n, K = p.shape
    lanes, seg, tiles = kpad // per, 128 // per, kpad // 128
    x = torch.zeros((n, kpad), dtype=torch.float32)
    x[:, :K] = p
    pre = x.view(n, lanes, per).clone()
    for i in range(1, per):
        pre[:, :, i] = pre[:, :, i - 1] + pre[:, :, i]
    incl = pre[:, :, -1].reshape(n, tiles, seg).clone()
    off = 1
    while off < seg:
        prev = incl.clone()
        incl[:, :, off:] = prev[:, :, off:] + prev[:, :, :-off]
        off *= 2
    excl = torch.zeros_like(incl)
    excl[:, :, 1:] = incl[:, :, :-1]
    cdf = (excl.reshape(n, lanes, 1) + pre).view(n, tiles, 128)
    total = incl[:, 0, -1]
    for t in range(1, tiles):
        total = total + incl[:, t, -1]
    u = u24.to(torch.float32) * (2.0 ** -24) * total
    cnt = torch.zeros(n, dtype=torch.int64)
    tile_off = torch.zeros(n, dtype=torch.float32)
    for t in range(tiles):
        cnt += (cdf[:, t] <= (u - tile_off)[:, None]).sum(dim=1)
        tile_off = incl[:, t, -1] if t == 0 else tile_off + incl[:, t, -1]
    return torch.minimum(cnt, lastnz), total


@pytest.mark.parametrize("K", [5, 100, 130, 200])
@pytest.mark.parametrize("positive_support", [True, False])
def test_lane_association_draws_as_cdf_draw(K, positive_support):
    """The kernel's association of the prefix sums (per-lane sums in
    order, a scan of the lane totals, 128-topic segments) draws the topic
    `cdf_draw` draws on 100,000 seeded rows of bf16 products with exact
    zeros; a row may differ only at a rounding tie (u within f32 rounding
    of an exact boundary), on at most 1e-4 of the rows."""
    rng = np.random.default_rng(7 * K + positive_support)
    kpad = kpad_of(K)
    n = 100_000
    bf = cuda_pcgs._bf16
    nd = torch.as_tensor(rng.poisson(2.0, (n, K)) + 0.5, dtype=torch.float32)
    ph = torch.as_tensor(rng.gamma(0.3, 1.0, (n, K)), dtype=torch.float32)
    zero = torch.as_tensor(rng.random((n, K)) < 0.3)
    if positive_support:
        zero[:] = False
    p = bf(nd * bf(torch.where(zero, 0.0, ph)))
    p[0] = 0.0                                   # a row with total 0
    u24 = torch.as_tensor(rng.integers(0, 2 ** 24, n), dtype=torch.int32)
    topics = torch.arange(K)
    last = (K - 1 if positive_support
            else (topics * (p > 0)).max(dim=1).values)
    z_ref, tot_ref = cuda_pcgs.cdf_draw(p, u24, kpad,
                                        K - 1 if positive_support else None)
    z, tot = _lane_model_draw(p, u24, kpad, LANE_TOPICS,
                              torch.as_tensor(last).expand(n))
    assert torch.equal(tot > 0, tot_ref > 0)
    live = tot_ref > 0
    diff = torch.nonzero(live & (z != z_ref)).flatten()
    print(f"K={K}: {diff.numel()} of {n} rows differ")
    assert diff.numel() <= 1e-4 * n
    cdf64 = p[diff].double().cumsum(dim=1)
    u64 = u24[diff].double() * 2.0 ** -24 * cdf64[:, -1]
    lo = torch.minimum(z[diff], z_ref[diff])
    gap = (cdf64[torch.arange(diff.numel()), lo] - u64).abs()
    assert (gap <= 1e-5 * cdf64[:, -1]).all()
    if not positive_support:                 # never a zero-probability topic
        assert (p[live, z[live]] > 0).all()


@pytest.mark.parametrize("streamed", [False, True])
def test_pcgs_mode_requires_a_document_order(streamed):
    """The PCGS-mode wrappers raise without `doc_order` (or with one of the
    wrong size), and the collapsed mode, which walks the documents in
    index order, refuses one."""
    case = _case(6, streamed, True, seed=3)
    with pytest.raises(ValueError, match="needs doc_order"):
        case.port(doc_order=None)
    with pytest.raises(ValueError, match="doc_order: expected an int32"):
        case.port(doc_order=torch.arange(case.c.num_docs - 1,
                                         dtype=torch.int32))
    ccase, _, nk_plus, beta = _collapsed_case(6, streamed, seed=3)
    fn = (cuda_pcgs.fused_pcgs_sweep_streamed if streamed
          else cuda_pcgs.fused_pcgs_sweep)
    with pytest.raises(ValueError, match="takes no doc_order"):
        ccase.port(fn=fn, positive_support=True, nk_plus=nk_plus,
                   beta=beta, doc_order=torch.arange(ccase.c.num_docs,
                                                     dtype=torch.int32))


@pytest.mark.parametrize("streamed", [False, True])
def test_results_do_not_depend_on_the_document_order(streamed):
    """z, N_kw and the table come out identical under a random permutation
    of the documents given as `doc_order` (the draws are keyed by slot and
    documents are independent given phi)."""
    case = _case(100, streamed, False, seed=5)
    perm = torch.as_tensor(np.random.default_rng(5).permutation(
        case.c.num_docs).astype(np.int32))
    for a, b in zip(case.port(), case.port(doc_order=perm)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The collapsed (ADLDA) mode: nk_plus / beta, N_kw and n_k live
# ---------------------------------------------------------------------------

def _collapsed_case(K, streamed, selected=None, seed=0, beta=0.01):
    """A multi-document random corpus with an entry N_kw that is NOT the
    z_old histogram (hist + a sparse random offset, nk_plus consistent
    with it). The counts stay small (V beta = 3, n_k of tens at K >= 100),
    so leaving the token's own count in the numerator or the denominator
    moves the conditional by percents. `selected`: the one selected
    document ("longest" or an index), or None for every 4th document
    unselected. Returns (case, entry [V, K], nk_plus [K], beta)."""
    rng = np.random.default_rng(2000 + K + 7 * streamed + seed)
    c = _rand_corpus(seed)
    V = c.num_types
    z_flat = rng.integers(0, K, c.num_tokens).astype(np.int32)
    hist = np.zeros((V, K), np.int64)
    np.add.at(hist, (c.tokens, z_flat), 1)
    entry = hist + rng.integers(0, 4, (V, K)) * (rng.random((V, K)) < 0.05)
    nk_plus = (np.float32(beta) * np.float32(V)
               + entry.sum(0).astype(np.float32)).astype(np.float32)
    doc_mask = np.ones(c.num_docs, np.float32)
    if selected is None:
        doc_mask[::4] = 0.0
    else:
        if selected == "longest":
            selected = int(np.argmax(c.doc_lengths()))
        doc_mask[:] = 0.0
        doc_mask[selected] = 1.0
    alpha = (rng.gamma(1.0, 1.0, K) * 0.5 + 0.05).astype(np.float32)
    case = Case(c, K, z_flat, doc_mask, entry.astype(np.float32), alpha,
                streamed, seed=31 + seed)
    return case, entry, nk_plus, beta


def _check_live_counts(case, entry, z3, nkw):
    """N_kw out = entry + hist(z) - hist(z_old), exactly."""
    c, K = case.c, case.K
    z = case.flat(z3)
    d_new = np.zeros((c.num_types, K), np.int64)
    np.add.at(d_new, (c.tokens, z), 1)
    d_old = np.zeros((c.num_types, K), np.int64)
    np.add.at(d_old, (c.tokens, case.z_flat), 1)
    assert np.array_equal(nkw[:c.num_types].astype(np.int64),
                          entry + d_new - d_old)
    assert not nkw[c.num_types:].any()
    return z


@pytest.mark.parametrize("K", [5, 100, 130])
@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("selected", ["longest", 3])
def test_collapsed_single_document_matches_interpreted_kernel(K, streamed,
                                                              selected):
    """With one selected document every chunk of the interpreted kernel
    holds at most one drawing token, so its chunk schedule is the
    sequential chain the plain version runs: z equal on at least 99.9% of
    the document's tokens (only a cdf summed in another order crossing u
    may differ), N_kw exact, the table's n_dk a recount."""
    case, entry, nk_plus, beta = _collapsed_case(K, streamed, selected)
    z_p, nkw_p, table_p = case.port(positive_support=True, nk_plus=nk_plus,
                                    beta=beta)
    z_j, nkw_j, table_j = case.jax(positive_support=True, nk_plus=nk_plus,
                                   beta=beta)
    zp = _check_live_counts(case, entry, z_p, nkw_p)
    zj = _check_live_counts(case, entry, z_j, nkw_j)
    doc = case.doc_mask[case.c.token_doc_ids()] > 0
    disagree = int((zp != zj)[doc].sum())
    print(f"K={K} streamed={streamed} doc={selected}: {disagree} of "
          f"{int(doc.sum())} tokens disagree")
    assert disagree <= MAX_DISAGREE * doc.sum()
    assert (zp[doc] != case.z_flat[doc]).any()
    assert np.array_equal(zp[~doc], case.z_flat[~doc])
    if disagree == 0:
        assert np.array_equal(nkw_p, nkw_j)
        assert np.array_equal(table_p, table_j)


def test_collapsed_single_document_matches_ktiled_streamed_kernel():
    """The same against the JAX streamed kernel's K-tiled body
    (force_ktile) at K=130, two topic tiles: it takes its total from a sum
    of the probs tiles and its offsets from the tile cdfs."""
    case, entry, nk_plus, beta = _collapsed_case(130, True, "longest",
                                                 seed=4)
    z_p, nkw_p, _ = case.port(positive_support=True, nk_plus=nk_plus,
                              beta=beta)
    z_j, nkw_j, _ = case.jax(positive_support=True, force_ktile=True,
                             nk_plus=nk_plus, beta=beta)
    zp = _check_live_counts(case, entry, z_p, nkw_p)
    zj = _check_live_counts(case, entry, z_j, nkw_j)
    doc = case.doc_mask[case.c.token_doc_ids()] > 0
    assert int((zp != zj)[doc].sum()) <= MAX_DISAGREE * doc.sum()


def _freshness_case(streamed):
    """tests/test_pallas_pcgs.py::_freshness_case on the plain version:
    two selected one-token documents of the same word (documents 0 and
    128, d-windows 0 and 1), all z_old = 0. Document 0's uniform 0.8
    sends it to topic 1; with live counts document 128 then sees
    p(topic 0) = 3/7 and its uniform 0.5 draws topic 1, where sweep-stale
    counts (p(topic 0) = 4/7) would draw topic 0."""
    c = Corpus.from_token_lists([[0]] + [[]] * 127 + [[0]], ["w0", "w1"])
    K, beta = 2, 1.0
    case = Case(c, K, np.zeros(2, np.int32), np.ones(c.num_docs, np.float32),
                np.array([[2.0, 0.0], [0.0, 0.0]], np.float32),
                np.ones(K, np.float32), streamed)
    for tok, u in ((0, 0.8), (1, 0.5)):
        case.u24[case.fi3 == tok] = int(u * 2 ** 24)
    nk_plus = np.array([2.0 * beta + 2.0, 2.0 * beta], np.float32)
    return case, nk_plus, beta


@pytest.mark.parametrize("streamed", [False, True])
def test_collapsed_live_freshness(streamed):
    """Ports of test_fused_sweep_collapsed_live_freshness and
    test_streamed_sweep_collapsed_live_freshness: the second token draws
    against the counts the first one left."""
    case, nk_plus, beta = _freshness_case(streamed)
    nk_out = torch.zeros(2)
    z3, nkw, _ = case.port(nk_plus=nk_plus, beta=beta, nk_out=nk_out)
    assert case.flat(z3).tolist() == [1, 1]
    assert nkw[0, :2].tolist() == [0, 2]
    assert nk_out.tolist() == [2.0, 4.0]


@pytest.mark.parametrize("streamed", [False, True])
def test_collapsed_own_count_excluded_at_the_boundary(streamed):
    """One token of word 0 on topic 0 with tiny counts, so the token's own
    assignment is a large share of every count it appears in: entry N_kw
    = [[1, 0], [0, 3]], V beta + n_k = [2, 4] (beta 0.5, V 2), n_dk +
    alpha = [1.7, 0.3]. The conditional (n_dk + alpha - own)(beta + N_kw
    - own)/(V beta + n_k - own) puts 0.35 / 0.3875 on topic 0; leaving own
    in the numerator, the denominator or n_dk would move that to 0.966,
    0.824 or 0.958. With u 1% below and above it the plain version and
    the interpreted kernel both keep topic 0 and then move to topic 1."""
    c = Corpus.from_token_lists([[0]], ["w0", "w1"])
    counts = np.array([[1.0, 0.0], [0.0, 3.0]], np.float32)
    nk_plus = np.array([2.0, 4.0], np.float32)
    alpha = np.array([0.7, 0.3], np.float32)
    case = Case(c, 2, np.zeros(1, np.int32), np.ones(1, np.float32), counts,
                alpha, streamed)
    bf = torch.tensor([0.35, 0.0375]).to(torch.bfloat16).double().numpy()
    p0 = bf[0] / bf.sum()
    for u, want in ((0.99 * p0, 0), (1.01 * p0, 1)):
        case.u24[case.fi3 == 0] = int(u * 2 ** 24)
        z_p, nkw_p, _ = case.port(positive_support=True, nk_plus=nk_plus,
                                  beta=0.5)
        z_j, nkw_j, _ = case.jax(positive_support=True, nk_plus=nk_plus,
                                 beta=0.5)
        assert case.flat(z_p).tolist() == case.flat(z_j).tolist() == [want]
        assert np.array_equal(nkw_p, nkw_j)
        assert nkw_p[0, :2].tolist() == [1 - want, want]


@pytest.mark.parametrize("streamed", [False, True])
def test_collapsed_live_bookkeeping(streamed):
    """Port of test_collapsed_live_bookkeeping_resident_and_streamed: with
    an entry N_kw that is not the z_old histogram, N_kw out = entry +
    hist(z) - hist(z_old); unselected documents and padding keep z; the
    table is a recount plus alpha; nk_out = V beta + n_k of N_kw out."""
    case, entry, nk_plus, beta = _collapsed_case(6, streamed, seed=7)
    nk_out = torch.zeros(6)
    z3, nkw, table = case.port(positive_support=True, nk_plus=nk_plus,
                               beta=beta, nk_out=nk_out)
    z = _check_live_counts(case, entry, z3, nkw)
    case.check_counts(z3, None, table)
    delta = nkw[:case.c.num_types].sum(0) - entry.sum(0)
    assert np.array_equal(nk_out.numpy(),
                          (nk_plus.astype(np.float64) + delta)
                          .astype(np.float32))
    sel = case.doc_mask[case.c.token_doc_ids()] > 0
    assert (z[sel] != case.z_flat[sel]).any()


def test_collapsed_draw_distribution():
    """test_fused_sweep_collapsed_distribution (tests/test_pallas_pcgs.py
    :186) on the plain version's Philox path: chi-square of 2000
    single-token documents of word 0 against the exact conditional
    alpha_k (beta + N_k0 - own) / (V beta + n_k - own). The entry counts
    are large (about 1e6 per topic), so the live drift of at most 2000
    moves is invisible at this sample size."""
    D, K, V = 2000, 5, 2
    c = Corpus.from_token_lists([[0]] * D, ["w0", "w1"])
    alpha = np.array([0.5, 1.0, 2.0, 0.25, 1.25], np.float32)
    beta = 0.3
    base = np.array([1.0e6, 1.1e6, 0.9e6, 1.2e6, 0.8e6])
    counts = np.zeros((V, K), np.float32)
    counts[0] = base
    nk_plus = (beta * V + base).astype(np.float32)
    case = Case(c, K, np.zeros(D, np.int32), np.ones(D, np.float32), counts,
                alpha, False, seed=21)
    z3, nkw, _ = case.port(inject=False, positive_support=True,
                           nk_plus=nk_plus, beta=beta)
    own = np.eye(K)[0]
    p = alpha * (beta + base - own) / (beta * V + base - own)
    p = p / p.sum()
    obs = np.bincount(case.flat(z3), minlength=K).astype(np.float64)
    chi2 = float(((obs - p * D) ** 2 / (p * D)).sum())
    assert sps.chi2.sf(chi2, K - 1) > 1e-4, (obs, p * D)
    assert nkw[0].sum() == base.sum()


@pytest.mark.parametrize("streamed", [False, True])
def test_collapsed_mode_cpu_runs_plain_version(streamed):
    """On CPU tensors the wrappers run the plain collapsed version, the
    sequential chain, with every launch counter at 0; nk_plus without
    beta raises."""
    case, entry, nk_plus, beta = _collapsed_case(6, streamed, seed=2)
    ref = (cuda_pcgs.fused_pcgs_sweep_streamed_reference if streamed
           else cuda_pcgs.fused_pcgs_sweep_reference)
    got = case.port(positive_support=True, nk_plus=nk_plus, beta=beta)
    want = case.port(positive_support=True, nk_plus=nk_plus, beta=beta,
                     fn=ref)
    for a, r in zip(got, want):
        assert np.array_equal(a, r)
    for fn in (cuda_pcgs.fused_pcgs_sweep,
               cuda_pcgs.fused_pcgs_sweep_streamed):
        assert fn.launches == fn.collapsed_launches == 0
    with pytest.raises(ValueError, match="nk_plus and beta"):
        case.port(nk_plus=nk_plus, beta=None)


def _operands_of_k(num_topics):
    """Minimal CPU operands of `check_sweep_operands` for a K-topic table."""
    i32 = torch.int32
    z3 = torch.zeros((1, 1, 128), dtype=i32)
    table = torch.zeros((kpad_of(num_topics) + FLAG_ROWS, 128))
    return (z3, z3, z3, table, torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=i32), 1, torch.arange(2, dtype=i32),
            torch.zeros(1, dtype=i32), num_topics)


@pytest.mark.parametrize("collapsed,limit", [
    (True, cuda_pcgs.MAX_TOPICS_COLLAPSED), (False, cuda_pcgs.MAX_TOPICS)])
def test_sweep_topic_limit_per_mode(collapsed, limit):
    """The collapsed mode keeps four K-rows a warp in shared memory (16
    bytes a topic: n_dk column, cdf, the view of V beta + n_k and the
    unflushed moves), the PCGS mode two (8 bytes): each mode's limit is the
    largest 128-topic multiple that fits 227 KB in one warp. At the limit
    the topic check passes and the next check (the tensors' device: these
    lie on the CPU) raises; one 128-topic step above, the topic check
    raises."""
    assert limit == (227 * 1024 // (16 if collapsed else 8)) // 128 * 128
    assert cuda_pcgs.MAX_TOPICS_COLLAPSED == 14464
    assert cuda_pcgs.MAX_TOPICS == 29056
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_pcgs.check_sweep_operands(*_operands_of_k(limit),
                                       collapsed=collapsed)
    with pytest.raises(ValueError, match=f"num_topics={limit + 128} "
                       f"outside the kernel's range \\(1..{limit}"):
        cuda_pcgs.check_sweep_operands(*_operands_of_k(limit + 128),
                                       collapsed=collapsed)
    # the PCGS mode's limit is unchanged by the collapsed mode's
    above = cuda_pcgs.MAX_TOPICS_COLLAPSED + 128
    with pytest.raises(ValueError, match=("outside" if collapsed
                                          else "expected a tensor on")):
        cuda_pcgs.check_sweep_operands(*_operands_of_k(above),
                                       collapsed=collapsed)
