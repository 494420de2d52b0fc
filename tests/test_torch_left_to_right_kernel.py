"""The left-to-right estimator kernel's plain version on the CPU
(ops/cuda_left_to_right.py::left_to_right_reference, the kernel's own
inverse-CDF draws from Philox words): the closed form on length-one
documents, its estimate within the spread of five seeds of the JAX
package's `left_to_right_from_counts` on a synthetic split, the true phi
ahead of a uniform one, the draws' counter independent of the other
documents, the launch shape, the kernel's draw (the dense prefix and the
sparse walk of each particle's sorted list, emulated in Python) against
the plain version's dense inverse CDF, and the wiring: off the CPU
without injected noise the estimator takes the kernel and never falls
back. (The estimator
given the JAX function's own Gumbel draws stays
tests/test_torch_heldout.py::test_estimator_equals_jax_given_its_gumbel_draws.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ldagroupedgibbssampler_tpu.evaluation import marginal as jax_marginal
from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
    build_perplexity_split)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation import marginal
from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_left_to_right
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

ref = cuda_left_to_right.left_to_right_reference


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(v):
    return torch.tensor([v], dtype=torch.int64)


def _planted(num_docs=60, doc_len=40, seed=42):
    """Three planted topics of ten types each (tests/conftest.py's
    synthetic corpus)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{k}_{i}" for k in range(3) for i in range(10)]
    docs = []
    for d in range(num_docs):
        main = rng.integers(0, 10, int(doc_len * 0.9)) + (d % 3) * 10
        noise = rng.integers(0, len(vocab), doc_len - len(main))
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(docs, vocab)


def _true_phi():
    phi = np.full((3, 30), 1e-3)
    for k in range(3):
        phi[k, k * 10:(k + 1) * 10] = 1.0
    return (phi / phi.sum(1, keepdims=True)).astype(np.float32)


def test_length_one_documents_give_the_closed_form():
    """One token a document: log sum_k (alpha_k / sum alpha) p(w|k),
    whatever the draws."""
    test = Corpus.from_token_lists([[0], [3], [5], [2]],
                                   [f"w{i}" for i in range(6)])
    w_pad, mask_pad = test.to_padded()
    phi = np.random.default_rng(0).dirichlet(np.ones(6), 4)
    alpha = np.array([0.1, 0.4, 1.0, 2.5])
    got = float(ref(w_pad, mask_pad, torch.as_tensor(phi, dtype=torch.float32),
                    torch.as_tensor(alpha, dtype=torch.float32), 8, _seed(3)))
    want = sum(np.log((alpha / alpha.sum()) @ phi[:, w]) for w in (0, 3, 5, 2))
    assert got == pytest.approx(want, rel=1e-5)


def test_estimate_lies_within_the_spread_of_five_jax_seeds():
    """Counts of a split of the planted corpus (each token on its planted
    topic): five seeds of the kernel's plain version against five keys of
    the JAX estimator, 16 particles. Their means agree within 4 standard
    errors of the difference, and each of ours lies within the JAX five's
    range widened by that range on each side."""
    corpus = _planted()
    train, _est, evl = build_perplexity_split(corpus, 0.2, seed=2)
    k = np.repeat(np.arange(3), 10)[train.tokens]
    nkw = np.zeros((3, 30), np.int32)
    np.add.at(nkw, (k, train.tokens), 1)
    nk = nkw.sum(1).astype(np.int32)
    alpha = np.full(3, 0.5, np.float32)
    w_pad, mask_pad = evl.to_padded()
    word_prob = ((0.01 + torch.as_tensor(nkw, dtype=torch.float32))
                 / (0.01 * 30 + torch.as_tensor(nk, dtype=torch.float32))
                 [:, None])
    ours = np.array([float(ref(w_pad, mask_pad, word_prob,
                               torch.as_tensor(alpha), 16, _seed(s)))
                     for s in range(5)])
    theirs = np.array([float(jax_marginal._jitted(
        jax.random.key(s), jnp.asarray(w_pad), jnp.asarray(mask_pad),
        jnp.asarray(nkw), jnp.asarray(nk), jnp.asarray(alpha), 0.01, 16))
        for s in range(5)])
    se = np.sqrt(ours.var(ddof=1) / 5 + theirs.var(ddof=1) / 5)
    assert abs(ours.mean() - theirs.mean()) < 4 * se, (ours, theirs)
    spread = theirs.max() - theirs.min()
    assert (ours > theirs.min() - spread).all(), (ours, theirs)
    assert (ours < theirs.max() + spread).all(), (ours, theirs)


def test_true_phi_beats_uniform_phi():
    """As tests/test_likelihood.py::test_left_to_right_sane, on the
    kernel's draws."""
    corpus = _planted()
    w_pad, mask_pad = corpus.to_padded()
    alpha = torch.full((3,), 0.5)
    ll_true = float(ref(w_pad, mask_pad, torch.as_tensor(_true_phi()), alpha,
                        16, _seed(0)))
    ll_unif = float(ref(w_pad, mask_pad, torch.full((3, 30), 1.0 / 30),
                        alpha, 16, _seed(0)))
    assert ll_true > ll_unif + 100, (ll_true, ll_unif)


def test_draws_do_not_depend_on_the_other_documents():
    """The counter names (document, position, particle): the first
    documents of a split, alone, draw the same z as inside the split, and
    positions that are not real are -1 in the returned draws."""
    corpus = _planted(num_docs=12)
    w_pad, mask_pad = corpus.to_padded()
    mask_pad[1, 30:] = False             # a shorter second document
    phi = torch.as_tensor(_true_phi())
    _t, z_all = ref(w_pad, mask_pad, phi, 0.5, 6, _seed(9), return_z=True)
    _t, z_sub = ref(w_pad[:3, :35], mask_pad[:3, :35], phi, 0.5, 6,
                    _seed(9), return_z=True)
    assert torch.equal(z_sub, z_all[:35, :, :3])
    assert (z_all[30:, :, 1] == -1).all() and (z_all[:30, :, 1] >= 0).all()


def test_launch_shape_fits_shared_memory():
    """K=100 and K=4096 at the split's 88 padded positions: one block a
    document of 100 particles, a thread each, each list min(K, L) entries
    of 16 + 16 bits, within the budget of two blocks an SM; more topics
    than four warps' dense prefix takes get more warps (8 at K=4096); a
    few particles get at least 4 warps; lists that do not fit split
    the particles into groups; a padded length of 2^16 or more takes
    32 + 32-bit entries; a K whose two word rows and one list exceed the
    card's shared memory takes one word-row buffer, up to K = 28,964 at 88
    positions; a K whose one row and one list exceed it raises."""
    small = cuda_left_to_right.launch_shape(100, 100, 88)
    assert (small.groups, small.particles, small.warps, small.row_buffers,
            small.capacity, small.wide_entries) == (1, 100, 4, 2, 88, False)
    big = cuda_left_to_right.launch_shape(4096, 100, 88)
    assert (big.groups, big.particles, big.warps, big.row_buffers,
            big.capacity, big.wide_entries) == (1, 100, 8, 2, 88, False)
    for s in (small, big):
        assert s.shared_bytes <= cuda_left_to_right.SHARED_BUDGET
    assert cuda_left_to_right.launch_shape(100, 1, 1).warps == 4
    long = cuda_left_to_right.launch_shape(4096, 100, 1000)
    assert long.groups > 1 and long.particles * long.groups >= 100
    assert long.particles * (long.groups - 1) < 100
    assert long.shared_bytes <= cuda_left_to_right.SHARED_BUDGET
    assert cuda_left_to_right.launch_shape(100, 100, 1 << 16).wide_entries
    assert cuda_left_to_right.launch_shape(19_308, 100, 88).row_buffers == 2
    for k in (19_312, 20_001, 23_200, 28_964):
        one = cuda_left_to_right.launch_shape(k, 100, 88)
        assert one.row_buffers == 1 and one.particles == 1
        assert one.shared_bytes <= cuda_left_to_right.SHARED_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        cuda_left_to_right.launch_shape(28_968, 100, 88)


@pytest.mark.parametrize("k,length", [(100, 88), (4096, 88), (7, 88),
                                      (100, 3), (1, 1)])
def test_list_capacity_is_the_fewer_of_topics_and_positions(k, length):
    """A particle lists at most one entry a topic and one a real position,
    so its capacity is min(K, L) entries."""
    assert cuda_left_to_right.launch_shape(k, 100, length).capacity == min(
        k, length)


def test_estimator_off_the_cpu_takes_the_kernel(monkeypatch):
    """left_to_right_from_word_prob hands a tensor off the CPU to the
    kernel wrapper with a seed from its generator; with injected noise it
    stays the plain version (meta tensors stand in for the card)."""
    calls = []
    monkeypatch.setattr(rnd, "kernel_seed", lambda gen, dev: torch.empty(
        1, dtype=torch.int64, device=dev))
    monkeypatch.setattr(cuda_left_to_right, "left_to_right",
                        lambda *args: calls.append(args[4]) or
                        torch.zeros((), device="meta"))
    wp = torch.empty((3, 30), device="meta")
    w_pad = torch.zeros((4, 5), dtype=torch.int64, device="meta")
    mask = torch.ones((4, 5), dtype=torch.bool, device="meta")
    marginal.left_to_right_from_word_prob(w_pad, mask, wp, 0.5, 7,
                                          generator=object())
    assert calls == [7]
    marginal.left_to_right_from_word_prob(
        w_pad, mask, wp, 0.5, 7,
        gumbel=lambda t: torch.zeros((7, 4, 3), device="meta"))
    assert calls == [7]


def test_kernel_path_raises_when_the_build_or_the_launch_fails(monkeypatch,
                                                                tmp_path):
    """A failing nvcc raises from the build; a library whose entry point
    returns a CUDA error raises from the launch; no plain fallback."""
    wp = torch.empty((3, 30), device="meta")
    w_pad = torch.zeros((4, 5), dtype=torch.int32, device="meta")
    mask = torch.ones((4, 5), dtype=torch.bool, device="meta")
    seed = torch.empty(1, dtype=torch.int64, device="meta")

    def no_nvcc():
        raise RuntimeError("nvcc failed (test)")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "libldakernels-test.so")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            cuda_left_to_right.left_to_right(w_pad, mask, wp, 0.5, 8, seed)
    finally:
        _build.library.cache_clear()

    class FailingLibrary:
        def __getattr__(self, name):
            return lambda *args: 700
    monkeypatch.setattr(_build, "library", lambda: FailingLibrary())
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    before = cuda_left_to_right.left_to_right.launches
    with pytest.raises(RuntimeError, match="lda_left_to_right failed"):
        cuda_left_to_right.left_to_right(w_pad, mask, wp, 0.5, 8, seed)
    assert cuda_left_to_right.left_to_right.launches == before


def test_the_unrepaired_kernel_walk_draws_a_zero_topic():
    """The seeded case of chip_smoke.py: in the kernel's association (the
    dense prefix's shuffle scans, the binary search) the draw, without its
    repair, lands on a topic whose product is 0, while the plain version,
    given the same Philox word, draws a topic with a positive product."""
    import chip_smoke
    case = chip_smoke.l2r_zero_run_case()
    warps = cuda_left_to_right.launch_shape(len(case["alpha"]), 1, 1).warps
    z = chip_smoke.l2r_kernel_draw(case["alpha"], case["u24"], warps)[0]
    assert z == case["unrepaired"] and case["alpha"][z] == 0
    zk, zr = chip_smoke.l2r_zero_run_draw(torch, case, device="cpu")
    assert zk == zr and case["alpha"][zr] > 0


def _dense_draw(alpha, wrow, counts, u24):
    """left_to_right_reference's draw of one particle: the inverse CDF of
    torch.cumsum((c + alpha) wp[w]) at u T, then the zero-product repair."""
    s = (counts + alpha) * wrow
    cdf = torch.cumsum(s, 0)
    u = torch.tensor(u24, dtype=torch.float32) * 2.0 ** -24 * cdf[-1]
    z = (cdf <= u).sum().clamp(max=len(s) - 1)
    z = cuda_left_to_right._off_zero(z.reshape(1, 1), counts[None, None],
                                     alpha, wrow[None])
    return int(z)


def _is_tie(alpha, wrow, counts, u24, za, zb):
    """Every exact (float64) cdf value from min(za, zb) up to the other
    draw minus one lies within L2R_TIE sqrt(K) 2^-24 T of u T."""
    import chip_smoke
    s = (counts.double() + alpha.double()) * wrow.double()
    cdf = torch.cumsum(s, 0)
    total = float(cdf[-1])
    target = u24 * 2.0 ** -24 * total
    lo, hi = min(za, zb), max(za, zb)
    gap = float((cdf[lo:hi] - target).abs().max())
    return gap <= chip_smoke.L2R_TIE * np.sqrt(len(s)) * 2.0 ** -24 * total


def _kernel_draw(alpha, wrow, counts, u24, warps):
    """The kernel's draw (chip_smoke.l2r_kernel_draw) with its repair."""
    import chip_smoke
    a = (alpha * wrow).numpy()
    entries = [(int(k), int(counts[k])) for k in torch.nonzero(counts)[:, 0]]
    z = chip_smoke.l2r_kernel_draw(a, u24, warps, entries, wrow.numpy())[0]
    z = cuda_left_to_right._off_zero(torch.tensor([[z]]), counts[None, None],
                                     alpha, wrow[None])
    return int(z)


def _walk_case(seed, k, nonzero, zeros):
    """A particle's operands from a seed: alpha and the word row of mixed
    magnitudes with a share `zeros` of zero alphas and zero word
    probabilities, `nonzero` topics with counts, one Philox-size u."""
    rng = np.random.default_rng(seed)
    alpha = (rng.random(k) * rng.choice([1.0, 1e-3, 1e2], k)).astype(
        np.float32)
    alpha[rng.random(k) < zeros] = 0
    wrow = (rng.random(k) * rng.choice([1.0, 1e-4], k)).astype(np.float32)
    wrow[rng.random(k) < zeros / 2] = 0
    counts = np.zeros(k, np.float32)
    picked = rng.choice(k, min(nonzero, k), replace=False)
    counts[picked] = rng.integers(1, 30, len(picked))
    return (torch.as_tensor(alpha), torch.as_tensor(wrow),
            torch.as_tensor(counts), int(rng.integers(0, 1 << 24)))


def _walks_agree(seed, k, nonzero, zeros, warps):
    alpha, wrow, counts, u24 = _walk_case(seed, k, nonzero, zeros)
    zd = _dense_draw(alpha, wrow, counts, u24)
    zk = _kernel_draw(alpha, wrow, counts, u24, warps)
    return zd == zk or _is_tie(alpha, wrow, counts, u24, zd, zk)


@pytest.mark.parametrize("k,warps", [(100, 4), (4096, 8), (37, 4),
                                     (300, 4)])
def test_sparse_walk_draws_the_dense_inverse_cdf(k, warps):
    """The kernel's draw (the dense prefix A of alpha_k wp[w, k], then the
    walk of the particle's sorted (topic, count) list with a binary search
    of A in the segment where A_k + C passes u T) draws the z of the
    plain version's dense inverse CDF on 300 seeded particles, but where
    the two differ by a proven tie (L2R_TIE)."""
    for seed in range(300):
        nonzero = seed % 60
        assert _walks_agree(seed, k, nonzero, 0.3 if seed % 3 == 0 else 0.0,
                            warps), seed


@settings(max_examples=150, deadline=None, database=None,
          derandomize=True)
@given(seed=st.integers(0, 2 ** 32 - 1), k=st.integers(1, 700),
       nonzero=st.integers(0, 90), zeros=st.sampled_from([0.0, 0.2, 0.9]),
       warps=st.sampled_from([4, 8, 16]))
def test_sparse_walk_draws_the_dense_inverse_cdf_hypothesis(seed, k, nonzero,
                                                            zeros, warps):
    """As above over K, list lengths, zero shares and warps drawn by
    hypothesis (the values themselves from the seed)."""
    assert _walks_agree(seed, k, nonzero, zeros, warps)


def _emulate_kernel(w_pad, mask, word_prob, alpha, num_particles, seed):
    """The whole kernel in Python: every (document, particle) keeps its
    sorted (topic, count) list, each real position draws by
    chip_smoke.l2r_kernel_draw from the kernel's Philox word and repairs a
    zero-product draw; returns the draws as int32 [L, R, D] (-1 where not
    real)."""
    import chip_smoke
    num_docs, length = w_pad.shape
    k = word_prob.shape[0]
    warps = cuda_left_to_right.launch_shape(k, num_particles, length).warps
    wp_t = word_prob.T.contiguous()
    z_all = torch.full((length, num_particles, num_docs), -1,
                       dtype=torch.int32)
    lists = [[{} for _ in range(num_particles)] for _ in range(num_docs)]
    for t in range(length):
        u24 = cuda_left_to_right._u24(seed, t, num_particles, num_docs)
        for d in range(num_docs):
            if not mask[d, t]:
                continue
            wrow = wp_t[int(w_pad[d, t])]
            a = (alpha * wrow).numpy()
            for r in range(num_particles):
                lst = lists[d][r]
                entries = sorted(lst.items())
                z = chip_smoke.l2r_kernel_draw(a, int(u24[r, d]), warps,
                                               entries, wrow.numpy())[0]
                counts = torch.zeros(k)
                for topic, c in entries:
                    counts[topic] = c
                z = int(cuda_left_to_right._off_zero(
                    torch.tensor([[z]]), counts[None, None], alpha,
                    wrow[None]))
                lst[z] = lst.get(z, 0) + 1
                z_all[t, r, d] = z
    return z_all


@pytest.mark.parametrize("k", [7, 200])
def test_kernel_emulation_draws_the_plain_versions_z(k):
    """The emulated kernel (lists, insertions, the walk, the repair) on the
    planted corpus's first documents, with a tenth of the topics inactive
    (alpha 0): every particle's draws equal left_to_right_reference's up to
    its first difference, and that difference is a proven tie."""
    import chip_smoke
    corpus = _planted(num_docs=5, doc_len=24)
    w_pad, mask_pad = corpus.to_padded()
    w_pad, mask_pad = torch.as_tensor(w_pad), torch.as_tensor(mask_pad)
    mask_pad[2, 15:] = False
    rng = np.random.default_rng(k)
    word_prob = torch.as_tensor(rng.dirichlet(np.full(30, 0.3), k)
                                .astype(np.float32))
    alpha = torch.as_tensor(np.where(np.arange(k) % 10 == 3, 0.0,
                                     rng.random(k) + 0.05).astype(np.float32))
    seed = _seed(77 + k)
    zk = _emulate_kernel(w_pad, mask_pad, word_prob, alpha, 6, seed)
    _t, zr = ref(w_pad, mask_pad, word_prob, alpha, 6, seed, return_z=True)
    differ = zk != zr
    assert (zk[~mask_pad.T[:, None, :].expand_as(zk)] == -1).all()
    assert float(differ.float().mean()) < 0.05
    for r, d in differ.any(dim=0).nonzero().tolist():
        t = int(differ[:, r, d].nonzero()[0, 0])
        ok, gap = chip_smoke.l2r_tie_proof(
            torch, word_prob.T.contiguous(), alpha, w_pad, mask_pad, zr,
            seed, t, r, d, int(zk[t, r, d]), int(zr[t, r, d]))
        assert ok, (r, d, t, gap)


def test_a_draw_on_a_zero_product_moves_to_the_last_positive_below():
    """The repair the kernel and the plain version share: a z whose
    product (c_z + alpha_z) wp[w, z] is 0 moves to the last topic at or
    below it with a positive product; a z with a positive product, and a
    z with none below it, stay."""
    alpha = torch.tensor([0.0, 0.5, 0.0, 0.0, 0.25, 0.0])
    wrow = torch.tensor([[1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                         [1.0, 1.0, 1.0, 1.0, 0.0, 1.0]])
    counts = torch.zeros((2, 2, 6))
    counts[1, 0, 2] = 1.0
    z = torch.tensor([[3, 5], [3, 0]])
    got = cuda_left_to_right._off_zero(z, counts, alpha, wrow)
    # particle 0: doc 0 topic 3 -> 1; doc 1 topic 5 (wp 1, alpha 0) -> 1
    # (topic 4's wp is 0); particle 1: doc 0 topic 3 -> 2 (its count);
    # doc 1 topic 0 has nothing below it and stays
    assert got.tolist() == [[1, 1], [2, 0]]
    z = torch.tensor([[1, 4], [2, 1]])
    assert cuda_left_to_right._off_zero(z, counts, alpha, wrow).tolist() == [
        [1, 1], [2, 1]]
