"""The left-to-right estimator kernel's plain version on the CPU
(ops/cuda_left_to_right.py::left_to_right_reference, the kernel's own
inverse-CDF draws from Philox words): the closed form on length-one
documents, its estimate within the spread of five seeds of the JAX
package's `left_to_right_from_counts` on a synthetic split, the true phi
ahead of a uniform one, the draws' counter independent of the other
documents, the launch shape, and the wiring: off the CPU without injected
noise the estimator takes the kernel and never falls back. (The estimator
given the JAX function's own Gumbel draws stays
tests/test_torch_heldout.py::test_estimator_equals_jax_given_its_gumbel_draws.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    """K=100: one block a document of 100 particles; K=4096: groups of
    particles whose 16-bit counts fit the budget; a padded length of 2^16
    or more takes 32-bit counts."""
    s = cuda_left_to_right.launch_shape(100, 100, 88)
    assert (s.groups, s.particles, s.topics, s.stride,
            s.wide_counts) == (1, 100, 4, 5, False)
    big = cuda_left_to_right.launch_shape(4096, 100, 88)
    assert big.groups > 1 and big.particles * big.groups >= 100
    assert big.particles * (big.groups - 1) < 100
    assert big.shared_bytes <= cuda_left_to_right.SHARED_BUDGET
    assert cuda_left_to_right.launch_shape(100, 100, 1 << 16).wide_counts


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
    """The seeded case of chip_smoke.py: in the kernel's association (a
    lane's in-order sums, a Hillis-Steele scan across lanes) the draw,
    without its repair, lands on a topic whose product is 0, while the
    plain version, given the same Philox word, draws a topic with a
    positive product."""
    import chip_smoke
    case = chip_smoke.l2r_zero_run_case()
    z = chip_smoke.l2r_kernel_draw(case["alpha"], case["u24"])
    assert z == case["unrepaired"] and case["alpha"][z] == 0
    zk, zr = chip_smoke.l2r_zero_run_draw(torch, case, device="cpu")
    assert zk == zr and case["alpha"][zr] > 0


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
