"""The `manhattan` kernel of csrc/pairwise.cu: a sum-of-|x - y| op of
`minmax_kernel` (the ring of chunks that chebychev and jaccard run on),
its arithmetic emulated on the CPU.

The kernel sums |x - y| in two-level sums: each chunk of 32 coordinates
(the last to K) in order into a fresh partial, each partial into its
split's total, the splits' totals (a cluster of up to 4 blocks where the
tiles fill at most half the SMs) in rank order. `minmax_emulation` of
tests/test_torch_pairwise_jaccard_chebychev.py repeats it; here it is held
to the JAX package's `manhattan` within rtol = atol = 1e-5, split and
unsplit; unsplit it is bit-equal to the parent kernel's padded two-level
sum (`_chunked_sum` of tests/test_torch_pairwise_kernel.py: the padding
added +0 to partials >= 0), and so is chip_smoke.py's on-card emulation
(`manhattan_emulation`, torch on the card's tensors). A NaN, or an inf in
both rows at one coordinate, gives NaN where JAX does. The wrapper sends
manhattan to one launch of `lda_pairwise_elementwise` with the metric of
the minmax kernel, and the source dispatches it there.

Tolerances: 1e-5 (chip_smoke.py's PAIRWISE_TOL: sums in another order than
JAX's); the rest exact."""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_pairwise_jaccard_chebychev as tj
import test_torch_pairwise_kernel as tk
from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_pairwise as cp

F32 = np.float32
TOL = chip_smoke.PAIRWISE_TOL
SOURCE = tj.SOURCE


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split_count(m, n, k):
    return len(cp.minmax_launch_shape(m, n, k)["split_chunks"])


@pytest.mark.parametrize("m,n,k", [(7, 9, 12), (5, 6, 37), (4, 3, 70),
                                   (3, 5, 100), (5, 6, 4096),
                                   (140, 20, 37), (300, 200, 65)])
def test_ring_sum_equals_jax_split_and_unsplit(m, n, k):
    """The ring's sum order, emulated, within 1e-5 of JAX's manhattan,
    both with the launch's K split (up to 4 blocks a tile here) and
    without one (sms=1); the split changes the sum by a few ulps only."""
    X, Y = tj._probs(m + k, m, k), tj._probs(n + k + 1, n, k)
    want = tj._jax("manhattan", X, Y)
    split = tj.minmax_emulation("manhattan", X, Y)
    whole = tj.minmax_emulation("manhattan", X, Y, sms=1)
    np.testing.assert_allclose(split, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(whole, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(split, whole, rtol=1e-6, atol=0)
    assert _split_count(m, n, k) == min(4, -(-k // tj.CHUNK),
                                        max(1, 132 // (-(-m // 128)
                                                       * -(-n // 64))))


@pytest.mark.parametrize("k", [12, 37, 70, 100, 4096])
def test_unsplit_is_bit_equal_to_the_parents_padded_sum(k):
    """Without a split the ring's sum (the last chunk to K) is the parent
    kernel's zero-padded two-level sum bit for bit, and chip_smoke.py's
    torch emulation of it too, split or not."""
    X, Y = tj._probs(k, 4, k), tj._probs(k + 1, 5, k)
    d = np.abs(X[:, None, :] - Y[None, :, :]).astype(F32)
    parent = tk._chunked_sum(d)
    np.testing.assert_array_equal(
        tj.minmax_emulation("manhattan", X, Y, sms=1), parent)
    np.testing.assert_array_equal(
        chip_smoke.manhattan_emulation(torch, tj._t(X), tj._t(Y)).numpy(),
        parent)
    splits = cp.minmax_launch_shape(4, 5, k)["split_chunks"]
    np.testing.assert_array_equal(
        chip_smoke.manhattan_emulation(torch, tj._t(X), tj._t(Y),
                                       splits).numpy(),
        tj.minmax_emulation("manhattan", X, Y))


def test_a_nan_or_an_inf_pair_gives_nan_as_in_jax():
    """A NaN in x row 0 makes that row NaN in JAX, the plain version and
    the emulation; an inf in both rows at one coordinate (|inf - inf|)
    makes that pair NaN and an inf against a finite value inf."""
    for impl in (tj._jax, tj._plain, tj.minmax_emulation):
        r = impl("manhattan", tj.NAN_X, tj.NAN_Y)
        assert np.isnan(r[0]).all() and np.isfinite(r[1]).all()
    X, Y = tj._probs(3, 12, 37), tj._probs(4, 14, 37)
    X[5, 7] = Y[9, 7] = np.inf
    for impl in (tj._jax, tj._plain, tj.minmax_emulation):
        r = impl("manhattan", X, Y)
        assert np.isnan(r[5, 9])
        assert np.isposinf(r[5, :9]).all() and np.isposinf(r[:5, 9]).all()
        assert np.isfinite(np.delete(np.delete(r, 5, 0), 9, 1)).all()


@pytest.mark.parametrize("k", [12, 37])
@pytest.mark.parametrize("case", ["off path", "inf pair"])
def test_chip_smoke_nan_rows_agree(case, k):
    """On chip_smoke.py's off-path rows (a negative value, NaN, inf, 2^40,
    subnormal values) and inf-pair rows the JAX package, the plain
    version and the emulation agree: NaN at the same places, the rest
    within 1e-5; pairwise_nan_report checks manhattan on the card."""
    X, Y = chip_smoke.pairwise_nan_cases(tj._probs(1, 301, k),
                                         tj._probs(2, 203, k))[case]
    X, Y = X[:140], Y[:80]
    keep = np.arange(len(X)) != (101 if case == "off path" else -1)
    jax_r, plain = tj._jax("manhattan", X, Y), tj._plain("manhattan", X, Y)
    tj._same_nan_and_close(plain[keep], jax_r[keep])
    tj._same_nan_and_close(tj.minmax_emulation("manhattan", X, Y), plain)
    assert "manhattan" in chip_smoke.PAIRWISE_NAN_METRICS


@pytest.mark.parametrize("m,n,k", [(3, 5, 100), (129, 65, 37)])
def test_wrapper_sends_manhattan_to_one_launch_of_the_minmax_kernel(
        m, n, k, monkeypatch):
    """Off the CPU (meta tensors stand in for the card) the wrapper makes
    one call of lda_pairwise_elementwise with manhattan's metric number,
    the shapes as they are, and counts one launch."""
    calls = []

    class Library:
        def lda_pairwise_elementwise(self, *args):
            calls.append(args[6:10])
            return 0
    monkeypatch.setattr(_build, "library", lambda: Library())
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    X = torch.empty((m, k), device="meta")
    Y = torch.empty((n, k), device="meta")
    before = cp.pairwise_elementwise.launches
    out = cp.pairwise_elementwise("manhattan", X, Y)
    assert out.shape == (m, n)
    assert calls == [(m, n, k, cp.METRICS["manhattan"])]
    assert cp.pairwise_elementwise.launches == before + 1


def test_source_dispatches_manhattan_to_the_minmax_kernel():
    """csrc/pairwise.cu: manhattan's case launches minmax_kernel through
    launch_minmax, its op is a sum of fabsf(x - y), and elementwise_tile
    keeps canberra and js only."""
    text = open(SOURCE, encoding="utf-8").read()
    case = re.search(r"case kManhattan:\s*err = (\w+)<kManhattan>", text)
    assert case and case.group(1) == "launch_minmax"
    assert "kSumAbs" in text
    assert re.search(r"kOp == kSumAbs\)\s*acc = __fadd_rn\(acc, "
                     r"fabsf\(__fsub_rn\(x, y\)\)\);", text)
    tile = text[text.index("elementwise_tile("):
                text.index("// ---- manhattan, chebychev and jaccard")]
    assert "kManhattan" not in tile
    assert "static_assert(kMetric == kCanberra || kMetric == kJs" in tile
    assert "minmax_kernel<kManhattan, true>" in text


def test_floors_and_occupancy_name_manhattan():
    """chip_smoke.py prints manhattan's instruction floor (two FADDs a
    term: 0.1898 ms at the 20NG shape, 2 issued instructions a term) and
    reads its blocks an SM as the fifth value of blocks_per_sm."""
    import types
    floors = chip_smoke.minmax_floors(
        types.SimpleNamespace(_nvcc=lambda: "/nonexistent/nvcc"),
        chip_smoke.PAIRWISE_TEST, chip_smoke.PAIRWISE_TRAIN, 100)
    assert floors["manhattan"] == "not measured"
    assert round(floors["issue_floor_ms"], 4) == 0.1898
    assert "manhattan" in chip_smoke.PAIRWISE_REDESIGNED
    assert "int [5] on the host" in open(SOURCE, encoding="utf-8").read()
