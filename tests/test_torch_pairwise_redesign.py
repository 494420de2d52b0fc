"""The redesigned `uber` and `ks` kernels of csrc/pairwise.cu, their
arithmetic emulated on the CPU.

KS: a NumPy emulation of the kernel's shared-memory walk, step for step as
the kernel runs it (a step takes the smaller head, or both where they are
equal; the gap carried as the sum of two shared offsets, x ascending and y
descending, its largest and smallest entered at every step; the walk
ended once a row is exhausted, tested every kKsUnroll steps; NaN staged
as +inf),
held bit-equal to `ks_merge_reference` and to the port's plain `ks`, and
within 1e-6 of the JAX package's `ks` (which divides both counts by K
before subtracting), on rows with ties where a row is exhausted, signed
zeros, equal rows, K = 1 and K that no group of steps divides; the steps
it needs summed equal `chip_smoke.ks_merge_steps`, the count behind the
kernel's bound; the global-memory instance's walk (2K steps, x first on
a tie, one load a step) emulated the same way.

uber: its division (reciprocal, Newton step, quotient, correction) on the
values scaled by 2^64, with each fused multiply-add rounded once
(`cuda_pairwise.fma_f32`), equal to the IEEE quotient on every term, with
the reciprocal correctly rounded or an ulp off either way (the card's
approximate reciprocal is within an ulp); `division_check_reference`
finds no differing term on chip_smoke.py's rows; the scaled path's sums
(values times 2^64, chebychev and manhattan times 2^-64 at the end) equal
the unscaled ones bit for bit, denormal values included.

Tolerances: the merge exact (integer gaps); JAX's ks within 1e-6 as in
tests/test_torch_pairwise_kernel.py; the division and the scaled sums
exact."""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from ldagroupedgibbssampler_tpu.similarity import distances as jax_distances
from ldagroupedgibbssampler_tpu_torch.ops import cuda_pairwise as cp
from ldagroupedgibbssampler_tpu_torch.similarity import distances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "ldagroupedgibbssampler_tpu_torch", "csrc",
                      "pairwise.cu")
F32 = np.float32


def _const(name):
    text = open(SOURCE, encoding="utf-8").read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


UNROLL = _const("kKsUnroll")
ROW = 128                     # kKsRowBytes: one staged value of 32 rows


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a, F32))


# ---------------------------------------------------------------------------
# ks: the kernel's walks, emulated
# ---------------------------------------------------------------------------

def ks_shared_walk(x, y, lane=5, col=17):
    """ks_kernel<true> on one pair of sorted rows: (the largest gap, the
    steps run, the steps after which a row was first exhausted). The
    shared rows as the kernel stages them, addressed in bytes: x
    ascending in slots 0..K + kKsUnroll - 1 (+inf from K), then y
    descending in as many slots (slot t = y[K + kKsUnroll - 1 - t], +inf
    below kKsUnroll), a slot 128 B, the lane's or the column's 4 B inside
    it; any other address raises."""
    k = len(x)
    inf = F32(np.inf)
    slots = k + UNROLL
    mem = {}
    for t in range(slots):
        vx = F32(x[t]) if t < k else inf
        vy = F32(y[slots - 1 - t]) if t >= UNROLL else inf
        mem[t * ROW + 4 * lane] = vx if vx == vx else inf
        mem[(slots + t) * ROW + 4 * col] = vy if vy == vy else inf
    ax, ay = 4 * lane, (2 * slots - 1) * ROW + 4 * col
    xi, yj = mem[ax], mem[ay]
    c = ax + ay
    x_end, y_end = ax + k * ROW, ay - k * ROW
    hi = lo = c
    steps, needed = 0, None
    for _ in range(0, 2 * k, UNROLL):
        for _ in range(UNROLL):
            take_x, take_y = xi <= yj, yj <= xi
            if take_x:
                xi, ax = mem[ax + ROW], ax + ROW
            if take_y:
                yj, ay = mem[ay - ROW], ay - ROW
            hi, lo = max(hi, ax + ay), min(lo, ax + ay)
            steps += 1
            if needed is None and (ax >= x_end or ay <= y_end):
                needed = steps
        if ax >= x_end or ay <= y_end:
            break
    return max(hi - c, c - lo) // ROW, steps, needed


def ks_global_walk(x, y):
    """ks_kernel<false> on one pair (ks_walk_global): 2K steps, each taking
    the smaller head (x on a tie), |i - j| entered where the next head is
    larger than the value taken; the largest gap."""
    k = len(x)
    inf = F32(np.inf)

    def at(row, i):
        return F32(row[i]) if i < k else inf

    i = j = best = 0
    xi, yj = at(x, 0), at(y, 0)
    for _ in range(2 * k):
        take_x = xi <= yj
        v = xi if take_x else yj
        if take_x:
            i += 1
            xi = at(x, i)
        else:
            j += 1
            yj = at(y, j)
        if min(xi, yj) != v:
            best = max(best, abs(i - j))
    return best


def _emulate(X, Y, walk):
    """[M, N] float32 of walk's gaps / K, rows sorted as the wrapper sorts
    them (the CPU's true division, as ks_merge_reference's)."""
    xs, ys = np.sort(X, axis=1), np.sort(Y, axis=1)
    gaps = [[walk(a, b) for b in ys] for a in xs]
    gaps = [[g[0] if isinstance(g, tuple) else g for g in row]
            for row in gaps]
    return torch.tensor(gaps, dtype=torch.int64).to(torch.float32) / X.shape[1]


# values on a coarse grid, so that rows tie within and across themselves,
# and at a row's maximum
_GRID = st.sampled_from([0.0, 0.0, 0.0625, 0.125, 0.25, 0.5, 1.0, 3.0])


@st.composite
def _rows(draw):
    k = draw(st.one_of(st.just(1), st.integers(1, 3 * UNROLL + 5)))
    m, n = draw(st.integers(1, 3)), draw(st.integers(1, 3))
    vals = st.lists(_GRID, min_size=k, max_size=k)
    X = np.array([draw(vals) for _ in range(m)], F32)
    Y = np.array([draw(vals) for _ in range(n)], F32)
    if draw(st.booleans()):        # an equal pair
        Y[draw(st.integers(0, n - 1))] = X[draw(st.integers(0, m - 1))]
    if draw(st.booleans()):        # x's maximum into a run of y's
        top = np.float32(draw(_GRID))
        X[0] = np.minimum(X[0], top)
        X[0, -1] = top
        Y[0, :draw(st.integers(1, k))] = top
    flip = np.array(draw(st.lists(st.booleans(), min_size=m * k,
                                  max_size=m * k))).reshape(m, k)
    X = np.where(flip & (X == 0), np.float32(-0.0), X)
    return X, Y


@settings(max_examples=80, deadline=None, database=None)
@given(xy=_rows())
def test_ks_walks_equal_the_merge_and_jax(xy):
    """Both walks of the kernel, emulated, give ks_merge_reference's
    statistic bit for bit, the port's plain ks too, and JAX's within
    1e-6; the shared walk stops within kKsUnroll - 1 steps of a row's
    exhaustion."""
    X, Y = xy
    want = cp.ks_merge_reference(_t(X), _t(Y))
    shared = _emulate(X, Y, ks_shared_walk)
    assert torch.equal(shared, want)
    assert torch.equal(_emulate(X, Y, ks_global_walk), want)
    assert torch.equal(shared, distances.ks(_t(X), _t(Y)))
    np.testing.assert_allclose(shared.numpy(),
                               np.asarray(jax_distances.ks(X, Y)),
                               rtol=0, atol=1e-6)
    for a in np.sort(X, axis=1):
        for b in np.sort(Y, axis=1):
            _, steps, needed = ks_shared_walk(a, b)
            assert needed is not None and needed <= 2 * len(a)
            assert needed <= steps <= needed + UNROLL - 1


@pytest.mark.parametrize("k", [8, 37, 100])
def test_ks_end_rows(k):
    """chip_smoke.ks_end_rows: x's maximum tied into a run of y where x
    ends, the mirror, equal rows, equal maxima in runs of both, -0.0
    against +0.0, an untied end; every pair of the two sets."""
    X, Y = chip_smoke.ks_end_rows(k)
    want = cp.ks_merge_reference(_t(X), _t(Y))
    assert torch.equal(_emulate(X, Y, ks_shared_walk), want)
    assert torch.equal(_emulate(X, Y, ks_global_walk), want)
    np.testing.assert_allclose(want.numpy(),
                               np.asarray(jax_distances.ks(X, Y)),
                               rtol=0, atol=1e-6)
    # the first three pairs by hand: the largest gap is at 0.1, before
    # y's run of 0.5, k - 1 - k // 2
    gap = torch.tensor(k - 1 - k // 2, dtype=torch.float32) / k
    assert want[0, 0] == gap and want[1, 1] == gap and want[2, 2] == 0


def test_ks_walk_of_nan_rows_stays_in_its_rows():
    """A NaN is staged as +inf: the walk ends and reads no slot outside
    its rows' kKsUnroll slots of padding (the emulation's memory holds
    only the staged slots and raises on any other address)."""
    x = np.array([0.1, np.nan, np.nan, 0.2], F32)
    y = np.array([np.nan, 0.3, 0.3, np.inf], F32)
    for a, b in ((x, y), (y, x), (x, x), (np.sort(x), np.sort(y))):
        gap, steps, _ = ks_shared_walk(a, b)
        assert 0 <= gap <= len(a) and steps <= 2 * len(a) + UNROLL - 1


@settings(max_examples=40, deadline=None, database=None)
@given(xy=_rows())
def test_ks_merge_steps_counts_the_walks(xy):
    """chip_smoke.ks_merge_steps, the steps behind the bound, is the sum
    over the pairs of the steps after which a row is exhausted."""
    X, Y = xy
    need = sum(ks_shared_walk(a, b)[2] for a in np.sort(X, axis=1)
               for b in np.sort(Y, axis=1))
    assert chip_smoke.ks_merge_steps(torch, _t(X), _t(Y)) == need


def test_ks_merge_steps_on_dirichlet_rows():
    """On chip_smoke.py's Dirichlet(0.1) rows the walks end before 2K
    steps (ties at 0 taken in pairs, the walk ended at a row's end), and
    ks_merge_steps agrees with the emulated walks."""
    X = chip_smoke.pairwise_rows(9, 100, 1)
    Y = chip_smoke.pairwise_rows(7, 100, 2)
    need = [ks_shared_walk(a, b)[2] for a in np.sort(X, axis=1)
            for b in np.sort(Y, axis=1)]
    assert chip_smoke.ks_merge_steps(torch, _t(X), _t(Y)) == sum(need)
    assert 100 < min(need) and max(need) <= 200 and sum(need) < 200 * 63
    assert torch.equal(_emulate(X, Y, ks_shared_walk),
                       cp.ks_merge_reference(_t(X), _t(Y)))


# ---------------------------------------------------------------------------
# uber: the division and the scaled sums
# ---------------------------------------------------------------------------

def _scaled_operands(x, y):
    xs, ys = x * cp.UBER_SCALE, y * cp.UBER_SCALE
    return (xs - ys).abs(), (xs.abs() + ys.abs()).clamp_min(cp.DEN_FLOOR)


# tame values: zeros of both signs, denormals, tiny, ordinary, up to 2^32
_TAME = st.one_of(
    st.sampled_from([0.0, -0.0, 1e-45, 3e-45, 1.1754942e-38, 1.0,
                     2.0 ** 32, -(2.0 ** 32)]),
    st.floats(-(2.0 ** 32), 2.0 ** 32, width=32, allow_nan=False),
    st.floats(-(2.0 ** -100), 2.0 ** -100, width=32, allow_nan=False))


@settings(max_examples=60, deadline=None, database=None)
@given(v=st.lists(st.tuples(_TAME, _TAME), min_size=1, max_size=64),
       ulps=st.sampled_from([-1, 0, 1]))
def test_division_on_scaled_operands_is_ieee(v, ulps):
    """div_rn_scaled on uber's scaled operands gives the IEEE quotient
    |x - y| / (|x| + |y|) (0 where both are 0), with the reciprocal
    rounded to nearest or an ulp below or above it."""
    x = torch.tensor([a for a, _ in v], dtype=torch.float32)
    y = torch.tensor([b for _, b in v], dtype=torch.float32)
    a, b = _scaled_operands(x, y)
    seed = (1.0 / b.double()).float()
    if ulps:
        seed = torch.nextafter(seed, torch.full_like(seed, ulps * np.inf))
    got = cp.division_reference(a, b, seed)
    den = x.abs() + y.abs()
    want = torch.where(den == 0, 0.0, (x - y).abs() / den)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_division_check_reference_on_the_check_rows():
    """division_check_reference counts every term of chip_smoke.py's
    Dirichlet rows, with denormals put in, and finds none that differs;
    a value beyond 2^32 or a NaN is not counted."""
    X = chip_smoke.pairwise_rows(40, 100, 1)
    Y = chip_smoke.pairwise_rows(30, 100, 2)
    X[2, :4] = np.array([1e-45, 3e-44, 1e-40, 0.0], F32)
    Y[3, :4] = np.array([1e-45, 0.0, 2e-40, 1e-38], F32)
    assert cp.division_check(_t(X), _t(Y)).tolist() == [40 * 30 * 100, 0]
    Xw = X.copy()
    Xw[0, 0], Xw[1, 1] = 2.0 ** 40, np.nan
    assert cp.division_check(_t(Xw), _t(Y)).tolist() == [
        40 * 30 * 100 - 2 * 30, 0]


def _two_level(t):
    """csrc/pairwise.cu's sum over the last axis: chunks of 32 summed in
    order into a fresh partial, each partial added to the total."""
    k = t.shape[-1]
    total = np.zeros(t.shape[:-1], F32)
    for c in range(0, k, 32):
        part = np.zeros(t.shape[:-1], F32)
        for kk in range(c, min(c + 32, k)):
            part = (part + t[..., kk]).astype(F32)
        total = (total + part).astype(F32)
    return total


def _uber_parts(X, Y, scale):
    """uber's four elementwise parts as uber_kernel computes them with
    the values times `scale`: canberra, chebychev and manhattan times
    1 / scale, and inter / union (jaccard's ratio)."""
    x = (X[:, None, :] * F32(scale)).astype(F32)
    y = (Y[None, :, :] * F32(scale)).astype(F32)
    d = np.abs(x - y).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        den = (np.abs(x) + np.abs(y)).astype(F32)
        can = _two_level(np.where(den == 0, F32(0), d / den).astype(F32))
        inter = _two_level(np.minimum(x, y))
        union = _two_level(np.maximum(x, y))
        ratio = (inter / union).astype(F32)
    inv = F32(1.0 / scale)
    return (can, (d.max(-1) * inv).astype(F32),
            (_two_level(d) * inv).astype(F32), inter > 0, ratio)


@pytest.mark.parametrize("k", [37, 100, 300])
def test_scaled_sums_equal_the_unscaled(k):
    """The scaled path's parts equal the unscaled path's bit for bit on
    rows with denormals and exact zeros, so uber's result does not
    depend on which path a block takes."""
    rng = np.random.default_rng(k)
    X = chip_smoke.pairwise_rows(6, k, 3)
    Y = chip_smoke.pairwise_rows(5, k, 4)
    X[0, :3] = np.array([1e-45, 7e-44, 2e-39], F32)
    Y[0, :3] = np.array([3e-45, 7e-44, 0.0], F32)
    X[1] = (rng.random(k) * 2.0 ** 30).astype(F32)
    for got, want in zip(_uber_parts(X, Y, 2.0 ** 64),
                         _uber_parts(X, Y, 1.0)):
        if got.dtype == F32:
            got, want = got.view(np.int32), want.view(np.int32)
        assert np.array_equal(got, want)


def test_division_check_off_the_cpu_launches_or_raises(monkeypatch):
    """Off the CPU (meta tensors stand in for the card) the division check
    calls its entry point, raises on the CUDA error it returns and counts
    no launch; an empty M gives zeros with no call."""
    from ldagroupedgibbssampler_tpu_torch.ops import _build

    class FailingLibrary:
        def __getattr__(self, name):
            return lambda *args: 700        # cudaErrorIllegalAddress
    monkeypatch.setattr(_build, "library", lambda: FailingLibrary())
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    X = torch.empty((3, 5), device="meta")
    Y = torch.empty((4, 5), device="meta")
    before = cp.division_check.launches
    with pytest.raises(RuntimeError,
                       match="lda_pairwise_division_check failed"):
        cp.division_check(X, Y)
    assert cp.division_check.launches == before
    assert cp.division_check(X[:0], Y).shape == (2,)
    assert cp.division_check.launches == before
