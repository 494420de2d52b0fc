"""The fused Gamma / Dirichlet kernels' plain versions on the CPU
(ops/cuda_gamma.py): they draw the words of ops/philox.py (one element
recomputed by hand), follow Gamma(a) by KS at the shapes of the card's
check, keep the exact 0 at a = 0 and the Dirichlet floor, normalise on
both axes, agree in distribution with the generator path of the CPU and
in moments with the JAX package's `_gamma_marsaglia`; the CPU draws of
ops/random.py are unchanged; the wrappers take the kernel for a tensor off
the CPU and raise when its build or launch fails; the kernels' tiles and
their compacted retries (round 0 for every element, the later rounds over
a queue of rejects) give every element the plain version's draw."""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from ldagroupedgibbssampler_tpu.ops import random as jax_rnd
from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_gamma
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10

SHAPES = (1e-3, 0.01, 0.1, 0.5, 1.0, 2.5, 100.0, 1e4)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(v):
    return torch.tensor([v], dtype=torch.int64)


def _unit23(w):
    return np.float32((np.float32(w >> 9) + np.float32(0.5))
                      * np.float32(2.0 ** -23))


@pytest.mark.parametrize("a,i", [(2.5, 7), (0.3, 123), (40.0, 4)])
def test_reference_draws_the_philox_words_by_hand(a, i):
    """Element i recomputed in numpy float32 from philox4x32_10 at
    counters 8 i + r (the rounds) and 8 i + 6 (the boost): the same
    accepted round and the same value (rtol 1e-6: numpy's and torch's
    float32 log / cos / exp may differ in the last bit)."""
    seed = 0x0123_4567_89AB_CDEF
    g, rounds = cuda_gamma.gamma_reference(
        torch.full((i + 1,), a), _seed(seed), return_rounds=True)
    f = np.float32
    a32 = f(a)
    d = (a32 + f(1) if a32 < 1 else a32) - f(1 / 3)
    c = f(1) / np.sqrt(f(9) * d)

    def words(ctr):
        t = torch.tensor([ctr], dtype=torch.int64)
        return [int(w) for w in philox4x32_10(
            t, t >> 32, torch.tensor([seed & 0xFFFFFFFF]),
            torch.tensor([seed >> 32]))]
    out, acc = d, 6
    for r in range(6):
        w = words(8 * i + r)
        x = f(np.sqrt(f(-2) * np.log(_unit23(w[0])))
              * np.cos(f(2 * np.pi) * _unit23(w[1])))
        v1 = f(1) + c * x
        v = v1 * v1 * v1
        if v > 0 and np.log(_unit23(w[2])) < (f(0.5) * x * x + d - d * v
                                               + d * np.log(v)):
            out, acc = d * v, r
            break
    if a32 < 1:
        out = out * np.exp(np.log(_unit23(words(8 * i + 6)[0])) / a32)
    assert int(rounds[i]) == acc
    assert float(g[i]) == pytest.approx(float(out), rel=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_follows_gamma_by_ks(shape):
    """KS of 20,000 draws against scipy.stats.gamma; below shape 0.1, as
    tests/test_torch_random.py does, conditioned on draws above 1e-30
    (float32 flushes the rest to 0 or to denormals)."""
    draws = cuda_gamma.gamma_reference(torch.full((20_000,), shape),
                                       _seed(11)).double().numpy()
    eps = 1e-30 if shape < 0.1 else 0.0
    kept = draws[draws > eps]
    assert len(kept) > 1000
    f_eps = stats.gamma.cdf(eps, shape)
    ks = stats.kstest(kept, lambda x: (stats.gamma.cdf(x, shape) - f_eps)
                      / (1.0 - f_eps))
    assert ks.pvalue > 1e-3, (shape, ks)


def test_reference_exact_zero_floor_and_rows_sum_to_one_on_both_axes():
    """a = 0 draws exactly 0; the Dirichlet floors such coordinates at
    DIRICHLET_FLOOR before normalising; rows (dim -1) and columns (dim 0)
    sum to 1 within 1e-5, the counts-plus-prior form included."""
    assert cuda_gamma.DIRICHLET_FLOOR == rnd.DIRICHLET_FLOOR
    g = cuda_gamma.gamma_reference(torch.tensor([0.0] * 500 + [1.0]),
                                   _seed(3))
    assert (g[:500] == 0).all() and g[-1] > 0
    d = cuda_gamma.dirichlet_reference(torch.tensor([[0.0, 0.0, 5.0]]),
                                       _seed(4))
    assert torch.isfinite(d).all() and d[0, 2] > 0.99
    assert (d[0, :2] > 0).all() and d[0, 0] == d[0, 1]
    counts = torch.randint(0, 6, (300, 40), generator=torch.Generator()
                           .manual_seed(0), dtype=torch.int32)
    for dim in (-1, 0):
        for prior in (0.01, torch.linspace(0.1, 2.0, 40)):
            x = cuda_gamma.dirichlet_reference(counts, _seed(5), dim, prior)
            assert (x > 0).all()
            np.testing.assert_allclose(x.sum(dim).numpy(), 1.0, atol=1e-5)
            ref = cuda_gamma.dirichlet_reference(
                counts.to(torch.float32) + prior, _seed(5), dim)
            assert torch.equal(x, ref)


@pytest.mark.parametrize("shape", (0.05, 0.7, 3.0, 200.0))
def test_reference_agrees_with_the_generator_path_by_two_sample_ks(shape):
    """The kernel's words and the CPU generator path (ops/random.py) draw
    the same distribution: two-sample KS on 20,000 draws each."""
    ref = cuda_gamma.gamma_reference(torch.full((20_000,), shape),
                                     _seed(21)).double().numpy()
    gen = torch.Generator().manual_seed(21)
    cpu = rnd.gamma(torch.full((20_000,), shape), gen).double().numpy()
    ks = stats.ks_2samp(ref, cpu)
    assert ks.pvalue > 1e-3, (shape, ks)


def test_reference_moments_match_jax_gamma_marsaglia():
    """Mean and variance of 4 seeds x 20,000 draws at three shapes against
    the JAX package's `_gamma_marsaglia` over 4 keys, within 5 standard
    errors of the difference."""
    n = 20_000
    for shape in (0.2, 1.5, 30.0):
        ours = np.concatenate([cuda_gamma.gamma_reference(
            torch.full((n,), shape), _seed(s)).double().numpy()
            for s in range(4)])
        theirs = np.concatenate([np.asarray(jax_rnd._gamma_marsaglia(
            jax.random.key(s), np.full(n, shape, np.float32)),
            np.float64) for s in range(4)])
        se = np.sqrt(ours.var() / ours.size + theirs.var() / theirs.size)
        assert abs(ours.mean() - theirs.mean()) < 5 * se, shape
        # the variance's standard error from the fourth central moment
        m4 = ((theirs - theirs.mean()) ** 4).mean()
        se_v = np.sqrt(2 * (m4 - theirs.var() ** 2) / theirs.size)
        assert abs(ours.var() - theirs.var()) < 5 * se_v, shape


def test_cpu_draws_keep_the_generator_path():
    """On the CPU, dirichlet's counts-plus-prior and axis-0 forms draw
    exactly what the callers' former expressions drew from the same
    generator: counts.to(float32) + prior, a Gamma, the floor, the sum."""
    counts = torch.randint(0, 9, (50, 7), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32)
    alpha = torch.linspace(0.1, 1.0, 7)
    got = rnd.dirichlet(counts, torch.Generator().manual_seed(2),
                        prior=alpha)
    want = rnd.dirichlet(counts.to(torch.float32) + alpha,
                         torch.Generator().manual_seed(2))
    assert torch.equal(got, want)
    got = rnd.dirichlet(counts, torch.Generator().manual_seed(3), dim=0,
                        prior=0.01)
    g = rnd.gamma(counts.to(torch.float32) + 0.01,
                  torch.Generator().manual_seed(3)).clamp_min(
        rnd.DIRICHLET_FLOOR)
    assert torch.equal(got, g / g.sum(dim=0, keepdim=True))


def test_draws_off_the_cpu_go_to_the_kernel_wrappers(monkeypatch):
    """ops/random.py hands a tensor off the CPU to the kernel wrappers with
    a seed from the generator (meta tensors stand in for the card)."""
    calls = []
    monkeypatch.setattr(rnd, "kernel_seed", lambda gen, dev: torch.empty(
        1, dtype=torch.int64, device=dev))
    monkeypatch.setattr(cuda_gamma, "gamma", lambda a, seed: calls.append(
        ("gamma", a.device.type, seed.device.type)) or a)
    monkeypatch.setattr(cuda_gamma, "dirichlet",
                        lambda x, seed, dim, prior: calls.append(
                            ("dirichlet", dim, prior)) or x)
    a = torch.empty((4, 3), device="meta")
    rnd.gamma(a, None)
    rnd.dirichlet(a, None, dim=0, prior=0.5)
    rnd.beta(a, a, None)
    assert calls == [("gamma", "meta", "meta"), ("dirichlet", 0, 0.5),
                     ("gamma", "meta", "meta"), ("gamma", "meta", "meta")]


def test_wrappers_raise_when_the_build_or_the_launch_fails(monkeypatch,
                                                            tmp_path):
    """A tensor off the CPU launches the kernel or raises: with nvcc
    failing the build raises; with a library whose entry points return a
    CUDA error the launch raises; neither falls back to the plain
    version."""
    a = torch.empty((5, 4), device="meta")
    seed = torch.empty(1, dtype=torch.int64, device="meta")

    def no_nvcc():
        raise RuntimeError("nvcc failed (test)")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "libldakernels-test.so")
    _build.library.cache_clear()
    try:
        for call in (lambda: cuda_gamma.gamma(a, seed),
                     lambda: cuda_gamma.dirichlet(a, seed),
                     lambda: cuda_gamma.dirichlet(a, seed, 0, 0.1)):
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
    before = (cuda_gamma.gamma.launches, cuda_gamma.dirichlet.launches)
    for call, name in ((lambda: cuda_gamma.gamma(a, seed), "lda_gamma"),
                       (lambda: cuda_gamma.dirichlet(a, seed),
                        "lda_dirichlet_rows"),
                       (lambda: cuda_gamma.dirichlet(
                           a.to(torch.int32), seed, 0, 0.1),
                        "lda_dirichlet_cols")):
        with pytest.raises(RuntimeError, match=f"{name} failed"):
            call()
    assert (cuda_gamma.gamma.launches,
            cuda_gamma.dirichlet.launches) == before
    with pytest.raises(ValueError, match="last axis or axis 0"):
        cuda_gamma.dirichlet(torch.empty((2, 3, 4), device="meta"), seed, 1)


def _compacted_gamma(a, seed, tile):
    """The kernels' control flow over the plain version's rounds: each
    tile of `tile` elements runs round 0 on every element; the rejected
    ones go to a queue (in index order) and run rounds 1..5, one element
    a thread, until one accepts (the mode d where none does); then the
    boost. Each round's words and values are computed once for every
    element, as gamma_reference computes them."""
    flat = torch.as_tensor(a).to(torch.float32).reshape(-1)
    n = flat.numel()
    base = torch.arange(n, dtype=torch.int64) * cuda_gamma.BLOCKS_PER_ELEMENT
    d, c = cuda_gamma.mt_setup(flat)
    table = [cuda_gamma.mt_round(d, c, seed, base + r)
             for r in range(cuda_gamma.ROUNDS)]
    out = torch.empty(n)
    rounds = torch.full((n,), cuda_gamma.ROUNDS, dtype=torch.int32)
    for t0 in range(0, n, tile):
        idx = torch.arange(t0, min(t0 + tile, n))
        ok, g = table[0][0][idx], table[0][1][idx]
        out[idx[ok]] = g[ok]
        rounds[idx[ok]] = 0
        for i in idx[~ok].tolist():
            out[i] = d[i]
            for r in range(1, cuda_gamma.ROUNDS):
                if table[r][0][i]:
                    out[i], rounds[i] = table[r][1][i], r
                    break
    return cuda_gamma.mt_boost(flat, out, seed, base), rounds


@pytest.mark.parametrize("tile", [cuda_gamma.TILE, 300, 32])
def test_compacted_retries_return_the_plain_versions_draws(tile):
    """Round 0 for every element of a tile, the later rounds over its
    queue of rejects: every element gets gamma_reference's value and
    accepted round, at the grid of the card's check and at counts plus
    0.5 (the theta shapes), whatever the tile."""
    rng = np.random.default_rng(tile)
    a = torch.cat([torch.full((3000,), x) for x in
                   (0.0, 1e-3, 0.01, 0.1, 0.5, 1.0, 2.5, 100.0, 1e4)]
                  + [torch.as_tensor(rng.poisson(0.4, 6000)
                                     .astype(np.float32)) + 0.5])
    seed = _seed(0x5EED_1234_ABCD)
    want, want_rounds = cuda_gamma.gamma_reference(a, seed,
                                                   return_rounds=True)
    got, got_rounds = _compacted_gamma(a, seed, tile)
    assert torch.equal(got_rounds, want_rounds)
    assert torch.equal(got, want)
    assert (want_rounds > 0).any() and (want_rounds > 1).any()


def test_warp_rounds_before_and_after_compaction():
    """chip_smoke.gamma_warp_rounds: with one reject in every warp of 32,
    each warp runs two rounds without compaction, while the compacted
    queue gathers the rejects into one warp a tile (1 + 32 / 1024 lane-
    rounds an element at a tile of 1024); with no rejects all three are
    1; an element that rejects every round needs 6."""
    import chip_smoke
    rounds = torch.zeros(4096, dtype=torch.int32)
    assert chip_smoke.gamma_warp_rounds(torch, rounds, 1024) == [1.0, 1.0,
                                                                 1.0]
    rounds[::32] = 1
    need, before, after = chip_smoke.gamma_warp_rounds(torch, rounds, 1024)
    assert need == pytest.approx(1 + 1 / 32)
    assert before == pytest.approx(2.0)
    assert after == pytest.approx(1 + 32 / 1024)
    # element 5 rejects every round: its queue warp of the first tile runs
    # 5 more rounds, and that tile's 33rd reject takes a second warp
    rounds[5] = cuda_gamma.ROUNDS
    need, before, after = chip_smoke.gamma_warp_rounds(torch, rounds, 1024)
    assert before == pytest.approx(2.0 + 4 * 32 / 4096)
    assert after == pytest.approx(1 + (32 * (5 + 1) + 3 * 32) / 4096)


@pytest.mark.parametrize("rows,cols", [(20_000, 100), (20_000, 4096),
                                       (50, 7), (10 ** 7, 100)])
def test_tiles_hold_whole_rows_and_bounded_column_tiles(rows, cols):
    """The one-launch last-axis Dirichlet's tile holds whole rows within
    ROW_TILE elements (one row where a row is longer); the axis-0 tile is
    COL_TILE_COLS columns at most, holds at least COL_TILE[0] and at most
    COL_TILE[1] elements, and gives at most COL_TILES tiles down the rows
    where that fits."""
    tr = cuda_gamma.row_tile(cols)
    assert tr * cols <= max(cuda_gamma.ROW_TILE, cols)
    assert (tr + 1) * cols > cuda_gamma.ROW_TILE
    r, c = cuda_gamma.col_tile(rows, cols)
    assert c == min(cols, cuda_gamma.COL_TILE_COLS)
    assert cuda_gamma.COL_TILE[0] // c <= r <= cuda_gamma.COL_TILE[1] // c
    if r < cuda_gamma.COL_TILE[1] // c:
        assert -(-rows // r) <= cuda_gamma.COL_TILES


@pytest.mark.parametrize("rows,cols", [(1000, 4096), (37, 300), (50, 129),
                                       (20_000, 100), (64, 128)])
def test_column_tiles_cover_every_element_once(rows, cols):
    """The axis-0 Dirichlet's first launch as csrc/gamma.cu indexes it:
    block (row tile, column tile) takes slots e < rows of the tile x tc,
    slot e at row r0 + e // tc and column c0 + e % tc, with tc = C (whole
    rows) or COL_TILE_COLS (the last column tile's slots past C left
    empty). Every element of [R, C] is drawn by exactly one slot, and the
    prior's column is the element's column."""
    tr, tc = cuda_gamma.col_tile(rows, cols)
    assert tc in (cols, cuda_gamma.COL_TILE_COLS)
    flat, col = [], []
    for r0 in range(0, rows, tr):
        nrows = min(tr, rows - r0)
        for c0 in range(0, cols, tc):
            e = np.arange(nrows * tc)
            k = c0 + e % tc
            keep = k < min(c0 + tc, cols)
            flat.append(((r0 + e // tc) * cols + k)[keep])
            col.append(k[keep])
    flat, col = np.concatenate(flat), np.concatenate(col)
    assert np.array_equal(np.sort(flat), np.arange(rows * cols))
    assert np.array_equal(col, flat % cols)
