"""The redesigned `js` and `canberra` instances of csrc/pairwise.cu's
`pairwise_kernel`, their arithmetic emulated on the CPU.

js: on a block whose values are all finite, >= 0 and at most 2^32 the
kernel sums the closed form A / (8 ln 2) + B / 8, A = sum over x > 0 and
y > 0 of (x - y)(lx - ly) (the row logs), B = sum over the rest of x + y,
with staged masks [v > 0] and [v == 0]: dm = fma([y > 0], x, -[x > 0] y),
A = fma(dm, lx - ly, A), B = fma([x == 0], y, fma([y == 0], x, B)), in
chunks of 32 summed into fresh partials, then fma(A, 1 / (8 ln 2), B / 8).
`js_closed_emulation` repeats that operation by operation (each fused
multiply-add rounded once, `cuda_pairwise.fma_f32`) and is held to the
JAX package's `js` on normal values and to the port's plain `js` (the
tiles) with subnormal values too; on grid values by hypothesis (zeros,
ties, x = y, all-zero rows, K = 1, K that no chunk divides). A block with
a negative value, a NaN, an inf or a value above 2^32 keeps the general term:
`block_emulation` picks per 64 x 64 block as the kernel does, and such a
block equals `kernel_emulation("js")` of tests/test_torch_pairwise_kernel.py
bit for bit. The subnormal divergence is pinned: XLA on the CPU flushes
subnormal inputs, so JAX's js differs from the plain version on an
all-subnormal row, where the plain version equals the closed form.

canberra: a tame block (every |v| <= 2^32, no NaN) stages its values
times 2^64 and divides by `div_rn_scaled`; the quotients
(`cuda_pairwise.division_reference` on the scaled operands) equal the IEEE
ones bit for bit, so its sums equal `kernel_emulation("canberra")` bit for
bit on tame blocks and on blocks off the path alike.

Tolerances: the emulations against JAX and the plain version within rtol
1e-5 / atol 1e-5 (PAIRWISE_TOL of chip_smoke.py; sums in another order,
the plain version's logs of the average); the block choice, the
quotients and canberra's sums exact."""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import test_torch_pairwise_kernel as tk
from ldagroupedgibbssampler_tpu.similarity import distances as jax_distances
from ldagroupedgibbssampler_tpu_torch.ops import cuda_pairwise as cp
from ldagroupedgibbssampler_tpu_torch.similarity import distances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "ldagroupedgibbssampler_tpu_torch", "csrc",
                      "pairwise.cu")
F32 = np.float32
CHUNK = 32
TILE = 64
TOL = chip_smoke.PAIRWISE_TOL
# csrc/pairwise.cu's kInvJs (the f32 reciprocal of 4 ln 2), halved
INV_8LN2 = F32(0.5) * (F32(1) / F32(2.772588722239781))


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a, F32))


# ---------------------------------------------------------------------------
# js: the closed form, emulated
# ---------------------------------------------------------------------------

def js_closed_emulation(X, Y):
    """The closed-form js of every pair in float32, as the kernel computes
    it (rows with values finite, >= 0 and within 2^32)."""
    x = _t(X)[:, None, :]
    y = _t(Y)[None, :, :]
    k = x.shape[-1]
    pad = -k % CHUNK

    def staged(v):
        v = torch.nn.functional.pad(v, (0, pad))
        log = torch.where(v > 0, v, 1.0).log()
        return v, log, (v > 0).float(), (v == 0).float()
    x, lx, px, zx = staged(x)
    y, ly, py, zy = staged(y)
    shape = (x.shape[0], y.shape[1])
    A, B = torch.zeros(shape), torch.zeros(shape)
    for c in range(0, k + pad, CHUNK):
        pa, pb = torch.zeros(shape), torch.zeros(shape)
        for kk in range(c, c + CHUNK):
            xs, ys = x[..., kk], y[..., kk]
            dm = cp.fma_f32(py[..., kk], xs, -(px[..., kk] * ys))
            pa = cp.fma_f32(dm, lx[..., kk] - ly[..., kk], pa)
            pb = cp.fma_f32(zx[..., kk], ys, cp.fma_f32(zy[..., kk], xs, pb))
        A, B = A + pa, B + pb
    return cp.fma_f32(A, torch.tensor(INV_8LN2), B * 0.125).numpy()


def _tame_js(v):
    return np.all((v >= 0) & (v <= 2.0 ** 32), axis=1)


def block_emulation(X, Y):
    """js as the kernel computes it: each 64 x 64 block of pairs by the
    closed form where all its X and Y rows are tame, else by the general term
    (tests/test_torch_pairwise_kernel.py's kernel_emulation)."""
    out = np.empty((X.shape[0], Y.shape[0]), F32)
    tx, ty = _tame_js(X), _tame_js(Y)
    for m0 in range(0, X.shape[0], TILE):
        for n0 in range(0, Y.shape[0], TILE):
            xb, yb = X[m0:m0 + TILE], Y[n0:n0 + TILE]
            closed = tx[m0:m0 + TILE].all() and ty[n0:n0 + TILE].all()
            with np.errstate(invalid="ignore"):
                out[m0:m0 + TILE, n0:n0 + TILE] = (
                    js_closed_emulation(xb, yb) if closed
                    else tk.kernel_emulation("js", xb, yb))
    return out


def _probs(shape_seed, m, k):
    return tk._probs(np.random.default_rng(shape_seed), m, k).astype(F32)


@pytest.mark.parametrize("m,n,k", [(7, 9, 12), (5, 6, 37), (4, 3, 70),
                                   (3, 5, 100), (6, 4, 1), (3, 4, 300)])
def test_closed_form_equals_jax_and_the_plain_version(m, n, k):
    """On probability rows with exact zeros (tests/test_torch_pairwise_
    kernel.py's) the closed form is within 1e-5 of JAX's js and of the
    port's plain js, across one, two and ten chunks and K = 1."""
    if k == 1:
        X = np.array([[1.0], [0.0], [1.0], [0.0], [1.0], [0.0]], F32)
        Y = np.array([[1.0], [0.0], [0.0], [1.0]], F32)
    else:
        X, Y = _probs(k, m, k), _probs(k + 1, n, k)
    got = js_closed_emulation(X, Y)
    np.testing.assert_allclose(got, np.asarray(jax_distances.js(X, Y)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, distances.js(_t(X), _t(Y)).numpy(),
                               rtol=TOL, atol=TOL)


def test_closed_form_on_chip_smoke_rows_with_subnormal_values():
    """chip_smoke.py's Dirichlet(0.1) rows, then subnormal values put in
    (and a row holding only subnormal values): the closed form against
    the plain version; against JAX where no row holds a subnormal value."""
    X = chip_smoke.pairwise_rows(12, 100, 1)
    Y = chip_smoke.pairwise_rows(9, 100, 2)
    np.testing.assert_allclose(js_closed_emulation(X, Y),
                               np.asarray(jax_distances.js(X, Y)),
                               rtol=TOL, atol=TOL)
    X[3, :4] = np.array([1e-40, 3e-39, 1e-45, 0.0], F32)
    Y[5, 4:8] = np.array([2e-40, 0.0, 1e-44, 5e-39], F32)
    X[7] = 0.0
    X[7, 1:5] = np.array([1e-40, 2e-40, 3e-39, 5e-41], F32)
    np.testing.assert_allclose(js_closed_emulation(X, Y),
                               distances.js(_t(X), _t(Y)).numpy(),
                               rtol=TOL, atol=TOL)


# values on a coarse grid, so that rows tie within and across themselves
_GRID = st.sampled_from([0.0, 0.0, 0.0, 0.0625, 0.125, 0.25, 0.5, 1.0, 3.0])


@st.composite
def _grid_rows(draw):
    k = draw(st.one_of(st.just(1), st.integers(1, 2 * CHUNK + 7)))
    m, n = draw(st.integers(1, 4)), draw(st.integers(1, 4))
    vals = st.lists(_GRID, min_size=k, max_size=k)
    X = np.array([draw(vals) for _ in range(m)], F32)
    Y = np.array([draw(vals) for _ in range(n)], F32)
    if draw(st.booleans()):                     # an equal pair
        Y[draw(st.integers(0, n - 1))] = X[draw(st.integers(0, m - 1))]
    if draw(st.booleans()):                     # an all-zero row
        X[draw(st.integers(0, m - 1))] = 0.0
    return X, Y


@settings(max_examples=60, deadline=None, database=None)
@given(xy=_grid_rows())
def test_closed_form_on_grid_values(xy):
    """Zeros, ties, equal rows (exactly 0), all-zero rows (0 against an
    all-zero row, B / 8 against another), K = 1 and K that no chunk
    divides: the closed form within 1e-5 of the plain version and of
    JAX's js."""
    X, Y = xy
    got = js_closed_emulation(X, Y)
    np.testing.assert_allclose(got, distances.js(_t(X), _t(Y)).numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(jax_distances.js(X, Y)),
                               rtol=TOL, atol=TOL)
    for i, a in enumerate(X):
        for j, b in enumerate(Y):
            if np.array_equal(a, b):
                assert got[i, j] == 0.0
            if not a.any() and not b.any():
                assert got[i, j] == 0.0


@pytest.mark.parametrize("bad", [-0.25, np.nan, np.inf, 2.0 ** 40])
def test_a_block_off_the_closed_form_keeps_the_general_term(bad):
    """A value that is negative, NaN, inf or above 2^32 in X's row 3 sends
    the blocks of X's first 64 rows to the general term: they equal
    kernel_emulation("js") bit for bit, the blocks of rows 64-69 the
    closed form; both agree with the plain version (NaN where it has
    NaN)."""
    X, Y = _probs(3, 70, 40), _probs(4, 66, 40)
    X[3, 5] = bad
    got = block_emulation(X, Y)
    with np.errstate(invalid="ignore"):
        general = tk.kernel_emulation("js", X[:TILE], Y)
    np.testing.assert_array_equal(got[:TILE], general)
    np.testing.assert_array_equal(got[TILE:], js_closed_emulation(X[TILE:],
                                                                  Y))
    np.testing.assert_allclose(got, distances.js(_t(X), _t(Y)).numpy(),
                               rtol=TOL, atol=TOL, equal_nan=True)


def test_off_path_rows_of_chip_smoke():
    """chip_smoke.pairwise_off_path_rows, the card's check of both paths:
    the blocks of X's first 64 rows off the closed form, the others on it
    with subnormal values; the kernel's arithmetic within 1e-5 of the
    plain version there, NaN where it has NaN (the inf row)."""
    X, Y = chip_smoke.pairwise_off_path_rows(
        chip_smoke.pairwise_rows(130, 37, 1),
        chip_smoke.pairwise_rows(75, 37, 2))
    assert not _tame_js(X[:TILE]).all() and _tame_js(X[TILE:]).all()
    assert _tame_js(Y).all()
    got = block_emulation(X, Y)
    want = distances.js(_t(X), _t(Y)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1]).all() and np.isfinite(np.delete(want, 1, 0)).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, equal_nan=True)
    assert got[101].max() > 10.0          # the all-subnormal row


def test_subnormal_divergence_from_jax_is_pinned():
    """XLA on the CPU treats a subnormal float32 input as 0, so on a row
    holding only subnormal values JAX's js differs from the plain version
    by ~16; the plain version (PyTorch keeps subnormal values) equals the
    closed form, and JAX agrees with both on the rows without them."""
    X = chip_smoke.pairwise_rows(3, 12, 1)
    Y = chip_smoke.pairwise_rows(4, 12, 2)
    X[1] = 0.0
    X[1, :4] = np.array([1e-40, 2e-40, 3e-39, 5e-41], F32)
    plain = distances.js(_t(X), _t(Y)).numpy()
    jax = np.asarray(jax_distances.js(X, Y))
    assert np.abs(jax[1] - plain[1]).max() > 10.0
    np.testing.assert_allclose(jax[[0, 2]], plain[[0, 2]], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(js_closed_emulation(X, Y), plain, rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# canberra: the scaled division
# ---------------------------------------------------------------------------

def _canberra_rows():
    """chip_smoke.py's rows with subnormal, negative and large values within
    2^32, and one row with a value beyond (off the scaled path)."""
    X = chip_smoke.pairwise_rows(6, 37, 5)
    Y = chip_smoke.pairwise_rows(5, 37, 6)
    X[0, :4] = np.array([1e-45, 7e-44, -2e-39, -0.5], F32)
    Y[0, :4] = np.array([3e-45, 7e-44, 0.0, 2e-39], F32)
    X[1, :3] = np.array([2.0 ** 32, -(2.0 ** 31), 3e9], F32)
    X[2, 5] = 2.0 ** 40
    return X, Y


def test_canberra_scaled_quotients_equal_the_ieee_ones():
    """On canberra's operands the scaled division (values times 2^64,
    |x| + |y| raised to 2^-100, division_reference) gives the IEEE
    quotient |x - y| / (|x| + |y|) (0 where both are 0) on every term
    whose values are within 2^32; division_check_reference counts them
    all and finds none that differs."""
    X, Y = _canberra_rows()
    x, y = _t(X)[:, None, :], _t(Y)[None]
    tame = (x.abs() <= cp.TAME_MAX) & (y.abs() <= cp.TAME_MAX)
    xs, ys = x * cp.UBER_SCALE, y * cp.UBER_SCALE
    got = cp.division_reference((xs - ys).abs(),
                                (xs.abs() + ys.abs()).clamp_min(cp.DEN_FLOOR))
    den = x.abs() + y.abs()
    want = torch.where(den == 0, 0.0, (x - y).abs() / den)
    assert torch.equal(got[tame].view(torch.int32),
                       want[tame].view(torch.int32))
    assert cp.division_check(_t(X), _t(Y)).tolist() == [int(tame.sum()), 0]
    assert int(tame.sum()) == 6 * 5 * 37 - 5


def test_canberra_sums_equal_the_parent_on_both_paths():
    """canberra's kernel sums: where every value of the block is within
    2^32 the scaled quotients, else the IEEE ones, in the parent's order;
    equal to kernel_emulation("canberra") bit for bit either way."""
    X, Y = _canberra_rows()
    x, y = _t(X)[:, None, :], _t(Y)[None]
    want = tk.kernel_emulation("canberra", X, Y)
    for scaled in (True, False):
        if scaled:
            keep = (np.abs(X) <= cp.TAME_MAX).all(axis=1)
            xs, ys = x[keep] * cp.UBER_SCALE, y * cp.UBER_SCALE
            q = cp.division_reference(
                (xs - ys).abs(), (xs.abs() + ys.abs()).clamp_min(cp.DEN_FLOOR))
            got = tk._chunked_sum(q.numpy())
            assert np.array_equal(got.view(np.int32),
                                  want[keep].view(np.int32))
        else:
            den = x.abs() + y.abs()
            q = torch.where(den == 0, 0.0, (x - y).abs() / den)
            got = tk._chunked_sum(q.numpy())
            assert np.array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# the source's constants and chip_smoke.py's bounds
# ---------------------------------------------------------------------------

def test_js_shared_memory_and_bounds():
    """js's eight staged arrays are the dynamic shared memory the launch
    asks for, and two blocks of them fit an SM; chip_smoke.py counts the
    closed form's 7 operations a term and no special-function call (the
    row logs once), beside the parent's 12 and a logf a term."""
    text = open(SOURCE, encoding="utf-8").read()
    const = dict(re.findall(r"constexpr int (kTile|kChunk) = (\d+);", text))
    staged = int(const["kChunk"]) * (int(const["kTile"]) + 4)
    assert "constexpr int kJsSharedBytes = 8 * kStaged * 4;" in text
    assert 2 * 8 * staged * 4 <= 232_448 and 8 * staged * 4 > 48 * 1024
    assert chip_smoke.PAIRWISE_OPS["js"] == (7, 0)
    m, n, k = chip_smoke.PAIRWISE_TEST, chip_smoke.PAIRWISE_TRAIN, 100
    new, by = chip_smoke.pairwise_bound("js", m, n, k)
    old = chip_smoke.pairwise_bound("js", m, n, k,
                                    ops=chip_smoke.JS_OPS_LOGF)[0]
    assert by == "operations"
    assert new == pytest.approx(7 * m * n * k / chip_smoke.F32_OPS_PER_S
                                * 1e3)
    assert old == pytest.approx(m * n * k / chip_smoke.SFU_OPS_PER_S * 1e3)
    assert round(old, 4) == 0.7592 and new < old / 2
