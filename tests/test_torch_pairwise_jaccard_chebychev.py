"""The `chebychev` and `jaccard` kernel of csrc/pairwise.cu
(`minmax_kernel`, which also runs `manhattan`: tests/
test_torch_pairwise_manhattan.py), its arithmetic emulated on the CPU.

NaN: the JAX package's `chebychev` (`jnp.max`) and `jaccard`
(`jnp.minimum` / `jnp.maximum` summed, then `where(inter > 0, 1 - inter /
union, 0)`) carry a NaN: chebychev is NaN wherever some |x - y| is, and a
NaN inter gives jaccard 0. The port's plain versions agree, on the rows of
the kernel's repair (a NaN in a row) and on chip_smoke.py's off-path and
inf-pair rows. The kernel takes max.NaN / min.NaN for that.

`minmax_emulation` repeats the kernel in float32 operation by operation:
chebychev the max of |x - y| (exact: a max is free of order); manhattan
the two-level sum of |x - y|; jaccard per
128 x 64 block: where every staged value of the block's rows is finite,
>= 0 and at most 2^32, inter = the two-level sum of the minima (chunks of
32 summed into fresh partials, the last chunk to K), Sx and Sy the rows'
two-level sums, union = (Sx + Sy) - inter; elsewhere inter and union both
two-level sums (NaN-propagating). Where a launch's tiles do not fill the
132 SMs, a cluster of up to 4 blocks splits each tile's chunks, and each
sum is the splits' totals added in rank order. It is held to the JAX
package within rtol = atol = 1e-5 at K = 12, 37, 70, 100 and 4096,
chebychev bit-equal to the plain version; without a split its inter is
bit-equal to the parent kernel's padded two-level sum (`kernel_emulation`
of tests/test_torch_pairwise_kernel.py, whose np.minimum / np.maximum
already carry NaN), with one within a few ulps and positive where that is;
a block with a negative value, a NaN, an inf or a value above 2^32 takes
the general path, equal to that emulation bit for bit without a split.
`minmax_launch_shape` covers every pair once, its chunks every coordinate
once, its splits every chunk once.

Tolerances: 1e-5 (chip_smoke.py's PAIRWISE_TOL: sums in another order,
the union from the rows' sums a few ulps of Sx + Sy off the sum of the
maxima); the rest exact."""

import collections
import os
import re
import types

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_pairwise_kernel as tk
from ldagroupedgibbssampler_tpu.similarity import distances as jax_distances
from ldagroupedgibbssampler_tpu_torch.ops import cuda_pairwise as cp
from ldagroupedgibbssampler_tpu_torch.similarity import distances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "ldagroupedgibbssampler_tpu_torch", "csrc",
                      "pairwise.cu")
F32 = np.float32
CHUNK = cp.MINMAX_CHUNK
TILE_M = 16 * cp.MINMAX_TM                    # a block's tile of pairs
TILE_N = 16 * cp.MINMAX_TN
TAME_MAX = F32(cp.TAME_MAX)
TOL = chip_smoke.PAIRWISE_TOL
# the rows of the kernel's NaN repair: x row 0 holds a NaN
NAN_X = np.array([[0.2, np.nan, 0.8], [0.5, 0.25, 0.25]], F32)
NAN_Y = np.array([[0.1, 0.3, 0.6], [0.3, 0.3, 0.4]], F32)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a, F32))


def two_level(t, splits=((0, None),)):
    """The kernel's two-level sum over the last axis: chunks of CHUNK, the
    last one to K, each summed in order into a fresh partial, each partial
    added to its split's total; the splits' totals (chunks [c0, c1) each)
    added in rank order (float32)."""
    k = t.shape[-1]
    out = None
    with np.errstate(invalid="ignore", over="ignore"):
        for c0, c1 in splits:
            total = np.zeros(t.shape[:-1], F32)
            end = k if c1 is None else min(c1 * CHUNK, k)
            for c in range(c0 * CHUNK, end, CHUNK):
                part = np.zeros(t.shape[:-1], F32)
                for kk in range(c, min(c + CHUNK, k)):
                    part = (part + t[..., kk]).astype(F32)
                total = (total + part).astype(F32)
            out = total if out is None else (out + total).astype(F32)
    return out


def _tame(rows) -> bool:
    return bool(np.all((rows >= 0) & (rows <= TAME_MAX)))


def block_paths(X, Y) -> dict:
    """{(m0, n0): "tame" or "general"}: the path jaccard's kernel takes on
    each block of TILE_M x TILE_N pairs."""
    return {(m0, n0): "tame" if _tame(X[m0:m0 + TILE_M])
            and _tame(Y[n0:n0 + TILE_N]) else "general"
            for m0 in range(0, X.shape[0], TILE_M)
            for n0 in range(0, Y.shape[0], TILE_N)}


def minmax_emulation(metric, X, Y, sms=cp.H100_SMS):
    """The kernel's manhattan, chebychev or jaccard of every pair in
    float32,
    operation by operation, with the K split of its launch on a card of
    `sms` SMs (minmax_launch_shape)."""
    X, Y = np.asarray(X, F32), np.asarray(Y, F32)
    x, y = X[:, None, :], Y[None, :, :]
    splits = cp.minmax_launch_shape(X.shape[0], Y.shape[0], X.shape[1],
                                    sms)["split_chunks"]
    with np.errstate(invalid="ignore", over="ignore"):
        if metric == "chebychev":
            return np.abs(x - y).astype(F32).max(-1)
        if metric == "manhattan":
            return two_level(np.abs(x - y).astype(F32), splits)
        inter = two_level(np.minimum(x, y), splits)
        union = np.empty_like(inter)
        sx, sy = two_level(X, splits), two_level(Y, splits)
        general = None
        for (m0, n0), path in block_paths(X, Y).items():
            blk = (slice(m0, m0 + TILE_M), slice(n0, n0 + TILE_N))
            if path == "tame":
                sxy = (sx[blk[0], None] + sy[None, blk[1]]).astype(F32)
                union[blk] = (sxy - inter[blk]).astype(F32)
            else:
                if general is None:
                    general = two_level(np.maximum(x, y), splits)
                union[blk] = general[blk]
        with np.errstate(divide="ignore"):
            ratio = (inter / union).astype(F32)
        return np.where(inter > 0, (F32(1) - ratio).astype(F32), F32(0))


def _probs(seed, m, k):
    return chip_smoke.pairwise_rows(m, k, seed)


def _jax(metric, X, Y):
    return np.asarray(jax_distances.DISTANCES[metric](X, Y))


def _plain(metric, X, Y):
    return distances.DISTANCES[metric](_t(X), _t(Y)).numpy()


def _same_nan_and_close(got, want, exact=False):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    if exact:
        np.testing.assert_array_equal(got[keep], want[keep])
    else:
        np.testing.assert_allclose(got[keep], want[keep], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# NaN and inf: the JAX package, the plain versions and the emulation agree
# ---------------------------------------------------------------------------

def test_a_nan_reaches_chebychev_and_zeroes_jaccard():
    """chebychev's row 0 is NaN and jaccard's 0 (a NaN inter fails inter >
    0) in the JAX package, the port's plain version and the kernel's
    emulation; row 1 agrees everywhere."""
    for impl in (_jax, _plain, minmax_emulation):
        cheb = impl("chebychev", NAN_X, NAN_Y)
        jac = impl("jaccard", NAN_X, NAN_Y)
        assert np.isnan(cheb[0]).all() and not np.isnan(cheb[1]).any()
        np.testing.assert_array_equal(jac[0], [0.0, 0.0])
    np.testing.assert_array_equal(
        minmax_emulation("chebychev", NAN_X, NAN_Y)[1],
        _plain("chebychev", NAN_X, NAN_Y)[1])
    np.testing.assert_allclose(minmax_emulation("jaccard", NAN_X, NAN_Y),
                               _jax("jaccard", NAN_X, NAN_Y), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("k", [12, 37])
@pytest.mark.parametrize("case", ["off path", "inf pair"])
def test_chip_smoke_nan_rows_agree(case, k):
    """On chip_smoke.py's off-path rows (a negative value, NaN, inf, 2^40,
    subnormal values) and inf-pair rows (|inf - inf| is NaN) the JAX
    package, the plain versions and the emulation agree: NaN at the same
    places, chebychev bit-equal to the plain version, jaccard within
    1e-5."""
    X, Y = chip_smoke.pairwise_nan_cases(_probs(1, 301, k),
                                         _probs(2, 203, k))[case]
    X, Y = X[:140], Y[:80]
    # x row 101 of the off-path rows holds only subnormal values, which
    # XLA on the CPU flushes (its inter 0, the plain version's > 0: the
    # divergence pinned in tests/test_torch_pairwise_js_canberra.py)
    keep = np.arange(len(X)) != (101 if case == "off path" else -1)
    for metric in ("chebychev", "jaccard", "manhattan"):
        jax_r, plain = _jax(metric, X, Y), _plain(metric, X, Y)
        emu = minmax_emulation(metric, X, Y)
        _same_nan_and_close(plain[keep], jax_r[keep])
        _same_nan_and_close(emu, plain, exact=metric == "chebychev")
    if case == "inf pair":
        assert np.isnan(_plain("chebychev", X, Y)[5, 9])
        assert np.isnan(_plain("jaccard", X, Y)[5, 9])
        assert np.isinf(_plain("chebychev", X, Y)[5, :9]).all()
    else:
        assert np.isnan(_plain("chebychev", X, Y)[0]).all()
        np.testing.assert_array_equal(_plain("jaccard", X, Y)[0], 0.0)


def test_mismatch_flags_a_kernel_that_drops_nan():
    """chip_smoke.pairwise_mismatch passes a result with NaN where the
    plain version has it and flags the parent kernel's (fmaxf and fminf
    skip a NaN: chebychev 0.2 and a nonzero jaccard on row 0)."""
    X, Y = NAN_X, NAN_Y
    want = distances.chebychev(_t(X), _t(Y))
    assert chip_smoke.pairwise_mismatch(torch, "chebychev", want.clone(),
                                        want) is None
    d = np.abs(X[:, None, :] - Y[None, :, :])
    dropped = torch.as_tensor(np.fmax.reduce(d, axis=-1))
    assert float(dropped[0, 0]) == pytest.approx(0.2)
    assert "NaN" in chip_smoke.pairwise_mismatch(torch, "chebychev",
                                                 dropped, want)
    inter = np.fmin(X[:, None, :], Y[None, :, :]).sum(-1)
    union = np.fmax(X[:, None, :], Y[None, :, :]).sum(-1)
    jac = torch.as_tensor(np.where(inter > 0, 1 - inter / union, 0),
                          dtype=torch.float32)
    assert float(jac[0, 0]) > 0.1
    assert "max |diff|" in chip_smoke.pairwise_mismatch(
        torch, "jaccard", jac, distances.jaccard(_t(X), _t(Y)))


def test_nan_report_is_empty_for_the_plain_versions():
    """pairwise_nan_report, the check that shows the parent's fault on the
    card, finds nothing on CPU tensors (the plain versions on both sides)
    and covers both metrics, both row sets and both K."""
    assert chip_smoke.pairwise_nan_report(torch, "cpu") == {}
    assert set(chip_smoke.PAIRWISE_NAN_METRICS) == {"chebychev", "jaccard",
                                                    "manhattan"}
    assert set(chip_smoke.PAIRWISE_NAN_METRICS) <= set(
        chip_smoke.PAIRWISE_REDESIGNED)


# ---------------------------------------------------------------------------
# the emulation against the JAX package and the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(7, 9, 12), (5, 6, 37), (4, 3, 70),
                                   (3, 5, 100), (5, 6, 4096),
                                   (140, 20, 37)])
def test_emulation_equals_jax_and_the_plain_version(m, n, k):
    """Dirichlet(0.1) rows with ~30% exact zeros: jaccard within 1e-5 of
    JAX and of the plain version, chebychev bit-equal to the plain
    version and within 1e-5 of JAX (every block tame)."""
    X, Y = _probs(m + k, m, k), _probs(n + k + 1, n, k)
    assert set(block_paths(X, Y).values()) == {"tame"}
    for metric in ("chebychev", "jaccard", "manhattan"):
        emu = minmax_emulation(metric, X, Y)
        np.testing.assert_allclose(emu, _jax(metric, X, Y), rtol=TOL,
                                   atol=TOL)
        if metric == "chebychev":
            np.testing.assert_array_equal(emu, _plain(metric, X, Y))
        else:
            np.testing.assert_allclose(emu, _plain(metric, X, Y), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("k", [12, 37, 70, 100, 4096])
def test_inter_equals_the_parents_padded_sum(k):
    """Without a K split, dropping the padded coordinates keeps inter
    bit-equal (zeros added to a partial change nothing), so inter > 0
    decides as before, and a general block equals the parent's emulation
    bit for bit. With the split these 4 x 5 pairs get on the card (up to
    4 blocks a tile), inter is the splits' totals added in rank order:
    within 1e-6 relative (the 128 partials at K = 4096 in another
    association), and on rows >= 0 inter > 0 decides the same (a sum of
    terms >= 0 is 0 only where all are)."""
    X, Y = _probs(k, 4, k), _probs(k + 1, 5, k)
    x, y = X[:, None, :], Y[None, :, :]
    np.testing.assert_array_equal(two_level(np.minimum(x, y)),
                                  tk._chunked_sum(np.minimum(x, y)))
    np.testing.assert_array_equal(two_level(np.maximum(x, y)),
                                  tk._chunked_sum(np.maximum(x, y)))
    d = np.abs(x - y).astype(F32)
    np.testing.assert_array_equal(minmax_emulation("manhattan", X, Y,
                                                   sms=1),
                                  tk._chunked_sum(d))
    splits = cp.minmax_launch_shape(4, 5, k)["split_chunks"]
    assert len(splits) == min(4, -(-k // CHUNK))
    split = two_level(np.minimum(x, y), splits)
    whole = two_level(np.minimum(x, y))
    np.testing.assert_array_equal(split > 0, whole > 0)
    np.testing.assert_allclose(split, whole, rtol=1e-6, atol=0)
    X[0, 0] = -0.25
    assert set(block_paths(X, Y).values()) == {"general"}
    np.testing.assert_array_equal(minmax_emulation("jaccard", X, Y, sms=1),
                                  tk.kernel_emulation("jaccard", X, Y))
    np.testing.assert_allclose(minmax_emulation("jaccard", X, Y),
                               _plain("jaccard", X, Y), rtol=TOL, atol=TOL)


def test_union_from_row_sums_is_within_ulps_of_the_sum_of_maxima():
    """On a tame block (Sx + Sy) - inter differs from the two-level sum of
    the maxima only by rounding: a few ulps of Sx + Sy."""
    X, Y = _probs(3, 40, 100), _probs(4, 50, 100)
    x, y = X[:, None, :], Y[None, :, :]
    inter = two_level(np.minimum(x, y))
    sxy = (two_level(X)[:, None] + two_level(Y)[None, :]).astype(F32)
    fast = (sxy - inter).astype(F32)
    slow = two_level(np.maximum(x, y))
    assert np.all(np.abs(fast - slow) <= 8 * np.spacing(sxy))


# ---------------------------------------------------------------------------
# the per-block path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [-0.25, np.nan, np.inf, 2.0 ** 40])
@pytest.mark.parametrize("side", ["x", "y"])
def test_a_block_off_the_tame_path_takes_the_general_one(bad, side):
    """One value (negative, NaN, inf, above 2^32) in a row of the second
    block of rows sends that block alone to the general path, whose result
    equals the parent's emulation (both sums, NaN carried) bit for bit;
    the other blocks stay on the tame path, within 1e-5 of the plain
    version."""
    X, Y = _probs(5, 140, 37), _probs(6, 150, 37)
    (X if side == "x" else Y)[133, 3] = bad
    paths = block_paths(X, Y)
    off = {key for key, p in paths.items() if p == "general"}
    assert off == {(m0, n0) for m0, n0 in paths
                   if (m0 if side == "x" else n0) == 128}
    one = minmax_emulation("jaccard", X, Y, sms=1)    # no K split
    parent = tk.kernel_emulation("jaccard", X, Y)
    for m0, n0 in off:
        blk = (slice(m0, m0 + TILE_M), slice(n0, n0 + TILE_N))
        np.testing.assert_array_equal(one[blk], parent[blk])
    _same_nan_and_close(one, _plain("jaccard", X, Y))
    # the launch on the card splits K in 2 (4 tiles, 2 chunks)
    assert cp.minmax_launch_shape(140, 150, 37)["grid"] == (
        -(-150 // TILE_N), 2, 2)
    _same_nan_and_close(minmax_emulation("jaccard", X, Y),
                        _plain("jaccard", X, Y))
    cheb = minmax_emulation("chebychev", X, Y)
    _same_nan_and_close(cheb, _plain("chebychev", X, Y), exact=True)


def test_minus_zero_and_subnormal_values_stay_tame():
    """-0.0 (>= 0) and subnormal values keep a block on the tame path,
    within 1e-5 of the plain version."""
    X, Y = _probs(7, 20, 37), _probs(8, 30, 37)
    X[0, :4] = np.array([-0.0, 1e-40, 3e-39, 1e-45], F32)
    Y[1, :2] = np.array([-0.0, 2e-40], F32)
    assert set(block_paths(X, Y).values()) == {"tame"}
    np.testing.assert_allclose(minmax_emulation("jaccard", X, Y),
                               _plain("jaccard", X, Y), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the launch shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (7, 9, 12), (128, 128, 32),
                                   (129, 127, 33), (301, 203, 37),
                                   (255, 257, 100), (5, 300, 4096),
                                   (300, 5, 3), (130, 1, 64), (1, 130, 65),
                                   (256, 256, 31), (400, 129, 97)])
def test_launch_shape_covers_every_pair_and_coordinate_once(m, n, k):
    """minmax_launch_shape's blocks and each thread's rows
    (minmax_thread_rows) give every (m, n) pair exactly once; its chunks
    every coordinate once, none padded; its K split, where the tiles fill
    at most half the 132 SMs, every chunk once, in rank order, at least
    one a block, up to 4 blocks a tile, all in one wave."""
    shape = cp.minmax_launch_shape(m, n, k)
    gx, gy, gz = shape["grid"]
    rows_m, rows_n = shape["tile"]
    tm, tn = shape["thread_rows"]
    assert shape["threads"] == 256 and (tm, tn) == (8, 4)
    assert (rows_m, rows_n) == (16 * tm, 16 * tn)
    seen = collections.Counter()
    for by in range(gy):
        for bx in range(gx):
            for t in range(shape["threads"]):
                tx, ty = t % 16, t // 16
                for i in cp.minmax_thread_rows(ty, tm):
                    for j in cp.minmax_thread_rows(tx, tn):
                        mm, nn = by * rows_m + i, bx * rows_n + j
                        if mm < m and nn < n:
                            seen[(mm, nn)] += 1
    assert len(seen) == m * n and set(seen.values()) == {1}
    chunks = shape["chunks"]
    assert sum(chunks) == k and all(c == CHUNK for c in chunks[:-1])
    assert 0 < chunks[-1] <= CHUNK
    split = shape["split_chunks"]
    assert len(split) == gz and split[0][0] == 0
    assert split[-1][1] == len(chunks)
    assert all(a < b for a, b in split)
    assert all(split[q][1] == split[q + 1][0] for q in range(gz - 1))
    assert gz == min(4, len(chunks), max(1, 132 // (gx * gy)))
    assert gx * gy * gz <= max(132, gx * gy)          # one wave


def test_launch_shape_constants_are_the_sources():
    """The Python geometry is csrc/pairwise.cu's: per-thread rows, chunk,
    landing stages, the dynamic shared memory, which fits one block an
    SM; the floors chip_smoke.py prints count 2 instructions a term."""
    text = open(SOURCE, encoding="utf-8").read()
    const = dict((name, int(v)) for name, v in re.findall(
        r"constexpr int (kMmThreads|kMmStages|kChunk|kMmMaxSplit) = (\d+);",
        text))
    assert const == {"kMmStages": cp.MINMAX_STAGES, "kChunk": CHUNK,
                     "kMmThreads": 256, "kMmMaxSplit": cp.MINMAX_MAX_SPLIT}
    assert "constexpr int kMmTm = 8, kMmTn = 4;" in text
    assert (cp.MINMAX_TM, cp.MINMAX_TN) == (8, 4)
    assert "constexpr int kMmLd = kChunk + 4;" in text
    assert cp.MINMAX_LD == CHUNK + 4 and cp.MINMAX_LD % 8 == 4
    assert ("constexpr int kMmSharedBytes = kMmStages * kMmStaged * 4;"
            in text)
    shape = cp.minmax_launch_shape(10, 10, 10)
    rows = sum(shape["tile"])
    assert shape["shared_bytes"] == cp.MINMAX_STAGES * rows \
        * cp.MINMAX_LD * 4 == 82_944
    # two blocks an SM: the ring and the rows' sums of each
    assert 2 * (shape["shared_bytes"] + 4 * rows + 1024) <= 233_472
    floors = chip_smoke.minmax_floors(
        types.SimpleNamespace(_nvcc=lambda: "/nonexistent/nvcc"),
        chip_smoke.PAIRWISE_TEST, chip_smoke.PAIRWISE_TRAIN, 100)
    assert floors["chebychev"] == floors["jaccard"] == floors[
        "manhattan"] == "not measured"
    assert round(floors["issue_floor_ms"], 4) == 0.1898


def test_sass_hot_loop_counts_the_innermost_fmnmx_loop(monkeypatch):
    """sass_hot_loop reads cuobjdump's listing: of the backward branches,
    the span with the largest share of FMNMX (the inner loop over
    coordinates, not the chunk loop around it), its opcodes counted
    without modifiers."""
    listing = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_113minmax_kernelILi3ELb1EEEvPKfS2_Pfxxi
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   FMNMX R2, R3, R4, PT ;
        /*0020*/                   LDS.128 R8, [R0] ;
        /*0030*/                   FMNMX.NAN R5, R8, R12, PT ;
        /*0040*/                   FADD R6, R6, R5 ;
        /*0050*/                   FMNMX.NAN R7, R9, R12, PT ;
        /*0060*/                   FADD R10, R10, R7 ;
        /*0070*/               @P1 BRA 0x20 ;
        /*0080*/                   IADD3 R0, R0, 0x400, RZ ;
        /*0090*/                   STS [R0], R2 ;
        /*00a0*/              @!P0 BRA 0x10 ;
        /*00b0*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_113minmax_kernelILi1ELb1EEEvPKfS2_Pfxxi
        /*0000*/                   EXIT ;
"""
    monkeypatch.setattr(chip_smoke.os.path, "exists", lambda p: True)
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **kw: types.SimpleNamespace(
                            stdout=listing))
    fake = types.SimpleNamespace(_nvcc=lambda: "/cuda/bin/nvcc",
                                 library_path=lambda: "lib.so")
    body = chip_smoke.sass_hot_loop(fake, "minmax_kernelILi3ELb1E")
    assert body == collections.Counter(
        {"LDS": 1, "FMNMX": 2, "FADD": 2, "BRA": 1})
    assert chip_smoke.sass_hot_loop(fake, "minmax_kernelILi1ELb1E") is None
    # manhattan's loop is found by its FADDs (two a term)
    assert chip_smoke.sass_hot_loop(fake, "minmax_kernelILi3ELb1E",
                                    "FADD") == body
    floors = chip_smoke.minmax_floors(fake, 32, 1, 2)
    # 6 instructions, 2 on the ALU: max(6, 4) clocks for 2 terms a warp
    assert floors["jaccard"]["floor_ms"] == pytest.approx(
        32 * 2 / 32 / 2 * 6 / (132 * 4 * 1.98e9) * 1e3)
    assert floors["chebychev"] == "not measured"
