"""The pairwise kernels' plain versions on the CPU (ops/cuda_pairwise.py,
csrc/pairwise.cu): `ks_merge_reference`, the kernel's merge walk, bit-equal
to the port's plain `ks` and within 1e-6 of the JAX package's `ks`
(hypothesis: exact zeros, ties, identical rows, -0.0, K from 1 to 64, and
the (7, 9, 12) fixture of tests/test_torch_similarity.py); an f32
emulation of the elementwise kernel's arithmetic (zero-padded chunks of
32 summed into fresh partials, the plain versions' order, the reciprocals
of the Python divisors) against the JAX package's metrics; each of the
seven metrics on a CPU tensor running its tiled block and never the
wrappers; a tensor off the CPU (meta) reaching the wrappers, which launch
or raise; the C entry points' signatures and constants; an empty M or N.

Tolerances: the merge and `ks` exact (integer gaps, one division); JAX's
`ks` divides both counts by K before subtracting, within 1e-6; the
elementwise emulation within rtol 1e-5 / atol 1e-5 of JAX (sums in
another order), uber within the JAX tests' own 1e-4."""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ldagroupedgibbssampler_tpu.similarity import distances as jax_distances
from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_pairwise as cp
from ldagroupedgibbssampler_tpu_torch.similarity import (DISTANCES, Distance,
                                                         pairwise)
from ldagroupedgibbssampler_tpu_torch.similarity import distances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "ldagroupedgibbssampler_tpu_torch", "csrc",
                      "pairwise.cu")
SEVEN = ("js", "manhattan", "chebychev", "canberra", "jaccard", "ks",
         "uber")
ELEMENTWISE = ("manhattan", "chebychev", "canberra", "jaccard", "js")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _probs(rng, n, k):
    """Probability rows with exact zeros, as tests/test_torch_similarity.py
    makes them: ~30% of the coordinates, the first two columns of every
    row, and row 0 supported on the upper half only."""
    x = rng.gamma(1.0, 1.0, (n, k))
    x[rng.random((n, k)) < 0.3] = 0.0
    x[:, :2] = 0.0
    x[0, :k // 2] = 0.0
    x[0, k // 2:] += 0.1
    return x / x.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def xy():
    """tests/test_torch_similarity.py's (M, N, K) = (7, 9, 12) fixture."""
    rng = np.random.default_rng(0)
    X, Y = _probs(rng, 7, 12), _probs(rng, 9, 12)
    Y[1, 6:] = 0.0
    Y[1, :6] = rng.gamma(1.0, 1.0, 6) + 0.1
    Y[1] /= Y[1].sum()
    return X.astype(np.float32), Y.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# ks: the merge walk
# ---------------------------------------------------------------------------

def test_ks_merge_on_the_fixture(xy):
    X, Y = xy
    merge = cp.ks_merge_reference(_t(X), _t(Y))
    assert merge.dtype == torch.float32 and merge.shape == (7, 9)
    assert torch.equal(merge, distances.ks(_t(X), _t(Y)))
    np.testing.assert_allclose(merge.numpy(),
                               np.asarray(jax_distances.ks(X, Y)),
                               rtol=0, atol=1e-6)


# values on a coarse grid, so that rows tie within and across themselves
_GRID = st.sampled_from([0.0, 0.0, 0.0, 0.0625, 0.125, 0.25, 0.5, 1.0, 3.0])


@st.composite
def _rows(draw, signed_zero=False):
    k = draw(st.integers(1, 64))
    m, n = draw(st.integers(1, 4)), draw(st.integers(1, 4))
    vals = st.lists(_GRID, min_size=k, max_size=k)
    X = np.array([draw(vals) for _ in range(m)], np.float32)
    Y = np.array([draw(vals) for _ in range(n)], np.float32)
    if draw(st.booleans()):
        Y[draw(st.integers(0, n - 1))] = X[draw(st.integers(0, m - 1))]
    if signed_zero:
        flip = np.array(draw(st.lists(st.booleans(), min_size=m * k,
                                      max_size=m * k))).reshape(m, k)
        X = np.where(flip & (X == 0), np.float32(-0.0), X)
    return X, Y


@settings(max_examples=60, deadline=None, database=None)
@given(xy=_rows())
def test_ks_merge_equals_plain_ks_and_jax(xy):
    """Rows with exact zeros, repeated values and identical rows: the
    merge equals the port's plain ks bit for bit and JAX's within 1e-6."""
    X, Y = xy
    merge = cp.ks_merge_reference(_t(X), _t(Y))
    assert torch.equal(merge, distances.ks(_t(X), _t(Y)))
    assert torch.equal(merge, cp.pairwise_ks(_t(X), _t(Y)))
    np.testing.assert_allclose(merge.numpy(),
                               np.asarray(jax_distances.ks(X, Y)),
                               rtol=0, atol=1e-6)


@settings(max_examples=40, deadline=None, database=None)
@given(xy=_rows(signed_zero=True))
def test_ks_merge_takes_negative_zero_as_zero(xy):
    """-0.0 and 0.0 are one value to the merge, as to the plain ks."""
    X, Y = xy
    merge = cp.ks_merge_reference(_t(X), _t(Y))
    assert torch.equal(merge, distances.ks(_t(X), _t(Y)))
    assert torch.equal(merge, cp.ks_merge_reference(_t(X + 0.0), _t(Y)))


def test_ks_merge_edge_rows():
    """An identical pair 0, disjoint supports 1, an all-zero row against a
    row with no zero 1, and a heavily tied pair its exact gap."""
    k = 8
    a = np.array([[0.0] * 4 + [0.25] * 4], np.float32)
    disjoint = np.array([[0.25] * 4 + [0.0] * 4], np.float32)
    zeros = np.zeros((1, k), np.float32)
    dense = np.full((1, k), 0.125, np.float32)
    tied = np.array([[0.0] * 6 + [0.5] * 2], np.float32)
    X = np.concatenate([a, zeros])
    Y = np.concatenate([a, disjoint, dense, tied])
    got = cp.ks_merge_reference(_t(X), _t(Y)).numpy()
    # a: 4 zeros + 4 x 0.25; disjoint has the same multiset as a
    want = np.array([[0.0, 0.0, 0.5, 0.25], [0.5, 0.5, 1.0, 0.25]],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, distances.ks(_t(X), _t(Y)).numpy())


# ---------------------------------------------------------------------------
# the elementwise kernel's arithmetic, emulated in f32
# ---------------------------------------------------------------------------

F32 = np.float32
CHUNK = 32


def _chunked_sum(t):
    """csrc/pairwise.cu's two-level sum over the last axis: zero-padded
    chunks of 32 summed in order into a fresh partial, each partial added
    to the total."""
    k = t.shape[-1]
    t = np.concatenate([t, np.zeros(t.shape[:-1] + (-k % CHUNK,), F32)],
                       axis=-1)
    total = np.zeros(t.shape[:-1], F32)
    for c in range(0, t.shape[-1], CHUNK):
        part = np.zeros(t.shape[:-1], F32)
        for kk in range(c, c + CHUNK):
            part = (part + t[..., kk]).astype(F32)
        total = (total + part).astype(F32)
    return total


def _log0(v):
    with np.errstate(divide="ignore"):
        return np.where(v > 0, np.log(np.where(v > 0, v, F32(1))), F32(0))


def kernel_emulation(metric, X, Y, parts=None):
    """The elementwise kernel's result in f32, operation by operation."""
    x, y = X[:, None, :].astype(F32), Y[None, :, :].astype(F32)
    d = np.abs(x - y).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        den = (np.abs(x) + np.abs(y)).astype(F32)
        can = _chunked_sum(np.where(den == 0, F32(0), d / den).astype(F32))
        inter = _chunked_sum(np.minimum(x, y))
        union = _chunked_sum(np.maximum(x, y))
        jac = np.where(inter > 0, F32(1) - inter / union, F32(0)).astype(F32)
    if metric == "manhattan":
        return _chunked_sum(d)
    if metric == "chebychev":
        return d.max(-1)
    if metric == "canberra":
        return can
    if metric == "jaccard":
        return jac
    if metric == "js":
        a = ((x + y) * F32(0.5)).astype(F32)
        la = _log0(a).astype(F32)

        def skl(p):
            ok = (p > 0) & (a > 0)
            return _chunked_sum(np.where(
                ok, (p - a) * (_log0(p).astype(F32) - la), F32(0))
                .astype(F32))
        return ((skl(x) + skl(y)) * (F32(1) / F32(4 * np.log(2.0)))
                ).astype(F32)
    cos, euc, kl = parts
    r = can + d.max(-1)
    for part in (cos, euc, jac, kl, _chunked_sum(d)):
        r = (r + part).astype(F32)
    return (r * (F32(1) / F32(7))).astype(F32)


@pytest.mark.parametrize("shape", [(7, 9, 12), (5, 6, 37), (4, 3, 70),
                                   (3, 5, 100)])
@pytest.mark.parametrize("metric", ELEMENTWISE + ("uber",))
def test_kernel_emulation_equals_jax(xy, shape, metric):
    """The kernel's arithmetic against the JAX package's metric: on the
    (7, 9, 12) fixture, on a K that no chunk divides (37), across two and
    three chunks (70, 100)."""
    if shape == (7, 9, 12):
        X, Y = xy
    else:
        rng = np.random.default_rng(sum(shape))
        X = _probs(rng, shape[0], shape[2]).astype(F32)
        Y = _probs(rng, shape[1], shape[2]).astype(F32)
    parts = None
    if metric == "uber":
        parts = [DISTANCES[p](_t(X), _t(Y)).numpy()
                 for p in cp.UBER_PRODUCTS]
    got = kernel_emulation(metric, X, Y, parts)
    want = np.asarray(jax_distances.DISTANCES[metric](X, Y))
    tol = 1e-4 if metric == "uber" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if metric == "chebychev":      # a max: exact, as the plain version
        np.testing.assert_array_equal(
            got, distances.chebychev(_t(X), _t(Y)).numpy())


def test_wrappers_on_the_cpu_run_the_plain_versions(xy):
    """On CPU tensors the wrappers give the metrics' CPU results, uber
    with the products' matrices as its parts bit for bit."""
    X, Y = (_t(a) for a in xy)
    for name in ELEMENTWISE:
        assert torch.equal(cp.pairwise_elementwise(name, X, Y),
                           DISTANCES[name](X, Y))
    parts = tuple(DISTANCES[p](X, Y) for p in cp.UBER_PRODUCTS)
    assert torch.equal(cp.pairwise_elementwise("uber", X, Y, parts=parts),
                       distances.uber(X, Y))
    with pytest.raises(ValueError, match="parts"):
        cp.pairwise_elementwise("uber", X, Y)
    with pytest.raises(ValueError, match="parts"):
        cp.pairwise_elementwise("js", X, Y, parts=parts)
    with pytest.raises(ValueError, match="no elementwise kernel"):
        cp.pairwise_elementwise("kl", X, Y)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(N, K\)"):
        cp.pairwise_ks(X, Y[:, :5])
    with pytest.raises(ValueError, match="K >= 1"):
        cp.pairwise_ks(X[:, :0], Y[:, :0])


# ---------------------------------------------------------------------------
# dispatch: the CPU keeps its tiles; off the CPU the wrappers launch or raise
# ---------------------------------------------------------------------------

def _refuse_wrappers(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached cuda_pairwise")
    monkeypatch.setattr(cp, "pairwise_elementwise", refuse)
    monkeypatch.setattr(cp, "pairwise_ks", refuse)


@pytest.mark.parametrize("name", SEVEN)
def test_cpu_tensors_run_the_tiled_block(xy, name, monkeypatch):
    """On the CPU each of the seven metrics runs its plain tiled block, by
    `pairwise`, `Distance.pairwise` and `Distance.calculate`, and never
    touches cuda_pairwise."""
    X, Y = xy
    want = np.asarray(pairwise(name, X, Y, device="cpu"))
    _refuse_wrappers(monkeypatch)
    fn = DISTANCES[name]
    calls = []
    real = fn.block
    monkeypatch.setattr(fn, "block", lambda x, y: calls.append(
        (x.shape[0], y.shape[0])) or real(x, y))
    got = pairwise(name, X, Y, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    dist = Distance(name, device="cpu")
    np.testing.assert_array_equal(dist.pairwise(X, Y), want)
    assert dist.calculate(X[2], Y[3]) == float(want[2, 3])
    assert calls and all(c[0] >= 1 and c[1] >= 1 for c in calls)


def _meta(a):
    return torch.empty(tuple(np.shape(a)), dtype=torch.float32,
                       device="meta")


@pytest.mark.parametrize("name", SEVEN)
def test_off_the_cpu_the_metric_reaches_its_wrapper(xy, name, monkeypatch):
    """A meta tensor stands in for the card: the metric calls its wrapper
    with the whole inputs (no tile, no block) and returns what it gives."""
    X, Y = (_meta(a) for a in xy)
    seen = []

    def fake(metric_or_x, *args, **kwargs):
        seen.append((metric_or_x, args, kwargs))
        return torch.empty((7, 9), device="meta")
    monkeypatch.setattr(cp, "pairwise_ks" if name == "ks"
                        else "pairwise_elementwise", fake)
    for seven in SEVEN:
        monkeypatch.setattr(DISTANCES[seven], "block", None)
    out = DISTANCES[name](X, Y)
    assert out.shape == (7, 9) and len(seen) == 1
    if name == "ks":
        assert seen[0][0].shape == (7, 12) and seen[0][1][0].shape == (9, 12)
    else:
        assert seen[0][0] == name
        assert seen[0][1][0].shape == (7, 12)
        parts = seen[0][2].get("parts")
        assert (parts is not None) == (name == "uber")


def test_off_the_cpu_uber_passes_the_exact_products(xy, monkeypatch):
    """uber off the CPU computes cosine, euclidean and kl as the CPU does
    and hands them to one elementwise launch as its parts."""
    X, Y = (_t(a) for a in xy)
    seen = {}

    def fake(metric, x, y, parts=None):
        seen.update(metric=metric, parts=parts)
        return torch.zeros((x.shape[0], y.shape[0]))
    monkeypatch.setattr(cp, "pairwise_elementwise", fake)
    distances._uber_on_card(X, Y)
    assert seen["metric"] == "uber"
    for got, name in zip(seen["parts"], cp.UBER_PRODUCTS):
        assert torch.equal(got, DISTANCES[name](X, Y))


def _meta_calls(xy):
    X, Y = (_meta(a) for a in xy)
    return ([(lambda n=name: DISTANCES[n](X, Y), "lda_pairwise_elementwise")
             for name in ("js", "manhattan", "chebychev", "canberra",
                          "jaccard", "uber")]
            + [(lambda: DISTANCES["ks"](X, Y), "lda_pairwise_ks")])


def test_wrappers_off_the_cpu_launch_or_raise(xy, monkeypatch, tmp_path):
    """A failed build raises; an entry point that returns a CUDA error
    raises and counts no launch; no wrapper falls back (meta tensors stand
    in for the card)."""
    calls = _meta_calls(xy)

    def no_nvcc():
        raise RuntimeError("nvcc failed (test)")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "libldakernels-test.so")
    _build.library.cache_clear()
    try:
        for call, _ in calls:
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
    fns = (cp.pairwise_elementwise, cp.pairwise_ks)
    before = [f.launches for f in fns]
    for call, name in calls:
        with pytest.raises(RuntimeError, match=f"{name} failed"):
            call()
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("m,n", [(0, 9), (7, 0), (0, 0)])
def test_empty_m_or_n_gives_an_empty_result(m, n, monkeypatch):
    """An empty M or N gives an empty (M, N): on the CPU by the tiled
    code, and off it from the wrappers without a launch."""
    rng = np.random.default_rng(1)
    X = _probs(rng, 7, 12).astype(F32)[:m]
    Y = _probs(rng, 9, 12).astype(F32)[:n]
    for name in SEVEN:
        out = pairwise(name, X, Y, device="cpu")
        assert out.shape == (m, n) and out.dtype == torch.float32

    class NoLaunch:
        def __getattr__(self, name):
            raise AssertionError(f"{name} launched on an empty input")
    monkeypatch.setattr(_build, "library", lambda: NoLaunch())
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    Xm, Ym = _meta(X), _meta(Y)
    before = (cp.pairwise_elementwise.launches, cp.pairwise_ks.launches)
    for name in ELEMENTWISE:
        assert cp.pairwise_elementwise(name, Xm, Ym).shape == (m, n)
    assert cp.pairwise_ks(Xm, Ym).shape == (m, n)
    assert (cp.pairwise_elementwise.launches,
            cp.pairwise_ks.launches) == before


def test_every_entry_point_has_its_signature():
    """Each extern "C" entry point of csrc/pairwise.cu has an _SIGNATURES
    entry with one argtype a parameter; the wrappers' metric numbers are
    the source's, and its KS tile fits the shared memory."""
    text = open(SOURCE, encoding="utf-8").read()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    assert [name for name, _ in found] == [
        "lda_pairwise_elementwise", "lda_pairwise_division_check",
        "lda_pairwise_blocks_per_sm", "lda_pairwise_ks"]
    for name, params in found:
        assert len(_build._SIGNATURES[name]) == len(params.split(",")), name
    enum = dict((name, int(v)) for name, v in re.findall(
        r"\bk(Manhattan|Chebychev|Canberra|Jaccard|Js|Uber) = (\d+)", text))
    assert {k.lower(): v for k, v in enum.items()} == cp.METRICS
    # the shared rows of a KS block, [K + kKsUnroll][32] of x and of y,
    # and its [32][33] result tile fit the opt-in shared memory up to the
    # largest K sent to that instance
    const = dict((name, int(v)) for name, v in re.findall(
        r"constexpr int (kKsSharedMaxK|kKsTile|kKsUnroll) = (\d+);", text))
    max_k, tile = const["kKsSharedMaxK"], const["kKsTile"]
    unroll = const["kKsUnroll"]
    result = tile * (tile + 1) * 4
    assert 2 * (max_k + unroll) * tile * 4 + result <= 232_448
    assert 2 * (max_k + 1 + unroll) * tile * 4 + result > 232_448


def test_launch_counters_include_the_pairwise_kernels():
    from ldagroupedgibbssampler_tpu_torch.models.fusion import (
        launch_counters)
    counters = launch_counters()
    assert (cp.pairwise_elementwise, "launches") in counters
    assert (cp.pairwise_ks, "launches") in counters
