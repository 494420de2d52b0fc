"""The redesigned Polya-Urn rows and table counts of the PyTorch/CUDA port
(csrc/polya_urn.cu, csrc/hdp.cu), held on the CPU by their plain pieces
and by numpy emulations of the kernels' control flow.

- The Polya-Urn rows: the inversion's cdf table (`inversion_table`) term
  for term against the inversion loop of `poisson_reference`, emulated in
  numpy f64 in the kernel's order; the table search with the queue for
  every other value (`table_classes`, `table_search`) against
  `poisson_reference`'s counts on seeded grids; the draw launch's deal
  (`urn_launch_shape`, `urn_deal`) drawing every 32-column group once and
  spreading a heavy row over every block; the rows emulated over it
  (each group's f64 sum, a row's total from its groups') against
  `polya_urn_reference`.
- The table counts: the blocks' shared histograms flushed into the
  global one, then the second launch's reverse scans in chunks of its
  threads, emulated in numpy against `ge_reference`, and through the plain
  draws against `table_counts_reference`.
- The wrappers' wiring off the CPU with a stand-in library: two launches
  a Polya-Urn call with its grid and group sums, two a table-count call on
  its [K, M] scratch.
The JAX package is not needed here: `tests/test_torch_polya_urn_kernel.py`
and `tests/test_torch_hdp_kernel.py` hold these plain versions to it.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_hdp
from ldagroupedgibbssampler_tpu_torch.ops import cuda_polya_urn as cpu
from ldagroupedgibbssampler_tpu_torch.ops.cuda_gamma import _unit23
from ldagroupedgibbssampler_tpu_torch.ops.philox import element_words

CSRC = Path(cpu.__file__).resolve().parent.parent / "csrc"
SMS = 132                          # the H100's multiprocessors
HIST_BLOCKS, TABLE_THREADS = 264, 256             # csrc/hdp.cu's


def _seed(v):
    return torch.tensor([v], dtype=torch.int64)


def _uniforms(n, seed):
    """Each flat element's uniform: word x of its Philox block 0."""
    el = torch.arange(n, dtype=torch.int64)
    return _unit23(element_words(seed, el, 0)[0]).double()


# ---------------------------------------------------------------------------
# the Polya-Urn rows: the table
# ---------------------------------------------------------------------------

def test_kernel_constants_match_the_module():
    src = (CSRC / "polya_urn.cu").read_text()
    for name, value in (("kRates", cpu.TABLE_RATES),
                        ("kTab", cpu.TABLE_TERMS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    hdp = (CSRC / "hdp.cu").read_text()
    for name, value in (("kHistBlocks", HIST_BLOCKS),
                        ("kTableThreads", TABLE_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", hdp), name


@pytest.mark.parametrize("source", ["polya_urn.cu", "hdp.cu"])
def test_every_entry_point_has_its_signature(source):
    """Each extern "C" entry point of the source has an _SIGNATURES entry
    with one argtype a parameter."""
    text = (CSRC / source).read_text()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    assert found
    for name, params in found:
        assert len(_build._SIGNATURES[name]) == len(params.split(",")), name


@pytest.mark.parametrize("beta", [0.01, 0.5, 0.9999, 0.37])
def test_inversion_table_is_the_loop_term_for_term(beta):
    """Row c holds s_0, s_1, .. of the inversion at lam = f32(c) + beta,
    emulated in numpy f64 as the kernel's loop forms them (p = exp(-lam),
    then (p lam) / k added term by term), up to the first term >= U_MAX
    and 2.0 after it."""
    tab = cpu.inversion_table(beta).numpy()
    lam = (np.arange(cpu.TABLE_RATES, dtype=np.float32)
           + np.float32(beta)).astype(np.float64)
    for c in range(cpu.TABLE_RATES):
        p = float(torch.exp(-torch.tensor(lam[c], dtype=torch.float64)))
        s = p
        want = [s]
        for k in range(1, cpu.TABLE_TERMS):
            if s >= cpu.U_MAX:
                break
            p = (p * lam[c]) / k
            s = s + p
            want.append(s)
        want += [2.0] * (cpu.TABLE_TERMS - len(want))
        assert tab[c].tolist() == want, c
        assert np.all(np.diff(tab[c]) >= 0)
    # a row reaches U_MAX within its 24 terms (2.0 after), or all its
    # terms are below it (rates above ~6: the uniforms past its last term
    # are queued); rates up to 5 always reach it
    for c in range(cpu.TABLE_RATES):
        real = tab[c][tab[c] < 2.0]
        assert real[-1] >= cpu.U_MAX or len(real) == cpu.TABLE_TERMS
        assert lam[c] > 5.1 or real[-1] >= cpu.U_MAX


@pytest.mark.parametrize("beta", [0.0, 1.5, -0.25])
def test_rates_off_the_table_leave_their_rows_empty(beta):
    """A rate at 0 or at 10 and above (or a negative one) has no row: all
    2.0, and its counts' class is -1 (queued)."""
    tab = cpu.inversion_table(beta)
    counts = torch.arange(cpu.TABLE_RATES, dtype=torch.float32)
    lam = counts + beta
    classes = cpu.table_classes(counts, beta)
    off = ~((lam > 0) & (lam < 10))
    assert bool(off.any())
    assert bool((tab[off] == 2.0).all())
    assert bool((classes[off] == -1).all())
    assert bool((classes[~off] == counts[~off].long()).all())


def urn_counts_emulated(counts, beta, seed):
    """The rows kernel's counts at every flat element: a value of class c
    searches table row c with its uniform; a value off the table, or past
    its row's last term, is queued and drawn by the sampler
    (poisson_reference at that element)."""
    x = torch.as_tensor(counts).to(torch.float32).reshape(-1)
    classes = cpu.table_classes(x, beta)
    m = cpu.table_search(cpu.inversion_table(beta), classes,
                         _uniforms(x.numel(), seed))
    use = (classes >= 0) & (m < cpu.TABLE_TERMS)
    out = torch.empty_like(x)
    out[use] = m[use].to(torch.float32)
    el = torch.arange(x.numel(), dtype=torch.int64)
    rest = ~use
    if bool(rest.any()):
        out[rest] = cpu.poisson_reference(x[rest] + beta, seed, el[rest])
    return out.reshape(torch.as_tensor(counts).shape), use


def _grid(seed, shape=(48, 700)):
    """Counts 0-9 (mostly 0), >= 10, f32 values off the table (halves,
    9.999, negatives, NaN) and an all-zero row."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(rng.choice([0.05, 2.0, 6.0], size=shape[0])[:, None],
                    shape).astype(np.float32)
    x[:, :20] = rng.integers(10, 400, (shape[0], 20))
    x[1, :30] = np.arange(30)
    x[2, :6] = (3.5, 9.999, -1.0, np.nan, 0.25, 12.5)
    x[3] = 0.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("beta", [0.01, 0.5])
def test_table_search_gives_the_reference_counts(seed, beta):
    x = _grid(seed)
    key = _seed(0x5EED + seed)
    got, use = urn_counts_emulated(x, beta, key)
    want = cpu.poisson_reference(torch.as_tensor(x) + beta, key)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    # most values come off the table; the head is queued
    use = use.reshape(got.shape)
    assert 0.8 < float(use.float().mean()) < 1.0
    assert not bool(use[4:, :20].any())


def test_rates_just_below_ten_and_past_the_rows_end():
    """beta = 0.9999: row 9 is lam = 9.9999, whose 24 terms stop short of
    U_MAX; uniforms past its last term are queued and still give the
    reference's counts."""
    beta = 0.9999
    x = np.full((4, 20000), 9.0, np.float32)
    key = _seed(77)
    got, use = urn_counts_emulated(x, beta, key)
    want = cpu.poisson_reference(torch.as_tensor(x) + beta, key)
    assert torch.equal(got, want)
    past = ~use.reshape(got.shape)
    assert 0 < int(past.sum()) < 50         # ~1.2e-4 of the values
    assert bool((got[past] >= cpu.TABLE_TERMS).all())


# ---------------------------------------------------------------------------
# the Polya-Urn rows: the deal of the groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,num_cols", [
    (1, 1), (1, 7), (3, 33), (1, 300000), (2, 300000), (5000, 7),
    (100, 2047), (100, 20000), (200, 20000), (7, 20001), (4096, 100)])
@pytest.mark.parametrize("per_sm", [1, 8])
def test_deal_draws_every_group_once(rows, num_cols, per_sm):
    blocks = cpu.urn_launch_shape(rows, num_cols, SMS, per_sm)
    groups = rows * -(-num_cols // 32)
    assert 1 <= blocks <= SMS * per_sm
    assert blocks == min(SMS * per_sm, -(-groups // cpu.URN_WARPS))
    deal = cpu.urn_deal(rows, num_cols, blocks)
    assert deal.shape == (groups, 3)
    # (block, warp, round) names one slot of the launch, each group's own
    slot = (deal[:, 2] * cpu.URN_WARPS + deal[:, 1]) * blocks + deal[:, 0]
    assert torch.equal(slot, torch.arange(groups))
    assert bool((deal[:, 0] < blocks).all())
    assert bool((deal[:, 1] < cpu.URN_WARPS).all())
    # every warp's rounds run from 0 without a gap, the block-uniform
    # loop covers them: rounds < ceil(groups / (blocks warps))
    assert int(deal[:, 2].max()) < -(-groups // (blocks * cpu.URN_WARPS))


def test_a_heavy_row_spreads_over_every_block():
    """One row of 20,000 values (625 groups) of the K=100 matrix, on a wave
    of 1,056 blocks: each block draws at most one of its groups, so the
    row's queued draws are at most 32 a block."""
    blocks = cpu.urn_launch_shape(100, 20000, SMS, 8)
    assert blocks == 1056
    deal = cpu.urn_deal(100, 20000, blocks)
    row0 = deal[:625]
    assert int(torch.bincount(row0[:, 0], minlength=blocks).max()) == 1
    # the head (the first 8 groups) on 8 different blocks
    assert len(set(row0[:8, 0].tolist())) == 8


def urn_rows_emulated(counts, beta, seed, active=None, per_sm=8):
    """The two launches over the deal: each 32-column group's f64 sum, a
    row's total from its groups' sums, one f32 division a value, 1/L
    where the total is 0; inactive rows 0 (mask 1)."""
    x = torch.as_tensor(counts)
    rows, num_cols = x.shape
    width = -(-num_cols // 32)
    blocks = cpu.urn_launch_shape(rows, num_cols, SMS, per_sm)
    deal = cpu.urn_deal(rows, num_cols, blocks)
    c, _ = urn_counts_emulated(x, beta, seed)
    c = c.numpy()
    if active is not None:
        c = np.where(np.asarray(active)[:, None], c, np.float32(0.0))
    gsum = np.zeros(len(deal))
    # launch 1, block by block: its groups' counts and sums
    for b in range(blocks):
        for g in (deal[:, 0] == b).nonzero().reshape(-1).tolist():
            r, q = divmod(g, width)
            gsum[g] = float(np.sum(c[r, 32 * q:32 * q + 32]
                                   .astype(np.float64)))
    phi = np.zeros(c.shape, np.float32)
    for r in range(rows):
        if active is not None and not bool(active[r]):
            continue
        t32 = np.float32(np.sum(gsum[r * width:(r + 1) * width]))
        phi[r] = (c[r] / max(t32, np.float32(1.0)) if t32 > 0
                  else np.float32(1.0 / num_cols))
    return torch.as_tensor(phi), torch.as_tensor(c == 0)


@pytest.mark.parametrize("shape", [(6, 37), (5, 4100), (3, 20000)])
@pytest.mark.parametrize("with_active", [False, True])
def test_rows_over_the_deal_equal_the_reference(shape, with_active):
    rng = np.random.default_rng(shape[1])
    x = rng.poisson(0.3, shape).astype(np.int32)
    x[:, :40] = rng.integers(0, 60, (shape[0], min(40, shape[1])))
    x[-1] = 0                                   # an all-zero row
    active = (torch.tensor([i % 3 != 1 for i in range(shape[0])])
              if with_active else None)
    key = _seed(4242)
    phi, zero = urn_rows_emulated(x, 0.01, key, active)
    want, want_zero = cpu.polya_urn_reference(torch.as_tensor(x), 0.01, key,
                                              active, True)
    assert torch.equal(phi, want)
    assert torch.equal(zero, want_zero)


# ---------------------------------------------------------------------------
# the table counts: the first launch's split histogram and the tail
# ---------------------------------------------------------------------------

def table_hist_emulated(ndk, max_count, blocks=HIST_BLOCKS):
    """The first launch: each block's run of whole rows counted into its
    [K, M] histogram (values clipped to M, zeros never), its non-zero cells
    added to the global histogram."""
    ndk = np.asarray(ndk)
    d, k = ndk.shape
    hist = np.zeros((k, max_count), np.int64)
    rows = -(-d // blocks) if d else 1
    topic = np.broadcast_to(np.arange(k), ndk.shape)
    for r0 in range(0, max(d, 1), rows):
        v, kk = ndk[r0:r0 + rows], topic[r0:r0 + rows]
        h_s = np.zeros((k, max_count), np.int64)
        on = v > 0
        np.add.at(h_s, (kk[on], np.minimum(v[on], max_count) - 1), 1)
        hist += h_s
    return hist


def scan_ge(hist, threads=TABLE_THREADS):
    """The second launch's ge: a topic's j from M down in chunks of its
    threads, each chunk's inclusive suffix sums on the carry of the chunks
    above it."""
    k, m = hist.shape
    ge = np.zeros((k, m), np.int64)
    for t in range(k):
        carry = 0
        for top in range(m, 0, -threads):
            j = np.arange(top, max(top - threads, 0), -1)
            run = np.cumsum(hist[t, j - 1])
            ge[t, j - 1] = carry + run
            carry += int(run[-1])
    return ge


def _ndk(seed, d, k, big=True):
    rng = np.random.default_rng(seed)
    ndk = rng.poisson(rng.gamma(0.3, 3.0, k)[None, :], (d, k))
    if big:
        ndk[rng.integers(0, d, 40), rng.integers(0, k, 40)] = \
            rng.integers(33, 400, 40)              # above 32 and above M
    ndk[rng.integers(0, d, max(1, d // 10))] = 0   # all-zero rows
    return ndk.astype(np.int32)


@pytest.mark.parametrize("threads", [TABLE_THREADS])
@pytest.mark.parametrize("d,k,m", [(1001, 7, 40), (264, 5, 168), (17, 3, 9),
                                   (1000, 100, 33), (0, 4, 12), (529, 1, 64),
                                   (300, 3, 600)])
def test_histogram_and_scans_give_ge(d, k, m, threads):
    """The second launch's block scans (256 j at a time): D not a
    multiple of a block's rows, values above M, all-zero rows, M below 32
    and above 256, one topic, no document."""
    ndk = _ndk(d + k + m, d, k) if d else np.zeros((0, k), np.int32)
    hist = table_hist_emulated(ndk, m)
    want = cuda_hdp.ge_reference(torch.as_tensor(ndk), m).numpy()
    assert np.array_equal(scan_ge(hist, threads), want)


@pytest.mark.parametrize("hlda", [False, True])
@pytest.mark.parametrize("concentrated", [False, True])
def test_scans_and_draws_give_the_tables(hlda, concentrated):
    """l_k from the emulated launches' ge: every term binomial_reference at
    element k M + j - 1 (the exact ones, ge_j = 0 or p_j = 0 or 1, 0 or
    ge_j), so l_k is table_counts_reference's, with alpha0 psi and hlda's
    gamma, on n_dk spread over the topics or concentrated on a few (the
    HDP chains' state)."""
    d, k, m = 700, 9, 60
    ndk = _ndk(5, d, k)
    if concentrated:
        ndk[:, 3:] = 0
        ndk[:, 0] = np.random.default_rng(7).integers(20, m + 20, d)
    a = (3.0 if hlda else torch.as_tensor(
        np.random.default_rng(6).gamma(1.0, 0.2, k).astype(np.float32)))
    key = _seed(99)
    ge = torch.as_tensor(scan_ge(table_hist_emulated(ndk, m))).float()
    p = cuda_hdp.table_probs(cuda_hdp._concentration(a, k, "cpu"), m, "cpu")
    terms = cuda_hdp.binomial_reference(ge, p, key)
    want = cuda_hdp.table_counts_reference(torch.as_tensor(ndk), a, m, key)
    assert torch.equal(terms.sum(dim=1), want)
    need = (ge > 0) & (p > 0) & (p < 1)
    whole = torch.where((ge > 0) & (p >= 1), ge, torch.zeros(()))
    assert torch.equal(terms[~need], whole[~need])
    assert int(need.sum()) > 3


# ---------------------------------------------------------------------------
# the wrappers' wiring off the CPU
# ---------------------------------------------------------------------------

class StandInLibrary:
    """Records each entry point's arguments; returns cudaSuccess, 132
    multiprocessors of 8 draw blocks each and the shared instance."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name == "lda_polya_urn_geometry":
                blocks = cpu.urn_launch_shape(args[0], args[1], SMS, 8)
                (ctypes.c_int * 4).from_address(args[3])[:] = [
                    blocks, 16, 8, SMS]
            if name == "lda_hdp_hist_shared":
                return 1
            return 0
        return call


@pytest.fixture
def stand_in(monkeypatch):
    lib = StandInLibrary()
    shapes = []
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "check_tensor",
                        lambda name, t, shape, *a, **k: shapes.append(
                            (name, tuple(shape))))
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    yield lib, shapes


@pytest.mark.parametrize("rows,num_cols", [(100, 20000), (200, 20000),
                                           (3, 37)])
def test_polya_urn_is_two_launches_on_its_grid(stand_in, rows, num_cols):
    lib, _ = stand_in
    meta = torch.device("meta")
    counts = torch.empty((rows, num_cols), dtype=torch.int32, device=meta)
    before = cpu.polya_urn.launches
    cpu.polya_urn(counts, 0.01, torch.empty(1, dtype=torch.int64,
                                            device=meta))
    assert cpu.polya_urn.launches == before + 2
    (name, args), = [c for c in lib.calls if c[0] == "lda_polya_urn"]
    assert args[8:10] == (rows, num_cols)
    occupancy = cpu.urn_occupancy(rows, num_cols, meta)
    assert occupancy["blocks"] == cpu.urn_launch_shape(rows, num_cols, SMS,
                                                       8)


@pytest.mark.parametrize("instance", ["shared", "global"])
def test_table_counts_are_two_launches_on_their_scratch(stand_in, instance):
    lib, shapes = stand_in
    meta = torch.device("meta")
    k, m = 6, 40
    ndk = torch.empty((50, k), dtype=torch.int32, device=meta)
    hist = torch.zeros((k, m), dtype=torch.int32, device=meta)
    before = cuda_hdp.table_counts.launches
    cuda_hdp.table_counts(ndk, 0.5, m, torch.empty(1, dtype=torch.int64,
                                                   device=meta),
                          instance=instance, hist=hist)
    assert cuda_hdp.table_counts.launches == before + 2
    assert ("hist", (k, m)) in shapes
    (name, args), = [c for c in lib.calls
                     if c[0] == "lda_hdp_table_counts"]
    assert args[7:11] == (50, k, m, int(instance == "shared"))


def test_table_counts_default_instance_and_scratch(stand_in):
    lib, shapes = stand_in
    meta = torch.device("meta")
    cuda_hdp.table_counts(torch.empty((5, 3), dtype=torch.int32,
                                      device=meta), 0.5, 4,
                          torch.empty(1, dtype=torch.int64, device=meta))
    assert ("hist", (3, 4)) in shapes
    assert [c[1] for c in lib.calls if c[0] == "lda_hdp_hist_shared"] == [
        (3, 4, None)]
