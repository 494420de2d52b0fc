"""The alias-MH z-step's set-up records and the VS-Dirichlet kernel's
cluster, their arithmetic and control flow on the CPU (ops/cuda_alias_mh.py,
csrc/alias_mh.cu; ops/cuda_gamma.py::vs_launch_shape, csrc/vs_dirichlet.cu):
the document and type records made once at set-up (base, count, the
count's reciprocal for the exact modulo) against the per-token values ~0 /
max(count, 1), emulated in numpy uint64, on edge bounds; the offsets read
back from the records' bases; an emulation of the pre-pass (the entry
topics, an output array that starts as garbage zeroed) and of the rounds
on the records against alias_mh_reference with every document and with
half of them selected; the VS cluster's geometry
covering every value of a row once; its f64 sums taken in the kernel's
order (a slice's threads, the warp butterfly, the warps, then the ranks)
within 1 ulp of the plain version's total, with the same inclusion
mask."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import cuda_alias_mh as cam
from ldagroupedgibbssampler_tpu_torch.ops import cuda_gamma
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10

K = 6
M64 = (1 << 64) - 1
EDGE_BOUNDS = (1, 2, 3, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1)
THREADS = 256               # the VS kernel's block


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(v):
    return torch.tensor([v], dtype=torch.int64)


def _corpus(seed=0, docs=80, vocab=40, max_len=70):
    rng = np.random.default_rng(seed)
    toks = [list(rng.integers(0, vocab, rng.integers(2, max_len)))
            for _ in range(docs)]
    return Corpus.from_token_lists(toks, [f"w{i}" for i in range(vocab)])


@pytest.fixture(scope="module")
def model():
    """A CPU ggs_aliasmh model after 2 iterations at K=6, alpha
    asymmetric."""
    cfg = LDAConfig(scheme="ggs_aliasmh", topics=K, alpha=0.5, beta=0.01,
                    seed=7, device="cpu", exec_time=-1, token_block=512)
    m = create_model(cfg).add_instances(_corpus())
    m.state.alpha = torch.linspace(0.1, 1.2, K)
    m.sample(2)
    return m


def _case(m, selected):
    c, s = m.corpus, m.state
    ops = cam.MHOperands.build(c.tokens, c.doc_offsets, m._blocks.flat_index,
                               c.num_types, "cpu")
    a_sum = s.alpha.sum()
    mask = (None if selected == "all"
            else (torch.arange(c.num_docs) % 2) == 0)
    return dict(z_slot=s.z, ops=ops, phi=s.phi, nkw=s.nkw, theta=s.theta,
                ndk=s.ndk, beta=s.beta, alpha_sum=a_sum, au=a_sum / K,
                seed=_seed(0x0BAD_5EED_1234_5678), doc_mask=mask)


# ---------------------------------------------------------------------
# the records made once at set-up
# ---------------------------------------------------------------------
def _mulhi64(a, b):
    """The high 64 bits of a b for uint64 arrays (__umul64hi)."""
    m, s = np.uint64(0xFFFFFFFF), np.uint64(32)
    a0, a1, b0, b1 = a & m, a >> s, b & m, b >> s
    mid = (a0 * b0 >> s) + (a0 * b1 & m) + (a1 * b0 & m)
    return a1 * b1 + (a0 * b1 >> s) + (a1 * b0 >> s) + (mid >> s)


def _mod_exact(x, m, inv):
    """The kernel's mod_exact: a Barrett estimate, two subtractions."""
    r = x - _mulhi64(x, inv) * m
    for _ in range(2):
        r = np.where(r >= m, r - m, r)
    return r


def _decode(tab):
    """(base, count, inv uint64) of count_table's int32 records."""
    u = np.asarray(tab).astype(np.int32).view(np.uint32).astype(np.uint64)
    return (u[:, 0].astype(np.int64), u[:, 1],
            u[:, 2] | (u[:, 3] << np.uint64(32)))


@pytest.mark.parametrize("bound", EDGE_BOUNDS)
def test_reciprocal_is_the_kernels_division(bound):
    """reciprocals gives the per-token ~0 / m, uint64, and
    mod_exact with it is exact at the edge bounds, on 62-bit values at
    and around the multiples of the bound and at the top of the range."""
    inv = cam.reciprocals([bound])[0]
    assert int(inv) == M64 // bound
    x = np.array([0, 1, bound - 1, bound, bound + 1, 2 ** 62 - 1,
                  (2 ** 62 - 1) // bound * bound, 2 ** 61 + 12345,
                  2 ** 32 - 1, 2 ** 32], np.uint64)
    got = _mod_exact(x, np.uint64(bound), np.uint64(inv))
    assert [int(r) for r in got] == [int(v) % bound for v in x]


@settings(max_examples=150, deadline=None, database=None)
@given(x=st.lists(st.integers(0, 2 ** 62 - 1), min_size=1, max_size=16),
       m=st.one_of(st.sampled_from(EDGE_BOUNDS), st.integers(1, 2 ** 32 - 1)))
def test_barrett_with_the_records_reciprocal_is_exact(x, m):
    """The reciprocal decoded from a record gives x mod m exactly."""
    _, cnt, inv = _decode(cam.count_table([0, m]))
    xs = np.array(x, np.uint64)
    assert int(cnt[0]) == m
    assert [int(r) for r in _mod_exact(xs, cnt, inv)] == [v % m for v in x]


def test_records_are_the_first_designs_per_token_values(model):
    """Each token's document and type records hold its per-token values:
    doc_off[d], max(L_d, 1) and ~0 / max(L_d, 1); the type's base in type
    order, max(n_w, 1) and its reciprocal."""
    ops = _case(model, "all")["ops"]
    w, d = ops.tok_w.numpy(), ops.tok_d.numpy()
    doc_off, ty_off = ops.doc_off.numpy(), ops.ty_off.numpy()
    for tab, off, idx in ((ops.doc_tab, doc_off, d), (ops.ty_tab, ty_off, w)):
        base, cnt, inv = _decode(tab.numpy())
        hi = np.maximum(off[idx + 1] - off[idx], 1)
        assert np.array_equal(base[idx], off[idx])
        assert np.array_equal(cnt[idx].astype(np.int64), hi)
        assert [int(v) for v in inv[idx]] == [M64 // int(h) for h in hi]
    # an empty span keeps a bound of 1
    base, cnt, inv = _decode(cam.count_table([0, 3, 3, 9]))
    assert base.tolist() == [0, 3, 3] and cnt.tolist() == [3, 1, 6]
    assert [int(v) for v in inv] == [M64 // 3, M64, M64 // 6]


@pytest.mark.parametrize("offsets", [[0], [0, 0, 0], [0, 3, 3, 9],
                                     [0, 1, 2, 3], [0, 5, 2 ** 20]])
def test_offsets_are_the_records_bases(offsets):
    """MHOperands keeps the records alone: its offsets are their bases and
    the token count, empty spans included."""
    n = offsets[-1]
    tab = torch.as_tensor(cam.count_table(offsets))
    toks = [torch.zeros(n, dtype=torch.int32) for _ in range(4)]
    ops = cam.MHOperands(*toks, tab, tab.clone())
    for off in (ops.doc_off, ops.ty_off):
        assert off.dtype == torch.int32 and off.tolist() == offsets


@pytest.mark.parametrize("span", ["document", "type"])
def test_built_offsets_are_the_corpus(model, span):
    """The offsets of the built operands: the corpus's document offsets,
    and the types' in type order (cumulative type counts)."""
    c = model.corpus
    ops = _case(model, "all")["ops"]
    if span == "document":
        want, got = np.asarray(c.doc_offsets), ops.doc_off
    else:
        want = np.concatenate([[0], np.cumsum(np.bincount(
            c.tokens, minlength=c.num_types))])
        got = ops.ty_off
    assert got.tolist() == want.tolist()


# ---------------------------------------------------------------------
# the one-launch step's control flow
# ---------------------------------------------------------------------
def _step_emulation(case, rounds, packed):
    """entry_kernel and rounds_kernel over every token at once in numpy
    f32, as the CUDA source computes them: the entry topics gathered into
    canonical and type order and the output, which starts as garbage,
    zeroed; then the records' bases, counts and
    reciprocals, the Barrett modulo, the picks from the gathered entry
    topics, the entry topic's densities for a proposal of it, the
    accepted tokens counted, every real slot written by its token.
    Returns (z over the slots, counts int [rounds, 2])."""
    f32 = np.float32
    ops = case["ops"]
    z_slot = case["z_slot"].numpy()
    slot, slot_ty = ops.slot_of_can.numpy(), ops.slot_of_can_ty.numpy()
    w, d = ops.tok_w.numpy().astype(np.int64), ops.tok_d.numpy()
    n, k = len(w), case["phi"].shape[1]
    beta, au = f32(case["beta"]), f32(case["au"])
    a_sum, kbeta = f32(case["alpha_sum"]), f32(k * case["beta"])
    if packed:
        wk, dk = (t.numpy() for t in cam.pack_reference(*(case[x] for x in (
            "phi", "nkw", "theta", "ndk", "beta", "au"))))

        def dens(i, j):
            return wk[i, 0], wk[i, 1], dk[j, 0], dk[j, 1]
    else:
        phi, nkw = case["phi"].numpy().ravel(), case["nkw"].numpy().ravel()
        th, ndk = case["theta"].numpy().ravel(), case["ndk"].numpy().ravel()

        def dens(i, j):
            return phi[i], nkw[i].astype(f32) + beta, th[j], \
                ndk[j].astype(f32) + au
    mask = case["doc_mask"]
    upd = np.ones(n, bool) if mask is None else mask.numpy()[d]
    d_base, d_cnt, d_inv = _decode(ops.doc_tab.numpy())
    t_base, t_cnt, t_inv = _decode(ops.ty_tab.numpy())
    z_can, z_ty = z_slot[slot], z_slot[slot_ty]        # the pre-pass
    out = np.zeros_like(z_slot)         # the pre-pass zeroes the output
    rec = {0: (t_base[w], t_cnt[w], t_inv[w], z_ty),
           1: (d_base[d], d_cnt[d], d_inv[d], z_can)}
    p_mix = {0: t_cnt[w].astype(f32) / (t_cnt[w].astype(f32) + kbeta),
             1: d_cnt[d].astype(f32) / (d_cnt[d].astype(f32) + a_sum)}
    z0 = z_can.astype(np.int64)
    wK, dK = w * k, d.astype(np.int64) * k
    ph0, qw0, th0, qd0 = dens(wK + z0, dK + z0)
    t0 = th0 * ph0
    zz, t_c, qw_c, qd_c = z0.copy(), t0, qw0, qd0
    seed = int(case["seed"][0])
    key = (torch.tensor([seed & 0xFFFFFFFF]),
           torch.tensor([(seed >> 32) & 0xFFFFFFFF]))
    tok = torch.arange(n, dtype=torch.int64)
    counts = np.zeros((rounds, 2), np.int64)
    inv_k = np.full(n, M64 // k, np.uint64)
    for r in range(rounds):
        for s in (0, 1):
            j = 4 * r + 2 * s
            x = [v.numpy().astype(np.uint64) for v in philox4x32_10(
                tok, torch.full_like(tok, j), *key)]
            y = [v.numpy().astype(np.uint64) for v in philox4x32_10(
                tok, torch.full_like(tok, j + 1), *key)]
            u_mix = (x[0] >> np.uint64(8)).astype(f32) * f32(2.0 ** -24)
            base, cnt, inv, entry = rec[s]
            pos = _mod_exact((x[1] << np.uint64(30)) | (x[2] >> np.uint64(2)),
                             cnt, inv).astype(np.int64)
            pick = entry[np.where(u_mix < p_mix[s], base + pos, 0)]
            topic = _mod_exact((x[3] << np.uint64(30)) | (y[0] >> np.uint64(2)),
                               np.full(n, k, np.uint64), inv_k)
            kp = np.where(u_mix < p_mix[s], pick, topic.astype(np.int64))
            phn, qwn, thn, qdn = dens(wK + kp, dK + kp)
            t_new = thn * phn
            q_new, q_cur = (qwn, qw_c) if s == 0 else (qdn, qd_c)
            u_acc = (y[1] >> np.uint64(8)).astype(f32) * f32(2.0 ** -24)
            acc = upd & (u_acc * np.maximum(t_c * q_new, f32(1e-38))
                         < t_new * q_cur)
            zz = np.where(acc, kp, zz)
            t_c = np.where(acc, t_new, t_c)
            qw_c = np.where(acc, qwn, qw_c)
            qd_c = np.where(acc, qdn, qd_c)
            counts[r, s] = int(acc.sum())
    out[slot] = zz
    return out, counts


@pytest.mark.parametrize("selected", ["all", "half"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
def test_step_on_the_records_gives_the_references_z_and_rates(
        model, selected, packed, rounds):
    """The redesigned kernels' control flow writes alias_mh_reference's z
    on every slot (padding 0, unselected documents' z kept) and its counts
    give the reference's f32 rates, with every document selected and with
    the even ones; the entry z is not written."""
    case = _case(model, selected)
    entry = case["z_slot"].clone()
    z_ref, (acc_w, acc_d) = cam.alias_mh_reference(**case, rounds=rounds,
                                                   packed=packed)
    z_emu, counts = _step_emulation(case, rounds, packed)
    assert np.array_equal(z_emu, z_ref.numpy())
    assert torch.equal(case["z_slot"], entry)
    den = cam.updatable_tokens(case["ops"], case["doc_mask"])
    rw, rd = cam.acceptance_rates(torch.as_tensor(counts, dtype=torch.int32),
                                  den)
    assert torch.equal(rw, acc_w) and torch.equal(rd, acc_d)
    # the CPU wrapper is the plain version, in a new tensor
    z_cpu = cam.alias_mh(**case, rounds=rounds, packed=(
        cam.pack_reference(*(case[x] for x in ("phi", "nkw", "theta", "ndk",
                                               "beta", "au")))
        if packed else None))
    assert torch.equal(z_cpu, z_ref) and z_cpu.data_ptr() != \
        case["z_slot"].data_ptr()


# ---------------------------------------------------------------------
# the VS-Dirichlet cluster
# ---------------------------------------------------------------------
def _slices(num_cols, shape):
    cluster, slice_len = shape[:2]
    return [(min(num_cols, r * slice_len),
             min(num_cols, min(num_cols, r * slice_len) + slice_len))
            for r in range(cluster)]


@pytest.mark.parametrize("num_cols", [
    1, 2, 7, 40, 255, 256, 2047, 2048, 2049, 4095, 4096, 5000, 8191,
    16_384, 16_385, 19_999, 20_000, 20_001, 100_003, 200_000, 348_160,
    450_000, 1_000_000])
def test_vs_launch_shape_covers_each_value_once(num_cols):
    """Every value of a row falls in exactly one rank's slice; the cluster
    is 1 to VS_CLUSTER_MAX blocks, a slice at least VS_SLICE_MIN / 2
    values where the row is split, drawn in chunks of at most VS_CHUNK
    (the whole slice where it fits); the kept values fit the shared
    memory with a chunk's queue, draws and list, and a slice that
    overflows keeps whole chunks."""
    shape = cuda_gamma.vs_launch_shape(num_cols)
    cluster, slice_len, chunk, resident, smem = shape
    assert 1 <= cluster <= cuda_gamma.VS_CLUSTER_MAX
    assert cluster * slice_len >= num_cols
    assert cluster == 1 or slice_len >= cuda_gamma.VS_SLICE_MIN // 2
    cover = np.zeros(num_cols, np.int64)
    for lo, hi in _slices(num_cols, shape):
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert smem <= cuda_gamma.VS_SMEM
    assert chunk == min(slice_len, cuda_gamma.VS_CHUNK)
    assert smem == 4 * resident + 10 * chunk
    if resident < slice_len:
        assert resident % chunk == 0 and resident > 0
    else:
        assert resident == slice_len


def test_vs_launch_shape_at_the_main_paths_rows():
    """nzvsspalias's rows of V = 20,000: 8 blocks of 2,500, each drawn as
    one chunk and kept."""
    assert cuda_gamma.vs_launch_shape(20_000) == (8, 2500, 2500, 2500,
                                                  14 * 2500)


def _kernel_sum(values, num_cols, shape):
    """The VS kernel's f64 sum of a row: each rank's threads sum their
    values chunk by chunk (thread i takes i, i + 256, ... of a chunk), a
    warp's lanes by the xor butterfly (lane 0's value), the block's warps
    in order, then the ranks in rank order."""
    chunk = shape[2]
    total = 0.0
    for lo, hi in _slices(num_cols, shape):
        per = np.zeros(THREADS)
        for t0 in range(lo, hi, chunk):
            e_n = min(chunk, hi - t0)
            for e in range(e_n):
                per[e % THREADS] += values[t0 + e]
        lanes = per.reshape(-1, 32)
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        part = 0.0
        for wsum in lanes[:, 0]:
            part += wsum
        total += part
    return total


@pytest.mark.parametrize("num_cols,rows,ints",
                         [(20_000, 3, True), (5000, 4, False),
                          (40, 3, True), (2049, 2, False),
                          (30_000, 2, True)])
def test_vs_cluster_sums_are_the_plain_versions(num_cols, rows, ints):
    """n_k summed in the kernel's order is the plain version's (integer
    counts exactly; float counts to f32), so p and the inclusion mask are
    the plain version's; the row total in the kernel's order is within 1
    ulp of the plain version's f32 total."""
    rng = np.random.default_rng(num_cols)
    counts = rng.poisson(0.3, (rows, num_cols)).astype(np.float32)
    if not ints:
        counts += rng.random((rows, num_cols)).astype(np.float32)
    prev = np.where(rng.random((rows, num_cols)) < 0.4, 0.0,
                    rng.random((rows, num_cols))).astype(np.float32)
    x = torch.as_tensor(counts.astype(np.int32) if ints else counts)
    seed = _seed(0x0715_C0FF_EE00 + num_cols)
    beta, prior = 0.01, 0.5
    phi, excl = cuda_gamma.vs_dirichlet_reference(x, beta, prior, seed,
                                                  torch.as_tensor(prev), True)
    shape = cuda_gamma.vs_launch_shape(num_cols)
    c32 = torch.as_tensor(counts if not ints else counts.astype(np.int32)
                          ).to(torch.float32)
    g = cuda_gamma.gamma_reference(c32 + beta, seed).clamp_min(
        cuda_gamma.DIRICHLET_FLOOR).numpy()
    u = cuda_gamma.vs_uniforms(c32.shape, seed).numpy()
    for r in range(rows):
        nk = np.float32(_kernel_sum(c32[r].numpy().astype(np.float64),
                                    num_cols, shape))
        assert nk == np.float32(c32[r].double().sum())
        zp = np.float32((prev[r] == 0).sum())
        p = rnd.vs_inclusion_prob(torch.tensor([[zp]]), torch.tensor([[nk]]),
                                  beta, prior)
        include = (c32[r].numpy() > 0) | (u[r] <= float(p))
        assert np.array_equal(~include, excl[r].numpy())
        kept = np.where(include, g[r], 0.0).astype(np.float32)
        total = np.float32(_kernel_sum(kept.astype(np.float64), num_cols,
                                       shape))
        want = np.float32(torch.as_tensor(kept).double().sum())
        assert abs(int(total.view(np.int32)) - int(want.view(np.int32))) <= 1
        got = kept / max(total, np.float32(cuda_gamma.DIRICHLET_FLOOR))
        if total == want:
            assert np.array_equal(got, phi[r].numpy())
