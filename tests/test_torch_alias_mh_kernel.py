"""The alias-MH z-step kernels' plain versions on the CPU
(ops/cuda_alias_mh.py): the Philox draws' contract (exact positions and
topics, uniforms on the 2^-24 grid, a token's words by hand and free of
the token count), the int32 operands against the model's, the reference
against the model's CPU step given the same draws, packed against
unpacked, the packed tables against the JAX package's stack, unselected
documents and padding slots, MH invariance by chi-square, an emulation of
csrc/alias_mh.cu's control flow (the Barrett modulo, the entry topic's
densities for a proposal of it, exact acceptance counts) against
the reference, the C entry points' signatures, and the wrappers raising
off the CPU where the build or the launch fails."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy import stats

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models import ggs_aliasmh as gam
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import _build, cuda_alias_mh as cam
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "ldagroupedgibbssampler_tpu_torch", "csrc",
                      "alias_mh.cu")
K = 6
BETA = float(np.float32(0.01))
M64 = (1 << 64) - 1


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
    """A CPU ggs_aliasmh model after 2 iterations at K=6 with an
    asymmetric alpha: its layout, state and int64 operands."""
    cfg = LDAConfig(scheme="ggs_aliasmh", topics=K, alpha=0.5, beta=0.01,
                    seed=5, device="cpu", exec_time=-1, token_block=512)
    m = create_model(cfg).add_instances(_corpus())
    m.state.alpha = torch.linspace(0.1, 1.2, K)
    m.sample(2)
    return m


def _case(m, mask_every=2):
    """The operands of one z-step on the model's state: the int32
    operands, the tables, alpha_sum and au as the model computes them, a
    seed and a document mask selecting every `mask_every`-th document."""
    c, st_ = m.corpus, m.state
    ops = cam.MHOperands.build(c.tokens, c.doc_offsets,
                               m._blocks.flat_index, c.num_types, "cpu")
    a_sum = st_.alpha.sum()
    mask = (torch.arange(c.num_docs) % mask_every) == 0
    return dict(z_slot=st_.z, ops=ops, phi=st_.phi, nkw=st_.nkw,
                theta=st_.theta, ndk=st_.ndk, beta=st_.beta,
                alpha_sum=a_sum, au=a_sum / K,
                seed=_seed(0x0123_4567_89AB_CDEF), doc_mask=mask)


# ---------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------
@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(-2 ** 63, 2 ** 63 - 1), k=st.integers(1, 5000),
       bounds=st.lists(st.one_of(st.integers(1, 40),
                                 st.integers(2 ** 24 - 3, 2 ** 24 + 5),
                                 st.integers(1, 2 ** 31 - 1)),
                       min_size=1, max_size=64))
def test_philox_draws_contract(seed, k, bounds):
    """Positions are int64 in [0, bound) for bounds up to 2^31 - 1, topics
    in [0, K), uniforms f32 in [0, 1) on the 2^-24 grid."""
    hi = torch.tensor(bounds, dtype=torch.int64)
    lo_hi = torch.tensor(bounds[::-1], dtype=torch.int64)
    for r in (0, 3):
        out = cam.philox_draws(_seed(seed), len(bounds), hi, lo_hi, k)(r)
        for pos, b in ((out[1], hi), (out[5], lo_hi)):
            assert pos.dtype == torch.int64
            assert bool((pos >= 0).all() and (pos < b).all())
        for topic in (out[2], out[6]):
            assert bool((topic >= 0).all() and (topic < k).all())
        for u in (out[0], out[3], out[4], out[7]):
            assert u.dtype == torch.float32
            assert bool((u >= 0).all() and (u < 1).all())
            grid = u.double() * 2 ** 24
            assert torch.equal(grid, grid.floor())


def test_positions_reach_past_two_to_the_24():
    """At the largest bound the positions reach odd values above 2^30,
    which an f32 uniform scaled to the bound cannot."""
    n = 20_000
    hi = torch.full((n,), 2 ** 31 - 1, dtype=torch.int64)
    pos = cam.philox_draws(_seed(7), n, hi, hi, 3)(0)[1]
    assert bool((pos % 2 == 1).any()) and int(pos.max()) > 2 ** 30


def test_a_tokens_words_by_hand():
    """Token t's draws of round r, step s, from the blocks at counters
    (j << 32) | t, j = 4 r + 2 s, j + 1, as the kernel's header lays
    them out."""
    seed, t, r, k = 0x7EED_0000_1234_5678, 37, 2, 1000
    hi = torch.full((t + 1,), 12345, dtype=torch.int64)
    lo = torch.full((t + 1,), 99, dtype=torch.int64)
    got = cam.philox_draws(_seed(seed), t + 1, hi, lo, k)(r)

    def words(ctr):
        c = torch.tensor([ctr], dtype=torch.int64)
        return [int(x) for x in philox4x32_10(
            c, c >> 32, torch.tensor([seed & 0xFFFFFFFF]),
            torch.tensor([seed >> 32]))]
    for s, bound in ((0, 12345), (1, 99)):
        j = 4 * r + 2 * s
        a, b = words((j << 32) | t), words(((j + 1) << 32) | t)
        want = ((a[0] >> 8) / 2 ** 24, ((a[1] << 32 | a[2]) >> 2) % bound,
                ((a[3] << 32 | b[0]) >> 2) % k, (b[1] >> 8) / 2 ** 24)
        for x, y in zip(got[4 * s: 4 * s + 4], want):
            assert float(x[t]) == y


def test_a_tokens_draws_do_not_depend_on_the_token_count():
    """The draws for a prefix of the corpus are the first tokens' draws
    for the whole corpus, in every round."""
    n, m = 1500, 411
    rng = np.random.default_rng(3)
    hi = torch.as_tensor(rng.integers(1, 10 ** 6, n))
    lo = torch.as_tensor(rng.integers(1, 500, n))
    full = cam.philox_draws(_seed(-5), n, hi, lo, 77)
    part = cam.philox_draws(_seed(-5), m, hi[:m], lo[:m], 77)
    for r in range(3):
        for a, b in zip(full(r), part(r)):
            assert torch.equal(a[:m], b)


# ---------------------------------------------------------------------
# the operands and the reference
# ---------------------------------------------------------------------
def test_operands_are_the_models(model):
    """The int32 operands give the model's int64 ones: the slots, the type
    order, the bases and the bounds."""
    ops = _case(model)["ops"]
    assert all(getattr(ops, f).dtype == torch.int32 for f in (
        "slot_of_can", "slot_of_can_ty", "tok_w", "tok_d", "doc_off",
        "ty_off"))
    w, d = ops.tok_w.long(), ops.tok_d.long()
    assert torch.equal(ops.slot_of_can.long(), model._mh_slot_of_can)
    assert torch.equal(ops.slot_of_can_ty.long(),
                       model._mh_slot_of_can[model._mh_ty_perm])
    assert torch.equal(w, model._mh_w) and torch.equal(d, model._mh_d)
    doc_off, ty_off = ops.doc_off.long(), ops.ty_off.long()
    assert torch.equal(doc_off[d], model._mh_doc_base)
    assert torch.equal(doc_off[d + 1] - doc_off[d], model._mh_doc_len)
    assert torch.equal(ty_off[w], model._mh_ty_base)
    assert torch.equal(ty_off[w + 1] - ty_off[w], model._mh_ty_cnt)


@pytest.mark.parametrize("packed", [False, True])
def test_reference_is_the_models_cpu_step_given_its_draws(model, packed,
                                                          monkeypatch):
    """The model's CPU step, its rounds fed the Philox draws of one seed,
    writes the z of alias_mh_reference on every slot."""
    case = _case(model, mask_every=1)
    case.pop("doc_mask")
    orig = gam.alias_mh_rounds

    def philox_rounds(*args, generator=None, draws=None):
        n, ty_cnt, doc_len, k = (args[0].shape[0], args[9], args[8],
                                 args[10])
        return orig(*args, draws=cam.philox_draws(
            case["seed"], n, ty_cnt.clamp_min(1), doc_len.clamp_min(1), k))
    monkeypatch.setattr(gam, "alias_mh_rounds", philox_rounds)
    model.config.aliasmh_packed = "packed" if packed else "unpacked"
    try:
        st_ = model.state
        z = model._eager_z_step(st_, st_.theta, None, case["alpha_sum"],
                                case["au"])
    finally:
        model.config.aliasmh_packed = "auto"
    want, _ = cam.alias_mh_reference(**case, rounds=2, packed=packed)
    assert torch.equal(z, want)


def _pack_jax(phi, nkw, theta, ndk, beta, au):
    """The JAX package's `_step` stack of the same tables."""
    f32 = jnp.float32
    return (jnp.stack([jnp.asarray(phi).reshape(-1),
                       jnp.asarray(nkw).astype(f32).reshape(-1) + beta], 1),
            jnp.stack([jnp.asarray(theta).reshape(-1),
                       jnp.asarray(ndk).astype(f32).reshape(-1)
                       + jnp.asarray(au)], 1))


def test_pack_reference_is_the_jax_stack_and_packed_equals_unpacked(model):
    """pack_reference equals the JAX package's stacked tables bit for bit;
    the reference on them gives the unpacked z and rates."""
    case = _case(model)
    a = [case[n].numpy() for n in ("phi", "nkw", "theta", "ndk")]
    packs = cam.pack_reference(*(case[n] for n in (
        "phi", "nkw", "theta", "ndk", "beta", "au")))
    for ours, theirs in zip(packs, _pack_jax(*a, case["beta"],
                                             case["au"].numpy())):
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
    for rounds in (1, 3):
        zp, ratesp = cam.alias_mh_reference(**case, rounds=rounds,
                                            packed=True)
        zu, ratesu = cam.alias_mh_reference(**case, rounds=rounds)
        assert torch.equal(zp, zu)
        assert all(torch.equal(x, y) for x, y in zip(ratesp, ratesu))
    assert torch.equal(cam.pack_tables(*(case[n] for n in (
        "phi", "nkw", "theta", "ndk", "beta", "au")))[0], packs[0])


def test_unselected_documents_keep_z_and_padding_slots_are_zero(model):
    """Tokens of unselected documents keep z, padding slots are 0, some
    selected tokens move; the wrappers' CPU path is the reference."""
    case = _case(model, mask_every=3)
    z, rates = cam.alias_mh_reference(**case, rounds=2)
    ops, z0 = case["ops"], case["z_slot"]
    real = ops.slot_of_can.long()
    pad = torch.ones(z0.shape, dtype=torch.bool)
    pad[real] = False
    assert bool(pad.any()) and bool((z[pad] == 0).all())
    unsel = ~case["doc_mask"][ops.tok_d.long()]
    assert torch.equal(z[real[unsel]], z0[real[unsel]])
    assert bool((z[real[~unsel]] != z0[real[~unsel]]).any())
    assert all(bool(((r > 0) & (r <= 1)).all()) for r in rates)
    kw = {n: case[n] for n in case if n not in ("z_slot", "ops")}
    assert torch.equal(cam.alias_mh(z0, ops, **kw, rounds=2), z)
    with pytest.raises(ValueError, match="acc_counts"):
        cam.alias_mh(z0, ops, **kw, rounds=2,
                     acc_counts=torch.zeros((2, 2), dtype=torch.int32))


def test_mh_rounds_leave_the_target_invariant():
    """80 documents of 300 tokens over 12 types, z drawn exactly from
    theta[d] phi[., w]; after 8 rounds z still follows it: chi-square of
    the tokens' topics by (document group, type) cell, p > 1e-4; about
    half the tokens moved."""
    rng = np.random.default_rng(11)
    k, v, docs, length = 5, 12, 80, 300
    tokens = rng.integers(0, v, docs * length)
    offsets = np.arange(0, docs * length + 1, length)
    corpus = Corpus(tokens=tokens.astype(np.int32), doc_offsets=offsets,
                    vocab=[f"w{i}" for i in range(v)])
    blocks = corpus.cell_blocks(block=512, vspan=128, dspan=128)
    ops = cam.MHOperands.build(tokens, offsets, blocks.flat_index, v, "cpu")
    # 4 groups of documents share a theta row, so cells stay populated
    theta = rng.dirichlet(np.full(k, 1.5), 4).astype(np.float32)[
        np.arange(docs) % 4]
    phi = rng.dirichlet(np.full(v, 1.0), k).T.astype(np.float32)
    p = theta[np.repeat(np.arange(docs), length)] * phi[tokens]
    p /= p.sum(axis=1, keepdims=True)
    z = np.minimum((rng.random(len(tokens))[:, None]
                    > np.cumsum(p, axis=1)).sum(1), k - 1)
    z_slot = torch.zeros(blocks.flat_index.size, dtype=torch.int32)
    z_slot[ops.slot_of_can.long()] = torch.as_tensor(z, dtype=torch.int32)
    nkw = np.zeros((v, k), np.int32)
    np.add.at(nkw, (tokens, z), 1)
    ndk = np.zeros((docs, k), np.int32)
    np.add.at(ndk, (np.repeat(np.arange(docs), length), z), 1)
    a_sum = torch.tensor(0.1 * k, dtype=torch.float32)
    out, rates = cam.alias_mh_reference(
        z_slot, ops, torch.as_tensor(phi), torch.as_tensor(nkw),
        torch.as_tensor(theta), torch.as_tensor(ndk), BETA, a_sum, a_sum / k,
        _seed(2024), 8)
    z8 = out[ops.slot_of_can.long()].numpy()
    moved = float((z8 != z).mean())
    assert 0.3 < moved < 0.95, moved
    cell = (np.repeat(np.arange(docs), length) % 4) * v + tokens
    obs = np.zeros((4 * v, k))
    np.add.at(obs, (cell, z8), 1)
    expect = np.zeros((4 * v, k))
    np.add.at(expect, cell, p)
    keep = expect > 5
    chi2 = float((((obs - expect) ** 2)[keep] / expect[keep]).sum())
    dof = int(keep.sum()) - int(keep.any(axis=1).sum())
    assert stats.chi2.sf(chi2, dof) > 1e-4, (chi2, dof)
    assert all(float(r.min()) > 0.3 for r in rates)


# ---------------------------------------------------------------------
# csrc/alias_mh.cu's control flow
# ---------------------------------------------------------------------
def _mulhi64(a, b):
    """The high 64 bits of a b for uint64 arrays (__umul64hi)."""
    m = np.uint64(0xFFFFFFFF)
    s = np.uint64(32)
    a0, a1, b0, b1 = a & m, a >> s, b & m, b >> s
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> s) + (p01 & m) + (p10 & m)
    return p11 + (p01 >> s) + (p10 >> s) + (mid >> s)


def _mod_exact(x, m, inv):
    """The kernel's mod_exact: a Barrett estimate and two subtractions."""
    r = x - _mulhi64(x, inv) * m
    for _ in range(2):
        r = np.where(r >= m, r - m, r)
    return r


@settings(max_examples=200, deadline=None, database=None)
@given(x=st.lists(st.integers(0, 2 ** 62 - 1), min_size=1, max_size=20),
       m=st.integers(1, 2 ** 32 - 1))
def test_barrett_modulo_is_exact(x, m):
    """mod_exact with inv = floor((2^64 - 1) / m) equals x mod m for every
    62-bit x and 32-bit m."""
    xs = np.array(x, np.uint64)
    mm = np.full(xs.shape, m, np.uint64)
    inv = np.full(xs.shape, M64 // m, np.uint64)
    assert [int(r) for r in _mod_exact(xs, mm, inv)] == [v % m for v in x]


def _kernel_emulation(case, rounds, packed):
    """rounds_kernel over every token at once in numpy f32, as the CUDA
    source computes it: the per-token operands, the Barrett modulo, a
    proposal of the entry topic reading its densities (checked equal to a
    gather), and the accepted tokens counted exactly. The kernel draws a
    batch of steps' proposals before their accept tests, which changes
    nothing here: a proposal depends on the entry topics and the draws
    alone. Returns (z over the slots, counts int [rounds, 2])."""
    f32 = np.float32
    ops = case["ops"]
    z_slot = case["z_slot"].numpy()
    z_can = z_slot[ops.slot_of_can.numpy()]
    z_ty = z_slot[ops.slot_of_can_ty.numpy()]
    w, d = ops.tok_w.numpy().astype(np.int64), ops.tok_d.numpy()
    doc_off, ty_off = ops.doc_off.numpy(), ops.ty_off.numpy()
    n, k = len(w), case["phi"].shape[1]
    beta, au = f32(case["beta"]), f32(case["au"])
    a_sum = f32(case["alpha_sum"])
    kbeta = f32(k * case["beta"])
    if packed:
        wk, dk = (t.numpy() for t in cam.pack_reference(*(case[x] for x in (
            "phi", "nkw", "theta", "ndk", "beta", "au"))))

        def dens_w(i):
            return wk[i, 0], wk[i, 1]

        def dens_d(i):
            return dk[i, 0], dk[i, 1]
    else:
        phi, nkw = case["phi"].numpy().ravel(), case["nkw"].numpy().ravel()
        th, ndk = case["theta"].numpy().ravel(), case["ndk"].numpy().ravel()

        def dens_w(i):
            return phi[i], nkw[i].astype(f32) + beta

        def dens_d(i):
            return th[i], ndk[i].astype(f32) + au
    upd = case["doc_mask"].numpy()[d]
    doc_base, ty_base = doc_off[d], ty_off[w]
    doc_len, ty_cnt = doc_off[d + 1] - doc_base, ty_off[w + 1] - ty_base
    hi = {0: np.maximum(ty_cnt, 1).astype(np.uint64),
          1: np.maximum(doc_len, 1).astype(np.uint64)}
    inv = {s: np.array([M64 // int(m) for m in hi[s]], np.uint64)
           for s in hi}
    kk = np.full(n, k, np.uint64)
    inv_k = np.full(n, M64 // k, np.uint64)
    cw, ld = ty_cnt.astype(f32), doc_len.astype(f32)
    p_mix = {0: cw / (cw + kbeta), 1: ld / (ld + a_sum)}
    wK, dK = w * k, d.astype(np.int64) * k
    zz = z_can.astype(np.int64)
    ph0, qw0 = dens_w(wK + zz)
    th0, qd0 = dens_d(dK + zz)
    t0 = th0 * ph0
    t_c, qw_c, qd_c = t0, qw0, qd0
    seed = int(case["seed"][0])
    key = (torch.tensor([seed & 0xFFFFFFFF]), torch.tensor([(seed >> 32)
                                                            & 0xFFFFFFFF]))
    tok = torch.arange(n, dtype=torch.int64)
    counts = np.zeros((rounds, 2), np.int64)
    for r in range(rounds):
        for s in (0, 1):
            j = 4 * r + 2 * s
            a = [x.numpy().astype(np.uint64) for x in philox4x32_10(
                tok, torch.full_like(tok, j), *key)]
            b = [x.numpy().astype(np.uint64) for x in philox4x32_10(
                tok, torch.full_like(tok, j + 1), *key)]
            u_mix = (a[0] >> np.uint64(8)).astype(f32) * f32(2.0 ** -24)
            pos = _mod_exact((a[1] << np.uint64(30)) | (a[2] >> np.uint64(2)),
                             hi[s], inv[s]).astype(np.int64)
            pick = (z_ty[ty_base + pos] if s == 0
                    else z_can[doc_base + pos])
            topic = _mod_exact((a[3] << np.uint64(30)) | (b[0] >> np.uint64(2)),
                               kk, inv_k).astype(np.int64)
            kp = np.where(u_mix < p_mix[s], pick, topic)
            phn, qw_new = dens_w(wK + kp)
            thn, qd_new = dens_d(dK + kp)
            t_new = thn * phn
            # the kernel reads the entry topic's densities for a proposal
            # of it: the values a gather returns
            same = kp == z_can
            assert np.array_equal(t_new[same], t0[same])
            assert np.array_equal(qw_new[same], qw0[same])
            assert np.array_equal(qd_new[same], qd0[same])
            q_new, q_cur = (qw_new, qw_c) if s == 0 else (qd_new, qd_c)
            u_acc = (b[1] >> np.uint64(8)).astype(f32) * f32(2.0 ** -24)
            acc = upd & (u_acc * np.maximum(t_c * q_new, f32(1e-38))
                         < t_new * q_cur)
            zz = np.where(acc, kp, zz)
            t_c = np.where(acc, t_new, t_c)
            qw_c = np.where(acc, qw_new, qw_c)
            qd_c = np.where(acc, qd_new, qd_c)
            counts[r, s] = int(acc.sum())
    out = np.zeros_like(z_slot)
    out[ops.slot_of_can.numpy()] = zz
    return out, counts


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_kernel_control_flow_gives_the_references_z_and_rates(model, packed,
                                                              rounds):
    """The kernel's control flow (the emulation) writes the reference's z
    on every slot, and its exact counts give the reference's f32 rates
    through acceptance_rates, over half the documents."""
    case = _case(model)
    z_ref, (acc_w, acc_d) = cam.alias_mh_reference(**case, rounds=rounds,
                                                   packed=packed)
    z_emu, counts = _kernel_emulation(case, rounds, packed)
    assert np.array_equal(z_emu, z_ref.numpy())
    den = cam.updatable_tokens(case["ops"], case["doc_mask"])
    assert int(den) == int(case["doc_mask"][case["ops"].tok_d.long()].sum())
    rw, rd = cam.acceptance_rates(torch.as_tensor(counts, dtype=torch.int32),
                                  den)
    assert torch.equal(rw, acc_w) and torch.equal(rd, acc_d)


def test_every_entry_point_has_its_signature():
    """Each extern "C" entry point of csrc/alias_mh.cu has an
    _build._SIGNATURES entry with one argtype a parameter."""
    text = open(SOURCE, encoding="utf-8").read()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    assert [name for name, _ in found] == [
        "lda_alias_mh_entry", "lda_alias_mh_rounds", "lda_alias_mh_pack"]
    for name, params in found:
        assert len(_build._SIGNATURES[name]) == len(params.split(",")), name


def test_wrappers_raise_when_the_build_or_the_launch_fails(model,
                                                           monkeypatch,
                                                           tmp_path):
    """A tensor off the CPU launches the kernel or raises: with nvcc
    failing the build raises; with a library whose entry points return a
    CUDA error the launch raises; no launch is counted and nothing falls
    back to the plain version (meta tensors stand in for the card)."""
    case = _case(model)
    meta = {n: (t.to("meta") if isinstance(t, torch.Tensor) else t)
            for n, t in case.items()}
    meta["ops"] = cam.MHOperands(*(t.to("meta") for t in (
        case["ops"].slot_of_can, case["ops"].slot_of_can_ty,
        case["ops"].tok_w, case["ops"].tok_d, case["ops"].doc_tab,
        case["ops"].ty_tab)))
    tables = [meta[n] for n in ("phi", "nkw", "theta", "ndk", "beta", "au")]
    calls = ((lambda: cam.alias_mh(**meta, rounds=2), "lda_alias_mh_entry"),
             (lambda: cam.mh_rounds(
                 *(torch.empty(meta["ops"].num_tokens, dtype=torch.int32,
                               device="meta") for _ in range(2)),
                 meta["z_slot"], meta["ops"], *tables[:5],
                 meta["alpha_sum"], meta["au"], meta["seed"], 2),
              "lda_alias_mh_rounds"),
             (lambda: cam.pack_tables(*tables), "lda_alias_mh_pack"))

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
    before = [f.launches for f in (cam.entry_topics, cam.mh_rounds,
                                   cam.pack_tables)]
    for call, name in calls:
        with pytest.raises(RuntimeError, match=f"{name} failed"):
            call()
    assert [f.launches for f in (cam.entry_topics, cam.mh_rounds,
                                 cam.pack_tables)] == before
