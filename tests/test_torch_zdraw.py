"""The z-draw kernel's plain version against the JAX Pallas kernel run in
interpret mode with the same injected uniforms, as
tests/test_pallas_zdraw.py::_run_zdraw runs it; semantics (planted topics,
kept z) and the distribution of the Philox path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu.ops.pallas_zdraw import (
    fused_zdraw_nkw as jax_fused_zdraw_nkw)
from ldagroupedgibbssampler_tpu_torch.ops.cuda_zdraw import (
    fused_zdraw_nkw, fused_zdraw_nkw_reference)
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10


def _inputs(c, z_flat, seed):
    b = c.cell_blocks(block=512, vspan=128, dspan=128, chunk=128)
    nb = b.w_local.shape[0]
    sh3 = (nb, b.w_local.shape[1] // b.chunk, b.chunk)
    fi3 = b.flat_index.reshape(sh3)
    z_old = np.zeros(sh3, np.int32)
    z_old[fi3 >= 0] = z_flat[fi3[fi3 >= 0]]
    u24 = np.random.default_rng(seed).integers(
        0, 2 ** 24, sh3, dtype=np.int64).astype(np.int32)
    return b, sh3, fi3, z_old, u24


def _to_flat(c, fi3, z3):
    out = np.zeros(c.num_tokens, np.int32)
    out[fi3[fi3 >= 0]] = np.asarray(z3)[fi3 >= 0]
    return out


def _run_port(c, K, z_flat, theta, phi, seed=11, precise=False,
              inject=True):
    b, sh3, fi3, z_old, u24 = _inputs(c, z_flat, seed)
    t = torch.as_tensor
    z, nkw = fused_zdraw_nkw(
        t(b.w_local.reshape(sh3)), t(b.d_local_a.reshape(sh3)), t(z_old),
        t(theta), t(phi), torch.tensor([seed], dtype=torch.int64),
        t(b.win_w), t(b.first_w), t(b.win_d_chunks),
        t(u24) if inject else None, nwin_w=b.nwin_w, nwin_d=b.nwin_d,
        vspan=128, dspan=128, num_topics=K, precise=precise)
    return _to_flat(c, fi3, z.numpy()), nkw.numpy()


def _run_jax(c, K, z_flat, theta, phi, seed=11, precise=False):
    b, sh3, fi3, z_old, u24 = _inputs(c, z_flat, seed)
    z, nkw = jax_fused_zdraw_nkw(
        jnp.asarray(b.w_local.reshape(sh3)),
        jnp.asarray(b.d_local_a.reshape(sh3)), jnp.asarray(z_old),
        jnp.asarray(theta), jnp.asarray(phi),
        jnp.asarray([seed], jnp.int32), jnp.asarray(b.win_w),
        jnp.asarray(b.first_w), jnp.asarray(b.win_d_chunks),
        jnp.asarray(u24), nwin_w=b.nwin_w, nwin_d=b.nwin_d,
        vspan=128, dspan=128, num_topics=K, precise=precise,
        interpret=jax.default_backend() != "tpu")
    return _to_flat(c, fi3, z), np.asarray(nkw)


def _corpus(rng, D, V, max_len):
    return Corpus.from_token_lists(
        [list(rng.integers(0, V, rng.integers(3, max_len))) for _ in range(D)],
        [f"w{i}" for i in range(V)])


@pytest.mark.parametrize("K", [13, 200])
@pytest.mark.parametrize("precise", [False, True])
def test_zdraw_reference_matches_jax_kernel(K, precise):
    """Same inputs and uniforms: z agrees on >= 99.9% of tokens (the rest
    are cdf ties summed in another order), and N_kw agrees on every type
    whose tokens all agree. K=200 spans two 128-topic tiles of the TPU
    kernel, exercising its tile offsets."""
    rng = np.random.default_rng(K + precise)
    D, V = 150, 300
    c = _corpus(rng, D, V, 50)
    theta = rng.dirichlet(np.full(K, 0.3), D).astype(np.float32)
    theta[::6] = 0.0                       # unselected docs keep z
    phi = rng.dirichlet(np.full(V, 0.1), K).T.astype(np.float32)
    z_flat = rng.integers(0, K, c.num_tokens).astype(np.int32)
    z_p, nkw_p = _run_port(c, K, z_flat, theta, phi, precise=precise)
    z_j, nkw_j = _run_jax(c, K, z_flat, theta, phi, precise=precise)
    agree = z_p == z_j
    assert agree.mean() >= 0.999, agree.mean()
    bad_types = np.unique(c.tokens[~agree])
    rows = np.setdiff1d(np.arange(V), bad_types)
    assert np.array_equal(nkw_p[rows], nkw_j[rows])
    assert nkw_p[:V].sum() == c.num_tokens


@pytest.mark.parametrize("K,every", [(13, 5), (200, 7)])
def test_zdraw_planted_topics_and_kept_z(K, every):
    """One-hot theta plants each doc's topic; zeroed-theta docs keep z;
    N_kw is the histogram of the returned z (test_zdraw_kernel_semantics_
    interpret), on both the injected-uniform and the Philox path."""
    rng = np.random.default_rng(3)
    D, V = 210, 300
    c = _corpus(rng, D, V, 40)
    doc_topic = (np.arange(D) % K).astype(np.int32)
    theta = np.zeros((D, K), np.float32)
    theta[np.arange(D), doc_topic] = 1.0
    theta[::every] = 0.0
    phi = np.full((V, K), 1.0 / V, np.float32)
    z_flat = rng.integers(0, K, c.num_tokens).astype(np.int32)
    dall = c.token_doc_ids()
    sel = (dall % every) != 0
    for precise in (False, True):
        for inject in (True, False):
            z_out, nkw = _run_port(c, K, z_flat, theta, phi,
                                   precise=precise, inject=inject)
            assert np.array_equal(z_out[sel], doc_topic[dall][sel])
            assert np.array_equal(z_out[~sel], z_flat[~sel])
            ref = np.zeros((V, K), np.int64)
            np.add.at(ref, (c.tokens, z_out), 1)
            assert np.array_equal(nkw[:V].astype(np.int64), ref)
            assert not nkw[V:].any()


@pytest.mark.parametrize("K,precise", [(5, False), (5, True), (100, False)])
def test_zdraw_philox_distribution(K, precise):
    """Chi-square of the Philox path's draws against the exact conditional
    theta_d[k] * phi[k][w] (single-token docs, identical rows)."""
    rng = np.random.default_rng(K)
    D = 12000
    c = Corpus.from_token_lists([[0]] * D, ["w0", "w1"])
    w = rng.gamma(1.0, 1.0, K).astype(np.float32) + 0.05
    theta = np.tile(w / w.sum(), (D, 1))
    phi = np.stack([rng.uniform(0.2, 1.0, K), rng.uniform(0.2, 1.0, K)]
                   ).astype(np.float32)
    p = theta[0] * phi[0]
    p = p / p.sum()
    z_out, _ = _run_port(c, K, np.zeros(D, np.int32), theta, phi, seed=23,
                         precise=precise, inject=False)
    edges = np.linspace(0, K, min(K, 10) + 1).astype(int)
    obs = np.add.reduceat(np.bincount(z_out, minlength=K), edges[:-1])
    exp = np.add.reduceat(p * D, edges[:-1])
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert sps.chi2.sf(chi2, len(exp) - 1) > 1e-4, (obs, exp)


def test_philox_known_answer():
    """Philox4x32-10 of counter 0 under key 0 (the Random123 known-answer
    vector), the generator the CUDA kernel implements."""
    z = torch.zeros(1, dtype=torch.int64)
    out = [int(v) for v in philox4x32_10(z, z, z, z)]
    assert out == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_zdraw_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    c = _corpus(rng, 40, 150, 30)
    theta = rng.dirichlet(np.ones(6), 40).astype(np.float32)
    phi = rng.dirichlet(np.ones(150), 6).T.astype(np.float32)
    b, sh3, fi3, z_old, u24 = _inputs(c, np.zeros(c.num_tokens, np.int32), 2)
    t = torch.as_tensor
    args = (t(b.w_local.reshape(sh3)), t(b.d_local_a.reshape(sh3)),
            t(z_old), t(theta), t(phi), torch.tensor([9], dtype=torch.int64),
            t(b.win_w), t(b.first_w), t(b.win_d_chunks))
    kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=128, dspan=128,
              num_topics=6)
    for a, r in zip(fused_zdraw_nkw(*args, **kw),
                    fused_zdraw_nkw_reference(*args, **kw)):
        assert torch.equal(a, r)
