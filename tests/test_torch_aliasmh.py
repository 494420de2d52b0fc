"""Scheme `ggs_aliasmh` of the port on the CPU against the JAX package's:
its MH rounds given the same draws, its two table layouts, its count
rebuild, its chain and the CLI (tests/test_e2e_samplers.py's
`test_aliasmh_*` cases, copied onto the port)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config.lda_config import (
    LDAConfig as JaxConfig)
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.models.ggs_aliasmh import (
    alias_mh_rounds as jax_alias_mh_rounds)
from ldagroupedgibbssampler_tpu.models.registry import (
    create_model as jax_create_model)
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models import ggs_aliasmh as gam
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.tui import parallel_lda

ITERS = 30
CFG = dict(topics=3, alpha=1.0, beta=0.01, exec_time=-1, token_block=512)


@pytest.fixture(scope="module")
def corpus():
    """tests/conftest.py's synthetic_corpus, as a port Corpus."""
    rng = np.random.default_rng(42)
    num_topics, types_per_topic, num_docs, doc_len = 3, 10, 60, 40
    vocab = [f"w{k}_{i}" for k in range(num_topics)
             for i in range(types_per_topic)]
    docs = []
    for d in range(num_docs):
        k = d % num_topics
        main = rng.integers(0, types_per_topic, int(doc_len * 0.9)) \
            + k * types_per_topic
        noise = rng.integers(0, len(vocab), doc_len - len(main))
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(docs, vocab)


def _jax_corpus(corpus):
    return JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                     vocab=corpus.vocab)


@pytest.fixture(scope="module")
def jax_model(corpus):
    """One JAX ggs_aliasmh instance; chains restart through
    add_instances(key=...), sharing its compiled step."""
    model = jax_create_model(JaxConfig(scheme="ggs_aliasmh", seed=7,
                                       topic_interval=ITERS, **CFG))
    return model, _jax_corpus(corpus)


def _port(corpus, **kw):
    cfg = LDAConfig(scheme="ggs_aliasmh", seed=7, device="cpu",
                    **{**CFG, **kw})
    return create_model(cfg).add_instances(corpus)


def _recounts(corpus, z, num_topics=3):
    nkw = np.zeros((corpus.num_types, num_topics), np.int64)
    np.add.at(nkw, (corpus.tokens, z), 1)
    ndk = np.zeros((corpus.num_docs, num_topics), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    return nkw, ndk


# ---------------------------------------------------------------------
# alias_mh_rounds against the JAX function, given the same draws
# ---------------------------------------------------------------------
def _jax_round_draws(key, rounds, n, ty_hi, doc_hi, k):
    """The eight arrays of each round, drawn as the JAX function draws
    them: split(key, rounds), then split(kr, 8) and one draw a subkey."""
    out = []
    for kr in jax.random.split(key, rounds):
        ks = jax.random.split(kr, 8)
        out.append(tuple(np.array(a) for a in (
            jax.random.uniform(ks[0], (n,)),
            jax.random.randint(ks[1], (n,), 0, ty_hi, jnp.int32),
            jax.random.randint(ks[2], (n,), 0, k, jnp.int32),
            jax.random.uniform(ks[3], (n,)),
            jax.random.uniform(ks[4], (n,)),
            jax.random.randint(ks[5], (n,), 0, doc_hi, jnp.int32),
            jax.random.randint(ks[6], (n,), 0, k, jnp.int32),
            jax.random.uniform(ks[7], (n,)))))
    return out


def _mh_operands(corpus, k, seed=11):
    """numpy operands of the rounds: tables, z, the canonical token
    arrays and a document mask (every 4th document unselected). Table
    entries are well above the f32 normal range, so no product rounds to
    a subnormal in either framework."""
    rng = np.random.default_rng(seed)
    v, d, n = corpus.num_types, corpus.num_docs, corpus.num_tokens
    w = corpus.tokens.astype(np.int64)
    doc = corpus.token_doc_ids().astype(np.int64)
    z = rng.integers(0, k, n).astype(np.int32)
    nkw = np.zeros((v, k), np.int32)
    np.add.at(nkw, (w, z), 1)
    ndk = np.zeros((d, k), np.int32)
    np.add.at(ndk, (doc, z), 1)
    lengths = np.diff(corpus.doc_offsets).astype(np.int64)
    ty_cnt = np.bincount(w, minlength=v).astype(np.int64)
    ty_off = np.concatenate([[0], np.cumsum(ty_cnt)[:-1]])
    beta, alpha = 0.01, np.full(k, 0.5, np.float32)
    a_sum = np.float32(alpha.sum())
    cw, ld = ty_cnt[w].astype(np.float32), lengths[doc].astype(np.float32)
    return dict(
        phi=rng.dirichlet(np.full(v, 2.0), k).T.astype(np.float32),
        theta=rng.dirichlet(np.full(k, 2.0), d).astype(np.float32),
        nkw=nkw, ndk=ndk, z=z, w=w, doc=doc, beta=beta,
        au=np.float32(a_sum / np.float32(k)),
        upd_ok=(doc % 4) != 0,
        p_tok_w=(cw / (cw + np.float32(k * beta))).astype(np.float32),
        p_tok_d=(ld / (ld + a_sum)).astype(np.float32),
        doc_base=corpus.doc_offsets[:-1].astype(np.int64)[doc],
        ty_base=ty_off[w], ty_perm=np.argsort(w, kind="stable"),
        doc_len=lengths[doc], ty_cnt=ty_cnt[w])


def _gathers(xp, o, k, packed, cast):
    """gather_w / gather_d over numpy operands `o` in framework `xp` (jnp
    or torch), packed [., 2] rows or straight from the tables, as the two
    models build them."""
    t = {name: xp.asarray(o[name]) if xp is jnp else torch.as_tensor(o[name])
         for name in ("phi", "theta", "nkw", "ndk", "w", "doc")}
    f32 = jnp.float32 if xp is jnp else torch.float32
    wk, dk = t["w"] * k, t["doc"] * k
    if packed:
        wk_pack = xp.stack([t["phi"].reshape(-1),
                            cast(t["nkw"], f32).reshape(-1) + o["beta"]], 1)
        dk_pack = xp.stack([t["theta"].reshape(-1),
                            cast(t["ndk"], f32).reshape(-1) + o["au"]], 1)

        def gw(kk):
            r = wk_pack[wk + kk]
            return r[:, 0], r[:, 1]

        def gd(kk):
            r = dk_pack[dk + kk]
            return r[:, 0], r[:, 1]
        return gw, gd
    phi, nkw = t["phi"].reshape(-1), t["nkw"].reshape(-1)
    th, ndk = t["theta"].reshape(-1), t["ndk"].reshape(-1)

    def gw(kk):
        return phi[wk + kk], cast(nkw[wk + kk], f32) + o["beta"]

    def gd(kk):
        return th[dk + kk], cast(ndk[dk + kk], f32) + o["au"]
    return gw, gd


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("packed", [True, False])
def test_alias_mh_rounds_match_jax_given_its_draws(corpus, rounds, packed):
    """The same tables and the JAX function's own draws, fed through the
    `draws` hook, give identical z and acceptance rates equal to 1e-6
    (the rates are f32 counts over f32 totals; both sides count the same
    booleans)."""
    k = 5
    o = _mh_operands(corpus, k)
    n = corpus.num_tokens
    key = jax.random.key(3)
    # JAX
    gw, gd = _gathers(jnp, o, k, packed, lambda a, t: a.astype(t))
    z_entry = jnp.asarray(o["z"])
    z_ty = z_entry[jnp.asarray(o["ty_perm"])]
    doc_base, ty_base = jnp.asarray(o["doc_base"]), jnp.asarray(o["ty_base"])
    z_jax, (aw_jax, ad_jax) = jax_alias_mh_rounds(
        key, z_entry, gw, gd, jnp.asarray(o["upd_ok"]),
        jnp.asarray(o["p_tok_w"]), jnp.asarray(o["p_tok_d"]),
        lambda pos: z_entry[doc_base + pos], lambda pos: z_ty[ty_base + pos],
        jnp.asarray(o["doc_len"].astype(np.int32)),
        jnp.asarray(o["ty_cnt"].astype(np.int32)), k, rounds)
    # the port, given the draws the JAX function made
    draws = _jax_round_draws(key, rounds, n,
                             np.maximum(o["ty_cnt"], 1).astype(np.int32),
                             np.maximum(o["doc_len"], 1).astype(np.int32), k)
    gw, gd = _gathers(torch, o, k, packed, lambda a, t: a.to(t))
    ze = torch.as_tensor(o["z"])
    ze_ty = ze[torch.as_tensor(o["ty_perm"])]
    tb, db = torch.as_tensor(o["ty_base"]), torch.as_tensor(o["doc_base"])
    z_port, (aw, ad) = gam.alias_mh_rounds(
        ze, gw, gd, torch.as_tensor(o["upd_ok"]),
        torch.as_tensor(o["p_tok_w"]), torch.as_tensor(o["p_tok_d"]),
        lambda pos: ze[db + pos], lambda pos: ze_ty[tb + pos],
        torch.as_tensor(o["doc_len"]), torch.as_tensor(o["ty_cnt"]), k,
        rounds,
        draws=lambda r: tuple(torch.as_tensor(a) for a in draws[r]))
    assert z_port.dtype == torch.int32
    assert np.array_equal(z_port.numpy(), np.asarray(z_jax))
    np.testing.assert_allclose(aw.numpy(), np.asarray(aw_jax), atol=1e-6)
    np.testing.assert_allclose(ad.numpy(), np.asarray(ad_jax), atol=1e-6)
    # unselected documents keep z; some selected tokens moved
    keep = ~o["upd_ok"]
    assert np.array_equal(z_port.numpy()[keep], o["z"][keep])
    assert (z_port.numpy() != o["z"]).any()


def test_generator_draws_are_exact_positions():
    """The default draws: positions are integers in [0, bound) for bounds
    past 2^24 too, topics in [0, K), uniforms in [0, 1)."""
    gen = torch.Generator().manual_seed(0)
    hi = torch.tensor([1, 2, 3, 2 ** 24 + 3, 2 ** 31 - 1] * 2000)
    draws = gam.generator_draws(gen, hi.numel(), hi, hi, 7)(0)
    for pos in (draws[1], draws[5]):
        assert pos.dtype == torch.int64
        assert bool((pos >= 0).all() and (pos < hi).all())
        # the largest bounds reach positions an f32 uniform cannot
        big = pos[hi == 2 ** 31 - 1]
        assert bool((big % 2 == 1).any()) and int(big.max()) > 2 ** 30
    for topic in (draws[2], draws[6]):
        assert int(topic.min()) >= 0 and int(topic.max()) < 7
    for u in (draws[0], draws[3], draws[4], draws[7]):
        assert u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


# ---------------------------------------------------------------------
# the scheme
# ---------------------------------------------------------------------
def test_packed_unpacked_identical(corpus):
    """Both table layouts are the same chain bit for bit (mirrors
    tests/test_e2e_samplers.py::test_aliasmh_packed_unpacked_identical)."""
    zs = []
    for mode in ("packed", "unpacked"):
        m = _port(corpus, aliasmh_packed=mode)
        m.sample(5)
        zs.append(m.get_z_indicators())
    assert np.array_equal(zs[0], zs[1])


def test_packed_gate_follows_jax_budget(corpus):
    m = _port(corpus)
    assert m._mh_packed()
    assert gam._ALIASMH_PACK_BYTES == 4 << 30
    m.config.topics = (4 << 30) // (8 * (corpus.num_types
                                         + corpus.num_docs)) + 1
    assert not m._mh_packed()


def test_no_zdraw_arrays_uploaded(corpus):
    """The scheme never launches the z-draw, so its set-up uploads none of
    the z-draw's own arrays (the JAX class skips them the same way);
    dense ggs still has them."""
    m = _port(corpus)
    assert not m._use_fused_zdraw
    for name in ("dla", "windc", "_real_slots"):
        assert not hasattr(m, name)
    g = create_model(LDAConfig(scheme="ggs", seed=7, device="cpu",
                               **CFG)).add_instances(corpus)
    assert all(hasattr(g, name) for name in ("dla", "windc", "_real_slots"))


def test_canonical_counts_equal_blocked(corpus):
    """The canonical-token scatter (the JAX package's branch above kpad
    4096 on the TPU; the port counts with the blocked kernel at every K)
    equals the blocked rebuild exactly (mirrors tests/test_e2e_samplers.py::
    test_aliasmh_canonical_counts_equal_blocked)."""
    m = _port(corpus)
    m.sample(3)
    z = m.state.z
    z_can = z[m._mh_slot_of_can].to(torch.int64)
    k = m.config.topics
    nkw = torch.zeros((corpus.num_types, k), dtype=torch.int32)
    nkw.index_put_((m._mh_w, z_can), torch.ones_like(z_can, dtype=torch.int32),
                   accumulate=True)
    ndk = torch.zeros((corpus.num_docs, k), dtype=torch.int32)
    ndk.index_put_((m._mh_d, z_can), torch.ones_like(z_can, dtype=torch.int32),
                   accumulate=True)
    assert torch.equal(nkw, m._count_nkw(z))
    assert torch.equal(ndk, m._count_ndk(z))
    assert torch.equal(nkw, m.state.nkw) and torch.equal(ndk, m.state.ndk)


def test_counts_exact_and_topics_recovered(corpus):
    model = _port(corpus, topic_interval=5)
    model.sample(10)
    nkw, ndk = _recounts(corpus, model.get_z_indicators())
    assert np.array_equal(model.get_topic_type_counts().T, nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=0))
    assert model.get_tokens_per_topic().sum() == corpus.num_tokens
    np.testing.assert_allclose(model.get_phi().sum(axis=1), 1.0, atol=1e-5)
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert len(lls) == 2 and lls[1] > lls[0]


def test_port_ll_within_jax_seed_spread(corpus, jax_model):
    """LL at iteration 30 within the range of 5 JAX ggs_aliasmh chains
    widened by 3 standard deviations (the PRNGs differ, so the chains are
    compared in distribution)."""
    model, jc = jax_model
    finals = []
    for seed in range(5):
        model._ll_history = []
        model.add_instances(jc, key=jax.random.key(100 + seed, impl="rbg"))
        model.sample(ITERS)
        finals.append(model.get_log_likelihoods()[-1][1])
    port = _port(corpus)
    port.sample(ITERS)
    ll = port.model_log_likelihood()
    lo, hi, sd = min(finals), max(finals), float(np.std(finals))
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, finals)


def test_random_scan_unselected_docs_keep_z(corpus):
    """A document mask keeps the theta rows and z of unselected documents;
    their tokens still count."""
    model = _port(corpus)
    st = model.state
    z_before = model.get_z_indicators()
    theta_before = st.theta.clone()
    doc_mask = torch.arange(corpus.num_docs) % 2 == 0
    model._step(st, doc_mask)
    z_after = model.get_z_indicators()
    unsel = ~doc_mask.numpy()[corpus.token_doc_ids()]
    assert np.array_equal(z_after[unsel], z_before[unsel])
    assert not np.array_equal(z_after[~unsel], z_before[~unsel])
    assert torch.equal(st.theta[~doc_mask], theta_before[~doc_mask])
    nkw, ndk = _recounts(corpus, z_after)
    assert np.array_equal(model.get_topic_type_counts().T, nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)


def test_checkpoint_carried_across_from_jax(corpus, jax_model, tmp_path):
    model, jc = jax_model
    model._ll_history = []
    model.add_instances(jc, key=jax.random.key(3, impl="rbg"))
    model.sample(3)
    path = str(tmp_path / "jax_ckpt.npz")
    model.save_checkpoint(path)
    port = _port(corpus)
    port.load_checkpoint(path)
    assert port.state.iteration == 3
    for get in ("get_topic_type_counts", "get_document_topic_matrix",
                "get_tokens_per_topic", "get_z_indicators"):
        assert np.array_equal(getattr(port, get)(), getattr(model, get)())
    np.testing.assert_allclose(port.get_phi(), model.get_phi(), rtol=1e-6)
    port.sample(2)                      # the loaded chain runs on
    nkw, ndk = _recounts(corpus, port.get_z_indicators())
    assert np.array_equal(port.get_topic_type_counts().T, nkw)
    assert np.array_equal(port.get_document_topic_matrix(), ndk)


def test_cli_runs_ggs_aliasmh_on_cpu(tmp_path):
    rng = np.random.default_rng(0)
    themes = [["cat", "lynx", "leopard", "tiger", "kitten", "paw"],
              ["car", "engine", "wheel", "road", "drive", "fuel"],
              ["tree", "leaf", "forest", "branch", "root", "pine"]]
    docs = tmp_path / "docs.txt"
    with open(docs, "w") as f:
        for d in range(60):
            words = [themes[d % 3][i] for i in rng.integers(0, 6, 25)]
            f.write(f"docno:{d}\tL{d % 3}\t{' '.join(words)}\n")
    cfg = tmp_path / "run.cfg"
    cfg.write_text(
        f"configs = mh\nno_runs = 1\nexperiment_out_dir = {tmp_path}/runs\n"
        f"exec_time = 300\niterations = 20\ntopics = 3\nalpha = 1\n"
        f"beta = 0.01\ndataset = {docs}\nrare_threshold = 0\nseed = 2019\n"
        f"topic_interval = 10\nstart_diagnostic = 1\nstoplist =\n\n"
        f"[mh]\nscheme = ggs_aliasmh\naliasmh_rounds = 3\n")
    parallel_lda.main([f"--run_cfg={cfg}", "--device=cpu"])
    runs = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runmh-*"))
    assert len(runs) == 1
    for fn in ("likelihood.txt", "log_posterior.txt", "TopWords.txt",
               "run_metadata.json"):
        assert os.path.exists(os.path.join(runs[0], fn)), fn
    lls = [float(ln.split("\t")[1])
           for ln in open(os.path.join(runs[0], "likelihood.txt"))]
    assert len(lls) == 2 and lls[1] > lls[0] - 50
    top = open(os.path.join(runs[0], "TopWords.txt")).read().splitlines()
    assert len(top) == 3 and top[0].startswith("Topic 0: ")
