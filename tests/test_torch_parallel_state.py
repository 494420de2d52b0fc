"""Checkpoints, fold-in and swap of the port's five sharded schemes at 2
gloo ranks on the CPU (tests/torch_parallel_state_worker.py, one process a
rank, spawned once for the module), held to the single-device contract
and to the JAX package's sharded schemes on the 8-device CPU mesh of
tests/conftest.py:

  - a checkpoint round trip leaves every rank's state bit-equal, and the
    next iteration's counts are exact recounts of its z;
  - the file's keys, shapes and dtypes are those the JAX scheme writes;
  - fold-in gives the whole corpus's counts (a recount of its z, N
    tokens), keeps phi, and the chain goes on from it;
  - a swap keeps z, phi and theta and rebuilds the counts for the new
    words; a swap to the same words leaves the chain as it was.

Where the JAX scheme fails at one of these, a test here pins the failure
as a fault of the reference (ROADMAP C).
"""

import importlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from ldagroupedgibbssampler_tpu.config import LDAConfig as JaxConfig
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.models.registry import (
    _SHARDED_SCHEMES as JAX_SHARDED)
from ldagroupedgibbssampler_tpu.parallel.mesh import make_mesh
from torch_parallel_state_worker import FOLD_IN_ITERS, ITERS, shuffled
from torch_parallel_worker import planted_corpus

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_state_worker.py")
WORLD = 2
SCHEMES = tuple(JAX_SHARDED)
DOC_SHARDED = tuple(s for s in SCHEMES if s != "vocab_sharded_ggs")
DEADLINE_S = 300


@pytest.fixture(scope="module")
def corpus():
    return planted_corpus()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("state_ranks"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "RANK", "WORLD_SIZE", "LOCAL_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + [p for p in [env.get("PYTHONPATH")] if p])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(WORLD):
        log = open(os.path.join(out, f"log_{rank}.txt"), "w")
        procs.append((rank, log, subprocess.Popen(
            [sys.executable, WORKER, str(port), str(rank), str(WORLD), out],
            stdout=log, stderr=subprocess.STDOUT, env=env)))
    deadline = time.time() + DEADLINE_S
    try:
        for rank, log, p in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.time()))
            log.close()
            assert rc == 0, f"rank {rank} exited {rc}:\n{open(log.name).read()}"
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return out


def _ranks(out, scheme):
    return [dict(np.load(os.path.join(out, f"state_{scheme}_{r}.npz")))
            for r in range(WORLD)]


def _recounts(corpus, z, k=3):
    nkw = np.zeros((k, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    ndk = np.zeros((corpus.num_docs, k), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    return nkw, ndk


def _assert_exact(corpus, r, prefix):
    nkw, ndk = _recounts(corpus, r[f"{prefix}z"])
    assert np.array_equal(r[f"{prefix}nkw"], nkw)
    assert np.array_equal(r[f"{prefix}ndk"], ndk)
    assert np.array_equal(r[f"{prefix}nk"], nkw.sum(axis=1))
    assert int(r[f"{prefix}nk"].sum()) == corpus.num_tokens


def _jax_model(scheme, corpus, world=WORLD):
    module, cls, _ = JAX_SHARDED[scheme]
    model = getattr(importlib.import_module(
        f"ldagroupedgibbssampler_tpu.{module}"), cls)(
        JaxConfig(scheme=scheme, topics=3, alpha=1.0, beta=0.01, seed=7,
                  exec_time=-1, token_block=256, vocab_span=4, doc_span=16,
                  topic_interval=50), mesh=make_mesh((world,)))
    return model.add_instances(JaxCorpus(tokens=corpus.tokens,
                                         doc_offsets=corpus.doc_offsets,
                                         vocab=corpus.vocab))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_checkpoint_round_trip_bit_equal_on_every_rank(runs, scheme):
    for r in _ranks(runs, scheme):
        saved = sorted(k[len("saved_"):] for k in r if k.startswith("saved_"))
        loaded = sorted(k[len("loaded_"):] for k in r
                        if k.startswith("loaded_"))
        assert saved == loaded
        assert {"z", "ndk", "nkw", "nk", "phi", "alpha", "beta",
                "iteration"} <= set(saved)
        assert ("theta" in saved) == scheme.endswith("ggs")
        for name in saved:
            a, b = r[f"saved_{name}"], r[f"loaded_{name}"]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert int(r["loaded_iteration"]) == ITERS


@pytest.mark.parametrize("scheme", SCHEMES)
def test_next_iteration_after_a_load_counts_exactly(runs, corpus, scheme):
    """The loaded ranks ran one more iteration under the paranoid checks;
    the gathered z recounts to the merged counts on every rank."""
    ranks = _ranks(runs, scheme)
    for r in ranks:
        assert np.array_equal(r["next_z"], ranks[0]["next_z"])
        _assert_exact(corpus, r, "next_")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_checkpoint_file_is_laid_out_as_the_jax_schemes(runs, corpus,
                                                        scheme, tmp_path):
    """The file rank 0 wrote has the keys, shapes and dtypes of the JAX
    scheme's file at the same number of shards; its z is canonical, its
    n_dk the whole corpus's (a recount of z) and its N_kw the merged
    counts, in the JAX scheme's orientation."""
    jm = _jax_model(scheme, corpus)
    jm.sample(ITERS)
    jm.save_checkpoint(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "jax.npz") as d:
        jax_file = {k: (d[k].shape, d[k].dtype) for k in d.files}
    with np.load(os.path.join(runs, f"ckpt_{scheme}.npz")) as d:
        ours = {k: d[k] for k in d.files}
    assert {k: (v.shape, v.dtype) for k, v in ours.items()} == jax_file
    nkw, ndk = _recounts(corpus, ours["z"])
    file_nkw = ours["nkw"] if scheme != "vocab_sharded_ggs" else \
        ours["nkw"].T
    assert np.array_equal(file_nkw, nkw)
    rows = ours["ndk"]
    if rows.ndim == 3:          # [S, Dp, K], shard s's documents first
        from ldagroupedgibbssampler_tpu_torch.parallel.sharded import (
            partition_documents)
        b = partition_documents(corpus, WORLD)
        rows = np.concatenate([rows[s, : b[s + 1] - b[s]]
                               for s in range(WORLD)])
    assert np.array_equal(rows, ndk)
    assert int(ours["iteration"]) == ITERS


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fold_in_gives_the_whole_corpus_counts(runs, corpus, scheme):
    ranks = _ranks(runs, scheme)
    for r in ranks:
        assert np.array_equal(r["foldin_z"], ranks[0]["foldin_z"])
        assert r["foldin_nkw"].sum() == corpus.num_tokens
        _assert_exact(corpus, r, "foldin_")
        assert bool(r["foldin_phi_kept"])
        theta = r["foldin_theta"]
        assert theta.shape == (corpus.num_docs, 3)
        assert np.allclose(theta.sum(axis=1), 1.0, atol=1e-5)
        assert np.array_equal(theta, ranks[0]["foldin_theta"])
        # the chain goes on from the folded-in state, counts exact
        _assert_exact(corpus, r, "foldin_next_")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_swap_keeps_the_latents_and_rebuilds_the_counts(runs, corpus,
                                                        scheme):
    new = shuffled(corpus)
    for r in _ranks(runs, scheme):
        assert np.array_equal(r["swap_z"], r["preswap_z"])
        assert r["swap_phi"].tobytes() == r["preswap_phi"].tobytes()
        assert ("swap_theta" in r) == scheme.endswith("ggs")
        if "swap_theta" in r:
            assert r["swap_theta"].tobytes() == r["preswap_theta"].tobytes()
        _assert_exact(new, r, "swap_")
        assert not np.array_equal(r["swap_nkw"], r["preswap_nkw"])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_swap_to_the_same_words_leaves_the_chain_as_it_was(runs, scheme):
    """Both generators' states are kept: one iteration after a swap to the
    same corpus equals the chain that never swapped."""
    for r in _ranks(runs, scheme):
        for name in ("z", "nkw", "ndk", "nk"):
            assert np.array_equal(r[f"sameswap_{name}"],
                                  r[f"straight_{name}"]), name
        assert r["sameswap_phi"].tobytes() == r["straight_phi"].tobytes()


# ---------------------------------------------------------------------------
# the JAX sharded schemes' failures, which the port does not share
# ---------------------------------------------------------------------------
def _jax_checkpoint(scheme, corpus, tmp_path):
    jm = _jax_model(scheme, corpus)
    jm.sample(ITERS)
    path = str(tmp_path / f"{scheme}.npz")
    jm.save_checkpoint(path)
    return path


def test_jax_sharded_ggs_load_fails_where_the_port_loads(corpus, tmp_path):
    """The JAX ShardedGGS keeps z as [S, Ns] padded shards (layout
    "flat"), and the base `_z_from_flat` copies the canonical z into its
    first row: the load raises."""
    path = _jax_checkpoint("sharded_ggs", corpus, tmp_path)
    with pytest.raises(ValueError, match="could not broadcast"):
        _jax_model("sharded_ggs", corpus).load_checkpoint(path)


def test_jax_vocab_sharded_ggs_load_fails_where_the_port_loads(corpus,
                                                                tmp_path):
    """The JAX VocabShardedGGS has no single-device `_blocks`, which the
    GGS loader reads."""
    path = _jax_checkpoint("vocab_sharded_ggs", corpus, tmp_path)
    with pytest.raises(AttributeError, match="_blocks"):
        _jax_model("vocab_sharded_ggs", corpus).load_checkpoint(path)


def test_jax_vocab_sharded_ggs_fold_in_fails_where_the_port_runs(corpus):
    jm = _jax_model("vocab_sharded_ggs", corpus)
    jm.sample(ITERS)
    with pytest.raises(AttributeError, match="w_pad"):
        jm.sample_z_given_phi(FOLD_IN_ITERS)


def test_jax_sharded_ggs_fold_in_breaks_its_counts(corpus):
    """The JAX base fold-in writes a flat-padded z into ShardedGGS's
    sharded z: the counts it returns are no recount of the z the scheme
    reads back, where the port's are exact."""
    jm = _jax_model("sharded_ggs", corpus)
    jm.sample(ITERS)
    jm.sample_z_given_phi(FOLD_IN_ITERS)
    nkw, _ = _recounts(corpus, jm.get_z_indicators())
    assert int(jm.get_topic_type_counts().sum()) == corpus.num_tokens
    assert not np.array_equal(jm.get_topic_type_counts(), nkw)


@pytest.mark.parametrize("scheme", DOC_SHARDED)
def test_jax_chain_cannot_go_on_after_a_sharded_fold_in(corpus, scheme):
    """The JAX base fold-in leaves the whole corpus's n_dk [D, K] in the
    state of a document-sharded scheme, whose step takes [S, Dp, K]: the
    next iteration raises. The port's chain goes on (above)."""
    jm = _jax_model(scheme, corpus)
    jm.sample(ITERS)
    jm.sample_z_given_phi(FOLD_IN_ITERS)
    assert np.asarray(jm.state.ndk).shape == (corpus.num_docs, 3)
    with pytest.raises(ValueError, match="shard_map"):
        jm.sample(1)


@pytest.mark.parametrize("scheme", ("sharded_adlda", "sharded_pcgs",
                                    "sharded_uncollapsed"))
def test_jax_swap_breaks_the_chain_where_the_port_runs(corpus, scheme):
    """The JAX base swap recounts n_dk through the single-device padded
    path, which counts the sharded [S, Dp, L] z by its slot rows: an n_dk
    of shape [S, L, K] that is no recount of z (on other corpora the swap
    raises at once), and the next iteration raises."""
    jm = _jax_model(scheme, corpus)
    jm.sample(ITERS)
    before = np.asarray(jm.state.ndk).shape
    new = shuffled(corpus)
    jm.swap_corpus_tokens(JaxCorpus(tokens=new.tokens,
                                    doc_offsets=corpus.doc_offsets,
                                    vocab=corpus.vocab))
    assert np.asarray(jm.state.ndk).shape != before
    _, ndk = _recounts(new, jm.get_z_indicators())
    assert not np.array_equal(jm.get_document_topic_matrix(), ndk)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jm.sample(1)
