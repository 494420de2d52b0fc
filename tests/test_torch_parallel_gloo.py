"""The five sharded schemes of the port at 2 and 4 ranks, each rank its own
process in a gloo group on the CPU (tests/torch_parallel_worker.py), held
to the JAX package's sharded schemes on the 8-device CPU mesh of
tests/conftest.py.

The ranks of each world size are spawned once for the module; each writes
its results to a directory that the parametrised tests read. While they
run, the JAX sharded chains run beside them (this process those of 2
ranks, a helper process, this file run as a script, those of 4): five
seeds per scheme and world size for the likelihood band, and the last
chain's z, alpha and beta for the ranks to carry across. Every wait is
bounded.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from ldagroupedgibbssampler_tpu.config import LDAConfig as JaxConfig
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.evaluation.likelihood import (
    model_log_likelihood as jax_model_log_likelihood)
from ldagroupedgibbssampler_tpu.models.registry import (
    _SHARDED_SCHEMES as JAX_SHARDED)
from ldagroupedgibbssampler_tpu.parallel.mesh import make_mesh
from torch_parallel_worker import ITERS, planted_corpus

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
WORLDS = (2, 4)
SCHEMES = tuple(JAX_SHARDED)
JAX_SEEDS = 5
DEADLINE_S = 420


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_model(scheme, world):
    import importlib
    module, cls, _ = JAX_SHARDED[scheme]
    model = getattr(importlib.import_module(
        f"ldagroupedgibbssampler_tpu.{module}"), cls)(
        JaxConfig(scheme=scheme, topics=3, alpha=1.0, beta=0.01, seed=7,
                  exec_time=-1, token_block=256, vocab_span=4, doc_span=16,
                  topic_interval=ITERS), mesh=make_mesh((world,)))
    return model


def _save(out_dir, name, **arrays):
    """np.savez to out_dir/name.npz, appearing whole (the ranks poll)."""
    tmp = os.path.join(out_dir, f"{name}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(out_dir, f"{name}.npz"))


def _jax_chains(corpus, out_dir, world):
    """Per scheme at `world` ranks: the likelihoods at ITERS of JAX_SEEDS
    JAX sharded chains, with the last chain's counts and likelihood
    (out_dir/band_<scheme>_<world>.npz); that chain's z, alpha and beta go
    to the ranks (out_dir/jax_<scheme>_<world>.npz)."""
    jc = JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                   vocab=corpus.vocab)
    for scheme in SCHEMES:
        model = _jax_model(scheme, world)
        model.add_instances(jc)
        # every chain starts from its own key through one compiled init
        init = jax.jit(model._init_state)
        lls = []
        for seed in range(JAX_SEEDS):
            model._ll_history = []
            model.state = init(jax.random.key(100 + seed, impl="rbg"))
            model.sample(ITERS)
            lls.append(model.get_log_likelihoods()[-1][1])
        alpha = np.asarray(model.state.alpha, np.float32)
        beta = np.float32(model.state.beta)
        _save(out_dir, f"jax_{scheme}_{world}", z=model.get_z_indicators(),
              alpha=alpha, beta=beta)
        nkw = model.get_topic_type_counts()
        ndk = model.get_document_topic_matrix()
        _save(out_dir, f"band_{scheme}_{world}", lls=np.asarray(lls),
              nkw=nkw, ndk=ndk, nk=nkw.sum(axis=1),
              ll=float(jax_model_log_likelihood(ndk, nkw, alpha, beta)))


@pytest.fixture(scope="module")
def corpus():
    return planted_corpus()


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gloo_ranks"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "RANK", "WORLD_SIZE", "LOCAL_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = []
    for world in WORLDS:
        port = _free_port()
        for rank in range(world):
            log = open(os.path.join(out, f"log_{world}_{rank}.txt"), "w")
            procs.append((world, rank, log, subprocess.Popen(
                [sys.executable, WORKER, str(port), str(rank), str(world),
                 out], stdout=log, stderr=subprocess.STDOUT, env=env)))
    log = open(os.path.join(out, "log_jax.txt"), "w")
    procs.append((WORLDS[1], "jax", log, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out], stdout=log,
        stderr=subprocess.STDOUT, env=env)))
    deadline = time.time() + DEADLINE_S
    try:
        _jax_chains(corpus, out, WORLDS[0])
        for world, rank, log, p in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.time()))
            log.close()
            text = open(log.name).read()
            assert rc == 0, f"{rank} of {world} exited {rc}:\n{text}"
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return out


def _ranks(out, prefix, scheme, world):
    return [dict(np.load(os.path.join(out, f"{prefix}{scheme}_{world}_{r}"
                                           ".npz")))
            for r in range(world)]


def _band(out, scheme, world):
    return dict(np.load(os.path.join(out, f"band_{scheme}_{world}.npz")))


def _recounts(corpus, z, k=3):
    nkw = np.zeros((k, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    ndk = np.zeros((corpus.num_docs, k), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    return nkw, ndk


CASES = [(s, w) for w in WORLDS for s in SCHEMES]


@pytest.mark.parametrize("scheme,world", CASES)
def test_counts_conserved_and_exact(runs, corpus, scheme, world):
    """Every rank gathers the same z, and the merged counts are its exact
    recount (the ranks also checked this and the conservation of N every
    iteration under `paranoid`)."""
    ranks = _ranks(runs, "", scheme, world)
    for r in ranks:
        assert np.array_equal(r["z"], ranks[0]["z"])
        nkw, ndk = _recounts(corpus, r["z"])
        assert np.array_equal(r["nkw"], nkw)
        assert np.array_equal(r["ndk"], ndk)
        assert np.array_equal(r["nk"], nkw.sum(axis=1))
        assert r["nk"].sum() == corpus.num_tokens
        assert len(r["ll"]) == 1 and r["ll"][0] > r["ll0"]


@pytest.mark.parametrize("scheme,world", CASES)
def test_getters_answer_for_the_whole_model(runs, corpus, scheme, world):
    """On every rank get_type_topic_matrix is the V x K recount of the
    whole corpus's gathered z, not the rank's part, and get_beta the
    config's beta as a Python float."""
    for r in _ranks(runs, "", scheme, world):
        nkw, _ = _recounts(corpus, r["z"])
        assert np.array_equal(r["type_topic"], nkw.T)
        assert r["type_topic"].shape == (corpus.num_types, 3)
        assert float(r["beta"]) == float(np.float32(0.01))


@pytest.mark.parametrize("scheme,world", CASES)
def test_replicated_tensors_bit_equal(runs, scheme, world):
    ranks = _ranks(runs, "", scheme, world)
    names = ["phi", "nkw_state"] + (["theta"] if "theta" in ranks[0]
                                    else [])
    assert ("theta" in ranks[0]) == (scheme == "vocab_sharded_ggs")
    for r in ranks[1:]:
        for name in names:
            assert r[name].tobytes() == ranks[0][name].tobytes(), name


@pytest.mark.parametrize("scheme,world", CASES)
def test_z_round_trip(runs, corpus, scheme, world):
    z0 = np.arange(corpus.num_tokens) % 3
    nkw, ndk = _recounts(corpus, z0)
    for r in _ranks(runs, "", scheme, world):
        assert np.array_equal(r["roundtrip_z"], z0)
        assert np.array_equal(r["roundtrip_nkw"], nkw)
        assert np.array_equal(r["roundtrip_ndk"], ndk)


@pytest.mark.parametrize("scheme,world", CASES)
def test_one_seed_one_chain(runs, scheme, world):
    for r in _ranks(runs, "", scheme, world):
        for name in ("z", "nkw", "ndk", "ll"):
            assert np.array_equal(r[name], r[f"again_{name}"]), name
        assert r["phi"].tobytes() == r["again_phi"].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_ndk_reduction_is_int32_over_gloo(runs, world):
    """gloo has no int16 all-reduce, so the vocabulary-sharded n_dk merge
    runs in int32 there (the counts are exact, above); psum refuses an
    int16 tensor, as gloo itself does. The int16 route that NCCL takes
    (pairs of int16 counts as int32 words), run over gloo, sums exactly."""
    for r in _ranks(runs, "", "vocab_sharded_ggs", world):
        assert str(r["backend"]) == "gloo"
        assert str(r["ndk_dtype"]) == "torch.int32"
    for rank in range(world):
        p = np.load(os.path.join(runs, f"psum_{world}_{rank}.npz"))
        assert str(p["int16"]) == "refused"
        assert str(p["gloo_int16"]) == "refused"
        assert int(p["int32"]) == 4 * world
        assert np.array_equal(p["packed"], p["plain"])
        assert p["plain"].max() >= 2 ** 14      # totals near the bound


@pytest.mark.parametrize("scheme,world", CASES)
def test_state_carried_across_from_jax(runs, scheme, world):
    """A JAX sharded chain's z, alpha and beta in the port's ranks: the
    merged counts equal JAX's exactly, the likelihood within 1e-5."""
    jx = _band(runs, scheme, world)
    for r in _ranks(runs, "carried_", scheme, world):
        assert np.array_equal(r["nkw"], jx["nkw"])
        assert np.array_equal(r["ndk"], jx["ndk"])
        assert np.array_equal(r["nk"], jx["nk"])
        assert float(r["ll"]) == pytest.approx(jx["ll"], rel=1e-5)


@pytest.mark.parametrize("scheme,world", CASES)
def test_chain_within_jax_seed_band(runs, scheme, world):
    """The port's likelihood at ITERS lies in the range of JAX_SEEDS JAX
    sharded chains at the same world size, widened by 3 standard
    deviations (for sharded_adlda, whose per-rank replica differs from
    JAX's stale one, the same band)."""
    lls = list(_band(runs, scheme, world)["lls"])
    lo, hi, sd = min(lls), max(lls), float(np.std(lls))
    ll = float(_ranks(runs, "", scheme, world)[0]["ll"][-1])
    assert lo - 3 * sd <= ll <= hi + 3 * sd, (ll, lls)


if __name__ == "__main__":
    # the helper process: the JAX chains of 4 ranks, on the 8-device CPU
    # mesh that tests/conftest.py sets up
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    _jax_chains(planted_corpus(), sys.argv[1], WORLDS[1])
