"""The port's sharded schemes in one process, on the CPU: the deterministic
parts against the JAX package's (document and window partitions, the type
permutation, each rank's vocabulary-sharded layout), every scheme as a
1-rank mesh, and the mesh's size rule. The multi-rank runs are in
tests/test_torch_parallel_gloo.py."""

import dataclasses

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config import LDAConfig as JaxConfig
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.parallel import sharded_ggs as jax_sharded
from ldagroupedgibbssampler_tpu.parallel import vocab_sharded_ggs as jax_vocab
from ldagroupedgibbssampler_tpu.parallel.mesh import make_mesh as jax_mesh
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.models.registry import (
    _SHARDED_SCHEMES, create_model)
from ldagroupedgibbssampler_tpu_torch.parallel import sharded_ggs
from ldagroupedgibbssampler_tpu_torch.parallel import vocab_sharded_ggs
from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (
    Mesh, count_reduce_dtype, make_mesh, psum)
from torch_parallel_worker import config, planted_corpus

VSPAN = 4


def zipf_corpus():
    """200 documents of 60 tokens over 512 Zipf(1.1) types."""
    rng = np.random.default_rng(3)
    v = 512
    probs = 1.0 / np.arange(1, v + 1) ** 1.1
    probs /= probs.sum()
    docs = [list(rng.choice(v, size=60, p=probs)) for _ in range(200)]
    return Corpus.from_token_lists(docs, [f"w{i}" for i in range(v)])


CORPORA = {"planted": planted_corpus, "zipf": zipf_corpus}


def _jax(corpus):
    return JaxCorpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                     vocab=corpus.vocab)


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_partitions_equal_jax(name, shards):
    corpus = CORPORA[name]()
    assert np.array_equal(
        sharded_ggs.partition_documents(corpus, shards),
        jax_sharded.partition_documents(_jax(corpus), shards))
    tf = corpus.type_frequencies()
    perm, inv = vocab_sharded_ggs.interleave_permutation(tf, VSPAN)
    jperm, jinv = jax_vocab.interleave_permutation(tf, VSPAN)
    assert np.array_equal(perm, jperm) and np.array_equal(inv, jinv)
    for counts in (tf, tf[inv]):
        assert np.array_equal(
            vocab_sharded_ggs.partition_windows(counts, VSPAN, shards),
            jax_vocab.partition_windows(counts, VSPAN, shards))


@pytest.mark.parametrize("shards", [2, 4])
def test_vocab_rank_layout_equals_jax(shards):
    """Each rank's arrays are the JAX shard's: equal on the rank's blocks,
    and the JAX shard's padding to the largest shard's block count holds
    no token."""
    corpus = zipf_corpus()
    jm = jax_vocab.VocabShardedGGS(
        JaxConfig(scheme="ggs", topics=3, token_block=256, vocab_span=VSPAN,
                  doc_span=16), mesh=jax_mesh((shards,)))
    jm._prepare_device_data(_jax(corpus))
    bpc = 256 // 128
    jarr = {k: np.asarray(getattr(jm, k)) for k in (
        "wb3", "dla3", "mk3", "wdc", "winb", "firstb", "srcb", "dlb",
        "windb", "firstdb")}
    tokens = 0
    for r in range(shards):
        b = vocab_sharded_ggs.vocab_rank_layout(
            corpus, block=256, vspan=VSPAN, dspan=16, num_ranks=shards,
            rank=r).blocks
        na, nb = b.w_local.shape[0], b.d_local.shape[0]
        for key, ours, rows in (
                ("wb3", b.w_local, na), ("dla3", b.d_local_a, na),
                ("mk3", b.mask, na), ("winb", b.win_w, na),
                ("firstb", b.first_w, na), ("wdc", b.win_d_chunks, na * bpc),
                ("srcb", b.src_chunks, nb * bpc), ("dlb", b.d_local, nb),
                ("windb", b.win_d, nb), ("firstdb", b.first_d, nb)):
            assert np.array_equal(jarr[key][r, :rows], ours), (key, r)
        assert not jarr["mk3"][r, na:].any()
        assert np.array_equal(jm._flat_index[r, :na], b.flat_index)
        assert (jm._flat_index[r, na:] == -1).all()
        tokens += int(b.mask.sum())
    assert tokens == corpus.num_tokens


def _recounts(corpus, z, k=3):
    nkw = np.zeros((k, corpus.num_types), np.int64)
    np.add.at(nkw, (z, corpus.tokens), 1)
    ndk = np.zeros((corpus.num_docs, k), np.int64)
    np.add.at(ndk, (corpus.token_doc_ids(), z), 1)
    return nkw, ndk


@pytest.mark.parametrize("scheme", sorted(_SHARDED_SCHEMES))
def test_scheme_runs_as_one_rank_mesh(scheme):
    """Through create_model with no process group: a 1-rank mesh whose
    counts are the recount of z and which recovers the planted topics."""
    corpus = planted_corpus()
    model = create_model(config(scheme, topic_interval=10))
    assert model.mesh.size == 1 and model.mesh.group is None
    model.add_instances(corpus)
    model.sample(30)
    nkw, ndk = _recounts(corpus, model.get_z_indicators())
    assert np.array_equal(model.get_topic_type_counts(), nkw)
    assert np.array_equal(model.get_document_topic_matrix(), ndk)
    assert np.array_equal(model.get_tokens_per_topic(), nkw.sum(axis=1))
    blocks = nkw.reshape(3, 3, 10).sum(axis=2)
    purity = blocks.max(axis=1) / np.maximum(blocks.sum(axis=1), 1)
    assert purity.mean() > 0.7, purity
    lls = [ll for _, ll in model.get_log_likelihoods()]
    assert len(lls) == 3 and np.isfinite(lls).all()


def test_mesh_is_the_world():
    """Without a process group the mesh is one rank with no group, whose
    psum is the identity; a shape that is not the world size raises (the
    JAX package raises only above its device count)."""
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == (1, 0, None,
                                                                None)
    assert make_mesh((1,), ("data",)).axis_name == "data"
    t = torch.arange(4)
    assert psum(t, mesh) is t and t.tolist() == [0, 1, 2, 3]
    for shape in ((2,), (8,), (1, 1)):
        with pytest.raises(ValueError, match="mesh shape"):
            make_mesh(shape)
    with pytest.raises(ValueError, match="mesh shape"):
        create_model(config("sharded_ggs", mesh_shape=(2,)))
    # counts are summed in int16 only over NCCL, and only below 2^15
    nccl = Mesh(group=None, rank=0, size=1, axis_name="data",
                backend="nccl")
    assert count_reduce_dtype(nccl, 2 ** 15 - 1) == torch.int16
    assert count_reduce_dtype(nccl, 2 ** 15) == torch.int32
    gloo = dataclasses.replace(nccl, backend="gloo")
    assert count_reduce_dtype(gloo, 100) == torch.int32
    assert count_reduce_dtype(mesh, 100) == torch.int32


def _port_vocab_model(shards, rank):
    """The port's vocab_sharded_ggs as rank `rank` of `shards`, without a
    process group (its bookkeeping needs none)."""
    mesh = Mesh(group=None, rank=rank, size=shards, axis_name="data",
                backend=None)
    return vocab_sharded_ggs.VocabShardedGGS(
        config("vocab_sharded_ggs", vocab_span=VSPAN), mesh=mesh)


def _jax_vocab_model(shards):
    return jax_vocab.VocabShardedGGS(
        JaxConfig(scheme="ggs", topics=3, token_block=256, vocab_span=VSPAN,
                  doc_span=16), mesh=jax_mesh((shards,)))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_shard_bookkeeping_equals_jax(shards):
    """shard_token_counts, shard_pad_slots and _ndk_i16 on every rank are
    the JAX model's; vocab_shard_summary gives them with no group, each
    rank's padded slots are its own layout's, and the wire dtype stays
    count_reduce_dtype's."""
    corpus = zipf_corpus()
    jm = _jax_vocab_model(shards)
    jm._prepare_device_data(_jax(corpus))
    summary = vocab_sharded_ggs.vocab_shard_summary(
        corpus, block=256, vspan=VSPAN, dspan=16, num_ranks=shards)
    assert summary.shard_token_counts == jm.shard_token_counts
    assert summary.shard_pad_slots == jm.shard_pad_slots
    assert np.array_equal(summary.win_bounds, jm.win_bounds)
    for rank in {0, shards - 1}:
        m = _port_vocab_model(shards, rank)
        m._prepare_device_data(corpus)
        assert m.shard_token_counts == jm.shard_token_counts
        assert m.shard_pad_slots == jm.shard_pad_slots
        assert m._ndk_i16 is True and jm._ndk_i16 is True
        assert m._ndk_dtype == torch.int32
        assert m._blocks.w_local.size == m.shard_pad_slots[rank]
        assert int(m._blocks.mask.sum()) == m.shard_token_counts[rank]


def test_long_document_turns_int16_off_in_both_packages():
    """A document of 2^15 tokens turns the int16 n_dk decision off in the
    JAX model and in the port's, and one token shorter keeps it on."""
    base = zipf_corpus()
    for length, want in ((2 ** 15, False), (2 ** 15 - 1, True)):
        docs = [list(base.tokens[a:b]) for a, b in zip(
            base.doc_offsets[:-1], base.doc_offsets[1:])]
        docs.append([7] * length)
        corpus = Corpus.from_token_lists(docs, base.vocab)
        jm = _jax_vocab_model(2)
        jm._prepare_device_data(_jax(corpus))
        m = _port_vocab_model(2, 1)
        m._prepare_device_data(corpus)
        assert jm._ndk_i16 is want and m._ndk_i16 is want
        assert m.shard_token_counts == jm.shard_token_counts
        assert m.shard_pad_slots == jm.shard_pad_slots
