"""The PubMed-scale rehearsal of the port, tools/card_pubmed_rehearsal.py,
on the CPU: its corpus is the JAX script's (benchmarks/pubmed_rehearsal.py)
draw for draw, and of the JAX record's size at the default budget; its
analysis equals the JAX model's shard bookkeeping on an 8-device mesh; its
two arms run end to end at a tiny size with exact recounts; the committed
card record holds the JAX record's corpus and partition and compares with
the card's memory; and the kernels' wrappers refuse a layout or a table
past their int32 indexes. The rehearsal at size runs on the card
(chip_smoke.py phase 11)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.config import LDAConfig as JaxConfig
from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JaxCorpus
from ldagroupedgibbssampler_tpu.parallel.mesh import make_mesh as jax_mesh
from ldagroupedgibbssampler_tpu.parallel.vocab_sharded_ggs import (
    VocabShardedGGS as JaxVocabShardedGGS)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import real_slot_list
from ldagroupedgibbssampler_tpu_torch.ops import cuda_counts, cuda_zdraw
from tools import card_pubmed_rehearsal as pr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "card_pubmed_rehearsal.py")
SMALL = 300_000


def _jax_record():
    with open(os.path.join(ROOT, "PUBMED_REHEARSAL.json")) as f:
        return json.load(f)


def _jax_script_corpus(tokens):
    """benchmarks/pubmed_rehearsal.py's lines 76-89 at a budget of
    `tokens`."""
    V_FULL, D_FULL, N_FULL = 141_043, 8_200_000, 730_000_000
    mean_len = N_FULL / D_FULL
    d_sub = max(64, int(round(tokens / mean_len)))
    rng = np.random.default_rng(7)
    lengths = np.maximum(3, rng.poisson(mean_len, d_sub)).astype(np.int64)
    n = int(lengths.sum())
    ranks = np.arange(1, V_FULL + 1, dtype=np.float64)
    probs = (1.0 / ranks ** 1.05)
    probs /= probs.sum()
    tokens = rng.choice(V_FULL, size=n, p=probs).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return tokens, offsets


def test_default_budget_gives_the_jax_records_corpus_size():
    """At the default --tokens the document lengths (the Poisson part of
    the draw) give the JAX record's 820,000 documents and 72,997,437
    tokens, and the executed cut its 82,000 and 7,300,424."""
    jax = _jax_record()
    lengths, _ = pr.pubmed_lengths(pr.TOKENS)
    assert (len(lengths), int(lengths.sum())) == (
        jax["subsample"]["docs"], jax["subsample"]["tokens"]) == (
        820_000, 72_997_437)
    d_exec = pr.exec_docs(pr.EXEC_TOKENS)
    assert (d_exec, int(lengths[:d_exec].sum())) == (
        jax["executed_mesh_subsample"]["docs"],
        jax["executed_mesh_subsample"]["tokens"]) == (82_000, 7_300_424)


@pytest.fixture(scope="module")
def small_corpus():
    return pr.pubmed_corpus(SMALL)


def test_corpus_is_the_jax_scripts_draw_for_draw(small_corpus):
    tokens, offsets = _jax_script_corpus(SMALL)
    assert np.array_equal(small_corpus.tokens, tokens)
    assert np.array_equal(small_corpus.doc_offsets, offsets)
    assert small_corpus.num_types == pr.V_FULL == 141_043


def test_analysis_equals_the_jax_models_bookkeeping(small_corpus):
    """The tool's analysis at 300,000 tokens over the whole vocabulary,
    field for field, against the JAX model's bookkeeping on an 8-device
    mesh at the JAX script's configuration, computed as the JAX script
    computes its report."""
    c = small_corpus
    jm = JaxVocabShardedGGS(
        JaxConfig(scheme="ggs", topics=100, alpha=0.5, beta=0.01, seed=2019,
                  exec_time=-1, topic_interval=0, doc_span=1024),
        mesh=jax_mesh((8,), ("data",)))
    jm._prepare_device_data(JaxCorpus(tokens=c.tokens,
                                      doc_offsets=c.doc_offsets,
                                      vocab=c.vocab))
    ours = pr.analysis(c)
    shard, n, d = jm.shard_token_counts, c.num_tokens, c.num_docs
    width = 2 if jm._ndk_i16 else 4
    want = {
        "subsample": {"docs": d, "vocab": 141_043, "tokens": n,
                      "fraction_of_pubmed": round(n / 730_000_000, 4)},
        "shard_tokens": shard,
        "shard_pad_slots": jm.shard_pad_slots,
        "shard_imbalance_maxmean": round(
            max(shard) / max(1, (sum(shard) / len(shard))), 3),
        "type_relabeling": "frequency_interleaved",
        "ndk_psum_dtype": "int16" if jm._ndk_i16 else "int32",
        "ndk_psum_bytes_per_iter_subsample": int(d * 100 * width),
        "ndk_psum_bytes_per_iter_pubmed": int(8_200_000 * 100 * width),
        "measured_bytes_per_token": round(
            13.0 * sum(jm.shard_pad_slots) / max(1, n), 2),
    }
    assert {k: ours[k] for k in want} == want
    assert ours["ndk_psum_dtype"] == "int16"
    # the port's own wire: int32 over gloo, int16 pairs over NCCL
    wire = ours["ndk_allreduce_wire"]
    assert wire["gloo"] == {"dtype": "int32",
                            "bytes_per_iter_subsample": d * 100 * 4,
                            "bytes_per_iter_pubmed": 8_200_000 * 100 * 4}
    assert wire["nccl"]["dtype"] == "int16"
    assert wire["nccl"]["bytes_per_iter_pubmed"] == 8_200_000 * 100 * 2


def test_both_arms_run_on_the_cpu(tmp_path):
    """The tool end to end with --device cpu at a tiny size, the mesh arm
    at 2 gloo ranks: every recount and conservation check holds, each
    rank exits 0, and the run is added to the record beside an older
    one."""
    out = tmp_path / "record.json"
    out.write_text(json.dumps({"tool": "x", "runs": {"older": {}}}))
    args = ["--device", "cpu", "--tokens", "20000", "--exec_tokens",
            "10000", "--topics", "4", "--ranks", "2", "--token_block", "256",
            "--out", str(out)]
    res = subprocess.run([sys.executable, TOOL, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    record = json.loads(out.read_text())
    assert set(record["runs"]) == {"older", (
        "tokens=20000 exec_tokens=10000 ranks=2 device=cpu "
        "arms=analysis,mesh,card")}
    run = record["runs"][max(record["runs"], key=len)]
    assert run["failures"] == []
    card, mesh = run["card"], run["mesh"]
    assert all(card["checks"].values()) and card["tokens"] == 20_137
    ranks = mesh["rank_results"]
    assert [r["exitcode"] for r in ranks] == [0, 0]
    n = mesh["executed_mesh_subsample"]["tokens"]
    assert all(r["nkw_sum"] == r["ndk_sum"] == n for r in ranks)
    assert sum(r["tokens"] for r in ranks) == n
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert ranks[0]["shard_token_counts"] == [r["tokens"] for r in ranks]
    assert run["analysis"]["shard_tokens"] == [10_084, 10_053]


def test_launch_check_wants_every_kernel_each_iteration():
    want = {"fused_zdraw_nkw": 3, "blocked_label_counts": 3, "dirichlet": 9}
    assert pr.launch_failures(want, 3, "cuda") == []
    assert pr.launch_failures({**want, "dirichlet": 8}, 3, "cuda")
    assert pr.launch_failures({}, 3, "cuda")
    assert pr.launch_failures({}, 3, "cpu") == []


def test_committed_card_record():
    """PUBMED_REHEARSAL_TORCH.json: the mesh at the whole analysis scale
    holds the JAX record's corpus and partition exactly; the card is
    named; memory is held to the card's, never to 16 GB; and the whole of
    PubMed on one card either ran with exact recounts or the host limit
    that stopped it is recorded."""
    with open(os.path.join(ROOT, "PUBMED_REHEARSAL_TORCH.json")) as f:
        record = json.load(f)
    jax = _jax_record()
    run = record["runs"]["tokens=73000000 exec_tokens=73000000 ranks=8 "
                         "device=cuda arms=analysis,mesh,card"]
    assert "H100" in run["nvidia_smi"] and run["failures"] == []
    for key in ("subsample", "shard_tokens", "shard_imbalance_maxmean",
                "ndk_psum_dtype", "ndk_psum_bytes_per_iter_subsample",
                "ndk_psum_bytes_per_iter_pubmed",
                "measured_bytes_per_token"):
        assert run["analysis"][key] == jax[key], key
        assert run["beside_jax_record"][key]["equal"] is True
    assert run["mesh"]["executed_mesh_subsample"] == {
        "docs": 820_000, "tokens": 72_997_437}
    assert all(r["exitcode"] == 0 for r in run["mesh"]["rank_results"])
    proj = run["pubmed_projection"]
    total = run["card"]["device_total_bytes"]
    assert proj["device_total_bytes"] == total > 16 * 2 ** 30
    assert proj["per_rank_from_tokens"] == 72_997_437
    assert "fits_16gb" not in json.dumps(record)
    full = [r for k, r in record["runs"].items()
            if k.startswith("tokens=730000000")]
    assert len(full) == 1
    if "card" in full[0]:
        assert all(full[0]["card"]["checks"].values())
        assert full[0]["card"]["tokens"] > 700_000_000
    else:
        assert full[0]["host_limit"]["largest_tokens_that_ran"] > 0


def test_projection_scales_the_measured_peaks_to_pubmed():
    """Everything but the [V, K] tables scales with the tokens: a peak
    measured at a tenth of PubMed's tokens is projected ten times over,
    per device and per rank, against the card's memory."""
    vk = pr.V_FULL * 100 * 8
    report = {"card": {"tokens": pr.N_FULL // 10,
                       "peak_device_bytes": 4 * 2 ** 30 + vk,
                       "device_total_bytes": 80 * 2 ** 30},
              "mesh": {"ranks": 8, "executed_mesh_subsample": {
                  "tokens": pr.N_FULL // 10}, "rank_results": [
                      {"peak_device_gib": 1.0 + vk / 2 ** 30},
                      {"peak_device_gib": 9.0 + vk / 2 ** 30}]}}
    proj = pr.projection(report, 100)
    assert proj["one_device_bytes"] == 40 * 2 ** 30 + vk
    assert proj["fits_one_device"] is True
    assert proj["per_rank_bytes"] == 90 * 2 ** 30 + vk
    assert proj["fits_one_device_a_rank"] is False
    assert proj["theta_bytes"] == proj["ndk_bytes"] == 8_200_000 * 100 * 4


def test_int32_guards_refuse_a_layout_or_table_past_2_31():
    """A layout of 2^31 slots, or a table of 2^31 elements, is refused by
    name before any launch (meta tensors of those shapes allocate
    nothing); one element fewer passes the guard."""
    with pytest.raises(ValueError, match=r"2\^31"):
        real_slot_list(np.broadcast_to(False, (2 ** 31,)))
    nb, chunks, chunk = 2 ** 31 // 4096, 32, 128
    meta = dict(device="meta", dtype=torch.int32)

    def zdraw(nb, docs):
        w3 = torch.empty((nb, chunks, chunk), **meta)
        return cuda_zdraw.fused_zdraw_nkw(
            w3, w3, w3, torch.empty((docs, 100), device="meta"),
            torch.empty((128, 100), device="meta"),
            torch.empty(1, device="meta", dtype=torch.int64),
            torch.empty(nb, **meta), torch.empty(nb, **meta),
            torch.empty(nb * chunks, **meta), nwin_w=1, nwin_d=1,
            vspan=128, dspan=1024, num_topics=100,
            real_slots=torch.empty(1, **meta))
    with pytest.raises(ValueError, match=r"slots: 2147483648 .*2\^31"):
        zdraw(nb, 10)
    with pytest.raises(ValueError, match=r"theta_dk: 2147483700 .*2\^31"):
        zdraw(1, 21_474_837)
    with pytest.raises(ValueError, match=r"slots: .*2\^31"):
        cuda_counts.blocked_label_counts(
            torch.empty((nb, 4096), **meta), torch.empty((nb, 4096), **meta),
            torch.empty(nb, **meta), None, nwin=1, vspan=128, num_labels=100)
    with pytest.raises(ValueError, match=r"counts: .*2\^31"):
        cuda_counts.blocked_label_counts(
            torch.empty((1, 4096), **meta), torch.empty((1, 4096), **meta),
            torch.empty(1, **meta), None, nwin=2 ** 31 // 12_800 + 1,
            vspan=128, num_labels=100)
    # below the limit the guard passes and the wrapper's checks go on (a
    # meta tensor is not on the card)
    with pytest.raises(ValueError, match="expected a tensor on"):
        zdraw(nb - 1, 10)
