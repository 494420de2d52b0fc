#!/usr/bin/env python3
"""The PubMed-scale rehearsal of `vocab_sharded_ggs` on the card: the
port of the JAX package's benchmarks/pubmed_rehearsal.py.

PubMed (D=8.2M, V=141,043, N about 730M) is the corpus the
vocabulary-sharded GGS was built for. This tool builds its shapes:

(a) Corpus. `pubmed_corpus(tokens)` draws the JAX script's synthetic
    corpus draw for draw: seed 7, Poisson(N/D) document lengths of at
    least 3, Zipf(1.05) over the 141,043 types with `rng.choice`. The
    default `--tokens` is 10% of PubMed's.
(b) Analysis, on the host at `--tokens`: the partition of the
    vocabulary-sharded layout over `--ranks` ranks
    (`parallel/vocab_sharded_ggs.py::vocab_shard_summary`), under the
    JAX record's names: each rank's tokens, the max/mean imbalance, the
    int16 decision (every document below 2^15 tokens), the n_dk all-reduce
    bytes at the subsample and at PubMed, and `measured_bytes_per_token`,
    the JAX model of 13 B a padded slot. The n_dk all-reduce is also
    reckoned in the port's own wire dtype for each backend
    (`parallel/mesh.py::count_reduce_dtype`: int32 over gloo, int16 pairs
    over NCCL).
(c) The mesh arm: `vocab_sharded_ggs` at `--ranks` gloo ranks sharing
    the device (each rank a spawned process, the kernels built before),
    on the first documents up to `--exec_tokens` (the JAX rule for the
    document count), 1 + 2 iterations. Each rank runs the scheme's
    paranoid checks (sum N_kw = sum n_dk = N, the gathered z recounted
    exactly to the merged counts, the replicated tensors bit-equal across
    the ranks) and records its peak memory on the device and on the host,
    ms an iteration, the all-reduce's ms (CUDA events) and its launches.
(d) The one-device arm: `ggs` on the whole `--tokens` subsample, 1 + 2
    iterations. N_kw, n_dk and n_k must equal an exact recount of z in
    corpus order (`device_recount`, on the device a slice at a time). Its
    peak allocation less what was held before, over N, is the measured
    bytes a token, from which the whole of PubMed is projected at one
    rank and at `--ranks` ranks and compared with the device's memory.

On the card every iteration must launch the z-draw kernel (csrc/zdraw.cu)
once, the count kernel (csrc/label_counts.cu) once and the Dirichlet
kernel (csrc/gamma.cu) three times (theta one, phi over V two), in each
arm and on each rank.

Run from the repository root:

    python3 tools/card_pubmed_rehearsal.py [--tokens 73000000]
        [--exec_tokens 7300000] [--topics 100] [--doc_span 1024]
        [--ranks 8] [--device cuda|cpu] [--arms analysis,mesh,card]
        [--token_block 4096] [--out PUBMED_REHEARSAL_TORCH.json]

The record is a file of runs: a run is stored under its key (its token
budgets, ranks, device and arms) beside the runs already in `--out`,
with the device's name and power limit from nvidia-smi and the JAX
record's fields (PUBMED_REHEARSAL.json, 8 virtual CPU devices) beside its
own where the corpus is the same. `--doc_span` stays 1024: at 128,
PubMed's 89-token documents pad to about 12.5 slots a token, which would
pass the kernels' int32 slot indexes at PubMed's size (a layout of 2^31
slots is refused). A `cuda` request without a card
raises. On the CPU (`--device cpu`, the kernels' plain versions) cut the
run: e.g. `--tokens 20000 --exec_tokens 10000 --topics 4 --ranks 2
--token_block 256`. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from ldagroupedgibbssampler_tpu_torch.config.lda_config import (  # noqa: E402
    LDAConfig)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus  # noqa: E402
from ldagroupedgibbssampler_tpu_torch.models.registry import (  # noqa: E402
    create_model)
from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, count_reduce_dtype)
from ldagroupedgibbssampler_tpu_torch.parallel.vocab_sharded_ggs import (  # noqa
    vocab_shard_summary)
from ldagroupedgibbssampler_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)
from tools.card_geweke_check import counter_values  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD = os.path.join(ROOT, "PUBMED_REHEARSAL.json")

# PubMed (resources/datasets/README.txt): D=8.2M, V=141,043, N about 730M
V_FULL, D_FULL, N_FULL = 141_043, 8_200_000, 730_000_000
MEAN_LEN = N_FULL / D_FULL                   # about 89 tokens a document
CORPUS_SEED = 7
ZIPF_EXPONENT = 1.05
MIN_DOC_LEN = 3
TOKENS, EXEC_TOKENS = 73_000_000, 7_300_000
TOPICS, DOC_SPAN, RANKS, TOKEN_BLOCK = 100, 1024, 8, 4096
ALPHA, BETA, SEED = 0.5, 0.01, 2019
ITERS = 2                                    # timed, after one first step
# the JAX model's device bytes a padded slot (its measured_bytes_per_token)
JAX_BYTES_PER_SLOT = 13.0
# the launches of an iteration of either scheme, by counter
LAUNCHES_PER_ITERATION = {"fused_zdraw_nkw": 1, "blocked_label_counts": 1,
                          "dirichlet": 3}
MESH_DEADLINE_S = 1200.0     # the mesh arm's ranks, all together
RANK_TIMEOUT_S = 600.0       # a rank's wait in init and in a collective
RECOUNT_SLICE = 1 << 27      # slots a pass of device_recount
ARMS = ("analysis", "mesh", "card")


# ---------------------------------------------------------------------------
# (a) the corpus
# ---------------------------------------------------------------------------
def pubmed_lengths(tokens: int = TOKENS):
    """(document lengths, int64 [D], and the generator after their draw):
    the first part of the JAX script's draw at a budget of `tokens`."""
    d_sub = max(64, int(round(tokens / MEAN_LEN)))
    rng = np.random.default_rng(CORPUS_SEED)
    lengths = np.maximum(MIN_DOC_LEN,
                         rng.poisson(MEAN_LEN, d_sub)).astype(np.int64)
    return lengths, rng


def exec_docs(exec_tokens: int = EXEC_TOKENS) -> int:
    """The documents of the executed cut (the JAX script's d_exec)."""
    return max(64, int(round(exec_tokens / MEAN_LEN)))


def vocab() -> list:
    return [f"w{i}" for i in range(V_FULL)]


def pubmed_corpus(tokens: int = TOKENS) -> Corpus:
    """The JAX script's synthetic PubMed subsample of about `tokens`
    tokens, draw for draw."""
    lengths, rng = pubmed_lengths(tokens)
    n = int(lengths.sum())
    ranks = np.arange(1, V_FULL + 1, dtype=np.float64)
    probs = 1.0 / ranks ** ZIPF_EXPONENT
    probs /= probs.sum()
    words = rng.choice(V_FULL, size=n, p=probs).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return Corpus(tokens=words, doc_offsets=offsets, vocab=vocab())


def first_docs(corpus: Corpus, num_docs: int) -> Corpus:
    """The corpus's first `num_docs` documents (views, no copy)."""
    end = int(corpus.doc_offsets[num_docs])
    return Corpus(tokens=corpus.tokens[:end],
                  doc_offsets=corpus.doc_offsets[: num_docs + 1],
                  vocab=corpus.vocab)


# ---------------------------------------------------------------------------
# (b) the analysis
# ---------------------------------------------------------------------------
def wire_bytes(num_docs: int, topics: int, backend: str,
               max_len: int) -> dict:
    """The n_dk all-reduce of one iteration in the port's wire dtype on
    `backend`: int16 counts travel in pairs of int32 words."""
    mesh = Mesh(group=None, rank=0, size=2, axis_name="data",
                backend=backend)
    dtype = count_reduce_dtype(mesh, max_len)
    n = num_docs * topics
    nbytes = (n + n % 2) * 2 if dtype == torch.int16 else n * 4
    return {"dtype": str(dtype).replace("torch.", ""), "bytes": nbytes}


def analysis(corpus: Corpus, *, ranks: int = RANKS, topics: int = TOPICS,
             doc_span: int = DOC_SPAN,
             token_block: int = TOKEN_BLOCK) -> dict:
    """The partition of `corpus` over `ranks` vocabulary-sharded ranks and
    what follows from it, under the JAX record's names."""
    t0 = time.perf_counter()
    summary = vocab_shard_summary(
        corpus, block=token_block, vspan=LDAConfig().vocab_span,
        dspan=doc_span, num_ranks=ranks)
    build_s = time.perf_counter() - t0
    shard = summary.shard_token_counts
    n, d = corpus.num_tokens, corpus.num_docs
    max_len = int(np.max(corpus.doc_lengths(), initial=0))
    ndk_i16 = max_len < 2 ** 15
    width = 2 if ndk_i16 else 4
    pad = sum(summary.shard_pad_slots)
    return {
        "subsample": {"docs": d, "vocab": corpus.num_types, "tokens": n,
                      "fraction_of_pubmed": round(n / N_FULL, 4)},
        "build_seconds": build_s,
        "shard_tokens": shard,
        "shard_pad_slots": summary.shard_pad_slots,
        "shard_imbalance_maxmean": round(
            max(shard) / max(1, sum(shard) / len(shard)), 3),
        "type_relabeling": "frequency_interleaved",
        "longest_document": max_len,
        "ndk_psum_dtype": "int16" if ndk_i16 else "int32",
        "ndk_psum_bytes_per_iter_subsample": d * topics * width,
        "ndk_psum_bytes_per_iter_pubmed": D_FULL * topics * width,
        "ndk_allreduce_wire": {
            backend: {"dtype": w["dtype"], "bytes_per_iter_subsample":
                      w["bytes"], "bytes_per_iter_pubmed": wire_bytes(
                          D_FULL, topics, backend, max_len)["bytes"]}
            for backend in ("gloo", "nccl")
            for w in [wire_bytes(d, topics, backend, max_len)]},
        "padded_slots": pad,
        "measured_bytes_per_token": round(
            JAX_BYTES_PER_SLOT * pad / max(1, n), 2),
    }


# ---------------------------------------------------------------------------
# the arms' shared pieces
# ---------------------------------------------------------------------------
def rehearsal_config(scheme: str, device: str, topics: int = TOPICS,
                     doc_span: int = DOC_SPAN,
                     token_block: int = TOKEN_BLOCK) -> LDAConfig:
    """The JAX script's configuration: alpha 0.5, beta 0.01, seed 2019, no
    time limit and no likelihood."""
    return LDAConfig(scheme=scheme, topics=topics, alpha=ALPHA, beta=BETA,
                     seed=SEED, exec_time=-1, topic_interval=0,
                     doc_span=doc_span, token_block=token_block,
                     device=device)


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in counter_values().items()
            if v != before[k]}


def launch_failures(launches: dict, iterations: int, device: str) -> list:
    """What differs from LAUNCHES_PER_ITERATION x `iterations` on the
    card (the CPU runs the plain versions and counts nothing)."""
    if device == "cpu":
        return []
    want = {k: n * iterations for k, n in LAUNCHES_PER_ITERATION.items()}
    return [] if launches == want else [
        f"launches {launches}, expected {want}"]


def host_peak_gib() -> float:
    """This process's peak resident host memory so far, GiB (ru_maxrss;
    a spawned process's starts from its parent's resident size)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def host_rss_gib() -> float:
    """This process's resident host memory now, GiB (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    raise RuntimeError("no VmRSS in /proc/self/status")


def timed_sample(model, device, iterations: int) -> float:
    """Seconds of `iterations` iterations on the host clock, the device
    synchronised before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    model.sample(iterations)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# (c) the mesh arm
# ---------------------------------------------------------------------------
def mesh_rank(rank: int, world: int, port: int, data_dir: str, cfg_kw: dict,
              out_path: str):
    """One rank of the mesh arm, in a spawned process: it maps the corpus
    saved in `data_dir`, joins a gloo group of `world` ranks, runs
    vocab_sharded_ggs 1 + ITERS iterations with the paranoid checks after,
    and writes its numbers (or its traceback) to `out_path`."""
    result = {"rank": rank, "world": world}
    try:
        from ldagroupedgibbssampler_tpu_torch.ops import _build
        from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (
            collective_counters, collectives, distributed_initialize)
        import torch.distributed as dist
        cfg = rehearsal_config("vocab_sharded_ggs", **cfg_kw)
        device = resolve_device(cfg.device)
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if device.type == "cuda":
            _, result["build_s"] = _build.build()
            if result["build_s"] != 0.0:
                raise RuntimeError("a rank rebuilt the kernels")
        corpus = Corpus(
            tokens=np.load(os.path.join(data_dir, "tokens.npy"),
                           mmap_mode="r"),
            doc_offsets=np.load(os.path.join(data_dir, "offsets.npy")),
            vocab=vocab())
        distributed_initialize(f"127.0.0.1:{port}", num_processes=world,
                               process_id=rank, device=cfg.device,
                               timeout_s=RANK_TIMEOUT_S)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = create_model(cfg)
        model.add_instances(corpus)
        result["setup_s"] = time.perf_counter() - t0
        rss = [host_rss_gib()]
        result["backend"] = model.mesh.backend
        result["tokens"] = int(model._slot_mask.sum())
        result["slots"] = int(model._slot_mask.numel())
        before = counter_values()
        result["first_step_s"] = timed_sample(model, device, 1)
        for attr in ("calls", "bytes"):
            setattr(collectives, attr, 0)
        with collectives.timed() as events:
            result["ms_per_iteration"] = timed_sample(
                model, device, ITERS) * 1e3 / ITERS
            result["allreduce_ms_per_iteration"] = (
                sum(a.elapsed_time(b) for a, b in events) / ITERS
                if events else None)
        rss.append(host_rss_gib())
        result["launches"] = launches_since(before)
        result["collectives_per_iteration"] = {
            attr: getattr(obj, attr) / ITERS
            for obj, attr in collective_counters()}
        result["ndk_wire_dtype"] = str(model._ndk_dtype).replace("torch.",
                                                                 "")
        result["ndk_i16"] = model._ndk_i16
        result["shard_token_counts"] = model.shard_token_counts
        if device.type == "cuda":
            result["peak_device_gib"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
        t0 = time.perf_counter()
        model._paranoid_checks()
        result["checks_s"] = time.perf_counter() - t0
        result["nkw_sum"] = int(model.state.nkw.sum())
        result["ndk_sum"] = int(model.state.ndk.sum())
        # the largest resident size at set-up, the iterations and the
        # checks (the peak counter of a spawned process starts from its
        # parent's)
        result["host_rss_gib"] = max(rss + [host_rss_gib()])
        dist.destroy_process_group()
    except BaseException:
        result["error"] = traceback.format_exc()
        with open(out_path, "w") as f:
            json.dump(result, f)
        raise
    with open(out_path, "w") as f:
        json.dump(result, f)


def mesh_arm(corpus: Corpus, *, exec_tokens: int, ranks: int, device: str,
             work_dir: str | None = None, deadline_s: float = MESH_DEADLINE_S,
             **cfg_kw) -> dict:
    """vocab_sharded_ggs on the first documents of `corpus` up to
    `exec_tokens`, at `ranks` gloo ranks sharing the device; every rank
    must exit 0 before the deadline and pass its checks."""
    d_exec = min(exec_docs(exec_tokens), corpus.num_docs)
    sub = first_docs(corpus, d_exec)
    own_dir = work_dir is None
    work_dir = work_dir or tempfile.mkdtemp(prefix="pubmed_mesh_")
    os.makedirs(work_dir, exist_ok=True)
    if resolve_device(device).type == "cuda":
        from ldagroupedgibbssampler_tpu_torch.ops import _build
        _build.library()           # built once, before the ranks start
    t0 = time.perf_counter()
    try:
        np.save(os.path.join(work_dir, "tokens.npy"), sub.tokens)
        np.save(os.path.join(work_dir, "offsets.npy"), sub.doc_offsets)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = mp.get_context("spawn")
        outs = [os.path.join(work_dir, f"rank_{r}.json")
                for r in range(ranks)]
        kw = dict(cfg_kw, device=device)
        procs = [ctx.Process(target=mesh_rank, args=(
            r, ranks, port, work_dir, kw, outs[r])) for r in range(ranks)]
        for p in procs:
            p.start()
        end = time.time() + deadline_s
        try:
            for p in procs:
                p.join(max(1.0, end - time.time()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, p in enumerate(procs):
            res = (json.load(open(outs[r])) if os.path.exists(outs[r])
                   else {"rank": r})
            res["exitcode"] = p.exitcode
            results.append(res)
    finally:
        if own_dir:
            shutil.rmtree(work_dir, ignore_errors=True)
    failures = []
    for res in results:
        if res["exitcode"] != 0 or "error" in res:
            failures.append(f"rank {res['rank']} of {ranks} exited "
                            f"{res['exitcode']}: " + res.get(
                                "error", "no result (killed at the "
                                "deadline?)"))
            continue
        n = sub.num_tokens
        if not res["nkw_sum"] == res["ndk_sum"] == n:
            failures.append(f"rank {res['rank']}: sum N_kw {res['nkw_sum']}"
                            f", sum n_dk {res['ndk_sum']}, N {n}")
        failures += [f"rank {res['rank']}: {f}" for f in launch_failures(
            res["launches"], 1 + ITERS, device)]
    return {"executed_mesh_subsample": {"docs": d_exec,
                                        "tokens": sub.num_tokens},
            "ranks": ranks, "seconds": time.perf_counter() - t0,
            "rank_results": results, "failures": failures}


# ---------------------------------------------------------------------------
# (d) the one-device arm
# ---------------------------------------------------------------------------
def device_recount(model, corpus: Corpus, topics: int) -> tuple:
    """(N_kw [V, K], n_dk [D, K], int32, and whether every token of the
    corpus sits on exactly one slot): the counts of the model's z
    recounted in corpus order on its device, RECOUNT_SLICE slots at a
    time, through the layout's flat index. Plain PyTorch."""
    dev = model.device
    v, d, k = corpus.num_types, corpus.num_docs, topics
    tokens = torch.as_tensor(corpus.tokens, device=dev)
    offsets = torch.as_tensor(np.asarray(corpus.doc_offsets, np.int64),
                              device=dev)
    nkw = torch.zeros(v * k, dtype=torch.int32, device=dev)
    ndk = torch.zeros(d * k, dtype=torch.int32, device=dev)
    hits = torch.zeros(corpus.num_tokens, dtype=torch.int32, device=dev)
    flat, z = model._flat_index, model.state.z.reshape(-1)
    for a in range(0, flat.size, RECOUNT_SLICE):
        fi = torch.as_tensor(flat[a: a + RECOUNT_SLICE], device=dev)
        keep = fi >= 0
        pos = fi[keep]
        zz = z[a: a + RECOUNT_SLICE][keep].to(torch.int64)
        ones = torch.ones_like(pos, dtype=torch.int32)
        nkw.index_add_(0, tokens[pos].to(torch.int64) * k + zz, ones)
        doc = torch.searchsorted(offsets, pos, right=True) - 1
        ndk.index_add_(0, doc * k + zz, ones)
        hits.index_add_(0, pos, ones)
    once = bool((hits == 1).all())
    return nkw.view(v, k), ndk.view(d, k), once


def card_arm(corpus: Corpus, *, device: str, **cfg_kw) -> dict:
    """ggs on the whole of `corpus` on one device, 1 + ITERS iterations:
    exact recounts and the peak device memory of the set-up and the
    iterations (the recount's own peak apart)."""
    cfg = rehearsal_config("ggs", device, **cfg_kw)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t_arm = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = create_model(cfg)
    model.add_instances(corpus)
    setup_s = time.perf_counter() - t0
    before = counter_values()
    first_s = timed_sample(model, dev, 1)
    ms = timed_sample(model, dev, ITERS) * 1e3 / ITERS
    launches = launches_since(before)
    n, d = corpus.num_tokens, corpus.num_docs
    st = model.state
    out = {"docs": d, "tokens": n, "slots": int(model._slot_mask.numel()),
           "setup_s": setup_s, "first_step_seconds": first_s,
           "ms_per_iteration": ms, "launches": launches,
           "dk_dtypes": {"theta": str(st.theta.dtype).replace("torch.", ""),
                         "ndk": str(st.ndk.dtype).replace("torch.", "")}}
    out["slots_per_token"] = out["slots"] / max(1, n)
    if cuda:
        out.update(
            peak_device_bytes=torch.cuda.max_memory_allocated(dev) - held,
            resident_device_bytes=torch.cuda.memory_allocated(dev) - held,
            device_total_bytes=torch.cuda.get_device_properties(
                dev).total_memory)
        out["measured_bytes_per_token"] = out["peak_device_bytes"] / max(1, n)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    nkw, ndk, once = device_recount(model, corpus, cfg.topics)
    checks = {
        "every_token_on_one_slot": once,
        "nkw_recount": bool(torch.equal(nkw, st.nkw)),
        "ndk_recount": bool(torch.equal(ndk, st.ndk)),
        "nk_recount": bool(torch.equal(nkw.sum(dim=0, dtype=torch.int32),
                                       st.nk)),
        "nkw_sum_is_n": int(st.nkw.sum()) == n,
        "ndk_sum_is_n": int(st.ndk.sum()) == n,
    }
    if cuda:
        out["recount_peak_device_bytes"] = (
            torch.cuda.max_memory_allocated(dev) - held)
    del nkw, ndk, model, st
    if cuda:
        torch.cuda.empty_cache()
    out.update(recount_s=time.perf_counter() - t0, checks=checks,
               failures=[name for name, ok in checks.items() if not ok]
               + launch_failures(launches, 1 + ITERS, device),
               host_peak_gib=host_peak_gib(),
               seconds=time.perf_counter() - t_arm)
    return out


def projection(report: dict, topics: int) -> dict:
    """The whole of PubMed on the card, from the peaks measured here.
    Apart from the [V, K] tables (phi f32 and N_kw int32, constant in N),
    every byte on the device scales with the tokens or the documents, and
    the synthetic documents keep PubMed's mean length; so PubMed needs a
    peak less the [V, K] tables, times N_FULL over the run's tokens, plus
    them: one device from the one-device arm's peak, a rank of the mesh
    from the largest rank's peak. The [D, K] tables at PubMed are listed
    in the port's dtypes (theta f32, n_dk int32)."""
    vk = V_FULL * topics * 8
    out = {"theta_bytes": D_FULL * topics * 4,
           "ndk_bytes": D_FULL * topics * 4, "vk_tables_bytes": vk}
    card, mesh = report.get("card", {}), report.get("mesh") or {}
    total = card.get("device_total_bytes")
    if "peak_device_bytes" in card:
        one = ((card["peak_device_bytes"] - vk) * N_FULL / card["tokens"]
               + vk)
        out.update(one_device_from_tokens=card["tokens"],
                   one_device_bytes=int(one), fits_one_device=one < total)
    peaks = [r.get("peak_device_gib") for r in mesh.get("rank_results", [])]
    if peaks and None not in peaks and total:
        n = mesh["executed_mesh_subsample"]["tokens"]
        rank = (max(peaks) * 2 ** 30 - vk) * N_FULL / n + vk
        out.update(per_rank_from_tokens=n, ranks=mesh["ranks"],
                   per_rank_bytes=int(rank),
                   fits_one_device_a_rank=rank < total)
    out["device_total_bytes"] = total
    return out


# ---------------------------------------------------------------------------
# the run and its record
# ---------------------------------------------------------------------------
def nvidia_smi() -> str | None:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def same_run_as(jax: dict, corpus: Corpus, ranks: int, **cfg_kw) -> bool:
    """Whether the JAX record is of this corpus budget, rank count and
    configuration (the defaults), so that its fields must be ours."""
    cfg = dict(topics=TOPICS, doc_span=DOC_SPAN, token_block=TOKEN_BLOCK)
    return (corpus.num_docs == jax["subsample"]["docs"]
            and ranks == jax["num_devices"]
            and all(cfg_kw.get(k, v) == v for k, v in cfg.items()))


def corpus_mismatches(corpus: Corpus, jax: dict) -> list:
    """The corpus's token count against the JAX record's of the same
    document count: numpy's generator must draw the record's corpus."""
    if corpus.num_tokens != jax["subsample"]["tokens"]:
        return [f"numpy {np.__version__} draws another corpus: "
                f"{corpus.num_tokens} tokens in {corpus.num_docs} "
                f"documents, the JAX record {jax['subsample']['tokens']}"]
    return []


# the fields compared with the JAX record: (section of ours, key)
JAX_FIELDS = (("analysis", "subsample"), ("analysis", "shard_tokens"),
              ("analysis", "shard_imbalance_maxmean"),
              ("analysis", "ndk_psum_dtype"),
              ("analysis", "ndk_psum_bytes_per_iter_subsample"),
              ("analysis", "ndk_psum_bytes_per_iter_pubmed"),
              ("analysis", "measured_bytes_per_token"),
              ("mesh", "executed_mesh_subsample"))


def beside_jax(report: dict, jax: dict) -> dict:
    """Each compared field: ours, the JAX record's and whether they are
    equal; and the JAX record's timings (8 virtual CPU devices) beside
    the card's."""
    rows = {}
    for section, key in JAX_FIELDS:
        if section in report and key in report[section]:
            ours, theirs = report[section][key], jax.get(key)
            # the executed cut is the record's only at its token budget
            same = (key != "executed_mesh_subsample"
                    or ours["docs"] == theirs["docs"])
            rows[key] = {"ours": ours, "jax_record": theirs,
                         "equal": ours == theirs if same else None}
    if "mesh" in report:
        ms = [r.get("ms_per_iteration") for r in
              report["mesh"]["rank_results"]]
        rows["seconds_per_iteration"] = {
            "ours_largest_rank": max((m for m in ms if m is not None),
                                     default=0.0) / 1e3,
            "jax_record_8_virtual_cpu_devices":
                jax.get("seconds_per_iteration")}
    return rows


def jax_mismatches(report: dict, jax: dict) -> list:
    """The compared fields that differ from the JAX record (none are
    compared unless the corpus is the record's)."""
    return [f"{k}: ours {row['ours']}, the JAX record {row['jax_record']}"
            for k, row in beside_jax(report, jax).items()
            if row.get("equal") is False]


def rehearse(corpus: Corpus, *, exec_tokens: int = EXEC_TOKENS,
             ranks: int = RANKS, device: str = "cuda", arms=ARMS,
             jax: dict | None = None, work_dir: str | None = None,
             mesh_deadline_s: float = MESH_DEADLINE_S, echo=print,
             **cfg_kw) -> dict:
    """The arms of the rehearsal on `corpus`; `failures` lists every check
    that failed (empty when all held)."""
    resolve_device(device)
    report = {"device": device, "nvidia_smi": nvidia_smi(),
              "numpy": np.__version__, "torch": torch.__version__,
              "failures": []}
    if jax is not None and not same_run_as(jax, corpus, ranks, **cfg_kw):
        jax = None
    if jax is not None:
        report["failures"] += corpus_mismatches(corpus, jax)
        if report["failures"]:
            return report
    if "analysis" in arms:
        report["analysis"] = analysis(corpus, ranks=ranks, **cfg_kw)
        echo(f"analysis: {json.dumps(report['analysis'])}")
    if "mesh" in arms:
        report["mesh"] = mesh_arm(
            corpus, exec_tokens=exec_tokens, ranks=ranks, device=device,
            work_dir=work_dir, deadline_s=mesh_deadline_s, **cfg_kw)
        report["failures"] += report["mesh"]["failures"]
        echo(f"mesh: {mesh_line(report['mesh'])}")
    if "card" in arms:
        report["card"] = card_arm(corpus, device=device, **cfg_kw)
        report["failures"] += report["card"]["failures"]
        echo(f"card: {card_line(report['card'])}")
        if "peak_device_bytes" in report["card"]:
            report["pubmed_projection"] = projection(
                report, cfg_kw.get("topics", TOPICS))
            echo("PubMed projected: "
                 + json.dumps(report["pubmed_projection"]))
    if jax is not None:
        report["beside_jax_record"] = beside_jax(report, jax)
        report["failures"] += jax_mismatches(report, jax)
    return report


def mesh_line(mesh: dict) -> str:
    rs = [r for r in mesh["rank_results"] if "ms_per_iteration" in r]
    sub = mesh["executed_mesh_subsample"]

    def col(key, nd=1):
        return [round(r[key], nd) if r.get(key) is not None else None
                for r in rs]
    return (f"{mesh['ranks']} gloo ranks on {sub['docs']} documents, "
            f"{sub['tokens']} tokens: {mesh['seconds']:.1f} s; ms/iteration "
            f"{col('ms_per_iteration')}; all-reduce ms/iteration "
            f"{col('allreduce_ms_per_iteration')}; first step s "
            f"{col('first_step_s', 2)}; set-up s {col('setup_s', 2)}; peak "
            f"GiB on the device {col('peak_device_gib', 3)}, on the host "
            f"(the largest VmRSS at set-up, iterations and checks) "
            f"{col('host_rss_gib', 2)}; tokens a rank {col('tokens', 0)}; "
            f"launches {json.dumps(rs[0]['launches']) if rs else None}; "
            f"failures {mesh['failures']}")


def card_line(card: dict) -> str:
    def gib(key):
        return (f"{card[key] / 2 ** 30:.3f}" if card.get(key) is not None
                else None)
    return (f"ggs on {card['docs']} documents, {card['tokens']} tokens, "
            f"{card['slots']} slots ({card['slots_per_token']:.3f} a token):"
            f" set-up {card['setup_s']:.1f} s, first step "
            f"{card['first_step_seconds']:.2f} s, "
            f"{card['ms_per_iteration']:.1f} ms/iteration; peak GiB on the "
            f"device {gib('peak_device_bytes')} (the recount's "
            f"{gib('recount_peak_device_bytes')}), on the host "
            f"{card['host_peak_gib']:.2f} (the process's peak so far); "
            f"bytes a token {card.get('measured_bytes_per_token')}; recounts "
            f"{json.dumps(card['checks'])}; launches "
            f"{json.dumps(card['launches'])}")


def run_key(args) -> str:
    return (f"tokens={args.tokens} exec_tokens={args.exec_tokens} "
            f"ranks={args.ranks} device={args.device} arms={args.arms}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=TOKENS,
                    help="the subsample's token budget (PubMed: 730M)")
    ap.add_argument("--exec_tokens", type=int, default=EXEC_TOKENS,
                    help="the token budget of the mesh arm")
    ap.add_argument("--topics", type=int, default=TOPICS)
    ap.add_argument("--doc_span", type=int, default=DOC_SPAN)
    ap.add_argument("--ranks", type=int, default=RANKS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--token_block", type=int, default=TOKEN_BLOCK)
    ap.add_argument("--out", default="PUBMED_REHEARSAL_TORCH.json")
    args = ap.parse_args(argv)
    arms = tuple(a for a in args.arms.split(",") if a)
    unknown = set(arms) - set(ARMS)
    if unknown:
        ap.error(f"unknown arms {sorted(unknown)}: choose from {ARMS}")
    jax = json.load(open(JAX_RECORD)) if os.path.exists(JAX_RECORD) else None
    t0 = time.perf_counter()
    corpus = pubmed_corpus(args.tokens)
    synth_s = time.perf_counter() - t0
    print(f"corpus: D={corpus.num_docs} V={V_FULL} N={corpus.num_tokens} "
          f"({100.0 * corpus.num_tokens / N_FULL:.2f}% of PubMed's tokens) "
          f"in {synth_s:.1f} s", flush=True)
    report = rehearse(corpus, exec_tokens=args.exec_tokens, ranks=args.ranks,
                      device=args.device, arms=arms, jax=jax,
                      echo=lambda line: print(line, flush=True),
                      topics=args.topics, doc_span=args.doc_span,
                      token_block=args.token_block)
    report.update(synthesis_seconds=synth_s,
                  seconds=time.perf_counter() - t0,
                  host_peak_gib=host_peak_gib(),
                  args=dict(vars(args)))
    record = (json.load(open(args.out)) if os.path.exists(args.out)
              else {"tool": "tools/card_pubmed_rehearsal.py", "runs": {}})
    record["runs"][run_key(args)] = report
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"failures: {report['failures']}; {report['seconds']:.1f} s; "
          f"{report['nvidia_smi']}", flush=True)
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
