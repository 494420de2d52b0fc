#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port
(ldagroupedgibbssampler_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. environment: card name and power limit (nvidia-smi), torch and CUDA;
  2. build: compiles csrc/*.cu through ops/_build.py and reports the time;
  3. kernels against their plain PyTorch versions on the card, at the
     shapes of the synthetic 20NG corpus (D=11,269, V=20,000, K=100, mean
     doc length 120, Zipf 1.1 types, default_rng(0) — the same recipe as
     bench.py), with each kernel's time, its plain version's time, the
     library yardstick where one exists, and its bound;
  4. the main path: LDAGroupedGibbsSampler on that corpus on cuda, 30
     iterations with the likelihood every 10; launch counters, exact
     recounts, rising likelihood, tokens/s;
  5. the experiment CLI (tui.parallel_lda.main) on a small text corpus on
     cuda.
Then one JSON line describing every kernel, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false or when the port's package is not beside it.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

D, V, K = 11269, 20000, 100
MEAN_LEN = 120
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
ITERS = 30
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def synth_corpus(Corpus, seed=0):
    """The synthetic 20NG corpus of bench.py: Poisson(120) lengths (min 5),
    Zipf(1.1) types over V."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(5, rng.poisson(MEAN_LEN, D)).astype(np.int64)
    n = int(lengths.sum())
    probs = 1.0 / np.arange(1, V + 1, dtype=np.float64) ** 1.1
    probs /= probs.sum()
    tokens = rng.choice(V, size=n, p=probs).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return Corpus(tokens=tokens, doc_offsets=offsets,
                  vocab=[f"w{i}" for i in range(V)])


def time_ms(torch, fn, reps=7, calls=10):
    """Median over `reps` of the mean device time of `calls` back-to-back
    calls, from CUDA events. A device-side sleep queued first lets the host
    enqueue every call before the first one starts, so host overhead does
    not show as idle time between launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return float(np.median(out))


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_iterations(torch, model, n: int) -> str:
    """Device time by kernel over `n` more iterations (torch.profiler),
    against their host wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.sample(n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type != torch.autograd.DeviceType.CPU:
            rows.append((us / 1e3 / n, e.key))
    busy = sum(ms for ms, _ in rows)
    if busy == 0:
        return (f"{n} iterations, {wall:.3f} ms/iteration; the profiler saw "
                "no device time")
    rows.sort(reverse=True)
    top = "; ".join(f"{ms:.3f} ms {name[:70]}" for ms, name in rows[:8])
    return (f"{n} iterations: {wall:.3f} ms/iteration host wall, device "
            f"busy {busy:.3f} ms/iteration ({100 * busy / wall:.1f}%), "
            f"{len(rows)} kernels; top: {top}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: needs a CUDA card")
    try:
        from ldagroupedgibbssampler_tpu_torch.ops import _build
    except ImportError as e:
        return fail(f"the port's package is not importable ({e}); run "
                    "from the repository root")
    from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
    from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_counts, cuda_zdraw
    from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
    from ldagroupedgibbssampler_tpu_torch.tui import parallel_lda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[1 env] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    # ---- 2. build ------------------------------------------------------
    path, build_s = _build.build()
    regs = [ln.strip() for ln in
            path.with_suffix(".log").read_text().splitlines()
            if "registers" in ln] if path.with_suffix(".log").exists() else []
    _build.library()
    print(f"[2 build] {path.name} in {build_s:.1f} s "
          f"(0 = already built); ptxas: {' | '.join(regs)}", flush=True)

    # ---- 3. kernels against their plain versions -----------------------
    corpus = synth_corpus(Corpus)
    n_tok = corpus.num_tokens
    cfg = LDAConfig(scheme="ggs", topics=K, alpha=0.5, beta=0.01, seed=2019,
                    exec_time=-1, topic_interval=10, device="cuda")
    vspan, dspan = cfg.vocab_span, cfg.doc_span
    t0 = time.perf_counter()
    blocks = corpus.cell_blocks(block=cfg.token_block, vspan=vspan,
                                dspan=dspan)
    build_blocks_s = time.perf_counter() - t0
    nb, block = blocks.w_local.shape
    chunk = blocks.chunk
    chunks = block // chunk
    shape3 = (nb, chunks, chunk)
    slots = nb * block

    def t(a):
        return torch.as_tensor(a, device=dev)

    wb, dla = t(blocks.w_local), t(blocks.d_local_a)
    mask = t(blocks.mask)
    winb, firstb, windc = t(blocks.win_w), t(blocks.first_w), \
        t(blocks.win_d_chunks)
    srcb = t(blocks.src_chunks.astype(np.int64))
    dlb, windb, firstdb = t(blocks.d_local), t(blocks.win_d), \
        t(blocks.first_d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    z = torch.randint(0, K, (nb, block), generator=gen, device=dev,
                      dtype=torch.int32)
    z = torch.where(mask, z, 0)
    z_b = z.view(-1, chunk)[srcb].view(dlb.shape).contiguous()
    print(f"[3 layout] N={n_tok} tokens, {nb} blocks x {block} = {slots} "
          f"slots, layout B {dlb.shape[0]} blocks, built in "
          f"{build_blocks_s:.1f} s", flush=True)

    kc = dict(nwin=blocks.nwin_w, vspan=vspan, num_labels=K)
    kd = dict(nwin=blocks.nwin_d, vspan=dspan, num_labels=K)
    count_ok = {}
    for name, args, kw in (("A", (wb, z, winb, firstb), kc),
                           ("B", (dlb, z_b, windb, firstdb), kd)):
        got = cuda_counts.blocked_label_counts(*args, **kw)
        ref = cuda_counts.blocked_label_counts_reference(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"label counts layout {name} differ "
              "from the plain version")
        check(int(got.sum()) == n_tok, f"layout {name} counts != N")
        count_ok[name] = (args, kw)
    # time on layout B: the per-iteration call of the main path
    args_b, kw_b = count_ok["B"]
    counts_ms = time_ms(torch, lambda: cuda_counts.blocked_label_counts(
        *args_b, **kw_b))
    counts_a_ms = time_ms(torch, lambda: cuda_counts.blocked_label_counts(
        *count_ok["A"][0], **count_ok["A"][1]))
    counts_plain_ms = time_ms(
        torch, lambda: cuda_counts.blocked_label_counts_reference(
            *args_b, **kw_b), reps=5, calls=2)
    valid_b = dlb < dspan
    key_b = ((windb.to(torch.int64)[:, None] * dspan + dlb)[valid_b] * K
             + z_b[valid_b])
    nrows_b = blocks.nwin_d * dspan
    lib = torch.bincount(key_b, minlength=nrows_b * K).view(nrows_b, K)
    check(torch.equal(lib.to(torch.int32),
                      cuda_counts.blocked_label_counts(*args_b, **kw_b)),
          "bincount yardstick disagrees with the count kernel")
    counts_lib_ms = time_ms(torch, lambda: torch.bincount(
        key_b, minlength=nrows_b * K))
    counts_bytes = 4 * (2 * dlb.numel() + 2 * windb.numel()
                        + nrows_b * K)
    counts_bound, counts_by = bound(counts_bytes, 0)
    print(f"[3 counts] layouts A and B exact; layout B "
          f"{counts_ms:.4f} ms (layout A {counts_a_ms:.4f} ms), plain "
          f"{counts_plain_ms:.4f} ms, torch.bincount {counts_lib_ms:.4f} ms, "
          f"bound {counts_bound:.4f} ms ({counts_by})", flush=True)

    # z-draw: realistic tables, every 5th document's theta row zeroed
    theta = rnd.dirichlet(torch.rand((D, K), generator=gen, device=dev)
                          * 20 + 0.5, gen)
    phi = rnd.gamma(torch.rand((V, K), generator=gen, device=dev) * 5
                    + 0.01, gen).clamp_min(rnd.DIRICHLET_FLOOR)
    phi = (phi / phi.sum(dim=0, keepdim=True)).contiguous()
    doc_sel = (torch.arange(D, device=dev) % 5) != 0
    theta_m = torch.where(doc_sel[:, None], theta, 0.0).contiguous()
    w3, d3 = wb.view(shape3), dla.view(shape3)
    z_old = z.view(shape3)
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    u24 = torch.randint(0, 2 ** 24, shape3, generator=gen, device=dev,
                        dtype=torch.int32)
    zargs = (w3, d3, z_old, theta_m, phi, seed, winb, firstb, windc)
    zkw = dict(nwin_w=blocks.nwin_w, nwin_d=blocks.nwin_d, vspan=vspan,
               dspan=dspan, num_topics=K)
    pad = (w3 == vspan)
    doc_of_slot = torch.as_tensor(blocks.doc_ids.reshape(shape3),
                                  device=dev)
    unsel = (~pad) & (doc_of_slot % 5 == 0)
    agreement = {}
    for label, u, precise in (("u24 bf16", u24, False),
                              ("u24 precise", u24, True),
                              ("philox bf16", None, False)):
        zk, nk_k = cuda_zdraw.fused_zdraw_nkw(*zargs, u, precise=precise,
                                              **zkw)
        zr, nk_r = cuda_zdraw.fused_zdraw_nkw_reference(
            *zargs, u, precise=precise, **zkw)
        torch.cuda.synchronize()
        agree = float((zk == zr)[~pad].float().mean())
        agreement[label] = agree
        check(agree >= 0.999, f"z-draw ({label}): only {agree:.6f} of "
              "tokens agree with the plain version")
        hist = cuda_counts.blocked_label_counts_reference(
            wb, zk.view(wb.shape), winb, firstb, **kc)
        check(torch.equal(nk_k, hist), f"z-draw ({label}): N_kw is not "
              "the histogram of the kernel's z")
        check(torch.equal(zk[pad], z_old[pad]),
              f"z-draw ({label}): a padding slot changed z")
        check(torch.equal(zk[unsel], z_old[unsel]),
              f"z-draw ({label}): a zeroed-theta document changed z")
        if label == "philox bf16":
            zdraw_err = int((nk_k - nk_r).abs().max())
    # planted topics: one-hot theta fixes every selected doc's topic
    doc_topic = torch.arange(D, device=dev) % K
    onehot = torch.nn.functional.one_hot(doc_topic, K).to(torch.float32)
    onehot = torch.where(doc_sel[:, None], onehot, 0.0).contiguous()
    zk, _ = cuda_zdraw.fused_zdraw_nkw(w3, d3, z_old, onehot, phi, seed,
                                       winb, firstb, windc, **zkw)
    sel = (~pad) & ~unsel
    check(torch.equal(zk[sel], doc_topic[doc_of_slot[sel]].to(torch.int32)),
          "planted topics not drawn")
    check(torch.equal(zk[unsel], z_old[unsel]), "planted run: unselected "
          "documents changed z")
    # chi-square of 200k Philox draws of one (d, w) pair at K=100
    from scipy import stats as sps
    nb1 = -(-200_000 // block)
    zero3 = torch.zeros((nb1, chunks, chunk), dtype=torch.int32, device=dev)
    th1 = (torch.rand((1, K), generator=gen, device=dev) + 0.05)
    ph1 = (torch.rand((1, K), generator=gen, device=dev) + 0.05)
    zk1, _ = cuda_zdraw.fused_zdraw_nkw(
        zero3, zero3, zero3, th1 / th1.sum(), ph1 / ph1.sum(), seed,
        torch.zeros(nb1, dtype=torch.int32, device=dev),
        torch.ones(nb1, dtype=torch.int32, device=dev),
        torch.zeros(nb1 * chunks, dtype=torch.int32, device=dev),
        nwin_w=1, nwin_d=1, vspan=vspan, dspan=dspan, num_topics=K)
    p = (th1 * ph1).double().cpu().numpy()[0]
    p /= p.sum()
    obs = np.bincount(zk1.cpu().numpy().reshape(-1), minlength=K)
    exp = p * obs.sum()
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    pval = float(sps.chi2.sf(chi2, K - 1))
    check(pval > 1e-4, f"z-draw chi-square p={pval:.2e}")

    zdraw_ms = time_ms(torch, lambda: cuda_zdraw.fused_zdraw_nkw(
        *zargs, **zkw))
    zdraw_plain_ms = time_ms(torch, lambda: cuda_zdraw.
                             fused_zdraw_nkw_reference(*zargs, **zkw),
                             reps=5, calls=2)
    zdraw_bytes = (4 * 4 * slots + 4 * (D + V) * K + 8 + 4 * 2 * nb
                   + 4 * nb * chunks + 4 * blocks.nwin_w * vspan * K)
    zdraw_ops = 3.0 * n_tok * K         # product, prefix sum, compare
    zdraw_bound, zdraw_by = bound(zdraw_bytes, zdraw_ops)
    print(f"[3 zdraw] z agreement {json.dumps(agreement)}; planted topics "
          f"exact; chi2={chi2:.1f} (df {K - 1}, p={pval:.3g}); "
          f"{zdraw_ms:.4f} ms, plain {zdraw_plain_ms:.4f} ms, bound "
          f"{zdraw_bound:.4f} ms ({zdraw_by}); max |N_kw - plain| "
          f"{zdraw_err}", flush=True)
    del theta, phi, theta_m, onehot, u24, z, z_b, key_b, lib
    torch.cuda.empty_cache()

    # ---- 4. main path: the library entry point -------------------------
    cuda_counts.blocked_label_counts.launches = 0
    cuda_zdraw.fused_zdraw_nkw.launches = 0
    model = create_model(cfg)
    model.add_instances(corpus)
    ll0 = model.model_log_likelihood()
    model.sample(10)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    model.sample(ITERS - 10)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    launches = {
        "fused_zdraw_nkw": cuda_zdraw.fused_zdraw_nkw.launches,
        "blocked_label_counts": cuda_counts.blocked_label_counts.launches}
    check(launches["fused_zdraw_nkw"] == ITERS,
          f"z-draw kernel launched {launches['fused_zdraw_nkw']} times")
    check(launches["blocked_label_counts"] >= ITERS,
          f"count kernel launched {launches['blocked_label_counts']} times")
    zc = model.get_z_indicators()
    nkw_ref = np.zeros((V, K), np.int64)
    np.add.at(nkw_ref, (corpus.tokens, zc), 1)
    ndk_ref = np.zeros((D, K), np.int64)
    np.add.at(ndk_ref, (corpus.token_doc_ids(), zc), 1)
    check(np.array_equal(model.get_topic_type_counts().T, nkw_ref),
          "N_kw differs from a recount of z")
    check(np.array_equal(model.get_document_topic_matrix(), ndk_ref),
          "n_dk differs from a recount of z")
    nk = model.get_tokens_per_topic()
    check(np.array_equal(nk, nkw_ref.sum(axis=0)) and nk.sum() == n_tok,
          "n_k differs from a recount of z")
    lls = dict(model.get_log_likelihoods())
    check(lls[30] > lls[10] > ll0, f"LL did not rise: init {ll0}, {lls}")
    tok_s = n_tok * (ITERS - 10) / (t_b - t_a)
    print(f"[4 main path] ggs K={K} on {torch.cuda.get_device_name(0)} "
          f"({smi}): launches {json.dumps(launches)}; counts exact; LL "
          f"init {ll0:.1f} -> it10 {lls[10]:.1f} -> it30 {lls[30]:.1f}; "
          f"{tok_s:.0f} tokens/s over iterations 11-30 "
          f"({(t_b - t_a) / (ITERS - 10) * 1e3:.3f} ms/iteration, host "
          "clock, LL at 20 and 30 included)", flush=True)
    print(f"[4 profile] {profile_iterations(torch, model, 5)}", flush=True)
    del model
    torch.cuda.empty_cache()

    # ---- 5. the experiment CLI ------------------------------------------
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(1)
    themes = [["cat", "lynx", "leopard", "tiger", "kitten", "paw", "purr"],
              ["car", "engine", "wheel", "road", "drive", "fuel", "brake"],
              ["tree", "leaf", "forest", "branch", "root", "oak", "pine"]]
    with open(os.path.join(work, "docs.txt"), "w") as f:
        for d in range(300):
            words = [themes[d % 3][i] for i in rng.integers(0, 7, 40)]
            words += [themes[rng.integers(0, 3)][rng.integers(0, 7)]
                      for _ in range(4)]
            f.write(f"docno:{d}\tL{d % 3}\t{' '.join(words)}\n")
    with open(os.path.join(work, "run.cfg"), "w") as f:
        f.write(f"configs = ggs\nno_runs = 1\n"
                f"experiment_out_dir = {work}/runs\nexec_time = 300\n"
                f"iterations = {ITERS}\ntopics = 3\nalpha = 1\n"
                f"beta = 0.01\ndataset = {work}/docs.txt\n"
                f"rare_threshold = 0\nseed = 2019\ntopic_interval = 10\n"
                f"start_diagnostic = 1\nstoplist =\ndevice = cuda\n\n"
                f"[ggs]\nscheme = ggs\n")
    cuda_counts.blocked_label_counts.launches = 0
    cuda_zdraw.fused_zdraw_nkw.launches = 0
    parallel_lda.main([f"--run_cfg={work}/run.cfg"])
    cli_launches = (cuda_zdraw.fused_zdraw_nkw.launches,
                    cuda_counts.blocked_label_counts.launches)
    check(cli_launches[0] == ITERS and cli_launches[1] >= ITERS,
          f"CLI run launches (zdraw, counts) = {cli_launches}")
    run_dir = glob.glob(os.path.join(work, "runs", "RunSuite*", "Runggs-*"))
    check(len(run_dir) == 1, f"CLI run directories: {run_dir}")
    for fn in ("likelihood.txt", "TopWords.txt", "run_metadata.json"):
        check(os.path.exists(os.path.join(run_dir[0], fn)), f"CLI: no {fn}")
    ll_cli = [float(ln.split("\t")[1]) for ln in
              open(os.path.join(run_dir[0], "likelihood.txt"))]
    check(len(ll_cli) == 3 and ll_cli[-1] > ll_cli[0],
          f"CLI LL did not rise: {ll_cli}")
    print(f"[5 cli] parallel_lda on cuda: launches (zdraw, counts) "
          f"{cli_launches}; LL {ll_cli}", flush=True)

    kernels = [
        {"name": "blocked_label_counts", "route": "cuda",
         "source": "ldagroupedgibbssampler_tpu_torch/csrc/label_counts.cu",
         "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_counts.py:33",
         "launches": launches["blocked_label_counts"], "max_abs_err": 0,
         "ms": counts_ms, "plain_ms": counts_plain_ms,
         "bound_ms": counts_bound, "bound_by": counts_by,
         "library_ms": counts_lib_ms},
        {"name": "fused_zdraw_nkw", "route": "cuda",
         "source": "ldagroupedgibbssampler_tpu_torch/csrc/zdraw.cu",
         "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_zdraw.py:59",
         "launches": launches["fused_zdraw_nkw"], "max_abs_err": zdraw_err,
         "ms": zdraw_ms, "plain_ms": zdraw_plain_ms,
         "bound_ms": zdraw_bound, "bound_by": zdraw_by,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
