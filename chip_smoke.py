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
     The PCGS sweep kernel is held against its plain version on the
     resident layout at K=100 and the streamed layout at K=200, with
     injected and Philox uniforms, exact zeros in phi, and a chi-square;
  4. the main paths on that corpus on cuda, each with its launch counters
     set to 0 just before it and read just after: LDAGroupedGibbsSampler
     (ggs) and scheme pcgs at K=100, 30 iterations with the likelihood
     every 10 (exact recounts, rising likelihood, tokens/s, a profile),
     then pcgs at K=200 (streamed layout) and polyaurn at K=100, 10
     iterations each;
  5. the experiment CLI (tui.parallel_lda.main) on a small text corpus on
     cuda, with a ggs and a pcgs section.
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


def check_counts_exact(model, corpus, label: str):
    """N_kw, n_dk and n_k of the model's state equal a host recount of its
    z (get_z_indicators)."""
    zc = model.get_z_indicators()
    k = model.config.topics
    nkw_ref = np.zeros((corpus.num_types, k), np.int64)
    np.add.at(nkw_ref, (corpus.tokens, zc), 1)
    ndk_ref = np.zeros((corpus.num_docs, k), np.int64)
    np.add.at(ndk_ref, (corpus.token_doc_ids(), zc), 1)
    check(np.array_equal(model.get_topic_type_counts().T, nkw_ref),
          f"{label}: N_kw differs from a recount of z")
    check(np.array_equal(model.get_document_topic_matrix(), ndk_ref),
          f"{label}: n_dk differs from a recount of z")
    nk = model.get_tokens_per_topic()
    check(np.array_equal(nk, nkw_ref.sum(axis=0))
          and nk.sum() == corpus.num_tokens,
          f"{label}: n_k differs from a recount of z")


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


PCGS_LAYOUTS = ((100, "resident"), (200, "streamed"))


def pcgs_config(LDAConfig, scheme: str, topics: int):
    return LDAConfig(scheme=scheme, topics=topics, alpha=0.5, beta=0.01,
                     seed=2019, exec_time=-1, topic_interval=10,
                     device="cuda")


def check_sweep_outputs(torch, model, label, z_old, z, nkw, table, doc_sel):
    """One PCGS sweep's outputs against recounts: N_kw is the histogram of
    z, the table's n_dk (minus alpha) a recount of z and its flag row
    intact, and padding slots and unselected documents keep z."""
    real = model._slot_mask
    k, d = model.config.topics, model.corpus.num_docs
    hist = torch.zeros_like(nkw)
    hist.index_put_((model._slot_w[real], z[real].long()),
                    torch.ones_like(z[real]), accumulate=True)
    check(torch.equal(hist, nkw),
          f"{label}: N_kw is not the histogram of the kernel's z")
    ndk = torch.round(table[:k, :d].T - model.state.alpha[None, :])
    check(torch.equal(ndk.to(torch.int32), model._count_ndk(z)),
          f"{label}: the table's n_dk differs from a recount of z")
    kpad = table.shape[0] - 8
    check(torch.equal(table[kpad, :d], doc_sel.to(torch.float32)),
          f"{label}: the table's doc-mask row changed")
    check(torch.equal(z[~real], z_old[~real]),
          f"{label}: a padding slot changed z")
    unsel = real & ~doc_sel[model._slot_d]
    check(torch.equal(z[unsel], z_old[unsel]),
          f"{label}: an unselected document changed z")
    sel = real & doc_sel[model._slot_d]
    check(bool((z[sel] != z_old[sel]).any()),
          f"{label}: no selected token moved")


def pcgs_chi_square(torch, cuda_pcgs, gen, seed, k=100, n=200_704,
                    block=4096, chunk=128):
    """Chi-square of `n` Philox draws of one-token documents of one type
    against the exact conditional alpha_k * phi[k][w] (rounded as the
    kernel rounds). Returns (chi2, p-value)."""
    from scipy import stats as sps
    dev = seed.device
    nb = n // block
    zero3 = torch.zeros((nb, block // chunk, chunk), dtype=torch.int32,
                        device=dev)
    alpha = torch.rand(k, generator=gen, device=dev) + 0.05
    phi = torch.rand((1, k), generator=gen, device=dev) + 0.05
    phi = (phi / phi.sum()).contiguous()
    kpad = cuda_pcgs.kpad_of(k)
    table = torch.zeros((kpad + cuda_pcgs.FLAG_ROWS, n), device=dev)
    table[:k] = alpha[:, None]
    table[0] += 1.0                   # every token sits on topic 0
    table[kpad] = 1.0
    z, _, _ = cuda_pcgs.fused_pcgs_sweep(
        zero3, zero3, zero3, table, phi, seed,
        torch.zeros(nb, dtype=torch.int32, device=dev),
        torch.ones(nb, dtype=torch.int32, device=dev),
        torch.zeros(nb * block // chunk, dtype=torch.int32, device=dev),
        torch.arange(n + 1, dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev),
        nwin_w=1, nwin_d=1, vspan=128, dspan=128, num_topics=k,
        positive_support=True)
    nd = table[:k, 0].clone()
    nd[0] -= 1.0
    bf = torch.bfloat16
    p = (nd * phi[0].to(bf).float()).to(bf).double().cpu().numpy()
    p /= p.sum()
    obs = np.bincount(z.cpu().numpy().reshape(-1), minlength=k)
    exp = p * obs.sum()
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    return chi2, float(sps.chi2.sf(chi2, k - 1))


def pcgs_kernel_phase(torch, corpus, LDAConfig, create_model, cuda_pcgs):
    """[3 pcgs]: the sweep kernel against its plain version at the 20NG
    shapes, on the resident layout at K=100 and the streamed one at K=200,
    with operands built by the model as its main path builds them.
    Returns one `kernels` entry per layout (launches filled in later)."""
    plain_of = {
        cuda_pcgs.fused_pcgs_sweep: cuda_pcgs.fused_pcgs_sweep_reference,
        cuda_pcgs.fused_pcgs_sweep_streamed:
            cuda_pcgs.fused_pcgs_sweep_streamed_reference}
    entries = []
    for k, layout in PCGS_LAYOUTS:
        t0 = time.perf_counter()
        model = create_model(pcgs_config(LDAConfig, "pcgs", k))
        model.add_instances(corpus)
        setup_s = time.perf_counter() - t0
        check(model._mode == layout,
              f"K={k}: layout {model._mode}, expected {layout}")
        dev, st = model.device, model.state
        gen = torch.Generator(device=dev)
        gen.manual_seed(k)
        real = model._slot_mask
        doc_sel = (torch.arange(D, device=dev) % 5) != 0
        table = model._ndk_table(st.ndk, st.alpha, doc_sel)
        phi_vk = st.phi.T.contiguous()
        seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                            device=dev)
        u24 = torch.randint(0, 2 ** 24, tuple(st.z.shape), generator=gen,
                            device=dev, dtype=torch.int32)
        agreement = {}
        for label, u in (("u24", u24), ("philox", None)):
            fn, args, kw = model._sweep_call(st.z, table, phi_vk, seed, u)
            zk, nkw_k, tb_k = fn(*args, **kw)
            zr, nkw_r, _ = plain_of[fn](*args, **kw)
            torch.cuda.synchronize()
            agree = float((zk == zr)[real].float().mean())
            agreement[label] = agree
            check(agree >= 0.999, f"pcgs K={k} ({label}): only "
                  f"{agree:.6f} of tokens agree with the plain version")
            check_sweep_outputs(torch, model, f"pcgs K={k} ({label})",
                                st.z, zk, nkw_k, tb_k, doc_sel)
            if label == "philox":
                err = int((nkw_k - nkw_r).abs().max())
        # exact zeros in phi (about half the entries) and no positive
        # support: no token may land on a zero-probability topic
        keep = torch.rand(phi_vk.shape, generator=gen, device=dev) < 0.5
        phi_zero = torch.where(keep, phi_vk, 0.0).contiguous()
        fn, args, kw = model._sweep_call(st.z, table, phi_zero, seed)
        kw = {**kw, "positive_support": False}
        zk, nkw_k, tb_k = fn(*args, **kw)
        zr, _, _ = plain_of[fn](*args, **kw)
        torch.cuda.synchronize()
        agreement["philox zero-phi"] = float((zk == zr)[real].float().mean())
        check(agreement["philox zero-phi"] >= 0.999,
              f"pcgs K={k} zero-phi: z agreement {agreement}")
        check_sweep_outputs(torch, model, f"pcgs K={k} (zero-phi)", st.z,
                            zk, nkw_k, tb_k, doc_sel)
        sel = real & doc_sel[model._slot_d]
        check(bool((phi_zero[model._slot_w[sel], zk[sel].long()] > 0).all()),
              f"pcgs K={k}: a draw landed on a zero-probability topic")
        chi = ""
        if k == 100:
            chi2, pval = pcgs_chi_square(torch, cuda_pcgs, gen, seed)
            check(pval > 1e-4, f"pcgs chi-square p={pval:.2e}")
            chi = f"; chi2={chi2:.1f} (df {k - 1}, p={pval:.3g})"
        fn, args, kw = model._sweep_call(st.z, table, phi_vk, seed)
        ms = time_ms(torch, lambda: fn(*args, **kw))
        plain_ms = time_ms(torch, lambda: plain_of[fn](*args, **kw),
                           reps=3, calls=1)
        slots, n = st.z.numel(), corpus.num_tokens
        b = model._sblocks
        nbytes = (4 * 3 * slots + 4 * args[6].numel() + 4 * (D + 1)
                  + 4 * n + 4 * V * k + 8 + 2 * 4 * table.numel()
                  + 4 * b.nwin_w * model._vspan * k)
        bound_ms, bound_by = bound(nbytes, 3.0 * n * k)
        print(f"[3 pcgs] K={k} {layout} layout (vspan {model._vspan}, "
              f"{slots} slots for {n} tokens, model set up in "
              f"{setup_s:.1f} s): z agreement {json.dumps(agreement)}; "
              f"N_kw, n_dk, flags and kept z exact; no draw on a "
              f"zero-probability topic{chi}; {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"max |N_kw - plain| {err}", flush=True)
        entries.append(
            {"name": fn.__name__, "route": "cuda",
             "source": "ldagroupedgibbssampler_tpu_torch/csrc/pcgs.cu",
             "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_pcgs.py:"
                         + ("135" if layout == "resident" else "653"),
             "launches": 0, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None})
        del model, st, table, phi_vk, phi_zero, u24, zk, zr, tb_k, nkw_k
        torch.cuda.empty_cache()
    return entries


def pcgs_main_path(torch, corpus, LDAConfig, create_model, cuda_pcgs, smi):
    """[4 pcgs main path]: scheme pcgs K=100 (resident layout) for ITERS
    iterations with a profile, then pcgs K=200 (streamed layout) and
    polyaurn K=100 for 10 iterations each, each with its launch counts
    set to 0 just before it and read just after. Returns the launches of
    each wrapper in its own run."""
    res, stm = cuda_pcgs.fused_pcgs_sweep, cuda_pcgs.fused_pcgs_sweep_streamed
    launches = {}

    res.launches = stm.launches = 0
    model = create_model(pcgs_config(LDAConfig, "pcgs", 100))
    model.add_instances(corpus)
    ll0 = model.model_log_likelihood()
    model.sample(10)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    model.sample(ITERS - 10)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    launches[res.__name__] = res.launches
    check(res.launches == ITERS and stm.launches == 0,
          f"pcgs: sweep launches (resident, streamed) = "
          f"{(res.launches, stm.launches)}")
    check_counts_exact(model, corpus, "pcgs")
    lls = dict(model.get_log_likelihoods())
    check(lls[30] > lls[10] > ll0, f"pcgs LL did not rise: init {ll0}, "
          f"{lls}")
    n = corpus.num_tokens
    print(f"[4 pcgs main path] pcgs K=100 resident on "
          f"{torch.cuda.get_device_name(0)} ({smi}): launches "
          f"{launches[res.__name__]}; counts exact; LL init {ll0:.1f} -> "
          f"it10 {lls[10]:.1f} -> it30 {lls[30]:.1f}; "
          f"{n * (ITERS - 10) / (t_b - t_a):.0f} tokens/s over iterations "
          f"11-30 ({(t_b - t_a) / (ITERS - 10) * 1e3:.3f} ms/iteration, "
          "host clock, LL at 20 and 30 included)", flush=True)
    print(f"[4 pcgs profile] {profile_iterations(torch, model, 5)}",
          flush=True)
    del model
    torch.cuda.empty_cache()

    for scheme, k, layout in (("pcgs", 200, "streamed"),
                              ("polyaurn", 100, "resident")):
        res.launches = stm.launches = 0
        model = create_model(pcgs_config(LDAConfig, scheme, k))
        model.add_instances(corpus)
        check(model._mode == layout, f"{scheme} K={k}: layout "
              f"{model._mode}")
        ll0 = model.model_log_likelihood()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(9)
        phi_prev = model.get_phi()
        model.sample(1)
        t1 = time.perf_counter()
        wrapper = stm if layout == "streamed" else res
        other = res if layout == "streamed" else stm
        if scheme == "pcgs":
            launches[stm.__name__] = stm.launches
        check(wrapper.launches == 10 and other.launches == 0,
              f"{scheme} K={k}: sweep launches {wrapper.launches}, other "
              f"layout {other.launches}")
        check_counts_exact(model, corpus, f"{scheme} K={k}")
        lls = dict(model.get_log_likelihoods())
        check(lls[10] > ll0, f"{scheme} K={k}: LL did not rise: init "
              f"{ll0}, {lls}")
        extra = ""
        if scheme == "polyaurn":
            # no token drawn onto a zero phi[k][w] of the sweep that drew
            # it; a type whose phi column is all zero keeps its z
            z = model.get_z_indicators()
            live = phi_prev.sum(axis=0)[corpus.tokens] > 0
            check(bool((phi_prev[z, corpus.tokens][live] > 0).all()),
                  "polyaurn: a token sits on a zero-probability topic")
            extra = (f"; phi density {model.get_phi_density():.4f}; "
                     f"{int((~live).sum())} tokens of all-zero phi columns "
                     "kept z; no draw on a zero phi")
        print(f"[4 {scheme} K={k}] {layout} layout: launches "
              f"{wrapper.launches}; counts exact; LL init {ll0:.1f} -> "
              f"it10 {lls[10]:.1f}; {(t1 - t0) / 10 * 1e3:.3f} "
              f"ms/iteration (host clock, LL at 10 included){extra}",
              flush=True)
        del model
        torch.cuda.empty_cache()
    return launches


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
    from ldagroupedgibbssampler_tpu_torch.ops import (cuda_counts, cuda_pcgs,
                                                      cuda_zdraw)
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
    pcgs_entries = pcgs_kernel_phase(torch, corpus, LDAConfig, create_model,
                                     cuda_pcgs)

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
    check_counts_exact(model, corpus, "ggs")
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
    pcgs_launches = pcgs_main_path(torch, corpus, LDAConfig, create_model,
                                   cuda_pcgs, smi)
    for entry in pcgs_entries:
        entry["launches"] = pcgs_launches[entry["name"]]

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
        f.write(f"configs = ggs, pcgs\nno_runs = 1\n"
                f"experiment_out_dir = {work}/runs\nexec_time = 300\n"
                f"iterations = {ITERS}\ntopics = 3\nalpha = 1\n"
                f"beta = 0.01\ndataset = {work}/docs.txt\n"
                f"rare_threshold = 0\nseed = 2019\ntopic_interval = 10\n"
                f"start_diagnostic = 1\nstoplist =\ndevice = cuda\n\n"
                f"[ggs]\nscheme = ggs\n\n"
                f"[pcgs]\nscheme = pcgs\nsave_phi = true\n")
    cuda_counts.blocked_label_counts.launches = 0
    cuda_zdraw.fused_zdraw_nkw.launches = 0
    cuda_pcgs.fused_pcgs_sweep.launches = 0
    cuda_pcgs.fused_pcgs_sweep_streamed.launches = 0
    parallel_lda.main([f"--run_cfg={work}/run.cfg"])
    cli_launches = (cuda_zdraw.fused_zdraw_nkw.launches,
                    cuda_counts.blocked_label_counts.launches,
                    cuda_pcgs.fused_pcgs_sweep.launches)
    check(cli_launches[0] == ITERS and cli_launches[1] >= ITERS
          and cli_launches[2] == ITERS,
          f"CLI run launches (zdraw, counts, pcgs) = {cli_launches}")
    ll_cli = {}
    for name, files in (("ggs", ()), ("pcgs", ("phi.csv",))):
        run_dir = glob.glob(os.path.join(work, "runs", "RunSuite*",
                                         f"Run{name}-*"))
        check(len(run_dir) == 1, f"CLI run directories: {run_dir}")
        for fn in ("likelihood.txt", "TopWords.txt", "run_metadata.json",
                   *files):
            check(os.path.exists(os.path.join(run_dir[0], fn)),
                  f"CLI {name}: no {fn}")
        lls = [float(ln.split("\t")[1]) for ln in
               open(os.path.join(run_dir[0], "likelihood.txt"))]
        check(len(lls) == 3 and lls[-1] > lls[0],
              f"CLI {name} LL did not rise: {lls}")
        ll_cli[name] = lls
    print(f"[5 cli] parallel_lda on cuda, sections ggs and pcgs: launches "
          f"(zdraw, counts, pcgs) {cli_launches}; LL {json.dumps(ll_cli)}",
          flush=True)

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
        *pcgs_entries,
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
