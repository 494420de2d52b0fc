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
     library yardstick where one exists, and its bound; the count kernel
     on layouts A and B at K=100 with uniform and concentrated z (each
     word's tokens mostly on one topic) and on layout A at K=4096 (its
     global instance), each with its launch shape; the z-draw also
     with its launch shape, its precise-mode time, and a K=514 check on
     the first 1,000 documents (the instance that loads one topic at a
     time). The PCGS sweep kernel is held against its plain version on
     the resident layout at K=100 and the streamed layout at K=200, with
     injected and Philox uniforms, exact zeros in phi, a chi-square, the
     documents in index order bit-equal to longest first, its bf16
     word-table pre-pass bit-equal to its plain version and timed alone,
     its launch shape and registers, a K=514 check on the first 1,000
     documents (the shared-memory instance above kpad 256), and the HDP
     family's operands (alpha exactly 0 on 60% of the topics, whose phi
     rows are 0 and which hold no token), equal to the plain version on
     every token but documents whose first difference is a proven
     rounding tie.
     The LightLDA MH sweep kernel likewise (resident K=100, streamed
     K=200), with a chi-square against the enumerated MH transition, its
     word-cdf pre-pass against its plain version and timed alone, and its
     launch shape;
     The collapsed (ADLDA) mode of the PCGS sweep kernel likewise
     (`[3 adlda sweep]`): bookkeeping against an entry N_kw that is not
     the z_old histogram, one selected document against the plain
     version (the sequential chain), the one-warp launch on the first 200
     documents, and a chi-square of 200,704 one-token documents, with the
     launch shape (warps per block, shared memory per warp);
  4. the main paths on that corpus on cuda, each with its launch counters
     set to 0 just before it and read just after: LDAGroupedGibbsSampler
     (ggs), schemes pcgs, lightpclda and adlda at K=100, 30 iterations
     with the likelihood every 10 (exact recounts, rising likelihood,
     tokens/s, a profile), then pcgs at K=200 (streamed layout), polyaurn
     at K=100, lightpcldaw2 and lightcollapsed at K=100, lightpclda and
     adlda at K=200 (streamed), 10 iterations each; then `[4 adlda
     oracle]`, adlda on the first 2,000 documents with the parallel and
     the one-warp launch from one seed (likelihood gap under 0.5% at
     iteration 30), beside the spread of three parallel chains' gaps and
     of three one-warp chains from three seeds; `[4 ggs_aliasmh main
     path]`, scheme ggs_aliasmh at K=100 for 30 iterations (the count
     kernel on both layouts every iteration) with a profile, and
     `[4 ggs_aliasmh K=4096]`, ggs_aliasmh beside dense ggs at K=4096, 10
     iterations each; `[4 ppu_hdplda main path]`, scheme ppu_hdplda at
     K_max=100 (the JAX package's 20NG HDP configuration) for 30
     iterations with a profile (a finite likelihood, which falls while
     topics are born as in the JAX package's chain; the active topics at
     10, 20 and 30; inactive topics with alpha 0, zero phi rows and no
     token), then ppu_hlda at K=100 (10 iterations),
     ppu_hdplda_all_topics at K=100 (30, the likelihood rising from 10 to
     30), spalias_priors (10 topics anchoring 5 of the most frequent
     words each: phi exactly 0 and no token on a masked pair) and
     nzvsspalias at K=100, and nzvsspalias at K=200 (streamed), 10
     iterations each; and
     `[4 collapsed]`, the serial oracle on the first 100 documents;
  5. the experiment CLI (tui.parallel_lda.main) on a small text corpus on
     cuda, with a ggs, a pcgs, a lightpclda, an adlda, a ggs_aliasmh, a
     spalias_priors (with its prior file) and a ppu_hdplda section.
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


def slot_hist(torch, model, z, rows):
    """N_kw [rows, K] int32: the histogram of z over the model's real
    slots."""
    real = model._slot_mask
    hist = torch.zeros((rows, model.config.topics), dtype=torch.int32,
                       device=z.device)
    hist.index_put_((model._slot_w[real], z[real].long()),
                    torch.ones_like(z[real]), accumulate=True)
    return hist


def check_sweep_outputs(torch, model, label, z_old, z, nkw, table, doc_sel,
                        entry=None, alpha=None):
    """One PCGS sweep's outputs against recounts: N_kw is the histogram of
    z (with the collapsed mode's entry counts `entry` [rows, K]: entry +
    hist(z) - hist(z_old)), the table's n_dk (minus alpha, the model's
    unless given) a recount of z and its flag row intact, and padding
    slots and unselected documents keep z."""
    real = model._slot_mask
    k, d = model.config.topics, model.corpus.num_docs
    alpha = model.state.alpha if alpha is None else alpha
    hist = slot_hist(torch, model, z, nkw.shape[0])
    what = "histogram"
    if entry is not None:
        hist += entry - slot_hist(torch, model, z_old, nkw.shape[0])
        what = "entry count plus the moves"
    check(torch.equal(hist, nkw), f"{label}: N_kw is not the {what} of the "
          "kernel's z")
    ndk = torch.round(table[:k, :d].T - alpha[None, :])
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
        positive_support=True,
        doc_order=torch.arange(n, dtype=torch.int32, device=dev))
    nd = table[:k, 0].clone()
    nd[0] -= 1.0
    bf = torch.bfloat16
    p = (nd * phi[0].to(bf).float()).to(bf).double().cpu().numpy()
    p /= p.sum()
    obs = np.bincount(z.cpu().numpy().reshape(-1), minlength=k)
    exp = p * obs.sum()
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    return chi2, float(sps.chi2.sf(chi2, k - 1))


def zdraw_large_k(torch, corpus, Corpus, cfg, cuda_zdraw, cuda_counts, gen,
                  k=514, num_docs=1000):
    """The z-draw at a large K that is no multiple of 4 (the instance
    that loads one topic at a time): K=514 on the first `num_docs`
    documents, u24 and Philox, both precision modes. z agrees with the
    plain version on >= 99.9% of tokens, N_kw is the histogram of z,
    padding keeps z. Returns a summary for the [3 zdraw] line."""
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import real_slot_list
    dev = torch.device("cuda", 0)
    sub = first_docs(Corpus, corpus, num_docs)
    b = sub.cell_blocks(block=cfg.token_block, vspan=cfg.vocab_span,
                        dspan=cfg.doc_span)
    nb, block = b.w_local.shape
    sh3 = (nb, block // b.chunk, b.chunk)

    def t(a):
        return torch.as_tensor(a, device=dev)
    w3, d3 = t(b.w_local).view(sh3), t(b.d_local_a).view(sh3)
    z_old = torch.randint(0, k, sh3, generator=gen, device=dev,
                          dtype=torch.int32)
    theta = torch.rand((sub.num_docs, k), generator=gen, device=dev)
    phi = torch.rand((sub.num_types, k), generator=gen, device=dev)
    u24 = torch.randint(0, 2 ** 24, sh3, generator=gen, device=dev,
                        dtype=torch.int32)
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    args = (w3, d3, z_old, theta, phi, seed, t(b.win_w), t(b.first_w),
            t(b.win_d_chunks))
    kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=cfg.vocab_span,
              dspan=cfg.doc_span, num_topics=k)
    real_slots = t(real_slot_list(b.mask))
    pad = w3 == cfg.vocab_span
    agree = {}
    for precise in (False, True):
        for label, u in (("u24", u24), ("philox", None)):
            zk, nk_k = cuda_zdraw.fused_zdraw_nkw(*args, u, precise=precise,
                                                  real_slots=real_slots, **kw)
            zr, _ = cuda_zdraw.fused_zdraw_nkw_reference(
                *args, u, precise=precise, **kw)
            torch.cuda.synchronize()
            name = f"{label} {'precise' if precise else 'bf16'}"
            agree[name] = float((zk == zr)[~pad].float().mean())
            check(agree[name] >= 0.999, f"z-draw K={k} ({name}): only "
                  f"{agree[name]:.6f} of tokens agree with the plain version")
            hist = cuda_counts.blocked_label_counts_reference(
                w3.reshape(nb, block), zk.view(nb, block), t(b.win_w),
                t(b.first_w), nwin=b.nwin_w, vspan=cfg.vocab_span,
                num_labels=k)
            check(torch.equal(nk_k, hist), f"z-draw K={k} ({name}): N_kw "
                  "is not the histogram of the kernel's z")
            check(torch.equal(zk[pad], z_old[pad]),
                  f"z-draw K={k} ({name}): a padding slot changed z")
    return (f"K={k} on the first {num_docs} documents ({sub.num_tokens} "
            f"tokens), {cuda_zdraw.launch_shape(theta, phi)[2]} topic a row "
            f"load: "
            f"z agreement "
            f"{json.dumps(agree)}, N_kw and kept z exact")


def ptxas_registers(_build, name):
    """Registers and spill stores of each instance of the kernel `name`,
    from ptxas's lines in the built library's log: {"template arguments":
    "R registers, S B spilled"}."""
    import re
    log = _build.library_path().with_suffix(".log")
    out, key, spill = {}, None, "0"
    for line in (log.read_text().splitlines() if log.exists() else ()):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.search(name + r"I(.*?)EEv", m.group(1))
            key = (",".join(re.findall(r"L[ib](\d+)E", args.group(1) + "E"))
                   if args else "" if name + "E" in m.group(1) else None)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if key is not None and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if key is not None and m:
            out[key] = f"{m.group(1)} registers, {spill} B spilled"
            key, spill = None, "0"
    return out


COUNT_CASES = (("A", 100, "uniform"), ("A", 100, "concentrated"),
               ("B", 100, "uniform"), ("B", 100, "concentrated"),
               ("A", 4096, "uniform"), ("A", 4096, "concentrated"))


def count_cases(torch, blocks, dev, cases=COUNT_CASES):
    """The count kernel's operands on the layouts of `blocks`: {"A K=100
    uniform": (args, kw), ...} for each (layout, K, z shape) of `cases`.
    z is uniform over K, or concentrated: each word's tokens sit on topic
    w mod K with probability 0.9 and on a uniform topic otherwise (the
    shape a chain past burn-in gives the Zipf head rows). Layout B gets z
    by the models' regroup. Drawn from a generator of its own (seed 8)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def t(a):
        return torch.as_tensor(a, device=dev)
    wb, winb, firstb, mask = (t(blocks.w_local), t(blocks.win_w),
                              t(blocks.first_w), t(blocks.mask))
    srcb = t(blocks.src_chunks.astype(np.int64))
    dlb, windb, firstdb = t(blocks.d_local), t(blocks.win_d), \
        t(blocks.first_d)
    word = winb.to(torch.int64)[:, None] * blocks.vspan + wb
    out = {}
    for layout, k, shape in cases:
        z = torch.randint(0, k, wb.shape, generator=gen, device=dev,
                          dtype=torch.int32)
        if shape == "concentrated":
            hot = torch.rand(wb.shape, generator=gen, device=dev) < 0.9
            z = torch.where(hot, (word % k).to(torch.int32), z)
        z = torch.where(mask, z, 0)
        if layout == "A":
            args = (wb, z, winb, firstb)
            kw = dict(nwin=blocks.nwin_w, vspan=blocks.vspan, num_labels=k)
        else:
            z_b = z.view(-1, blocks.chunk)[srcb].view(dlb.shape).contiguous()
            args = (dlb, z_b, windb, firstdb)
            kw = dict(nwin=blocks.nwin_d, vspan=blocks.dspan, num_labels=k)
        out[f"{layout} K={k} {shape}"] = (args, kw)
    return out


def counts_phase(torch, blocks, n_tok, cuda_counts, _build):
    """[3 counts]: the count kernel against its plain version on layouts A
    and B at K=100 with uniform and concentrated z, and on layout A at
    K=4096 (the global instance), and on blocks cut to 4094 slots (the
    shared instance's path without 16-byte loads): exact, summing to N
    (but the cut blocks), each timed beside
    its bound, its plain version and torch.bincount on the same keys, with
    each instance's launch shape and registers. Returns the kernel's entry
    of the kernels JSON line (its main fields: layout B, K=100, uniform z,
    the ggs path's per-iteration call)."""
    dev = torch.device("cuda", 0)
    fn, plain = (cuda_counts.blocked_label_counts,
                 cuda_counts.blocked_label_counts_reference)
    block = blocks.w_local.shape[1]
    cases = {}
    for name, (args, kw) in count_cases(torch, blocks, dev).items():
        got = fn(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"label counts {name} differ from the "
              "plain version")
        check(int(got.sum()) == n_tok, f"label counts {name}: sum != N")
        ids, labels, win, _ = args
        k, vspan = kw["num_labels"], kw["vspan"]
        valid = ids < vspan
        key = ((win.to(torch.int64)[:, None] * vspan + ids)[valid] * k
               + labels[valid])
        nrows = kw["nwin"] * vspan
        lib = torch.bincount(key, minlength=nrows * k).view(nrows, k)
        check(torch.equal(lib.to(torch.int32), got),
              f"torch.bincount disagrees with the count kernel ({name})")
        del lib, got, ref
        if name == "A K=100 concentrated":
            # blocks of 4094 slots: the shared instance's 4-byte-load path
            cut = [a[:, :4094].contiguous() for a in args[:2]] + list(
                args[2:])
            check(torch.equal(fn(*cut, **kw), plain(*cut, **kw)),
                  f"label counts {name}, blocks of 4094: differ from the "
                  "plain version")
        # the bytes the function needs: every slot's id, the labels of the
        # real slots only, the window ids once, the table written once
        nbytes = 4 * (ids.numel() + int(valid.sum()) + win.numel()
                      + nrows * k)
        b_ms, b_by = bound(nbytes, 0)
        inst, threads, smem, per_sm = cuda_counts.launch_shape(vspan, k,
                                                               block)
        run = cuda_counts.count_instance(vspan, k, block).run_blocks
        cases[name] = {
            "ms": time_ms(torch, lambda: fn(*args, **kw)),
            "plain_ms": time_ms(torch, lambda: plain(*args, **kw), reps=3,
                                calls=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: torch.bincount(
                key, minlength=nrows * k)),
            "instance": inst,
            "launch": (f"{threads} threads, {smem} B shared a CTA, {run} "
                       f"blocks a CTA, {per_sm} CTAs an SM")}
        del key
    regs = {name: ptxas_registers(_build, name).get("", "not in the log")
            for name in ("label_counts_shared_kernel",
                         "label_counts_global_kernel")}
    print("[3 counts] exact and summing to N in every case, and exact on "
          "blocks of 4094 slots; " + "; ".join(
        f"{name}: {c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
        f"({c['bound_by']}), torch.bincount {c['library_ms']:.4f} ms, plain "
        f"{c['plain_ms']:.4f} ms, {c['instance']} instance ({c['launch']})"
        for name, c in cases.items()) + f"; ptxas {json.dumps(regs)}",
        flush=True)
    main = cases["B K=100 uniform"]
    a = cases["A K=100 uniform"]
    return {"name": "blocked_label_counts", "route": "cuda",
            "source": "ldagroupedgibbssampler_tpu_torch/csrc/label_counts.cu",
            "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_counts.py:33",
            "max_abs_err": 0,
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            **{f"{key}_a": a[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
            "cases": {name: {key: c[key] for key in (
                "ms", "bound_ms", "library_ms", "plain_ms", "instance")}
                for name, c in cases.items()}}


def pcgs_sweep_checks(torch, model, gen, seed, plain_of, label, doc_sel):
    """The PCGS-mode checks of one model's layout, shared by [3 pcgs] and
    its K=514 check: z agreement with the plain version (>= 0.999) for
    injected uniforms, Philox and phi with exact zeros (about half the
    entries, positive_support off), N_kw, n_dk, flags and kept z exact, no
    draw on a zero-probability topic, and the kernel with the documents in
    index order bit-equal to longest first. Returns (agreement, max |N_kw
    - plain| of the Philox run)."""
    st, dev = model.state, model.device
    real = model._slot_mask
    table = model._ndk_table(st.ndk, st.alpha, doc_sel)
    phi_vk = st.phi.T.contiguous()
    u24 = torch.randint(0, 2 ** 24, tuple(st.z.shape), generator=gen,
                        device=dev, dtype=torch.int32)
    agreement = {}
    for name, u in (("u24", u24), ("philox", None)):
        fn, args, kw = model._sweep_call(st.z, table, phi_vk, seed, u)
        zk, nkw_k, tb_k = fn(*args, **kw)
        zr, nkw_r, _ = plain_of[fn](*args, **without_order(kw))
        torch.cuda.synchronize()
        agreement[name] = float((zk == zr)[real].float().mean())
        check(agreement[name] >= 0.999, f"{label} ({name}): only "
              f"{agreement[name]:.6f} of tokens agree with the plain version")
        check_sweep_outputs(torch, model, f"{label} ({name})", st.z, zk,
                            nkw_k, tb_k, doc_sel)
        if name == "philox":
            err = int((nkw_k - nkw_r).abs().max())
            # warps taking the documents in index order draw the same as
            # longest first, bit for bit
            index = torch.arange(model.corpus.num_docs, dtype=torch.int32,
                                 device=dev)
            check(all(torch.equal(a, b) for a, b in zip(
                fn(*args, **{**kw, "doc_order": index}),
                (zk, nkw_k, tb_k))), f"{label}: results depend on the "
                  "document order")
    keep = torch.rand(phi_vk.shape, generator=gen, device=dev) < 0.5
    phi_zero = torch.where(keep, phi_vk, 0.0).contiguous()
    fn, args, kw = model._sweep_call(st.z, table, phi_zero, seed)
    kw = {**kw, "positive_support": False}
    zk, nkw_k, tb_k = fn(*args, **kw)
    zr, _, _ = plain_of[fn](*args, **without_order(kw))
    torch.cuda.synchronize()
    agreement["philox zero-phi"] = float((zk == zr)[real].float().mean())
    check(agreement["philox zero-phi"] >= 0.999,
          f"{label} zero-phi: z agreement {agreement}")
    check_sweep_outputs(torch, model, f"{label} (zero-phi)", st.z, zk,
                        nkw_k, tb_k, doc_sel)
    sel = real & doc_sel[model._slot_d]
    check(bool((phi_zero[model._slot_w[sel], zk[sel].long()] > 0).all()),
          f"{label}: a draw landed on a zero-probability topic")
    return agreement, err


def ties_at_first_disagreement(torch, model, label, z_old, zk, zr, table,
                               phi_vk, u24):
    """Where the kernel's z differs from the plain version's, the
    documents' first differing tokens must be rounding ties: the two
    association orders of the f32 prefix sums (csrc/pcgs.cu's header) may
    put u on either side of a boundary only when u lies within 1e-5 of
    the total of the exact (f64) cdf at every boundary between the two
    draws, recomputed on the host from the n_dk both had at that token.
    Returns (tokens that differ, documents)."""
    real = model._slot_mask
    diff = (zk != zr) & real
    n_tok = int(diff.sum())
    if n_tok == 0:
        return 0, 0
    docs = torch.unique(model._slot_d[diff]).tolist()
    check(len(docs) <= 64, f"{label}: {len(docs)} documents differ from the "
          "plain version")
    k = model.config.topics
    kpad = table.shape[0] - 8
    off = model.doc_slot_offsets.cpu().tolist()
    slots = model.doc_slots.cpu().tolist()
    zo, zk_, zr_, w_of = (t.reshape(-1).cpu() for t in
                          (z_old, zk, zr, model._slot_w))
    u_all = u24.reshape(-1).cpu()
    tab = table.cpu()
    phi = phi_vk.cpu()
    for d in docs:
        col = tab[:k, d].clone()                 # f32 n_dk + alpha
        flag = float(tab[kpad, d])
        for s in slots[off[d]:off[d + 1]]:
            a, b = int(zk_[s]), int(zr_[s])
            if a != b:
                break
            if a != int(zo[s]):
                col[int(zo[s])] -= 1.0
                col[a] += 1.0
        nd = col.clone()
        nd[int(zo[s])] -= flag
        bf = phi[int(w_of[s])].to(torch.bfloat16).to(torch.float32)
        p = (nd * bf).to(torch.bfloat16).double()
        cdf = p.cumsum(0)
        total = float(cdf[-1])
        u = float(u_all[s]) * 2.0 ** -24 * total
        lo, hi = min(a, b), max(a, b)
        gap = float((cdf[lo:hi] - u).abs().max())
        check(gap <= 1e-5 * total, f"{label}: document {d} first differs "
              f"at slot {s} ({a} vs {b}) {gap / total:.2e} of its total from "
              "an exact cdf boundary: not a rounding tie")
    return n_tok, len(docs)


def pcgs_zero_alpha_check(torch, model, gen, seed, plain_of, label, doc_sel):
    """The operands of the HDP family on the model's layout: alpha exactly
    0 on 60% of the topics, whose phi rows are all 0 and which hold no
    token (inactive HDP topics), and 30% exact zeros in the live rows
    (Polya-Urn atoms), `positive_support` off, with injected and Philox
    uniforms. The kernel must equal the plain version on every token but
    those of documents whose first differing token is a proven rounding
    tie (ties_at_first_disagreement); no token may land on a dead topic or
    a zero phi; N_kw, n_dk, flags and kept z exact. Returns (a summary,
    the kernel's ms on these operands with Philox uniforms)."""
    from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24
    st, dev = model.state, model.device
    k = model.config.topics
    real = model._slot_mask
    dead = torch.randperm(k, generator=gen, device=dev)[: (6 * k) // 10]
    alive = torch.ones(k, dtype=torch.bool, device=dev)
    alive[dead] = False
    live = torch.nonzero(alive).flatten().to(torch.int32)
    z_old = torch.where(real, live[st.z.long() % live.numel()], 0)
    ndk = model._count_ndk(z_old)
    psi = torch.rand(k, generator=gen, device=dev) + 0.05
    alpha = (0.5 * psi / psi.sum() * alive).contiguous()
    atoms = torch.rand(st.phi.T.shape, generator=gen, device=dev) < 0.3
    phi_vk = torch.where(atoms | ~alive[None, :], 0.0,
                         st.phi.T).contiguous()
    table = model._ndk_table(ndk, alpha, doc_sel)
    u24 = torch.randint(0, 2 ** 24, tuple(z_old.shape), generator=gen,
                        device=dev, dtype=torch.int32)
    sel = real & doc_sel[model._slot_d]
    out = {}
    for name, u in (("u24", u24), ("philox", None)):
        fn, args, kw = model._sweep_call(z_old, table, phi_vk, seed, u)
        kw = {**kw, "positive_support": False}
        zk, nkw_k, tb_k = fn(*args, **kw)
        zr, _, _ = plain_of[fn](*args, **without_order(kw))
        torch.cuda.synchronize()
        words = u if u is not None else philox_u24(seed, z_old.numel())
        n_tok, n_doc = ties_at_first_disagreement(
            torch, model, f"{label} zero-alpha ({name})", z_old, zk, zr,
            table, phi_vk, words)
        check(n_tok <= 0.001 * int(real.sum()), f"{label} zero-alpha "
              f"({name}): {n_tok} tokens differ from the plain version")
        check_sweep_outputs(torch, model, f"{label} zero-alpha ({name})",
                            z_old, zk, nkw_k, tb_k, doc_sel, alpha=alpha)
        zs = zk[sel].long()
        check(bool(alive[zs].all()), f"{label} zero-alpha ({name}): a token "
              "landed on a zero-alpha, zero-phi topic")
        check(bool((phi_vk[model._slot_w[sel], zs] > 0).all()),
              f"{label} zero-alpha ({name}): a draw landed on a zero phi")
        out[name] = (n_tok, n_doc)
    ms = time_ms(torch, lambda: fn(*args, **kw))
    summary = (f"zero-alpha operands ({k - live.numel()} of {k} topics "
               f"alpha 0 with zero phi rows, 30% zero atoms in the live "
               f"rows): z equal to the plain version on every token but "
               + ", ".join(f"{n} tokens in {m} documents ({name})"
                           for name, (n, m) in out.items())
               + ", each document's first a proven rounding tie; no token "
               f"on a dead topic or a zero phi; counts exact; {ms:.4f} ms")
    return summary, ms


def pcgs_large_k(torch, corpus, Corpus, LDAConfig, create_model, plain_of,
                 k=514, num_docs=1000):
    """The PCGS mode above kpad 256 (the shared-memory instance, which the
    main path does not reach): K=514 (kpad 640) on the first `num_docs`
    documents, with pcgs_sweep_checks. Returns a summary for the [3 pcgs]
    line."""
    sub = first_docs(Corpus, corpus, num_docs)
    model = create_model(pcgs_config(LDAConfig, "pcgs", k))
    model.add_instances(sub)
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    doc_sel = (torch.arange(sub.num_docs, device=dev) % 5) != 0
    agreement, err = pcgs_sweep_checks(torch, model, gen, seed, plain_of,
                                       f"pcgs K={k}", doc_sel)
    return (f"K={k} ({model._mode} layout) on the first {num_docs} "
            f"documents ({sub.num_tokens} tokens): z agreement "
            f"{json.dumps(agreement)}, N_kw, n_dk, flags and kept z exact, "
            f"no draw on a zero-probability topic, index document order "
            f"bit-equal to longest first, max |N_kw - plain| {err}")


def pcgs_kernel_phase(torch, corpus, Corpus, LDAConfig, create_model,
                      cuda_pcgs, _build):
    """[3 pcgs]: the sweep kernel against its plain version at the 20NG
    shapes, on the resident layout at K=100 and the streamed one at K=200,
    with operands built by the model as its main path builds them
    (pcgs_sweep_checks), a chi-square, the pre-pass bit-equal to its plain
    version and timed alone, the launch shape and the registers; the
    K=100 line adds the K=514 check. Returns one `kernels` entry per
    layout (launches filled in later)."""
    plain_of = {
        cuda_pcgs.fused_pcgs_sweep: cuda_pcgs.fused_pcgs_sweep_reference,
        cuda_pcgs.fused_pcgs_sweep_streamed:
            cuda_pcgs.fused_pcgs_sweep_streamed_reference}
    regs = ptxas_registers(_build, "pcgs_lane_kernel")
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
        doc_sel = (torch.arange(D, device=dev) % 5) != 0
        seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                            device=dev)
        agreement, err = pcgs_sweep_checks(torch, model, gen, seed, plain_of,
                                           f"pcgs K={k}", doc_sel)
        zero_alpha, zero_alpha_ms = pcgs_zero_alpha_check(
            torch, model, gen, seed, plain_of, f"pcgs K={k}", doc_sel)
        chi = ""
        if k == 100:
            chi2, pval = pcgs_chi_square(torch, cuda_pcgs, gen, seed)
            check(pval > 1e-4, f"pcgs chi-square p={pval:.2e}")
            chi = f"; chi2={chi2:.1f} (df {k - 1}, p={pval:.3g})"
        # the pre-pass against its plain version, bit for bit
        phi_vk = st.phi.T.contiguous()
        kpad = cuda_pcgs.kpad_of(k)
        check(torch.equal(cuda_pcgs.phi_bf16_table(phi_vk, kpad),
                          cuda_pcgs.phi_bf16_table_reference(phi_vk, kpad)),
              f"pcgs K={k}: the pre-pass differs from its plain version")
        table = model._ndk_table(st.ndk, st.alpha, doc_sel)
        fn, args, kw = model._sweep_call(st.z, table, phi_vk, seed)
        ms = time_ms(torch, lambda: fn(*args, **kw))
        pre_ms = time_ms(torch, lambda: cuda_pcgs.phi_bf16_table(phi_vk,
                                                                 kpad))
        plain_ms = time_ms(torch, lambda: plain_of[fn](
            *args, **without_order(kw)), reps=3, calls=1)
        warps, smem, per, docs = cuda_pcgs.launch_shape(k, collapsed=False)
        slots, n = st.z.numel(), corpus.num_tokens
        b = model._sblocks
        nbytes = (4 * 3 * slots + 4 * args[6].numel() + 4 * (D + 1)
                  + 4 * n + 4 * V * k + 8 + 2 * 4 * table.numel()
                  + 4 * b.nwin_w * model._vspan * k)
        bound_ms, bound_by = bound(nbytes, 3.0 * n * k)
        big = ""
        if k == 100:
            big = "; " + pcgs_large_k(torch, corpus, Corpus, LDAConfig,
                                      create_model, plain_of)
        print(f"[3 pcgs] K={k} {layout} layout (vspan {model._vspan}, "
              f"{slots} slots for {n} tokens, model set up in "
              f"{setup_s:.1f} s): z agreement {json.dumps(agreement)}; "
              f"N_kw, n_dk, flags and kept z exact; no draw on a "
              f"zero-probability topic; index document order bit-equal to "
              f"longest first{chi}; pre-pass bit-equal to its plain "
              f"version; launched with {warps} warps a block, {smem} B of "
              f"shared memory, {per} topics a lane, {docs} document(s) a "
              f"warp; ptxas by (pair, last nonzero) {json.dumps(regs)}; "
              f"{ms:.4f} ms (pre-pass "
              f"alone {pre_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); max |N_kw - plain| "
              f"{err}; {zero_alpha}{big}", flush=True)
        entries.append(
            {"name": fn.__name__, "mode": "pcgs", "route": "cuda",
             "source": "ldagroupedgibbssampler_tpu_torch/csrc/pcgs.cu",
             "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_pcgs.py:"
                         + ("135" if layout == "resident" else "653"),
             "launches": 0, "max_abs_err": err, "ms": ms,
             "prepass_ms": pre_ms, "zero_alpha_ms": zero_alpha_ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None})
        del model, st, table, phi_vk
        torch.cuda.empty_cache()
    return entries


def check_hdp_state(model, label: str):
    """Inactive topics have alpha exactly 0 and zero phi rows, and hold no
    token. Returns the active-topic count."""
    active = model.get_active_mask()
    check(bool((model.get_alpha()[~active] == 0).all()),
          f"{label}: an inactive topic has alpha > 0")
    check(bool((model.get_phi()[~active] == 0).all()),
          f"{label}: an inactive topic has a nonzero phi row")
    check(bool((model.get_tokens_per_topic()[~active] == 0).all()),
          f"{label}: a token sits on an inactive topic")
    return int(active.sum())


def no_token_on_zero_phi(model, corpus, phi_prev, label: str) -> int:
    """No token drawn onto a zero phi[k][w] of the sweep that drew it
    (`phi_prev`; phi is redrawn after the sweep); a type whose phi column
    is all zero keeps its z. Returns the tokens of such columns."""
    z = model.get_z_indicators()
    live = phi_prev.sum(axis=0)[corpus.tokens] > 0
    check(bool((phi_prev[z, corpus.tokens][live] > 0).all()),
          f"{label}: a token sits on a zero-probability topic")
    return int((~live).sum())


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
            kept = no_token_on_zero_phi(model, corpus, phi_prev, scheme)
            extra = (f"; phi density {model.get_phi_density():.4f}; "
                     f"{kept} tokens of all-zero phi columns kept z; no "
                     "draw on a zero phi")
        print(f"[4 {scheme} K={k}] {layout} layout: launches "
              f"{wrapper.launches}; counts exact; LL init {ll0:.1f} -> "
              f"it10 {lls[10]:.1f}; {(t1 - t0) / 10 * 1e3:.3f} "
              f"ms/iteration (host clock, LL at 10 included){extra}",
              flush=True)
        del model
        torch.cuda.empty_cache()
    return launches


def prior_spec_file(corpus, path: str, topics=10, words=5) -> np.ndarray:
    """Writes a prior spec in which each of `topics` topics anchors
    `words` of the most frequent words; returns those words' ids [topics,
    words]."""
    top = np.argsort(-corpus.type_frequencies(), kind="stable")
    ids = top[: topics * words].reshape(topics, words)
    with open(path, "w") as f:
        for k in range(topics):
            f.write(f"{k}, " + ", ".join(corpus.vocab[i] for i in ids[k])
                    + "\n")
    return ids


def new_schemes_main_path(torch, corpus, LDAConfig, create_model, cuda_pcgs,
                          smi):
    """The five schemes of the last single-device slice, each with the
    sweep's launch counts set to 0 just before it and read just after:
    [4 ppu_hdplda main path] (K_max=100, alpha 0.5, ITERS iterations, the
    likelihood every 10, with a profile), ppu_hlda at K=100 for 10
    iterations, ppu_hdplda_all_topics at K=100 for ITERS, then 10
    iterations each of spalias_priors at K=100 with a prior file of 10
    topics' anchors, and nzvsspalias at K=100 (resident) and K=200
    (streamed). Returns {wrapper: {path: launches}}."""
    res, stm = cuda_pcgs.fused_pcgs_sweep, cuda_pcgs.fused_pcgs_sweep_streamed
    launches = {res.__name__: {}, stm.__name__: {}}
    n = corpus.num_tokens

    def run(scheme, k, iters, **kw):
        res.launches = stm.launches = 0
        cfg = pcgs_config(LDAConfig, scheme, k).replace(**kw)
        t0 = time.perf_counter()
        model = create_model(cfg)
        model.add_instances(corpus)
        return model, time.perf_counter() - t0

    def read(model, scheme, k, iters):
        layout = "streamed" if k > 100 else "resident"
        check(model._mode == layout, f"{scheme} K={k}: layout "
              f"{model._mode}")
        wrapper, other = (stm, res) if layout == "streamed" else (res, stm)
        check(wrapper.launches == iters and other.launches == 0,
              f"{scheme} K={k}: sweep launches {wrapper.launches}, other "
              f"layout {other.launches}")
        launches[wrapper.__name__][f"{scheme} K={k}"] = wrapper.launches
        check_counts_exact(model, corpus, f"{scheme} K={k}")
        return layout, wrapper.launches

    # ppu_hdplda, the JAX package's 20NG HDP configuration
    model, setup_s = run("ppu_hdplda", 100, ITERS)
    ll0 = model.model_log_likelihood()
    model.sample(10)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    model.sample(ITERS - 10)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    _, nl = read(model, "ppu_hdplda", 100, ITERS)
    lls = dict(model.get_log_likelihoods())
    # the likelihood falls while topics are born (each costs about
    # log alpha_k a document, alpha_k ~ 1e-3), as in the JAX package's
    # chain (tests/test_torch_hdp.py::test_hdplda_ll_falls_while_topics_
    # are_born_as_in_the_jax_kernel_chain): finite, not rising, is the bar
    check(all(np.isfinite(lls[i]) for i in (10, 20, 30)),
          f"ppu_hdplda LL not finite: {lls}")
    hist = model.get_active_topic_history()
    check(hist[-1] >= 2, f"ppu_hdplda: no topic born and kept: {hist}")
    n_active = check_hdp_state(model, "ppu_hdplda")
    print(f"[4 ppu_hdplda main path] ppu_hdplda K_max=100 resident on "
          f"{torch.cuda.get_device_name(0)} ({smi}): launches {nl}; counts "
          f"exact; LL init {ll0:.1f} -> it10 {lls[10]:.1f} -> it20 "
          f"{lls[20]:.1f} -> it30 {lls[30]:.1f}; active topics at 10 / 20 "
          f"/ 30: {hist[9]} / {hist[19]} / {hist[29]} ({n_active} now); "
          f"inactive topics with alpha 0, zero phi rows and no token; "
          f"{n * (ITERS - 10) / (t_b - t_a):.0f} tokens/s over iterations "
          f"11-30 ({(t_b - t_a) / (ITERS - 10) * 1e3:.3f} ms/iteration, "
          f"host clock, LL at 20 and 30 included); set up in {setup_s:.1f} "
          "s", flush=True)
    print(f"[4 ppu_hdplda profile] {profile_iterations(torch, model, 5)}",
          flush=True)
    del model
    torch.cuda.empty_cache()

    prior_path = os.path.join(ROOT, "build", "chip_smoke_priors.txt")
    os.makedirs(os.path.dirname(prior_path), exist_ok=True)
    anchors = prior_spec_file(corpus, prior_path)
    for scheme, k, iters, kw in (("ppu_hlda", 100, 10, {}),
                                 ("ppu_hdplda_all_topics", 100, ITERS, {}),
                                 ("spalias_priors", 100, 10,
                                  {"topic_prior_filename": prior_path}),
                                 ("nzvsspalias", 100, 10, {}),
                                 ("nzvsspalias", 200, 10, {})):
        model, setup_s = run(scheme, k, iters, **kw)
        ll0 = model.model_log_likelihood()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(iters - 1)
        phi_prev = model.get_phi()
        model.sample(1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        layout, nl = read(model, scheme, k, iters)
        lls = dict(model.get_log_likelihoods())
        trail = " -> ".join(f"it{i} {v:.1f}" for i, v in lls.items())
        if scheme == "ppu_hlda":
            # topics are born a few a iteration and the LL falls (as for
            # ppu_hdplda); under the Poisson psi an active topic with
            # tokens can draw psi_k = 0, a true -inf
            a, nk = model.get_alpha(), model.get_tokens_per_topic()
            check(np.isfinite(lls[10]) or bool(((a == 0) & (nk > 0)).any()),
                  f"{scheme}: LL not finite without a topic of alpha 0 "
                  f"that holds tokens: {lls}")
        elif scheme == "ppu_hdplda_all_topics":
            # the first iterations spread the start topic's tokens over
            # all K_max sticks (the LL drops); then it climbs
            check(all(np.isfinite(v) for v in lls.values())
                  and lls[30] > lls[10], f"{scheme}: LL not finite or not "
                  f"rising from 10 to 30: {lls}")
        else:
            check(np.isfinite(lls[10]) and lls[10] > ll0, f"{scheme} K={k}: "
                  f"LL not finite or not rising from init: {ll0}, {lls}")
        if scheme.startswith("ppu"):
            n_active = check_hdp_state(model, scheme)
            extra = (f"; {n_active} active topics at {iters}, inactive "
                     "ones with alpha 0, zero phi rows and no token")
        elif scheme == "spalias_priors":
            mask = model.get_topic_priors()
            check(mask.shape == (k, corpus.num_types)
                  and int((mask == 0).sum()) == (k - 1) * anchors.size,
                  "spalias_priors: the prior mask is not the spec's")
            phi = model.get_phi()
            check(bool((phi[mask == 0] == 0).all()),
                  "spalias_priors: phi is not 0 where the prior is 0")
            z = model.get_z_indicators()
            check(bool((mask[z, corpus.tokens] > 0).all()),
                  "spalias_priors: a token sits on a masked (topic, word)")
            extra = (f"; {anchors.shape[0]} topics anchor "
                     f"{anchors.shape[1]} of the most frequent words each "
                     f"({int((mask == 0).sum())} masked coordinates): phi "
                     "exactly 0 on every one, no token on one")
        else:
            kept = no_token_on_zero_phi(model, corpus, phi_prev, scheme)
            extra = (f"; phi density {model.get_phi_density():.4f}; no "
                     f"draw on a zero phi; {kept} tokens of all-zero phi "
                     "columns kept z")
        print(f"[4 {scheme} K={k}] {layout} layout (vspan {model._vspan}): "
              f"launches {nl}; counts exact; LL init {ll0:.1f} -> {trail}; "
              f"{(t1 - t0) / iters * 1e3:.3f} ms/iteration over {iters} "
              f"iterations (host clock, the LL every 10 included); set up "
              f"in {setup_s:.1f} s{extra}", flush=True)
        print(f"[4 {scheme} K={k} profile] "
              f"{profile_iterations(torch, model, 5)}", flush=True)
        del model
        torch.cuda.empty_cache()
    return launches


def mh_oracle(torch, z0, nd, tw_w, qw_w):
    """A copy of tests/test_pallas_lightlda.py::_mh_oracle (inner loop
    vectorised): the exact distribution of z after one two-step MH
    transition from z0 with fixed nd (= n^{-i} + alpha), word target
    column tw_w and proposal column qw_w (float64 arrays). The doc proposal
    draws from ndq = bf16(nd) and its acceptance uses ndq for the proposal
    ratio and nd for the target, as the kernel does."""
    k = len(nd)
    ndq = torch.tensor(nd, dtype=torch.float32).to(torch.bfloat16)
    ndq = ndq.double().numpy()
    q1 = qw_w / qw_w.sum()
    qd = ndq / ndq.sum()
    a1 = np.minimum(1.0, (nd * tw_w * qw_w[z0]) / (nd[z0] * tw_w[z0] * qw_w))
    p1 = q1 * a1                         # distribution of z1
    p1[z0] += float((q1 * (1 - a1)).sum())
    p2 = np.zeros(k)
    for z1 in range(k):
        if p1[z1] == 0:
            continue
        a2 = np.minimum(1.0, (nd * tw_w * ndq[z1])
                        / (nd[z1] * tw_w[z1] * ndq))
        p2 += p1[z1] * qd * a2
        p2[z1] += p1[z1] * float((qd * (1 - a2)).sum())
    return p2


def one_token_sweep_operands(torch, cuda_lightlda, fn, alpha, tw, qw, seed,
                             n, block, chunk=128):
    """Positional operands (up to the optional u24) and keywords of an MH
    sweep through the wrapper `fn` over `n` one-token documents of one
    type, every document selected and its token on topic 0; n is a
    multiple of `block`."""
    from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import (FLAG_ROWS,
                                                                kpad_of)
    dev = seed.device
    k = alpha.numel()
    nb, chunks = n // block, block // chunk
    zero3 = torch.zeros((nb, chunks, chunk), dtype=torch.int32, device=dev)
    kpad = kpad_of(k)
    table = torch.zeros((kpad + FLAG_ROWS, n), device=dev)
    table[:k] = alpha[:, None]
    table[0] += 1.0                   # every token sits on topic 0
    table[kpad] = 1.0
    zeros = torch.zeros(nb * chunks, dtype=torch.int32, device=dev)
    if fn is cuda_lightlda.fused_lightlda_sweep:
        wins = (torch.zeros(nb, dtype=torch.int32, device=dev),
                torch.ones(nb, dtype=torch.int32, device=dev), zeros)
    else:
        wins = (zeros, zeros)
    args = (zero3, zero3, zero3, table, tw, qw, seed, *wins,
            torch.arange(n + 1, dtype=torch.int32, device=dev),
            torch.arange(n, dtype=torch.int32, device=dev))
    return args, dict(nwin_w=1, nwin_d=1, vspan=128, dspan=128,
                      num_topics=k,
                      doc_order=torch.arange(n, dtype=torch.int32,
                                             device=dev))


def without_order(kw):
    """An MH sweep wrapper's keywords for its plain version, which takes
    no document order (no draw depends on it)."""
    return {key: v for key, v in kw.items() if key != "doc_order"}


def lightlda_chi_square(torch, cuda_lightlda, fn, gen, seed, k, n=200_704,
                        block=4096):
    """Chi-square of `n` Philox draws of one-token documents of one type
    through the MH sweep wrapper `fn` against the enumerated two-step MH
    transition (mh_oracle), with a random alpha row (not bf16-exact) and
    random target and proposal columns. Returns (chi2, p-value)."""
    from scipy import stats as sps
    dev = seed.device
    alpha = torch.rand(k, generator=gen, device=dev) + 0.05
    check(bool((alpha.to(torch.bfloat16).float() != alpha).any()),
          "chi-square alpha row is bf16-exact")
    tw = (torch.rand((1, k), generator=gen, device=dev) + 0.05).contiguous()
    qw = (torch.rand((1, k), generator=gen, device=dev) + 0.05).contiguous()
    args, kw = one_token_sweep_operands(torch, cuda_lightlda, fn, alpha, tw,
                                        qw, seed, n, block)
    z, _, _ = fn(*args, **kw)
    nd = args[3][:k, 0].clone()
    nd[0] -= 1.0                      # own token out, in f32
    bf = torch.bfloat16
    p = mh_oracle(torch, 0, nd.double().cpu().numpy(),
                  tw[0].to(bf).double().cpu().numpy(),
                  qw[0].to(bf).double().cpu().numpy())
    obs = np.bincount(z.cpu().numpy().reshape(-1), minlength=k)
    exp = p * obs.sum()
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    return chi2, float(sps.chi2.sf(chi2, k - 1))


def lightlda_boundaries(torch, cuda_lightlda, fn, plain, seed, block=4096,
                        chunk=128):
    """Both MH acceptance tests at their boundaries, kernel against plain
    version (tests/test_torch_lightlda_kernel.py holds the plain version
    to the interpreted Pallas kernel on the same inputs): one-token
    documents, K=2, non-bf16-exact alpha and tables, both draws pinned to
    topic 1 and the accept uniform swept across the threshold, for step 1
    (group A) and step 2 (group B). Returns the tokens per group."""
    dev = seed.device
    alpha = torch.tensor([0.3, 0.7], device=dev)
    tw = torch.tensor([[0.4, 0.2]], device=dev)
    qw = torch.tensor([[0.3, 0.5]], device=dev)
    nd = (alpha + torch.tensor([1.0, 0.0], device=dev)
          - torch.tensor([1.0, 0.0], device=dev)).double()
    bf = torch.bfloat16
    twq, qwq = tw[0].to(bf).double(), qw[0].to(bf).double()
    ndq = nd.float().to(bf).double()
    t1 = float((nd[1] * twq[1] * qwq[0]) / (nd[0] * twq[0] * qwq[1]))
    t2 = float((nd[1] * twq[1] * ndq[0]) / (nd[0] * twq[0] * ndq[1]))
    check(t1 < 1 and t2 < 1, f"boundary thresholds {t1}, {t2}")
    groups = []
    for t in (t1, t2):
        c = int(t * 2 ** 24)
        groups.append(np.concatenate([
            np.arange(c - 16, c + 17),
            np.linspace(c * 0.995, c * 1.005, 1000).astype(np.int64)]))
    top = 2 ** 24 - 1
    a, b = groups
    words = np.concatenate([
        np.stack([np.full_like(a, top), a, np.full_like(a, top),
                  np.full_like(a, top)], 1),
        np.stack([np.full_like(b, top), np.full_like(b, top),
                  np.full_like(b, top), b], 1)])
    n = -(-len(words) // block) * block
    words = np.concatenate([words, np.full((n - len(words), 4), top)])
    nb, chunks = n // block, block // chunk
    u24 = torch.as_tensor(words.reshape(nb, chunks, chunk, 4)
                          .transpose(0, 1, 3, 2)
                          .reshape(nb, 4 * chunks, chunk)
                          .astype(np.int32), device=dev)
    args, kw = one_token_sweep_operands(torch, cuda_lightlda, fn, alpha, tw,
                                        qw, seed, n, block, chunk)
    z = fn(*args, u24, **kw)[0].reshape(-1)
    zr = plain(*args, u24, **without_order(kw))[0].reshape(-1)
    torch.cuda.synchronize()
    check(torch.equal(z, zr), f"acceptance boundaries: kernel and plain "
          f"version differ on {int((z != zr).sum())} tokens")
    for lo, hi in ((0, len(a)), (len(a), len(a) + len(b))):
        moved = int(z[lo:hi].sum())
        check(0 < moved < hi - lo, f"boundary group {lo}:{hi} is one-sided "
              f"({moved} of {hi - lo} accepted)")
    return len(a), len(b)


def lightlda_kernel_phase(torch, corpus, LDAConfig, create_model,
                          cuda_lightlda):
    """[3 lightlda]: the MH sweep kernel against its plain version at the
    20NG shapes, on the resident layout at K=100 (row 5) and the streamed
    one at K=200 (row 6), with operands built by a `lightpclda` model as
    its main path builds them and a proposal table that differs from the
    target (N_kw + beta, as `lightpcldaw2`). Returns one `kernels` entry
    per layout (launches filled in later)."""
    plain_of = {
        cuda_lightlda.fused_lightlda_sweep:
            cuda_lightlda.fused_lightlda_sweep_reference,
        cuda_lightlda.fused_lightlda_sweep_streamed:
            cuda_lightlda.fused_lightlda_sweep_streamed_reference}
    entries = []
    for k, layout in PCGS_LAYOUTS:
        t0 = time.perf_counter()
        model = create_model(pcgs_config(LDAConfig, "lightpclda", k))
        model.add_instances(corpus)
        setup_s = time.perf_counter() - t0
        check(model._mode == layout,
              f"lightlda K={k}: layout {model._mode}, expected {layout}")
        dev, st = model.device, model.state
        gen = torch.Generator(device=dev)
        gen.manual_seed(k + 1)
        real = model._slot_mask
        doc_sel = (torch.arange(D, device=dev) % 5) != 0
        table = model._ndk_table(st.ndk, st.alpha, doc_sel)
        tw = st.phi.T.contiguous()
        qw = (st.nkw.T.to(torch.float32) + st.beta).contiguous()
        seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                            device=dev)
        nb, chunks, chunk = st.z.shape
        u24 = torch.randint(0, 2 ** 24, (nb, 4 * chunks, chunk),
                            generator=gen, device=dev, dtype=torch.int32)
        agreement = {}
        for label, u in (("u24", u24), ("philox", None)):
            fn, args, kw = model._sweep_call(st.z, table, tw, seed, u,
                                             proposal_vk=qw)
            zk, nkw_k, tb_k = fn(*args, **kw)
            zr, nkw_r, _ = plain_of[fn](*args, **without_order(kw))
            torch.cuda.synchronize()
            agree = float((zk == zr)[real].float().mean())
            agreement[label] = agree
            check(agree >= 0.999, f"lightlda K={k} ({label}): only "
                  f"{agree:.6f} of tokens agree with the plain version")
            check_sweep_outputs(torch, model, f"lightlda K={k} ({label})",
                                st.z, zk, nkw_k, tb_k, doc_sel)
            if label == "philox":
                err = int((nkw_k - nkw_r).abs().max())
                # warps taking the documents in index order draw the same
                # as longest first, bit for bit
                index = torch.arange(D, dtype=torch.int32, device=dev)
                check(all(torch.equal(a, b) for a, b in zip(
                    fn(*args, **{**kw, "doc_order": index}),
                    (zk, nkw_k, tb_k))), f"lightlda K={k}: results depend "
                      "on the document order")
        # the pre-pass against its plain version: last nonzero topics
        # exact, totals and cdf rows to f32 rounding (another association)
        kpad = table.shape[0] - 8
        qw16 = qw.to(torch.bfloat16)
        cdf_k, tot_k, last_k = cuda_lightlda.word_cdf_table(qw16, kpad)
        cdf_r, tot_r, last_r = cuda_lightlda.word_cdf_table_reference(
            qw16.float(), kpad)
        torch.cuda.synchronize()
        check(torch.equal(last_k, last_r), f"lightlda K={k}: pre-pass last "
              "nonzero topics differ from the plain version")
        pre_err = float(((cdf_k - cdf_r).abs().max(dim=1).values
                         / tot_r.clamp_min(1e-30)).max())
        tot_err = float(((tot_k - tot_r).abs() / tot_r.clamp_min(1e-30))
                        .max())
        check(pre_err < 1e-5 and tot_err < 1e-5, f"lightlda K={k}: pre-pass "
              f"cdf / total relative error {pre_err:.3g} / {tot_err:.3g}")
        chi2, pval = lightlda_chi_square(torch, cuda_lightlda, fn, gen,
                                         seed, k)
        check(pval > 1e-4, f"lightlda K={k} chi-square p={pval:.2e}")
        n_a, n_b = lightlda_boundaries(torch, cuda_lightlda, fn,
                                       plain_of[fn], seed)
        fn, args, kw = model._sweep_call(st.z, table, tw, seed,
                                         proposal_vk=qw)
        ms = time_ms(torch, lambda: fn(*args, **kw))
        pre_ms = time_ms(torch, lambda: cuda_lightlda.word_cdf_table(
            qw16, kpad))
        plain_ms = time_ms(torch, lambda: plain_of[fn](
            *args, **without_order(kw)), reps=3, calls=1)
        warps, smem = cuda_lightlda.launch_shape(k)
        slots, n = st.z.numel(), corpus.num_tokens
        b = model._sblocks
        # w, z_old and z per slot, the slot lists, two bf16 [V, K] tables,
        # the table read and written, N_kw written
        nbytes = (4 * 3 * slots + 4 * args[7].numel() + 4 * (D + 1)
                  + 4 * n + 2 * 2 * V * k + 8 + 2 * 4 * table.numel()
                  + 4 * b.nwin_w * model._vspan * k)
        # two prefix sums and two compares over K per token
        bound_ms, bound_by = bound(nbytes, 4.0 * n * k)
        print(f"[3 lightlda] K={k} {layout} layout (vspan {model._vspan}, "
              f"{slots} slots for {n} tokens, model set up in "
              f"{setup_s:.1f} s): z agreement {json.dumps(agreement)}; "
              f"N_kw, n_dk, flags and kept z exact; index document order "
              f"bit-equal to longest first; chi2={chi2:.1f} "
              f"(df {k - 1}, p={pval:.3g}, 200,704 one-token documents, "
              f"non-bf16-exact alpha); acceptance boundaries exact on "
              f"{n_a} + {n_b} tokens; pre-pass against its plain version: "
              f"last nonzero topics exact, cdf / total relative error "
              f"{pre_err:.2g} / {tot_err:.2g}; launched with {warps} warps "
              f"a block, {smem // warps} B of shared memory a warp; "
              f"{ms:.4f} ms (pre-pass alone {pre_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"max |N_kw - plain| {err}", flush=True)
        entries.append(
            {"name": fn.__name__, "route": "cuda",
             "source": "ldagroupedgibbssampler_tpu_torch/csrc/lightlda.cu",
             "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_lightlda.py:"
                         + ("67" if layout == "resident" else "275"),
             "launches": 0, "max_abs_err": err, "ms": ms,
             "prepass_ms": pre_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        del model, st, table, tw, qw, qw16, u24, zk, zr, tb_k, nkw_k
        del cdf_k, cdf_r
        torch.cuda.empty_cache()
    return entries


def lightlda_main_path(torch, corpus, LDAConfig, create_model, cuda_lightlda,
                       smi):
    """[4 lightpclda main path]: scheme lightpclda K=100 (resident layout)
    for ITERS iterations with a profile, then lightpcldaw2 K=100,
    lightcollapsed K=100 and lightpclda K=200 (streamed layout) for 10
    iterations each, each with its launch counts set to 0 just before it
    and read just after. Returns the launches of each wrapper in its own
    run."""
    res = cuda_lightlda.fused_lightlda_sweep
    stm = cuda_lightlda.fused_lightlda_sweep_streamed
    launches = {}

    res.launches = stm.launches = 0
    model = create_model(pcgs_config(LDAConfig, "lightpclda", 100))
    model.add_instances(corpus)
    check(model._mode == "resident", f"lightpclda: layout {model._mode}")
    ll0 = model.model_log_likelihood()
    model.sample(10)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    model.sample(ITERS - 10)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    launches[res.__name__] = res.launches
    check(res.launches == ITERS and stm.launches == 0,
          f"lightpclda: sweep launches (resident, streamed) = "
          f"{(res.launches, stm.launches)}")
    check_counts_exact(model, corpus, "lightpclda")
    lls = dict(model.get_log_likelihoods())
    check(lls[30] > lls[10] > ll0, f"lightpclda LL did not rise: init "
          f"{ll0}, {lls}")
    n = corpus.num_tokens
    print(f"[4 lightpclda main path] lightpclda K=100 resident on "
          f"{torch.cuda.get_device_name(0)} ({smi}): launches "
          f"{launches[res.__name__]}; counts exact; LL init {ll0:.1f} -> "
          f"it10 {lls[10]:.1f} -> it30 {lls[30]:.1f}; "
          f"{n * (ITERS - 10) / (t_b - t_a):.0f} tokens/s over iterations "
          f"11-30 ({(t_b - t_a) / (ITERS - 10) * 1e3:.3f} ms/iteration, "
          "host clock, LL at 20 and 30 included)", flush=True)
    print(f"[4 lightpclda profile] {profile_iterations(torch, model, 5)}",
          flush=True)
    del model
    torch.cuda.empty_cache()

    for scheme, k, layout in (("lightpcldaw2", 100, "resident"),
                              ("lightcollapsed", 100, "resident"),
                              ("lightpclda", 200, "streamed")):
        res.launches = stm.launches = 0
        model = create_model(pcgs_config(LDAConfig, scheme, k))
        model.add_instances(corpus)
        check(model._mode == layout, f"{scheme} K={k}: layout "
              f"{model._mode}")
        ll0 = model.model_log_likelihood()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(10)
        t1 = time.perf_counter()
        wrapper = stm if layout == "streamed" else res
        other = res if layout == "streamed" else stm
        if layout == "streamed":
            launches[stm.__name__] = stm.launches
        check(wrapper.launches == 10 and other.launches == 0,
              f"{scheme} K={k}: sweep launches {wrapper.launches}, other "
              f"layout {other.launches}")
        check_counts_exact(model, corpus, f"{scheme} K={k}")
        lls = dict(model.get_log_likelihoods())
        check(lls[10] > ll0, f"{scheme} K={k}: LL did not rise: init "
              f"{ll0}, {lls}")
        print(f"[4 {scheme} K={k}] {layout} layout (vspan {model._vspan}): "
              f"launches {wrapper.launches}; counts exact; LL init "
              f"{ll0:.1f} -> it10 {lls[10]:.1f}; "
              f"{(t1 - t0) / 10 * 1e3:.3f} ms/iteration (host clock, LL "
              "at 10 included)", flush=True)
        del model
        torch.cuda.empty_cache()
    return launches


def collapsed_entry(torch, model, gen):
    """Sweep-entry counts for the collapsed mode that are NOT the z_old
    histogram: entry = hist(z_old) + a random offset in [0, 4), padded to
    the layout's rows, with nk_plus = V beta + n_k consistent with them.
    Returns (entry int32 [rows, K], counts f32 [V, K], nk_plus f32 [K])."""
    st, dev = model.state, model.device
    v, k = model.corpus.num_types, model.config.topics
    rows = model._sblocks.nwin_w * model._vspan
    entry = torch.zeros((rows, k), dtype=torch.int32, device=dev)
    entry[:v] = st.nkw.T + torch.randint(0, 4, (v, k), generator=gen,
                                         device=dev, dtype=torch.int32)
    beta32 = torch.tensor(st.beta, dtype=torch.float32, device=dev)
    nk_plus = beta32 * v + entry.sum(0).to(torch.float32)
    return entry, entry[:v].to(torch.float32).contiguous(), nk_plus


def check_nk_plus(torch, label, nk_plus, entry, nkw, nkp):
    """The live V beta + n_k after the sweep against the entry value plus
    the moves, recomputed in f64."""
    moves = (nkw.sum(0) - entry.sum(0)).double()
    check(torch.equal(nkp, (nk_plus.double() + moves).float()),
          f"{label}: live V beta + n_k differs from its f64 recount")


def collapsed_chi_square(torch, fn, gen, seed, k, n=200_704, block=4096,
                         chunk=128, beta=0.01):
    """(d): chi-square of `n` Philox draws of one-token documents of word
    0 (of V=2) through the collapsed sweep wrapper `fn`, parallel launch,
    against the enumerated conditional alpha_k (beta + N_0k) / (2 beta +
    n_k) rounded as the kernel rounds. Entry counts are integers of about
    4e6 per topic and word (below 2^24, so the f32 sums stay exact), z_old
    is drawn from the target, so the net flow of the live counts is about
    sqrt(n) per topic, and alpha is not uniform. Returns (chi2, p-value,
    tokens that moved)."""
    from scipy import stats as sps
    from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import (FLAG_ROWS,
                                                                kpad_of)
    dev = seed.device
    f32 = torch.float32
    alpha = torch.rand(k, generator=gen, device=dev) + 0.05
    base = torch.randint(2_000_000, 6_000_000, (2, k), generator=gen,
                         device=dev, dtype=torch.int32)
    beta32 = torch.tensor(beta, dtype=f32, device=dev)
    nkp0 = beta32 * 2 + base.sum(0).to(f32)
    p = ((base[0].to(f32) + beta32) / nkp0 * alpha).to(torch.bfloat16)
    p = p.double() / p.double().sum()
    z_old = torch.multinomial(p.float(), n, replacement=True,
                              generator=gen).to(torch.int32)
    counts = base.clone()
    counts[0] += torch.bincount(z_old, minlength=k).to(torch.int32)
    nk_plus = beta32 * 2 + counts.sum(0).to(f32)
    p = ((counts[0].to(f32) + beta32) / nk_plus * alpha).to(torch.bfloat16)
    p = p.double() / p.double().sum()
    nb, chunks = n // block, block // chunk
    zero3 = torch.zeros((nb, chunks, chunk), dtype=torch.int32, device=dev)
    kpad = kpad_of(k)
    table = torch.zeros((kpad + FLAG_ROWS, n), device=dev)
    table[:k] = alpha[:, None]
    table[z_old.long(), torch.arange(n, device=dev)] += 1.0
    table[kpad] = 1.0
    zeros = torch.zeros(nb * chunks, dtype=torch.int32, device=dev)
    wins = ((torch.zeros(nb, dtype=torch.int32, device=dev),
             torch.ones(nb, dtype=torch.int32, device=dev), zeros)
            if fn.__name__ == "fused_pcgs_sweep" else (zeros, zeros))
    z, nkw, _ = fn(zero3, zero3, z_old.view(nb, chunks, chunk), table,
                   counts.to(f32), seed, *wins,
                   torch.arange(n + 1, dtype=torch.int32, device=dev),
                   torch.arange(n, dtype=torch.int32, device=dev), None,
                   nk_plus, beta, nwin_w=1, nwin_d=1, vspan=128, dspan=128,
                   num_topics=k, positive_support=True)
    z = z.reshape(-1)
    moves = (torch.bincount(z, minlength=k)
             - torch.bincount(z_old, minlength=k)).to(torch.int32)
    check(torch.equal(nkw[0], counts[0] + moves) and not nkw[2:].any()
          and torch.equal(nkw[1], counts[1]),
          f"collapsed chi-square ({fn.__name__}): live N_kw is off")
    obs = np.bincount(z.cpu().numpy(), minlength=k)
    exp = p.cpu().numpy() * n
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    return chi2, float(sps.chi2.sf(chi2, k - 1)), int((z != z_old).sum())


def collapsed_boundary(torch, fn, plain, seed):
    """The own count at the draw's boundary (tests/test_torch_pcgs_kernel.py
    holds the plain version to the interpreted TPU kernel on the same
    case): two one-token documents of word 0 on topic 0, tiny counts
    (entry N_kw [[2, 0], [0, 3]], V beta + n_k [3, 4], beta 0.5, n_dk +
    alpha [1.7, 0.3]), so excluding the own count moves the conditional
    by tens of percents. The one-warp launch walks document 0 with u 1%
    under P(topic 0) (it stays), then document 1 with u 1% over it (it
    moves). Returns the kernel's z of the two tokens."""
    from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import FLAG_ROWS
    dev = seed.device
    i32 = torch.int32
    zero3 = torch.zeros((1, 1, 128), dtype=i32, device=dev)
    table = torch.zeros((128 + FLAG_ROWS, 128), device=dev)
    table[:2, :2] = torch.tensor([[1.7, 1.7], [0.3, 0.3]], device=dev)
    table[128, :2] = 1.0
    p = torch.tensor([0.7 * 0.75, 0.3 * 0.125]).to(torch.bfloat16).double()
    p0 = float(p[0] / p.sum())
    u24 = torch.zeros((1, 1, 128), dtype=i32, device=dev)
    u24[0, 0, 0] = int(0.99 * p0 * 2 ** 24)
    u24[0, 0, 1] = int(1.01 * p0 * 2 ** 24)
    one = torch.zeros(1, dtype=i32, device=dev)
    wins = ((one, one + 1, one) if fn.__name__ == "fused_pcgs_sweep"
            else (one, one))
    args = (zero3, zero3, zero3, table,
            torch.tensor([[2.0, 0.0], [0.0, 3.0]], device=dev), seed, *wins,
            torch.arange(3, dtype=i32, device=dev),
            torch.arange(2, dtype=i32, device=dev), u24,
            torch.tensor([3.0, 4.0], device=dev), 0.5)
    kw = dict(nwin_w=1, nwin_d=1, vspan=128, dspan=128, num_topics=2,
              positive_support=True, serial=True)
    z, nkw, _ = fn(*args, **kw)
    zr, nkw_r, _ = plain(*args, **kw)
    z = z.reshape(-1)[:2].tolist()
    check(z == zr.reshape(-1)[:2].tolist() == [0, 1]
          and torch.equal(nkw, nkw_r) and nkw[0].tolist() == [1, 1],
          f"own count at the boundary ({fn.__name__}): z {z}, plain "
          f"{zr.reshape(-1)[:2].tolist()}, expected [0, 1]")
    return z


def adlda_kernel_phase(torch, corpus, LDAConfig, create_model, cuda_pcgs):
    """[3 adlda sweep]: the collapsed mode of the sweep kernel against its
    plain version (the sequential chain) at the 20NG shapes, on the
    resident layout at K=100 (row 3) and the streamed one at K=200 (row
    4), with operands built by an `adlda` model as its main path builds
    them: (a) bookkeeping on the full corpus, (b) one selected document,
    (c) the one-warp launch on the first 200 documents, (d) a chi-square.
    Returns one `kernels` entry per layout (launches filled in later)."""
    plain_of = {
        cuda_pcgs.fused_pcgs_sweep: cuda_pcgs.fused_pcgs_sweep_reference,
        cuda_pcgs.fused_pcgs_sweep_streamed:
            cuda_pcgs.fused_pcgs_sweep_streamed_reference}
    entries = []
    for k, layout in PCGS_LAYOUTS:
        t0 = time.perf_counter()
        model = create_model(pcgs_config(LDAConfig, "adlda", k))
        model.add_instances(corpus)
        setup_s = time.perf_counter() - t0
        check(model._mode == layout,
              f"adlda K={k}: layout {model._mode}, expected {layout}")
        dev, st = model.device, model.state
        gen = torch.Generator(device=dev)
        gen.manual_seed(k + 2)
        real = model._slot_mask
        entry, counts, nk_plus = collapsed_entry(torch, model, gen)
        seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                            device=dev)
        nkp = torch.empty_like(nk_plus)
        label = f"adlda K={k}"

        def call(table, u=None, **kw):
            fn, args, ckw = model._sweep_call(st.z, table, counts, seed, u,
                                              nk_plus=nk_plus, beta=st.beta)
            return fn, args, {**ckw, **kw}

        # (a) bookkeeping on the full corpus, parallel launch
        doc_sel = (torch.arange(D, device=dev) % 5) != 0
        table = model._ndk_table(st.ndk, st.alpha, doc_sel)
        fn, args, kw = call(table, nk_out=nkp)
        zk, nkw_k, tb_k = fn(*args, **kw)
        torch.cuda.synchronize()
        check_sweep_outputs(torch, model, f"{label} (a)", st.z, zk, nkw_k,
                            tb_k, doc_sel, entry)
        check_nk_plus(torch, f"{label} (a)", nk_plus, entry, nkw_k, nkp)
        moved_a = int((zk != st.z)[real].sum())

        # (b) one selected document, injected and Philox uniforms
        lengths = np.diff(corpus.doc_offsets)
        docs = (int(np.argmax(lengths)), 0, D // 2)
        u24 = torch.randint(0, 2 ** 24, tuple(st.z.shape), generator=gen,
                            device=dev, dtype=torch.int32)
        for doc in docs:
            one = torch.arange(D, device=dev) == doc
            table1 = model._ndk_table(st.ndk, st.alpha, one)
            for u in (u24, None):
                nkp_r = torch.empty_like(nk_plus)
                fn, args, kw = call(table1, u, nk_out=nkp)
                zk, nkw_k, tb_k = fn(*args, **kw)
                zr, nkw_r, tb_r = plain_of[fn](*args, **{**kw,
                                                         "nk_out": nkp_r})
                torch.cuda.synchronize()
                src = "philox" if u is None else "u24"
                what = f"{label} (b) doc {doc} {src}"
                check(torch.equal(zk, zr) and torch.equal(nkw_k, nkw_r)
                      and torch.equal(tb_k, tb_r) and torch.equal(nkp, nkp_r),
                      f"{what}: kernel and plain version differ on "
                      f"{int((zk != zr).sum())} tokens")
                check_sweep_outputs(torch, model, what, st.z, zk, nkw_k,
                                    tb_k, one, entry)
        z_edge = collapsed_boundary(torch, fn, plain_of[fn], seed)

        # (c) the one-warp launch against the plain version on the first
        # 200 documents (the kernel walks only the listed documents)
        table = model._ndk_table(st.ndk, st.alpha, None)
        fn, args, kw = call(table, serial=True, nk_out=nkp)
        i_off = next(i for i, a in enumerate(args)
                     if a is model.doc_slot_offsets)
        sargs = list(args)
        sargs[i_off] = model.doc_slot_offsets[:201]
        zk, nkw_k, tb_k = fn(*sargs, **kw)
        torch.cuda.synchronize()
        nkp_r = torch.empty_like(nk_plus)
        t0 = time.perf_counter()
        zr, nkw_r, _ = plain_of[fn](*sargs, **{**kw, "nk_out": nkp_r})
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        in_slice = real & (model._slot_d < 200)
        n_slice = int(in_slice.sum())
        agree_c = float((zk == zr)[in_slice].float().mean())
        check(agree_c >= 0.999, f"{label} (c): one-warp launch agrees with "
              f"the plain version on only {agree_c:.6f} of tokens")
        check(torch.equal(zk[~in_slice], st.z[~in_slice]),
              f"{label} (c): a token outside the slice moved")
        live = entry + slot_hist(torch, model, zk, entry.shape[0]) \
            - slot_hist(torch, model, st.z, entry.shape[0])
        check(torch.equal(nkw_k, live), f"{label} (c): N_kw is not the "
              "entry count plus the one-warp launch's moves")
        check_nk_plus(torch, f"{label} (c)", nk_plus, entry, nkw_k, nkp)
        err = int((nkw_k - nkw_r).abs().max())

        # (d) chi-square of one-token documents
        chi2, pval, moved_d = collapsed_chi_square(torch, fn, gen, seed, k)
        check(pval > 1e-4, f"{label} chi-square p={pval:.2e}")

        # times: the parallel launch (every document selected), the
        # one-warp launch over the whole corpus
        fn, args, kw = call(table)
        ms = time_ms(torch, lambda: fn(*args, **kw))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args, **{**kw, "serial": True})
        b.record()
        b.synchronize()
        serial_ms = a.elapsed_time(b)
        slots, n = st.z.numel(), corpus.num_tokens
        vpad = entry.shape[0]
        # w, z_old and z per slot, the windows, the slot lists, the entry
        # counts read and N_kw written, nk_plus, the table read and written
        nbytes = (4 * 3 * slots + 4 * args[6].numel() + 4 * (D + 1)
                  + 4 * n + 4 * V * k + 4 * vpad * k + 4 * k + 8
                  + 2 * 4 * table.numel())
        # per token and topic: beta add, division, product, prefix sum,
        # compare
        bound_ms, bound_by = bound(nbytes, 5.0 * n * k)
        warps, smem, _, _ = cuda_pcgs.launch_shape(k, collapsed=True)
        print(f"[3 adlda sweep] K={k} {layout} layout (vspan "
              f"{model._vspan}, {slots} slots for {n} tokens, model set up "
              f"in {setup_s:.1f} s; launched with {warps} warps a block, "
              f"{smem // warps} B of shared memory a warp): (a) full "
              f"corpus, every 5th document "
              f"unselected, entry N_kw = hist + offset: N_kw = entry + "
              f"moves, n_dk, flags, kept z and V beta + n_k exact "
              f"({moved_a} tokens moved); (b) one selected document "
              f"({', '.join(map(str, docs))}; lengths "
              f"{', '.join(str(lengths[d]) for d in docs)}): kernel equal "
              f"to the plain version on every token, u24 and Philox; own "
              f"count at the draw's boundary: z {z_edge} as computed; (c) "
              f"one-warp launch on the first 200 documents ({n_slice} "
              f"tokens): z agreement {agree_c:.6f}, N_kw and V beta + n_k "
              f"exact, max |N_kw - plain| {err}; (d) chi2={chi2:.1f} (df "
              f"{k - 1}, p={pval:.3g}, 200,704 one-token documents, "
              f"{moved_d} moved); kernel {ms:.4f} ms, one-warp launch "
              f"{serial_ms:.1f} ms, plain version on the first 200 "
              f"documents {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        entries.append(
            {"name": fn.__name__, "mode": "collapsed", "route": "cuda",
             "source": "ldagroupedgibbssampler_tpu_torch/csrc/pcgs.cu",
             "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_pcgs.py:"
                         + ("215" if layout == "resident" else "825"),
             "launches": 0, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms,
             "plain_scope": f"first 200 documents ({n_slice} tokens)",
             "serial_ms": serial_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None})
        del model, st, table, table1, entry, counts, u24, zk, zr, tb_k
        torch.cuda.empty_cache()
    return entries


def adlda_main_path(torch, corpus, LDAConfig, create_model, cuda_pcgs, smi):
    """[4 adlda main path]: scheme adlda K=100 (resident layout) for ITERS
    iterations with a profile, then adlda K=200 (streamed layout) for 10,
    each with every launch count of the sweep wrappers set to 0 just
    before it and read just after. Returns the collapsed launches of each
    wrapper in its own run."""
    res, stm = cuda_pcgs.fused_pcgs_sweep, cuda_pcgs.fused_pcgs_sweep_streamed
    launches = {}
    n = corpus.num_tokens
    for k, layout, iters in ((100, "resident", ITERS),
                             (200, "streamed", 10)):
        for fn in (res, stm):
            fn.launches = fn.collapsed_launches = 0
        model = create_model(pcgs_config(LDAConfig, "adlda", k))
        model.add_instances(corpus)
        check(model._mode == layout, f"adlda K={k}: layout {model._mode}")
        ll0 = model.model_log_likelihood()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(10)
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        if iters > 10:
            model.sample(iters - 10)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        wrapper = stm if layout == "streamed" else res
        other = res if layout == "streamed" else stm
        launches[wrapper.__name__] = wrapper.collapsed_launches
        check(wrapper.collapsed_launches == iters
              and other.collapsed_launches == 0
              and res.launches == stm.launches == 0,
              f"adlda K={k}: collapsed launches (resident, streamed) = "
              f"{(res.collapsed_launches, stm.collapsed_launches)}, PCGS "
              f"mode {(res.launches, stm.launches)}")
        check_counts_exact(model, corpus, f"adlda K={k}")
        lls = dict(model.get_log_likelihoods())
        rising = ll0 < lls[10] and (iters == 10 or lls[10] < lls[iters])
        check(rising, f"adlda K={k}: LL did not rise: init {ll0}, {lls}")
        if iters > 10:
            print(f"[4 adlda main path] adlda K={k} {layout} on "
                  f"{torch.cuda.get_device_name(0)} ({smi}): collapsed "
                  f"launches {wrapper.collapsed_launches}; counts exact; LL "
                  f"init {ll0:.1f} -> it10 {lls[10]:.1f} -> it30 "
                  f"{lls[30]:.1f}; {n * (iters - 10) / (t_b - t_a):.0f} "
                  f"tokens/s over iterations 11-30 "
                  f"({(t_b - t_a) / (iters - 10) * 1e3:.3f} ms/iteration, "
                  "host clock, LL at 20 and 30 included)", flush=True)
            print(f"[4 adlda profile] {profile_iterations(torch, model, 5)}",
                  flush=True)
        else:
            print(f"[4 adlda K={k}] {layout} layout (vspan {model._vspan}):"
                  f" collapsed launches {wrapper.collapsed_launches}; counts "
                  f"exact; LL init {ll0:.1f} -> it10 {lls[10]:.1f}; "
                  f"{(t_a - t0) / 10 * 1e3:.3f} ms/iteration (host clock, "
                  "LL at 10 included)", flush=True)
        del model
        torch.cuda.empty_cache()
    return launches


def aliasmh_main_path(torch, corpus, LDAConfig, create_model, cuda_counts,
                      cuda_zdraw, smi):
    """[4 ggs_aliasmh main path]: scheme ggs_aliasmh K=100 for ITERS
    iterations with a profile, the launch counts set to 0 just before it
    and read just after: the count kernel twice an iteration (N_kw on
    layout A, n_dk on layout B) and twice at set-up, the z-draw never.
    Then [4 ggs_aliasmh K=4096]: ggs_aliasmh and dense ggs at K=4096 in
    one call, 10 iterations each, the card's first crossover reading,
    each with a profile of 3 more.
    Returns the count kernel's launches in the K=100 run."""
    n = corpus.num_tokens
    counts = cuda_counts.blocked_label_counts
    zdraw = cuda_zdraw.fused_zdraw_nkw
    counts.launches = zdraw.launches = 0
    cfg = pcgs_config(LDAConfig, "ggs_aliasmh", K)
    model = create_model(cfg)
    model.add_instances(corpus)
    check(model._mh_packed(), "ggs_aliasmh K=100: tables not packed")
    ll0 = model.model_log_likelihood()
    model.sample(10)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    model.sample(ITERS - 10)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    launches = counts.launches
    check(launches == 2 * ITERS + 2 and zdraw.launches == 0,
          f"ggs_aliasmh: count kernel launched {launches} times (expected "
          f"{2 * ITERS + 2}), z-draw {zdraw.launches}")
    check_counts_exact(model, corpus, "ggs_aliasmh")
    lls = dict(model.get_log_likelihoods())
    check(lls[30] > lls[10] > ll0, f"ggs_aliasmh: LL did not rise: init "
          f"{ll0}, {lls}")
    print(f"[4 ggs_aliasmh main path] ggs_aliasmh K={K} on "
          f"{torch.cuda.get_device_name(0)} ({smi}): count kernel launches "
          f"{launches} (2 an iteration + 2 at set-up), z-draw 0; counts "
          f"exact; LL init {ll0:.1f} -> it10 {lls[10]:.1f} -> it30 "
          f"{lls[30]:.1f}; {n * (ITERS - 10) / (t_b - t_a):.0f} tokens/s "
          f"over iterations 11-30 ({(t_b - t_a) / (ITERS - 10) * 1e3:.3f} "
          "ms/iteration, host clock, LL at 20 and 30 included)", flush=True)
    print(f"[4 ggs_aliasmh profile] {profile_iterations(torch, model, 5)}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    k_big, res = 4096, {}
    for scheme in ("ggs_aliasmh", "ggs"):
        cfg = LDAConfig(scheme=scheme, topics=k_big, alpha=0.5, beta=0.01,
                        seed=2019, exec_time=-1, topic_interval=5,
                        device="cuda")
        model = create_model(cfg)
        model.add_instances(corpus)
        ll0 = model.model_log_likelihood()
        model.sample(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(8)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 8 * 1e3
        check_counts_exact(model, corpus, f"{scheme} K={k_big}")
        lls = dict(model.get_log_likelihoods())
        check(lls[10] > lls[5] > ll0, f"{scheme} K={k_big}: LL did not rise:"
              f" init {ll0}, {lls}")
        res[scheme] = (ms, ll0, lls)
        print(f"[4 ggs_aliasmh K={k_big} profile] {scheme}: "
              f"{profile_iterations(torch, model, 3)}", flush=True)
        del model
        torch.cuda.empty_cache()
    mh, dense = res["ggs_aliasmh"], res["ggs"]
    print(f"[4 ggs_aliasmh K={k_big}] counts exact and LL rising in both; "
          f"ggs_aliasmh {mh[0]:.3f} ms/iteration (LL init {mh[1]:.1f} -> it5 "
          f"{mh[2][5]:.1f} -> it10 {mh[2][10]:.1f}), dense ggs {dense[0]:.3f} "
          f"ms/iteration (LL init {dense[1]:.1f} -> it5 {dense[2][5]:.1f} -> "
          f"it10 {dense[2][10]:.1f}), dense / alias-MH time "
          f"{dense[0] / mh[0]:.3f} (host clock over iterations 3-10, LL at "
          "5 and 10 included)", flush=True)
    return launches


def first_docs(Corpus, corpus, num_docs):
    """The corpus cut to its first `num_docs` documents (same vocabulary)."""
    end = int(corpus.doc_offsets[num_docs])
    return Corpus(tokens=corpus.tokens[:end],
                  doc_offsets=corpus.doc_offsets[:num_docs + 1],
                  vocab=corpus.vocab)


def adlda_oracle(torch, corpus, Corpus, LDAConfig, create_model,
                 num_docs=2000):
    """[4 adlda oracle]: the staleness contract at a real width. On the
    first 2,000 documents at K=100, `adlda` for ITERS iterations with the
    parallel launch, then from the same seed with the one-warp launch (the
    sequential collapsed chain); their LL at iteration ITERS must agree
    within 0.5%. Beside it, for the spread: two more parallel chains from
    the same seed (the atomics' order differs from run to run) and
    one-warp chains from two more seeds; it prints the mean and range of
    the three parallel chains' gaps beside the range of the three one-warp
    chains' LLs at iteration ITERS. Returns the relative gap."""
    import dataclasses
    sub = first_docs(Corpus, corpus, num_docs)
    runs = []
    for serial, seed in ((False, 2019), (True, 2019), (True, 2020),
                         (False, 2019), (False, 2019), (True, 2021)):
        cfg = pcgs_config(LDAConfig, "adlda", 100)
        model = create_model(dataclasses.replace(cfg, seed=seed))
        model._serial_sweep = serial
        model.add_instances(sub)
        ll0 = model.model_log_likelihood()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check_counts_exact(model, sub, f"adlda oracle serial={serial}")
        runs.append(([ll0] + [ll for _, ll in model.get_log_likelihoods()],
                     secs / ITERS * 1e3))
        del model
    (par, par_ms), (ser, ser_ms), (other, _) = runs[:3]

    def rel(lls):
        return (lls[-1] - ser[-1]) / abs(ser[-1])
    gap = rel(par)
    check(abs(gap) < 0.005, f"adlda oracle: LL gap {gap:.5f} at iteration "
          f"{ITERS} (parallel {par}, one warp {ser})")
    gaps = [rel(r[0]) for r in (runs[0], runs[3], runs[4])]
    ser_ll = [r[0][-1] for r in (runs[1], runs[2], runs[5])]
    ser_range = (max(ser_ll) - min(ser_ll)) / abs(ser[-1])

    def traj(lls):
        return json.dumps([round(x, 1) for x in lls])
    print(f"[4 adlda oracle] first {num_docs} documents ({sub.num_tokens} "
          f"tokens), K=100, seed 2019: LL init/10/20/30 parallel launch "
          f"{traj(par)} ({par_ms:.1f} ms/iteration), one-warp launch "
          f"{traj(ser)} ({ser_ms:.1f} ms/iteration); relative gap at "
          f"{ITERS} {gap:+.6f}; two more parallel chains "
          f"{', '.join(f'{g:+.6f}' for g in gaps[1:])}; one-warp "
          f"launch from seed 2020 {traj(other)}, {rel(other):+.6f}; "
          f"parallel gaps at {ITERS}: mean {np.mean(gaps):+.6f}, range "
          f"[{min(gaps):+.6f}, {max(gaps):+.6f}]; one-warp LLs at {ITERS} "
          f"(seeds 2019, 2020, 2021) {traj(ser_ll)}, range "
          f"{ser_range:.6f} of |LL|", flush=True)
    return gap


def collapsed_phase(torch, corpus, Corpus, LDAConfig, create_model,
                    counters, num_docs=100):
    """[4 collapsed]: scheme `collapsed` (the serial oracle, a per-token
    host loop) on the first 100 documents for 2 iterations on the card;
    no kernel launch counter may move."""
    sub = first_docs(Corpus, corpus, num_docs)
    before = [(fn.__name__, attr, getattr(fn, attr))
              for fn, attr in counters]
    model = create_model(pcgs_config(LDAConfig, "collapsed", 100))
    model.add_instances(sub)
    ll0 = model.model_log_likelihood()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.sample(2)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 2
    check_counts_exact(model, sub, "collapsed")
    after = [(fn.__name__, attr, getattr(fn, attr))
             for fn, attr in counters]
    check(before == after, f"collapsed moved a launch counter: {before} -> "
          f"{after}")
    ll = model.model_log_likelihood()
    print(f"[4 collapsed] first {num_docs} documents ({sub.num_tokens} "
          f"tokens), "
          f"K=100 on {model.device}: {secs:.2f} s/iteration (a per-token "
          f"host loop); LL init {ll0:.1f} -> it2 {ll:.1f}; counts exact; "
          f"no kernel launched", flush=True)
    del model



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
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import (
        Corpus, real_slot_list)
    from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
    from ldagroupedgibbssampler_tpu_torch.ops import (cuda_counts,
                                                      cuda_lightlda,
                                                      cuda_pcgs, cuda_zdraw)
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    z = torch.randint(0, K, (nb, block), generator=gen, device=dev,
                      dtype=torch.int32)
    z = torch.where(mask, z, 0)
    print(f"[3 layout] N={n_tok} tokens, {nb} blocks x {block} = {slots} "
          f"slots, layout B {blocks.d_local.shape[0]} blocks, built in "
          f"{build_blocks_s:.1f} s", flush=True)

    kc = dict(nwin=blocks.nwin_w, vspan=vspan, num_labels=K)
    counts_entry = counts_phase(torch, blocks, n_tok, cuda_counts, _build)

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
    real_slots = t(real_slot_list(blocks.mask))
    pad = (w3 == vspan)
    doc_of_slot = torch.as_tensor(blocks.doc_ids.reshape(shape3),
                                  device=dev)
    unsel = (~pad) & (doc_of_slot % 5 == 0)
    agreement = {}
    for label, u, precise in (("u24 bf16", u24, False),
                              ("u24 precise", u24, True),
                              ("philox bf16", None, False)):
        zk, nk_k = cuda_zdraw.fused_zdraw_nkw(*zargs, u, precise=precise,
                                              real_slots=real_slots, **zkw)
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
                                       winb, firstb, windc,
                                       real_slots=real_slots, **zkw)
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
        nwin_w=1, nwin_d=1, vspan=vspan, dspan=dspan, num_topics=K,
        real_slots=torch.arange(zero3.numel(), dtype=torch.int32,
                                device=dev))
    p = (th1 * ph1).double().cpu().numpy()[0]
    p /= p.sum()
    obs = np.bincount(zk1.cpu().numpy().reshape(-1), minlength=K)
    exp = p * obs.sum()
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    pval = float(sps.chi2.sf(chi2, K - 1))
    check(pval > 1e-4, f"z-draw chi-square p={pval:.2e}")

    zdraw_ms = time_ms(torch, lambda: cuda_zdraw.fused_zdraw_nkw(
        *zargs, real_slots=real_slots, **zkw))
    zdraw_precise_ms = time_ms(torch, lambda: cuda_zdraw.fused_zdraw_nkw(
        *zargs, precise=True, real_slots=real_slots, **zkw))
    thr, smem, step = cuda_zdraw.launch_shape(theta_m, phi)
    zshape = (f"one real slot a thread, {thr} threads and {smem} B of "
              f"shared memory a block, {step} topics a row load")
    big = zdraw_large_k(torch, corpus, Corpus, cfg, cuda_zdraw, cuda_counts,
                        gen)
    zdraw_plain_ms = time_ms(torch, lambda: cuda_zdraw.
                             fused_zdraw_nkw_reference(*zargs, **zkw),
                             reps=5, calls=2)
    zdraw_bytes = (4 * 4 * slots + 4 * (D + V) * K + 8 + 4 * 2 * nb
                   + 4 * nb * chunks + 4 * blocks.nwin_w * vspan * K)
    zdraw_ops = 3.0 * n_tok * K         # product, prefix sum, compare
    zdraw_bound, zdraw_by = bound(zdraw_bytes, zdraw_ops)
    print(f"[3 zdraw] z agreement {json.dumps(agreement)}; planted topics "
          f"exact; chi2={chi2:.1f} (df {K - 1}, p={pval:.3g}); launch: "
          f"{zshape}; {zdraw_ms:.4f} ms (precise mode {zdraw_precise_ms:.4f} "
          f"ms), plain {zdraw_plain_ms:.4f} ms, bound {zdraw_bound:.4f} ms "
          f"({zdraw_by}); max |N_kw - plain| {zdraw_err}; {big}",
          flush=True)
    del theta, phi, theta_m, onehot, u24, z
    torch.cuda.empty_cache()
    pcgs_entries = pcgs_kernel_phase(torch, corpus, Corpus, LDAConfig,
                                     create_model, cuda_pcgs, _build)
    lightlda_entries = lightlda_kernel_phase(torch, corpus, LDAConfig,
                                             create_model, cuda_lightlda)
    adlda_entries = adlda_kernel_phase(torch, corpus, LDAConfig,
                                       create_model, cuda_pcgs)

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
    new_launches = new_schemes_main_path(torch, corpus, LDAConfig,
                                         create_model, cuda_pcgs, smi)
    for entry in pcgs_entries:
        entry["launches"] = pcgs_launches[entry["name"]]
        entry["launches_new_schemes"] = new_launches[entry["name"]]
    lightlda_launches = lightlda_main_path(torch, corpus, LDAConfig,
                                           create_model, cuda_lightlda, smi)
    for entry in lightlda_entries:
        entry["launches"] = lightlda_launches[entry["name"]]
    adlda_launches = adlda_main_path(torch, corpus, LDAConfig, create_model,
                                     cuda_pcgs, smi)
    for entry in adlda_entries:
        entry["launches"] = adlda_launches[entry["name"]]
    adlda_oracle(torch, corpus, Corpus, LDAConfig, create_model)
    aliasmh_launches = aliasmh_main_path(torch, corpus, LDAConfig,
                                         create_model, cuda_counts,
                                         cuda_zdraw, smi)
    # every launch counter of the port's wrappers
    counters = [(fn, "launches") for fn in (
        cuda_counts.blocked_label_counts, cuda_zdraw.fused_zdraw_nkw,
        cuda_lightlda.fused_lightlda_sweep,
        cuda_lightlda.fused_lightlda_sweep_streamed)]
    counters += [(fn, attr) for fn in (cuda_pcgs.fused_pcgs_sweep,
                                       cuda_pcgs.fused_pcgs_sweep_streamed)
                 for attr in ("launches", "collapsed_launches")]
    collapsed_phase(torch, corpus, Corpus, LDAConfig, create_model, counters)

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
    with open(os.path.join(work, "priors.txt"), "w") as f:
        f.write("".join(f"{k}, {', '.join(t[:2])}\n"
                        for k, t in enumerate(themes)))
    with open(os.path.join(work, "run.cfg"), "w") as f:
        f.write(f"configs = ggs, pcgs, lightpclda, adlda, ggs_aliasmh, "
                f"spalias_priors, ppu_hdplda\n"
                f"no_runs = 1\n"
                f"experiment_out_dir = {work}/runs\nexec_time = 300\n"
                f"iterations = {ITERS}\ntopics = 3\nalpha = 1\n"
                f"beta = 0.01\ndataset = {work}/docs.txt\n"
                f"rare_threshold = 0\nseed = 2019\ntopic_interval = 10\n"
                f"start_diagnostic = 1\nstoplist =\ndevice = cuda\n\n"
                f"[ggs]\nscheme = ggs\n\n"
                f"[pcgs]\nscheme = pcgs\nsave_phi = true\n\n"
                f"[lightpclda]\nscheme = lightpclda\n\n"
                f"[adlda]\nscheme = adlda\n\n"
                f"[ggs_aliasmh]\nscheme = ggs_aliasmh\n\n"
                f"[spalias_priors]\nscheme = spalias_priors\n"
                f"topic_prior_filename = {work}/priors.txt\n\n"
                f"[ppu_hdplda]\nscheme = ppu_hdplda\ntopics = 6\n")
    for fn, attr in counters:
        setattr(fn, attr, 0)
    parallel_lda.main([f"--run_cfg={work}/run.cfg"])
    cli_launches = (cuda_zdraw.fused_zdraw_nkw.launches,
                    cuda_counts.blocked_label_counts.launches,
                    cuda_pcgs.fused_pcgs_sweep.launches,
                    cuda_lightlda.fused_lightlda_sweep.launches,
                    cuda_pcgs.fused_pcgs_sweep.collapsed_launches)
    # counts: ggs once an iteration, ggs_aliasmh twice; the PCGS mode:
    # pcgs, spalias_priors and ppu_hdplda
    check(cli_launches[0] == ITERS and cli_launches[1] >= 3 * ITERS
          and cli_launches[2] == 3 * ITERS and cli_launches[3] == ITERS
          and cli_launches[4] == ITERS,
          f"CLI run launches (zdraw, counts, pcgs, lightlda, collapsed) = "
          f"{cli_launches}")
    ll_cli = {}
    for name, files in (("ggs", ()), ("pcgs", ("phi.csv",)),
                        ("lightpclda", ()), ("adlda", ()),
                        ("ggs_aliasmh", ()), ("spalias_priors", ()),
                        ("ppu_hdplda", ())):
        run_dir = glob.glob(os.path.join(work, "runs", "RunSuite*",
                                         f"Run{name}-*"))
        check(len(run_dir) == 1, f"CLI run directories: {run_dir}")
        for fn in ("likelihood.txt", "TopWords.txt", "run_metadata.json",
                   *files):
            check(os.path.exists(os.path.join(run_dir[0], fn)),
                  f"CLI {name}: no {fn}")
        lls = [float(ln.split("\t")[1]) for ln in
               open(os.path.join(run_dir[0], "likelihood.txt"))]
        # the collapsed chain reaches its plateau by iteration 10 on this
        # small corpus, so adlda may only not fall; the HDP chain's
        # topics are born and die, so its series need only be finite
        rose = (lls[-1] > lls[0] - 1e-3 * abs(lls[0]) if name == "adlda"
                else bool(np.isfinite(lls).all()) if name == "ppu_hdplda"
                else lls[-1] > lls[0])
        check(len(lls) == 3 and rose, f"CLI {name} LL did not rise: {lls}")
        ll_cli[name] = lls
    print(f"[5 cli] parallel_lda on cuda, sections ggs, pcgs, lightpclda, "
          f"adlda, ggs_aliasmh, spalias_priors (with its prior file) and "
          f"ppu_hdplda: launches (zdraw, counts, pcgs, lightlda, collapsed) "
          f"{cli_launches}; LL {json.dumps(ll_cli)}", flush=True)

    kernels = [
        {**counts_entry, "launches": aliasmh_launches,
         "launches_ggs": launches["blocked_label_counts"]},
        {"name": "fused_zdraw_nkw", "route": "cuda",
         "source": "ldagroupedgibbssampler_tpu_torch/csrc/zdraw.cu",
         "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_zdraw.py:59",
         "launches": launches["fused_zdraw_nkw"], "max_abs_err": zdraw_err,
         "ms": zdraw_ms, "precise_ms": zdraw_precise_ms,
         "plain_ms": zdraw_plain_ms, "bound_ms": zdraw_bound,
         "bound_by": zdraw_by, "library_ms": None},
        *pcgs_entries,
        *lightlda_entries,
        *adlda_entries,
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
