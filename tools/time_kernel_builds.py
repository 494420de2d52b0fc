#!/usr/bin/env python3
"""Time builds of one kernel of the port against each other on one CUDA
card, in turns.

Run from the repository root on a machine with one card and nvcc:

    python3 tools/time_kernel_builds.py \
        --kernel pcgs|lightlda|zdraw|counts|gamma|left_to_right|alias_mh|
                 hdp|polya_urn|vs_dirichlet|pairwise \
        NAME=PATH [NAME=PATH ...] [--root DIR] [--cases CASE,...] \
        [--rounds 2] [--json out.json]

Each PATH is either
  - a source of the kernel (`csrc/pcgs.cu`, `csrc/lightlda.cu`,
    `csrc/zdraw.cu`, `csrc/label_counts.cu`, `csrc/gamma.cu`,
    `csrc/left_to_right.cu`, `csrc/alias_mh.cu`, `csrc/hdp.cu`,
    `csrc/polya_urn.cu`, `csrc/vs_dirichlet.cu`, `csrc/pairwise.cu`, or a
    copy of one beside
    the headers it includes), timed under the wrappers of the
    checkout `--root` (default: this one), so it must keep that
    checkout's C interface; or
  - a directory holding a checkout of the repository (the parent commit
    unpacked there with `git archive`, say), timed with that checkout's own
    wrappers and its own source of the kernel, so builds whose C
    interfaces differ compare too.

Every NAME gets a worker process of its own (this script with --worker).
It compiles its source alone, with the nvcc flags of `ops/_build.py`, into
a library of its own, puts that library under its checkout's wrappers
(the checkout's other kernels, which the models' set-up launches, come
from the checkout's own build), and builds the operands of the kernel's
timings in that checkout's `chip_smoke.py`: the synthetic 20NG corpus,
and
  - pcgs: the collapsed mode (`[3 adlda sweep]`) and the PCGS mode
    (`[3 pcgs]`), each at K=100 on the resident layout and K=200 on the
    streamed one, with the keywords the model's `_sweep_call` gives (in
    the PCGS mode its longest-first `doc_order`, where the checkout has
    one);
  - lightlda: `[3 lightlda]`, K=100 resident and K=200 streamed;
  - zdraw: `[3 zdraw]` at K=100 in bf16 and in precise mode;
  - counts: `[3 counts]`, layouts A and B at K=100 with uniform and
    concentrated z and layout A at K=4096 (`chip_smoke.py::count_cases` of
    this checkout, whichever checkout the wrappers come from);
  - gamma: `[3 gamma]`'s Dirichlet draws of the `ggs` iteration at K=100
    and K=4096, theta [D, K] over the last axis and phi [V, K] over axis
    0, and the PCGS family's long rows at K=100, phi [K, V] over the last
    axis;
  - left_to_right: `[3 left-to-right]`, the 10% split at K=100 and
    K=4096, 100 particles (`chip_smoke.py::l2r_operands` of this
    checkout);
  - alias_mh: `[3 alias-mh]`'s operands (`chip_smoke.py::alias_mh_case`
    of this checkout) at K=100 and K=4096 in both table modes, 2 rounds:
    the z-step as the main path runs it (`alias_mh`: the pre-pass and the
    rounds) with every document selected and with half of them; the
    pre-pass alone and the rounds kernel alone, at K=100 packed also at 1
    and 4 rounds and with no document selected (what a token costs
    without its draws and gathers); the pack at both K;
  - hdp: `[3 hdp]`'s operands (`chip_smoke.py::hdp_state` and
    `psi_operands` of this checkout): the table counts of a ppu_hdplda
    K_max=100 chain after 10 iterations in both instances, psi on its
    tables, and psi at K_max=4096 (GEM with the hdplda births, Poisson
    with the hlda ones); the whole step after that chain's sweep
    (`_kernel_after_sweep`: its seeds, the table counts, psi and the
    Polya-Urn rows, by CUDA events); and a single-stepped iteration of
    ppu_hdplda K_max=100 after 2;
  - polya_urn: `[3 polya-urn]`'s rows, that chain's N_kw [100, V] with
    and without its active mask and a uniform z's [200, V], the
    elementwise Poisson at its rates, and a single-stepped iteration of
    polyaurn K=100 after 2;
  - vs_dirichlet: `[3 vs-dirichlet]`'s rows at [100, V] and [200, V],
    the previous phi a Polya-Urn draw, and a single-stepped nzvsspalias
    iteration at K=100 and K=200 (ms by CUDA events, the host's gaps
    between launches included);
  - pairwise: `[3 pairwise]`'s kernels' wrappers (`chip_smoke.py::
    pairwise_rows` and `pairwise_kernel_fns` of this checkout: ks with its
    rows' sort, uber on its products computed beforehand), each of
    the seven metrics at the 20NG test x train shape (5,635 x 5,634 x 100)
    and on its first 256 rows, and at 512 x 512 x 4096; jaccard also at
    the first shape with a negative value in every 64th row ("jaccard a
    general": every block off its tame path).
The workers start together, so builds and set-up run in parallel; then
each case is timed with `chip_smoke.time_ms`, one worker at a time, the
names first to last and back, `--rounds` times, so each has as many early
turns as late ones. An iteration case (its name starts with "iteration")
is timed by CUDA events with the host's gaps between launches included,
and also profiled over 5 calls (`chip_smoke.profile_numbers`): its host
wall and device busy ms a call. Nothing is checked but that every call
succeeds: a source whose results differ from the committed kernel's may
be timed as well. A worker that fails to build, fails a call, or takes longer than
`--call-timeout` seconds is stopped and left out of the rest. Prints one
line per case with each name's median and its samples, the card's name and
power limit, and writes every sample to the --json file.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCES = {"pcgs": "pcgs.cu", "lightlda": "lightlda.cu",
                  "zdraw": "zdraw.cu", "counts": "label_counts.cu",
                  "gamma": "gamma.cu", "left_to_right": "left_to_right.cu",
                  "alias_mh": "alias_mh.cu", "hdp": "hdp.cu",
                  "polya_urn": "polya_urn.cu",
                  "vs_dirichlet": "vs_dirichlet.cu",
                  "pairwise": "pairwise.cu"}
TAG = "@@ "                       # prefix of the worker's protocol lines


# ---------------------------------------------------------------- worker
def build_source(src: str, out_dir: str) -> tuple[ctypes.CDLL, list[str]]:
    """nvcc `src` alone into a library under out_dir; returns it loaded,
    with ptxas's register lines."""
    from ldagroupedgibbssampler_tpu_torch.ops import _build
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "lib.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           os.path.dirname(os.path.abspath(src)), "-o", lib_path, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log[-4000:]}")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return lib, regs


class Overlay:
    """The entry points of the timed source's library, and the checkout's
    other kernels (the models' set-up launches them) from its own, built
    when one is first asked for."""

    def __init__(self, lib, full):
        self._lib, self._full = lib, full

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return getattr(self._full(), name)


def pcgs_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 adlda sweep]'s and [3 pcgs]'s timed calls (old and new checkouts
    share the model API they use)."""
    cases = {}
    dev = torch.device("cuda", 0)
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    for mode, scheme in (("collapsed", "adlda"), ("pcgs", "pcgs")):
        for k, layout in cs.PCGS_LAYOUTS:
            model = create_model(cs.pcgs_config(LDAConfig, scheme, k))
            model.add_instances(corpus)
            st = model.state
            if scheme == "adlda":
                gen = torch.Generator(device=dev)
                gen.manual_seed(k + 2)
                _, counts, nk_plus = cs.collapsed_entry(torch, model, gen)
                table = model._ndk_table(st.ndk, st.alpha, None)
                call = model._sweep_call(st.z, table, counts, seed, None,
                                         nk_plus=nk_plus, beta=st.beta)
            else:
                doc_sel = (torch.arange(cs.D, device=dev) % 5) != 0
                table = model._ndk_table(st.ndk, st.alpha, doc_sel)
                call = model._sweep_call(st.z, table, st.phi.T.contiguous(),
                                         seed, None)
            cases[f"{mode} K={k} {layout}"] = call
    return cases


def lightlda_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 lightlda]'s timed calls: lightpclda's operands with a proposal
    table unlike the target, every 5th document unselected."""
    cases = {}
    dev = torch.device("cuda", 0)
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    for k, layout in cs.PCGS_LAYOUTS:
        model = create_model(cs.pcgs_config(LDAConfig, "lightpclda", k))
        model.add_instances(corpus)
        st = model.state
        doc_sel = (torch.arange(cs.D, device=dev) % 5) != 0
        table = model._ndk_table(st.ndk, st.alpha, doc_sel)
        tw = st.phi.T.contiguous()
        qw = (st.nkw.T.to(torch.float32) + st.beta).contiguous()
        cases[f"K={k} {layout}"] = model._sweep_call(st.z, table, tw, seed,
                                                     proposal_vk=qw)
    return cases


def zdraw_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 zdraw]'s timed call at K=100 in both precision modes: a ggs
    model's layout-A operands, realistic theta and phi tables, every 5th
    document's theta row zeroed."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_zdraw
    from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
    dev = torch.device("cuda", 0)
    k = cs.K
    cfg = LDAConfig(scheme="ggs", topics=k, alpha=0.5, beta=0.01, seed=2019,
                    exec_time=-1, topic_interval=10, device="cuda")
    model = create_model(cfg)
    model.add_instances(corpus)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    theta = rnd.dirichlet(torch.rand((cs.D, k), generator=gen, device=dev)
                          * 20 + 0.5, gen)
    phi = rnd.gamma(torch.rand((cs.V, k), generator=gen, device=dev) * 5
                    + 0.01, gen).clamp_min(rnd.DIRICHLET_FLOOR)
    phi = (phi / phi.sum(dim=0, keepdim=True)).contiguous()
    doc_sel = (torch.arange(cs.D, device=dev) % 5) != 0
    theta_m = torch.where(doc_sel[:, None], theta, 0.0).contiguous()
    sh3 = model._shape3
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    b = model._blocks
    args = (model.wb.view(sh3), model.dla.view(sh3), model.state.z.view(sh3),
            theta_m, phi, seed, model.winb, model.firstb, model.windc)
    kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=cfg.vocab_span,
              dspan=b.dspan, num_topics=k)
    fn = cuda_zdraw.fused_zdraw_nkw
    # a checkout whose wrapper launches over the model's real-slot list
    if "real_slots" in inspect.signature(fn).parameters:
        kw["real_slots"] = model._real_slots
    return {f"{mode} K={k}": (fn, args, {**kw, "precise": mode == "precise"})
            for mode in ("bf16", "precise")}


def counts_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 counts]'s timed calls, with the operands of this checkout's
    `chip_smoke.py::count_cases` on the default cell blocks."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_counts
    own = _own_chip_smoke()
    cfg = LDAConfig(device="cuda")
    blocks = corpus.cell_blocks(block=cfg.token_block, vspan=cfg.vocab_span,
                                dspan=cfg.doc_span)
    fn = cuda_counts.blocked_label_counts
    return {name: (fn, args, kw) for name, (args, kw) in own.count_cases(
        torch, blocks, torch.device("cuda", 0)).items()}


def _own_chip_smoke():
    """This checkout's chip_smoke.py, whichever checkout the wrappers come
    from (the functions that make the cases' operands)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(ROOT, "chip_smoke.py"))
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return own


def gamma_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 gamma]'s timed Dirichlet draws, n_dk and N_kw a recount of a
    random z: theta [D, K] from n_dk + 0.5 over the last axis and phi [V,
    K] from N_kw + 0.01 over axis 0 at K=100 and K=4096, and the long
    rows, N_kw [K, V] + 0.01 over the last axis, at K=100."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_gamma
    dev = torch.device("cuda", 0)
    own = _own_chip_smoke()
    seed = torch.tensor([0x5EED_1234_ABCD], dtype=torch.int64, device=dev)
    fn = cuda_gamma.dirichlet
    cases = {}
    for k, z_seed in ((own.K, 3), (4096, 4)):
        z = np.random.default_rng(z_seed).integers(0, k, corpus.num_tokens)
        nkw_ref, ndk_ref = own.recount(corpus, z, k)
        ndk = torch.as_tensor(ndk_ref.astype(np.int32), device=dev)
        nkw = torch.as_tensor(nkw_ref.astype(np.int32), device=dev)
        alpha = torch.full((k,), 0.5, device=dev)
        cases[f"theta K={k}"] = (fn, (ndk, seed, -1, alpha), {})
        cases[f"phi K={k}"] = (fn, (nkw, seed, 0, 0.01), {})
        if k == own.K:
            cases[f"long rows K={k}"] = (fn, (nkw.T.contiguous(), seed, -1,
                                              0.01), {})
    return cases


def left_to_right_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 left-to-right]'s timed calls at K=100 and K=4096."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_left_to_right
    dev = torch.device("cuda", 0)
    own = _own_chip_smoke()
    cases = {}
    for k in (own.K, 4096):
        w_pad, mask, word_prob, alpha, seed, _n = own.l2r_operands(
            torch, corpus, k, dev)
        cases[f"K={k}"] = (cuda_left_to_right.left_to_right,
                           (w_pad, mask, word_prob, alpha, 100, seed), {})
    return cases


def alias_mh_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 alias-mh]'s operands at K=100 and K=4096: the z-step as the main
    path runs it (`alias_mh`: the pre-pass and the rounds) in both table
    modes with every document selected and with half of them (the even
    ones); the pre-pass alone; the rounds kernel alone after one
    pre-pass, 2 rounds, and at K=100 packed at 1 and 4 rounds and with no
    document selected (what a token costs without its draws and gathers);
    the pack at both K."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_alias_mh as cam
    own = _own_chip_smoke()
    cases = {}
    for k in (own.K, 4096):
        _model, case = own.alias_mh_case(torch, corpus, LDAConfig,
                                         create_model, k)
        tables = [case[n] for n in ("phi", "nkw", "theta", "ndk", "beta",
                                    "au")]
        args = {n: case[n] for n in ("phi", "nkw", "theta", "ndk", "beta",
                                     "alpha_sum", "au", "seed")}
        half, none = case["doc_mask"], torch.zeros_like(case["doc_mask"])
        head = (*cam.entry_topics(case["z_slot"], case["ops"]), case["ops"])
        for mode, packed in (("packed", cam.pack_tables(*tables)),
                             ("unpacked", None)):
            for sel, mask in (("all", None), ("half", half)):
                cases[f"zstep K={k} {mode} {sel}"] = (
                    cam.alias_mh, (case["z_slot"], case["ops"]),
                    dict(args, rounds=2, doc_mask=mask, packed=packed))
            probe = k == own.K and mode == "packed"
            for sel, mask in (("all", None), ("half", half),
                              ("none", none))[:1 + 2 * probe]:
                for r in (1, 2, 4) if probe and sel != "half" else (2,):
                    cases[f"rounds K={k} {mode} {sel} r{r}"] = (
                        cam.mh_rounds, head,
                        dict(args, rounds=r, doc_mask=mask, packed=packed))
        cases[f"prepass K={k}"] = (cam.entry_topics,
                                   (case["z_slot"], case["ops"]), {})
        cases[f"pack K={k}"] = (cam.pack_tables, tables, {})
    return cases


def _hdp_chain(torch, corpus, LDAConfig, create_model):
    """This checkout's [3 hdp] chain (ppu_hdplda K_max=100, 10
    iterations) and its seed."""
    own = _own_chip_smoke()
    model = own.hdp_state(torch, corpus, LDAConfig, create_model)
    seed = torch.tensor([0x0DDC_0FFE_E123], dtype=torch.int64,
                        device=model.device)
    return own, model, seed


def hdp_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 hdp]'s timed calls: the table counts in both instances, psi at
    K_max=100 on the chain's tables and at K_max=4096 on synthetic ones,
    the step after the chain's sweep, a single-stepped iteration."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_hdp
    own, model, seed = _hdp_chain(torch, corpus, LDAConfig, create_model)
    cfg, st = model.config, model.state
    m = model._max_count
    tables = cuda_hdp.table_counts(st.ndk, st.alpha, m, seed)
    kw = dict(gamma=cfg.hdp_gamma, budget=cfg.hdp_birth_budget,
              births="candidates", sampler=cfg.hdp_psi_sampler,
              dist=cfg.hdp_gamma_dist, alpha0=float(cfg.alpha))
    t4, n4, a4 = own.psi_operands(torch, 4096, model.device)
    fn, psi = cuda_hdp.table_counts, cuda_hdp.psi_step
    hist = torch.zeros((cfg.topics, m), dtype=torch.int32,
                       device=model.device)
    return {"tables K=100": (fn, (st.ndk, st.alpha, m, seed),
                             {"hist": hist}),
            "tables K=100 global": (fn, (st.ndk, st.alpha, m, seed),
                                    {"instance": "global", "hist": hist}),
            "psi K=100": (psi, (tables, st.nk, st.active, seed), kw),
            "psi K=4096 gem": (psi, (t4, n4, a4, seed),
                               dict(gamma=3.0, budget=32,
                                    births="candidates", sampler="gem",
                                    alpha0=0.5)),
            "psi K=4096 poisson": (psi, (t4, n4, a4, seed),
                                   dict(gamma=3.0, budget=32,
                                        births="lowest", sampler="poisson",
                                        alpha0=0.5)),
            "step ppu_hdplda K=100": (model._kernel_after_sweep,
                                      (st, st.ndk, st.nkw, st.nk), {}),
            "iteration ppu_hdplda K=100": _iteration(
                own, LDAConfig, create_model, corpus, "ppu_hdplda")}


def _iteration(own, LDAConfig, create_model, corpus, scheme):
    """A single-stepped iteration of `scheme` at K=100 after 2."""
    chain = create_model(own.pcgs_config(LDAConfig, scheme, own.K))
    chain.add_instances(corpus)
    chain.sample(2)
    return chain.sample, (1,), {}


def polya_urn_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 polya-urn]'s timed calls."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_polya_urn
    own, model, seed = _hdp_chain(torch, corpus, LDAConfig, create_model)
    st = model.state
    nkw200 = own.urn_operands(torch, corpus, model.device)
    fn = cuda_polya_urn.polya_urn
    return {"rows K=100": (fn, (st.nkw, 0.01, seed), {}),
            "rows K=100 active": (fn, (st.nkw, 0.01, seed, st.active), {}),
            "rows K=200": (fn, (nkw200, 0.01, seed), {}),
            "poisson K=100": (cuda_polya_urn.poisson,
                              (st.nkw.to(torch.float32) + 0.01, seed), {}),
            "iteration polyaurn K=100": _iteration(
                own, LDAConfig, create_model, corpus, "polyaurn")}


def vs_dirichlet_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 vs-dirichlet]'s timed calls, and a single-stepped iteration of
    nzvsspalias at K=100 and K=200 after 2 (its ms by CUDA events, the
    host's gaps between launches included)."""
    from ldagroupedgibbssampler_tpu_torch.ops import (cuda_gamma,
                                                      cuda_polya_urn)
    own, model, seed = _hdp_chain(torch, corpus, LDAConfig, create_model)
    st = model.state
    nkw200 = own.urn_operands(torch, corpus, model.device)
    phi200 = cuda_polya_urn.polya_urn(nkw200, 0.01, seed)[0]
    fn = cuda_gamma.vs_dirichlet
    cases = {"rows K=100": (fn, (st.nkw, 0.01, 0.5, seed, st.phi), {}),
             "rows K=200": (fn, (nkw200, 0.01, 0.5, seed, phi200), {})}
    for k in (own.K, 200):
        chain = create_model(own.pcgs_config(LDAConfig, "nzvsspalias", k))
        chain.add_instances(corpus)
        chain.sample(2)
        cases[f"iteration nzvsspalias K={k}"] = (chain.sample, (1,), {})
    return cases


def pairwise_cases(torch, cs, corpus, LDAConfig, create_model):
    """[3 pairwise]'s kernels' wrappers, every metric at each shape."""
    own = _own_chip_smoke()
    dev = torch.device("cuda", 0)
    out = {}
    for label, m, n, k in (("a", own.PAIRWISE_TEST, own.PAIRWISE_TRAIN,
                            own.K),
                           ("block", own.APPS_BLOCK, own.PAIRWISE_TRAIN,
                            own.K),
                           ("K=4096", 512, 512, 4096)):
        X = torch.as_tensor(own.pairwise_rows(m, k, 1), device=dev)
        Y = torch.as_tensor(own.pairwise_rows(n, k, 2), device=dev)
        for name in own.PAIRWISE_METRICS:
            kernel, _ = own.pairwise_kernel_fns(torch, name, X, Y)
            out[f"{name} {label}"] = (kernel, (), {})
        if label == "a":
            # a negative value in every 64th row: every block of jaccard's
            # kernel off its tame path
            Xg = X.clone()
            Xg[::64, 0] = -1e-3
            out["jaccard a general"] = (
                own.pairwise_kernel_fns(torch, "jaccard", Xg, Y)[0], (), {})
    return out


CASES = {"pcgs": pcgs_cases, "lightlda": lightlda_cases,
         "zdraw": zdraw_cases, "counts": counts_cases, "gamma": gamma_cases,
         "left_to_right": left_to_right_cases, "alias_mh": alias_mh_cases,
         "hdp": hdp_cases, "polya_urn": polya_urn_cases,
         "vs_dirichlet": vs_dirichlet_cases, "pairwise": pairwise_cases}


def worker(kernel: str, root: str, source: str, out_dir: str) -> int:
    """Build `source` under the checkout `root`, build the operands, then
    time one case per line read from stdin; protocol lines start with
    TAG."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
    from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
    from ldagroupedgibbssampler_tpu_torch.ops import _build

    def say(obj):
        print(TAG + json.dumps(obj), flush=True)

    try:
        lib, regs = build_source(source, out_dir)
    except Exception as e:                       # noqa: BLE001
        say({"error": str(e)})
        return 1
    # the checkout's own build of all its kernels, made when first needed
    overlay = Overlay(lib, _build.library)
    _build.library = lambda: overlay
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = cs.synth_corpus(Corpus)
    cases = CASES[kernel](torch, cs, corpus, LDAConfig, create_model)
    say({"ready": True, "ptxas": regs, "cases": list(cases)})
    for line in sys.stdin:
        name = line.strip()
        if not name:
            continue
        fn, args, kw = cases[name]
        msg = {"ms": cs.time_ms(torch, lambda: fn(*args, **kw))}
        if name.startswith("iteration"):
            wall, busy, _rows = cs.profile_numbers(
                torch, lambda: [fn(*args, **kw) for _ in range(5)], 5)
            msg |= {"wall_ms": wall, "device_ms": busy}
        say(msg)
    return 0


# ---------------------------------------------------------- orchestrator
class Worker:
    def __init__(self, name, kernel, root, source, call_timeout):
        self.name, self.call_timeout = name, call_timeout
        out_dir = os.path.join(ROOT, "build", "kernel_timing", name)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--kernel", kernel, "--root", root, "--source", source,
             "--out", out_dir],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)
        self.alive = True
        # protocol lines, read by a thread so that a wait can time out;
        # other output is echoed to stderr; None marks the end of output
        self.lines = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            if line.startswith(TAG):
                self.lines.put(json.loads(line[len(TAG):]))
            else:
                print(f"[{self.name}] {line.rstrip()}", file=sys.stderr,
                      flush=True)
        self.lines.put(None)

    def read(self, timeout):
        """The next protocol line as a dict; None when the worker died or
        timed out."""
        try:
            return self.lines.get(timeout=timeout)
        except queue.Empty:
            print(f"[{self.name}] no answer in {timeout:.0f} s",
                  file=sys.stderr, flush=True)
            return None

    def ask(self, case):
        self.proc.stdin.write(case + "\n")
        self.proc.stdin.flush()
        return self.read(self.call_timeout)

    def stop(self):
        self.alive = False
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def resolve(path: str, kernel: str, root: str) -> tuple[str, str]:
    """(checkout root, kernel source) of one NAME=PATH."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        return path, os.path.join(path, "ldagroupedgibbssampler_tpu_torch",
                                  "csrc", KERNEL_SOURCES[kernel])
    return root, path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", metavar="NAME=PATH")
    ap.add_argument("--kernel", required=True, choices=sorted(CASES))
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose wrappers time the .cu sources")
    ap.add_argument("--cases", default=None,
                    help="comma-separated cases to time (default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--call-timeout", type=float, default=120.0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--source", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.kernel, args.root, args.source, args.out)

    import torch
    if not torch.cuda.is_available():
        print("time_kernel_builds: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[env] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    sources = dict(s.split("=", 1) for s in args.sources)
    t0 = time.perf_counter()
    workers = {}
    try:
        for name, path in sources.items():
            root, src = resolve(path, args.kernel,
                                os.path.abspath(args.root))
            workers[name] = Worker(name, args.kernel, root, src,
                                   args.call_timeout)
        cases = None
        for name, w in workers.items():
            msg = w.read(1800)
            if msg is None or "error" in msg:
                print(f"[build] {name}: FAILED "
                      f"{'' if msg is None else msg['error'][-2000:]}",
                      flush=True)
                w.stop()
                continue
            print(f"[build] {name}: {' | '.join(msg['ptxas'])}", flush=True)
            if cases is None:
                cases = msg["cases"]
        print(f"[build] {len(workers)} sources built and set up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if cases is None:
            return 1
        if args.cases:
            cases = [c for c in cases if c in args.cases.split(",")]
        results = []
        for case in cases:
            names = [n for n, w in workers.items() if w.alive]
            order = []
            for _ in range(args.rounds):
                order += names + names[::-1]
            samples = {n: [] for n in names}
            extra = {n: [] for n in names}
            for name in order:
                w = workers[name]
                if not w.alive:
                    continue
                msg = w.ask(case)
                if msg is None or "ms" not in msg:
                    print(f"[{case}] {name}: call failed; dropped",
                          flush=True)
                    w.stop()
                    continue
                samples[name].append(msg.pop("ms"))
                if msg:
                    extra[name].append(msg)
            med = {n: float(np.median(s)) for n, s in samples.items() if s}
            prof = {n: {k: float(np.median([e[k] for e in x])) for k in x[0]}
                    for n, x in extra.items() if x}
            print(f"[{args.kernel} {case}] " + "; ".join(
                f"{n} {med[n]:.4f} ms "
                f"({', '.join(f'{x:.4f}' for x in samples[n])})"
                + (f" profiled: host wall {prof[n]['wall_ms']:.4f}, device "
                   f"busy {prof[n]['device_ms']:.4f} ms a call"
                   if n in prof else "")
                for n in med) + f" | {smi}", flush=True)
            results.append({"case": case, "order": order,
                            "samples": samples, "median_ms": med,
                            "profiled": prof})
    finally:
        for w in workers.values():
            w.stop()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "kernel": args.kernel,
                       "sources": sources, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
