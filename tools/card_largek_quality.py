#!/usr/bin/env python3
"""Large-K (K=4096) chain quality on the card, dense `ggs` against
`ggs_aliasmh`: the port of the JAX package's benchmarks/largek_quality.py.

At K=4096 an alias-MH iteration costs about a quarter of a dense one.
This study asks whether it samples as well. It runs on the synthetic
20NG corpus (tools/synth_corpus.py, the recipe of bench.py) at K=4096,
alpha 50/K, beta 0.01, in three sections:

A. The bf16 gate at K=4096: dense `ggs` with the bf16 z-draw tables (the
   default) against N_PRECISE_SEEDS chains with `zdraw_precise=True`, 200
   iterations, the model LL every 20. The final LL and the Gini of the
   topic sizes must lie in the two-sided 99% predictive interval of the
   precise ensemble (df = 4, card_bf16_gate.predictive_check). The JAX
   script's precise chains ran its segmented XLA z-draw, a second
   implementation; the port has one z-draw, csrc/zdraw.cu, whose precise
   mode takes f32 tables, so this gate is bf16 against f32 on one kernel.
   The cross-implementation half of the JAX gate is carried by
   chip_smoke.py phase 3 (`[3 zdraw K=4096]`: both modes against the
   plain version).
B. The rounds study: dense `ggs` and `ggs_aliasmh` at `aliasmh_rounds`
   1, 4 and 16, seed 2019, 200 iterations. As the rounds grow the MH
   z-step nears the exact conditional draw; `monotone_toward_dense` says
   whether the LL gap to dense shrinks with them. A finding, not a gate.
C. The plateau: both schemes (`aliasmh_rounds` 1), PLATEAU_SEEDS each,
   3000 iterations on the train split of `build_perplexity_split(corpus,
   0.1, seed=2019)`, the model LL every 100; then the held-out LL of the
   left-to-right estimator on the first 256 evaluation documents, 20
   particles, its generator seeded 7. The summary holds the final LLs,
   their rise over the last 500 iterations (from the first reading when
   the chain is shorter than 600), the held-out LLs, the gaps between
   the schemes' means and the pooled seed sigma of each.

Seeds. A seed of 0 means the clock in LDAConfig (`effective_seed`), so
the JAX script's seed-0 chains cannot be rerun. Here A's precise chains
take seeds 1-5 and its bf16 chain seed 6, outside the precise set (a
chain of the same seed would share its initial z and kernel keys); C
takes seeds 1-3; B keeps 2019. Tags name the seeds used (`bf16_seed6`,
`precise_seed1`, `ggs_seed1`, ...), where the JAX record has
`bf16_seed0`, `precise_seed0`-`4` and `*_seed0`-`2`.

Run from the repository root:

    python3 tools/card_largek_quality.py [--device cuda|cpu] [--docs N]
        [--topics 4096] [--iters-a 200] [--iters-b 200] [--iters-c 3000]
        [--sections A,B,C] [--token-block N] [--out FILE]
        [--jax-record LARGEK_QUALITY.json]

`--docs` keeps the corpus's first N documents over the types they use,
`--topics` sets K (alpha stays 50/K) and `--token-block` the tokens a
sweep block (a cut corpus's cells are mostly padding at the default
4096), for a run cut to the CPU's size. The record is
written after every chain (to largek_study.json by default); a rerun
with the same `--out` skips the chains already in it and raises if its
device, corpus or lengths differ. LARGEK_QUALITY_TORCH.json is the
record of a whole study on an NVIDIA H100 80GB HBM3 (700 W).
`--jax-record` prints each summary number beside the same number of the
JAX package's record, with the difference in pooled seed sigma. A `cuda`
request without a card raises. On the card every chain must launch the
kernels its scheme runs (COUNTERS). Exits non-zero when the gate fails,
a counter did not move, an LL is not finite or a trajectory of two or
more readings did not rise.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from ldagroupedgibbssampler_tpu_torch.config.lda_config import (  # noqa: E402
    LDAConfig)
from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (  # noqa: E402
    build_perplexity_split)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus  # noqa: E402
from ldagroupedgibbssampler_tpu_torch.evaluation.marginal import (  # noqa
    left_to_right_log_likelihood)
from ldagroupedgibbssampler_tpu_torch.models.registry import (  # noqa: E402
    create_model)
from ldagroupedgibbssampler_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)
from tools import card_bf16_gate as gate  # noqa: E402
from tools.card_geweke_check import counter_values  # noqa: E402
from tools.synth_corpus import synth_corpus  # noqa: E402

K = 4096
BETA = 0.01
N_PRECISE_SEEDS = 5
# two-sided 99% Student-t quantile, df = N_PRECISE_SEEDS - 1 = 4
T_CRIT_995_DF4 = gate.T_CRIT_995[N_PRECISE_SEEDS - 1]
PRECISE_SEEDS = tuple(range(1, N_PRECISE_SEEDS + 1))
BF16_SEED = N_PRECISE_SEEDS + 1
ROUNDS_SEED = 2019
ROUNDS = (1, 4, 16)
PLATEAU_SEEDS = (1, 2, 3)
PLATEAU_SCHEMES = ("ggs", "ggs_aliasmh")
HELD_OUT_DOCS = 256
PARTICLES = 20
HELD_OUT_SEED = 7
SECTIONS = ("A", "B", "C")
# the launch counters (chip_smoke.py's names) that a chain must move on
# the card: by scheme, and the estimator's for a chain with a held-out LL
SCHEME_COUNTERS = {
    "ggs": ("fused_zdraw_nkw", "blocked_label_counts", "dirichlet"),
    "ggs_aliasmh": ("blocked_label_counts", "dirichlet", "mh_rounds",
                    "entry_topics", "pack_tables"),
}
HELD_OUT_COUNTERS = ("left_to_right",)
COUNTERS = ("fused_zdraw_nkw", "blocked_label_counts", "dirichlet",
            "mh_rounds", "entry_topics", "pack_tables", "left_to_right")


def alpha_of(topics: int) -> float:
    return 50.0 / topics


class Report:
    """The study's record as nested dicts, written to `path` (if any)
    after every `put`; a record already at `path` is read first."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.data = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self.data = json.load(f)

    def put(self, *keys_and_value):
        *keys, value = keys_and_value
        d = self.data
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = value
        if self.path:
            with open(self.path, "w") as f:
                json.dump(self.data, f, indent=1)

    def has(self, section: str, tag: str) -> bool:
        return bool(self.data.get(section, {}).get(tag))

    def settle(self, key: str, value):
        """Record a setting of the run, or raise if the record holds
        another: its chains would not belong to this run."""
        config = self.data.get("config", {})
        if key in config and config[key] != value:
            raise ValueError(f"{self.path}: its {key} is {config[key]!r}, "
                             f"this run's {value!r}; pass another --out")
        if key not in config:
            self.put("config", key, value)


# ---- the summaries: pure functions of the chain records ----------------
def final_reading(traj: dict):
    """(iteration, LL) of a trajectory's last reading."""
    top = max(int(k) for k in traj)
    return top, traj[str(top)]


def rise_last_500(traj: dict) -> float:
    """LL change over the last 500 iterations (from the first reading
    when none lies 500 before the last)."""
    t = {int(k): v for k, v in traj.items()}
    top = max(t)
    lo = max((k for k in t if k <= top - 500), default=min(t))
    return t[top] - t[lo]


def predictive_check(value, ensemble) -> dict:
    """The JAX script's two-sided 99% predictive-interval check, computed
    by card_bf16_gate.predictive_check (the quantile from the ensemble's
    size), in the JAX record's layout."""
    c = gate.predictive_check(value, ensemble)
    return {"value": c["bf16"], "precise_mean": c["precise_mean"],
            "precise_sd": c["precise_sd"], "n": c["n_precise_seeds"],
            "interval_half_width": c["interval_half_width"],
            "abs_delta": c["abs_delta"], "pass": c["pass"]}


def a_checks(a: dict, bf16_tag: str, precise_tags) -> tuple[dict, bool]:
    """Section A's checks of the bf16 chain against the precise ones, and
    the gate's verdict."""
    pre = [a[t] for t in precise_tags]
    bf = a[bf16_tag]
    it, value = final_reading(bf["ll_traj"])
    checks = {
        f"ll_{it}": predictive_check(
            value, [p["ll_traj"][str(it)] for p in pre]),
        "nk_gini": predictive_check(bf["nk_gini"],
                                    [p["nk_gini"] for p in pre]),
    }
    return checks, bool(all(c["pass"] for c in checks.values()))


def b_summary(b: dict) -> dict:
    """Section B's summary: each rounds variant's LL at the last reading
    and its distance from the dense chain's."""
    it, dense = final_reading(b["dense_ggs"]["ll_traj"])
    seq = [b[f"aliasmh_r{r}"]["ll_traj"][str(it)] for r in ROUNDS]
    dist = [abs(x - dense) for x in seq]
    return {
        f"dense_ll_{it}": dense,
        f"aliasmh_ll_{it}_by_rounds": {str(r): x for r, x in zip(ROUNDS,
                                                                 seq)},
        "abs_gap_to_dense_by_rounds": {str(r): d for r, d in zip(ROUNDS,
                                                                 dist)},
        "monotone_toward_dense": bool(dist[0] >= dist[1] >= dist[2]),
    }


def c_summary(c: dict, seeds) -> dict:
    """Section C's summary over `seeds` of each scheme: final LLs, their
    rise over the last 500 iterations, held-out LLs, the gaps between
    the schemes' means and the pooled seed sigmas (the JAX fields)."""
    def tag(scheme, s):
        return f"{scheme}_seed{s}"
    iters = final_reading(c[tag("ggs", seeds[0])]["ll_traj"])[0]
    g = [final_reading(c[tag("ggs", s)]["ll_traj"])[1] for s in seeds]
    a = [final_reading(c[tag("ggs_aliasmh", s)]["ll_traj"])[1]
         for s in seeds]
    gh = [c[tag("ggs", s)]["held_out_ll"] for s in seeds]
    ah = [c[tag("ggs_aliasmh", s)]["held_out_ll"] for s in seeds]
    sigma = float(np.sqrt((np.var(g, ddof=1) + np.var(a, ddof=1)) / 2))
    gap = float(abs(np.mean(g) - np.mean(a)))
    return {
        "iters": iters,
        "ggs_final_ll": g, "aliasmh_final_ll": a,
        "ggs_slope_last500": [rise_last_500(c[tag("ggs", s)]["ll_traj"])
                              for s in seeds],
        "aliasmh_slope_last500": [
            rise_last_500(c[tag("ggs_aliasmh", s)]["ll_traj"])
            for s in seeds],
        "ggs_held_out_ll": gh, "aliasmh_held_out_ll": ah,
        "held_out_gap": float(abs(np.mean(gh) - np.mean(ah))),
        "held_out_sigma": float(np.sqrt((np.var(gh, ddof=1)
                                         + np.var(ah, ddof=1)) / 2)),
        "final_ll_gap": gap, "final_ll_seed_sigma": sigma,
        "gap_vs_sigma": gap / max(sigma, 1e-9),
    }


# ---- the chains ---------------------------------------------------------
def study_corpus(docs: int | None = None) -> Corpus:
    """The synthetic 20NG corpus; with `docs`, its first `docs` documents
    over the types they use (renumbered in their order)."""
    corpus = synth_corpus(Corpus)
    if docs is None:
        return corpus
    corpus = corpus.subset(np.arange(min(docs, corpus.num_docs)))
    used, tokens = np.unique(corpus.tokens, return_inverse=True)
    return Corpus(tokens=tokens.astype(np.int32),
                  doc_offsets=corpus.doc_offsets,
                  vocab=[corpus.vocab[i] for i in used])


def run_chain(rep: Report, section: str, tag: str, scheme: str, seed: int,
              corpus, device: str, topics: int, iters: int, every: int,
              held_out=None, echo=print, token_block=None, **cfg) -> None:
    """One chain: the model LL every `every` iterations, the Gini of the
    topic sizes, the held-out LL on `held_out` (a Corpus) if given, the
    seconds and the launches of each counter; recorded under
    (section, tag), the model freed before the next chain."""
    import torch

    config = LDAConfig(scheme=scheme, topics=topics, alpha=alpha_of(topics),
                       beta=BETA, seed=seed, exec_time=-1, topic_interval=0,
                       device=device, **cfg)
    if token_block:
        config = config.replace(token_block=token_block)
    before = counter_values()
    t0 = time.perf_counter()
    m = create_model(config)
    m.add_instances(corpus)
    ll0 = m.model_log_likelihood()
    setup = time.perf_counter() - t0
    traj = {}
    t0 = time.perf_counter()
    done = 0
    while done < iters:
        step = min(every, iters - done)
        m.sample(step)
        done += step
        traj[str(done)] = m.model_log_likelihood()
    secs = time.perf_counter() - t0
    rec = {"ll_traj": traj, "ll_init": ll0,
           "nk_gini": gate.nk_gini(np.sort(m.get_tokens_per_topic())[::-1]),
           "seconds": secs, "ms_per_iteration": 1e3 * secs / iters,
           "setup_seconds": setup}
    if held_out is not None:
        t0 = time.perf_counter()
        gen = torch.Generator(device=m.device)
        gen.manual_seed(HELD_OUT_SEED)
        rec["held_out_ll"] = left_to_right_log_likelihood(
            held_out, None, m.state.alpha, num_particles=PARTICLES,
            nkw=m._nkw_kv(), nk=m.state.nk, beta=m.get_beta(),
            generator=gen)
        rec["held_out_seconds"] = time.perf_counter() - t0
    after = counter_values()
    rec["launches"] = {n: after[n] - before[n] for n in COUNTERS}
    rep.put(section, tag, rec)
    echo(f"{section} {tag}: LL {ll0:.9g} at 0, {traj[str(iters)]:.9g} at "
         f"{iters}" + (f", held-out {rec['held_out_ll']:.9g}"
                       if held_out is not None else "")
         + f"; {secs:.2f} s, {rec['ms_per_iteration']:.4f} ms an "
         f"iteration with the LL readings")
    m.release_chunked()
    del m
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def section_a(rep, corpus, device, topics=K, iters=200, echo=print,
              token_block=None):
    chains = ([(f"bf16_seed{BF16_SEED}", False, BF16_SEED)]
              + [(f"precise_seed{s}", True, s) for s in PRECISE_SEEDS])
    for tag, precise, seed in chains:
        if not rep.has("A", tag):
            run_chain(rep, "A", tag, "ggs", seed, corpus, device, topics,
                      iters, 20, echo=echo, token_block=token_block,
                      zdraw_precise=precise)
    checks, ok = a_checks(rep.data["A"], chains[0][0],
                          [t for t, _, _ in chains[1:]])
    rep.put("A", "checks", checks)
    rep.put("A", "gate_pass", ok)


def section_b(rep, corpus, device, topics=K, iters=200, echo=print,
              token_block=None):
    for tag, scheme, rounds in ([("dense_ggs", "ggs", None)]
                                + [(f"aliasmh_r{r}", "ggs_aliasmh", r)
                                   for r in ROUNDS]):
        if not rep.has("B", tag):
            kw = {} if rounds is None else {"aliasmh_rounds": rounds}
            run_chain(rep, "B", tag, scheme, ROUNDS_SEED, corpus, device,
                      topics, iters, 20, echo=echo,
                      token_block=token_block, **kw)
    rep.put("B", "summary", b_summary(rep.data["B"]))


def section_c(rep, corpus, device, topics=K, iters=3000, echo=print,
              token_block=None):
    train, _est, evl = build_perplexity_split(corpus, 0.1, seed=2019)
    # one held-out protocol for every chain: the same documents, particle
    # count and estimator seed
    sub = evl.subset(np.arange(min(HELD_OUT_DOCS, evl.num_docs)))
    for scheme in PLATEAU_SCHEMES:
        for seed in PLATEAU_SEEDS:
            tag = f"{scheme}_seed{seed}"
            if not rep.has("C", tag):
                kw = ({"aliasmh_rounds": 1} if scheme == "ggs_aliasmh"
                      else {})
                run_chain(rep, "C", tag, scheme, seed, train, device,
                          topics, iters, 100, held_out=sub, echo=echo,
                          token_block=token_block, **kw)
    rep.put("C", "summary", c_summary(rep.data["C"], PLATEAU_SEEDS))


def chains_of(data: dict):
    """(section, tag, scheme, record) of every chain in a record."""
    for section in SECTIONS:
        for tag, rec in data.get(section, {}).items():
            if isinstance(rec, dict) and "ll_traj" in rec:
                scheme = ("ggs_aliasmh" if tag.startswith(("aliasmh",
                                                           "ggs_aliasmh"))
                          else "ggs")
                yield section, tag, scheme, rec


def failures(data: dict) -> list[str]:
    """What the record fails: A's gate, a non-finite LL, a trajectory of
    two or more readings that did not rise, or (off the CPU) a counter
    that a chain's scheme runs and that did not move."""
    out = []
    if "A" in data and not data["A"].get("gate_pass", False):
        out.append("A: the bf16 chain left the precise ensemble's "
                   "interval")
    on_card = data.get("config", {}).get("device", "cpu") != "cpu"
    for section, tag, scheme, rec in chains_of(data):
        traj = [rec["ll_traj"][k] for k in
                sorted(rec["ll_traj"], key=int)]
        values = traj + [rec.get("ll_init", 0.0),
                         rec.get("held_out_ll", 0.0)]
        if not np.all(np.isfinite(values)):
            out.append(f"{section} {tag}: an LL is not finite")
        if len(traj) > 1 and not traj[-1] > traj[0]:
            out.append(f"{section} {tag}: LL did not rise "
                       f"({traj[0]} -> {traj[-1]})")
        if on_card:
            want = SCHEME_COUNTERS[scheme] + (
                HELD_OUT_COUNTERS if "held_out_ll" in rec else ())
            missing = [n for n in want if rec["launches"].get(n, 0) <= 0]
            if missing:
                out.append(f"{section} {tag}: counters did not move: "
                           + ", ".join(missing))
    return out


def study(corpus, device: str, sections=SECTIONS, topics=K, iters_a=200,
          iters_b=200, iters_c=3000, out: str | None = None,
          echo=print, token_block: int | None = None) -> dict:
    """Run the sections asked for (skipping the chains already in `out`)
    and return the record, with the launches of every counter over this
    call and its seconds."""
    resolve_device(device)
    rep = Report(out)
    rep.settle("device", device)
    rep.settle("docs", corpus.num_docs)
    rep.settle("topics", topics)
    rep.settle("token_block", token_block)
    t0 = time.perf_counter()
    before = counter_values()
    for name, run, iters in (("A", section_a, iters_a),
                             ("B", section_b, iters_b),
                             ("C", section_c, iters_c)):
        if name in sections:
            rep.settle(f"iters_{name}", iters)
            run(rep, corpus, device, topics, iters, echo=echo,
                token_block=token_block)
    after = counter_values()
    data = dict(rep.data)
    data["launches"] = {n: after[n] - before[n] for n in COUNTERS}
    data["seconds"] = time.perf_counter() - t0
    return data


# ---- printing ------------------------------------------------------------
def summary_lines(data: dict) -> list[str]:
    lines = []
    if "A" in data and "checks" in data["A"]:
        for name, c in data["A"]["checks"].items():
            lines.append(
                f"A {name}: bf16 {c['value']:.9g} precise mean "
                f"{c['precise_mean']:.9g} sd {c['precise_sd']:.6g} "
                f"half-width {c['interval_half_width']:.6g} |delta| "
                f"{c['abs_delta']:.6g} " + ("pass" if c["pass"] else "FAIL"))
        lines.append("A gate " + ("passed" if data["A"]["gate_pass"]
                                  else "FAILED"))
    if "B" in data and "summary" in data["B"]:
        lines.append("B " + json.dumps(data["B"]["summary"]))
    if "C" in data and "summary" in data["C"]:
        lines.append("C " + json.dumps(data["C"]["summary"]))
    return lines


def _pooled(x, y) -> float:
    """sqrt of the mean of two samples' variances (ddof=1)."""
    return float(np.sqrt((np.var(x, ddof=1) + np.var(y, ddof=1)) / 2))


def _row(name, ours, theirs, sigma, note=""):
    d = float(ours) - float(theirs)
    return {"name": name, "card": float(ours), "jax": float(theirs),
            "difference": d, "sigma": sigma,
            "difference_in_sigma": (d / sigma if sigma else None),
            "note": note}


def compare_records(ours: dict, jax: dict) -> list[dict]:
    """Each summary number of this record beside the JAX record's, the
    difference in pooled seed sigma: for an ensemble mean the pooled sd
    of the two packages' seeds; for B's single chains A's pooled precise
    sd at the same iteration; for a gap the two summaries' sigmas
    pooled."""
    rows = []
    a_sigma = {}
    if "checks" in ours.get("A", {}) and "checks" in jax.get("A", {}):
        for name, c in ours["A"]["checks"].items():
            j = jax["A"]["checks"].get(name)
            if j is None:
                continue
            sigma = float(np.sqrt((c["precise_sd"] ** 2
                                   + j["precise_sd"] ** 2) / 2))
            a_sigma[name] = sigma
            rows.append(_row(f"A {name} precise mean", c["precise_mean"],
                             j["precise_mean"], sigma))
            rows.append(_row(f"A {name} bf16", c["value"], j["value"],
                             sigma))
    if "summary" in ours.get("B", {}) and "summary" in jax.get("B", {}):
        b, jb = ours["B"]["summary"], jax["B"]["summary"]
        key = next(k for k in b if k.startswith("dense_ll_"))
        it = key[len("dense_ll_"):]
        sigma = a_sigma.get(f"ll_{it}")
        if key in jb:
            note = "sigma: A's precise seeds" if sigma else ""
            rows.append(_row(f"B {key}", b[key], jb[key], sigma, note))
            by = f"aliasmh_ll_{it}_by_rounds"
            for r, v in b[by].items():
                rows.append(_row(f"B aliasmh rounds {r}", v, jb[by][r],
                                 sigma, note))
    if "summary" in ours.get("C", {}) and "summary" in jax.get("C", {}):
        c, jc = ours["C"]["summary"], jax["C"]["summary"]
        note = ("" if c["iters"] == jc["iters"] else
                f"card at {c['iters']} iterations, JAX at {jc['iters']}")
        for field in ("ggs_final_ll", "aliasmh_final_ll",
                      "ggs_slope_last500", "aliasmh_slope_last500",
                      "ggs_held_out_ll", "aliasmh_held_out_ll"):
            rows.append(_row(f"C mean {field}", np.mean(c[field]),
                             np.mean(jc[field]),
                             _pooled(c[field], jc[field]), note))
        for field, sig in (("final_ll_gap", "final_ll_seed_sigma"),
                           ("held_out_gap", "held_out_sigma")):
            sigma = float(np.sqrt((c[sig] ** 2 + jc[sig] ** 2) / 2))
            rows.append(_row(f"C {field}", c[field], jc[field], sigma,
                             note))
        rows.append(_row("C gap_vs_sigma", c["gap_vs_sigma"],
                         jc["gap_vs_sigma"], None, note))
    return rows


def compare_line(row: dict) -> str:
    ds = row["difference_in_sigma"]
    return (f"{row['name']}: card {row['card']:.9g} JAX {row['jax']:.9g} "
            f"difference {row['difference']:.6g}"
            + (f" = {ds:+.3f} sigma (sigma {row['sigma']:.6g})"
               if ds is not None else "")
            + (f" [{row['note']}]" if row["note"] else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--docs", type=int, default=None)
    ap.add_argument("--topics", type=int, default=K)
    ap.add_argument("--iters-a", type=int, default=200)
    ap.add_argument("--iters-b", type=int, default=200)
    ap.add_argument("--iters-c", type=int, default=3000)
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--out", default="largek_study.json")
    ap.add_argument("--token-block", type=int, default=None,
                    help="tokens a sweep block (LDAConfig's by default)")
    ap.add_argument("--jax-record", default="")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    data = study(study_corpus(args.docs), args.device,
                 [s for s in args.sections.split(",") if s], args.topics,
                 args.iters_a, args.iters_b, args.iters_c, args.out,
                 token_block=args.token_block)
    for line in summary_lines(data):
        print(line, flush=True)
    print("launches " + json.dumps(data["launches"]), flush=True)
    if args.jax_record:
        with open(args.jax_record) as f:
            jax = json.load(f)
        for row in compare_records(data, jax):
            print(compare_line(row), flush=True)
    failed = failures(data)
    for line in failed:
        print(line, flush=True)
    print(f"large-K study {'FAILED' if failed else 'passed'} "
          f"({args.device}, {data['seconds']:.1f} s)", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
