#!/usr/bin/env python3
"""Quality gate of the bf16 z-draw on the card: the port of the JAX
package's benchmarks/bf16_gate.py.

The z-draw's default mode (`zdraw_precise = False`) scores tokens with
bf16 theta and phi tables (csrc/zdraw.cu), perturbing each per-token
conditional by at most 2^-8 relative. This gate runs `ggs` on the
synthetic 20NG corpus (tools/synth_corpus.py, the recipe of bench.py)
at K=100, alpha 0.5, beta 0.01, for 200 iterations, one bf16 chain and
N_PRECISE_SEEDS precise chains of other seeds, and compares three
statistics:

  1. the final model LL (the Dirichlet-multinomial joint LL, taken every
     20 iterations),
  2. the Gini coefficient of the sorted tokens per topic,
  3. the held-out LL: a second model of the same mode on the train split
     of `build_perplexity_split(corpus, 0.1, seed=2019)`, 200 iterations,
     then the left-to-right estimator (on the card its kernel,
     csrc/left_to_right.cu) with 50 particles on the evaluation halves.

Criterion, the JAX script's: every chain is an independent MCMC run, so
if bf16 introduces no bias its statistics are exchangeable with the
precise ensemble. With n precise seeds (mean m, sd s with ddof=1,
df = n - 1) each bf16 statistic must lie in the two-sided 99%
predictive interval

    |x_bf16 - m| <= t_{0.995, n-1} * s * sqrt(1 + 1/n).

A failed gate is a finding about the bf16 path; it does not flip the
default. A seed fixes a chain's initial z and every kernel key, so the
bf16 chain's seed lies outside the precise seeds: a precise chain of the
same seed would start from its state, draw its numbers, and differ only
where a bf16 rounding moves a draw. Seed 0 means the clock in LDAConfig
(`effective_seed`), so the precise chains take seeds 1-6 and the bf16
chain seed 7 (the JAX script's range(6) gave its seed-0 chains a clock
seed, apart from the others).

Run from the repository root:

    python3 tools/card_bf16_gate.py [--device cuda|cpu] [--docs N]
        [--topics 100] [--iters 200] [--ll-every 20] [--particles 50]
        [--out FILE]

`--docs` keeps the corpus's first N documents (all by default) and
`--topics` sets K, for a run cut to the CPU's size. A `cuda` request
without a card raises; on the card the chains must launch the kernels
of COUNTERS. Prints one line a statistic and exits non-zero when the
gate fails.
"""

from __future__ import annotations

import argparse
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
from tools.card_geweke_check import counter_values  # noqa: E402
from tools.synth_corpus import synth_corpus  # noqa: E402

N_PRECISE_SEEDS = 6
# two-sided 99% Student-t quantiles t(.995, df) by df = n - 1 of an
# ensemble of n seeds, to the JAX scripts' three decimals
T_CRIT_995 = {4: 4.604, 5: 4.032}
T_CRIT_995_DF5 = T_CRIT_995[5]
PRECISE_SEEDS = tuple(range(1, N_PRECISE_SEEDS + 1))
BF16_SEED = N_PRECISE_SEEDS + 1
CHECKS = ("final_model_ll", "held_out_ll", "nk_gini")
# the launch counters (models/fusion.py::launch_counters, chip_smoke.py's
# names) that the gate's chains must move on the card
COUNTERS = ("fused_zdraw_nkw", "blocked_label_counts", "dirichlet",
            "left_to_right")


def gate_corpus(docs: int | None = None) -> Corpus:
    """The synthetic 20NG corpus, its first `docs` documents (all if
    None)."""
    corpus = synth_corpus(Corpus)
    if docs is not None:
        corpus = corpus.subset(np.arange(min(docs, corpus.num_docs)))
    return corpus


def nk_gini(nk_sorted) -> float:
    """Gini coefficient of the topic sizes (the JAX script's form)."""
    nk = np.asarray(nk_sorted, float)
    return float(np.abs(nk[:, None] - nk[None, :]).mean() / (2 * nk.mean()))


def run_chain(corpus, train, evl, precise: bool, seed: int, device: str,
              iters=200, k=100, ll_every=20, particles=50) -> dict:
    """One chain: the model LL every `ll_every` iterations, the sorted
    topic sizes and their Gini, and the held-out LL of a second model of
    the same mode trained on `train`."""
    import torch

    cfg = LDAConfig(scheme="ggs", topics=k, alpha=0.5, beta=0.01,
                    seed=seed, exec_time=-1, topic_interval=0,
                    zdraw_precise=precise, device=device)
    model = create_model(cfg)
    model.add_instances(corpus)
    ll_traj = []
    t0 = time.perf_counter()
    for _ in range(iters // ll_every):
        model.sample(ll_every)
        ll_traj.append(model.model_log_likelihood())
    elapsed = time.perf_counter() - t0
    nk_sorted = np.sort(model.get_tokens_per_topic())[::-1].astype(float)

    mh = create_model(cfg)
    mh.add_instances(train)
    mh.sample(iters)
    gen = torch.Generator(device=mh.device)
    gen.manual_seed(seed)
    hll = left_to_right_log_likelihood(
        evl, None, mh.state.alpha, num_particles=particles,
        nkw=mh._nkw_kv(), nk=mh.state.nk, beta=mh.get_beta(),
        generator=gen)
    return {"ll_traj": ll_traj, "nk_sorted_top20": nk_sorted[:20].tolist(),
            "nk_gini": nk_gini(nk_sorted), "held_out_ll": hll,
            "seconds": elapsed,
            "seconds_total": time.perf_counter() - t0}


def predictive_check(bf16_value: float, precise_values) -> dict:
    """Two-sided 99% predictive-interval check of one scalar statistic
    against the precise seed ensemble (df = n - 1, the quantile from
    T_CRIT_995)."""
    pv = np.asarray(precise_values, float)
    n = len(pv)
    if n - 1 not in T_CRIT_995:
        raise ValueError(f"no t quantile for {n} precise seeds")
    m, s = float(pv.mean()), float(pv.std(ddof=1))
    half_width = T_CRIT_995[n - 1] * s * float(np.sqrt(1.0 + 1.0 / n))
    delta = float(abs(bf16_value - m))
    return {"bf16": bf16_value, "precise_mean": m, "precise_sd": s,
            "df": n - 1, "n_precise_seeds": n,
            "interval_half_width": half_width, "abs_delta": delta,
            "t_stat": delta / max(s * float(np.sqrt(1.0 + 1.0 / n)),
                                  1e-12),
            "pass": bool(delta <= half_width)}


def gate(corpus, device: str, iters=200, ll_every=20, particles=50,
         k=100) -> dict:
    """The bf16 chain and the precise seeds on `corpus`; the three checks
    and the verdict."""
    resolve_device(device)
    train, _est, evl = build_perplexity_split(corpus, 0.1, seed=2019)
    kw = dict(device=device, iters=iters, k=k, ll_every=ll_every,
              particles=particles)
    t0 = time.perf_counter()
    before = counter_values()
    runs = {f"bf16_seed{BF16_SEED}": run_chain(corpus, train, evl, False,
                                               BF16_SEED, **kw)}
    for seed in PRECISE_SEEDS:
        runs[f"precise_seed{seed}"] = run_chain(corpus, train, evl, True,
                                                seed, **kw)
    after = counter_values()
    launches = {n: after[n] - before[n] for n in COUNTERS}
    missing = ([n for n in COUNTERS if launches[n] <= 0]
               if device != "cpu" else [])
    bf16 = runs[f"bf16_seed{BF16_SEED}"]
    precise = [runs[f"precise_seed{s}"] for s in PRECISE_SEEDS]
    checks = {
        "final_model_ll": predictive_check(
            bf16["ll_traj"][-1], [r["ll_traj"][-1] for r in precise]),
        "held_out_ll": predictive_check(
            bf16["held_out_ll"], [r["held_out_ll"] for r in precise]),
        "nk_gini": predictive_check(
            bf16["nk_gini"], [r["nk_gini"] for r in precise]),
    }
    return {"criterion": ("each bf16 statistic inside the two-sided 99% "
                          "predictive interval of the precise seed "
                          "ensemble: |x - mean| <= t(.995, "
                          f"df={N_PRECISE_SEEDS - 1}) * sd * sqrt(1 + "
                          f"1/{N_PRECISE_SEEDS})"),
            "device": device, "iterations": iters, "topics": k,
            "num_docs": corpus.num_docs, "runs": runs, "checks": checks,
            "launches": launches, "counters_missing": missing,
            "seconds": time.perf_counter() - t0,
            "gate_pass": (all(c["pass"] for c in checks.values())
                          and not missing)}


def check_line(name: str, c: dict) -> str:
    return (f"{name}: bf16 {c['bf16']:.6g} precise mean "
            f"{c['precise_mean']:.6g} sd {c['precise_sd']:.4g} half-width "
            f"{c['interval_half_width']:.4g} |delta| {c['abs_delta']:.4g} "
            + ("pass" if c["pass"] else "FAIL"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--docs", type=int, default=None)
    ap.add_argument("--topics", type=int, default=100)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--ll-every", type=int, default=20)
    ap.add_argument("--particles", type=int, default=50)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    report = gate(gate_corpus(args.docs), args.device, args.iters,
                  args.ll_every, args.particles, args.topics)
    for name in CHECKS:
        print(check_line(name, report["checks"][name]))
    for name in report["counters_missing"]:
        print(f"counter {name} did not rise")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"bf16 gate {'passed' if report['gate_pass'] else 'FAILED'} "
          f"({args.device}, {report['seconds']:.1f} s)")
    return 0 if report["gate_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
