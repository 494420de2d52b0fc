#!/usr/bin/env python3
"""The HDP step after the sweep on one CUDA card: what its one seed launch
and its dependent psi launch each save, and what a step launches.

Run from the repository root on a machine with one card and nvcc:

    python3 tools/hdp_step_forms.py [--rounds 4] [--trace DIR ...]

On `chip_smoke.py`'s ppu_hdplda K_max=100 chain after 10 iterations (the
synthetic 20NG corpus), the step (`models/hdp.py::_kernel_after_sweep`:
the table counts, psi and the Polya-Urn rows) is timed in four forms, in
turns, by `chip_smoke.time_ms` (CUDA events, the launches queued ahead):
its three kernel keys from one `torch.randint` or from three, and psi
launched as the table counts' programmatic dependent or not. With
`--trace DIR`, one step of the checkout DIR (this one: `.`; the parent
unpacked with `git archive`, say) runs under torch.profiler in a process
of its own (`chip_smoke.hdp_step_trace` of this checkout): its `randint`
calls and its kernels in the order they started. Prints one line each
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _this_chip_smoke():
    """This checkout's chip_smoke.py as a module of its own name, whatever
    checkout is first on sys.path (its imports of the port are lazy)."""
    spec = importlib.util.spec_from_file_location(
        "hdp_step_forms_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chain(root):
    """(torch, the checkout's chip_smoke, its [3 hdp] chain)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
    from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
    model = cs.hdp_state(torch, cs.synth_corpus(Corpus), LDAConfig,
                         create_model)
    return torch, cs, model


def trace(root: str) -> dict:
    """One step of the checkout `root` under the profiler."""
    torch, _cs, model = _chain(root)
    own = _this_chip_smoke()
    own.hdp_step_trace(torch, model)              # warm-up
    return own.hdp_step_trace(torch, model)


def forms(rounds: int) -> dict:
    """{form: [median ms, samples]} of this checkout's step in four forms,
    timed in turns (first to last and back)."""
    import numpy as np
    torch, cs, model = _chain(ROOT)
    from ldagroupedgibbssampler_tpu_torch.ops import (cuda_hdp,
                                                      cuda_polya_urn)
    from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
    st, cfg = model.state, model.config
    gen, dev = model.generator, model.device

    def step(one_seed: bool, dependent: bool):
        keys = (rnd.kernel_seeds(gen, dev, 3) if one_seed else None)
        key = (lambda i: keys[i:i + 1]) if one_seed else (
            lambda i: rnd.kernel_seed(gen, dev))
        tables = cuda_hdp.table_counts(st.ndk, st.alpha, model._max_count,
                                       key(0), hist=model._table_hist)
        psi, active, alpha, _ = cuda_hdp.psi_step(
            tables, st.nk, st.active, key(1), gamma=cfg.hdp_gamma,
            budget=cfg.hdp_birth_budget, births=model.birth_rule,
            sampler=model._psi_sampler_name(), dist=cfg.hdp_gamma_dist,
            alpha0=float(cfg.alpha), dependent=dependent)
        phi, _ = cuda_polya_urn.polya_urn(st.nkw, float(cfg.beta), key(2),
                                          active=active)
        st.phi, st.psi, st.tables = phi, psi, tables
        st.active, st.alpha = active, alpha

    cases = {"one randint, psi dependent": (True, True),
             "one randint": (True, False),
             "three randints, psi dependent": (False, True),
             "three randints": (False, False)}
    names = list(cases)
    samples = {n: [] for n in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            samples[name].append(cs.time_ms(
                torch, lambda: step(*cases[name])))
    return {n: [float(np.median(v)), v] for n, v in samples.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--trace", nargs="*", default=[],
                    help="checkouts whose step to trace")
    ap.add_argument("--trace-one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.trace_one:
        print(json.dumps(trace(args.trace_one)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for root in args.trace:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--trace-one", root],
            capture_output=True, text=True, check=True, timeout=900)
        print(f"[step trace {root}] {out.stdout.strip().splitlines()[-1]} "
              f"| {smi}", flush=True)
    print(f"[step forms] ms, medians and samples: "
          f"{json.dumps(forms(args.rounds))} | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
