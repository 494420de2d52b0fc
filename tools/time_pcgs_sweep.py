#!/usr/bin/env python3
"""Time builds of the PCGS sweep kernel (csrc/pcgs.cu) against each other
on one CUDA card, in turns.

Run from the repository root on a machine with one card and nvcc:

    python3 tools/time_pcgs_sweep.py NAME=path/to/pcgs.cu [NAME=...] \
        [--pcgs NAME,...] [--rounds 2] [--json out.json]

Each NAME=path is one source of the kernel (its directory must hold the
`philox.cuh` it includes). Each is compiled by nvcc with the flags of
`ops/_build.py` into a library of its own, and swapped in under the port's
wrappers (`ops/cuda_pcgs.py`) for its turn. The wrappers are timed with
`chip_smoke.time_ms` on the operands of `chip_smoke.py`'s `[3 adlda sweep]`
(collapsed mode) and `[3 pcgs]` (PCGS mode) timings: the synthetic 20NG
corpus at K=100 on the resident layout and at K=200 on the streamed one,
the same operands for every source. The collapsed mode is timed for every
source, the PCGS mode for those named by --pcgs (default: all). In each
round the sources run first to last, then last to first, so each has as
many early turns as late ones. Nothing is checked but that every launch
succeeds: a source whose chain differs from the committed kernel's may be
timed as well. Prints one line per mode and shape with each source's
median and its samples, the card's name and power limit, and writes every
sample to the --json file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

ENTRY_POINTS = ("lda_pcgs_sweep", "lda_pcgs_collapsed_sweep")


def build_all(sources: dict[str, str], out_dir: str) -> dict[str, str]:
    """One nvcc per source, all started together. Returns name -> .so."""
    from ldagroupedgibbssampler_tpu_torch.ops import _build
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs, libs = {}, {}
    for name, src in sources.items():
        lib = os.path.join(out_dir, f"libpcgs-{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I",
               os.path.dirname(os.path.abspath(src)), "-o", lib, src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
        libs[name] = lib
    for name, p in procs.items():
        log = p.communicate()[0]
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: rc {p.returncode}; {' | '.join(regs)}",
              flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
    return libs


def load(path: str) -> ctypes.CDLL:
    from ldagroupedgibbssampler_tpu_torch.ops import _build
    lib = ctypes.CDLL(path)
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def operands(torch, corpus, LDAConfig, create_model, scheme, k, layout):
    """The wrapper call that chip_smoke.py times for `scheme` at K=k:
    (fn, args, kw)."""
    model = create_model(chip_smoke.pcgs_config(LDAConfig, scheme, k))
    model.add_instances(corpus)
    chip_smoke.check(model._mode == layout,
                     f"{scheme} K={k}: layout {model._mode}")
    st, dev = model.state, model.device
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    if scheme == "adlda":
        gen = torch.Generator(device=dev)
        gen.manual_seed(k + 2)
        _, counts, nk_plus = chip_smoke.collapsed_entry(torch, model, gen)
        table = model._ndk_table(st.ndk, st.alpha, None)
        return model._sweep_call(st.z, table, counts, seed, None,
                                 nk_plus=nk_plus, beta=st.beta)
    doc_sel = (torch.arange(chip_smoke.D, device=dev) % 5) != 0
    table = model._ndk_table(st.ndk, st.alpha, doc_sel)
    return model._sweep_call(st.z, table, st.phi.T.contiguous(), seed, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", metavar="NAME=PATH")
    ap.add_argument("--pcgs", default=None,
                    help="comma-separated sources to time in PCGS mode too "
                         "(default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sources = dict(s.split("=", 1) for s in args.sources)
    pcgs_names = (list(sources) if args.pcgs is None
                  else [n for n in args.pcgs.split(",") if n])

    import torch
    if not torch.cuda.is_available():
        print("time_pcgs_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
    from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
    from ldagroupedgibbssampler_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[env] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = {name: load(path) for name, path in build_all(
        sources, os.path.join(ROOT, "build", "pcgs_timing")).items()}
    print(f"[build] {len(libs)} sources in {time.perf_counter() - t0:.1f} s",
          flush=True)

    corpus = chip_smoke.synth_corpus(Corpus)
    library = _build.library
    results = []
    try:
        for mode, scheme, names in (("collapsed", "adlda", list(sources)),
                                    ("pcgs", "pcgs", pcgs_names)):
            if not names:
                continue
            for k, layout in chip_smoke.PCGS_LAYOUTS:
                fn, fargs, kw = operands(torch, corpus, LDAConfig,
                                         create_model, scheme, k, layout)
                samples = {name: [] for name in names}
                order = []
                for _ in range(args.rounds):
                    order += names + names[::-1]
                for name in order:
                    _build.library = lambda lib=libs[name]: lib
                    samples[name].append(chip_smoke.time_ms(
                        torch, lambda: fn(*fargs, **kw)))
                _build.library = library
                med = {n: float(np.median(s)) for n, s in samples.items()}
                print(f"[{mode} K={k} {layout}] " + "; ".join(
                    f"{n} {med[n]:.4f} ms "
                    f"({', '.join(f'{x:.4f}' for x in samples[n])})"
                    for n in names) + f" | {smi}", flush=True)
                results.append({"mode": mode, "K": k, "layout": layout,
                                "order": order, "samples": samples,
                                "median_ms": med})
                del fn, fargs, kw
                torch.cuda.empty_cache()
    finally:
        _build.library = library
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "sources": sources, "results": results},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
