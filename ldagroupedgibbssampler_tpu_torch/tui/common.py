"""Shared scaffolding for the secondary CLI drivers.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/common.py`.
Every reference tui main repeats the same prologue (tui/BM25Search.java:9-67,
tui/XValidationCreator.java:3-46, tui/ParallelLDATrainTest.java:26-75):
parse CLI -> parse INI -> for each run × subconfig: make a RunSuite log dir,
load the dataset, hand off to the driver body. `iterate_runs` factors that
out; each driver supplies only its body. The drivers run on the config's
`device` (default "cuda", an error without a CUDA device; `--device=cpu`
or INI `device = cpu` for the CPU).
"""

from __future__ import annotations

import time

from ldagroupedgibbssampler_tpu_torch.config import parse_args, parse_ini
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus import load_dataset
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import RunLogger


def load_configured_dataset(cfg: LDAConfig, vocab=None):
    """loadInstancesKeep / loadInstancesPrune dispatch on tfidf_vocab_size
    (e.g. tui/BM25Search.java:71-78). The tokenizer choice is the JAX
    package's `tui/common.py` expression, which gives keep_numbers
    precedence, not `corpus/tokenizer.py::tokenizer_mode`: the drivers
    load the corpora the JAX drivers load."""
    return load_dataset(
        cfg.dataset, stoplist_path=cfg.stoplist,
        rare_threshold=cfg.rare_threshold,
        tfidf_vocab_size=cfg.tfidf_vocab_size, file_regex=cfg.file_regex,
        tokenizer_mode="numeric" if cfg.keep_numbers else (
            "connector" if cfg.keep_connecting_punctuation else "simple"),
        max_doc_tokens=cfg.max_doc_buf_size, vocab=vocab)


def iterate_runs(argv, body, program_name: str):
    """Parse args/INI and invoke `body(cfg, corpus, logger)` per
    run × subconfig. Returns the list of body results."""
    args, overrides = parse_args(argv)
    if not args.run_cfg:
        raise SystemExit(f"{program_name}: --run_cfg=<file> is required")
    parsed = parse_ini(args.run_cfg)
    results = []
    first = parsed.activate(parsed.sub_config_names()[0], overrides)
    for run in range(first.no_runs):
        for name in parsed.sub_config_names():
            cfg = parsed.activate(name, overrides)
            logger = RunLogger.create_run_suite(
                cfg.experiment_out_dir or "runs", subconfig=name)
            print(f"=== {program_name} run {run + 1}/{first.no_runs} "
                  f"subconfig [{name}] on {cfg.device} -> {logger.run_dir}")
            t0 = time.time()
            corpus = load_configured_dataset(cfg)
            print(f"Loaded {corpus.num_docs} docs, vocab {corpus.num_types} "
                  f"in {time.time() - t0:.1f}s")
            results.append(body(cfg, corpus, logger))
            logger.close()
    return results
