"""The canonical experiment driver (reference: topics/tui/ParallelLDA.java,
the shade-jar main class, pom.xml:235).

Run lifecycle mirrored from ParallelLDA.doSample (:68-330):
  parse CLI -> parse INI -> for run in no_runs: create RunSuite dir ->
  for each subconfig: load dataset -> create model (registry) -> set seed ->
  add instances (+ test instances) -> sample(iterations) -> dump artifacts
  (top words, relevance words, doc-topic means, theta estimate, phi means,
  diagnostics, vocabulary, corpus stats) -> run metadata.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/parallel_lda.py`.
Runs on the device of the config's `device` key (default "cuda"; an error
when no CUDA device is present), e.g. `--device=cpu` on a machine without
one.

Under `torchrun`, `main` starts the process group from its environment
(`parallel/mesh.py::distributed_initialize`), and a sharded scheme's
section runs with one rank per process; only rank 0 writes the run
directory (the other ranks log to a `NullRunLogger` and run the same
collectives). In one process a sharded section runs as a 1-rank mesh.

Usage:
    python -m ldagroupedgibbssampler_tpu_torch.tui.parallel_lda \
        --run_cfg=plda-cats-test.cfg [--scheme=ggs --device=cpu ...overrides]
    torchrun --nproc_per_node=2 -m \
        ldagroupedgibbssampler_tpu_torch.tui.parallel_lda --run_cfg=...
"""

from __future__ import annotations

import os
import signal
import sys
import time

import torch.distributed as dist

from ldagroupedgibbssampler_tpu_torch.config import parse_args, parse_ini
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus import load_dataset
from ldagroupedgibbssampler_tpu_torch.corpus.tokenizer import tokenizer_mode
from ldagroupedgibbssampler_tpu_torch.evaluation.diagnostics import (
    topic_diagnostics_csv)
from ldagroupedgibbssampler_tpu_torch.evaluation.topwords import (
    top_relevance_words, top_words)
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (
    distributed_initialize)
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import (
    NullRunLogger, RunLogger)
from ldagroupedgibbssampler_tpu_torch.utils.tee import tee_console


def run_subconfig(cfg: LDAConfig, logger: RunLogger, common_seed: int,
                  model_holder: list | None = None):
    """One subconfig run (ParallelLDA.java:144-267)."""
    t_load = time.time()
    corpus = load_dataset(
        cfg.dataset, stoplist_path=cfg.stoplist,
        rare_threshold=cfg.rare_threshold,
        tfidf_vocab_size=cfg.tfidf_vocab_size, file_regex=cfg.file_regex,
        tokenizer_mode=tokenizer_mode(cfg.keep_numbers,
                                      cfg.keep_connecting_punctuation),
        max_doc_tokens=cfg.max_doc_buf_size)
    print(f"Loaded {corpus.num_docs} documents, vocab {corpus.num_types}, "
          f"{corpus.num_tokens} tokens in {time.time()-t_load:.1f}s")

    cfg = cfg.replace(seed=common_seed)
    model = create_model(cfg, logger=logger, verbose=True)
    if model_holder is not None:
        model_holder.append(model)
    model.add_instances(corpus)
    if cfg.test_dataset:
        test = load_dataset(cfg.test_dataset, stoplist_path=cfg.stoplist,
                            vocab=corpus.vocab)
        model.add_test_instances(test)

    t0 = time.time()
    model.sample(cfg.iterations)
    elapsed = time.time() - t0
    print(f"Execution time: {elapsed:.1f}s "
          f"({model.state.iteration} iterations on {model.device})")

    _dump_artifacts(model, corpus, cfg, logger)
    logger.save_metadata(cfg, extra={"execution_seconds": elapsed,
                                     "tokens": corpus.num_tokens})
    return model


def _dump_artifacts(model, corpus, cfg: LDAConfig, logger: RunLogger):
    """Post-run artifact dump (ParallelLDA.java:210-302)."""
    vocab = corpus.vocab
    tw = top_words(model.get_topic_type_counts(), vocab, cfg.no_top_words)
    logger.save_lines("TopWords.txt",
                      [f"Topic {k}: " + " ".join(ws)
                       for k, ws in enumerate(tw)])
    rel = top_relevance_words(model.get_phi(), vocab, cfg.no_top_words,
                              cfg.lambda_relevance)
    logger.save_lines("RelevanceWords.txt",
                      [f"Topic {k}: " + " ".join(ws)
                       for k, ws in enumerate(rel)])
    if cfg.save_doc_topic_means:
        logger.save_matrix_csv(cfg.doc_topic_mean_filename,
                               model.get_zbar())
    if cfg.save_doc_theta_estimate:
        logger.save_matrix_csv(cfg.doc_topic_theta_filename,
                               model.get_theta_estimate())
    if cfg.save_phi_means:
        pm = model.get_phi_means()
        if pm is not None:
            logger.save_matrix_csv(cfg.phi_mean_filename, pm)
    if cfg.save_phi:
        logger.save_matrix_csv("phi.csv", model.get_phi())
    if cfg.save_vocabulary:
        logger.save_lines(cfg.vocabulary_filename, vocab)
    if cfg.save_term_frequencies:
        freqs = corpus.type_frequencies()
        logger.save_lines(cfg.term_frequencies_filename,
                          [f"{vocab[i]}\t{int(freqs[i])}"
                           for i in range(len(vocab))])
    if cfg.save_doc_lengths:
        logger.save_lines(cfg.doc_lengths_filename,
                          [str(int(x)) for x in corpus.doc_lengths()])
    if cfg.save_corpus:
        # integer corpus dump, one doc per line (LDAUtils.extractCorpus
        # :2073)
        lines = []
        for d in range(corpus.num_docs):
            s, e = corpus.doc_offsets[d], corpus.doc_offsets[d + 1]
            lines.append(",".join(str(int(t))
                                  for t in corpus.tokens[s:e]))
        logger.save_lines("corpus.txt", lines)
    # topic diagnostics CSV (TopicModelDiagnosticsPlain, ParallelLDA.java
    # :219-225)
    logger.save_lines("topic_diagnostics.csv",
                      topic_diagnostics_csv(model, corpus))


def main(argv=None):
    args, overrides = parse_args(argv)
    if not args.run_cfg:
        raise SystemExit("--run_cfg=<file> is required")
    parsed = parse_ini(args.run_cfg)

    models = []

    def _abort_handler(signum, frame):
        # graceful shutdown hook (ParallelLDA.java:80-101)
        print("Abort requested — draining samplers...", file=sys.stderr)
        for m in models:
            m.abort()

    signal.signal(signal.SIGINT, _abort_handler)

    base_global = parsed.activate(parsed.sub_config_names()[0], overrides)
    # under torchrun: one rank per process (a no-op in one process)
    started = distributed_initialize(device=base_global.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    no_runs = base_global.no_runs
    for run in range(no_runs):
        for name in parsed.sub_config_names():
            cfg = parsed.activate(name, overrides)
            common_seed = cfg.effective_seed()
            if rank != 0:
                run_subconfig(cfg, NullRunLogger(), common_seed,
                              model_holder=models)
                continue
            out_dir = cfg.experiment_out_dir or "runs"
            logger = RunLogger.create_run_suite(out_dir, subconfig=name)
            print(f"=== run {run + 1}/{no_runs} subconfig [{name}] "
                  f"scheme={cfg.scheme} -> {logger.run_dir}")
            # console capture into the run dir (TeeStream,
            # tui/ParallelLDA.java:152-157)
            with tee_console(os.path.join(logger.run_dir, "console.txt")):
                run_subconfig(cfg, logger, common_seed, model_holder=models)
            logger.close()
    if started:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
