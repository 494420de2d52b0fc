#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port
(ldagroupedgibbssampler_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--parent DIR]

(--parent: a checkout of another commit, e.g. the parent unpacked with
`git archive`; `[3 alias-mh]`, `[3 hdp]`, `[3 polya-urn]`, `[3
vs-dirichlet]` and `[3 pairwise]` then also time its z-step, its table
counts, psi and a single-stepped ppu_hdplda iteration, its Polya-Urn
rows, its VS rows and its uber, ks, js, canberra, chebychev, jaccard and
manhattan kernels beside this checkout's, in turns, with
tools/time_kernel_builds.py.)

Phases (each prints one line; any failure raises and exits non-zero):
  1. environment: card name and power limit (nvidia-smi), torch and CUDA;
  2. build: compiles csrc/*.cu through ops/_build.py and the native corpus
     builders (native/*.cpp, g++) through corpus/_native_build.py, and
     reports the times;
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
     rounding tie, and two seeded one-token cases (the lane kernel at
     K=100, the shared-memory kernel at K=300) on which the count,
     without the zero-run repair, draws a zero-probability topic.
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
     wherever z is held to a plain version at 99.9% agreement, the tokens
     that differ must be proven rounding ties (for the z-draw each such
     token, for the sweeps each differing document's first token, for the
     one-warp collapsed chain its first differing token), and the z-draw
     also runs at K=4096 (`[3 zdraw K=4096]`: its time beside its bound
     on the whole corpus, agreement on the first 8 blocks);
     `[3 gamma]`, the Gamma and Dirichlet kernels (csrc/gamma.cu) at the
     ggs K=100 shapes (theta [D, K] from counts + 0.5, phi [V, K] from
     counts + 0.01 normalised over V): the Gamma kernel against
     gamma_reference (the kernel's own Philox words) on every element,
     within 1e-5 on 99.9% and every other element a proven accept/reject
     tie, the Dirichlet kernels against the kernel's Gamma draws floored
     and normalised, sums and floor, and the same for the long-row
     Dirichlet at the PCGS family's phi [K, V] (N_kw + 0.01, rows split
     across blocks); on shapes 0 to 1e4 the same
     agreement on 100,000 elements, a KS test of 200,000 draws against
     scipy.stats.gamma and the exact 0 at shape 0; times beside the plain
     version, the eager generator path it replaced, torch._standard_gamma
     and torch._sample_dirichlet; the lane-rounds an element of the
     elementwise kernel (needed, in warps of 32 without compaction, with
     the queue of rejects); `[3 left-to-right]`, the held-out
     estimator kernel (csrc/left_to_right.cu) at the [4 held-out] shapes,
     K = 100 and 4096: draws equal to left_to_right_reference on the
     first 64 test documents but proven ties (the exact cdf within 4
     sqrt(K) 2^-24 T of u T), the total within 1e-5, a seeded case on
     which the kernel's walk, unrepaired, draws a zero-product topic, ten
     kernel seeds' mean within 5 standard errors of five seeds of the
     plain generator= estimator on the whole split, times and peak
     memory; `[3 alias-mh]`, the alias-MH z-step kernels
     (csrc/alias_mh.cu) on a ggs_aliasmh state at K=100 and K=4096, 2
     rounds, an asymmetric alpha, the even documents selected and every
     document: z equal to alias_mh_reference on every slot in both table
     modes but proven ties, the rates from the kernel's acceptance counts
     equal, the entry z untouched, packed equal to unpacked, the pack
     kernel bit-equal to pack_reference, an MH-invariance chi-square,
     times of both selections beside the plain versions, torch.stack and
     the bounds, ptxas's registers; `[3 hdp]`, the table-count and psi
     kernels (csrc/hdp.cu) on a ppu_hdplda K_max=100 chain after 10
     iterations: the table counts equal to the plain version on the same
     Philox words in both instances (two launches each; and for hlda's
     scalar concentration), ge equal to the eager bincount path, the
     scratch left zero, the same at K=4096 (the global instance), the
     first launch's blocks an SM and ptxas's registers,
     psi on the chain's tables and, at K_max=4096 on synthetic inputs,
     for every birth rule, psi sampler and index prior (and at K = 37,
     700 and 5000 for three of them): births and the active mask exact,
     psi and alpha within 1e-5, also as the table counts' dependent
     launch at K=100 and 4096, its launch's geometry, and one HDP step
     under the profiler (one randint; psi right after the table counts'
     second launch on the stream); the elementwise
     Binomial kernel equal to its plain version and KS against
     torch.binomial; `[3 polya-urn]` (csrc/polya_urn.cu, two launches,
     the draws' 32-column groups dealt over a one-wave grid): the rows at
     [100, 20,000] (that chain's N_kw, with and without its active mask),
     [200, 20,000], f32 counts on [13, 37] and [3, 4,100], and [2,
     300,000] equal to the plain version, two launches each, the counts
     against torch.poisson, the draw launch's grid with its blocks an SM,
     ptxas's registers, the elementwise Poisson kernel on a grid of rates;
     `[3 vs-dirichlet]` (csrc/vs_dirichlet.cu, a row a cluster of 8
     blocks): the inclusion pattern equal to the plain version's but
     proven ties, values within 1e-5, the cluster geometry and ptxas's
     registers;
     each timed beside its plain version, the eager path it replaced and
     its bound; `[3 pairwise]` (csrc/pairwise.cu): the seven elementwise
     metrics (manhattan, chebychev, canberra, jaccard, js, ks, uber) on
     Dirichlet(0.1) rows with ~30% exact zeros against their plain
     versions (the tiled blocks of similarity/distances.py) on the card,
     chebychev and ks bit-equal, the rest within 1e-5, at 5,635 x 5,634 x
     100 (the 20NG test x train matrix), 512 x 512 x 4096, 301 x 203 x 37
     and edge rows (identical, disjoint, all-zero and tied pairs, a 1 x 1
     Distance.calculate), ks also on the early end's edge rows at K=100
     and 4096, canberra, js, manhattan, chebychev and jaccard also on rows
     that send some blocks off their fast paths (a negative value, NaN,
     inf, 2^40) beside blocks on them with subnormal values, manhattan,
     chebychev and jaccard also on rows with an inf at one coordinate of
     both (NaN where the plain version has it), manhattan bit-equal to
     its two-level sum's emulation (unsplit at the first shape: the
     parent kernel's sum), and the scaled division (uber's and
     canberra's) bit-equal to __fdiv_rn on every tame term; at the first
     shape and on its first 256 rows (uber, ks, js, canberra, chebychev,
     jaccard and manhattan also at 512 x 512 x 4096) each kernel's time
     alone and
     with its call, its
     plain version's, the torch.cdist time for manhattan and chebychev,
     the bound (ks's from the merge steps the rows need, js's closed form
     beside its logf a term), the peak memory a call adds, ptxas's
     registers and spills and uber's blocks an SM;
  4. the main paths on that corpus on cuda, each with its launch counters
     set to 0 just before it and read just after: LDAGroupedGibbsSampler
     (ggs), schemes pcgs, lightpclda and adlda at K=100, 30 iterations
     with the likelihood every 10 (exact recounts, rising likelihood,
     tokens/s, a profile; for ggs the Dirichlet kernels' launches checked,
     3 an iteration and 3 at set-up, at most 4 Gamma-kernel launches an
     iteration under the profiler, and the profile repeated with the eager
     generator draws the kernels replaced), then pcgs at K=200 (streamed layout), polyaurn
     at K=100, lightpcldaw2 and lightcollapsed at K=100, lightpclda and
     adlda at K=200 (streamed), 10 iterations each; then `[4 adlda
     oracle]`, adlda on the first 2,000 documents with the parallel and
     the one-warp launch from one seed (likelihood gap under 0.5% at
     iteration 30), beside the spread of three parallel chains' gaps and
     of three one-warp chains from three seeds; `[4 ggs_aliasmh main
     path]`, scheme ggs_aliasmh at K=100 for 30 iterations (the count
     kernel on both layouts and the alias-MH pre-pass, rounds and pack
     kernels every iteration) with a profile, and `[4 ggs_aliasmh
     K=4096]`, ggs_aliasmh packed and unpacked beside dense ggs at
     K=4096, 10 iterations each; `[4 ppu_hdplda main path]`, scheme ppu_hdplda at
     K_max=100 (the JAX package's 20NG HDP configuration) for 30
     iterations with a profile (a finite likelihood, which falls while
     topics are born as in the JAX package's chain; the active topics at
     10, 20 and 30; inactive topics with alpha 0, zero phi rows and no
     token), then ppu_hlda at K=100 (10 iterations),
     ppu_hdplda_all_topics at K=100 (30, the likelihood rising from 10 to
     30), spalias_priors (10 topics anchoring 5 of the most frequent
     words each: phi exactly 0 and no token on a masked pair) and
     nzvsspalias at K=100, and nzvsspalias at K=200 (streamed), 10
     iterations each, the draw kernels' launches counted on each run
     (and on polyaurn's) and each HDP, polyaurn and nzvsspalias profile
     held free of torch.binomial and torch.poisson kernels beside the
     same iterations on the eager path they replaced; and
     `[4 held-out]`, ggs K=100 on the 90% split of a 10%
     build_perplexity_split, 30 iterations with the held-out LL every 10
     (the training series equal to the same seed's without a test set;
     the estimator kernel launched twice an evaluation;
     one evaluation timed and profiled against a ggs iteration; the
     estimator on cuda against cpu given the same noise; the count phi
     against a uniform phi), then the test documents' first halves folded
     in on the z-draw (precise mode) and count kernels; `[4 held-out
     K=4096]`, ggs_aliasmh beside dense ggs at K=4096 on the same split,
     the held-out LL at 10 and 20; `[4 base options]`, ggs K=100 plain,
     with each base option alone and with all of them (hyperopt, the
     mixed Mandelbrot/delta-N topic index builder, topic batches of 0.5,
     paranoid checks, phi means, doc-topic distances, measure_timing),
     then pcgs with a delta-N builder and paranoid checks, 10 iterations
     each, ms/iteration against plain;
     `[4 collapsed]`, the serial oracle on the first 100 documents;
     `[4 fused]`, iteration fusion (scan_chunk 9, the largest group
     between likelihood events every 10) against single-stepping from one
     seed: ggs, pcgs, lightpclda, adlda and ggs_aliasmh at K=100 for 30
     iterations, pcgs, lightpclda and adlda at K=200 (streamed) and dense
     ggs at K=4096 for 10: z, n_dk, N_kw, n_k, phi and theta bit-equal
     (adlda's parallel launch differs between two runs of one chain, so
     its pairs hold the likelihood within 0.5% and `[4 fused adlda
     one-warp]` holds the one-warp launch bit for bit), the likelihood
     series and the launch counters equal, ms/iteration in turns, device
     busy under the profiler single-stepped and over replays of a captured
     group, peak memory and capture time; ggs with random scan over
     documents; every other fusable scheme for 10 iterations; the serial
     oracle's groups run single-stepped; and one single-stepped iteration
     of every fusable scheme under set_sync_debug_mode("error");
     `[4 sample_chunked]`, the GGS family's multi-iteration path (one
     CUDA graph of 10 full sweeps captured once per model and chunk, kept
     across calls): sample_chunked(30, chunk=10) of ggs and ggs_aliasmh at
     K=100 and sample_chunked(10) of ggs at K=4096 bit-equal to a twin's
     sample() with scan_chunk 10 (z, n_dk, N_kw, n_k, phi, theta, the
     iteration), launches equal and counted from 0, counts exact; 25
     iterations in chunks of 10 advance 30; a sample() between two chunks
     honoured; three sample_chunked calls and five calls of one
     _multi_step_fn(10) callable capture once (its warm-up step and
     capture + instantiation in host seconds), the replay's ms/iteration
     by CUDA events and host wall, bench.py's tokens/s formula over
     _multi_step_fn(10) and (30) as a preview, a new beta recaptured; the
     getters; a pre_z hook unfused and called once an iteration; and
     log_dirichlet at theta's [D, K] and phi's [K, V] against the
     Dirichlet kernel's draw from the same generator state (1e-5);
  5. the experiment CLI (tui.parallel_lda.main) on a small text corpus on
     cuda, with a ggs, a pcgs, a lightpclda, an adlda, a ggs_aliasmh, a
     spalias_priors (with its prior file) and a ppu_hdplda section; then
     (`[5 cli held-out]`) with a test_dataset and every base option in a
     ggs and a pcgs section, each artifact checked;
  6. the apps (`[6 apps]`) on cuda: `[6 similarity]`, LDADistancer
     (spalias, K=100) trained on the train half of a 2-fold split of the
     same corpus for 30 iterations and distance() of the test half (5,635
     x 5,634 symmetric KL) after 200 fold-in iterations, the launches of
     rows 1-3 checked (201 counts, 200 z-draws, 30 PCGS sweeps), the kl
     matrix against the CPU on its first 256 rows, every metric against
     the CPU on 32 rows and timed on 256, the products with TF32 on and
     off, then the 5,635 x 5,634 matrix of each of the seven elementwise
     metrics through Distance(name).pairwise, timed, one launch of its
     pairwise kernel a call (the counters set to 0 just before, read just
     after), and distance() with ks through the whole app, timed (201
     counts, 200 z-draws, 1 KS launch); `[6 bm25]`, BM25Searcher on the train half searched against
     itself (top 2), the first 256 rows against the CPU; `[6 classify]`,
     KLDivergenceClassifier.cross_validate (2 folds, 30 training and 300
     fold-in iterations) on the corpus labelled d % 20, its launches
     checked; `[6 cli apps]`, the seven secondary drivers' main (the KL
     classifier also with --multi_corpus) on phase 5's text corpus, every
     artifact checked, the KL classifier's accuracy >= 0.8 and the nearest
     training document of the same theme on >= 80% of test documents;
     each part with its seconds and peak memory;
  7. the sharded schemes on torch.distributed (`[7 parallel]`), each rank
     a process spawned once a run, which loads the kernels phase 2 built:
     all five (sharded_ggs, vocab_sharded_ggs, sharded_adlda, sharded_pcgs,
     sharded_uncollapsed) at 2 gloo ranks sharing cuda:0, then sharded_ggs
     and vocab_sharded_ggs at 1 NCCL rank (its n_dk all-reduce in int16),
     10 iterations each at K=100 on the whole corpus, with the launch
     counters set to 0 just before and read just after (rows 2 and 1, or
     row 3, once an iteration a rank, and the Dirichlet kernels' 3 or 2):
     the likelihood at 0 and 10, the
     exact recount of the gathered z against the merged counts, every
     replicated tensor bit-equal across the ranks, the GGS kernels at a
     rank's shapes against their plain versions, ms/iteration and the
     all-reduce's ms (CUDA events) and bytes an iteration; then
     `[7 sharded_adlda oracle]`, sharded_adlda at 2 ranks on the first
     2,000 documents for 30 iterations with each rank's parallel launch
     against the one-warp launch from one seed (gap under 0.5%), beside
     the single-device one-warp chain of `[4 adlda oracle]`. A rank that
     fails, or a run past its deadline, fails the script;
  8. ingestion and the sweeps at the NYTimes shape (`[8 ingest]`): a UCI
     text file of D=300,000 documents, V=102,660 pseudo-words of 3-12
     letters, Zipf 1.1, Poisson(333) lengths (at least 5), seed 1
     (~100M tokens, ~860 MB), synthesised in vectorised chunks and read
     by `load_dataset` (the native C++ tokenizer); then
     `create_model(cfg).add_instances(corpus).sample(n)` for ggs K=100
     with doc_span 1024 (the native cell blocks; rows 2 and 1) and pcgs
     K=100 (the streamed layout: the native stream blocks and row 4), 1 +
     5 iterations each with the launch counters set to 0 just before and
     read just after: the synthesis, tokenizer and builders' seconds, the
     native call counters (each at least 1), ms/iteration over 5, the
     device-busy share, slots, peak memory on the card and the host,
     exact recounts of N_kw, n_dk and n_k on the whole corpus; rows 2 and
     1 against their plain versions on the first 8 blocks and row 4 on
     the first d-window's documents cut to the first 8 blocks (with the
     tie proofs), and each timed on the whole layout beside its bound;
     native against Python / NumPy, bit-equal, on a 2M-token prefix
     (tokenizer, cell blocks, stream blocks), with both paths' seconds.
     Phase 3's `[3 layout]` builds the 20NG cell blocks natively (1.35M
     tokens, above the 1M switch) and with NumPy, bit-equal, and prints
     both seconds;
  9. the chain-level checks (`tools/card_geweke_check.py`,
     `tools/card_bf16_gate.py`): `[9 geweke]`, every Geweke chain of
     `card_geweke_check.CHAINS` at its CPU test's length (D=6, L=8, V=8,
     K=2; K_max 4 for the HDP chains), GEWEKE_JOBS spawned processes
     sharing the card, one line a chain with its statistics, steps and
     seconds; a chain that misses its bar, or whose named launch counters
     did not rise over its sample(1) calls, fails; then `[9 bf16 gate]`,
     one bf16 `ggs` chain and 6 precise seeds at K=100 on the synthetic
     20NG corpus (200 iterations, the held-out LL by the left-to-right
     kernel), one line a statistic with its predictive interval; a failed
     gate fails the script;
 10. the large-K quality study (`tools/card_largek_quality.py`,
     `[10 largek]`) on the synthetic 20NG corpus at K=4096, alpha 50/K:
     A, the bf16 gate (one bf16 `ggs` chain at seed 6 against precise
     seeds 1-5, 200 iterations); B, dense `ggs` against `ggs_aliasmh` at
     1, 4 and 16 rounds (seed 2019, 200 iterations); C, both schemes on
     the 90% split at seeds 1-3 for LARGEK_ITERS_C iterations, then the
     held-out LL (256 documents, 20 particles); one line a chain, check
     and summary. A failed gate, an LL that is not finite, a trajectory
     that did not rise from its first reading to its last, or a chain
     whose scheme's launch counters did not move, fails the script;
 11. the PubMed-scale rehearsal (`tools/card_pubmed_rehearsal.py`,
     `[11 pubmed]`) at its defaults: the JAX script's synthetic PubMed
     subsample (V=141,043, 10% of PubMed's tokens, seed 7), whose size
     must be PUBMED_REHEARSAL.json's (else numpy draws another corpus,
     and the phase fails saying so); the partition over 8
     vocabulary-sharded ranks, whose token counts, imbalance and
     13 B-a-slot bytes a token must equal the record's; vocab_sharded_ggs
     at 8 gloo ranks sharing the card on the first 10% of the documents
     and ggs on one card on the whole subsample, doc_span 1024, 1 + 2
     iterations each, with exact recounts, every rank exiting 0 before
     its deadline, and the z-draw, count and Dirichlet kernels launched
     in each arm and on each rank; one line an arm with its seconds, peak
     GiB on the card and the host and ms an iteration.
Then one JSON line describing every kernel (gamma, left_to_right,
alias_mh_rounds, alias_mh_pack, hdp_table_counts, hdp_psi, polya_urn and
vs_dirichlet among them, the last four with their launches in every run
of phase 4 as `launches_by_run`; pairwise_elementwise and pairwise_ks
with `[3 pairwise]`'s numbers at the 20NG shape (the elementwise entry
manhattan's, every metric under `metrics`) and their launches in `[6
similarity]` by part as `launches_apps`; the counts, z-draw and gamma entries
with the launches of
`[4 sample_chunked]`'s ggs K=100 run as `launches_chunked`, the gamma
entry its capture and replay numbers as `chunked`; the counts, z-draw and PCGS
entries with their launches in phase 6 as `launches_apps`, every entry
with its launches in phase 7 as `launches_parallel` and in phase 11 as
`launches_pubmed`; the counts, z-draw
and streamed PCGS entries with phase 8's launches by scheme as
`launches_ingest` and their numbers at that shape as `ingest`), the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false or when the port's package is not beside it.
"""

from __future__ import annotations

import functools
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from tools.synth_corpus import D, V, synth_corpus

K = 100
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
# per SM and clock, 64 32-bit integer lanes and 16 special-function lanes
# (Hopper architecture white paper), at the 1.98 GHz of the f32 peak
# (132 SMs x 128 lanes x 2 x 1.98 GHz = 67 TFLOP/s)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SFU_OPS_PER_S = 132 * 16 * 1.98e9
ITERS = 30
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


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


def once_ms(torch, fn):
    """Device time of one call of a slow plain version (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def bound(nbytes: float, nops: float, int_ops: float = 0.0,
          sfu_ops: float = 0.0):
    """The least time (ms) for nbytes of traffic and the f32, 32-bit
    integer and special-function operations, each at its peak rate, and
    which of bytes and operations sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(nops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S,
                sfu_ops / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_counts_exact(model, corpus, label: str):
    """N_kw, n_dk and n_k of the model's state equal a host recount of its
    z (get_z_indicators)."""
    nkw_ref, ndk_ref = recount(corpus, model.get_z_indicators(),
                               model.config.topics)
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
    return profile_calls(torch, lambda: model.sample(n), n, "iteration")


def profile_numbers(torch, fn, n: int):
    """(host wall ms, device busy ms, [(ms, kernel name, launches)]) per
    unit of `fn()`, which does `n` units of work, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type != torch.autograd.DeviceType.CPU:
            rows.append((us / 1e3 / n, e.key, e.count / n))
    return wall, sum(ms for ms, *_ in rows), rows


def profile_summary(wall, busy, rows, unit: str) -> str:
    """Host wall and device busy ms a unit, the busy share, the distinct
    kernels and their launches a unit."""
    return (f"{wall:.3f} ms/{unit} host wall, device busy {busy:.3f} "
            f"ms/{unit} ({100 * busy / wall:.1f}%), {len(rows)} kernels, "
            f"{sum(c for *_, c in rows):.1f} launches/{unit}")


def profile_calls(torch, fn, n: int, unit: str) -> str:
    """Device time by kernel of `fn()`, which does `n` `unit`s of work
    (torch.profiler), against its host wall time."""
    return profile_text(*profile_numbers(torch, fn, n), n, unit)


def profile_text(wall, busy, rows, n: int, unit: str) -> str:
    """profile_numbers' results as one line, with the top kernels."""
    if busy == 0:
        return (f"{n} {unit}s, {wall:.3f} ms/{unit}; the profiler saw "
                "no device time")
    rows.sort(reverse=True)
    top = "; ".join(f"{ms:.3f} ms {name[:70]}" for ms, name, _ in rows[:8])
    return (f"{n} {unit}s: {profile_summary(wall, busy, rows, unit)}; "
            f"top: {top}")


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
    plain version on >= 99.9% of tokens, each differing token a proven
    rounding tie (zdraw_ties: the "… ties" entries count them), N_kw is
    the histogram of z, padding keeps z. Returns a summary for the
    [3 zdraw] line."""
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
            agree[f"{name} ties"] = zdraw_ties(
                torch, f"z-draw K={k} ({name})", zk, zr, args, kw, u,
                precise)
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


def zdraw_large_k_full(torch, zargs, zkw, real_slots, blocks, n_tok, gen,
                       cuda_zdraw, rnd, k=4096, nb_check=8):
    """[3 zdraw K=4096]: the z-draw at dense ggs's large K on the whole
    corpus's layout A, every document selected: its time beside its bound
    (bytes / 3.35 TB/s against f32 operations / 67 TFLOP/s, as at K=100),
    and, on the first `nb_check` blocks (the plain version gathers a
    [slots, K] row per slot, 49 GB over all of them), z against the plain
    version in both precision modes with injected and Philox uniforms:
    agreement >= 0.999 in bf16 mode and >= 0.99 in precise mode (f32 sums
    of 4096 products in two associations), every differing token a proven
    rounding tie,
    N_kw of the kernel's z its histogram. Returns the kernels-line
    numbers."""
    dev = torch.device("cuda", 0)
    w3, d3, z_old, _, _, seed, winb, firstb, windc = zargs
    nb, chunks, chunk = w3.shape
    theta = rnd.dirichlet(torch.rand((D, k), generator=gen, device=dev)
                          * 20 + 0.5, gen)
    phi = rnd.gamma(torch.rand((V, k), generator=gen, device=dev) * 5
                    + 0.01, gen).clamp_min(rnd.DIRICHLET_FLOOR)
    phi = (phi / phi.sum(dim=0, keepdim=True)).contiguous()
    z_k = torch.where(w3 < zkw["vspan"], z_old * (k // K), 0).contiguous()
    kw = dict(zkw, num_topics=k)
    args = (w3, d3, z_k, theta, phi, seed, winb, firstb, windc)
    sub = (w3[:nb_check], d3[:nb_check], z_k[:nb_check], theta, phi, seed,
           winb[:nb_check], firstb[:nb_check], windc[:nb_check * chunks])
    sub_slots = real_slots[real_slots < nb_check * chunks * chunk]
    u24 = torch.randint(0, 2 ** 24, tuple(sub[0].shape), generator=gen,
                        device=dev, dtype=torch.int32)
    pad = sub[0] == zkw["vspan"]
    agree = {}
    for precise in (False, True):
        for label, u in (("u24", u24), ("philox", None)):
            name = f"{label} {'precise' if precise else 'bf16'}"
            zk, nkw_k = cuda_zdraw.fused_zdraw_nkw(
                *sub, u, precise=precise, real_slots=sub_slots, **kw)
            zr, nkw_r = cuda_zdraw.fused_zdraw_nkw_reference(
                *sub, u, precise=precise, **kw)
            torch.cuda.synchronize()
            agree[name] = float((zk == zr)[~pad].float().mean())
            # bf16 products sum exactly in f32 in any order; precise
            # mode's f32 sums of 4096 terms differ by association on ~0.1%
            # of tokens, each proven a tie below
            bar = 0.99 if precise else 0.999
            check(agree[name] >= bar, f"z-draw K={k} ({name}): only "
                  f"{agree[name]:.6f} of tokens agree with the plain version")
            agree[f"{name} ties"] = zdraw_ties(
                torch, f"z-draw K={k} ({name})", zk, zr, sub, kw, u, precise)
            hist = torch.zeros_like(nkw_k)
            real = ~pad
            rows = (winb[:nb_check].long()[:, None, None] * zkw["vspan"]
                    + sub[0].long())[real]
            hist.index_put_((rows, zk[real].long()),
                            torch.ones_like(rows, dtype=torch.int32),
                            accumulate=True)
            check(torch.equal(nkw_k, hist), f"z-draw K={k} ({name}): N_kw "
                  "is not the histogram of the kernel's z")
            del zk, zr, nkw_k, nkw_r, hist
    ms = time_ms(torch, lambda: cuda_zdraw.fused_zdraw_nkw(
        *args, real_slots=real_slots, **kw), reps=5, calls=5)
    slots = w3.numel()
    nbytes = (4 * 4 * slots + 4 * (D + V) * k + 8 + 4 * 2 * nb
              + 4 * nb * chunks + 4 * blocks.nwin_w * zkw["vspan"] * k)
    b_ms, b_by = bound(nbytes, 3.0 * n_tok * k)
    check_tokens = int((~pad).sum())
    print(f"[3 zdraw K={k}] whole corpus, every document selected: "
          f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes / 1e6:.1f} MB, {3.0 * n_tok * k / 1e9:.2f} GFLOP), "
          f"{ms / b_ms:.1f}x the bound; against the plain version on the "
          f"first {nb_check} blocks ({check_tokens} tokens): z agreement "
          f"{json.dumps(agree)}, N_kw the histogram of z", flush=True)
    del theta, phi, args, sub
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "agreement": agree}


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
    index order bit-equal to longest first; where z differs, each
    differing document's first token a proven rounding tie
    (ties_at_first_disagreement; the agreement's "… ties" entries count
    the tokens and documents that differ). Returns (agreement, max |N_kw
    - plain| of the Philox run)."""
    from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24
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
        words = u if u is not None else philox_u24(seed, st.z.numel())
        agreement[f"{name} ties"] = ties_at_first_disagreement(
            torch, model, f"{label} ({name})", st.z, zk, zr, table, phi_vk,
            words)
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
    agreement["philox zero-phi ties"] = ties_at_first_disagreement(
        torch, model, f"{label} (zero-phi)", st.z, zk, zr, table, phi_zero,
        philox_u24(seed, st.z.numel()))
    check_sweep_outputs(torch, model, f"{label} (zero-phi)", st.z, zk,
                        nkw_k, tb_k, doc_sel)
    sel = (real & doc_sel[model._slot_d]).reshape(-1)
    words, drawn = model._slot_w.reshape(-1), zk.reshape(-1).long()
    on_zero = (sel & ~(phi_zero[words, drawn] > 0)).nonzero()[:, 0]
    check(on_zero.numel() == 0, f"{label}: {on_zero.numel()} draws landed "
          f"on a zero-probability topic (words "
          f"{words[on_zero[:4]].tolist()}, z {drawn[on_zero[:4]].tolist()}, "
          f"plain z {zr.reshape(-1)[on_zero[:4]].tolist()})")
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


def cdf_boundary_gap(torch, probs, u24, a, b):
    """Rows of f32 `probs` [n, K] as a kernel multiplied them, each drawn
    by u = u24 * 2^-24 * total: the largest distance, as a share of the
    total, from u to the exact (f64) cdf at a boundary between the draws
    a and b [n]. Two draws of one row that differ only by the association
    of the f32 prefix sums lie within ~1e-6 of every such boundary.
    Returns f64 [n]."""
    cdf = probs.double().cumsum(dim=1)
    total = cdf[:, -1]
    u = u24.double() * 2.0 ** -24 * total
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    topics = torch.arange(probs.shape[1], device=probs.device)
    between = (topics >= lo[:, None]) & (topics < hi[:, None])
    gap = torch.where(between, (cdf - u[:, None]).abs(), 0.0)
    return gap.max(dim=1).values / total


def zdraw_ties(torch, label, zk, zr, args, kw, u24, precise):
    """Where the z-draw kernel's z differs from the plain version's, every
    differing token (tokens are independent given theta and phi) must be
    a rounding tie: u within 2 (K - 1) 2^-24 of the total (two f32 sums of
    K positive terms in any association differ by no more; at least 1e-5)
    from the exact cdf of the products the kernel computes (the f32
    products of its bf16, or hi + lo, table values, rounded to bf16
    outside precise mode) at every boundary between the two draws.
    Returns [tokens that differ, the largest gap]."""
    from ldagroupedgibbssampler_tpu_torch.ops.cuda_zdraw import _table
    from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24
    w3, d3, _, theta, phi, seed, win_w, _, win_d_chunks = args
    nb, chunks, chunk = w3.shape
    w, d = w3.reshape(-1), d3.reshape(-1)
    idx = torch.nonzero((zk != zr).reshape(-1) & (w < kw["vspan"])
                        & (d < kw["dspan"])).flatten()
    if idx.numel() == 0:
        return [0, 0.0]
    wrow = (win_w.long()[idx // (chunks * chunk)] * kw["vspan"]
            + w[idx].long())
    drow = win_d_chunks.long()[idx // chunk] * kw["dspan"] + d[idx].long()
    probs = _table(theta, precise)[drow] * _table(phi, precise)[wrow]
    if not precise:
        probs = probs.to(torch.bfloat16).to(torch.float32)
    words = u24 if u24 is not None else philox_u24(seed, w3.numel())
    gap = cdf_boundary_gap(torch, probs, words.reshape(-1)[idx],
                           zk.reshape(-1)[idx].long(),
                           zr.reshape(-1)[idx].long())
    worst = int(gap.argmax())
    tol = max(1e-5, 2.0 * (kw["num_topics"] - 1) * 2.0 ** -24)
    check(float(gap[worst]) <= tol, f"{label}: slot {int(idx[worst])} "
          f"draws {int(zk.reshape(-1)[idx[worst]])} against "
          f"{int(zr.reshape(-1)[idx[worst]])}, "
          f"{float(gap[worst]):.2e} of its total from an exact cdf "
          "boundary: not a rounding tie")
    return [int(idx.numel()), float(gap[worst])]


def mh_ties_at_first_disagreement(torch, model, label, z_old, zk, zr, table,
                                  tw_vk, qw_vk, words):
    """The MH sweep's counterpart of ties_at_first_disagreement. At each
    differing document's first differing token, from the n_dk both had
    there, the token's four decisions are recomputed on the host in exact
    arithmetic along the exact path: the word proposal's cdf draw from
    bf16(qw), its acceptance test, the doc proposal's draw from bf16(n_dk),
    its acceptance test. One of them must lie within 1e-5 of its boundary
    (a share of the cdf total, or of the larger side of the test): else
    both f32 computations would have taken the exact path and agreed.
    `words` are the four uniforms of every slot, int32 [slots, 4].
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
    u_all = words.cpu().double() * 2.0 ** -24
    tab = table.cpu()
    bf = torch.bfloat16

    def draw(p, u):
        """(topic, margin) of the inverse-cdf draw from p [K] at u."""
        cdf = p.cumsum(0)
        x = u * float(cdf[-1])
        last = int(torch.nonzero(p > 0).max()) if bool((p > 0).any()) else 0
        kk = min(int((cdf <= x).sum()), last)
        near = [abs(float(cdf[j]) - x) for j in (kk - 1, kk) if 0 <= j < k]
        return kk, min(near) / max(float(cdf[-1]), 1e-300)

    def test(lhs, rhs):
        """(lhs < rhs, margin) of an acceptance test."""
        return lhs < rhs, abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-300)
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
        z0 = int(zo[s])
        nd32 = col.clone()
        nd32[z0] -= flag
        nd, ndq = nd32.double(), nd32.to(bf).double()
        tw = tw_vk[int(w_of[s])].cpu().to(bf).double()
        qw = qw_vk[int(w_of[s])].cpu().to(bf).double()
        u = u_all[s]
        k1, m1 = draw(qw, float(u[0]))
        take1, m2 = test(float(u[1]) * nd[z0] * tw[z0] * qw[k1],
                         nd[k1] * tw[k1] * qw[z0])
        z1 = k1 if take1 and float(qw.sum()) > 0 else z0
        k2, m3 = draw(ndq, float(u[2]))
        _, m4 = test(float(u[3]) * nd[z1] * tw[z1] * ndq[k2],
                     nd[k2] * tw[k2] * ndq[z1])
        margin = min(m1, float(m2), m3, float(m4))
        check(margin <= 1e-5, f"{label}: document {d} first differs at slot "
              f"{s} ({a} vs {b}); its closest decision is {margin:.2e} from "
              "its boundary: not a rounding tie")
    return n_tok, len(docs)


def collapsed_tie_at_first_disagreement(torch, model, label, z_old, zk, zr,
                                        table, counts_vk, nk_plus, beta,
                                        u24, num_docs):
    """The one-warp collapsed launch and the plain version are both the
    sequential chain over the first `num_docs` documents in index order,
    N_kw, V beta + n_k and n_dk live. Up to the chain's first differing
    token both saw the same counts; there, with the conditional in the
    kernel's f32 arithmetic (`_collapsed_reference`), u must lie within
    1e-5 of the total from the exact cdf at every boundary between the two
    draws. After it the chains part. Returns the slot, or None."""
    kpad = table.shape[0] - 8
    k = model.config.topics
    real = model._slot_mask
    if bool(((zk == zr) | ~real).all()):
        return None
    off = model.doc_slot_offsets.cpu().tolist()
    slots = model.doc_slots.cpu().tolist()
    zo, zk_, zr_, w_of = (t.reshape(-1).cpu().numpy() for t in
                          (z_old, zk, zr, model._slot_w))
    tab = table.cpu()
    nkw = counts_vk.cpu().to(torch.float32).clone()
    nkp = nk_plus.cpu().to(torch.float32).clone()
    beta32 = torch.tensor(beta, dtype=torch.float32)
    for d in range(num_docs):
        flag = float(tab[kpad, d])
        if flag <= 0.5:
            continue
        col = tab[:k, d].clone()
        for s in slots[off[d]:off[d + 1]]:
            z0, w = int(zo[s]), int(w_of[s])
            a, b = int(zk_[s]), int(zr_[s])
            if a != b:
                e = torch.zeros(k)
                e[z0] = flag
                p = ((col - e) * (((nkw[w] + beta32) - e) / (nkp - e)))
                p = p.to(torch.bfloat16).to(torch.float32)
                gap = float(cdf_boundary_gap(
                    torch, p[None], u24.reshape(-1)[s:s + 1].cpu(),
                    torch.tensor([a]), torch.tensor([b]))[0])
                check(gap <= 1e-5, f"{label}: the chain first differs at "
                      f"slot {s} ({a} vs {b}), {gap:.2e} of its total from "
                      "an exact cdf boundary: not a rounding tie")
                return s
            if a != z0:
                for t in (col, nkw[w], nkp):
                    t[z0] -= 1.0
                    t[a] += 1.0
    return None


def _bf16_np(x):
    """bf16 rounding (to nearest even) of float32 values, as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def lane_kernel_count(p, u24):
    """The draw of csrc/pcgs.cu's lane kernel in its pair instance (kpad
    128: 16 lanes of 8 contiguous topics a document) for one token with
    products p [K <= 128], in its own f32 association, before the zero-run
    repair: each lane sums its 8 products left to right, a Hillis-Steele
    scan over the 16 lanes gives each lane's inclusive sum, the lane's
    values are its exclusive offset plus its running sums, and z =
    min(#{values <= u24 2^-24 total}, last topic with p > 0)."""
    f32 = np.float32
    pp = np.zeros(128, f32)
    pp[: len(p)] = p
    pre = np.zeros((16, 8), f32)
    for lane in range(16):
        s = f32(0)
        for i in range(8):
            v = pp[lane * 8 + i]
            s = v if i == 0 else f32(s + v)
            pre[lane, i] = s
    incl = pre[:, -1].copy()
    off = 1
    while off < 16:
        prev = incl.copy()
        incl[off:] = (prev[off:] + prev[:-off]).astype(f32)
        off <<= 1
    excl = np.concatenate([[f32(0)], incl[:-1]]).astype(f32)
    u = f32(f32(f32(u24) * f32(2.0 ** -24)) * incl[-1])
    cnt = int(((excl[:, None] + pre).astype(f32) <= u).sum())
    return min(cnt, int(np.nonzero(pp)[0].max()))


def pcgs_zero_run_case(k=100, seed=0):
    """A one-token case on which the lane kernel's count, before the
    zero-run repair, lands on a topic whose product is 0: products p (bf16
    values, a run of zero lanes after lane a), and a u24 that puts u * total
    between lane a's inclusive sum from the scan and its last running value
    (the two associations of the same sum). Found by a seeded search over
    lane_kernel_count; returns the products, the u24, the topic the
    unrepaired count draws and a z_old with p > 0."""
    rng = np.random.default_rng(seed)
    for _ in range(100_000):
        a = int(rng.integers(1, 10))
        nz = rng.random(k) < 0.7
        nz[8 * (a + 1): 8 * (a + 2)] = False
        p = np.where(nz, _bf16_np(rng.random(k).astype(np.float32)
                                  * rng.choice([1.0, 1e-3, 1e3], k)),
                     0).astype(np.float32)
        # u * total near lane a's end: the left-to-right cumsum only sizes
        # the search window
        pre = np.cumsum(p, dtype=np.float32)
        lo = int(np.floor(float(pre[8 * a + 7]) / float(pre[-1]) * 2 ** 24))
        for u24 in range(max(lo - 64, 0), min(lo + 64, 1 << 24)):
            z = lane_kernel_count(p, u24)
            if p[z] == 0:
                return {"phi": p, "u24": u24, "unrepaired": z,
                        "z_old": int(np.nonzero(p)[0][0]), "kpad": 128}
    raise AssertionError("no zero-run tie case found")


def _hillis_steele32(x):
    """Inclusive f32 Hillis-Steele scan of 32 values, as a warp's
    __shfl_up_sync loop sums them."""
    s = np.asarray(x, np.float32).copy()
    off = 1
    while off < 32:
        prev = s.copy()
        s[off:] = (prev[off:] + prev[:-off]).astype(np.float32)
        off <<= 1
    return s


def sweep_kernel_count(p, u24, kpad):
    """The draw of csrc/pcgs.cu's shared-memory sweep kernel (kpad > 256,
    PCGS mode) for one token with products p [K <= kpad], in its own f32
    association, before the zero-run repair: each 32-topic chunk of a
    128-topic tile a Hillis-Steele scan plus the chunk before it, each
    tile's total added in order; z = min(sum over tiles of #{cdf <= u -
    the tiles before}, last topic with p > 0)."""
    f32 = np.float32
    pp = np.zeros(kpad, f32)
    pp[: len(p)] = p
    cdf = np.zeros(kpad, f32)
    total = f32(0)
    for t in range(kpad // 128):
        carry = f32(0)
        for g in range(4):
            b = t * 128 + g * 32
            cdf[b: b + 32] = (_hillis_steele32(pp[b: b + 32])
                              + carry).astype(f32)
            carry = cdf[b + 31]
        total = f32(total + carry)
    u = f32(f32(f32(u24) * f32(2.0 ** -24)) * total)
    cnt, off = 0, f32(0)
    for t in range(kpad // 128):
        cnt += int((cdf[t * 128: t * 128 + 128] <= f32(u - off)).sum())
        off = f32(off + cdf[t * 128 + 127])
    return min(cnt, int(np.nonzero(pp)[0].max()))


def pcgs_sweep_zero_run_case(k=300, seed=0):
    """pcgs_zero_run_case for the shared-memory sweep kernel (K=300, kpad
    384): products with a zero run at the end of a 32-topic chunk, whose
    Hillis-Steele sums need not equal the chunk's last nonzero sum, and a
    u24 on which sweep_kernel_count, before the repair, counts into the
    run."""
    from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import kpad_of
    kpad = kpad_of(k)
    rng = np.random.default_rng(seed)
    for _ in range(10_000):
        c, j = int(rng.integers(0, k // 32)), int(rng.integers(1, 31))
        nz = rng.random(k) < 0.7
        nz[32 * c + j: 32 * c + 32] = False
        p = np.where(nz, _bf16_np(rng.random(k).astype(np.float32)
                                  * rng.choice([1.0, 1e-3, 1e3], k)),
                     0).astype(np.float32)
        pre = np.cumsum(p, dtype=np.float32)
        lo = int(np.floor(float(pre[32 * c + 31]) / float(pre[-1]) * 2 ** 24))
        for u24 in range(max(lo - 64, 0), min(lo + 64, 1 << 24)):
            z = sweep_kernel_count(p, u24, kpad)
            if p[z] == 0:
                return {"phi": p, "u24": u24, "unrepaired": z,
                        "z_old": int(np.nonzero(p)[0][0]), "kpad": kpad}
    raise AssertionError("no zero-run tie case found")


def pcgs_zero_run_draw(torch, case, device="cuda"):
    """The PCGS sweep (positive_support off) on a corpus of one document of
    one token, word 0, with alpha 1 and n_dk 1 on z_old, so every product is
    bf16(phi[0, k]) = case["phi"][k], and the injected u24: returns (the
    kernel's z, the plain version's z). The case's kpad (128 unless it
    says) picks the kernel: the lane kernel's pair instance or the
    shared-memory sweep kernel."""
    from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
    from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_pcgs
    k = len(case["phi"])
    model = create_model(LDAConfig(
        scheme="pcgs", topics=k, alpha=1.0, beta=0.01, seed=2019,
        exec_time=-1, device=device))
    model.add_instances(Corpus.from_token_lists([[0]], ["w0"]))
    check(model._mode == "resident"
          and model._kpad() == case.get("kpad", 128),
          f"zero-run case: kpad {model._kpad()}, not the case's")
    real = model._slot_mask.reshape(model.state.z.shape)
    z = torch.where(real, case["z_old"], 0).to(torch.int32)
    ndk = torch.zeros((1, k), dtype=torch.int32, device=model.device)
    ndk[0, case["z_old"]] = 1
    table = model._ndk_table(ndk, torch.ones(k, device=model.device), None)
    phi_vk = torch.as_tensor(case["phi"], device=model.device)[None, :]
    u24 = torch.full(tuple(z.shape), case["u24"], dtype=torch.int32,
                     device=model.device)
    seed = torch.zeros(1, dtype=torch.int64, device=model.device)
    fn, args, kw = model._sweep_call(z, table, phi_vk, seed, u24)
    kw = {**kw, "positive_support": False}
    zk = fn(*args, **kw)[0]
    plain = {cuda_pcgs.fused_pcgs_sweep:
             cuda_pcgs.fused_pcgs_sweep_reference}[fn]
    zr = plain(*args, **without_order(kw))[0]
    return int(zk[real][0]), int(zr[real][0])


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
    # the zero-run tie (ROADMAP C): a case on which the lane
    # kernel's count, before its repair, draws a zero-probability topic
    case = pcgs_zero_run_case()
    zk, zr = pcgs_zero_run_draw(torch, case)
    check(case["phi"][zk] > 0, f"[3 pcgs] zero-run tie: the kernel drew "
          f"topic {zk}, whose probability is 0")
    print(f"[3 pcgs] zero-run tie (one token, u24 {case['u24']}, positive "
          f"support off): the unrepaired count of the lane kernel's "
          f"association draws topic {case['unrepaired']} (p 0); the kernel "
          f"draws {zk} (p {float(case['phi'][zk]):.4g}), the plain version "
          f"{zr}", flush=True)
    # the same at kpad > 256: the shared-memory sweep kernel's copy of the
    # repair
    case = pcgs_sweep_zero_run_case()
    zk, zr = pcgs_zero_run_draw(torch, case)
    check(case["phi"][zk] > 0, f"[3 pcgs] zero-run tie K=300: the kernel "
          f"drew topic {zk}, whose probability is 0")
    print(f"[3 pcgs] zero-run tie K=300 (kpad {case['kpad']}, the "
          f"shared-memory sweep kernel; u24 {case['u24']}): the unrepaired "
          f"count of its association draws topic {case['unrepaired']} (p "
          f"0); the kernel draws {zk} (p {float(case['phi'][zk]):.4g}), the "
          f"plain version {zr}", flush=True)
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
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_gamma
    res, stm = cuda_pcgs.fused_pcgs_sweep, cuda_pcgs.fused_pcgs_sweep_streamed
    launches = {}

    res.launches = stm.launches = 0
    cuda_gamma.gamma.launches = cuda_gamma.dirichlet.launches = 0
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
    launches["dirichlet"] = cuda_gamma.dirichlet.launches
    launches["gamma"] = cuda_gamma.gamma.launches
    check(res.launches == ITERS and stm.launches == 0,
          f"pcgs: sweep launches (resident, streamed) = "
          f"{(res.launches, stm.launches)}")
    # phi [K, V] by the long-row Dirichlet (two launches), every iteration
    # and at set-up
    check(launches["dirichlet"] == 2 * (ITERS + 1)
          and launches["gamma"] == 0, f"pcgs: Dirichlet and Gamma kernel "
          f"launches {(launches['dirichlet'], launches['gamma'])}")
    check_counts_exact(model, corpus, "pcgs")
    lls = dict(model.get_log_likelihoods())
    check(lls[30] > lls[10] > ll0, f"pcgs LL did not rise: init {ll0}, "
          f"{lls}")
    n = corpus.num_tokens
    print(f"[4 pcgs main path] pcgs K=100 resident on "
          f"{torch.cuda.get_device_name(0)} ({smi}): launches "
          f"{launches[res.__name__]}, the long-row Dirichlet kernels "
          f"{launches['dirichlet']}; counts exact; LL init {ll0:.1f} -> "
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
        zero_draw_launches()
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
        draws = draw_launches()
        want = {name: 0 for name in draws} | expected_draws(scheme, 10)
        check(draws == want, f"{scheme} K={k}: draw kernel launches "
              f"{draws}, expected {want}")
        if scheme == "polyaurn":
            launches["draws polyaurn"] = draws
            kept = no_token_on_zero_phi(model, corpus, phi_prev, scheme)
            extra = (f"; the Polya-Urn kernels {draws['polya_urn']} "
                     f"launches; phi density {model.get_phi_density():.4f}; "
                     f"{kept} tokens of all-zero phi columns kept z; no "
                     "draw on a zero phi")
        print(f"[4 {scheme} K={k}] {layout} layout: launches "
              f"{wrapper.launches}; counts exact; LL init {ll0:.1f} -> "
              f"it10 {lls[10]:.1f}; {(t1 - t0) / 10 * 1e3:.3f} "
              f"ms/iteration (host clock, LL at 10 included){extra}",
              flush=True)
        if scheme == "polyaurn":
            from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
            label = f"[4 {scheme} K={k} profile]"
            line = profile_against_eager(torch, rnd, model, label)[0]
            print(f"{label} {line}", flush=True)
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
    (streamed). The draw kernels' launches (csrc/hdp.cu, polya_urn.cu,
    vs_dirichlet.cu) are counted with the
    sweep's (expected_draws) and the HDP and nzvsspalias profiles run no
    torch.binomial or torch.poisson kernel (profile_against_eager).
    Returns {wrapper: {path: launches}}, the draw kernels' under
    "draws"."""
    from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
    res, stm = cuda_pcgs.fused_pcgs_sweep, cuda_pcgs.fused_pcgs_sweep_streamed
    launches = {res.__name__: {}, stm.__name__: {}, "draws": {}}
    n = corpus.num_tokens

    def run(scheme, k, iters, **kw):
        res.launches = stm.launches = 0
        zero_draw_launches()
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
        draws = draw_launches()
        want = {name: 0 for name in draws} | expected_draws(scheme, iters)
        check(draws == want, f"{scheme} K={k}: draw kernel launches "
              f"{draws}, expected {want}")
        launches["draws"][f"{scheme} K={k}"] = draws
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
    prof_line, prof = profile_against_eager(torch, rnd, model,
                                            "[4 ppu_hdplda profile]")
    print(f"[4 ppu_hdplda main path] ppu_hdplda K_max=100 resident on "
          f"{torch.cuda.get_device_name(0)} ({smi}): launches {nl}, "
          f"the HDP step's kernels "
          f"{json.dumps(launches['draws']['ppu_hdplda K=100'])}; counts "
          f"exact; LL init {ll0:.1f} -> it10 {lls[10]:.1f} -> it20 "
          f"{lls[20]:.1f} -> it30 {lls[30]:.1f}; active topics at 10 / 20 "
          f"/ 30: {hist[9]} / {hist[19]} / {hist[29]} ({n_active} now); "
          f"inactive topics with alpha 0, zero phi rows and no token; "
          f"{n * (ITERS - 10) / (t_b - t_a):.0f} tokens/s over iterations "
          f"11-30 ({(t_b - t_a) / (ITERS - 10) * 1e3:.3f} ms/iteration, "
          f"host clock, LL at 20 and 30 included); set up in {setup_s:.1f} "
          f"s; device busy {100 * prof[1] / prof[0]:.1f}% over 5 more "
          "iterations (profiler)", flush=True)
    print(f"[4 ppu_hdplda profile] {prof_line}", flush=True)
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
        draws = {name: v for name, v in
                 launches["draws"][f"{scheme} K={k}"].items() if v}
        print(f"[4 {scheme} K={k}] {layout} layout (vspan {model._vspan}): "
              f"launches {nl}, draw kernels {json.dumps(draws)}; counts "
              f"exact; LL init {ll0:.1f} -> {trail}; "
              f"{(t1 - t0) / iters * 1e3:.3f} ms/iteration over {iters} "
              f"iterations (host clock, the LL every 10 included); set up "
              f"in {setup_s:.1f} s{extra}", flush=True)
        label = f"[4 {scheme} K={k} profile]"
        line = (profile_iterations(torch, model, 5)
                if scheme == "spalias_priors"
                else profile_against_eager(
                    torch, rnd, model, label,
                    eager_draws=scheme != "nzvsspalias")[0])
        print(f"{label} {line}", flush=True)
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
    target (N_kw + beta, as `lightpcldaw2`); where z differs, each
    differing document's first token a proven rounding tie
    (mh_ties_at_first_disagreement). Returns one `kernels` entry per
    layout (launches filled in later)."""
    from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24x4
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
            words = (cuda_lightlda._slot_uniforms(u, tuple(st.z.shape))
                     if u is not None else philox_u24x4(seed, st.z.numel()))
            agreement[f"{label} ties"] = mh_ties_at_first_disagreement(
                torch, model, f"lightlda K={k} ({label})", st.z, zk, zr,
                table, tw, qw, words)
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


def collapsed_sweep_checks(torch, model, gen, seed, plain_of, label,
                           serial_docs=200):
    """The collapsed-mode checks of one model's layout, shared by [3 adlda
    sweep] and the sharded_adlda ranks of [7 parallel], from entry counts
    that are not the z_old histogram (collapsed_entry): (a) the parallel
    launch over every document but each 5th: N_kw = entry + moves, n_dk,
    flags, kept z and V beta + n_k exact; (b) the longest, the first and
    the middle document alone: equal to the plain version on every token,
    injected and Philox uniforms; (c) the one-warp launch over the first
    `serial_docs` documents against the plain version (both the
    sequential chain): z agreement >= 0.999, where z differs the chain's
    first differing token a proven rounding tie, N_kw the entry plus the
    moves. Returns what [3 adlda sweep] prints, with `call` (table, u,
    **kw) -> (fn, args, kw), the one-warp launch's `table` and `entry`."""
    from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24
    dev, st, corpus = model.device, model.state, model.corpus
    d = corpus.num_docs
    real = model._slot_mask
    entry, counts, nk_plus = collapsed_entry(torch, model, gen)
    nkp = torch.empty_like(nk_plus)

    def call(table, u=None, **kw):
        fn, args, ckw = model._sweep_call(st.z, table, counts, seed, u,
                                          nk_plus=nk_plus, beta=st.beta)
        return fn, args, {**ckw, **kw}

    # (a) bookkeeping on the whole corpus, parallel launch
    doc_sel = (torch.arange(d, device=dev) % 5) != 0
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
    docs = (int(np.argmax(lengths)), 0, d // 2)
    u24 = torch.randint(0, 2 ** 24, tuple(st.z.shape), generator=gen,
                        device=dev, dtype=torch.int32)
    for doc in docs:
        one = torch.arange(d, device=dev) == doc
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
    del table1, u24

    # (c) the one-warp launch against the plain version on the first
    # documents (the kernel walks only the listed documents)
    table = model._ndk_table(st.ndk, st.alpha, None)
    fn, args, kw = call(table, serial=True, nk_out=nkp)
    i_off = next(i for i, a in enumerate(args)
                 if a is model.doc_slot_offsets)
    sargs = list(args)
    sargs[i_off] = model.doc_slot_offsets[:serial_docs + 1]
    zk, nkw_k, tb_k = fn(*sargs, **kw)
    torch.cuda.synchronize()
    nkp_r = torch.empty_like(nk_plus)
    t0 = time.perf_counter()
    zr, nkw_r, _ = plain_of[fn](*sargs, **{**kw, "nk_out": nkp_r})
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    in_slice = real & (model._slot_d < serial_docs)
    n_slice = int(in_slice.sum())
    agree_c = float((zk == zr)[in_slice].float().mean())
    check(agree_c >= 0.999, f"{label} (c): one-warp launch agrees with "
          f"the plain version on only {agree_c:.6f} of tokens")
    tie_c = collapsed_tie_at_first_disagreement(
        torch, model, f"{label} (c)", st.z, zk, zr, table, counts,
        nk_plus, st.beta, philox_u24(seed, st.z.numel()), serial_docs)
    check(torch.equal(zk[~in_slice], st.z[~in_slice]),
          f"{label} (c): a token outside the slice moved")
    live = entry + slot_hist(torch, model, zk, entry.shape[0]) \
        - slot_hist(torch, model, st.z, entry.shape[0])
    check(torch.equal(nkw_k, live), f"{label} (c): N_kw is not the "
          "entry count plus the one-warp launch's moves")
    check_nk_plus(torch, f"{label} (c)", nk_plus, entry, nkw_k, nkp)
    err = int((nkw_k - nkw_r).abs().max())
    return dict(call=call, table=table, entry=entry, moved_a=moved_a,
                docs=docs, lengths=[int(lengths[x]) for x in docs],
                n_slice=n_slice, agree_c=agree_c, tie_c=tie_c, err=err,
                plain_ms=plain_ms)


def adlda_kernel_phase(torch, corpus, LDAConfig, create_model, cuda_pcgs):
    """[3 adlda sweep]: the collapsed mode of the sweep kernel against its
    plain version (the sequential chain) at the 20NG shapes, on the
    resident layout at K=100 (row 3) and the streamed one at K=200 (row
    4), with operands built by an `adlda` model as its main path builds
    them: (a) bookkeeping on the full corpus, (b) one selected document,
    (c) the one-warp launch on the first 200 documents (where z differs,
    the chain's first differing token a proven rounding tie), (d) a
    chi-square. Returns one `kernels` entry per layout (launches filled in
    later)."""
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
        seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                            device=dev)
        label = f"adlda K={k}"
        r = collapsed_sweep_checks(torch, model, gen, seed, plain_of, label)
        call, table, entry = r["call"], r["table"], r["entry"]
        fn = call(table)[0]
        z_edge = collapsed_boundary(torch, fn, plain_of[fn], seed)

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
              f"({r['moved_a']} tokens moved); (b) one selected document "
              f"({', '.join(map(str, r['docs']))}; lengths "
              f"{', '.join(map(str, r['lengths']))}): kernel equal "
              f"to the plain version on every token, u24 and Philox; own "
              f"count at the draw's boundary: z {z_edge} as computed; (c) "
              f"one-warp launch on the first 200 documents ({r['n_slice']} "
              f"tokens): z agreement {r['agree_c']:.6f} ("
              + ("equal on every token" if r["tie_c"] is None else
                 f"first differing at slot {r['tie_c']}, a proven "
                 "rounding tie")
              + f"), N_kw and V beta + n_k "
              f"exact, max |N_kw - plain| {r['err']}; (d) chi2={chi2:.1f} (df "
              f"{k - 1}, p={pval:.3g}, 200,704 one-token documents, "
              f"{moved_d} moved); kernel {ms:.4f} ms, one-warp launch "
              f"{serial_ms:.1f} ms, plain version on the first 200 "
              f"documents {r['plain_ms']:.1f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        entries.append(
            {"name": fn.__name__, "mode": "collapsed", "route": "cuda",
             "source": "ldagroupedgibbssampler_tpu_torch/csrc/pcgs.cu",
             "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_pcgs.py:"
                         + ("215" if layout == "resident" else "825"),
             "launches": 0, "max_abs_err": r["err"], "ms": ms,
             "plain_ms": r["plain_ms"],
             "plain_scope": f"first 200 documents ({r['n_slice']} "
                            "tokens)",
             "serial_ms": serial_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None})
        del model, st, table, entry, r, call
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
                      cuda_zdraw, cam, smi):
    """[4 ggs_aliasmh main path]: scheme ggs_aliasmh K=100 for ITERS
    iterations with a profile, the launch counts set to 0 just before it
    and read just after: the count kernel twice an iteration (N_kw on
    layout A, n_dk on layout B) and twice at set-up, the z-draw never, the
    alias-MH pre-pass, rounds and (packed) pack kernels once an iteration
    each. Then [4 ggs_aliasmh K=4096]: ggs_aliasmh (packed, the gate's
    choice), ggs_aliasmh unpacked and dense ggs at K=4096 in one call, 10
    iterations each, each with its alias-MH launches and a profile of 3
    more. Returns the K=100 run's launches by wrapper."""
    n = corpus.num_tokens
    counts = cuda_counts.blocked_label_counts
    zdraw = cuda_zdraw.fused_zdraw_nkw
    mh = (cam.entry_topics, cam.mh_rounds, cam.pack_tables)
    counts.launches = zdraw.launches = 0
    for fn in mh:
        fn.launches = 0
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
    launches = {"blocked_label_counts": counts.launches,
                "fused_zdraw_nkw": zdraw.launches,
                **{fn.__name__: fn.launches for fn in mh}}
    check(launches["blocked_label_counts"] == 2 * ITERS + 2
          and zdraw.launches == 0,
          f"ggs_aliasmh: count kernel launched {counts.launches} times "
          f"(expected {2 * ITERS + 2}), z-draw {zdraw.launches}")
    check(all(fn.launches == ITERS for fn in mh), f"ggs_aliasmh: alias-MH "
          f"kernels launched {launches} (expected {ITERS} each)")
    check_counts_exact(model, corpus, "ggs_aliasmh")
    lls = dict(model.get_log_likelihoods())
    check(lls[30] > lls[10] > ll0, f"ggs_aliasmh: LL did not rise: init "
          f"{ll0}, {lls}")
    print(f"[4 ggs_aliasmh main path] ggs_aliasmh K={K} on "
          f"{torch.cuda.get_device_name(0)} ({smi}): count kernel launches "
          f"{counts.launches} (2 an iteration + 2 at set-up), z-draw 0, "
          f"alias-MH pre-pass {cam.entry_topics.launches}, rounds "
          f"{cam.mh_rounds.launches}, pack {cam.pack_tables.launches} (1 "
          f"an iteration each); counts "
          f"exact; LL init {ll0:.1f} -> it10 {lls[10]:.1f} -> it30 "
          f"{lls[30]:.1f}; {n * (ITERS - 10) / (t_b - t_a):.0f} tokens/s "
          f"over iterations 11-30 ({(t_b - t_a) / (ITERS - 10) * 1e3:.3f} "
          "ms/iteration, host clock, LL at 20 and 30 included)", flush=True)
    print(f"[4 ggs_aliasmh profile] {profile_iterations(torch, model, 5)}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    k_big, res = 4096, {}
    for name, scheme, mode in (("ggs_aliasmh", "ggs_aliasmh", "auto"),
                               ("ggs_aliasmh unpacked", "ggs_aliasmh",
                                "unpacked"), ("ggs", "ggs", "auto")):
        cfg = LDAConfig(scheme=scheme, topics=k_big, alpha=0.5, beta=0.01,
                        seed=2019, exec_time=-1, topic_interval=5,
                        device="cuda", aliasmh_packed=mode)
        model = create_model(cfg)
        model.add_instances(corpus)
        for fn in mh:
            fn.launches = 0
        ll0 = model.model_log_likelihood()
        model.sample(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(8)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 8 * 1e3
        mh_launches = {fn.__name__: fn.launches for fn in mh}
        packed = scheme == "ggs_aliasmh" and model._mh_packed()
        check(packed == (name == "ggs_aliasmh"), f"{name} K={k_big}: the "
              f"packed gate chose {packed}")
        want = ({"entry_topics": 10, "mh_rounds": 10,
                 "pack_tables": 10 if packed else 0}
                if scheme == "ggs_aliasmh" else dict.fromkeys(mh_launches, 0))
        check(mh_launches == want, f"{name} K={k_big}: alias-MH launches "
              f"{mh_launches}, expected {want}")
        check_counts_exact(model, corpus, f"{name} K={k_big}")
        lls = dict(model.get_log_likelihoods())
        check(lls[10] > lls[5] > ll0, f"{name} K={k_big}: LL did not rise:"
              f" init {ll0}, {lls}")
        res[name] = (ms, ll0, lls, mh_launches)
        print(f"[4 ggs_aliasmh K={k_big} profile] {name}: "
              f"{profile_iterations(torch, model, 3)}", flush=True)
        del model
        torch.cuda.empty_cache()
    dense = res["ggs"]
    text = "; ".join(
        f"{name} {r[0]:.3f} ms/iteration (LL init {r[1]:.1f} -> it5 "
        f"{r[2][5]:.1f} -> it10 {r[2][10]:.1f}; alias-MH launches "
        f"{json.dumps(r[3])}; dense / this time {dense[0] / r[0]:.3f})"
        for name, r in res.items())
    print(f"[4 ggs_aliasmh K={k_big}] counts exact and LL rising in each; "
          f"{text} (host clock over iterations 3-10, LL at 5 and 10 "
          "included)", flush=True)
    return launches


# [3 alias-mh]: the alias-MH z-step kernels (csrc/alias_mh.cu)
ALIAS_MH_KS = (K, 4096)
ALIAS_MH_ROUNDS = 2
# a z that differs from the plain version's is a proven tie where one accept
# test on the plain version's path has sides this close (relative): f32
# products rounded in another order move them by a few ulps at most
ALIAS_MH_TIE = 2.0 ** -20
ALIAS_MH_CHI = dict(docs=2000, length=300, types=50, topics=20, groups=4,
                    rounds=8)
PHILOX_MULTIPLIES = 40      # 32-bit multiplies of one Philox4x32-10 block


def alias_mh_case(torch, corpus, LDAConfig, create_model, k):
    """A ggs_aliasmh model at K=k after 2 iterations on cuda, and the
    operands of one z-step on its state: an asymmetric alpha (0.05 to 0.95,
    mean 0.5), the documents of even index selected, a fixed seed."""
    model = create_model(pcgs_config(LDAConfig, "ggs_aliasmh", k))
    model.add_instances(corpus)
    model.sample(2)
    st, dev = model.state, model.device
    a_sum = torch.linspace(0.05, 0.95, k, device=dev).sum()
    return model, dict(
        z_slot=st.z, ops=model._mh_ops, phi=st.phi, nkw=st.nkw,
        theta=st.theta, ndk=st.ndk, beta=st.beta, alpha_sum=a_sum,
        au=a_sum / k, seed=torch.tensor([0x2F6B_11D0_93A7_5C41],
                                        dtype=torch.int64, device=dev),
        doc_mask=torch.arange(corpus.num_docs, device=dev) % 2 == 0)


def alias_mh_proposals(torch, cam, case, rounds):
    """Each step's proposed topics, long [2 rounds, N]: they depend on
    the entry topics and the draws alone, not on acceptance."""
    ops, k = case["ops"], case["phi"].shape[1]
    w, d = ops.tok_w.long(), ops.tok_d.long()
    doc_off, ty_off = ops.doc_off.long(), ops.ty_off.long()
    doc_base, ty_base = doc_off[d], ty_off[w]
    doc_len, ty_cnt = doc_off[d + 1] - doc_base, ty_off[w + 1] - ty_base
    z_can, z_ty, _ = cam.entry_topics_reference(case["z_slot"], ops)
    f32 = torch.float32
    cw, ld = ty_cnt.to(f32), doc_len.to(f32)
    p_w = cw / (cw + k * case["beta"])
    p_d = ld / (ld + case["alpha_sum"])
    draws = cam.philox_draws(case["seed"], w.shape[0], ty_cnt.clamp_min(1),
                             doc_len.clamp_min(1), k)
    out = []
    for r in range(rounds):
        u1, pos1, k1, _, u2, pos2, k2, _ = draws(r)
        out.append(torch.where(u1 < p_w, z_ty[ty_base + pos1].long(), k1))
        out.append(torch.where(u2 < p_d, z_can[doc_base + pos2].long(), k2))
    return z_can.long(), torch.stack(out)


def alias_mh_touched(torch, cam, case, rounds):
    """(table entries, 32-byte sectors of the unpacked tables, sectors of
    the packed ones) that the updatable tokens' current and proposed
    topics need: the bound counts each entry's 8 bytes once."""
    ops, k = case["ops"], case["phi"].shape[1]
    sel = (torch.ones_like(ops.tok_d, dtype=torch.bool)
           if case["doc_mask"] is None else case["doc_mask"][ops.tok_d.long()])
    z0, props = alias_mh_proposals(torch, cam, case, rounds)
    topics = torch.cat([z0[None], props])[:, sel]
    entries = sectors = packed = 0
    for rows in (ops.tok_w.long()[sel], ops.tok_d.long()[sel]):
        idx = torch.unique(rows[None] * k + topics)
        entries += idx.numel()
        sectors += 2 * torch.unique(idx // 8).numel()
        packed += torch.unique(idx // 4).numel()
    return entries, sectors, packed


def alias_mh_tie_gaps(torch, cam, case, rounds, packed, tokens):
    """For each canonical token of `tokens`, the smallest relative gap
    |lhs - rhs| / max(lhs, rhs) between the sides of its accept tests on
    alias_mh_reference's path, repeated in numpy float32 from the same
    draws and table values: a kernel z that differs from the reference's
    is a proven tie where this is at most ALIAS_MH_TIE. Returns (the gaps,
    the z each path ends on)."""
    f32 = np.float32
    ops, k = case["ops"], case["phi"].shape[1]
    w, d = ops.tok_w.long(), ops.tok_d.long()
    doc_off, ty_off = ops.doc_off.long(), ops.ty_off.long()
    doc_len = (doc_off[d + 1] - doc_off[d]).clamp_min(1)
    ty_cnt = (ty_off[w + 1] - ty_off[w]).clamp_min(1)
    draws = cam.philox_draws(case["seed"], w.shape[0], ty_cnt, doc_len, k)
    step_draws = [[a.cpu().numpy() for a in draws(r)] for r in range(rounds)]
    z_can, z_ty, _ = cam.entry_topics_reference(case["z_slot"], ops)
    z_can, z_ty = z_can.cpu().numpy(), z_ty.cpu().numpy()
    tabs = (cam.pack_reference(*(case[n] for n in (
        "phi", "nkw", "theta", "ndk", "beta", "au"))) if packed else None)
    beta, au = f32(case["beta"]), f32(float(case["au"]))
    a_sum, kbeta = f32(float(case["alpha_sum"])), f32(k * case["beta"])

    def dens(t, kk):
        iw, idd = int(w[t]) * k + kk, int(d[t]) * k + kk
        if tabs is not None:
            a, b = tabs[0][iw].tolist(), tabs[1][idd].tolist()
            return f32(a[0]), f32(a[1]), f32(b[0]), f32(b[1])
        return (f32(float(case["phi"].view(-1)[iw])),
                f32(int(case["nkw"].view(-1)[iw])) + beta,
                f32(float(case["theta"].view(-1)[idd])),
                f32(int(case["ndk"].view(-1)[idd])) + au)
    gaps, ends = [], []
    for t in tokens:
        cw, ld = f32(int(ty_cnt[t])), f32(int(doc_len[t]))
        p_mix = (cw / (cw + kbeta), ld / (ld + a_sum))
        base = (int(ty_off[w[t]]), int(doc_off[d[t]]))
        zz = int(z_can[t])
        ph, qw, th, qd = dens(t, zz)
        t_c, gap = th * ph, np.inf
        for r in range(rounds):
            for s in (0, 1):
                u_mix, pos, topic, u_acc = (a[t] for a in
                                            step_draws[r][4 * s: 4 * s + 4])
                kp = (int((z_ty, z_can)[s][base[s] + pos])
                      if u_mix < p_mix[s] else int(topic))
                phn, qwn, thn, qdn = dens(t, kp)
                t_new = thn * phn
                lhs = u_acc * max(t_c * (qwn, qdn)[s], f32(1e-38))
                rhs = t_new * (qw, qd)[s]
                gap = min(gap, abs(float(lhs) - float(rhs))
                          / max(float(lhs), float(rhs), 1e-300))
                if lhs < rhs:
                    zz, t_c, qw, qd = kp, t_new, qwn, qdn
        gaps.append(gap)
        ends.append(zz)
    return gaps, ends


ALIAS_MH_SELECTIONS = ("half", "all")   # even documents; every document


def alias_mh_selected(case, sel):
    """The case with `sel`'s documents selected: the even ones (the case's
    own mask) or every one (doc_mask None, as the main path runs it)."""
    return case if sel == "half" else {**case, "doc_mask": None}


def alias_mh_agreement(torch, cam, case, label):
    """The kernel against alias_mh_reference in both modes, with the even
    documents selected and with every document, with acceptance counts: z
    equal on every slot but proven ties, padding slots 0, unselected
    documents' z kept and the entry z untouched, the rates from the counts
    equal to the reference's f32 rates, packed equal to unpacked (z and
    counts), the pack kernel equal to pack_reference bit for bit. Returns
    (the pack kernel's tables, {"mode sel": numbers})."""
    dev = case["z_slot"].device
    rounds, ops = ALIAS_MH_ROUNDS, case["ops"]
    tables = [case[n] for n in ("phi", "nkw", "theta", "ndk", "beta", "au")]
    packs = cam.pack_tables(*tables)
    packs_ref = cam.pack_reference(*tables)
    check(all(torch.equal(a, b) for a, b in zip(packs, packs_ref)),
          f"{label}: the pack kernel differs from pack_reference")
    real = ops.slot_of_can.long()
    pad = torch.ones(case["z_slot"].shape, dtype=torch.bool, device=dev)
    pad[real] = False
    entry = case["z_slot"].clone()
    out = {}
    for sel in ALIAS_MH_SELECTIONS:
        c = alias_mh_selected(case, sel)
        mask = c["doc_mask"]
        unsel = (torch.zeros_like(real, dtype=torch.bool) if mask is None
                 else ~mask[ops.tok_d.long()])
        den = cam.updatable_tokens(ops, mask)
        for mode in ("unpacked", "packed"):
            counts = torch.zeros((rounds, 2), dtype=torch.int32, device=dev)
            zk = cam.alias_mh(**c, rounds=rounds,
                              packed=packs if mode == "packed" else None,
                              acc_counts=counts)
            zr, rates = cam.alias_mh_reference(**c, rounds=rounds,
                                               packed=mode == "packed")
            what = f"{label} {mode} {sel}"
            diff = (zk[real] != zr[real]).nonzero().flatten()
            # the proof's path is the plain version's: it ends on its z,
            # here checked on the differing tokens and the first 16 tokens
            probe = diff[:64].tolist() + list(range(16))
            gaps, ends = alias_mh_tie_gaps(torch, cam, c, rounds,
                                           mode == "packed", probe)
            check(ends == zr[real[probe]].tolist(), f"{what}: the tie "
                  f"proof's path ends on {ends}, the plain version on "
                  f"{zr[real[probe]].tolist()}")
            gaps = gaps[:min(diff.numel(), 64)]
            check(diff.numel() <= 64 and all(g <= ALIAS_MH_TIE for g in gaps),
                  f"{what}: {diff.numel()} tokens differ from the plain "
                  f"version, accept-test gaps {gaps[:8]}")
            got = cam.acceptance_rates(counts, den)
            check(all(torch.equal(a, b) for a, b in zip(got, rates)),
                  f"{what}: rates {[a.tolist() for a in got]} from the "
                  f"counts, {[a.tolist() for a in rates]} by the plain "
                  "version")
            check(bool((zk[pad] == 0).all()), f"{what}: a padding slot is "
                  "not 0")
            check(torch.equal(zk[real[unsel]], case["z_slot"][real[unsel]]),
                  f"{what}: an unselected document's z moved")
            check(torch.equal(case["z_slot"], entry), f"{what}: the entry z "
                  "was written")
            out[f"{mode} {sel}"] = dict(
                z=zk, counts=counts, differ=int(diff.numel()),
                gap=max(gaps, default=None),
                moved=float((zk[real] != case["z_slot"][real]).float()
                            .mean()),
                max_abs_err=int((zk - zr).abs().max()))
        check(torch.equal(out[f"packed {sel}"]["z"],
                          out[f"unpacked {sel}"]["z"])
              and torch.equal(out[f"packed {sel}"]["counts"],
                              out[f"unpacked {sel}"]["counts"]),
              f"{label} {sel}: packed and unpacked kernels differ")
    return packs, out


def alias_mh_chi_square(torch, cam, Corpus, dev):
    """MH invariance on the card: ALIAS_MH_CHI's documents and types, theta
    shared by groups of documents, z drawn exactly from theta[d] phi[., w];
    after its rounds of the kernel z still follows it: chi-square over
    (group, type) cells, p > 1e-4. Returns (chi2, dof, p, share moved)."""
    from scipy import stats as sps
    c = ALIAS_MH_CHI
    rng = np.random.default_rng(17)
    k, v, docs, length = c["topics"], c["types"], c["docs"], c["length"]
    tokens = rng.integers(0, v, docs * length)
    offsets = np.arange(0, docs * length + 1, length)
    corpus = Corpus(tokens=tokens.astype(np.int32), doc_offsets=offsets,
                    vocab=[f"w{i}" for i in range(v)])
    blocks = corpus.cell_blocks(block=4096, vspan=128, dspan=128)
    ops = cam.MHOperands.build(tokens, offsets, blocks.flat_index, v, dev)
    doc_of = np.repeat(np.arange(docs), length)
    theta = rng.dirichlet(np.full(k, 1.5), c["groups"]).astype(np.float32)[
        np.arange(docs) % c["groups"]]
    phi = np.ascontiguousarray(rng.dirichlet(np.full(v, 1.0), k).T,
                               np.float32)
    p = theta[doc_of] * phi[tokens]
    p /= p.sum(axis=1, keepdims=True)
    z = np.minimum((rng.random(len(tokens))[:, None]
                    > np.cumsum(p, axis=1)).sum(1), k - 1)
    nkw = np.zeros((v, k), np.int32)
    np.add.at(nkw, (tokens, z), 1)
    ndk = np.zeros((docs, k), np.int32)
    np.add.at(ndk, (doc_of, z), 1)
    z_slot = torch.zeros(blocks.flat_index.size, dtype=torch.int32,
                         device=dev)
    z_slot[ops.slot_of_can.long()] = torch.as_tensor(z.astype(np.int32),
                                                     device=dev)
    a_sum = torch.tensor(0.1 * k, dtype=torch.float32, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)
    out = cam.alias_mh(z_slot, ops, t(phi), t(nkw), t(theta), t(ndk), 0.01,
                       a_sum, a_sum / k, torch.tensor(
                           [0x51DE_C0DE], dtype=torch.int64, device=dev),
                       c["rounds"])
    z_after = out[ops.slot_of_can.long()].cpu().numpy()
    cell = (doc_of % c["groups"]) * v + tokens
    obs = np.zeros((c["groups"] * v, k))
    np.add.at(obs, (cell, z_after), 1)
    expect = np.zeros((c["groups"] * v, k))
    np.add.at(expect, cell, p)
    keep = expect > 5
    chi2 = float((((obs - expect) ** 2)[keep] / expect[keep]).sum())
    dof = int(keep.sum()) - int(keep.any(axis=1).sum())
    pval = float(sps.chi2.sf(chi2, dof))
    moved = float((z_after != z).mean())
    check(pval > 1e-4 and moved > 0.3, f"[3 alias-mh] MH invariance: chi2 "
          f"{chi2:.1f} (dof {dof}, p={pval:.3g}), {moved:.3f} of z moved")
    return chi2, dof, pval, moved


def alias_mh_phase(torch, corpus, Corpus, LDAConfig, create_model, cam, smi,
                   _build, parent=None):
    """[3 alias-mh]: the alias-MH z-step kernels (csrc/alias_mh.cu) on the
    20NG corpus at K=100 and K=4096, each on a ggs_aliasmh model's state
    after 2 iterations, with ALIAS_MH_ROUNDS rounds, an asymmetric alpha,
    the even documents selected and every document (alias_mh_case,
    ALIAS_MH_SELECTIONS): the kernels against alias_mh_reference in both
    modes (alias_mh_agreement); MH invariance by chi-square on the card
    (alias_mh_chi_square); the z-step (pre-pass and rounds) timed by CUDA
    events in both modes and both selections, the pre-pass alone, the pack
    kernel, beside the plain versions, `torch.stack` of the same tables
    (the pack's yardstick; no PyTorch call computes an MH round) and the
    bounds: the z-step's bytes (its inputs read once, its output written
    once: the token operands, z at the real slots, the new z over every
    slot, the offsets, each table entry the updatable tokens' current and
    proposed topics need, 8 B once) against
    the Philox blocks' integer multiplies; the pack's 16 B a table entry;
    ptxas's registers of the pre-pass and both rounds instances. With
    `parent` (a checkout), also the parent's z-step and this one's in
    turns (parent_times). Returns the two kernels-JSON entries."""
    rounds = ALIAS_MH_ROUNDS
    res = {}
    chi = None
    regs = {"rounds_kernel<packed>": ptxas_registers(_build, "rounds_kernel"),
            "entry_kernel": ptxas_registers(_build, "entry_kernel")}
    for k in ALIAS_MH_KS:
        label = f"[3 alias-mh] K={k}"
        model, case = alias_mh_case(torch, corpus, LDAConfig, create_model,
                                    k)
        packs, agree = alias_mh_agreement(torch, cam, case, label)
        ops, n = case["ops"], case["ops"].num_tokens
        tables = [case[nm] for nm in ("phi", "nkw", "theta", "ndk", "beta",
                                      "au")]
        ms, bounds = {}, {}
        slots, d_, v_ = case["z_slot"].numel(), case["theta"].shape[0], \
            case["phi"].shape[0]
        for sel in ALIAS_MH_SELECTIONS:
            c = alias_mh_selected(case, sel)
            for mode, p in (("unpacked", None), ("packed", packs)):
                ms[f"{mode} {sel}"] = time_ms(torch, lambda c=c, p=p: cam.
                                              alias_mh(**c, rounds=rounds,
                                                       packed=p))
            entries, sectors, sectors_packed = alias_mh_touched(
                torch, cam, c, rounds)
            upd = int(cam.updatable_tokens(ops, c["doc_mask"]))
            # the function's inputs read once, its output written once:
            # slot, type, document and the type-order slot map, z at the
            # real slots (5 x 4 B a token), the new z (4 B a slot), the
            # document and type offsets and the mask
            stream = (4 * 5 * n + 4 * slots + 4 * (d_ + v_ + 2)
                      + (0 if c["doc_mask"] is None else d_))
            nbytes = stream + 8 * entries
            int_ops = upd * 4 * rounds * PHILOX_MULTIPLIES
            b_ms, by = bound(nbytes, 0.0, int_ops)
            bounds[sel] = dict(bound_ms=b_ms, bound_by=by, bytes=nbytes,
                               int_ops=int_ops, entries=entries,
                               sector_bytes=32 * sectors,
                               sector_bytes_packed=32 * sectors_packed,
                               updatable=upd)
        prepass_ms = time_ms(torch, lambda: cam.entry_topics(case["z_slot"],
                                                             ops))
        pack_ms = time_ms(torch, lambda: cam.pack_tables(*tables))
        plain_ms = {f"{mode} {sel}": once_ms(
            torch, lambda mode=mode, sel=sel: cam.alias_mh_reference(
                **alias_mh_selected(case, sel), rounds=rounds,
                packed=mode == "packed"))
            for mode in ("unpacked", "packed") for sel in ALIAS_MH_SELECTIONS}
        pack_plain_ms = time_ms(torch, lambda: cam.pack_reference(*tables))
        f32 = torch.float32
        nkw_f = case["nkw"].to(f32) + case["beta"]
        ndk_f = case["ndk"].to(f32) + case["au"]
        stack_ms = time_ms(torch, lambda: (
            torch.stack([case["phi"].reshape(-1), nkw_f.reshape(-1)], 1),
            torch.stack([case["theta"].reshape(-1), ndk_f.reshape(-1)], 1)))
        del nkw_f, ndk_f
        pack_bytes = 16 * (v_ + d_) * k
        pack_bound, pack_by = bound(pack_bytes, 0.0)
        if k == K:
            chi = alias_mh_chi_square(torch, cam, Corpus, model.device)
        numbers = {m: {x: agree[m][x] for x in ("differ", "gap", "moved",
                                                 "max_abs_err")}
                   | {"counts": agree[m]["counts"].tolist(), "ms": ms[m],
                      "plain_ms": plain_ms[m]} for m in agree}
        res[k] = dict(numbers=numbers, bounds=bounds, prepass_ms=prepass_ms,
                      pack_ms=pack_ms,
                      pack_plain_ms=pack_plain_ms, stack_ms=stack_ms,
                      pack_bound_ms=pack_bound, pack_bound_by=pack_by,
                      tokens=n)
        differ = {m: numbers[m]["differ"] for m in numbers}
        gap = max((numbers[m]["gap"] or 0.0) for m in numbers)
        times = "; ".join(
            f"{sel} ({bounds[sel]['updatable']} updatable) unpacked "
            f"{ms['unpacked ' + sel]:.4f} ms, packed "
            f"{ms['packed ' + sel]:.4f} ms, bound "
            f"{bounds[sel]['bound_ms']:.4f} ms ({bounds[sel]['bound_by']}: "
            f"{bounds[sel]['bytes'] / 1e6:.1f} MB with "
            f"{bounds[sel]['entries']} table entries of 8 B, "
            f"{bounds[sel]['int_ops'] / 1e6:.1f} M Philox multiplies; the "
            f"entries' 32-byte sectors "
            f"{bounds[sel]['sector_bytes'] / 1e6:.1f} MB unpacked, "
            f"{bounds[sel]['sector_bytes_packed'] / 1e6:.1f} MB packed)"
            for sel in ALIAS_MH_SELECTIONS)
        print(f"{label} {smi}: {n} tokens, {rounds} rounds, alpha "
              f"0.05-0.95, the even documents and every document selected: "
              f"z equal to alias_mh_reference on every slot but proven ties "
              f"(differing {json.dumps(differ)}, largest accept-test gap "
              f"{gap}), padding slots 0, unselected documents' z kept, the "
              f"entry z untouched, {numbers['packed all']['moved']:.4f} of "
              f"the tokens moved with every document; acceptance counts "
              f"(word, doc) by round "
              f"{json.dumps(numbers['packed all']['counts'])} give the plain "
              f"version's rates; packed equal to unpacked; pack kernel equal "
              f"to pack_reference; z-step (pre-pass + rounds): {times}; the "
              f"pre-pass alone {prepass_ms:.4f} ms; plain (unpacked / "
              f"packed) every document {plain_ms['unpacked all']:.2f} / "
              f"{plain_ms['packed all']:.2f} ms, half "
              f"{plain_ms['unpacked half']:.2f} / "
              f"{plain_ms['packed half']:.2f} ms; "
              f"pack {pack_ms:.4f} ms (1 launch), plain {pack_plain_ms:.4f} "
              f"ms, torch.stack {stack_ms:.4f} ms, bound {pack_bound:.4f} ms "
              f"({pack_by}, {pack_bytes / 1e6:.1f} MB)", flush=True)
        del model, case, packs, agree
        torch.cuda.empty_cache()
    print(f"[3 alias-mh] MH invariance on {torch.cuda.get_device_name(0)}: "
          f"{ALIAS_MH_CHI['docs']} documents of {ALIAS_MH_CHI['length']} "
          f"tokens, z drawn from theta phi, {ALIAS_MH_CHI['rounds']} rounds "
          f"of the kernel: chi2 {chi[0]:.1f} (dof {chi[1]}, p={chi[2]:.3g}), "
          f"{chi[3]:.4f} of z moved; ptxas {json.dumps(regs)}", flush=True)
    parents = parent_times("alias_mh", parent, [
        f"zstep K={k} {mode} {sel}" for k in ALIAS_MH_KS
        for mode in ("packed", "unpacked") for sel in ("all", "half")]
    ) if parent else None
    if parents:
        print(f"[3 alias-mh] z-step (pre-pass + rounds), parent and this "
              f"checkout in turns (ms, medians) {json.dumps(parents)}",
              flush=True)
    main, big = res[ALIAS_MH_KS[0]], res[ALIAS_MH_KS[-1]]
    src = "ldagroupedgibbssampler_tpu_torch/csrc/alias_mh.cu"
    rounds_entry = {
        "name": "alias_mh_rounds", "route": "cuda", "source": src,
        "replaces": "ldagroupedgibbssampler_tpu/models/ggs_aliasmh.py:89",
        "max_abs_err": max(r["numbers"][m]["max_abs_err"]
                           for r in res.values() for m in r["numbers"]),
        "ms": main["numbers"]["packed all"]["ms"],
        "unpacked_ms": main["numbers"]["unpacked all"]["ms"],
        "prepass_ms": main["prepass_ms"],
        "plain_ms": main["numbers"]["packed all"]["plain_ms"],
        "bound_ms": main["bounds"]["all"]["bound_ms"],
        "bound_by": main["bounds"]["all"]["bound_by"],
        "half_ms": main["numbers"]["packed half"]["ms"],
        "half_plain_ms": main["numbers"]["packed half"]["plain_ms"],
        "half_bound_ms": main["bounds"]["half"]["bound_ms"],
        "library_ms": None, "chi_square": list(chi), "ptxas": regs,
        "cases": {str(k): {"numbers": r["numbers"], "bounds": r["bounds"]}
                  for k, r in res.items()},
        "k4096": {"ms": big["numbers"]["packed all"]["ms"],
                  "unpacked_ms": big["numbers"]["unpacked all"]["ms"],
                  "prepass_ms": big["prepass_ms"],
                  "plain_ms": big["numbers"]["packed all"]["plain_ms"],
                  "bound_ms": big["bounds"]["all"]["bound_ms"],
                  "bound_by": big["bounds"]["all"]["bound_by"],
                  "half_ms": big["numbers"]["packed half"]["ms"],
                  "half_plain_ms": big["numbers"]["packed half"]["plain_ms"],
                  "half_bound_ms": big["bounds"]["half"]["bound_ms"]},
        "parent_times": parents}
    pack_entry = {
        "name": "alias_mh_pack", "route": "cuda", "source": src,
        "replaces": "ldagroupedgibbssampler_tpu/models/ggs_aliasmh.py:247",
        "max_abs_err": 0.0, "ms": main["pack_ms"],
        "plain_ms": main["pack_plain_ms"], "bound_ms": main["pack_bound_ms"],
        "bound_by": main["pack_bound_by"], "library_ms": main["stack_ms"],
        "k4096": {"ms": big["pack_ms"], "plain_ms": big["pack_plain_ms"],
                  "bound_ms": big["pack_bound_ms"],
                  "bound_by": big["pack_bound_by"],
                  "library_ms": big["stack_ms"]}}
    return rounds_entry, pack_entry


# ---------------------------------------------------------------------------
# The HDP step after the sweep, the Polya-Urn and the VS-Dirichlet draws
# (csrc/hdp.cu, csrc/polya_urn.cu, csrc/vs_dirichlet.cu with
# csrc/discrete.cuh)
# ---------------------------------------------------------------------------

HDP_STATE_ITERS = 10        # the ppu_hdplda chain [3 hdp] starts from
HDP_PSI_K = 4096            # [3 hdp]'s synthetic psi inputs
PSI_EXTRA_K = (37, 700, 5000)   # psi's geometry: one block; a cluster of
                                # 2; of 8 with two chunks a block
HDP_LARGE_K = 4096          # [3 hdp]'s table counts past shared memory
# psi and alpha, kernel against plain: the Gamma draws' last bits and the
# f64 scans taken in another order, each rounded once to f32
PSI_RTOL = 1e-5
PSI_CASES = tuple((births, sampler, dist)
                  for births in ("none", "candidates", "lowest")
                  for sampler in ("gem", "poisson")
                  for dist in ("geometric", "uniform"))
BINOMIAL_KS = ((6, 0.3), (40, 0.25), (400, 0.1), (90, 0.8))
POISSON_GRID = (0.01, 0.5, 9.99, 10.0, 37.5, 5000.0)
DRAW_KS = 200_000           # kernel and library draws of each KS case
VS_TIE = 1e-6               # an inclusion that differs must have |u - p|
                            # below this (p's f32 rounding)
VS_LONG_ROW = 450_000       # [3 vs-dirichlet]'s rows past shared memory
URN_LONG_ROW = 300_000      # [3 polya-urn]'s long rows


def draw_wrappers():
    """(name, wrapper) of the draw kernels' launch counters (csrc/hdp.cu,
    polya_urn.cu, vs_dirichlet.cu)."""
    from ldagroupedgibbssampler_tpu_torch.ops import (cuda_gamma, cuda_hdp,
                                                      cuda_polya_urn)
    return (("table_counts", cuda_hdp.table_counts),
            ("psi_step", cuda_hdp.psi_step),
            ("polya_urn", cuda_polya_urn.polya_urn),
            ("vs_dirichlet", cuda_gamma.vs_dirichlet),
            ("binomial", cuda_hdp.binomial),
            ("poisson", cuda_polya_urn.poisson))


def expected_draws(scheme: str, iters: int) -> dict:
    """The draw kernels' launches in `iters` iterations of a scheme
    from set-up: the table counts and Polya-Urn rows two an iteration and
    psi one (all topics: one more at set-up, its GEM prior draw); the VS
    rows one an iteration and one at set-up; polyaurn's rows two an
    iteration and two at set-up. Every other counter stays 0."""
    hdp_step = dict(table_counts=2 * iters, psi_step=iters,
                    polya_urn=2 * iters)
    return {"ppu_hdplda": hdp_step, "ppu_hlda": hdp_step,
            "ppu_hdplda_all_topics": hdp_step | dict(psi_step=iters + 1),
            "nzvsspalias": dict(vs_dirichlet=iters + 1),
            "polyaurn": dict(polya_urn=2 * (iters + 1))}.get(scheme, {})


def zero_draw_launches():
    for _, fn in draw_wrappers():
        fn.launches = 0


def draw_launches() -> dict:
    return {name: fn.launches for name, fn in draw_wrappers()}


def library_draw_kernels(rows) -> list:
    """Profile rows of PyTorch's own Binomial or Poisson kernels
    (torch.binomial, torch.poisson; the port's are `binomial_kernel`,
    `poisson_kernel` and the fused draws)."""
    return sorted({name[:70] for _, name, _ in rows
                   if ("binomial" in name.lower() or "poisson" in name.lower())
                   and "binomial_kernel" not in name
                   and "poisson_kernel" not in name})


def eager_polya_urn(torch, counts, beta, generator, zero_mask=True):
    """The Polya-Urn draw the port ran on the card before its kernel:
    torch.poisson and the normalisation, eager."""
    lam = torch.as_tensor(counts).to(torch.float32) + beta
    c = torch.poisson(lam, generator=generator)
    total = c.sum(dim=-1, keepdim=True)
    safe = torch.where(total > 0, c / total.clamp_min(1.0),
                       1.0 / c.shape[-1])
    return safe, (c == 0 if zero_mask else None)


def eager_vs_dirichlet(torch, rnd, counts, beta, vs_prior, generator,
                       previous_phi=None, sequential=False):
    """The vectorised VS-Dirichlet draw the port ran on the card before
    its kernel: the Gamma kernel, then ~40 eager launches."""
    counts = torch.as_tensor(counts).to(torch.float32)
    dev = counts.device
    n_k = counts.sum(dim=-1, keepdim=True)
    prev_zero = (torch.zeros(counts.shape, dtype=torch.bool, device=dev)
                 if previous_phi is None else previous_phi.to(dev) == 0.0)
    zero_phi = prev_zero.sum(dim=-1, keepdim=True).to(torch.float32)
    g = rnd._gamma_marsaglia(counts + beta, generator)
    u = torch.rand(counts.shape, generator=generator, device=dev)
    include = (counts > 0) | (u <= rnd.vs_inclusion_prob(zero_phi, n_k, beta,
                                                         vs_prior))
    g = torch.where(include, g.clamp_min(rnd.DIRICHLET_FLOOR), 0.0)
    return (g / g.sum(dim=-1, keepdim=True).clamp_min(rnd.DIRICHLET_FLOOR),
            ~include)


def eager_binomial(torch, n, p, generator):
    n = torch.as_tensor(n).to(torch.float32)
    p = torch.as_tensor(p).to(torch.float32).to(n.device)
    return torch.binomial(n, p.expand_as(n).contiguous(), generator=generator)


class eager_discrete:
    """Within the block, the HDP family's step after the sweep and
    ops/random.py's Poisson, Binomial, Polya-Urn and VS draws run on the
    card as they did before the draw kernels (torch.binomial,
    torch.poisson and eager PyTorch; the Gamma draws stay the Gamma
    kernel's, as they were): the "before" of the HDP, polyaurn and
    nzvsspalias profiles."""

    def __init__(self, torch, rnd):
        self.torch, self.rnd = torch, rnd

    def __enter__(self):
        from ldagroupedgibbssampler_tpu_torch.models import hdp
        torch, rnd = self.torch, self.rnd
        self.cls = hdp.PoissonPolyaUrnHDPLDAInfiniteTopics
        self.saved = (rnd.poisson, rnd.binomial, rnd.polya_urn_dirichlet,
                      rnd.vs_dirichlet, self.cls._kernel_after_sweep)
        rnd.poisson = lambda lam, gen: torch.poisson(
            torch.as_tensor(lam).to(torch.float32), generator=gen)
        rnd.binomial = lambda n, p, gen: eager_binomial(torch, n, p, gen)
        rnd.polya_urn_dirichlet = (
            lambda counts, beta, gen, zero_mask=True: eager_polya_urn(
                torch, counts, beta, gen, zero_mask))
        rnd.vs_dirichlet = lambda *a, **kw: eager_vs_dirichlet(torch, rnd,
                                                                *a, **kw)
        self.cls._kernel_after_sweep = self.cls._eager_after_sweep

    def __exit__(self, *exc):
        (self.rnd.poisson, self.rnd.binomial, self.rnd.polya_urn_dirichlet,
         self.rnd.vs_dirichlet, self.cls._kernel_after_sweep) = self.saved


def profile_against_eager(torch, rnd, model, label: str, n: int = 5,
                          eager_draws: bool = True):
    """`label`'s profile line: n iterations with the draw kernels (no
    torch.binomial or torch.poisson kernel may run) beside n more with the
    eager path they replaced, in one run; where that path drew with
    torch.binomial or torch.poisson (`eager_draws`: all but
    nzvsspalias'), it must show them, or the name check would see
    nothing. Ends with every kernel of the kernels' iterations and its
    launches an iteration. Returns (the line, profile_numbers of the
    kernels' iterations)."""
    after = profile_numbers(torch, lambda: model.sample(n), n)
    lib = library_draw_kernels(after[2])
    check(not lib, f"{label}: PyTorch's draw kernels ran: {lib}")
    with eager_discrete(torch, rnd):
        before = profile_numbers(torch, lambda: model.sample(n), n)
    lib_before = library_draw_kernels(before[2])
    check(bool(lib_before) == eager_draws, f"{label}: the eager path's "
          f"torch.binomial / torch.poisson kernels: {lib_before}")
    every = "; ".join(f"{c:g} {name[:48]}" for _, name, c in
                      sorted(after[2], key=lambda r: (-r[2], r[1])))
    text = (f"{profile_text(*after, n, 'iteration')}; no torch.binomial or "
            f"torch.poisson kernel; the same iterations on the eager path "
            f"before the draw kernels: "
            f"{profile_summary(*before, 'iteration')}"
            + (f" ({', '.join(lib_before)[:100]})" if lib_before else "")
            + f"; every kernel, launches an iteration: {every}")
    return text, after


def hdp_state(torch, corpus, LDAConfig, create_model,
              iters=HDP_STATE_ITERS):
    """A ppu_hdplda K_max=100 chain on the corpus after `iters`
    iterations: [3 hdp]'s operands (also tools/time_kernel_builds.py's)."""
    model = create_model(pcgs_config(LDAConfig, "ppu_hdplda", K))
    model.add_instances(corpus)
    model.sample(iters)
    torch.cuda.synchronize()
    return model


def psi_operands(torch, k, dev, seed=0):
    """Synthetic inputs of the psi kernel at K_max = k: 30% of the topics
    in the data (tables 1-60, n_k above them), 5% more active but empty
    (they die), the rest inactive."""
    rng = np.random.default_rng(seed)
    in_data = rng.random(k) < 0.3
    tables = np.where(in_data, rng.integers(1, 61, k), 0)
    nk = np.where(in_data, tables * rng.integers(1, 30, k), 0)
    active = in_data | (rng.random(k) < 0.05)
    return (torch.as_tensor(tables.astype(np.float32), device=dev),
            torch.as_tensor(nk.astype(np.int32), device=dev),
            torch.as_tensor(active, device=dev))


def psi_check(torch, cuda_hdp, tables, nk, active, seed, label, **kw):
    """The psi kernel against psi_reference on the same words: the active
    mask and the births exact, psi and alpha within PSI_RTOL (relative,
    zeros exact), psi summing to 1 within 1e-5. `dependent` (in kw) goes
    to the kernel only. Returns (the largest relative difference, the
    births)."""
    got = cuda_hdp.psi_step(tables, nk, active, seed, **kw)
    kw.pop("dependent", None)
    want = cuda_hdp.psi_reference(tables, nk, active, seed, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]) and torch.equal(got[3], want[3]),
          f"{label}: the active mask or the births differ from the plain "
          "version")
    rel = 0.0
    for a, b, name in ((got[0], want[0], "psi"), (got[2], want[2], "alpha")):
        check(torch.equal(a == 0, b == 0), f"{label}: {name}'s zeros differ")
        nz = b != 0
        r = float(((a - b).abs()[nz] / b[nz]).max()) if bool(nz.any()) \
            else 0.0
        check(r <= PSI_RTOL, f"{label}: {name} differs from the plain "
              f"version by {r:.3g} (relative)")
        rel = max(rel, r)
    total = float(got[0].sum())
    check(abs(total - 1.0) <= 1e-5, f"{label}: psi sums to {total}")
    return rel, int(got[3].sum())


def hdp_step_trace(torch, model) -> dict:
    """One HDP step after the sweep (`_kernel_after_sweep` on the chain's
    state) under torch.profiler: its `aten::randint` calls, the kernels
    it launched in the order they started (each with its start and end
    in us from the first one's start), and whether psi_kernel started
    right after tables_kernel (no launch between them on the stream)."""
    import re

    from torch.profiler import ProfilerActivity, profile
    st = model.state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model._kernel_after_sweep(st, st.ndk, st.nkw, st.nk)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    names = [e.name for e in kernels]
    tables = [i for i, n in enumerate(names) if "tables_kernel" in n]
    return {"randint": sum(e.name == "aten::randint" for e in events),
            "kernels": [[re.sub(r"\(.*", "", e.name.replace(
                "(anonymous namespace)::", ""))[-40:],
                round(e.time_range.start - kernels[0].time_range.start, 1),
                round(e.time_range.end - kernels[0].time_range.start, 1)]
                for e in kernels],
            "psi_follows_tables": bool(tables) and tables[-1] + 1 < len(names)
            and "psi_kernel" in names[tables[-1] + 1]}


def ks_against(torch, mine, library) -> float:
    """Two-sample KS p of the kernel's draws against the library's."""
    from scipy import stats as sps
    return float(sps.ks_2samp(mine.cpu().numpy(),
                              library.cpu().numpy()).pvalue)


def hdp_large_k_case(torch, corpus, dev, k=HDP_LARGE_K):
    """[3 hdp]'s large-K operands: n_dk [D, k] int32, a recount of a
    uniform z, and a concentration vector alpha0 psi (psi a normalised
    Gamma(0.3) draw, alpha0 = 5) f32 [k]."""
    z = np.random.default_rng(17).integers(0, k, corpus.num_tokens)
    ndk = recount(corpus, z, k)[1].astype(np.int32)
    rng = np.random.default_rng(18)
    psi = rng.gamma(0.3, size=k)
    return (torch.as_tensor(ndk, device=dev),
            torch.as_tensor((5.0 * psi / psi.sum()).astype(np.float32),
                            device=dev))


def hdp_phase(torch, corpus, model, rnd, smi, _build, parent=None):
    """[3 hdp]: the table counts (csrc/hdp.cu, two launches, the second a
    programmatic dependent launch) and the psi kernel (one). On a
    ppu_hdplda K_max=100 chain after HDP_STATE_ITERS iterations: the table
    counts (alpha0 psi, and hlda's scalar gamma) equal to
    table_counts_reference on the same Philox words in both instances,
    each call's launches counted, and ge equal to the eager bincount path
    (models/hdp.py::doc_count_ge_histogram); the same at K=HDP_LARGE_K
    (the global instance) on a uniform z's n_dk; the psi kernel
    on that chain's tables against its plain version; on synthetic inputs
    at K_max=4096 every birth rule x psi sampler x index prior (psi_check),
    and at PSI_EXTRA_K three of them (one block; clusters of 2 and 8);
    psi as the table counts' dependent launch at K=100 and 4096; one HDP
    step after the sweep under the profiler (hdp_step_trace: one
    `randint`, psi_kernel right after tables_kernel on the stream).
    The elementwise Binomial kernel equal to its plain version, and KS
    against torch.binomial at BINOMIAL_KS. Times by CUDA events beside the
    plain versions, the eager path they replaced and the bound; ptxas's
    registers and the first launch's blocks an SM of each instance; with
    `parent` (a checkout), the parent's table counts and these in turns
    (parent_times). Returns the kernels-JSON entries of the table counts
    and of psi."""
    from ldagroupedgibbssampler_tpu_torch.models import hdp
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_hdp
    dev = torch.device("cuda", 0)
    cfg, st = model.config, model.state
    ndk, alpha, m = st.ndk, st.alpha, model._max_count
    d_, k_ = ndk.shape
    seed = torch.tensor([0x0DDC_0FFE_E123], dtype=torch.int64, device=dev)
    ge_eager = hdp.doc_count_ge_histogram(ndk, m)
    instance = cuda_hdp.hist_instance(k_, m, dev)
    check(instance == "shared", f"[3 hdp] K={k_}, M={m} takes the {instance} "
          "instance")
    launches = {}
    large_ndk, large_alpha = hdp_large_k_case(torch, corpus, dev)
    large_m = m                       # the longest document, as at K=100
    check(cuda_hdp.hist_instance(HDP_LARGE_K, large_m, dev) == "global",
          f"[3 hdp] K={HDP_LARGE_K} takes the shared instance")
    large_ge = hdp.doc_count_ge_histogram(large_ndk, large_m)
    for label, nd, mm, ge_want, a_of, insts in (
            ("K=100", ndk, m, ge_eager, (alpha, cfg.hdp_gamma),
             ("shared", "global")),
            (f"K={HDP_LARGE_K}", large_ndk, large_m, large_ge,
             (large_alpha, cfg.hdp_gamma), ("global",))):
        for a in a_of:
            what = "alpha0 psi" if isinstance(a, torch.Tensor) else "gamma"
            want = cuda_hdp.table_counts_reference(nd, a, mm, seed)
            for inst in insts:
                ge = torch.empty(ge_want.shape, dtype=torch.int32, device=dev)
                scratch = torch.zeros((nd.shape[1], mm), dtype=torch.int32,
                                      device=dev)
                before = cuda_hdp.table_counts.launches
                got = cuda_hdp.table_counts(nd, a, mm, seed, ge=ge,
                                            instance=inst, hist=scratch)
                launches[inst] = cuda_hdp.table_counts.launches - before
                torch.cuda.synchronize()
                check(torch.equal(ge, ge_want), f"[3 hdp] ge ({label}, "
                      f"{what}, {inst}) differs from the eager bincount path")
                check(torch.equal(got, want), f"[3 hdp] table counts "
                      f"({label}, {what}, {inst}) differ from the plain "
                      f"version on {int((got != want).sum())} topics")
                check(not bool(scratch.any()), f"[3 hdp] {label} {inst}: the "
                      "scratch is not left zero")
    check(launches == {"shared": 2, "global": 2}, f"[3 hdp] table counts' "
          f"launches a call {launches}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    p = cuda_hdp.table_probs(alpha, m, dev)
    ge_f = ge_eager.to(torch.float32)
    hist = torch.zeros((k_, m), dtype=torch.int32, device=dev)
    tab_ms = time_ms(torch, lambda: cuda_hdp.table_counts(ndk, alpha, m,
                                                          seed, hist=hist))
    tab_global_ms = time_ms(torch, lambda: cuda_hdp.table_counts(
        ndk, alpha, m, seed, instance="global", hist=hist))
    large_hist = torch.zeros((HDP_LARGE_K, large_m), dtype=torch.int32,
                             device=dev)
    tab_large_ms = time_ms(torch, lambda: cuda_hdp.table_counts(
        large_ndk, large_alpha, large_m, seed, hist=large_hist))
    occupancy = {inst: cuda_hdp.hist_blocks_per_sm(k_, m, inst, dev)
                 for inst in ("shared", "global")}
    regs = {name: ptxas_registers(_build, name)
            for name in ("hist_kernel", "tables_kernel")}
    parents = parent_times("hdp", parent, [
        "tables K=100", "tables K=100 global", "psi K=100", "psi K=4096 gem",
        "psi K=4096 poisson", "iteration ppu_hdplda K=100"]) \
        if parent else None
    tab_plain_ms = once_ms(torch, lambda: cuda_hdp.table_counts_reference(
        ndk, alpha, m, seed))
    with eager_discrete(torch, rnd):
        tab_eager_ms = time_ms(torch, lambda: hdp.sample_table_counts(
            ndk, alpha, m, gen), reps=5, calls=3)
    tab_binomial_ms = time_ms(torch, lambda: torch.binomial(
        ge_f, p, generator=gen))
    draws = int(((ge_eager > 0) & (p > 0) & (p < 1)).sum())
    tab_bytes = 4 * d_ * k_ + 8 * k_
    tab_bound, tab_by = bound(tab_bytes, 0.0, draws * PHILOX_MULTIPLIES,
                              2 * draws)
    # psi at K_max = 100 on the chain's own table counts
    tables = cuda_hdp.table_counts(ndk, alpha, m, seed)
    kw = dict(gamma=cfg.hdp_gamma, budget=cfg.hdp_birth_budget,
              births="candidates", sampler=cfg.hdp_psi_sampler,
              dist=cfg.hdp_gamma_dist, alpha0=float(cfg.alpha))
    rel100, _ = psi_check(torch, cuda_hdp, tables, st.nk, st.active, seed,
                          "[3 hdp] psi K=100", **kw)
    psi_ms = time_ms(torch, lambda: cuda_hdp.psi_step(tables, st.nk,
                                                      st.active, seed, **kw))
    psi_plain_ms = once_ms(torch, lambda: cuda_hdp.psi_reference(
        tables, st.nk, st.active, seed, **kw))

    def eager_psi():
        active, _births = model._update_active(st, st.nk)
        psi = hdp.gem_psi(tables, cfg.hdp_gamma, gen)
        return float(cfg.alpha) * psi * active
    with eager_discrete(torch, rnd):
        psi_eager_ms = time_ms(torch, eager_psi, reps=5, calls=3)
    psi_bytes = 22 * k_
    # two Gamma draws a topic, a Philox block each at least, ~5 special
    # functions a round
    psi_bound, psi_by = bound(psi_bytes, 0.0, 2 * k_ * PHILOX_MULTIPLIES,
                              10 * k_)
    # K_max = 4096: every birth rule, psi sampler and index prior
    rel4096, born = 0.0, {}
    t4, n4, a4 = psi_operands(torch, HDP_PSI_K, dev)
    for births, sampler, dist in PSI_CASES:
        r, b = psi_check(torch, cuda_hdp, t4, n4, a4, seed,
                         f"[3 hdp] psi K={HDP_PSI_K} {births} {sampler} "
                         f"{dist}", gamma=3.0, budget=32, births=births,
                         sampler=sampler, dist=dist, alpha0=0.5)
        rel4096 = max(rel4096, r)
        born[f"{births} {dist}"] = b
    psi4096_ms = {s: time_ms(torch, lambda s=s: cuda_hdp.psi_step(
        t4, n4, a4, seed, gamma=3.0, budget=32, births=b_, sampler=s,
        alpha0=0.5)) for s, b_ in (("gem", "candidates"),
                                   ("poisson", "lowest"))}
    psi4096_plain_ms = once_ms(torch, lambda: cuda_hdp.psi_reference(
        t4, n4, a4, seed, gamma=3.0, budget=32, births="candidates",
        sampler="gem", alpha0=0.5))
    # the launch's geometry at other K (slices of a cluster, one chunk or
    # more), and psi as the dependent of the table counts' second launch
    for k in PSI_EXTRA_K:
        tk_, nk_, ak_ = psi_operands(torch, k, dev, seed=k)
        for births, sampler in (("candidates", "gem"), ("lowest", "poisson"),
                                ("lowest", "gem")):
            r, _ = psi_check(torch, cuda_hdp, tk_, nk_, ak_, seed,
                             f"[3 hdp] psi K={k} {births} {sampler}",
                             gamma=3.0, budget=32, births=births,
                             sampler=sampler, alpha0=0.5)
            rel4096 = max(rel4096, r)
    tables = cuda_hdp.table_counts(ndk, alpha, m, seed)
    rel_dep, _ = psi_check(torch, cuda_hdp, tables, st.nk, st.active, seed,
                           "[3 hdp] psi K=100 dependent", dependent=True,
                           **kw)
    # a cluster of 8 as the dependent: the table counts at K=4096
    tables = cuda_hdp.table_counts(large_ndk, large_alpha, large_m, seed)
    r, _ = psi_check(torch, cuda_hdp, tables, n4, a4, seed,
                     f"[3 hdp] psi K={HDP_PSI_K} dependent", dependent=True,
                     gamma=3.0, budget=32, births="candidates",
                     sampler="gem", alpha0=0.5)
    rel_dep = max(rel_dep, r)
    step_trace = hdp_step_trace(torch, model)
    check(step_trace["randint"] == 1 and step_trace["psi_follows_tables"],
          f"[3 hdp] the HDP step: {json.dumps(step_trace)}")
    # the elementwise Binomial: plain-version agreement, KS, time
    n_all = torch.cat([torch.full((DRAW_KS,), float(n)) for n, _ in
                       BINOMIAL_KS]).to(dev)
    p_all = torch.cat([torch.full((DRAW_KS,), q) for _, q in
                       BINOMIAL_KS]).to(dev)
    got = cuda_hdp.binomial(n_all, p_all, seed)
    want = cuda_hdp.binomial_reference(n_all, p_all, seed)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"[3 hdp] Binomial kernel differs from "
          f"its plain version on {int((got != want).sum())} of "
          f"{got.numel()} draws")
    lib = torch.binomial(n_all, p_all, generator=gen)
    ks = {}
    for i, (n, q) in enumerate(BINOMIAL_KS):
        sl = slice(i * DRAW_KS, (i + 1) * DRAW_KS)
        ks[f"{n},{q}"] = ks_against(torch, got[sl], lib[sl])
        check(ks[f"{n},{q}"] > 1e-4, f"[3 hdp] Binomial({n}, {q}) KS "
              f"against torch.binomial p={ks[f'{n},{q}']:.2e}")
    bin_ms = time_ms(torch, lambda: cuda_hdp.binomial(n_all, p_all, seed))
    bin_lib_ms = time_ms(torch, lambda: torch.binomial(n_all, p_all,
                                                       generator=gen))
    print(f"[3 hdp] {smi}: ppu_hdplda K_max=100 after {HDP_STATE_ITERS} "
          f"iterations, D={d_}, M={m} (longest document): table counts "
          f"equal to the plain version on the same Philox words (alpha0 psi "
          f"and hlda's gamma, shared and global instances; "
          f"{instance} here: a [{k_}, {m}] histogram in shared memory), "
          f"ge equal to the "
          f"eager bincount path, the scratch left zero; {tab_ms:.4f} ms "
          f"({launches['shared']} launches), global instance "
          f"{tab_global_ms:.4f} ms "
          f"({launches['global']}), plain {tab_plain_ms:.2f} ms, "
          f"eager path (bincount + torch.binomial) {tab_eager_ms:.4f} ms, "
          f"torch.binomial of the draws alone {tab_binomial_ms:.4f} ms, "
          f"bound {tab_bound:.4f} ms ({tab_by}: {tab_bytes / 1e6:.2f} MB, "
          f"{draws} draws); psi K=100 (births, GEM) within "
          f"{rel100:.2g} of the plain version, births and active exact, "
          f"{psi_ms:.4f} ms (1 launch), plain {psi_plain_ms:.2f} ms, eager "
          f"path (births + GEM + alpha) {psi_eager_ms:.4f} ms, bound "
          f"{psi_bound:.5f} ms ({psi_by}); as the table counts' dependent "
          f"within {rel_dep:.2g}; psi launches "
          f"{json.dumps({k: cuda_hdp.psi_launch_shape(k) for k in (K, HDP_PSI_K)})}"
          f"; ptxas psi_kernel "
          f"{json.dumps(ptxas_registers(_build, 'psi_kernel'))}; the HDP "
          f"step by the profiler {json.dumps(step_trace)}", flush=True)
    print(f"[3 hdp] table counts at K={HDP_LARGE_K} (uniform z, n_dk up to "
          f"{int(large_ndk.max())}, M={large_m}, global instance) equal "
          f"to the plain version, ge to the eager path, scratch left zero; "
          f"{tab_large_ms:.4f} ms; first "
          f"launch blocks an SM {json.dumps(occupancy)}; ptxas "
          f"{json.dumps(regs)}; parent and this checkout in turns (ms, "
          f"medians) {json.dumps(parents)}", flush=True)
    print(f"[3 hdp] K_max={HDP_PSI_K} synthetic: psi kernel against the "
          f"plain version for {len(PSI_CASES)} cases (birth rules x "
          f"samplers x index priors; and at K={list(PSI_EXTRA_K)}): births "
          f"and active exact, psi and alpha within {rel4096:.2g} (bar "
          f"{PSI_RTOL}), births "
          f"{json.dumps(born)}; gem {psi4096_ms['gem']:.4f} ms, poisson "
          f"{psi4096_ms['poisson']:.4f} ms, plain {psi4096_plain_ms:.2f} ms; "
          f"Binomial kernel equal to its plain version on {got.numel()} "
          f"draws, KS against torch.binomial {json.dumps(ks)}, "
          f"{bin_ms:.4f} ms against torch.binomial {bin_lib_ms:.4f} ms",
          flush=True)
    src = "ldagroupedgibbssampler_tpu_torch/csrc/hdp.cu"
    tab_entry = {
        "name": "hdp_table_counts", "route": "cuda", "source": src,
        "replaces": "ldagroupedgibbssampler_tpu/models/hdp.py:96",
        "max_abs_err": 0.0, "ms": tab_ms, "global_ms": tab_global_ms,
        f"k{HDP_LARGE_K}_ms": tab_large_ms, "launches_a_call": launches,
        "blocks_an_sm": occupancy, "ptxas": regs, "parent_times": parents,
        "instance": instance, "plain_ms": tab_plain_ms,
        "eager_ms": tab_eager_ms, "bound_ms": tab_bound, "bound_by": tab_by,
        "library_ms": None, "torch_binomial_ms": tab_binomial_ms,
        "draws": draws, "M": m,
        "binomial": {"ms": bin_ms, "library_ms": bin_lib_ms, "ks": ks,
                     "draws": got.numel()}}
    psi_entry = {
        "name": "hdp_psi", "route": "cuda", "source": src,
        "replaces": "ldagroupedgibbssampler_tpu/models/hdp.py:129",
        "max_abs_err": 0.0, "max_rel_err": max(rel100, rel4096),
        "ms": psi_ms, "plain_ms": psi_plain_ms, "eager_ms": psi_eager_ms,
        "bound_ms": psi_bound, "bound_by": psi_by, "library_ms": None,
        "k4096": {"ms": psi4096_ms, "plain_ms": psi4096_plain_ms,
                  "births": born},
        "launch": cuda_hdp.psi_launch_shape(K), "step_trace": step_trace}
    return tab_entry, psi_entry


def urn_operands(torch, corpus, dev):
    """The K=200 case of [3 polya-urn] and [3 vs-dirichlet]: N_kw [200,
    V] int32, a recount of a uniform z."""
    z = np.random.default_rng(11).integers(0, 200, corpus.num_tokens)
    nkw200 = recount(corpus, z, 200)[0].T.astype(np.int32)
    return torch.as_tensor(np.ascontiguousarray(nkw200), device=dev)


def urn_edge_cases(torch, dev, seed=19):
    """[3 polya-urn]'s geometry and type cases: f32 counts with fractional
    values, integers 0..12 and negatives, and NaN on [13, 37] (rows of two
    groups, the second of 5 columns) and on [3, 4,100]; int32 Poisson
    counts on [2, URN_LONG_ROW] (long rows, a head of counts 10..499) with
    an active mask [True, False]."""
    rng = np.random.default_rng(seed)
    out = {}
    for shape in ((13, 37), (3, 4100)):
        x = rng.integers(0, 13, shape).astype(np.float32)
        x = np.where(rng.random(shape) < 0.2, x + rng.random(shape), x)
        x[0, :3] = (-1.0, np.nan, 9.999)
        x[-1] = 0.0                                   # an all-zero row
        out[f"f32 {list(shape)}"] = (torch.as_tensor(x, device=dev), None)
    long_rows = rng.poisson(0.4, (2, URN_LONG_ROW)).astype(np.int32)
    long_rows[:, :50] = rng.integers(10, 500, (2, 50))
    out[f"int32 [2, {URN_LONG_ROW}] active [True, False]"] = (
        torch.as_tensor(long_rows, device=dev),
        torch.tensor([True, False], device=dev))
    return out


def polya_urn_phase(torch, corpus, model, smi, _build, parent=None):
    """[3 polya-urn]: the Polya-Urn rows (csrc/polya_urn.cu, two launches,
    the draws' 32-column groups dealt over a one-wave grid) at [100,
    20,000] (a ppu_hdplda chain's N_kw, with and without its active mask)
    and [200, 20,000] (a uniform z's), and on urn_edge_cases: phi and the
    zero
    mask equal to polya_urn_reference on the same words, phi equal to the
    elementwise Poisson kernel's counts normalised, those counts against
    torch.poisson on the same rates (a chi-square of the values 0, 1 and 2+
    where lam < 10, KS of the standardised counts where lam >= 10); the
    elementwise Poisson kernel equal to its plain version on POISSON_GRID
    and KS against torch.poisson there. Times beside the plain version,
    the eager path it replaced and torch.poisson; the draw launch's grid
    with its blocks an SM, ptxas's registers; with
    `parent` (a checkout), the parent's rows and these in turns
    (parent_times). Returns the kernels-JSON entry."""
    from scipy import stats as sps

    from ldagroupedgibbssampler_tpu_torch.ops import cuda_polya_urn
    dev = torch.device("cuda", 0)
    nkw100, active = model.state.nkw, model.state.active
    seed = torch.tensor([0x0CAB_BA6E_5EED], dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    beta = 0.01
    cases = {"K=100": (nkw100, None), "K=100 active": (nkw100, active),
             "K=200": (urn_operands(torch, corpus, dev), None)}
    res, shapes = {}, {}
    for label, (nkw, act) in (cases | urn_edge_cases(torch, dev)).items():
        before = cuda_polya_urn.polya_urn.launches
        phi, zero = cuda_polya_urn.polya_urn(nkw, beta, seed, act,
                                             zero_mask=True)
        check(cuda_polya_urn.polya_urn.launches - before == 2,
              f"[3 polya-urn] {label}: not two launches")
        want, want_zero = cuda_polya_urn.polya_urn_reference(nkw, beta, seed,
                                                             act, True)
        torch.cuda.synchronize()
        check(torch.equal(phi, want), f"[3 polya-urn] {label}: phi "
              f"differs from the plain version "
              f"({int((phi != want).sum())} values)")
        check(torch.equal(zero, want_zero), f"[3 polya-urn] {label}: the "
              "zero mask differs from the plain version")
        shapes[label] = cuda_polya_urn.urn_occupancy(
            nkw.numel() // nkw.shape[-1], nkw.shape[-1], dev)
        if label not in cases:
            continue
        if act is not None:
            check(bool((phi[~act] == 0).all()), f"[3 polya-urn] {label}: an "
                  "inactive row is not zero")
            continue
        lam = nkw.to(torch.float32) + beta
        c = cuda_polya_urn.poisson(lam, seed)
        total = c.double().sum(dim=-1, keepdim=True).to(torch.float32)
        check(torch.equal(phi, torch.where(total > 0, c / total.clamp_min(1.0),
                                           1.0 / c.shape[-1])),
              f"[3 polya-urn] {label}: phi is not the Poisson kernel's counts "
              "normalised")
        lib = torch.poisson(lam, generator=gen)
        small = lam < 10
        rows = [[int(((x == 0) & small).sum()), int(((x == 1) & small).sum()),
                 int(((x >= 2) & small).sum())] for x in (c, lib)]
        chi_p = float(sps.chi2_contingency(np.array(rows))[1])
        big = ~small
        sd = lam[big].sqrt()
        ks_p = ks_against(torch, (c[big] - lam[big]) / sd,
                          (lib[big] - lam[big]) / sd)
        check(chi_p > 1e-4 and ks_p > 1e-4, f"[3 polya-urn] {label}: counts "
              f"against torch.poisson chi2 p={chi_p:.2e}, KS p={ks_p:.2e}")
        ms = time_ms(torch, lambda: cuda_polya_urn.polya_urn(nkw, beta,
                                                             seed))
        plain_ms = once_ms(torch, lambda: cuda_polya_urn.polya_urn_reference(
            nkw, beta, seed))
        eager_ms = time_ms(torch, lambda: eager_polya_urn(torch, nkw, beta,
                                                          gen))
        torch_poisson_ms = time_ms(torch, lambda: torch.poisson(
            lam, generator=gen))
        n_el, n_big = nkw.numel(), int(big.sum())
        nbytes = 8 * n_el
        # a Philox block an element (PTRS: ~1.2 rounds), one exp or log
        int_ops = (n_el + 0.2 * n_big) * PHILOX_MULTIPLIES
        b_ms, by = bound(nbytes, 0.0, int_ops, n_el + 4 * n_big)
        res[label] = dict(ms=ms, plain_ms=plain_ms, eager_ms=eager_ms,
                          torch_poisson_ms=torch_poisson_ms, bound_ms=b_ms,
                          bound_by=by, chi_p=chi_p, ks_p=ks_p,
                          zeros=float(zero.float().mean()), big=n_big)
    # the elementwise Poisson kernel on the grid
    lam_all = torch.cat([torch.full((DRAW_KS,), v) for v in
                         POISSON_GRID]).to(dev)
    got = cuda_polya_urn.poisson(lam_all, seed)
    want = cuda_polya_urn.poisson_reference(lam_all, seed)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"[3 polya-urn] Poisson kernel differs "
          f"from its plain version on {int((got != want).sum())} draws")
    lib = torch.poisson(lam_all, generator=gen)
    ks = {}
    for i, v in enumerate(POISSON_GRID):
        sl = slice(i * DRAW_KS, (i + 1) * DRAW_KS)
        ks[str(v)] = ks_against(torch, got[sl], lib[sl])
        check(ks[str(v)] > 1e-4, f"[3 polya-urn] Poisson({v}) KS against "
              f"torch.poisson p={ks[str(v)]:.2e}")
    pois_ms = time_ms(torch, lambda: cuda_polya_urn.poisson(lam_all, seed))
    pois_lib_ms = time_ms(torch, lambda: torch.poisson(lam_all,
                                                       generator=gen))
    active_ms = time_ms(torch, lambda: cuda_polya_urn.polya_urn(
        nkw100, beta, seed, active))
    regs = {name: ptxas_registers(_build, name)
            for name in ("urn_draw_kernel", "urn_normalise_kernel")}
    parents = parent_times("polya_urn", parent, [
        "rows K=100", "rows K=100 active", "rows K=200",
        "poisson K=100"]) if parent else None
    for label, r in res.items():
        print(f"[3 polya-urn] {label} {smi}: phi and its zeros equal to the "
              f"plain version (with the active mask too, inactive rows 0), "
              f"phi the Poisson kernel's counts normalised, "
              f"{100 * r['zeros']:.2f}% exact zeros; counts against "
              f"torch.poisson: chi2 p={r['chi_p']:.3g} (0, 1, 2+ where lam < "
              f"10), KS p={r['ks_p']:.3g} ({r['big']} rates >= 10); "
              f"{r['ms']:.4f} ms (2 launches), plain {r['plain_ms']:.2f} ms, "
              f"eager path {r['eager_ms']:.4f} ms, torch.poisson alone "
              f"{r['torch_poisson_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    print(f"[3 polya-urn] Poisson kernel equal to its plain version on "
          f"{got.numel()} draws at {POISSON_GRID}, KS against torch.poisson "
          f"{json.dumps(ks)}; {pois_ms:.4f} ms against torch.poisson "
          f"{pois_lib_ms:.4f} ms", flush=True)
    print(f"[3 polya-urn] rows equal to the plain version also on "
          f"{', '.join(k for k in shapes if k not in cases)}; K=100 with the "
          f"active mask {active_ms:.4f} ms; the draw launch's grid "
          f"{json.dumps(shapes)}; ptxas {json.dumps(regs)}; parent "
          f"and this checkout in turns (ms, medians) {json.dumps(parents)}",
          flush=True)
    main = res["K=100"]
    return {"name": "polya_urn", "route": "cuda",
            "source": "ldagroupedgibbssampler_tpu_torch/csrc/polya_urn.cu",
            "replaces": "ldagroupedgibbssampler_tpu/ops/random.py:185",
            "max_abs_err": 0.0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "eager_ms": main["eager_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "torch_poisson_ms": main["torch_poisson_ms"],
            "cases": res, "active_ms": active_ms, "launch_shape": shapes,
            "ptxas": regs, "parent_times": parents,
            "poisson": {"ms": pois_ms, "library_ms": pois_lib_ms, "ks": ks,
                        "draws": got.numel()}}


def vs_dirichlet_phase(torch, corpus, model, rnd, smi, _build, parent=None):
    """[3 vs-dirichlet]: the VS-Dirichlet kernel (csrc/vs_dirichlet.cu,
    one launch, a row a thread-block cluster) at [100, 20,000] (a
    ppu_hdplda chain's N_kw, its Polya-Urn phi as the previous draw) and [200, 20,000] (a uniform z's N_kw, a
    Polya-Urn draw of it as the previous phi), without a previous draw,
    and at [2, VS_LONG_ROW] (Poisson counts, a previous phi 40% zeros:
    slices longer than the shared memory holds): the inclusion pattern
    equal to vs_dirichlet_reference's on the same words but proven ties (|u - p| <= VS_TIE), the values within
    GAMMA_RTOL (relative), rows summing to 1. Times beside the plain
    version and the eager path it replaced (no PyTorch call computes it);
    the cluster geometry (cuda_gamma.vs_launch_shape) and ptxas's
    registers. With `parent` (a checkout), also the parent's rows and
    these in turns (parent_times). Returns the kernels-JSON entry."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_gamma, cuda_polya_urn
    dev = torch.device("cuda", 0)
    nkw100, phi100 = model.state.nkw, model.state.phi
    seed = torch.tensor([0x05EE_D0F0_0D42], dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    beta, prior = 0.01, 0.5
    nkw200 = urn_operands(torch, corpus, dev)
    phi200 = cuda_polya_urn.polya_urn(nkw200, beta, seed)[0]
    # rows longer than a cluster's shared memory holds: each slice keeps
    # its first chunks there and the rest in the output
    long_counts = torch.poisson(torch.full((2, VS_LONG_ROW), 0.3,
                                           device=dev), generator=gen)
    u_prev = torch.rand((2, VS_LONG_ROW), device=dev, generator=gen)
    long_prev = torch.where(u_prev < 0.4, 0.0, u_prev)
    check(cuda_gamma.vs_launch_shape(VS_LONG_ROW)[3]
          < cuda_gamma.vs_launch_shape(VS_LONG_ROW)[1],
          "[3 vs-dirichlet] the long rows fit the shared memory")
    res = {}
    for label, nkw, prev in (("K=100", nkw100, phi100),
                             ("K=200", nkw200, phi200),
                             ("K=100 dense previous", nkw100, None),
                             (f"long rows [2, {VS_LONG_ROW}]",
                              long_counts.to(torch.int32), long_prev)):
        phi, excl = cuda_gamma.vs_dirichlet(nkw, beta, prior, seed, prev,
                                            zero_mask=True)
        want, want_excl = cuda_gamma.vs_dirichlet_reference(nkw, beta, prior,
                                                            seed, prev, True)
        torch.cuda.synchronize()
        differ = excl != want_excl
        ties = int(differ.sum())
        if ties:
            counts = nkw.to(torch.float32)
            n_k = counts.double().sum(-1, keepdim=True).to(torch.float32)
            zp = (torch.zeros_like(n_k) if prev is None else
                  (prev == 0).sum(-1, keepdim=True).to(torch.float32))
            p = rnd.vs_inclusion_prob(zp, n_k, beta, prior).expand_as(counts)
            u = cuda_gamma.vs_uniforms(counts.shape, seed, dev)
            gap = (u - p).abs()[differ]
            check(bool((counts[differ] == 0).all())
                  and float(gap.max()) <= VS_TIE, f"[3 vs-dirichlet] "
                  f"{label}: {ties} inclusions differ, not proven ties")
        same = ~differ & ~want_excl
        err = (phi - want).abs()[same]
        rel = float((err / want[same]).max())
        check(rel <= GAMMA_RTOL, f"[3 vs-dirichlet] {label}: values differ "
              f"by {rel:.3g} (relative)")
        sums = phi.double().sum(-1)
        check(bool(((sums - 1).abs() <= 1e-5).all()), f"[3 vs-dirichlet] "
              f"{label}: a row does not sum to 1")
        ms = time_ms(torch, lambda: cuda_gamma.vs_dirichlet(nkw, beta, prior,
                                                            seed, prev))
        plain_ms = once_ms(torch, lambda: cuda_gamma.vs_dirichlet_reference(
            nkw, beta, prior, seed, prev))
        eager_ms = time_ms(torch, lambda: eager_vs_dirichlet(
            torch, rnd, nkw, beta, prior, gen, prev))
        n_el = nkw.numel()
        nbytes = (12 if prev is not None else 8) * n_el
        # every value's uniform, and for the included ones (an excluded
        # value draws no Gamma) a Gamma round and the boost where count +
        # beta < 1: Philox blocks; ~5 special functions a round, 2 for the
        # boost. bound_all_ms: with a Gamma for every value, as a kernel that
        # draws them all needs
        incl = ~excl
        n_inc = int(incl.sum())
        boosted = int((incl & (nkw == 0)).sum())
        b_ms, by = bound(nbytes, 0.0,
                         (n_el + n_inc + boosted) * PHILOX_MULTIPLIES,
                         5 * n_inc + 2 * boosted)
        zeros = int((nkw == 0).sum())
        b_all, _ = bound(nbytes, 0.0, (2 * n_el + zeros) * PHILOX_MULTIPLIES,
                         5 * n_el + 2 * zeros)
        shape = dict(zip(("cluster", "slice", "chunk", "resident",
                          "smem_bytes"),
                         cuda_gamma.vs_launch_shape(nkw.shape[-1])))
        res[label] = dict(ms=ms, plain_ms=plain_ms, eager_ms=eager_ms,
                          bound_ms=b_ms, bound_by=by, bound_all_ms=b_all,
                          ties=ties,
                          max_rel_err=rel, max_abs_err=float(err.max()),
                          included=float((~excl).float().mean()),
                          launch_shape=shape)
        print(f"[3 vs-dirichlet] {label} {smi}: inclusion pattern equal to "
              f"the plain version's but {ties} proven ties, "
              f"{100 * res[label]['included']:.2f}% of the coordinates "
              f"included, values within {rel:.2g} (bar {GAMMA_RTOL}), rows "
              f"sum to 1; {ms:.4f} ms (1 launch, {nkw.shape[0]} clusters "
              f"{json.dumps(shape)}), plain {plain_ms:.2f} ms, eager path "
              f"{eager_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; with a Gamma "
              f"for every value {b_all:.4f})", flush=True)
    regs = ptxas_registers(_build, "vs_kernel")
    parents = parent_times("vs_dirichlet", parent) if parent else None
    print(f"[3 vs-dirichlet] ptxas vs_kernel {json.dumps(regs)}; parent "
          f"and this checkout in turns (ms, medians) {json.dumps(parents)}",
          flush=True)
    main = res["K=100"]
    return {"name": "vs_dirichlet", "route": "cuda",
            "source": "ldagroupedgibbssampler_tpu_torch/csrc/vs_dirichlet.cu",
            "replaces": "ldagroupedgibbssampler_tpu/ops/random.py:262",
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "max_rel_err": max(r["max_rel_err"] for r in res.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "eager_ms": main["eager_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "cases": res,
            "ptxas": regs, "parent_times": parents}


# ---- [3 pairwise]: the elementwise pairwise metrics and the KS merge ----
PAIRWISE_METRICS = ("manhattan", "chebychev", "canberra", "jaccard", "js",
                    "ks", "uber")
PAIRWISE_EXACT = ("chebychev", "ks")     # a max, integer gaps: bit-equal
PAIRWISE_TOL = 1e-5                      # rtol and atol of the other five
PAIRWISE_TEST, PAIRWISE_TRAIN = 5635, 5634   # the 2-fold 20NG halves
PAIRWISE_SHAPES = (("a", PAIRWISE_TEST, PAIRWISE_TRAIN, K),
                   ("b", 512, 512, 4096), ("c", 301, 203, 37))
# f32 operations and special-function calls a (pair, coordinate), as
# csrc/pairwise.cu's header counts them (a division's reciprocal is one
# special-function call); KS: operations a merge step, the steps that
# these rows need (ks_merge_steps)
PAIRWISE_OPS = {"manhattan": (3, 0), "chebychev": (3, 0),
                "canberra": (7, 1), "jaccard": (4, 0), "js": (7, 0),
                "uber": (13, 1)}
JS_OPS_LOGF = (12, 1)          # js before its closed form: logf a term
KS_STEP_OPS = 6
# the metrics whose kernels were redesigned, timed at (b) and against a
# parent checkout (--parent)
PAIRWISE_REDESIGNED = ("uber", "ks", "js", "canberra", "chebychev",
                       "jaccard", "manhattan")
# manhattan's, chebychev's and jaccard's kernel (minmax_kernel): two FADDs,
# or one FADD and one FMNMX, a term, so 2 issued instructions a term at 4
# schedulers x 32 lanes a clock an SM is its floor (FMNMX's 16-lane ALU
# gives the same), at the 1.98 GHz of F32_OPS_PER_S
MINMAX_INSTRUCTIONS = 2
INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9
# SASS opcodes by pipe: Hopper's 16-lane ALU (two clocks a warp) and its
# FMA pipes; the rest only take an issue slot
SASS_ALU = ("FMNMX", "FSETP", "FSEL", "ISETP", "IADD3", "LOP3", "LEA",
            "SHF", "SEL", "IMNMX", "PLOP3", "MOV")
SASS_FMA = ("FADD", "FMUL", "FFMA", "IMAD")
PAIRWISE_LIBRARY = {"manhattan": 1.0, "chebychev": float("inf")}
PAIRWISE_JAX_LINE = {"js": 69, "manhattan": 113, "chebychev": 118,
                     "canberra": 123, "jaccard": 138, "ks": 169, "uber": 198}


def pairwise_rows(n: int, k: int, seed: int) -> np.ndarray:
    """n Dirichlet(0.1) rows over k with ~30% of the coordinates set to an
    exact 0 and renormalised (a row left empty stays all zero), float32."""
    rng = np.random.default_rng(seed)
    x = rng.dirichlet(np.full(k, 0.1), n)
    x[rng.random((n, k)) < 0.3] = 0.0
    s = x.sum(axis=1, keepdims=True)
    return (x / np.where(s > 0, s, 1.0)).astype(np.float32)


def pairwise_edge_rows(k: int) -> tuple:
    """Edge rows, x row i against y row i: an identical pair, disjoint
    supports, all-zero rows, and a heavily tied pair (the values 0 and
    2 / k only, shifted by one coordinate)."""
    base = pairwise_rows(1, k, 11)[0]
    low = np.where(np.arange(k) < k // 2, 1.0 / (k // 2), 0.0)
    tied = np.where(np.arange(k) % 2 == 0, 2.0 / k, 0.0)
    X = np.stack([base, low, np.zeros(k), tied]).astype(np.float32)
    Y = np.stack([base, low[::-1], np.zeros(k), np.roll(tied, 1)]
                 ).astype(np.float32)
    return X, Y


def pairwise_off_path_rows(X, Y) -> tuple:
    """Copies of X and Y (numpy, K >= 8, M > 101, N > 70) with values that
    send the blocks of X's first 64 rows off canberra's scaled division
    and js's closed form to the general terms (csrc/pairwise.cu): in x row 0
    a negative value, a NaN and a subnormal value, in row 1 an inf, in
    row 2 a value of 2^40; and subnormal values in blocks that stay on
    both paths: a few in x row 100 and y row 70, and x row 101 holding
    only subnormal values (js about 16 against normalised rows)."""
    X, Y = X.copy(), Y.copy()
    X[0, :3] = np.array([-0.25, np.nan, 1e-40], np.float32)
    X[1, 3] = np.inf
    X[2, 4] = 2.0 ** 40
    X[100, :4] = np.array([1e-40, 3e-39, 1e-45, 0.0], np.float32)
    Y[70, 4:8] = np.array([2e-40, 0.0, 1e-44, 5e-39], np.float32)
    X[101] = 0.0
    X[101, 1:5] = np.array([1e-40, 2e-40, 3e-39, 5e-41], np.float32)
    return X, Y


def pairwise_inf_rows(X, Y) -> tuple:
    """Copies of X and Y (numpy, K >= 8, M > 5, N > 9) with an inf at
    coordinate 7 of x row 5 and of y row 9: |inf - inf| is NaN, so the
    plain chebychev is NaN at (5, 9) and inf on the rest of x row 5 and y
    column 9, and the plain jaccard NaN at (5, 9) (inf / inf) and 1 or 0
    on the rest of them (off every fast path)."""
    X, Y = X.copy(), Y.copy()
    X[5, 7] = np.inf
    Y[9, 7] = np.inf
    return X, Y


def pairwise_nan_cases(X, Y) -> dict:
    """{label: (X, Y)} of the rows that hold NaN and inf values, cut from
    X's first 301 rows and Y's first 203 (numpy)."""
    X, Y = X[:301], Y[:203]
    return {"off path": pairwise_off_path_rows(X, Y),
            "inf pair": pairwise_inf_rows(X, Y)}


def ks_end_rows(k: int) -> tuple:
    """Rows at the edges of the KS walk's end at a row's exhaustion (k >=
    8), x row i against y row i and every other pair of the two sets: x's
    largest value tied into a run of y where x is exhausted, with larger
    y values after it; the mirror case; equal rows; equal maxima in runs
    of both rows; x all -0.0 against y's +0.0 and larger values; x
    exhausted before a larger y with no tie."""
    h = k // 2
    tied = np.array([0.1] * (k - 1) + [0.5])
    run = np.array([0.1] * h + [0.5] * 3 + [0.9] * (k - h - 3))
    X = np.stack([tied, run, np.full(k, 0.25),
                  np.array([0.0] * (k - 2) + [0.5] * 2), np.full(k, -0.0),
                  np.full(k, 0.1)])
    Y = np.stack([run, tied, np.full(k, 0.25),
                  np.array([0.0] * (k - 3) + [0.5] * 3),
                  np.array([0.0] * h + [0.3] * (k - h)), np.full(k, 0.2)])
    return X.astype(np.float32), Y.astype(np.float32)


def ks_merge_steps(torch, X, Y, block: int = 1024) -> int:
    """The merge steps of the KS kernel's walks on X and Y, summed over
    the pairs: a step takes the smaller head of the two sorted rows, or
    both heads where they are equal, and a walk ends once a row is
    exhausted. Run for all pairs at once, `block` rows of X at a time."""
    inf = torch.full((1,), float("inf"), device=X.device)

    def rows(A):
        a = torch.sort(A, dim=1).values
        a = torch.where(torch.isnan(a), inf, a)
        return torch.cat([a, inf.expand(a.shape[0], 1)], dim=1)
    xs, ysT = rows(X), rows(Y).T.contiguous()          # [m, k+1], [k+1, n]
    m, k, n = X.shape[0], X.shape[1], Y.shape[0]
    total = 0
    for r0 in range(0, m, block):
        xb = xs[r0:r0 + block]
        i = torch.zeros((xb.shape[0], n), dtype=torch.int64, device=X.device)
        j = torch.zeros_like(i)
        steps = torch.zeros_like(i)
        for _ in range(2 * k):
            live = (i < k) & (j < k)
            if not bool(live.any()):
                break
            xi, yj = xb.gather(1, i), ysT.gather(0, j)
            i += (xi <= yj) & live
            j += (yj <= xi) & live
            steps += live
        total += int(steps.sum())
    return total


def pairwise_call(torch, name, X, Y):
    """The metric as a user calls it on the card (distances.py dispatches
    to the kernels: ks with its rows' sort, uber with its products)."""
    from ldagroupedgibbssampler_tpu_torch.similarity import distances
    return distances.DISTANCES[name](X, Y)


def pairwise_plain(torch, name, X, Y):
    """The metric's plain version on X's device: the tiled blocks."""
    from ldagroupedgibbssampler_tpu_torch.similarity import distances
    return distances.DISTANCES[name].tiled(X, Y)


def pairwise_mismatch(torch, name, got, want):
    """None where a kernel's result agrees with its plain version (the
    same shape, NaN and inf where the plain version has them; chebychev
    and ks bit for bit on the other entries, the rest within
    PAIRWISE_TOL), else what differs."""
    if got.shape != want.shape:
        return f"shape {tuple(got.shape)}, not {tuple(want.shape)}"
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        where = torch.nonzero(torch.isnan(got) != nan)[:4].tolist()
        return (f"NaN at {int((torch.isnan(got) != nan).sum())} other "
                f"entries than the plain version's, e.g. {where}: "
                f"{[float(got[i, j]) for i, j in where]} against "
                f"{[float(want[i, j]) for i, j in where]}")
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return "finite where the plain version is not"
    err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    if name in PAIRWISE_EXACT:
        if not torch.equal(got[~nan], want[~nan]):
            return (f"not bit-equal to the plain version (max |diff| "
                    f"{err:.3g}, {int((got != want)[~nan].sum())} entries)")
    elif not torch.allclose(got, want, rtol=PAIRWISE_TOL,
                            atol=PAIRWISE_TOL, equal_nan=True):
        return f"max |diff| {err:.3g} against the plain version"
    return None


def pairwise_agree(torch, name, got, want, label) -> float:
    """Hold a kernel's result to its plain version (pairwise_mismatch):
    NaN and inf where the plain version has them (uber's cosine of an
    all-zero row, a NaN or |inf - inf| in chebychev and jaccard),
    chebychev and ks bit for bit on the other entries, the rest within
    PAIRWISE_TOL. Returns max |got - want| over the finite entries."""
    wrong = pairwise_mismatch(torch, name, got, want)
    check(wrong is None, f"[3 pairwise] {name} {label}: {wrong}")
    fin = torch.isfinite(want)
    return float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0


PAIRWISE_NAN_METRICS = ("manhattan", "chebychev", "jaccard")


def pairwise_nan_report(torch, dev="cuda") -> dict:
    """manhattan's, chebychev's and jaccard's kernels against their plain
    versions on pairwise_nan_cases of Dirichlet rows at K=100 and K=37:
    {"K=k label name": what differs}, empty where all agree. Raises
    nothing, so that a kernel that drops a NaN (the parent's fmaxf /
    fminf) can be shown."""
    out = {}
    for k in (K, 37):
        X, Y = pairwise_rows(301, k, 1), pairwise_rows(203, k, 2)
        for label, (Xo, Yo) in pairwise_nan_cases(X, Y).items():
            Xo, Yo = (torch.as_tensor(a, device=dev) for a in (Xo, Yo))
            for name in PAIRWISE_NAN_METRICS:
                wrong = pairwise_mismatch(
                    torch, name, pairwise_call(torch, name, Xo, Yo),
                    pairwise_plain(torch, name, Xo, Yo))
                if wrong is not None:
                    out[f"K={k} {label} {name}"] = wrong
    return out


@functools.cache
def sass_listing(tool: str, library: str) -> tuple:
    """The kernels' SASS listings of `library` by cuobjdump (`tool`), one
    a kernel, each starting with its mangled name."""
    return tuple(subprocess.run([tool, "-sass", library],
                                capture_output=True, text=True, timeout=300,
                                check=True).stdout.split("Function : ")[1:])


def sass_hot_loop(_build, entry: str, op: str = "FMNMX"):
    """Opcode counts of the hot loop of the first kernel whose mangled name
    holds `entry`, in the built library's SASS (cuobjdump beside nvcc):
    the span of a backward branch with the largest share of `op` (FMNMX
    for chebychev and jaccard, FADD for manhattan: the innermost loop over
    coordinates, not the loops around it). None where the toolkit has no
    cuobjdump."""
    import collections
    import re
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    for func in sass_listing(tool, str(_build.library_path())):
        if entry not in func.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), o, args) for a, o, args in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
            r"([^;]*);", func)]
        best = None
        for a, opcode, args in ins:
            m = re.match(r"\s*(0x[0-9a-f]+)", args)
            if (opcode.split(".")[0] != "BRA" or not m
                    or int(m.group(1), 16) > a):
                continue
            body = collections.Counter(o.split(".")[0] for b, o, _ in ins
                                       if int(m.group(1), 16) <= b <= a)

            def share(c):
                return c[op] / sum(c.values())
            if body[op] and (best is None or share(body) > share(best)):
                best = body
        return best
    return None


def minmax_floors(_build, m, n, k) -> dict:
    """manhattan's, chebychev's and jaccard's instruction floors (ms) at
    (m, n, k): MINMAX_INSTRUCTIONS instructions a term at
    INSTRUCTIONS_PER_S, and from the SASS of each kernel's hot loop
    (sass_hot_loop; a term is one FMNMX, or two FADDs for manhattan): the
    larger of its instructions at one a clock and its ALU instructions at
    one every two clocks, a warp and scheduler, with the loop's counts by
    pipe; "not measured" without cuobjdump."""
    terms = float(m) * n * k
    out = {"issue_floor_ms":
           terms * MINMAX_INSTRUCTIONS / INSTRUCTIONS_PER_S * 1e3}
    for name, entry, op, per_term in (
            ("chebychev", "minmax_kernelILi1ELb1E", "FMNMX", 1),
            ("jaccard", "minmax_kernelILi3ELb1E", "FMNMX", 1),
            ("manhattan", "minmax_kernelILi0ELb1E", "FADD", 2)):
        body = sass_hot_loop(_build, entry, op)
        if not body or body[op] < per_term:
            out[name] = "not measured"
            continue
        total = sum(body.values())
        alu = sum(body[o] for o in SASS_ALU)
        fma = sum(body[o] for o in SASS_FMA)
        clocks = max(total, 2 * alu)
        loop_terms = body[op] // per_term
        out[name] = {
            "terms": loop_terms, "instructions": total, "alu": alu,
            "fma": fma, "lds": body["LDS"],
            "floor_ms": terms / 32 / loop_terms * clocks
            / (132 * 4 * 1.98e9) * 1e3}
    return out


def manhattan_emulation(torch, X, Y, splits=((0, None),)):
    """The manhattan kernel's sum in float32 on X's device, operation by
    operation: |x - y| summed in order into a fresh partial a chunk of
    MINMAX_CHUNK coordinates (the last to K), each partial added to its
    split's total, the splits' totals (chunks [c0, c1) each) added in rank
    order. Without a split, the parent kernel's padded sum bit for bit
    (its padding added +0 to partials >= 0)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_pairwise as cp
    k, chunk = X.shape[1], cp.MINMAX_CHUNK
    out = None
    for c0, c1 in splits:
        total = torch.zeros((X.shape[0], Y.shape[0]), device=X.device)
        end = k if c1 is None else min(c1 * chunk, k)
        for c in range(c0 * chunk, end, chunk):
            part = torch.zeros_like(total)
            for kk in range(c, min(c + chunk, k)):
                part += (X[:, kk, None] - Y[None, :, kk]).abs()
            total += part
        out = total if out is None else out + total
    return out


def pairwise_bound(name, m, n, k, ks_steps=None, sfu=None, ops=None):
    """(bound ms, bound_by) of the kernel alone at (m, n, k): the rows read
    once and the output written once (uber also reads its three product
    matrices), against its operations: for ks KS_STEP_OPS a merge step,
    `ks_steps` steps in all (default 2K a pair); for the others
    PAIRWISE_OPS, or `ops` (operations, special-function calls) a term
    (`sfu` overrides the calls); js's closed form also takes the log of
    each value of its rows once."""
    nbytes = 4 * (m + n) * k + 4 * m * n * (4 if name == "uber" else 1)
    if name == "ks":
        steps = 2.0 * k * m * n if ks_steps is None else float(ks_steps)
        return bound(nbytes, KS_STEP_OPS * steps)
    per_term, calls = ops or PAIRWISE_OPS[name]
    calls = calls if sfu is None else sfu
    row_logs = float(m + n) * k if name == "js" and ops is None else 0.0
    return bound(nbytes, per_term * float(m) * n * k,
                 sfu_ops=calls * float(m) * n * k + row_logs)


def pairwise_kernel_fns(torch, name, X, Y):
    """(the kernel's wrapper, the whole call) as callables: uber's wrapper
    on its products computed beforehand; the others' wrapper is the call
    (ks's with its rows' sort, ~0.1 ms of it at the 20NG shape)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_pairwise as cp
    from ldagroupedgibbssampler_tpu_torch.similarity import distances
    whole = (lambda: pairwise_call(torch, name, X, Y))
    if name == "uber":
        parts = tuple(distances.DISTANCES[p](X, Y)
                      for p in cp.UBER_PRODUCTS)
        return (lambda: cp.pairwise_elementwise("uber", X, Y, parts=parts)
                ), whole
    return whole, whole


def pairwise_timing(torch, name, X, Y):
    """Times at one shape: the kernel's wrapper and the whole call (CUDA
    events), the plain version (one call), the library call where one
    computes the same function, the bound, the peak memory the whole call
    adds."""
    kernel, whole = pairwise_kernel_fns(torch, name, X, Y)
    m, n, k = X.shape[0], Y.shape[0], X.shape[1]
    out = dict(ms=time_ms(torch, kernel, reps=5, calls=5))
    out["call_ms"] = (out["ms"] if whole is kernel
                      else time_ms(torch, whole, reps=5, calls=5))
    out["plain_ms"] = once_ms(torch, lambda: pairwise_plain(
        torch, name, X, Y))
    p = PAIRWISE_LIBRARY.get(name)
    out["library_ms"] = (time_ms(torch, lambda: torch.cdist(X, Y, p=p),
                                 reps=5, calls=5) if p else None)
    if name == "ks":
        out["merge_steps"] = ks_merge_steps(torch, X, Y)
        out["bound_ms"], out["bound_by"] = pairwise_bound(
            name, m, n, k, ks_steps=out["merge_steps"])
        out["bound_2k_ms"] = pairwise_bound(name, m, n, k)[0]
    else:
        out["bound_ms"], out["bound_by"] = pairwise_bound(name, m, n, k)
        if name in ("canberra", "uber"):
            out["bound_no_rcp_ms"] = pairwise_bound(name, m, n, k, sfu=0)[0]
        if name == "js":
            out["bound_logf_ms"] = pairwise_bound(name, m, n, k,
                                                  ops=JS_OPS_LOGF)[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = whole()
    torch.cuda.synchronize()
    out["peak_added_bytes"] = torch.cuda.max_memory_allocated() - held
    out["output_bytes"] = res.numel() * 4
    del res
    return out


def pairwise_division_check(torch, cp, X, Y, label) -> int:
    """The division of uber's and canberra's scaled blocks (csrc/
    pairwise.cu div_rn_scaled of the values times 2^64) bit-equal to
    __fdiv_rn on every (pair, coordinate) term of X and Y whose two values
    are within TAME_MAX (every term where all are); returns the terms
    checked."""
    checked, differ = (int(v) for v in cp.division_check(X, Y).cpu())
    tame_x = (X.abs() <= cp.TAME_MAX).sum(0, dtype=torch.float64)
    tame_y = (Y.abs() <= cp.TAME_MAX).sum(0, dtype=torch.float64)
    want = int((tame_x * tame_y).sum())
    check(checked == want and differ == 0,
          f"[3 pairwise] the scaled division {label}: {differ} of "
          f"{checked} terms ({want} tame) differ from __fdiv_rn")
    return checked


def parent_times(kernel: str, parent: str, cases=None) -> dict:
    """The times of `kernel`'s cases (tools/time_kernel_builds.py's, all
    or those named) of the checkout `parent` (a git archive of the parent
    commit, say) and of this one, in turns, by that tool in a process of
    its own: {case: {name: median ms}}."""
    out = os.path.join(ROOT, "build", f"{kernel}_parent_times.json")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "time_kernel_builds.py"),
         "--kernel", kernel, f"parent={parent}", f"new={ROOT}",
         *(["--cases", ",".join(cases)] if cases else []), "--json", out],
        check=True, timeout=900, stdout=subprocess.DEVNULL)
    with open(out) as f:
        return {r["case"]: r["median_ms"] for r in json.load(f)["results"]}


def pairwise_phase(torch, _build, smi, dev="cuda", parent=None):
    """[3 pairwise]: the kernels of csrc/pairwise.cu (the elementwise
    metrics; the KS merge) against their plain versions (the tiled blocks
    of similarity/distances.py) on the card, chebychev and ks bit-equal,
    the other five within PAIRWISE_TOL, on Dirichlet(0.1) rows with ~30%
    exact zeros at (a) the 20NG test x train shape, (b) 512 x 512 x 4096,
    (c) 301 x 203 x 37 (ragged tiles), and (d) edge rows with a 1 x 1
    Distance.calculate; ks also equal to ks_merge_reference at (c), (d)
    and on ks_end_rows at K and at 4096 (the global-memory walk); uber
    also at (c) with a value of 2^40 (the unscaled path in the blocks that
    hold it); canberra, js, chebychev and jaccard also on the first 301 x
    203 rows of (a) and on (c) with pairwise_off_path_rows (blocks off
    their fast paths beside blocks on them with subnormal values),
    manhattan, chebychev and jaccard also with pairwise_inf_rows (an inf
    at one coordinate of both rows), NaN where the plain version has it;
    manhattan bit-equal to manhattan_emulation at (a), unsplit (the
    parent kernel's sum), and at (c), split; the
    scaled division bit-equal to __fdiv_rn on every tame term of (a)-(d)
    and of the off-path rows. At (a)
    and on its first 256 rows: each kernel's time alone and with its call
    (ks's sort, uber's products), the plain version, the library call,
    the bound (ks's from the merge steps these rows need, beside the 2K
    steps a pair; canberra's and uber's with and without the division's
    reciprocal; js's closed form beside its logf a term), the peak memory
    a call adds (at most twice its output at (a); ks also its rows' sort;
    uber its three product matrices and their temporaries); the kernels
    of PAIRWISE_REDESIGNED timed at (b) too; ptxas's registers and
    spills; the blocks an SM of uber's kernel, of the shared KS kernel
    and of manhattan's, chebychev's and jaccard's; their instruction
    floors at (a) and (b) (minmax_floors). With `parent` (a checkout), also those kernels'
    times of that checkout and of this one at (a) and (b), in turns
    (parent_times). Returns the two kernels-JSON entries
    (manhattan's numbers at (a) for the elementwise kernel, every metric
    under `metrics`)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_pairwise as cp
    from ldagroupedgibbssampler_tpu_torch.similarity import Distance
    t0 = time.perf_counter()
    errs = {name: {} for name in PAIRWISE_METRICS}
    timing = {name: {} for name in PAIRWISE_METRICS}
    division = {}
    manhattan_exact = {}
    for label, m, n, k in PAIRWISE_SHAPES:
        X = torch.as_tensor(pairwise_rows(m, k, 1), device=dev)
        Y = torch.as_tensor(pairwise_rows(n, k, 2), device=dev)
        division[label] = pairwise_division_check(torch, cp, X, Y,
                                                  f"({label})")
        for name in PAIRWISE_METRICS:
            got = pairwise_call(torch, name, X, Y)
            want = pairwise_plain(torch, name, X, Y)
            errs[name][label] = pairwise_agree(torch, name, got, want,
                                               f"({label}) {m}x{n}x{k}")
            if name == "manhattan" and label in ("a", "c"):
                # bit-equal to its sum's emulation: unsplit at (a), the
                # parent kernel's sum; split at (c)
                splits = cp.minmax_launch_shape(m, n, k)["split_chunks"]
                emu = manhattan_emulation(torch, X, Y, splits)
                check(torch.equal(got, emu), f"[3 pairwise] manhattan "
                      f"({label}): not bit-equal to its two-level sum in "
                      f"{len(splits)} split(s) on "
                      f"{int((got != emu).sum())} entries")
                manhattan_exact[label] = len(splits)
                del emu
            if name == "ks" and label == "c":
                check(torch.equal(got, cp.ks_merge_reference(X, Y)),
                      "[3 pairwise] ks (c): not ks_merge_reference's")
            if name == "uber" and label == "c":
                # a value beyond 2^32 sends the blocks of X's first rows
                # down uber's unscaled path with __fdiv_rn
                Xw = X.clone()
                Xw[0, 0] = 2.0 ** 40
                errs[name]["c unscaled blocks"] = pairwise_agree(
                    torch, name, pairwise_call(torch, name, Xw, Y),
                    pairwise_plain(torch, name, Xw, Y),
                    f"(c) {m}x{n}x{k} with a value of 2^40")
            del got, want
        if label in ("a", "c"):
            # blocks off canberra's, js's and jaccard's fast paths (a
            # negative value, NaN, inf, 2^40) beside blocks on them with
            # subnormal values; chebychev and jaccard also with an inf at
            # one coordinate of both rows; at K=100 (16-byte loads) and
            # K=37: NaN where the plain version has it
            for case, rows in pairwise_nan_cases(
                    X.cpu().numpy(), Y.cpu().numpy()).items():
                Xo, Yo = (torch.as_tensor(v, device=dev) for v in rows)
                for name in (("canberra", "js") if case == "off path"
                             else ()) + PAIRWISE_NAN_METRICS:
                    errs[name][f"{label} {case}"] = pairwise_agree(
                        torch, name, pairwise_call(torch, name, Xo, Yo),
                        pairwise_plain(torch, name, Xo, Yo),
                        f"({label}) 301x203x{k} {case}")
                if case == "off path":
                    division[f"{label} off path"] = pairwise_division_check(
                        torch, cp, Xo, Yo, f"({label}) off the fast paths")
                del Xo, Yo
        if label == "a":
            for name in PAIRWISE_METRICS:
                timing[name]["a"] = pairwise_timing(torch, name, X, Y)
                timing[name]["block"] = pairwise_timing(
                    torch, name, X[:APPS_BLOCK], Y)
        if label == "b":
            for name in PAIRWISE_REDESIGNED:
                timing[name]["b"] = pairwise_timing(torch, name, X, Y)
        del X, Y
        torch.cuda.empty_cache()
    ex, ey = (torch.as_tensor(a, device=dev) for a in pairwise_edge_rows(K))
    for name in PAIRWISE_METRICS:
        got = pairwise_call(torch, name, ex, ey)
        errs[name]["d"] = pairwise_agree(torch, name, got,
                                         pairwise_plain(torch, name, ex, ey),
                                         "(d) edge rows")
        one = Distance(name, device=dev).calculate(ex[3].cpu().numpy(),
                                                   ey[3].cpu().numpy())
        errs[name]["d 1x1"] = pairwise_agree(
            torch, name, torch.tensor([[one]], device=dev),
            pairwise_plain(torch, name, ex[3:4], ey[3:4]), "(d) 1 x 1")
    diag = cp.pairwise_ks(ex, ey).diagonal()
    check(torch.equal(cp.pairwise_ks(ex, ey), cp.ks_merge_reference(ex, ey))
          and diag[0] == 0 and diag[2] == 0,
          f"[3 pairwise] ks (d): identical and all-zero pairs {diag}")
    division["d"] = pairwise_division_check(torch, cp, ex, ey, "(d)")
    # the early end's edges, on both instances of the walk
    for k in (K, 4096):
        ex, ey = (torch.as_tensor(a, device=dev) for a in ks_end_rows(k))
        got = cp.pairwise_ks(ex, ey)
        check(torch.equal(got, cp.ks_merge_reference(ex, ey))
              and torch.equal(got, pairwise_plain(torch, "ks", ex, ey)),
              f"[3 pairwise] ks on ks_end_rows({k}): {got.tolist()} is not "
              f"ks_merge_reference's "
              f"{cp.ks_merge_reference(ex, ey).tolist()}")
        errs["ks"][f"end rows K={k}"] = 0.0
    # at (a) a call adds at most twice its output; ks also its rows'
    # sort (values, int64 indices and the sort's scratch, 16 B a value);
    # uber also its three product matrices and their temporaries
    for name in PAIRWISE_METRICS:
        a = timing[name]["a"]
        limit = 2 * a["output_bytes"] + (
            16 * (PAIRWISE_TEST + PAIRWISE_TRAIN) * K if name == "ks"
            else 8 * a["output_bytes"] if name == "uber" else 0)
        check(a["peak_added_bytes"] <= limit,
              f"[3 pairwise] {name} (a): a call adds "
              f"{a['peak_added_bytes']} B, above {limit}")
    elementwise_regs = ptxas_registers(_build, "pairwise_kernel")
    minmax_regs = ptxas_registers(_build, "minmax_kernel")
    for name, found in (("canberra", elementwise_regs),
                        ("js", elementwise_regs),
                        ("chebychev", minmax_regs), ("jaccard", minmax_regs),
                        ("manhattan", minmax_regs)):
        for vec, kind in (("1", "16-byte loads"), ("0", "4-byte loads")):
            key = f"{cp.METRICS[name]},{vec}"
            check(key in found, f"[3 pairwise] no ptxas line of "
                  f"the {name} kernel with {kind}")
    regs = {**{f"metric,vec {key}": v for key, v in
               elementwise_regs.items()},
            **{f"minmax metric,vec {key}": v for key, v in
               minmax_regs.items()},
            **{f"uber vec {key}": v for key, v in
               ptxas_registers(_build, "uber_kernel").items()},
            **{f"ks shared {key}": v for key, v in
               ptxas_registers(_build, "ks_kernel").items()}}
    uber_blocks, ks_blocks, cheb_blocks, jac_blocks, man_blocks = \
        cp.blocks_per_sm(K, dev)
    check(uber_blocks >= 2, f"[3 pairwise] uber's kernel: {uber_blocks} "
          "block(s) an SM, fewer than 2")
    check(min(cheb_blocks, jac_blocks, man_blocks) >= 1, "[3 pairwise] the "
          f"chebychev, jaccard and manhattan kernels: {cheb_blocks}, "
          f"{jac_blocks} and {man_blocks} blocks an SM")
    occupancy = {"uber blocks an SM": uber_blocks,
                 f"ks shared blocks an SM at K={K}": ks_blocks,
                 "chebychev blocks an SM": cheb_blocks,
                 "jaccard blocks an SM": jac_blocks,
                 "manhattan blocks an SM": man_blocks}
    floors = {"a": minmax_floors(_build, PAIRWISE_TEST, PAIRWISE_TRAIN, K),
              "b": minmax_floors(_build, 512, 512, 4096)}
    parents = parent_times("pairwise", parent, [
        f"{name} {case}" for name in PAIRWISE_REDESIGNED
        for case in ("a", "K=4096")]) if parent else None
    seconds = time.perf_counter() - t0

    def short(r):
        return {key: (round(v, 4) if isinstance(v, float) else v)
                for key, v in r.items()}
    at_b = {n: short(timing[n]["b"]) for n in PAIRWISE_REDESIGNED}
    shapes = ", ".join(f"({label}) {m}x{n}x{k}"
                       for label, m, n, k in PAIRWISE_SHAPES)
    print(f"[3 pairwise] csrc/pairwise.cu on {torch.cuda.get_device_name(0)}"
          f" ({smi}): every metric against its plain version (tiled "
          f"blocks), chebychev and ks bit-equal, the rest within "
          f"{PAIRWISE_TOL}, at {shapes}, (d) edge rows and 1 x 1: max "
          f"|diff| {json.dumps(errs)}; ms (the wrapper; call_ms with uber's "
          f"products; plain one call; library torch.cdist; "
          f"peak bytes a call adds) at (a) "
          f"{json.dumps({n: short(t['a']) for n, t in timing.items()})}; on "
          f"its first {APPS_BLOCK} rows "
          f"{json.dumps({n: short(t['block']) for n, t in timing.items()})}"
          f"; at (b) {json.dumps(at_b)}"
          f"; the scaled division (uber's and canberra's tame blocks) "
          f"bit-equal to __fdiv_rn on {json.dumps(division)} terms; "
          f"manhattan bit-equal to its two-level sum (splits "
          f"{json.dumps(manhattan_exact)}; unsplit, the parent kernel's "
          f"sum); ptxas (canberra {cp.METRICS['canberra']}, js "
          f"{cp.METRICS['js']}; minmax: manhattan "
          f"{cp.METRICS['manhattan']}, chebychev "
          f"{cp.METRICS['chebychev']}, jaccard {cp.METRICS['jaccard']}) "
          f"{json.dumps(regs)}; "
          f"{json.dumps(occupancy)}; manhattan's, chebychev's and "
          f"jaccard's instruction floors (2 issued a term; from the SASS "
          f"of the hot loop by pipe) {json.dumps(floors)}; parent and "
          f"this checkout "
          f"in turns "
          f"(ms, medians) {json.dumps(parents)}; {seconds:.1f} s",
          flush=True)

    def entry(name, kernel, main):
        a = timing[main]["a"]
        return {"name": name, "route": "cuda",
                "source": "ldagroupedgibbssampler_tpu_torch/csrc/pairwise.cu",
                "replaces": "ldagroupedgibbssampler_tpu/similarity/"
                            f"distances.py:{PAIRWISE_JAX_LINE[main]}",
                "max_abs_err": max(max(errs[m].values()) for m in kernel),
                "ms": a["ms"], "plain_ms": a["plain_ms"],
                "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
                "library_ms": a["library_ms"], "shape": [
                    PAIRWISE_TEST, PAIRWISE_TRAIN, K],
                "metrics": {m: {"replaces": "ldagroupedgibbssampler_tpu/"
                                f"similarity/distances.py:"
                                f"{PAIRWISE_JAX_LINE[m]}",
                                "max_abs_err": errs[m], **timing[m]}
                            for m in kernel},
                "ptxas": regs, "occupancy": occupancy,
                "minmax_floors": floors,
                "division_terms_checked": division,
                "parent_times": parents}
    elementwise = [m for m in PAIRWISE_METRICS if m != "ks"]
    return (entry("pairwise_elementwise", elementwise, "manhattan"),
            entry("pairwise_ks", ["ks"], "ks"))


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
    chains' LLs at iteration ITERS. Returns the relative gap and the
    one-warp chain's LL series (init and every 10)."""
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
    return gap, ser


def collapsed_phase(torch, corpus, Corpus, LDAConfig, create_model,
                    counters, num_docs=100):
    """[4 collapsed]: scheme `collapsed` (the serial oracle, a per-token
    host loop) on the first 100 documents for 2 iterations on the card;
    no sweep or count kernel's launch counter may move (its diagnostic
    theta and phi draws launch the Dirichlet kernels)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_gamma
    draws = cuda_gamma.dirichlet
    sub = first_docs(Corpus, corpus, num_docs)
    counters = [(fn, attr) for fn, attr in counters
                if fn not in (cuda_gamma.gamma, draws)]
    draws0 = draws.launches
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
    check(draws.launches > draws0, "collapsed: no Dirichlet kernel launch")
    ll = model.model_log_likelihood()
    print(f"[4 collapsed] first {num_docs} documents ({sub.num_tokens} "
          f"tokens), "
          f"K=100 on {model.device}: {secs:.2f} s/iteration (a per-token "
          f"host loop); LL init {ll0:.1f} -> it2 {ll:.1f}; counts exact; "
          f"no sweep or count kernel launched, the Dirichlet kernels "
          f"{draws.launches - draws0} times", flush=True)
    del model


GAMMA_GRID = (0.0, 1e-3, 0.01, 0.1, 0.5, 1.0, 2.5, 100.0, 1e4)
GAMMA_CHECK = 100_000       # elements of each grid shape held to the plain
GAMMA_KS = 200_000          # kernel draws of each grid shape for the KS
GAMMA_RTOL = 1e-5


def gamma_tie_proof(torch, a, seed, i, r):
    """Whether round r of element i's accept test is a tie: both sides of
    log u < x^2/2 + d - d v + d log v recomputed in float64 from the
    element's Philox words differ by at most GAMMA_RTOL of the terms'
    magnitude, or 1 + c x is that close to 0 (the sign of v)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_gamma
    ctr = torch.tensor([i * cuda_gamma.BLOCKS_PER_ELEMENT + r],
                       dtype=torch.int64, device=seed.device)
    w = [float(v) for v in (cuda_gamma._unit23(x).double()
                            for x in cuda_gamma._words(seed, ctr)[:3])]
    a = float(a)
    d = (a + 1.0 if a < 1.0 else a) - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)
    x = np.sqrt(-2.0 * np.log(w[0])) * np.cos(2.0 * np.pi * w[1])
    v1 = 1.0 + c * x
    if abs(v1) <= GAMMA_RTOL * (1.0 + abs(c * x)):
        return True
    if v1 <= 0:
        return False
    v = v1 ** 3
    terms = (np.log(w[2]), 0.5 * x * x, d, -d * v, d * np.log(v))
    margin = terms[0] - sum(terms[1:])
    return abs(margin) <= GAMMA_RTOL * sum(abs(t) for t in terms)


def gamma_agreement(torch, cuda_gamma, a, seed, label):
    """The Gamma kernel against gamma_reference on float32 `a` (flat),
    both on the card: (share of elements within GAMMA_RTOL, [proven
    accept/reject ties, boost-amplified last bits], mean rounds a draw,
    gamma_warp_rounds of the kernel's rounds).
    An element outside the tolerance must either have another accepted
    round than the plain version, the earlier of the two a proven tie, or
    the same round with a < 1, where the boost exp(log(ub) / a) multiplies
    a last-bit difference of log(ub) by |log(ub) / a|: its relative error
    within 2.4e-7 (2 ulp) times 2 + |log(ub) / a|. The relative error's
    denominator is at least FLT_MIN: a denormal draw counts at the scale of
    the smallest normal."""
    a = a.reshape(-1).to(torch.float32).contiguous()
    rk = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    gk = cuda_gamma.gamma(a, seed, rk)
    gr, rr = cuda_gamma.gamma_reference(a, seed, return_rounds=True)
    tiny = torch.finfo(torch.float32).tiny
    rel = (gk - gr).abs() / gr.abs().clamp_min(tiny)
    bad = (rel > GAMMA_RTOL).nonzero()[:, 0]
    share = 1.0 - bad.numel() / max(a.numel(), 1)
    check(share >= 0.999, f"{label}: only {share:.6f} of the draws within "
          f"{GAMMA_RTOL} of the plain version")
    ties = boosted = 0
    for i in bad[:2000].tolist():
        if int(rk[i]) != int(rr[i]):
            m = min(int(rk[i]), int(rr[i]))
            check(m < cuda_gamma.ROUNDS and gamma_tie_proof(
                torch, a[i], seed, i, m), f"{label}: element {i} (a="
                f"{float(a[i])}) accepted round {int(rk[i])} against "
                f"{int(rr[i])}, not a tie")
            ties += 1
            continue
        ctr = torch.tensor([i * cuda_gamma.BLOCKS_PER_ELEMENT
                            + cuda_gamma.ROUNDS], dtype=torch.int64,
                           device=seed.device)
        ub = float(cuda_gamma._unit23(cuda_gamma._words(seed, ctr)[0]))
        amp = abs(np.log(ub) / max(float(a[i]), tiny))
        check(float(a[i]) < 1.0 and float(rel[i]) <= 2.4e-7 * (2 + amp),
              f"{label}: element {i} (a={float(a[i])}) off by "
              f"{float(rel[i]):.3g} in the same round")
        boosted += 1
    check(bad.numel() <= 2000, f"{label}: {bad.numel()} elements to prove")
    rounds = (rk.clamp(max=cuda_gamma.ROUNDS - 1) + 1).double().mean()
    return (share, [ties, boosted], float(rounds),
            gamma_warp_rounds(torch, rk, cuda_gamma.TILE))


def gamma_warp_rounds(torch, rounds, tile):
    """Rounds a draw of the elementwise Gamma kernel costs, in lane-rounds
    an element: (what the elements need, what warps of 32 consecutive
    elements run when each leaves the round loop at its last lane's
    accept, without a queue, what the compacted kernel runs:
    round 0 on every element of a tile, then over the tile's queue of
    rejects in warps of 32, each running its neediest element's later
    rounds). `rounds`: each element's accepted round (ROUNDS: none, all
    run). The queue is taken in index order; the kernel appends a warp's
    rejects together in the order the warps get there."""
    need = rounds.reshape(-1).to(torch.int64).clamp(max=5) + 1
    n = need.numel()
    pad = (-n) % 32
    groups = torch.cat([need, need.new_zeros(pad)]).reshape(-1, 32)
    before = 32 * float(groups.amax(dim=1).sum()) / n
    after = 0.0
    for t0 in range(0, n, tile):
        part = need[t0:t0 + tile]
        after += 32 * -(-part.numel() // 32)
        queue = part[part > 1] - 1
        qpad = (-queue.numel()) % 32
        if queue.numel():
            after += 32 * float(torch.cat([queue, queue.new_zeros(qpad)])
                                .reshape(-1, 32).amax(dim=1).sum())
    return [float(need.double().mean()), before, after / n]


def gamma_ops(a, mean_rounds: float) -> float:
    """f32 operations of the Gamma draws of `a` as the kernel does them:
    4 to set up, 26 a round over the rounds this run's draws took, 7 for
    the boost where a < 1."""
    return a.numel() * (4 + 26 * mean_rounds) + 7 * float((a < 1).sum())


def gamma_int_sfu(a, mean_rounds: float) -> tuple:
    """(32-bit integer multiplies, special-function calls) of the Gamma
    draws of `a` at the rounds this run's draws took: a Philox block a
    round and one for the boost where a < 1, each 10 rounds of two
    32 x 32 -> 64-bit multiplies (a low and a high 32-bit multiply each);
    rsqrt to set up, log, sqrt, cos, log v and log u a round, log and exp
    for the boost."""
    n, small = a.numel(), float((a < 1).sum())
    blocks = n * mean_rounds + small
    return 40 * blocks, n * (1 + 5 * mean_rounds) + 2 * small


def eager_dirichlet(torch, rnd, x, generator, dim=-1, prior=None):
    """The draw the port ran on the card before the kernel: the generator
    path of ops/random.py, ~25 eager launches a round."""
    conc = x.to(torch.float32) + (0.0 if prior is None else prior)
    g = rnd._gamma_eager(conc, generator)
    g = g.clamp_min(rnd.DIRICHLET_FLOOR)
    return g / g.sum(dim=dim, keepdim=True)


class eager_draws:
    """Within the block, ops/random.py draws on the card as it did before
    the kernel (the generator path): the "before" of [4 profile]."""

    def __init__(self, torch, rnd):
        self.torch, self.rnd = torch, rnd

    def __enter__(self):
        torch, rnd = self.torch, self.rnd
        self.saved = rnd._gamma_marsaglia, rnd.dirichlet
        rnd._gamma_marsaglia = lambda a, gen: rnd._gamma_eager(
            a.to(torch.float32), gen)
        rnd.dirichlet = lambda x, gen, dim=-1, prior=None: eager_dirichlet(
            torch, rnd, torch.as_tensor(x), gen, dim, prior)

    def __exit__(self, *exc):
        self.rnd._gamma_marsaglia, self.rnd.dirichlet = self.saved


def gamma_phase(torch, corpus, cuda_gamma, rnd, smi):
    """[3 gamma]: the Gamma and Dirichlet kernels (csrc/gamma.cu) at the
    ggs K=100 main path's shapes: theta [D, K] from counts + 0.5 (one
    launch a draw, rows) and phi [V, K] from counts + 0.01 normalised over
    V (two launches, axis 0), with n_dk and N_kw a recount of a random z,
    and the PCGS family's phi [K, V] from N_kw + 0.01 over V (two
    launches, rows split across blocks: gamma_long_rows), and theta and phi
    at K=4096 (gamma_large_k). The Gamma kernel against gamma_reference on
    every element of both
    (gamma_agreement: within 1e-5 but proven ties); the Dirichlet kernels
    against the kernel's own Gamma draws floored and normalised by torch
    (the same draws: 1e-5, the sums' order), rows and columns summing to 1
    within 1e-5, every coordinate above 0 (the floor); on the grid of
    shapes GAMMA_GRID the kernel against gamma_reference on GAMMA_CHECK
    elements, a KS test of GAMMA_KS draws against scipy.stats.gamma
    (conditioned on draws above 1e-30 below shape 0.1, as the CPU tests
    do), the exact 0 at shape 0, and a row with zero shapes floored. Timed
    by CUDA events: each Dirichlet draw and the elementwise Gamma, beside
    the plain versions (dirichlet_reference), the eager generator path the
    port ran before, torch._standard_gamma and torch._sample_dirichlet on
    the same concentrations (the yardstick), and the bound. Returns the
    kernels-JSON entry."""
    from scipy import stats as sps
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    z = rng.integers(0, K, corpus.num_tokens)
    nkw_ref, ndk_ref = recount(corpus, z, K)
    ndk = torch.as_tensor(ndk_ref.astype(np.int32), device=dev)
    nkw = torch.as_tensor(nkw_ref.astype(np.int32), device=dev)
    alpha = torch.full((K,), 0.5, device=dev)
    beta = 0.01
    theta_conc = ndk.to(torch.float32) + alpha
    phi_conc = nkw.to(torch.float32) + beta
    seed = torch.tensor([0x5EED_1234_ABCD], dtype=torch.int64, device=dev)
    out = {}
    for name, conc in (("theta", theta_conc), ("phi", phi_conc)):
        out[name] = gamma_agreement(torch, cuda_gamma, conc, seed,
                                    f"[3 gamma] {name}")
    # the Dirichlet kernels on the main path's counts-plus-prior operands
    theta = cuda_gamma.dirichlet(ndk, seed, -1, alpha)
    phi = cuda_gamma.dirichlet(nkw, seed, 0, beta)
    max_err = 0.0
    for name, got, conc, dim in (("theta", theta, theta_conc, -1),
                                 ("phi", phi, phi_conc, 0)):
        g = cuda_gamma.gamma(conc, seed).clamp_min(rnd.DIRICHLET_FLOOR)
        want = g / g.sum(dim=dim, keepdim=True)
        rel = float(((got - want).abs() / want).max())
        check(rel <= GAMMA_RTOL, f"[3 gamma] {name}: the Dirichlet kernel "
              f"off the kernel's own Gamma draws by {rel:.3g}")
        sums = got.sum(dim=dim)
        check(bool(((sums - 1).abs() <= 1e-5).all()) and bool((got > 0)
              .all()), f"[3 gamma] {name}: sums or floor")
        plain = cuda_gamma.dirichlet_reference(
            ndk if name == "theta" else nkw, seed, dim,
            alpha if name == "theta" else beta)
        max_err = max(max_err, float((got - plain).abs().max()))
    grid = {}
    for a in GAMMA_GRID:
        conc = torch.full((GAMMA_KS,), a, device=dev)
        share, ties, mean_rounds, _warps = gamma_agreement(
            torch, cuda_gamma, conc[:GAMMA_CHECK], seed, f"[3 gamma] a={a}")
        draws = cuda_gamma.gamma(conc, seed).double().cpu().numpy()
        if a == 0.0:
            check(bool((draws == 0).all()), "[3 gamma] a=0: not exactly 0")
            grid[str(a)] = {"agree": share, "ties": ties, "exact_zero": True}
            continue
        eps = 1e-30 if a < 0.1 else 0.0
        kept = draws[draws > eps]
        f_eps = sps.gamma.cdf(eps, a)
        ks = sps.kstest(kept, lambda x: (sps.gamma.cdf(x, a) - f_eps)
                        / (1.0 - f_eps))
        check(ks.pvalue > 1e-4, f"[3 gamma] a={a}: KS p={ks.pvalue:.3g}")
        grid[str(a)] = {"agree": share, "ties": ties, "ks_p": ks.pvalue,
                        "kept": int(kept.size), "mean": float(draws.mean()),
                        "rounds": mean_rounds}
    long_rows = gamma_long_rows(torch, nkw.T.contiguous(), beta, seed,
                                cuda_gamma, rnd)
    max_err = max(max_err, long_rows["max_abs_err"])
    large = gamma_large_k(torch, corpus, cuda_gamma, rnd, seed)
    max_err = max(max_err, *(v["max_abs_err"] for v in large.values()))
    zero_row = cuda_gamma.dirichlet(
        torch.tensor([[0.0, 0.0, 5.0]], device=dev), seed)
    check(bool((zero_row[0, :2] > 0).all()) and float(zero_row[0, 2]) > 0.99,
          f"[3 gamma] zero shapes not floored: {zero_row.tolist()}")
    # times
    gen = torch.Generator(device=dev).manual_seed(7)
    theta_ms = time_ms(torch, lambda: cuda_gamma.dirichlet(ndk, seed, -1,
                                                           alpha))
    phi_ms = time_ms(torch, lambda: cuda_gamma.dirichlet(nkw, seed, 0, beta))
    gamma_ms = (time_ms(torch, lambda: cuda_gamma.gamma(theta_conc, seed))
                + time_ms(torch, lambda: cuda_gamma.gamma(phi_conc, seed)))
    plain_ms = time_ms(torch, lambda: (
        cuda_gamma.dirichlet_reference(ndk, seed, -1, alpha),
        cuda_gamma.dirichlet_reference(nkw, seed, 0, beta)), reps=3, calls=2)
    eager_ms = time_ms(torch, lambda: (
        eager_dirichlet(torch, rnd, ndk, gen, -1, alpha),
        eager_dirichlet(torch, rnd, nkw, gen, 0, beta)), reps=3, calls=3)
    lib_dir_ms = time_ms(torch, lambda: (
        torch._sample_dirichlet(theta_conc),
        torch._sample_dirichlet(phi_conc.T.contiguous())))
    lib_gamma_ms = time_ms(torch, lambda: (
        torch._standard_gamma(theta_conc), torch._standard_gamma(phi_conc)))
    n = theta_conc.numel() + phi_conc.numel()
    nbytes = 8 * n + 4 * K
    nops = (gamma_ops(theta_conc, out["theta"][2])
            + gamma_ops(phi_conc, out["phi"][2]) + 4 * n)
    int_sfu = [gamma_int_sfu(conc, out[name][2]) for name, conc in
               (("theta", theta_conc), ("phi", phi_conc))]
    int_ops = sum(x[0] for x in int_sfu)
    sfu_ops = sum(x[1] for x in int_sfu)
    bound_ms, by = bound(nbytes, nops, int_ops, sfu_ops)
    print(f"[3 gamma] rounds a draw of the elementwise Gamma kernel, in "
          f"lane-rounds an element (needed, warps of 32 consecutive elements "
          f"without compaction, with the compacted queue of rejects): "
          f"theta {json.dumps([round(v, 4) for v in out['theta'][3]])}, phi "
          f"{json.dumps([round(v, 4) for v in out['phi'][3]])}",
          flush=True)
    print(f"[3 gamma] {smi}: Gamma kernel against gamma_reference on every "
          f"element (share within {GAMMA_RTOL}, [ties, boost last bits], "
          f"mean rounds): theta [{D}, {K}] {json.dumps(out['theta'][:3])}, "
          f"phi [{V}, {K}] {json.dumps(out['phi'][:3])}; Dirichlet kernels "
          f"equal "
          f"the kernel's own Gamma draws normalised, rows and columns sum to "
          f"1, floor held, max |Dirichlet - dirichlet_reference| "
          f"{max_err:.3g}; grid {json.dumps(grid)}; theta Dirichlet "
          f"{theta_ms:.4f} ms (1 launch), phi Dirichlet {phi_ms:.4f} ms (2 "
          f"launches), elementwise Gamma of both {gamma_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms, eager generator path {eager_ms:.4f} ms, "
          f"torch._sample_dirichlet {lib_dir_ms:.4f} ms, "
          f"torch._standard_gamma {lib_gamma_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
          f"{nops / 1e6:.1f} M f32 operations, {int_ops / 1e6:.1f} M "
          f"integer multiplies, {sfu_ops / 1e6:.1f} M special-function "
          f"calls); long rows (the PCGS "
          f"family's phi [{K}, {V}] from N_kw + {beta} over V, rows split "
          f"across blocks, 2 launches): equal the kernel's own Gamma draws "
          f"normalised within {long_rows['rel']:.3g}, rows sum to 1 within "
          f"{long_rows['sum_err']:.3g}, floor held, max |Dirichlet - "
          f"dirichlet_reference| {long_rows['max_abs_err']:.3g}; "
          f"{long_rows['ms']:.4f} ms, plain {long_rows['plain_ms']:.4f} "
          f"ms, torch._sample_dirichlet {long_rows['library_ms']:.4f} ms, "
          f"bound {long_rows['bound_ms']:.4f} ms ({long_rows['bound_by']}, "
          f"{long_rows['rounds']:.4f} mean rounds)", flush=True)
    for name, v in large.items():
        print(f"[3 gamma] {smi}: {name} {v['shape']} at K=4096 "
              f"({v['launches']} launches): equal the kernel's own Gamma "
              f"draws normalised within {v['rel']:.3g}, "
              f"{v['agree']:.6f} of the elements within {GAMMA_RTOL} of "
              f"dirichlet_reference (max abs difference "
              f"{v['max_abs_err']:.3g}), sums within {v['sum_err']:.3g}, "
              f"floor held; {v['ms']:.4f} ms, plain {v['plain_ms']:.3f} ms, "
              f"torch._sample_dirichlet {v['library_ms']:.4f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']}, {v['rounds']:.4f} "
              f"mean rounds)", flush=True)
    return {"name": "gamma", "route": "cuda",
            "source": "ldagroupedgibbssampler_tpu_torch/csrc/gamma.cu",
            "replaces": "ldagroupedgibbssampler_tpu/ops/random.py:43",
            "max_abs_err": max_err, "ms": theta_ms + phi_ms,
            "theta_ms": theta_ms, "phi_ms": phi_ms, "gamma_ms": gamma_ms,
            "plain_ms": plain_ms, "eager_ms": eager_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_dir_ms, "library_gamma_ms": lib_gamma_ms,
            "agreement": {"theta": out["theta"][:3], "phi": out["phi"][:3]},
            "warp_rounds": {"theta": out["theta"][3], "phi": out["phi"][3]},
            "grid": grid, "long_rows": long_rows, "k4096": large}


def gamma_long_rows(torch, nkw_kv, beta, seed, cuda_gamma, rnd):
    """The long-row Dirichlet (csrc/gamma.cu's dirichlet_long_draw_kernel
    and dirichlet_long_normalise_kernel: fewer than LONG_ROWS_BELOW rows,
    each split across blocks of LONG_CHUNK) at the PCGS family's phi shape:
    int32 N_kw [K, V] + beta over the last axis. Held to the Gamma kernel's
    own draws of the same concentrations floored and normalised by torch
    (within GAMMA_RTOL) and to dirichlet_reference; rows sum to 1 within
    1e-5 and every coordinate is above 0. Timed beside the plain version,
    torch._sample_dirichlet and the bound, from the rounds this run's
    draws took."""
    rows, last = nkw_kv.shape
    check(rows < cuda_gamma.LONG_ROWS_BELOW and last >= cuda_gamma.LONG_CHUNK,
          f"[3 gamma] long rows: [{rows}, {last}] takes another path")
    conc = nkw_kv.to(torch.float32) + beta
    launches = cuda_gamma.dirichlet.launches
    got = cuda_gamma.dirichlet(nkw_kv, seed, -1, beta)
    check(cuda_gamma.dirichlet.launches - launches == 2,
          "[3 gamma] long rows: not the two-launch path")
    rk = torch.empty(conc.shape, dtype=torch.int32, device=conc.device)
    g = cuda_gamma.gamma(conc, seed, rk).clamp_min(rnd.DIRICHLET_FLOOR)
    want = g / g.sum(dim=-1, keepdim=True)
    rel = float(((got - want).abs() / want).max())
    check(rel <= GAMMA_RTOL, f"[3 gamma] long rows: the Dirichlet kernels "
          f"off the kernel's own Gamma draws by {rel:.3g}")
    sum_err = float((got.sum(dim=-1) - 1).abs().max())
    check(sum_err <= 1e-5 and bool((got > 0).all()),
          f"[3 gamma] long rows: sums off 1 by {sum_err:.3g}, or the floor")
    err = float((got - cuda_gamma.dirichlet_reference(
        nkw_kv, seed, -1, beta)).abs().max())
    rounds = float((rk.clamp(max=cuda_gamma.ROUNDS - 1) + 1).double().mean())
    ms = time_ms(torch, lambda: cuda_gamma.dirichlet(nkw_kv, seed, -1, beta))
    plain_ms = time_ms(torch, lambda: cuda_gamma.dirichlet_reference(
        nkw_kv, seed, -1, beta), reps=3, calls=2)
    library_ms = time_ms(torch, lambda: torch._sample_dirichlet(conc))
    nbytes = 8 * conc.numel()
    bound_ms, by = bound(nbytes, gamma_ops(conc, rounds) + 4 * conc.numel(),
                         *gamma_int_sfu(conc, rounds))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "rel": rel, "sum_err": sum_err, "rounds": rounds}


def gamma_large_k(torch, corpus, cuda_gamma, rnd, seed, k=4096):
    """The Dirichlet kernels at the K=4096 main path's shapes ([4 ggs
    K=4096], [4 ggs_aliasmh K=4096], [4 held-out K=4096]): theta [D, k]
    from n_dk + 0.5 over the last axis (one launch, a block a row) and phi
    [V, k] from N_kw + 0.01 over axis 0 (two launches, tiles of 128
    columns), n_dk and N_kw a recount of a random z. Each held to the
    Gamma kernel's own draws of the same concentrations floored and
    normalised by torch (within GAMMA_RTOL), to dirichlet_reference (at
    least 0.999 of the elements within GAMMA_RTOL: the rest are the Gamma
    kernel's proven ties and last bits, as gamma_agreement shows at K=100),
    sums within 1e-5 and the floor. Timed beside the plain version (one
    call), torch._sample_dirichlet and the bound, from the rounds this
    run's draws took."""
    dev = seed.device
    z = np.random.default_rng(4).integers(0, k, corpus.num_tokens)
    nkw_ref, ndk_ref = recount(corpus, z, k)
    ndk = torch.as_tensor(ndk_ref.astype(np.int32), device=dev)
    nkw = torch.as_tensor(nkw_ref.astype(np.int32), device=dev)
    del nkw_ref, ndk_ref
    alpha = torch.full((k,), 0.5, device=dev)
    out = {}
    for name, x, dim, prior, launches in (("theta", ndk, -1, alpha, 1),
                                          ("phi", nkw, 0, 0.01, 2)):
        label = f"[3 gamma] {name} K={k}"
        conc = x.to(torch.float32) + prior
        before = cuda_gamma.dirichlet.launches
        got = cuda_gamma.dirichlet(x, seed, dim, prior)
        check(cuda_gamma.dirichlet.launches - before == launches,
              f"{label}: not the {launches}-launch path")
        rk = torch.empty(conc.shape, dtype=torch.int32, device=dev)
        g = cuda_gamma.gamma(conc, seed, rk).clamp_min(rnd.DIRICHLET_FLOOR)
        want = g / g.sum(dim=dim, keepdim=True)
        del g
        rel = float(((got - want).abs() / want).max())
        del want
        check(rel <= GAMMA_RTOL, f"{label}: the Dirichlet kernel off the "
              f"kernel's own Gamma draws by {rel:.3g}")
        sum_err = float((got.sum(dim=dim) - 1).abs().max())
        check(sum_err <= 1e-5 and bool((got > 0).all()),
              f"{label}: sums off 1 by {sum_err:.3g}, or the floor")
        plain = cuda_gamma.dirichlet_reference(x, seed, dim, prior)
        agree = 1.0 - float((((got - plain).abs() / plain) > GAMMA_RTOL)
                            .double().mean())
        err = float((got - plain).abs().max())
        del plain, got
        check(agree >= 0.999, f"{label}: only {agree:.6f} of the draws "
              f"within {GAMMA_RTOL} of dirichlet_reference")
        rounds = float((rk.clamp(max=cuda_gamma.ROUNDS - 1) + 1).double()
                       .mean())
        del rk
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: cuda_gamma.dirichlet(x, seed, dim, prior))
        plain_ms = once_ms(torch, lambda: cuda_gamma.dirichlet_reference(
            x, seed, dim, prior))
        torch.cuda.empty_cache()
        lib_in = conc if dim == -1 else conc.T.contiguous()
        library_ms = time_ms(torch, lambda: torch._sample_dirichlet(lib_in))
        del lib_in
        n = conc.numel()
        bound_ms, by = bound(8 * n + 4 * k,
                             gamma_ops(conc, rounds) + 4 * n,
                             *gamma_int_sfu(conc, rounds))
        out[name] = {"shape": list(conc.shape), "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": by,
                     "max_abs_err": err, "rel": rel, "agree": agree,
                     "sum_err": sum_err, "rounds": rounds,
                     "launches": launches}
        del conc
        torch.cuda.empty_cache()
    return out


L2R_DOCS = 64               # test documents held to the plain version
L2R_SEEDS = 5               # seeds of the plain estimator (1.6 s each at K=4096)
L2R_KERNEL_SEEDS = 10
# a proven tie: the exact cdf within L2R_TIE sqrt(K) 2^-24 T of u T. The
# f32 sums' rounding errors add up like a random walk, ~sqrt(K) units of
# 2^-24 T; the window is 15x below a topic's share T / K at K = 4096
L2R_TIE = 4.0
L2R_TOTAL_RTOL = 1e-5       # the kernel's total against the plain one


def l2r_tie_proof(torch, wp_t, alpha, w_pad, mask, z_ref, seed, t, r, d,
                  zk, zr):
    """Whether the first differing draw of particle r of document d, at
    position t, is a tie: with the counts of the draws before t (equal on
    both sides), every cdf value from min(zk, zr) up to the other draw
    minus one, recomputed in float64, lies within L2R_TIE sqrt(K) 2^-24 T
    of u T. Returns (the verdict, the largest gap over T)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_left_to_right
    k = wp_t.shape[1]
    past = z_ref[:t, r, d]
    past = past[past >= 0].long()
    counts = torch.bincount(past, minlength=k).double()
    s = (counts + alpha.double()) * wp_t[int(w_pad[d, t])].double()
    cdf = torch.cumsum(s, 0)
    total = float(cdf[-1])
    u = int(cuda_left_to_right._u24(seed, t, r + 1, d + 1)[r, d])
    target = u * 2.0 ** -24 * total
    lo, hi = min(zk, zr), max(zk, zr)
    gap = float((cdf[lo:hi] - target).abs().max())
    return (gap <= L2R_TIE * np.sqrt(k) * 2.0 ** -24 * total,
            gap / max(total, 1e-300))


def l2r_kernel_prefix(a, warps):
    """The dense prefix A_k of csrc/left_to_right.cu (dense_prefix) in its
    f32 association: warp v scans its chunks of 32 topics (a Hillis-Steele
    scan, then the carry of its chunks before), then adds the sum of the
    totals of warps 0..v-1 in order (warp 0 adds nothing)."""
    f32 = np.float32
    a = np.asarray(a, f32)
    k = len(a)
    nch = -(-k // 32)
    cpw = -(-nch // warps)
    padded = np.zeros(nch * 32, f32)
    padded[:k] = a
    local = np.zeros(nch * 32, f32)
    tot = np.zeros(warps, f32)
    for w in range(warps):
        carry = f32(0)
        for c in range(w * cpw, min((w + 1) * cpw, nch)):
            vals = (carry + _hillis_steele32(padded[c * 32:c * 32 + 32])
                    ).astype(f32)
            local[c * 32:c * 32 + 32] = vals
            carry = vals[31]
        tot[w] = carry
    out = local[:k].copy()
    for w in range(1, warps):
        off = f32(0)
        for v in range(w):
            off = f32(off + tot[v])
        lo, hi = w * cpw * 32, min((w + 1) * cpw * 32, k)
        out[lo:hi] = (off + local[lo:hi]).astype(f32)
    return out


def l2r_kernel_draw(a, u24, warps, entries=(), wrow=None):
    """The draw of csrc/left_to_right.cu for one particle, in the kernel's
    own f32 association, before its zero-topic repair: a [K] the dense
    products alpha_k wp[w, k] (l2r_kernel_prefix), entries the particle's
    list of (topic, count) sorted by topic, wrow [K] the word's row of wp.
    C = the entries' c_j wp[w, t_j] summed in list order, kept after every
    STEP-th entry; T = A_{K-1} + C. A binary search over the runs of STEP
    entries finds the first whose last entry's cdf A_t + C passes u T; the
    run is walked from the sum before it (the segment before each entry,
    a binary search of A where A_k + C passes u T there, then the entry);
    past the runs, the segment after the list; else K - 1. Returns (z, T,
    whether z is listed, z's list index or insertion point)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_left_to_right
    f32 = np.float32
    step = cuda_left_to_right.STEP
    A = l2r_kernel_prefix(a, warps)
    k = len(A)
    m = len(entries)
    q = [f32(f32(c) * f32(wrow[t])) for t, c in entries]
    sums, c_all = [], f32(0)
    for j in range(m):
        c_all = f32(c_all + q[j])
        if j % step == step - 1:
            sums.append(c_all)
    total = f32(A[-1] + c_all)
    target = f32(f32(f32(u24) * f32(2.0 ** -24)) * total)

    def first_above(lo, hi, c):
        while lo < hi:
            mid = (lo + hi) >> 1
            if f32(A[mid] + c) > target:
                hi = mid
            else:
                lo = mid + 1
        return lo
    rlo, rhi = 0, len(sums)
    while rlo < rhi:
        mid = (rlo + rhi) >> 1
        if f32(A[entries[mid * step + step - 1][0]] + sums[mid]) > target:
            rhi = mid
        else:
            rlo = mid + 1
    j1 = rlo * step
    c = sums[rlo - 1] if rlo > 0 else f32(0)
    lo = entries[j1 - 1][0] + 1 if j1 > 0 else 0
    for j in range(j1, min(j1 + step, m)):
        t = entries[j][0]
        if t > lo and f32(A[t - 1] + c) > target:
            return first_above(lo, t - 1, c), total, False, j
        c = f32(c + q[j])
        if f32(A[t] + c) > target:
            return t, total, True, j
        lo = t + 1
    if lo < k and f32(A[-1] + c) > target:
        return first_above(lo, k - 1, c), total, False, m
    listed = m > 0 and entries[-1][0] == k - 1
    return k - 1, total, listed, m - 1 if listed else m


def l2r_zero_run_case(k=100, seed=0):
    """A one-position, one-particle case on which the estimator kernel's
    draw, before its repair, lands on a topic whose product is 0: products
    p (the alpha of a document's first position under a word whose
    probability is 1 in every topic, so the list is empty and the draw is
    a binary search of the dense prefix A) with a zero at topic z inside a
    32-topic chunk where the shuffle scan's rounding gives A_z > A_{z-1},
    and the topics after z scaled so that u T lies between the two. u is
    the kernel's Philox word of (seed 0, position 0, particle 0, document
    0); the warps are the kernel's launch shape for one particle. Found by
    a seeded search over l2r_kernel_draw."""
    import torch
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_left_to_right
    u24 = int(cuda_left_to_right._u24(
        torch.zeros(1, dtype=torch.int64), 0, 1, 1)[0, 0])
    warps = cuda_left_to_right.launch_shape(k, 1, 1).warps
    u = float(np.float32(np.float32(u24) * np.float32(2.0 ** -24)))
    rng = np.random.default_rng(seed)
    for _ in range(20_000):
        p = (rng.random(k) * rng.choice([1.0, 1e-3, 1e3], k)).astype(
            np.float32)
        z0 = int(rng.integers(2, min(k, 64)))
        if z0 % 32 == 0:
            continue
        p[z0] = 0
        A = l2r_kernel_prefix(p, warps)
        if not A[z0] > A[z0 - 1]:
            continue
        rest = float(A[-1]) - float(A[z0])
        want = (float(A[z0 - 1]) + float(A[z0])) / 2 / u
        scale = (want - float(A[z0])) / rest
        if scale <= 0:
            continue
        p[z0 + 1:] = (p[z0 + 1:] * scale).astype(np.float32)
        z = l2r_kernel_draw(p, u24, warps)[0]
        if p[z] == 0:
            return {"alpha": p, "u24": u24, "unrepaired": z}
    raise AssertionError("no zero-topic case found")


def l2r_zero_run_draw(torch, case, device="cuda"):
    """The estimator on the case (one document of one word, word
    probabilities 1, alpha = the products, one particle, seed 0): returns
    (the kernel's z, the plain version's z); on the CPU both are the plain
    version."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_left_to_right
    alpha = torch.as_tensor(case["alpha"], device=device)
    k = alpha.numel()
    w_pad = torch.zeros((1, 1), dtype=torch.int32, device=device)
    mask = torch.ones((1, 1), dtype=torch.bool, device=device)
    word_prob = torch.ones((k, 1), device=device)
    seed = torch.zeros(1, dtype=torch.int64, device=device)
    z_k = torch.full((1, 1, 1), -1, dtype=torch.int32, device=device)
    cuda_left_to_right.left_to_right(w_pad, mask, word_prob, alpha, 1, seed,
                                     z_k)
    _, z_r = cuda_left_to_right.left_to_right_reference(
        w_pad, mask, word_prob, alpha, 1, seed, return_z=True)
    return int(z_k.reshape(-1)[0]), int(z_r.reshape(-1)[0])


def l2r_agreement(torch, cuda_left_to_right, w_pad, mask, word_prob, alpha,
                  seed, label):
    """The kernel against left_to_right_reference on the same operands and
    seed: z equal on every (position, particle, document) but after a
    proven tie at that particle's first difference; the totals within
    L2R_TOTAL_RTOL. Returns (share of draws equal, ties, relative total
    difference, largest tie gap over T)."""
    num_docs, length = w_pad.shape
    z_k = torch.full((length, 100, num_docs), -1, dtype=torch.int32,
                     device=w_pad.device)
    tk = float(cuda_left_to_right.left_to_right(w_pad, mask, word_prob,
                                                alpha, 100, seed, z_k))
    tr, z_r = cuda_left_to_right.left_to_right_reference(
        w_pad, mask, word_prob, alpha, 100, seed, return_z=True)
    tr = float(tr)
    rel = abs(tk - tr) / abs(tr)
    check(rel <= L2R_TOTAL_RTOL, f"{label}: total {tk} against plain {tr}")
    differ = z_k != z_r
    share = 1.0 - float(differ.float().mean())
    wp_t = word_prob.T.contiguous()
    ties, worst = 0, 0.0
    # at K=4096 a topic holds ~1/K of T, so a cdf value lies within the
    # f32 sums' rounding of u T in a fraction of the draws: many particles
    # meet a tie somewhere in their ~88 draws, each proven below
    pairs = differ.any(dim=0).nonzero().tolist()
    check(len(pairs) <= 0.2 * 100 * num_docs,
          f"{label}: {len(pairs)} particles differ")
    for r, d in pairs:
        t = int(differ[:, r, d].nonzero()[0, 0])
        ok, gap = l2r_tie_proof(torch, wp_t, alpha, w_pad, mask, z_r, seed,
                                t, r, d, int(z_k[t, r, d]),
                                int(z_r[t, r, d]))
        check(ok, f"{label}: particle {r} of document {d} differs at "
              f"position {t} ({int(z_k[t, r, d])} against "
              f"{int(z_r[t, r, d])}), not a tie (gap {gap:.3g} T)")
        ties += 1
        worst = max(worst, gap)
    return share, ties, rel, worst


def l2r_operands(torch, corpus, k, dev):
    """The operands of one shape of [3 left-to-right]: the 10% split's
    test documents (build_perplexity_split seed 2019, as [4 held-out])
    under the count word probabilities of a training z that puts 80% of
    each word's tokens on topic (word id mod K), alpha 0.5, beta 0.01, and
    the kernel's seed. word_prob [K, V] is a view of [V, K] storage, as
    `ggs` (N_kw kept [V, K]) hands it to the estimator, so the wrapper's
    [V, K] rows need no copy. Returns (w_pad, mask, word_prob, alpha,
    seed, number of test documents)."""
    from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
        build_perplexity_split)
    train, _est, evl = build_perplexity_split(corpus, 0.1, seed=2019)
    rng = np.random.default_rng(5)
    z = np.where(rng.random(train.num_tokens) < 0.8, train.tokens % k,
                 rng.integers(0, k, train.num_tokens))
    nkw = np.bincount(train.tokens * k + z, minlength=V * k).reshape(V, k)
    nkw_t = torch.as_tensor(nkw.astype(np.float32), device=dev)
    word_prob = ((0.01 + nkw_t)
                 / (0.01 * V + nkw_t.sum(dim=0))[None, :]).T
    alpha = torch.full((k,), 0.5, device=dev)
    w_np, m_np = evl.to_padded()
    w_pad = torch.as_tensor(w_np, device=dev)
    mask = torch.as_tensor(m_np, device=dev)
    seed = torch.tensor([0xC0FFEE + k], dtype=torch.int64, device=dev)
    return w_pad, mask, word_prob, alpha, seed, evl.num_docs


def l2r_case(torch, corpus, cuda_left_to_right, marginal, k, smi):
    """One shape of [3 left-to-right] (l2r_operands), 100 particles."""
    dev = torch.device("cuda", 0)
    w_pad, mask, word_prob, alpha, seed, num_test = l2r_operands(
        torch, corpus, k, dev)
    label = f"[3 left-to-right] K={k}"
    agree = l2r_agreement(torch, cuda_left_to_right, w_pad[:L2R_DOCS],
                          mask[:L2R_DOCS], word_prob, alpha, seed, label)
    # the whole split: ten seeds of the kernel against five of the plain
    # generator= estimator (Gumbel-max, the eager path). One estimate
    # against the range of five others would fail ~3% of correct runs (the
    # range of five normal draws is often narrow), so the bar is the means:
    # within 5 standard errors of their difference, from the pooled
    # seed-to-seed deviation (13 degrees of freedom: ~0.02% of correct runs)
    ours = np.array([float(marginal.left_to_right_from_word_prob(
        w_pad, mask, word_prob, alpha, 100,
        generator=torch.Generator(device=dev).manual_seed(s)))
        for s in range(L2R_KERNEL_SEEDS)])
    plain = np.array([float(eager_left_to_right(
        torch, marginal, w_pad, mask, word_prob, alpha,
        torch.Generator(device=dev).manual_seed(100 + s)))
        for s in range(L2R_SEEDS)])
    pooled = (((ours - ours.mean()) ** 2).sum()
              + ((plain - plain.mean()) ** 2).sum()) / (ours.size
                                                       + plain.size - 2)
    se = np.sqrt(pooled * (1 / ours.size + 1 / plain.size))
    check(abs(ours.mean() - plain.mean()) <= 5 * se,
          f"{label}: kernel {ours.tolist()} against the plain estimator "
          f"{plain.tolist()}")
    inside = bool(plain.min() <= ours[0] <= plain.max())
    reps, calls = (7, 5) if k <= 100 else (3, 2)
    ms = time_ms(torch, lambda: cuda_left_to_right.left_to_right(
        w_pad, mask, word_prob, alpha, 100, seed), reps=reps, calls=calls)
    plain_ms = once_ms(torch, lambda: cuda_left_to_right.
                       left_to_right_reference(w_pad, mask, word_prob, alpha,
                                               100, seed))
    eager_ms = once_ms(torch, lambda: eager_left_to_right(
        torch, marginal, w_pad, mask, word_prob, alpha,
        torch.Generator(device=dev).manual_seed(9)))
    peaks = []
    for fn in (lambda: cuda_left_to_right.left_to_right(
            w_pad, mask, word_prob, alpha, 100, seed),
            lambda: cuda_left_to_right.left_to_right_reference(
                w_pad, mask, word_prob, alpha, 100, seed)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    positions = int(mask.sum())
    words = int(torch.unique(w_pad[mask]).numel())
    nbytes = 5 * w_pad.numel() + 4 * words * k + 4 * k + 4
    # the work this run's draws need: a position's dense prefix (a
    # multiply and an add a topic); a particle's draw, two operations an
    # entry of its list for T and the walk, a binary search of log2 K
    # steps, four for u T and p; a Philox block (40 32-bit multiplies)
    z_all = torch.full((w_pad.shape[1], 100, w_pad.shape[0]), -1,
                       dtype=torch.int32, device=dev)
    cuda_left_to_right.left_to_right(w_pad, mask, word_prob, alpha, 100,
                                     seed, z_all)
    steps = l2r_list_steps(torch, z_all, mask, k)
    del z_all
    draws = positions * 100
    nops = (2.0 * positions * k + 2.0 * steps
            + draws * (np.ceil(np.log2(max(k, 2))) + 4))
    bound_ms, by = bound(nbytes, nops, int_ops=40.0 * draws)
    shape = cuda_left_to_right.launch_shape(k, 100, w_pad.shape[1])
    print(f"{label} {smi}: {num_test} test documents, {positions} "
          f"scored positions of {w_pad.shape[1]}, 100 particles; kernel "
          f"against left_to_right_reference on the first {L2R_DOCS} "
          f"documents: draws equal {agree[0]:.6f}, {agree[1]} particles "
          f"with a proven tie (largest gap {agree[3]:.3g} T), total within "
          f"{agree[2]:.3g}; the whole split, kernel seeds 0-9 "
          f"{json.dumps([round(v, 3) for v in ours])}, plain generator= "
          f"estimator seeds 100-104 "
          f"{json.dumps([round(v, 3) for v in plain])} (means "
          f"{ours.mean() - plain.mean():+.3f} apart, {5 * se:.3f} allowed; "
          f"seed 0 inside the plain range: {inside}); "
          f"{ms:.4f} ms against plain {plain_ms:.3f} ms and the eager "
          f"Gumbel estimator {eager_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({by}; {words} word rows, {steps / draws:.2f} list entries a "
          f"draw); peak memory above the operands {peaks[0]:.3f} GiB "
          f"(plain {peaks[1]:.3f} GiB); launch {shape._asdict()}",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "eager_ms": eager_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "max_abs_err": agree[2], "agree": agree[0], "ties": agree[1],
            "peak_gib": peaks[0], "plain_peak_gib": peaks[1],
            "kernel_seeds": ours.tolist(), "plain_seeds": plain.tolist(),
            "seed0_inside_plain_range": inside}


L2R_ONE_BUFFER_K = 20_001   # one word-row buffer at 88 positions, K % 4 != 0
L2R_ONE_BUFFER_DOCS = 8


def l2r_one_buffer_case(torch, corpus, cuda_left_to_right, smi,
                        k=L2R_ONE_BUFFER_K, docs=L2R_ONE_BUFFER_DOCS):
    """The estimator kernel where two word rows and a particle's list do
    not fit a block's shared memory (one row buffer, refilled after each
    position's draws) and K is not a multiple of 4 (4-byte row copies):
    l2r_operands at K = k, 100 particles, the first `docs` documents held
    to left_to_right_reference as [3 left-to-right] holds them (l2r_
    agreement). Returns the kernels-JSON entry's `one_buffer`."""
    dev = torch.device("cuda", 0)
    w_pad, mask, word_prob, alpha, seed, _n = l2r_operands(torch, corpus, k,
                                                           dev)
    w_pad, mask = w_pad[:docs].contiguous(), mask[:docs].contiguous()
    shape = cuda_left_to_right.launch_shape(k, 100, w_pad.shape[1])
    label = f"[3 left-to-right] K={k}"
    check(shape.row_buffers == 1 and k % 4 != 0,
          f"{label}: not the one-buffer, 4-byte path: {shape}")
    agree = l2r_agreement(torch, cuda_left_to_right, w_pad, mask, word_prob,
                          alpha, seed, label)
    ms = time_ms(torch, lambda: cuda_left_to_right.left_to_right(
        w_pad, mask, word_prob, alpha, 100, seed), reps=3, calls=2)
    print(f"{label} {smi}: the first {docs} test documents, one word-row "
          f"buffer, 4-byte row copies; kernel against "
          f"left_to_right_reference: draws equal {agree[0]:.6f}, {agree[1]} "
          f"particles with a proven tie (largest gap {agree[3]:.3g} T), "
          f"total within {agree[2]:.3g}; {ms:.4f} ms; launch "
          f"{shape._asdict()}", flush=True)
    return {"k": k, "docs": docs, "ms": ms, "agree": agree[0],
            "ties": agree[1], "total_rel": agree[2]}


def l2r_list_steps(torch, z, mask, k):
    """The list entries the kernel's particles walk over a run: the sum
    over real positions t, particles r and documents d of the distinct
    topics r drew in d before t. z: the draws, int32 [L, R, D] (-1 where
    not real); mask [D, L], each document's real positions a prefix."""
    length, num_r, num_d = z.shape
    zz = z.permute(1, 2, 0).reshape(num_r * num_d, length).long()
    t = torch.arange(length, device=z.device)
    rd = torch.arange(num_r * num_d, device=z.device)[:, None]
    key = (rd * k + zz) * length + t
    key = key[zz >= 0].sort().values
    topic = key // length
    first = torch.ones_like(topic, dtype=torch.bool)
    first[1:] = topic[1:] != topic[:-1]
    t_first = (key % length)[first]
    d = (topic[first] // k) % num_d
    seen = mask.long().cumsum(dim=1)
    return int((seen[d, -1] - seen[d, t_first]).sum())


def eager_left_to_right(torch, marginal, w_pad, mask, word_prob, alpha,
                        generator):
    """The plain estimator with the generator's Gumbel draws, as the port
    ran it on the card before the kernel: its noise injected per position
    so that the plain path runs on the card."""
    shape = (100, w_pad.shape[0], word_prob.shape[0])

    def noise(t):
        return marginal._gumbel(shape, generator, word_prob.device)
    return marginal.left_to_right_from_word_prob(
        w_pad, mask, word_prob, alpha, 100, gumbel=noise)


def left_to_right_phase(torch, corpus, cuda_left_to_right, smi,
                        k_big=4096):
    """[3 left-to-right]: the estimator kernel (csrc/left_to_right.cu) at
    the [4 held-out] shapes, K = 100 and 4096, and on a few documents at
    K = 20,001 (l2r_one_buffer_case). Returns the kernels-JSON entry (K =
    100's numbers, K = 4096's under `k4096`)."""
    from ldagroupedgibbssampler_tpu_torch.evaluation import marginal
    # the zero-topic repair (ROADMAP C): a case on which the kernel's
    # draw, before its repair, lands on a topic whose product is 0
    case = l2r_zero_run_case()
    zk, zr = l2r_zero_run_draw(torch, case)
    check(case["alpha"][zk] > 0, f"[3 left-to-right] zero-topic tie: the "
          f"kernel drew topic {zk}, whose product is 0")
    print(f"[3 left-to-right] zero-topic tie (one particle, u24 "
          f"{case['u24']}): the unrepaired walk of the kernel's association "
          f"draws topic {case['unrepaired']} (product 0); the kernel draws "
          f"{zk} (product {float(case['alpha'][zk]):.4g}), the plain "
          f"version {zr}", flush=True)
    k100 = l2r_case(torch, corpus, cuda_left_to_right, marginal, K, smi)
    torch.cuda.empty_cache()
    k4096 = l2r_case(torch, corpus, cuda_left_to_right, marginal, k_big, smi)
    torch.cuda.empty_cache()
    one_buffer = l2r_one_buffer_case(torch, corpus, cuda_left_to_right, smi)
    torch.cuda.empty_cache()
    return {"name": "left_to_right", "route": "cuda",
            "source": "ldagroupedgibbssampler_tpu_torch/csrc/left_to_right.cu",
            "replaces":
                "ldagroupedgibbssampler_tpu/evaluation/marginal.py:38",
            **{key: k100[key] for key in (
                "max_abs_err", "ms", "plain_ms", "eager_ms", "bound_ms",
                "bound_by", "agree", "ties", "peak_gib", "plain_peak_gib")},
            "library_ms": None, "k4096": k4096, "one_buffer": one_buffer}


# [4 fused]: scan_chunk. A fused group is exactly FUSED_CHUNK event-free
# iterations; with the likelihood every 10, 9 is the largest group between
# two events (27 of 30 iterations fused, 9 of 10).
FUSED_CHUNK = 9
FUSED_PAIRS = (("ggs", 100, ITERS), ("pcgs", 100, ITERS),
               ("lightpclda", 100, ITERS), ("adlda", 100, ITERS),
               ("ggs_aliasmh", 100, ITERS), ("pcgs", 200, 10),
               ("lightpclda", 200, 10), ("adlda", 200, 10),
               ("ggs", 4096, 10))


def chain_snapshot(model):
    """(the fields a step replaces, cloned; the likelihood series; the
    iteration) of a model."""
    from ldagroupedgibbssampler_tpu_torch.models.fusion import FIELDS
    st = model.state
    return ({f: None if getattr(st, f) is None else getattr(st, f).clone()
             for f in FIELDS}, model.get_log_likelihoods(), st.iteration)


def check_same_chain(torch, label, a, b):
    """Two chain_snapshot()s are bit-equal."""
    (fa, la, ia), (fb, lb, ib) = a, b
    check(ia == ib, f"{label}: iterations {ia} and {ib}")
    for f, t in fa.items():
        u = fb[f]
        check(t is None and u is None or (t is not None and u is not None
                                          and torch.equal(t, u)),
              f"{label}: {f} differs between the fused and the "
              "single-stepped chain")
    check(la == lb, f"{label}: likelihood series {la} and {lb}")


def timed_sample(torch, model, iters, counters):
    """model.sample(iters) with every launch counter set to 0 and the peak
    memory reset just before: (ms/iteration host wall, {counter: launches
    > 0}, peak GiB allocated)."""
    for fn, attr in counters:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.sample(iters)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    launches = {f"{fn.__name__}.{attr}": getattr(fn, attr)
                for fn, attr in counters if getattr(fn, attr)}
    return ms, launches, torch.cuda.max_memory_allocated() / 2 ** 30


def sync_debug_step(torch, model):
    """One single-stepped iteration, on a copy of the state, under
    torch.cuda.set_sync_debug_mode("error"): any host sync on the step's
    path (.item(), float(tensor), .cpu(), nonzero, a blocking copy)
    raises. Advances the model's generator."""
    import dataclasses
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model._step(dataclasses.replace(model.state), None, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def expected_groups(model, iters, chunk):
    """The fused groups of model.sample(iters) from iteration 1, by the
    base's own rule."""
    it, groups = 1, 0
    while it <= iters:
        n = model._fusable_span(it, iters, chunk)
        groups += n > 1
        it += n
    return groups


def fused_pair(torch, corpus, LDAConfig, create_model, counters, scheme, k,
               iters, timed=True, chunk=FUSED_CHUNK, serial=False,
               exact=True, **kw):
    """`scheme` at K=`k` from seed 2019 twice, single-stepped and with
    scan_chunk = `chunk`, `iters` iterations each with the likelihood
    every 10 (and `kw` config keys): z, n_dk, N_kw, n_k, phi and theta
    bit-equal, the likelihood series and every launch counter equal, the
    counts exact, each group the base's rule forms fused. `serial`
    launches adlda's sweep as one warp (the sequential chain). `exact`
    False is the parallel collapsed launch, whose draws depend on the
    order of the other warps' atomics, so that two runs of one chain
    differ: a third chain, single-stepped again, shows by how much, and
    the fused chain's likelihood must lie within 0.5% (the [4 adlda
    oracle] bar) of the single-stepped one's, counts exact and launches
    equal. With `timed`, both chains then run `iters` more in turns
    (single, fused, fused, single), still bit-equal when `exact`; then
    device busy under the profiler over `chunk` single-stepped iterations
    and over three replays of a group captured beforehand (and CUDA events
    over three more), and last, at K=100, the sync-debug pass on the
    single-stepped model. Returns the numbers."""
    from ldagroupedgibbssampler_tpu_torch.models.fusion import FusedSteps
    label = f"[4 fused] {scheme} K={k}"

    def make(c):
        m = create_model(pcgs_config(LDAConfig, scheme, k).replace(
            scan_chunk=c, **kw))
        if serial:
            m._serial_sweep = True
        return m.add_instances(corpus)
    single, fused = make(1), make(chunk)
    check(fused._fusable_chunk() == chunk and fused._capturable_step,
          f"{label}: the scheme is not fused")
    runs = [timed_sample(torch, m, iters, counters) for m in (single, fused)]
    for m in (single, fused):
        check_counts_exact(m, corpus, label)
    check(runs[0][1] == runs[1][1], f"{label}: launches {runs[0][1]} "
          f"single-stepped, {runs[1][1]} fused")
    fs = fused.fused_steps
    groups = expected_groups(fused, iters, chunk)
    check(groups >= 1 and fs.groups == groups and fs.captures == 1,
          f"{label}: {fs.groups} groups of {groups}, {fs.captures} "
          "captures")
    out = {"launches": runs[0][1], "peak_gib": (runs[0][2], runs[1][2]),
           "capture_s": fs.capture_s, "groups": groups,
           "lls": fused.get_log_likelihoods()}
    if exact:
        check_same_chain(torch, label, chain_snapshot(single),
                         chain_snapshot(fused))
    else:
        again = make(1)
        timed_sample(torch, again, iters, counters)
        check_counts_exact(again, corpus, label)
        out["z_differ"] = tuple(int((m.state.z != single.state.z).sum())
                                for m in (fused, again))
        for (i, a), (j, b) in zip(single.get_log_likelihoods(),
                                  out["lls"]):
            check(i == j and abs(a - b) < 0.005 * abs(a), f"{label}: LL "
                  f"{b} fused against {a} single-stepped at {i}")
        del again
    if not timed:
        return out
    second = [timed_sample(torch, m, iters, counters)
              for m in (fused, single)]
    if exact:
        check_same_chain(torch, f"{label}, second run",
                         chain_snapshot(single), chain_snapshot(fused))
    out["ms"] = (runs[0][0], runs[1][0], second[0][0], second[1][0])
    out["capture_s2"] = fused.fused_steps.capture_s
    # iterations 2 iters + 1 to 2 iters + chunk hold no event
    out["profile_single"] = profile_numbers(
        torch, lambda: single.sample(chunk), chunk)
    steps = FusedSteps(fused)
    masks = [np.ones(corpus.num_docs, bool)] * chunk
    steps.run(masks)
    out["profile_replay"] = profile_numbers(
        torch, lambda: [steps.run(masks) for _ in range(3)], 3 * chunk)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(3):
        steps.run(masks)
    b.record()
    b.synchronize()
    out["replay_event_ms"] = a.elapsed_time(b) / (3 * chunk)
    steps.close()
    if k == 100:
        sync_debug_step(torch, single)
    return out


def fused_phase(torch, corpus, Corpus, LDAConfig, create_model, counters,
                smi):
    """[4 fused]: iteration fusion (scan_chunk) as captured CUDA graphs
    against single-stepping: the nine pairs of FUSED_PAIRS (timed and
    profiled), ggs with random scan over documents (half of them an
    iteration), every other fusable scheme for 10 iterations, the serial
    oracle `collapsed` on 20 documents (its groups run single-stepped: no
    capture), the HDP family (unfused by its hook), and the sync-debug
    pass on every fusable scheme at K=100."""
    name = torch.cuda.get_device_name(0)

    def prof(p):
        return profile_summary(*p, "iteration")
    for scheme, k, iters in FUSED_PAIRS:
        exact = scheme != "adlda"
        r = fused_pair(torch, corpus, LDAConfig, create_model, counters,
                       scheme, k, iters, exact=exact)
        s1, f1, f2, s2 = r["ms"]
        same = ("z, n_dk, N_kw, n_k, phi, theta bit-equal after "
                f"{iters} and {2 * iters}; LL series equal" if exact else
                "the parallel collapsed launch differs between two runs "
                "of one chain (a second single-stepped chain on "
                f"{r['z_differ'][1]} tokens, the fused one on "
                f"{r['z_differ'][0]}): LL within 0.5%")
        print(f"[4 fused] {scheme} K={k} on {name} ({smi}), scan_chunk "
              f"{FUSED_CHUNK} against 1, {iters} iterations, likelihood "
              f"every 10 (fused groups: {r['groups']}): {same} "
              f"{json.dumps([round(ll, 1) for _, ll in r['lls']])}; "
              f"launches equal {json.dumps(r['launches'])}; counts exact; "
              f"ms/iteration in turns single {s1:.3f}, fused {f1:.3f}, "
              f"fused {f2:.3f}, single {s2:.3f} (host clock, the capture "
              f"and the likelihood included; capture {r['capture_s']:.3f} "
              f"/ {r['capture_s2']:.3f} s a run); peak memory single "
              f"{r['peak_gib'][0]:.3f} GiB, fused {r['peak_gib'][1]:.3f} "
              f"GiB", flush=True)
        print(f"[4 fused profile] {scheme} K={k}: single-stepped "
              f"{prof(r['profile_single'])}; replays of a captured group "
              f"{prof(r['profile_replay'])}; replays timed by CUDA events "
              f"{r['replay_event_ms']:.3f} ms/iteration", flush=True)
        torch.cuda.empty_cache()
    # the collapsed mode bit for bit: the one-warp launch (the sequential
    # chain, 1.7-3.2 s a sweep) for 3 iterations, one group of 2
    for k in (100, 200):
        r = fused_pair(torch, corpus, LDAConfig, create_model, counters,
                       "adlda", k, 3, timed=False, chunk=2, serial=True)
        print(f"[4 fused adlda one-warp] K={k}: scan_chunk 2 against 1, 3 "
              f"iterations of the one-warp launch (the sequential chain): "
              f"z, n_dk, N_kw, n_k, phi, theta bit-equal; launches equal "
              f"{json.dumps(r['launches'])}", flush=True)
    doc_scan = dict(batch_building_scheme="percentage",
                    percentage_split_size_doc=0.5)
    r = fused_pair(torch, corpus, LDAConfig, create_model, counters, "ggs",
                   100, 10, timed=False, **doc_scan)
    print(f"[4 fused random scan] ggs K=100, half of the documents an "
          f"iteration (percentage builder): z, n_dk, N_kw, n_k, phi, theta "
          f"bit-equal after 10 iterations (1-9 one group on the masked "
          f"graph); LL {r['lls']}; launches equal "
          f"{json.dumps(r['launches'])}", flush=True)
    prior_path = os.path.join(ROOT, "build", "chip_smoke_priors.txt")
    os.makedirs(os.path.dirname(prior_path), exist_ok=True)
    prior_spec_file(corpus, prior_path)
    from ldagroupedgibbssampler_tpu_torch.models.registry import SCHEMES
    paired = {s for s, _, _ in FUSED_PAIRS}
    fusable, others, unfused = [], [], []
    for scheme in SCHEMES:
        kw = ({"topic_prior_filename": prior_path}
              if scheme == "spalias_priors" else {})
        model = create_model(pcgs_config(LDAConfig, scheme, 100).replace(
            scan_chunk=FUSED_CHUNK, **kw))
        if model._fusable_chunk() == 1:
            unfused.append(scheme)
            continue
        if not model._capturable_step:
            continue
        fusable.append(scheme)
        if scheme in paired:
            continue
        fused_pair(torch, corpus, LDAConfig, create_model, counters, scheme,
                   100, 10, timed=False, **kw)
        model.add_instances(corpus)
        sync_debug_step(torch, model)
        others.append(scheme)
        del model
        torch.cuda.empty_cache()
    check(set(unfused) == {"ppu_hlda", "ppu_hdplda", "ppu_hdplda_all_topics"},
          f"unfused schemes {unfused}")
    # the serial oracle: groups formed, run single-stepped, no capture
    sub = first_docs(Corpus, corpus, 20)
    snaps = []
    for chunk in (1, 2):
        model = create_model(pcgs_config(LDAConfig, "collapsed", 100)
                             .replace(scan_chunk=chunk))
        model.add_instances(sub)
        model.sample(2)
        snaps.append(chain_snapshot(model))
    fs = model.fused_steps
    check(fs.groups == 1 and fs.captures == 0,
          f"collapsed: {fs.groups} groups, {fs.captures} captures")
    check_same_chain(torch, "[4 fused] collapsed", *snaps)
    print(f"[4 fused] sync-debug pass (one single-stepped iteration under "
          f"set_sync_debug_mode('error'), K=100) on every fusable scheme: "
          f"{', '.join(fusable)}; {', '.join(others)} also fused for 10 "
          f"iterations, bit-equal to single-stepping with equal launches; "
          f"collapsed on the first 20 documents: one group of 2 run "
          f"single-stepped (no capture), bit-equal; unfused by the hook "
          f"rule: {', '.join(unfused)}", flush=True)



# [4 sample_chunked]: the GGS family's multi-iteration path, one kept
# CUDA graph of CHUNK full sweeps a (model, chunk), replayed by every call
CHUNK = 10
CHUNKED_PAIRS = (("ggs", K, ITERS), ("ggs_aliasmh", K, ITERS),
                 ("ggs", 4096, 10))
BENCH_REPEATS = 5


def chunked_config(LDAConfig, scheme, k, **kw):
    """The main path's config without a logging event (topic_interval
    -1), so that sample() with scan_chunk fuses every whole group."""
    return pcgs_config(LDAConfig, scheme, k).replace(topic_interval=-1,
                                                     **kw)


def chunked_pair(torch, corpus, LDAConfig, create_model, counters, scheme,
                 k, iters):
    """`scheme` at K=`k` from seed 2019 twice: sample_chunked(iters,
    chunk=CHUNK) against a twin's sample(iters) with scan_chunk = CHUNK,
    each with the launch counters set to 0 just before and read just
    after: z, n_dk, N_kw, n_k, phi, theta and the iteration bit-equal,
    the launches equal, the counts exact, one capture. Returns (the
    chunked model, its launches)."""
    label = f"[4 sample_chunked] {scheme} K={k}"
    chunked = create_model(chunked_config(LDAConfig, scheme, k))
    chunked.add_instances(corpus)
    twin = create_model(chunked_config(LDAConfig, scheme, k,
                                       scan_chunk=CHUNK))
    twin.add_instances(corpus)
    runs = []
    for run in (lambda: chunked.sample_chunked(iters, chunk=CHUNK),
                lambda: twin.sample(iters)):
        zero_launches(counters)
        run()
        torch.cuda.synchronize()
        runs.append(read_launches(counters))
    check(runs[0] == runs[1], f"{label}: launches {runs[0]} chunked, "
          f"{runs[1]} by sample()")
    # the path's kernels: the z-draw once an iteration (ggs), the alias-MH
    # pre-pass, rounds and pack once an iteration (ggs_aliasmh, packed),
    # the counts at least once, theta and phi by the Dirichlet kernels
    got = runs[0]
    mh = (got["entry_topics"], got["mh_rounds"], got["pack_tables"])
    check((got["fused_zdraw_nkw"] == iters or scheme != "ggs")
          and mh == ((iters,) * 3 if scheme == "ggs_aliasmh" else (0,) * 3)
          and got["blocked_label_counts"] >= iters
          and got["dirichlet"] == 3 * iters,
          f"{label}: launches {got}")
    check(chunked.chunked_steps.captures == 1
          and chunked.chunked_steps.groups == iters // CHUNK
          and twin.fused_steps.groups == iters // CHUNK,
          f"{label}: {chunked.chunked_steps.captures} captures, "
          f"{chunked.chunked_steps.groups} and {twin.fused_steps.groups} "
          "groups")
    check_same_chain(torch, label, chain_snapshot(chunked),
                     chain_snapshot(twin))
    check_counts_exact(chunked, corpus, label)
    del twin
    return chunked, runs[0]


def chunked_bench(torch, model, n_tok):
    """bench.py's measurement on the port: `_multi_step_fn(n)` for n = 10
    and 30, each captured by a first call outside the timed region, then
    BENCH_REPEATS calls each bounded by torch.cuda.synchronize(); tokens/s
    = N x 2 x 10 / (median(t_30) - median(t_10)). Returns (tokens/s, the
    repeats' seconds by n)."""
    times = {}
    for n in (CHUNK, 3 * CHUNK):
        run = model._multi_step_fn(n)
        run()
        torch.cuda.synchronize()
        out = []
        for _ in range(BENCH_REPEATS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        times[n] = out
    med = {n: float(np.median(t)) for n, t in times.items()}
    return n_tok * 2 * CHUNK / (med[3 * CHUNK] - med[CHUNK]), times


def sample_chunked_phase(torch, corpus, LDAConfig, create_model, counters,
                         rnd, smi):
    """[4 sample_chunked]: sample_chunked on ggs and ggs_aliasmh at K=100
    (30 iterations) and ggs at K=4096 (10), each bit-equal to a twin's
    sample() with scan_chunk = CHUNK (chunked_pair); on the ggs K=100
    model: 25 iterations in chunks of 10 advance 30; a sample() between
    two chunks is honoured; three sample_chunked calls and five calls of
    one _multi_step_fn(10) callable capture once, the capture's host
    seconds split into the warm-up step and capture + instantiation, the
    replay's ms/iteration by CUDA events and by host wall, bench.py's
    tokens/s (a preview, not a number of record), a new beta recaptures;
    the getters; a pre_z hook keeps scan_chunk 10 from fusing and runs 30
    times; log_dirichlet at theta's [D, K] and phi's [K, V] against the
    Dirichlet kernel's draw from the same generator state. Returns (the
    launches of the ggs K=100 chunked run by wrapper, the capture and
    replay numbers, the launches of the ggs_aliasmh chunked run)."""
    name = torch.cuda.get_device_name(0)
    for scheme, k, iters in CHUNKED_PAIRS:
        model, launches = chunked_pair(torch, corpus, LDAConfig,
                                       create_model, counters, scheme, k,
                                       iters)
        print(f"[4 sample_chunked] {scheme} K={k} on {name} ({smi}): "
              f"sample_chunked({iters}, chunk={CHUNK}) against sample("
              f"{iters}) with scan_chunk {CHUNK}: z, n_dk, N_kw, n_k, phi, "
              f"theta and the iteration bit-equal; one capture; launches "
              f"equal {json.dumps({n: c for n, c in launches.items() if c})}"
              f"; counts exact", flush=True)
        if (scheme, k) == ("ggs", K):
            out, kept = launches, model
        else:
            if scheme == "ggs_aliasmh":
                aliasmh = launches
            del model
        torch.cuda.empty_cache()
    model, steps = kept, kept.chunked_steps
    label = f"[4 sample_chunked] ggs K={K}"
    it0 = model.state.iteration
    model.sample_chunked(25, chunk=CHUNK)
    check(model.state.iteration == it0 + 30,
          f"{label}: 25 in chunks of 10 advanced {model.state.iteration - it0}")
    # a sample() between two chunks, against a twin that fuses all three
    twin = create_model(chunked_config(LDAConfig, "ggs", K,
                                       scan_chunk=CHUNK))
    twin.add_instances(corpus)
    between = create_model(chunked_config(LDAConfig, "ggs", K))
    between.add_instances(corpus)
    between.sample_chunked(CHUNK, chunk=CHUNK)
    between.sample(CHUNK)
    between.sample_chunked(CHUNK, chunk=CHUNK)
    twin.sample(3 * CHUNK)
    check_same_chain(torch, f"{label}, chunk + sample() + chunk",
                     chain_snapshot(between), chain_snapshot(twin))
    del twin, between
    # one capture for each n across calls
    captures = steps.captures
    for _ in range(3):
        model.sample_chunked(2 * CHUNK, chunk=CHUNK)
    run = model._multi_step_fn(CHUNK)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(5):
        run()
    b.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (5 * CHUNK)
    event_ms = a.elapsed_time(b) / (5 * CHUNK)
    check(steps.captures == captures == 1 and model.chunked_steps is steps,
          f"{label}: {steps.captures} captures after repeated calls")
    warm_s, cap_s = steps.warmup_s, steps.capture_s - steps.warmup_s
    tok_s, times = chunked_bench(torch, model, corpus.num_tokens)
    check(steps.captures == 2, f"{label}: {steps.captures} captures after "
          f"_multi_step_fn({3 * CHUNK}) five times (want one more)")
    # a new beta is baked into no kept graph: the next call recaptures
    model.state.beta = float(np.float32(0.02))
    model.sample_chunked(CHUNK, chunk=CHUNK)
    check(steps.captures == 3, f"{label}: no recapture after beta changed")
    model.state.beta = float(np.float32(0.01))
    check_counts_exact(model, corpus, label)
    print(f"{label} on {name} ({smi}): 25 iterations in chunks of 10 "
          f"advanced 30; chunk + sample() + chunk bit-equal to sample(30) "
          f"with scan_chunk 10; three sample_chunked calls and five calls "
          f"of one _multi_step_fn(10) callable: 1 capture (warm-up step "
          f"{warm_s:.4f} s, capture + instantiation {cap_s:.4f} s host); "
          f"replay {event_ms:.4f} ms/iteration by CUDA events, "
          f"{wall_ms:.4f} by host wall; _multi_step_fn(30) five times: 1 "
          f"capture more; a new beta: 1 more", flush=True)
    print(f"{label} bench preview (ROADMAP A2, not a number of record): "
          f"bench.py's formula N x 2 x 10 / (median t_30 - median t_10), "
          f"{BENCH_REPEATS} repeats each bounded by torch.cuda.synchronize"
          f"(), the graphs captured outside the timed region: {tok_s:.0f} "
          f"tokens/s; t_10 {json.dumps(times[CHUNK])} s, t_30 "
          f"{json.dumps(times[3 * CHUNK])} s", flush=True)
    numbers = {"warmup_s": warm_s, "capture_s": cap_s,
               "replay_event_ms": event_ms, "replay_wall_ms": wall_ms,
               "bench_preview_tokens_s": tok_s}
    # the getters
    beta = model.get_beta()
    check(isinstance(beta, float) and beta == float(np.float32(0.01)),
          f"{label}: get_beta() = {beta!r}")
    ttm = model.get_type_topic_matrix()
    check(ttm.shape == (corpus.num_types, K)
          and np.array_equal(ttm, model.get_topic_type_counts().T)
          and not model.get_abort(), f"{label}: get_type_topic_matrix")
    # a hook keeps scan_chunk from fusing; it runs once an iteration
    calls = []
    hooked = type("PreZ", (type(model),),
                  {"pre_z": lambda self: calls.append(1)})(
        chunked_config(LDAConfig, "ggs", K, scan_chunk=CHUNK))
    hooked.add_instances(corpus)
    hooked.sample(ITERS)
    check(hooked.fused_steps is None and len(calls) == ITERS,
          f"[4 sample_chunked] pre_z hook: {len(calls)} calls, fused "
          f"{hooked.fused_steps is not None}")
    # log_dirichlet against the Dirichlet kernel, same generator state
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_gamma
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0x10D1)
    st = model.state
    errs = {}
    for what, conc in (("theta", st.ndk.to(torch.float32) + st.alpha),
                       ("phi", (st.nkw.T.to(torch.float32) + st.beta)
                        .contiguous())):
        state = gen.get_state()
        cuda_gamma.gamma.launches = cuda_gamma.dirichlet.launches = 0
        x = rnd.log_dirichlet(conc, gen)
        torch.cuda.synchronize()
        check(cuda_gamma.gamma.launches == 1
              and cuda_gamma.dirichlet.launches == 0,
              f"[4 sample_chunked] log_dirichlet {what}: Gamma kernel "
              f"launched {cuda_gamma.gamma.launches} times")
        gen.set_state(state)
        want = rnd.dirichlet(conc, gen).double()
        got = x.double().exp()
        rel = float(((got - want).abs() / want).max())
        sums = float((got.sum(dim=-1) - 1).abs().max())
        check(rel <= GAMMA_RTOL and sums <= 1e-5,
              f"[4 sample_chunked] log_dirichlet {what}: {rel:.3g} from the "
              f"Dirichlet kernel, row sums off by {sums:.3g}")
        errs[what] = (tuple(conc.shape), rel, sums)
    print(f"[4 sample_chunked] getters: get_beta() {beta!r} (the state's "
          f"float32 beta), get_type_topic_matrix() the transpose of "
          f"get_topic_type_counts(), get_abort() False; a pre_z hook with "
          f"scan_chunk {CHUNK}: unfused, called {len(calls)} times in "
          f"{ITERS} iterations; log_dirichlet, one Gamma kernel launch, "
          f"exp of it against the Dirichlet kernel's draw from the same "
          f"generator state (relative error, row sums' error; bar "
          f"{GAMMA_RTOL}): "
          + "; ".join(f"{w} {list(s)} {r:.3g}, {e:.3g}"
                      for w, (s, r, e) in errs.items()), flush=True)
    del hooked, model
    torch.cuda.empty_cache()
    return out, numbers, aliasmh


def recount(corpus, z, num_topics):
    """(N_kw [V, K], n_dk [D, K]) of canonical-order z, on the host."""
    nkw = np.bincount(corpus.tokens.astype(np.int64) * num_topics + z,
                      minlength=corpus.num_types * num_topics)
    ndk = np.bincount(corpus.token_doc_ids().astype(np.int64) * num_topics
                      + z, minlength=corpus.num_docs * num_topics)
    return (nkw.reshape(corpus.num_types, num_topics),
            ndk.reshape(corpus.num_docs, num_topics))


def host_gumbel(torch, shape):
    """Position t's Gumbel noise, drawn on the host from a generator seeded
    by t: the same draws for the estimator on either device."""
    def noise(t):
        gen = torch.Generator().manual_seed(1000 + t)
        u = torch.rand(shape, generator=gen).clamp_min(1e-38)
        return -torch.log(-torch.log(u))
    return noise


def held_out_phase(torch, corpus, LDAConfig, create_model, cuda_counts,
                   cuda_zdraw, cuda_left_to_right, smi, fold_iters=20):
    """[4 held-out]: ggs K=100 on the 90% training split of a 10%
    build_perplexity_split for ITERS iterations, the held-out LL of the
    test documents' second halves every 10 (100 particles); the training
    LL series equal to the same seed's without a test set; the estimator
    on cuda against the same call on cpu given the same injected noise (20
    particles); the count phi against a uniform phi; then the test
    documents' first halves folded in under the trained phi (fold_iters
    iterations, the z-draw in precise mode and the count kernel, their
    counters set to 0 just before and read just after). The estimator
    kernel's launches over the ITERS iterations (its counter set to 0 just
    before, read just after: two a call, three evaluations) are checked.
    Returns the fold-in's launches of the two kernels and the
    estimator's."""
    from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
        build_perplexity_split)
    from ldagroupedgibbssampler_tpu_torch.evaluation import marginal
    from ldagroupedgibbssampler_tpu_torch.evaluation.foldin import fold_in
    train, est, evl = build_perplexity_split(corpus, 0.1, seed=2019)
    cfg = pcgs_config(LDAConfig, "ggs", K)
    ref = create_model(cfg)
    ref.add_instances(train)
    ref.sample(ITERS)
    lls_ref = ref.get_log_likelihoods()
    del ref
    model = create_model(cfg)
    model.add_instances(train)
    model.add_test_instances(evl)
    l2r = cuda_left_to_right.left_to_right
    l2r.launches = 0
    model.sample(ITERS)
    l2r_launches = l2r.launches
    check(l2r_launches == 2 * (ITERS // 10), f"[4 held-out] the estimator "
          f"kernel launched {l2r_launches} times")
    check(model.get_log_likelihoods() == lls_ref, "held-out evaluation "
          f"changed the chain: {model.get_log_likelihoods()} against "
          f"{lls_ref}")
    held = model.get_held_out_log_likelihoods()
    check([it for it, _ in held] == [10, 20, 30]
          and all(np.isfinite(v) and v < 0 for _, v in held),
          f"held-out LL series {held}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._held_out_log_likelihood()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    model.sample(5)                 # iterations 31-35: no evaluation
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) / 5 * 1e3
    eval_profile = profile_calls(torch, model._held_out_log_likelihood, 1,
                                 "evaluation")
    # the estimator on both devices, given the same noise
    w_pad, mask_pad = evl.to_padded()
    r = 20
    noise = host_gumbel(torch, (r, evl.num_docs, K))
    st = model.state
    nkw_kv, nk = model._nkw_kv(), st.nk
    ll_dev = float(marginal.left_to_right_from_counts(
        w_pad, mask_pad, nkw_kv, nk, st.alpha, st.beta, r, gumbel=noise))
    ll_cpu = float(marginal.left_to_right_from_counts(
        w_pad, mask_pad, nkw_kv.cpu(), nk.cpu(), st.alpha.cpu(), st.beta, r,
        gumbel=noise))
    check(abs(ll_dev - ll_cpu) <= 1e-4 * abs(ll_cpu),
          f"estimator cuda {ll_dev} against cpu {ll_cpu}")
    gen = torch.Generator(device=model.device).manual_seed(5)
    ll_unif = float(marginal.left_to_right_from_word_prob(
        w_pad, mask_pad, torch.full((K, V), 1.0 / V, device=model.device),
        st.alpha, 100, generator=gen))
    ll_count = held[-1][1]
    check(ll_count > ll_unif, f"count phi {ll_count} does not beat uniform "
          f"phi {ll_unif}")
    # fold-in of the first halves on rows 2 and 1
    counts, zdraw = cuda_counts.blocked_label_counts, cuda_zdraw.fused_zdraw_nkw
    counts.launches = zdraw.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fold_in(model._phi_kv(), est, st.alpha, gen, fold_iters,
                  token_block=cfg.token_block, vocab_span=cfg.vocab_span,
                  doc_span=cfg.doc_span)
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t0) / fold_iters * 1e3
    launches = {"fused_zdraw_nkw": zdraw.launches,
                "blocked_label_counts": counts.launches}
    check(launches == {"fused_zdraw_nkw": fold_iters,
                       "blocked_label_counts": fold_iters + 1},
          f"fold-in launches {launches}")
    nkw_ref, ndk_ref = recount(est, res.flat_z(), K)
    check(np.array_equal(res.nkw_vk.cpu().numpy(), nkw_ref)
          and np.array_equal(res.ndk.cpu().numpy(), ndk_ref),
          "fold-in: counts differ from a recount of its z")
    sums = res.theta_mean.sum(dim=1)
    check(bool(((sums - 1.0).abs() < 1e-4).all()),
          "fold-in: theta rows do not sum to 1")
    print(f"[4 held-out] ggs K={K} on {torch.cuda.get_device_name(0)} "
          f"({smi}), 10% split ({train.num_docs} training documents, "
          f"{evl.num_docs} test documents, {evl.num_tokens} scored tokens, "
          f"{w_pad.shape[1]} positions): held-out LL (100 particles) "
          f"{json.dumps(held)} (estimator kernel launches {l2r_launches}); "
          f"training LL series equal to the chain "
          f"without a test set; one evaluation {eval_ms:.3f} ms against "
          f"{iter_ms:.3f} ms a ggs iteration (host clock, synchronised); "
          f"estimator cuda {ll_dev:.3f} = cpu {ll_cpu:.3f} given the same "
          f"noise ({r} particles); count phi {ll_count:.1f} > uniform phi "
          f"{ll_unif:.1f}; fold-in of the first halves ({est.num_tokens} "
          f"tokens), {fold_iters} iterations: launches "
          f"{json.dumps(launches)}, {fold_ms:.3f} ms/iteration, counts "
          f"exact, theta rows sum to 1", flush=True)
    print(f"[4 held-out profile] {eval_profile}", flush=True)
    del model, res
    torch.cuda.empty_cache()
    return launches, l2r_launches


def held_out_large_k(torch, corpus, LDAConfig, create_model, smi,
                     k_big=4096, iters=20):
    """[4 held-out K=4096]: ggs_aliasmh and dense ggs at K=4096 on the
    same 90% training split, `iters` iterations each, the held-out LL at
    10 and 20 (100 particles): the card's reading of PERF.md §7's
    large-K quality question. The estimator's [100, D_test, K] tensors
    (1.85 GB each) are freed before the next phase."""
    from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
        build_perplexity_split)
    train, _est, evl = build_perplexity_split(corpus, 0.1, seed=2019)
    res = {}
    for scheme in ("ggs_aliasmh", "ggs"):
        cfg = LDAConfig(scheme=scheme, topics=k_big, alpha=0.5, beta=0.01,
                        seed=2019, exec_time=-1, topic_interval=10,
                        device="cuda")
        model = create_model(cfg)
        model.add_instances(train)
        model.add_test_instances(evl)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(iters)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        held = model.get_held_out_log_likelihoods()
        check(len(held) == iters // 10
              and all(np.isfinite(v) for _, v in held),
              f"{scheme} K={k_big}: held-out LL {held}")
        check_counts_exact(model, train, f"{scheme} K={k_big} held-out")
        t1 = time.perf_counter()
        model._held_out_log_likelihood()
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        model.sample(5)             # no evaluation in iterations 21-25
        torch.cuda.synchronize()
        res[scheme] = (held, eval_ms, secs,
                       torch.cuda.max_memory_allocated() / 2 ** 30,
                       (time.perf_counter() - t1) / 5 * 1e3)
        del model
        torch.cuda.empty_cache()
    mh, dense = res["ggs_aliasmh"], res["ggs"]
    print(f"[4 held-out K={k_big}] on {torch.cuda.get_device_name(0)} "
          f"({smi}), {iters} iterations each on the 90% split: held-out LL "
          f"ggs_aliasmh {json.dumps(mh[0])}, dense ggs "
          f"{json.dumps(dense[0])}; dense - alias-MH at {iters} "
          f"{dense[0][-1][1] - mh[0][-1][1]:.1f} nats; one evaluation "
          f"{mh[1]:.1f} / {dense[1]:.1f} ms against an iteration's "
          f"{mh[4]:.1f} / {dense[4]:.1f} ms (host clock, synchronised); "
          f"run {mh[2]:.2f} / "
          f"{dense[2]:.2f} s with two evaluations; peak device memory "
          f"{mh[3]:.2f} / {dense[3]:.2f} GiB", flush=True)


BASE_OPTIONS = (
    ("hyperopt", dict(hyperparam_optim_interval=10)),
    ("topic index", dict(topic_index_building_scheme=
                         "mixed_mandelbrot_delta_n")),
    ("topic batch", dict(topic_batch_building_scheme="percentage",
                         percentage_split_size_topic=0.5)),
    ("paranoid", dict(paranoid=True)),
    ("phi means", dict(save_phi_means=True)),
    ("distances", dict(compute_doc_topic_distances=True,
                       start_diagnostic=1)),
    ("timing", dict(measure_timing=True)),
)


def base_options_phase(torch, corpus, LDAConfig, create_model, cuda_counts,
                       cuda_zdraw, cuda_pcgs, smi, iters=10):
    """[4 base options]: ggs K=100 for `iters` iterations with a run
    logger, plain, with each base option alone, and with all of them on
    (the last with its launch counters set to 0 just before and read just
    after), then plain again (the turns of one call); then pcgs K=100 with
    a delta-N topic index builder and paranoid checks. Each: LL finite and
    rising, counts exact, every phi entry positive (positive support).
    Prints ms/iteration (host clock, synchronised, LL at 5 and 10
    included) of each against plain."""
    from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import (
        RunLogger)
    work = os.path.join(ROOT, "build", "chip_smoke_options")
    shutil.rmtree(work, ignore_errors=True)
    all_on = {k: v for _, kw in BASE_OPTIONS for k, v in kw.items()}
    runs = [("plain", {}), *BASE_OPTIONS, ("all", all_on), ("plain", {}),
            ("pcgs delta-N paranoid", dict(
                scheme="pcgs", topic_index_building_scheme="delta_n",
                paranoid=True))]
    ms, launches = {}, None
    for i, (name, kw) in enumerate(runs):
        logger = RunLogger(os.path.join(work, f"run{i}"))
        cfg = pcgs_config(LDAConfig, "ggs", K).replace(topic_interval=5,
                                                        **kw)
        model = create_model(cfg, logger=logger)
        model.add_instances(corpus)
        ll0 = model.model_log_likelihood()
        if name == "all":
            for fn in (cuda_counts.blocked_label_counts,
                       cuda_zdraw.fused_zdraw_nkw):
                fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(iters)
        torch.cuda.synchronize()
        ms.setdefault(name, []).append(
            (time.perf_counter() - t0) / iters * 1e3)
        if name == "all":
            launches = {"fused_zdraw_nkw": cuda_zdraw.fused_zdraw_nkw.launches,
                        "blocked_label_counts":
                            cuda_counts.blocked_label_counts.launches}
            check(launches["fused_zdraw_nkw"] == iters
                  and launches["blocked_label_counts"] >= iters,
                  f"base options: launches {launches}")
            run = logger.run_dir
            rows = open(os.path.join(run, "timings.txt")).read().split("\n")
            check(len([r for r in rows if r]) == iters
                  and os.path.getsize(os.path.join(run, "timing_data",
                                                   "trace.json")) > 0,
                  "base options: timings or trace missing")
            check(len(open(os.path.join(run, "min_doc_distances.csv"))
                      .read().split("\n")) == 3,
                  "base options: min_doc_distances.csv rows")
            check(model.get_phi_means().shape == (K, V),
                  "base options: phi means")
        lls = dict(model.get_log_likelihoods())
        check(np.isfinite(lls[iters]) and lls[iters] > lls[5] > ll0,
              f"base options {name}: LL did not rise: {ll0}, {lls}")
        check_counts_exact(model, corpus, f"base options {name}")
        check(bool((model.state.phi > 0).all()),
              f"base options {name}: a phi entry is 0")
        logger.close()
        del model
        torch.cuda.empty_cache()
    plain = float(np.mean(ms["plain"]))
    parts = "; ".join(
        f"{name} {float(np.mean(v)):.3f} ({float(np.mean(v)) - plain:+.3f})"
        for name, v in ms.items() if name != "plain")
    print(f"[4 base options] ggs K={K} on {torch.cuda.get_device_name(0)} "
          f"({smi}), {iters} iterations each, LL rising, counts exact, phi "
          f"positive in every run; all-on launches {json.dumps(launches)}; "
          f"ms/iteration (host clock, LL at 5 and 10 included) plain "
          f"{ms['plain'][0]:.3f} then {ms['plain'][1]:.3f}; each option, "
          f"its difference to plain's mean: {parts}", flush=True)


def cli_held_out(torch, work, themes, rng, counters, cuda_zdraw):
    """[5 cli held-out]: the experiment CLI on cuda with a test_dataset
    (a held-out text file beside the small corpus) and every base option:
    a ggs section and a pcgs section with a delta-N builder. Checks that
    each artifact exists."""
    from ldagroupedgibbssampler_tpu_torch.tui import parallel_lda
    with open(os.path.join(work, "test.txt"), "w") as f:
        for d in range(60):
            words = [themes[d % 3][i] for i in rng.integers(0, 7, 40)]
            f.write(f"docno:t{d}\tL{d % 3}\t{' '.join(words)}\n")
    with open(os.path.join(work, "heldout.cfg"), "w") as f:
        f.write(f"configs = ggs_options, pcgs_delta\nno_runs = 1\n"
                f"experiment_out_dir = {work}/runs_heldout\n"
                f"exec_time = 300\niterations = {ITERS}\ntopics = 3\n"
                f"alpha = 1\nbeta = 0.01\ndataset = {work}/docs.txt\n"
                f"test_dataset = {work}/test.txt\nrare_threshold = 0\n"
                f"seed = 2019\ntopic_interval = 10\nstart_diagnostic = 1\n"
                f"stoplist =\ndevice = cuda\nparanoid = true\n"
                f"log_type_topic_density = true\n"
                f"log_document_density = true\nlog_phi_density = true\n\n"
                f"[ggs_options]\nscheme = ggs\n"
                f"hyperparam_optim_interval = 10\n"
                f"topic_index_building_scheme = mixed_mandelbrot_delta_n\n"
                f"topic_batch_building_scheme = percentage\n"
                f"percentage_split_size_topic = 0.5\n"
                f"save_phi_means = true\n"
                f"compute_doc_topic_distances = true\n"
                f"measure_timing = true\ndiagnostic_interval = 10, 11\n"
                f"dn_diagnostic_interval = 10, 12\n\n"
                f"[pcgs_delta]\nscheme = pcgs\n"
                f"topic_index_building_scheme = delta_n\n")
    for fn, attr in counters:
        setattr(fn, attr, 0)
    parallel_lda.main([f"--run_cfg={work}/heldout.cfg"])
    check(cuda_zdraw.fused_zdraw_nkw.launches == ITERS,
          f"CLI held-out: z-draw launches {cuda_zdraw.fused_zdraw_nkw.launches}")
    found = {}
    for name, files in (
            ("ggs_options", (
                "test_held_out_log_likelihood.txt", "stats.txt",
                "timings.txt", "timing_data/trace.json",
                "min_doc_distances.csv", "min_topic_distances.csv",
                "phi_means.csv", "topic_diagnostics.csv", "delta_n.txt",
                "phi_3_*_00010.BINARY", "N_3_*_00011.BINARY",
                "M_300_3_00011.BINARY", "z_10.csv")),
            ("pcgs_delta", ("test_held_out_log_likelihood.txt", "stats.txt",
                            "topic_diagnostics.csv"))):
        run_dir = glob.glob(os.path.join(work, "runs_heldout", "RunSuite*",
                                         f"Run{name}-*"))
        check(len(run_dir) == 1, f"CLI held-out run directories: {run_dir}")
        for fn in files:
            check(len(glob.glob(os.path.join(run_dir[0], fn))) == 1,
                  f"CLI held-out {name}: no {fn}")
        held = [float(ln.split("\t")[1]) for ln in open(os.path.join(
            run_dir[0], "test_held_out_log_likelihood.txt"))]
        check(len(held) == 3 and np.isfinite(held).all(),
              f"CLI held-out {name}: {held}")
        found[name] = held
    print(f"[5 cli held-out] parallel_lda on cuda with test_dataset and "
          f"paranoid checks, densities, hyperopt, the mixed Mandelbrot/"
          f"delta-N builder, topic batches of 0.5, phi means, distances, "
          f"timings and dumps (ggs) and a delta-N builder (pcgs): every "
          f"artifact written; held-out LL {json.dumps(found)}", flush=True)


# ---- 6. the apps -------------------------------------------------------
APPS_FOLD_IN = 200          # LDADistancer.distance's default iterations
CLASSIFY_FOLD_IN = 300      # KLDivergenceClassifier's default iterations
APPS_BLOCK = 256            # query rows held against the CPU and timed
APPS_CHECK = 32             # rows of every metric held against the CPU
LOOSE_METRICS = ("hellinger", "euclidean", "statistical", "t", "uber")
PRODUCT_METRICS = ("kl", "hellinger", "euclidean", "cosine", "statistical")


def read_launches(counters) -> dict:
    """Every launch counter of the port's wrappers, by wrapper and mode."""
    return {fn.__name__ + ("" if attr == "launches" else " collapsed"):
            getattr(fn, attr) for fn, attr in counters}


def zero_launches(counters):
    for fn, attr in counters:
        setattr(fn, attr, 0)


def rows_123(launches) -> tuple:
    """Launches of kernel rows 1-3: counts, z-draw, PCGS sweep."""
    return (launches["blocked_label_counts"], launches["fused_zdraw_nkw"],
            launches["fused_pcgs_sweep"])


def gib(nbytes) -> str:
    return f"{nbytes / 2 ** 30:.3f} GiB"


def apps_similarity(torch, corpus, LDAConfig, counters, smi, dev):
    """[6 similarity]: LDADistancer (spalias, K=100) trained on the train
    half of a 2-fold split for ITERS iterations, then distance() of the
    test half with the default 200 fold-in iterations; the launches of
    rows 1-3 checked (fold-in: 201 counts, 200 z-draws; training: 30 PCGS
    sweeps); the kl matrix against the CPU on the first rows, every metric
    against the CPU on a few rows, the products with TF32 on and off, and
    each metric timed on a block of test rows."""
    import ldagroupedgibbssampler_tpu_torch.similarity.lda_distancer as ldd
    from ldagroupedgibbssampler_tpu_torch.corpus.perplexity import (
        cross_validation_folds)
    from ldagroupedgibbssampler_tpu_torch.similarity import (DISTANCES,
                                                             LDADistancer,
                                                             pairwise)
    from ldagroupedgibbssampler_tpu_torch.similarity import distances
    (train_idx, test_idx), _ = cross_validation_folds(corpus.num_docs, 2,
                                                      2019)
    train, test = corpus.subset(train_idx), corpus.subset(test_idx)
    cfg = pcgs_config(LDAConfig, "spalias", K).replace(device=dev)
    zero_launches(counters)
    t0 = time.perf_counter()
    distancer = LDADistancer(cfg)
    distancer.train(train, iterations=ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    real_fold_in, fold = ldd.fold_in, {}

    def timed_fold_in(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_fold_in(*args, **kwargs)
        torch.cuda.synchronize()
        fold["s"] = time.perf_counter() - t
        return out
    ldd.fold_in = timed_fold_in
    try:
        t0 = time.perf_counter()
        dist = distancer.distance(test)
        distance_s = time.perf_counter() - t0
    finally:
        ldd.fold_in = real_fold_in
    launches = read_launches(counters)
    check(rows_123(launches) == (APPS_FOLD_IN + 1, APPS_FOLD_IN, ITERS),
          f"[6 similarity] launches of rows 1-3 (counts, z-draw, PCGS) "
          f"{rows_123(launches)}, expected "
          f"{(APPS_FOLD_IN + 1, APPS_FOLD_IN, ITERS)}")
    shape = (test.num_docs, train.num_docs)
    check(dist.shape == shape and bool(np.isfinite(dist).all())
          and float(dist.min()) > -1e-4,
          f"[6 similarity] kl matrix {dist.shape}, min {dist.min()}")
    theta_test = torch.as_tensor(distancer.sampled_test_topics, device=dev)
    theta_train = torch.as_tensor(distancer.train_thetas,
                                  dtype=torch.float32, device=dev)
    kl_ms = time_ms(torch, lambda: pairwise("kl", theta_test, theta_train,
                                            device=dev), reps=3, calls=3)
    host_test = distancer.sampled_test_topics
    cpu = pairwise("kl", host_test[:APPS_BLOCK], distancer.train_thetas,
                   device="cpu").numpy()
    kl_err = float(np.abs(dist[:APPS_BLOCK] - cpu).max())
    check(np.allclose(dist[:APPS_BLOCK], cpu, rtol=1e-5, atol=1e-5),
          f"[6 similarity] kl on {dev} against cpu: max |diff| {kl_err}")
    block = theta_test[:APPS_BLOCK]
    errs, metric_ms = {}, {}
    for name in sorted(DISTANCES):
        got = pairwise(name, block[:APPS_CHECK], theta_train, device=dev)
        want = pairwise(name, host_test[:APPS_CHECK],
                        distancer.train_thetas, device="cpu")
        errs[name] = float((got.cpu() - want).abs().max())
        tol = 1e-4 if name in LOOSE_METRICS else 1e-5
        check(torch.allclose(got.cpu(), want, rtol=tol, atol=tol),
              f"[6 similarity] {name} on {dev} against cpu: max |diff| "
              f"{errs[name]}")
        if name != "kl":
            metric_ms[name] = time_ms(
                torch, lambda n=name: pairwise(n, block, theta_train,
                                               device=dev), reps=3, calls=2)
    # the products give one result whatever the TF32 flag; a TF32 product
    # of the same rows would not
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for name in PRODUCT_METRICS:
            torch.backends.cuda.matmul.allow_tf32 = True
            on = pairwise(name, block, theta_train, device=dev)
            check(torch.backends.cuda.matmul.allow_tf32,
                  f"[6 similarity] {name} did not restore the TF32 flag")
            torch.backends.cuda.matmul.allow_tf32 = False
            off = pairwise(name, block, theta_train, device=dev)
            check(torch.equal(on, off),
                  f"[6 similarity] {name} depends on the TF32 flag")
        torch.backends.cuda.matmul.allow_tf32 = True
        raw_on = block @ theta_train.T
        torch.backends.cuda.matmul.allow_tf32 = False
        raw_off = block @ theta_train.T
        tf32_gap = float((raw_on - raw_off).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    peak = torch.cuda.max_memory_allocated()
    print(f"[6 similarity] LDADistancer spalias K={K} on "
          f"{torch.cuda.get_device_name(0)} ({smi}): trained on "
          f"{train.num_docs} documents in {train_s:.3f} s ({ITERS} "
          f"iterations), distance() of {test.num_docs} test documents in "
          f"{distance_s:.3f} s: fold-in {APPS_FOLD_IN} iterations "
          f"{fold['s'] * 1e3 / APPS_FOLD_IN:.3f} ms/iteration (host clock, "
          f"synchronised); kl matrix {shape[0]} x {shape[1]} "
          f"{kl_ms:.3f} ms (CUDA events), max |cuda - cpu| {kl_err:.3g} on "
          f"the first {APPS_BLOCK} rows; launches of rows 1-3 (counts, "
          f"z-draw, PCGS) {rows_123(launches)}; every metric against cpu "
          f"on {APPS_CHECK} rows, max |diff| {json.dumps(errs)}; products "
          f"equal with TF32 on and off (a TF32 product of the same rows "
          f"moves by up to {tf32_gap:.3g}); {APPS_BLOCK} x {shape[1]} "
          f"block ms {json.dumps(metric_ms)}; working set "
          f"{gib(distances.WORKING_SET_BYTES)} a tile; peak memory "
          f"{gib(peak)}", flush=True)
    pair_launches, pair_s = apps_pairwise(torch, distancer, test, counters,
                                          smi, dev)
    return train, launches, dict(
        fold_in_ms=fold["s"] * 1e3 / APPS_FOLD_IN, kl_ms=kl_ms,
        metric_ms=metric_ms, peak=peak, pairwise_launches=pair_launches,
        pairwise_s=pair_s)


def apps_pairwise(torch, distancer, test, counters, smi, dev):
    """The seven elementwise metrics' whole test x train matrices through
    `Distance(name).pairwise` (the matrix copied to the host, as the
    distancer takes it), each call one launch of its kernel (uber's beside
    its products); then `set_dist("ks")` and `distance(test)` through the
    whole app (200 fold-in iterations on rows 1-2, then one KS launch).
    The launch counters are set to 0 just before and read just after.
    Returns (launches by part, seconds)."""
    from ldagroupedgibbssampler_tpu_torch.similarity import Distance
    theta_test = torch.as_tensor(distancer.sampled_test_topics, device=dev)
    theta_train = torch.as_tensor(distancer.train_thetas,
                                  dtype=torch.float32, device=dev)
    shape = (theta_test.shape[0], theta_train.shape[0])
    pair = ("pairwise_elementwise", "pairwise_ks")
    zero_launches(counters)
    seconds, parts = {}, {}
    for name in PAIRWISE_METRICS:
        before = read_launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D = Distance(name, device=dev).pairwise(theta_test, theta_train)
        seconds[name] = time.perf_counter() - t0
        after = read_launches(counters)
        added = tuple(after[k] - before[k] for k in pair)
        check(added == ((0, 1) if name == "ks" else (1, 0)),
              f"[6 similarity] {name}: launches of the pairwise kernels "
              f"{added}")
        check(D.shape == shape and bool(np.isfinite(D).all()),
              f"[6 similarity] {name} matrix {D.shape}, not finite")
    parts["whole matrices"] = read_launches(counters)
    zero_launches(counters)
    distancer.set_dist("ks")
    t0 = time.perf_counter()
    D = distancer.distance(test)
    seconds["distance ks"] = time.perf_counter() - t0
    parts["distance ks"] = got = read_launches(counters)
    check(rows_123(got)[:2] == (APPS_FOLD_IN + 1, APPS_FOLD_IN)
          and (got["pairwise_elementwise"], got["pairwise_ks"]) == (0, 1),
          f"[6 similarity] distance() with ks: launches of rows 1-2 "
          f"{rows_123(got)[:2]}, pairwise {got['pairwise_ks']}")
    check(D.shape == shape and bool(((D >= 0) & (D <= 1)).all()),
          f"[6 similarity] distance() with ks: {D.shape}, outside [0, 1]")
    distancer.set_dist("kl")
    launches = {k: {part: got[k] for part, got in parts.items()}
                for k in pair}
    print(f"[6 similarity] the {shape[0]} x {shape[1]} matrix of each "
          f"elementwise metric through Distance(name).pairwise on "
          f"{torch.cuda.get_device_name(0)} ({smi}), s (host clock, the "
          f"matrix's copy to the host included) "
          f"{json.dumps({k: round(v, 4) for k, v in seconds.items()})}; "
          f"launches of the pairwise kernels {json.dumps(launches)} (one a "
          f"call; distance ks: 200 fold-in iterations, then the KS kernel)",
          flush=True)
    return launches, seconds


def apps_bm25(torch, train, smi, dev):
    """[6 bm25]: BM25Searcher on the train half, searched against itself
    (top 2): index and score seconds, peak memory, the self-in-top-2 rate,
    and the first rows' scores against the CPU's."""
    from ldagroupedgibbssampler_tpu_torch.similarity import BM25Searcher
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    searcher = BM25Searcher(train, device=dev)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    searcher.score(train)
    t0 = time.perf_counter()
    scores = searcher.score(train)
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx, _ = searcher.search(train, top_n=2)
    search_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = train.num_docs
    self_top2 = float(((idx[:, 0] == np.arange(n))
                       | (idx[:, 1] == np.arange(n))).mean())
    check(self_top2 > 0.5, f"[6 bm25] self in top 2 on {self_top2:.3f}")
    cpu = BM25Searcher(train, device="cpu").score(
        train.subset(np.arange(APPS_BLOCK)))
    rel = float((np.abs(scores[:APPS_BLOCK] - cpu)
                 / np.maximum(np.abs(cpu), 1e-30)).max())
    check(np.allclose(scores[:APPS_BLOCK], cpu, rtol=1e-5, atol=0),
          f"[6 bm25] scores on {dev} against cpu: max relative diff {rel}")
    del searcher
    torch.cuda.empty_cache()
    print(f"[6 bm25] BM25Searcher on {n} train documents x {train.num_types} "
          f"types on {torch.cuda.get_device_name(0)} ({smi}): index "
          f"{index_s:.3f} s, score {n} x {n} {score_s * 1e3:.3f} ms (host "
          f"clock, the scores' copy to the host included), search top 2 "
          f"{search_s:.3f} s (host argsort); self in top 2 on "
          f"{self_top2:.4f}; first {APPS_BLOCK} rows against cpu, max "
          f"relative diff {rel:.3g}; peak memory {gib(peak)}", flush=True)
    return dict(index_s=index_s, score_ms=score_s * 1e3, peak=peak)


def apps_classify(torch, corpus, Corpus, LDAConfig, counters, smi, dev):
    """[6 classify]: KLDivergenceClassifier.cross_validate, 2 folds, ITERS
    training iterations and 300 fold-in iterations, on the corpus labelled
    d % 20 (no planted classes, so the accuracy has no bar); the launches
    of rows 1-3 equal the folds' iterations."""
    from ldagroupedgibbssampler_tpu_torch.classify import (
        EnhancedConfusionMatrix, KLDivergenceClassifier)
    labelled = Corpus(tokens=corpus.tokens, doc_offsets=corpus.doc_offsets,
                      vocab=corpus.vocab,
                      labels=[str(d % 20) for d in range(corpus.num_docs)])
    cfg = pcgs_config(LDAConfig, "spalias", K).replace(device=dev)
    zero_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trials = KLDivergenceClassifier(cfg).cross_validate(labelled, folds=2,
                                                        iterations=ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(counters)
    want = (2 * (CLASSIFY_FOLD_IN + 1), 2 * CLASSIFY_FOLD_IN, 2 * ITERS)
    check(rows_123(launches) == want,
          f"[6 classify] launches of rows 1-3 {rows_123(launches)}, "
          f"expected {want}")
    combined = EnhancedConfusionMatrix.combined(trials)
    check(combined.total == corpus.num_docs and combined.num_classes == 20,
          f"[6 classify] {combined.total} documents, "
          f"{combined.num_classes} classes")
    peak = torch.cuda.max_memory_allocated()
    print(f"[6 classify] KLDivergenceClassifier spalias K={K}, 20 labels "
          f"(d % 20), 2 folds on {torch.cuda.get_device_name(0)} ({smi}): "
          f"{seconds:.3f} s ({ITERS} training and {CLASSIFY_FOLD_IN} fold-in "
          f"iterations a fold); launches of rows 1-3 {rows_123(launches)}; "
          f"accuracy {combined.average_accuracy:.4f} (no planted classes); "
          f"peak memory {gib(peak)}", flush=True)
    return launches, dict(seconds=seconds, peak=peak)


def app_run_dir(out: str) -> str:
    dirs = glob.glob(os.path.join(out, "RunSuite*", "Runapps-*"))
    check(len(dirs) == 1, f"[6 cli apps] run directories under {out}: "
          f"{dirs}")
    return dirs[0]


def rows_sum_to_one(path: str, atol: float) -> np.ndarray:
    m = np.loadtxt(path, delimiter=",", ndmin=2)
    check(bool(np.allclose(m.sum(axis=1), 1.0, rtol=0, atol=atol)),
          f"[6 cli apps] rows of {path} do not sum to 1")
    return m


def confusion_accuracy(path: str) -> float:
    rows = [ln.split(",") for ln in open(path).read().splitlines()]
    n = len(rows) - 2
    return sum(int(rows[1 + i][1 + i]) for i in range(n)) / int(rows[-1][-1])


def apps_cli(torch, work, counters, smi, dev):
    """[6 cli apps]: the seven secondary drivers' main (kl_classifier also
    with --multi_corpus) on phase 5's three-theme text corpus, each
    artifact checked; the KL classifier's accuracy >= 0.8 and the nearest
    training document of the same theme on >= 80% of the test documents."""
    from ldagroupedgibbssampler_tpu_torch.config import parse_ini
    from ldagroupedgibbssampler_tpu_torch.tui import (bm25_search,
                                                      kl_classifier,
                                                      lda_similarity,
                                                      svmlight_export,
                                                      topic_mass, train_test,
                                                      xvalidation)
    from ldagroupedgibbssampler_tpu_torch.tui.common import (
        load_configured_dataset)
    test_ids = [str(d) for d in range(0, 300, 10)]
    with open(os.path.join(work, "test_ids.txt"), "w") as f:
        f.write("\n".join(test_ids) + "\n")
    cfg_path = os.path.join(work, "apps.cfg")
    with open(cfg_path, "w") as f:
        f.write(f"configs = apps\nno_runs = 1\niterations = {ITERS}\n"
                f"topics = 3\nalpha = 1\nbeta = 0.01\n"
                f"dataset = {work}/docs.txt\nrare_threshold = 0\n"
                f"seed = 2019\nfolds = 2\nstoplist =\ndevice = {dev}\n"
                f"test_ids_filename = {work}/test_ids.txt\n\n"
                f"[apps]\nscheme = ggs\n")
    corpus = load_configured_dataset(parse_ini(cfg_path).activate("apps"))
    found = {}
    for name, module, extra in (
            ("xvalidation", xvalidation, []),
            ("train_test", train_test, []),
            ("kl_classifier", kl_classifier, []),
            ("kl_classifier --multi_corpus", kl_classifier,
             ["--multi_corpus"]),
            ("lda_similarity", lda_similarity, []),
            ("bm25_search", bm25_search, []),
            ("topic_mass", topic_mass, []),
            ("svmlight_export", svmlight_export, [])):
        out = os.path.join(work, "apps", name.replace(" --", "_"))
        zero_launches(counters)
        t0 = time.perf_counter()
        module.main([f"--run_cfg={cfg_path}", f"--experiment_out_dir={out}",
                     *extra])
        torch.cuda.synchronize()
        entry = {"s": round(time.perf_counter() - t0, 3),
                 "launches": rows_123(read_launches(counters))}
        run = app_run_dir(out)
        if name == "xvalidation":
            ids = []
            for fold in ("fold-1", "fold-2"):
                fd = os.path.join(run, fold)
                for fn in ("train-doc_topic_means.csv",
                           "test-doc_topic_means.csv"):
                    rows_sum_to_one(os.path.join(fd, fn), 1e-9)
                rows_sum_to_one(os.path.join(fd, "train-phi_means.csv"), 1e-5)
                ids += open(os.path.join(fd, "test-ids.txt")).read().split()
            check(sorted(ids, key=int) == [str(i) for i in range(300)],
                  "[6 cli apps] xvalidation test ids do not partition the "
                  "corpus")
        elif name == "train_test":
            check(open(os.path.join(run, "test-ids.txt")).read().split()
                  == test_ids, "[6 cli apps] train_test test ids")
            m = rows_sum_to_one(os.path.join(run, "test-doc_topic_means.csv"),
                                1e-9)
            check(m.shape == (30, 3), f"[6 cli apps] test matrix {m.shape}")
            rows_sum_to_one(os.path.join(run, "train-doc_topic_means.csv"),
                            1e-9)
        elif name.startswith("kl_classifier"):
            acc = confusion_accuracy(os.path.join(
                run, "last-confusion-matrix.csv"))
            entry["accuracy"] = acc
            if name == "kl_classifier":
                check(acc >= 0.8, f"[6 cli apps] KL classifier accuracy "
                      f"{acc}")
        elif name == "lda_similarity":
            pairs = [ln.split(",") for ln in open(os.path.join(
                run, "similarities.csv")).read().splitlines()[1:]]
            same = float(np.mean([int(t) % 3 == int(r) % 3
                                  for t, r, _ in pairs]))
            entry["same_theme"] = same
            check(len(pairs) == 150 and same >= 0.8,
                  f"[6 cli apps] {len(pairs)} similarities, nearest of the "
                  f"same theme on {same}")
        elif name == "bm25_search":
            lines = open(os.path.join(run, "bm25_results.csv")).readlines()
            check(len(lines) == 151, f"[6 cli apps] {len(lines)} BM25 lines")
        elif name == "topic_mass":
            lines = open(os.path.join(run, "type_mass_cumsum.csv")
                         ).read().splitlines()
            check(lines[0] == "type_fraction,cumulative_mass"
                  and len(lines) >= 2, f"[6 cli apps] type mass {lines}")
        else:
            docs = [list(corpus.tokens[corpus.doc_offsets[d]:
                                       corpus.doc_offsets[d + 1]])
                    for d in range(corpus.num_docs)]
            check(svmlight_export.read_token_index_corpus(os.path.join(
                run, "apps-corpus.txt")) == docs
                  and svmlight_export.read_svmlight_corpus(os.path.join(
                      run, "apps-corpus.svmlight")) == docs
                  and open(os.path.join(run, "apps-vocabulary.txt")
                           ).read().split() == list(corpus.vocab),
                  "[6 cli apps] the svmlight export does not round-trip")
        found[name] = entry
    print(f"[6 cli apps] the seven drivers' main on {dev} "
          f"({torch.cuda.get_device_name(0)}, {smi}), every artifact "
          f"checked; seconds, launches of rows 1-3 and quality "
          f"{json.dumps(found)}", flush=True)
    return found


def apps_phase(torch, corpus, Corpus, LDAConfig, counters, smi, work,
               dev="cuda"):
    """[6 apps]: similarity, BM25, classification and the seven secondary
    drivers on the card. Returns the launches of rows 1-3 of each part and
    those of the pairwise kernels in `[6 similarity]`'s whole matrices and
    distance() with ks."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # earlier phases' tensors
    t0 = time.perf_counter()
    train, sim_launches, sim = apps_similarity(torch, corpus, LDAConfig,
                                               counters, smi, dev)
    bm = apps_bm25(torch, train, smi, dev)
    cls_launches, cls = apps_classify(torch, corpus, Corpus, LDAConfig,
                                      counters, smi, dev)
    cli = apps_cli(torch, work, counters, smi, dev)
    seconds = time.perf_counter() - t0
    print(f"[6 apps] {seconds:.1f} s on {torch.cuda.get_device_name(0)} "
          f"({smi}); peak memory allocated: similarity {gib(sim['peak'])}, "
          f"bm25 {gib(bm['peak'])}, classify {gib(cls['peak'])}, each "
          f"including the {gib(held)} that earlier phases still held when "
          f"the phase began", flush=True)
    parts = {"similarity": sim_launches, "classify": cls_launches}
    return {name: {part: launches[name] for part, launches in parts.items()}
            | {"cli": sum(e["launches"][i] for e in cli.values())}
            for i, name in enumerate(("blocked_label_counts",
                                      "fused_zdraw_nkw", "fused_pcgs_sweep"))
            } | sim["pairwise_launches"]


# ---- 7. the sharded schemes on torch.distributed -------------------------
PARALLEL_SCHEMES = ("sharded_ggs", "vocab_sharded_ggs", "sharded_adlda",
                    "sharded_pcgs", "sharded_uncollapsed")
PARALLEL_NCCL = ("sharded_ggs", "vocab_sharded_ggs")
PARALLEL_ITERS = 10
PARALLEL_DEADLINE_S = 480   # a rank blocked by a dead peer gives up at 180
ORACLE_DOCS = 2000
# the largest |relative LL gap| at ITERS of the sharded_adlda chain to the
# single-device one-warp chain, by ranks: AD-LDA's staleness, which reads
# -3.4% to -3.7% at 2 ranks and -4.9% to -5.0% at 4 on an H100 (PERF.md §6)
STALENESS_BAR = {2: 0.05, 4: 0.07}
# the kernel launches each scheme's rank makes in an iteration, by counter
# (the Dirichlet kernels: theta one, phi over V two; phi [K, V], 100 rows
# of 20,000, two: its rows are split across blocks)
PARALLEL_LAUNCHES = {
    "sharded_ggs": {"fused_zdraw_nkw": 1, "blocked_label_counts": 1,
                    "dirichlet": 3},
    "vocab_sharded_ggs": {"fused_zdraw_nkw": 1, "blocked_label_counts": 1,
                          "dirichlet": 3},
    "sharded_adlda": {"fused_pcgs_sweep collapsed": 1, "dirichlet": 2},
    "sharded_pcgs": {"fused_pcgs_sweep": 1, "dirichlet": 2},
    "sharded_uncollapsed": {"fused_pcgs_sweep": 1, "dirichlet": 2},
}


def rank_kernels_vs_plain(torch, model, label):
    """The GGS kernels at this rank's shapes against their plain versions:
    the count kernel on the rank's layout B (exact) and the z-draw on its
    layout A with injected uniforms (every token but proven rounding ties,
    and N_kw the histogram of the kernel's z). Returns (z agreement, the
    ties entry)."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_counts, cuda_zdraw
    st, b, cfg = model.state, model._blocks, model.config
    z_b = st.z.view(-1, b.chunk)[model.srcb].view(model.dlb.shape)
    ckw = dict(nwin=b.nwin_d, vspan=b.dspan, num_labels=cfg.topics)
    got = cuda_counts.blocked_label_counts(model.dlb, z_b, model.windb,
                                           model.firstdb, **ckw)
    ref = cuda_counts.blocked_label_counts_reference(
        model.dlb, z_b, model.windb, model.firstdb, **ckw)
    check(torch.equal(got, ref), f"{label}: count kernel differs from its "
          "plain version on the rank's layout B")
    gen = torch.Generator(device=model.device)
    gen.manual_seed(11)
    u24 = torch.randint(0, 2 ** 24, model._shape3, generator=gen,
                        device=model.device, dtype=torch.int32)
    seed = torch.zeros(1, dtype=torch.int64, device=model.device)
    args = (model.wb.view(model._shape3), model.dla.view(model._shape3),
            st.z.view(model._shape3), st.theta,
            model._zdraw_phi(st.phi).contiguous(), seed, model.winb,
            model.firstb, model.windc)
    zkw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=b.vspan,
               dspan=b.dspan, num_topics=cfg.topics)
    zk, nkw = cuda_zdraw.fused_zdraw_nkw(*args, u24,
                                         real_slots=model._real_slots, **zkw)
    zr, _ = cuda_zdraw.fused_zdraw_nkw_reference(*args, u24, **zkw)
    real = model.mf.view(model._shape3)
    agree = float((zk == zr)[real].float().mean())
    check(agree >= 0.999, f"{label}: z-draw agrees with its plain version "
          f"on {agree:.6f} of the rank's tokens")
    ties = zdraw_ties(torch, f"{label} z-draw", zk, zr, args, zkw, u24,
                      False)
    hist = cuda_counts.blocked_label_counts_reference(
        model.wb, zk.view(model.wb.shape), model.winb, model.firstb,
        nwin=b.nwin_w, vspan=b.vspan, num_labels=cfg.topics)
    check(torch.equal(nkw, hist), f"{label}: the z-draw's N_kw is not the "
          "histogram of its z")
    return agree, ties


def rank_sweep_vs_plain(torch, model, scheme, label):
    """The sweep kernel (row 3) at this rank's shapes against its plain
    version: the PCGS-mode checks of [3 pcgs] (pcgs_sweep_checks: z
    agreement >= 0.999 with tie proofs, N_kw, n_dk, flags and kept z
    exact) for sharded_pcgs and sharded_uncollapsed, the collapsed-mode
    checks of [3 adlda sweep] (collapsed_sweep_checks (a)-(c)) for
    sharded_adlda. Returns the agreements."""
    from ldagroupedgibbssampler_tpu_torch.ops import cuda_pcgs
    plain_of = {
        cuda_pcgs.fused_pcgs_sweep: cuda_pcgs.fused_pcgs_sweep_reference,
        cuda_pcgs.fused_pcgs_sweep_streamed:
            cuda_pcgs.fused_pcgs_sweep_streamed_reference}
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(13 + model.mesh.rank)
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64,
                        device=dev)
    if scheme == "sharded_adlda":
        r = collapsed_sweep_checks(torch, model, gen, seed, plain_of, label)
        return {"one-warp": r["agree_c"], "one-warp tie at": r["tie_c"],
                "moved": r["moved_a"]}
    doc_sel = (torch.arange(model.corpus.num_docs, device=dev) % 5) != 0
    agreement, _ = pcgs_sweep_checks(torch, model, gen, seed, plain_of,
                                     label, doc_sel)
    return agreement


def parallel_scheme(torch, corpus, LDAConfig, create_model, counters,
                    scheme, label):
    """One scheme on this rank: PARALLEL_ITERS iterations timed, with the
    launch counters set to 0 just before and read just after, the all-reduce
    time by CUDA events and its bytes; then the exact recount of the
    gathered z, the replicated tensors bit-equal across the ranks (the
    paranoid checks) and the rank's kernels against their plain versions
    at its shapes: rows 2 and 1 for the GGS schemes
    (rank_kernels_vs_plain), row 3 for the others (rank_sweep_vs_plain)."""
    from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (
        collective_counters, collectives)
    t0 = time.perf_counter()
    model = create_model(pcgs_config(LDAConfig, scheme, K))
    model.add_instances(corpus)
    setup_s = time.perf_counter() - t0
    ll0 = model.model_log_likelihood()
    zero_launches(counters + collective_counters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with collectives.timed() as events:
        model.sample(PARALLEL_ITERS)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / PARALLEL_ITERS
    launches = {k: v for k, v in read_launches(counters).items() if v}
    out = dict(
        ll0=ll0, ll10=model.get_log_likelihoods()[-1][1], ms=ms,
        setup_s=setup_s, launches=launches,
        allreduce_ms=sum(a.elapsed_time(b) for a, b in events)
        / PARALLEL_ITERS,
        allreduce_bytes=collectives.bytes / PARALLEL_ITERS,
        allreduce_calls=collectives.calls / PARALLEL_ITERS,
        tokens=int(model._slot_mask.sum()), backend=model.mesh.backend,
        device=f"cuda:{torch.cuda.current_device()}")
    want = {k: n * PARALLEL_ITERS
            for k, n in PARALLEL_LAUNCHES[scheme].items()}
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(out["ll10"] > ll0 if scheme != "sharded_adlda"
          else out["ll10"] >= ll0, f"{label}: LL init {ll0} -> "
          f"it{PARALLEL_ITERS} {out['ll10']}")
    model._paranoid_checks()
    check_counts_exact(model, corpus, label)
    if scheme.endswith("ggs"):
        out["zdraw_agree"], out["zdraw_ties"] = rank_kernels_vs_plain(
            torch, model, label)
    else:
        out["sweep_agree"] = rank_sweep_vs_plain(torch, model, scheme, label)
    if scheme == "vocab_sharded_ggs":
        out["ndk_dtype"] = str(model._ndk_dtype).replace("torch.", "")
    if hasattr(model, "_mode"):
        out["layout"] = model._mode
    del model
    torch.cuda.empty_cache()
    return out


def sharded_adlda_oracle(torch, corpus, Corpus, LDAConfig, create_model,
                         num_docs, serial):
    """sharded_adlda on the first `num_docs` documents for ITERS
    iterations, each rank's sweep the parallel launch or (`serial`) the
    one-warp launch, the rank's sequential chain: its LL series (init and
    every 10) and ms/iteration."""
    sub = first_docs(Corpus, corpus, num_docs)
    model = create_model(pcgs_config(LDAConfig, "sharded_adlda", K))
    model._serial_sweep = serial
    model.add_instances(sub)
    ll0 = model.model_log_likelihood()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.sample(ITERS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / ITERS
    check_counts_exact(model, sub, "sharded_adlda oracle")
    lls = [ll0] + [ll for _, ll in model.get_log_likelihoods()]
    del model
    return dict(lls=lls, ms=ms)


def parallel_rank(rank, world, port, out_dir, tag, schemes, oracle_docs):
    """One rank of `[7 parallel]`, in a spawned process of its own: it
    loads the kernels the parent built, joins a group of `world` ranks on
    the card (more than one rank shares it over gloo; one rank takes
    choose_backend's NCCL), runs `schemes` and, with `oracle_docs`, the
    sharded_adlda oracle chain, and writes its results (or its traceback)
    to out_dir/<tag>_<rank>.json. Any failure exits non-zero."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    result = {"rank": rank, "world": world}
    path = os.path.join(out_dir, f"{tag}_{rank}.json")
    try:
        from ldagroupedgibbssampler_tpu_torch.config.lda_config import (
            LDAConfig)
        from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
        from ldagroupedgibbssampler_tpu_torch.models.fusion import (
            launch_counters)
        from ldagroupedgibbssampler_tpu_torch.models.registry import (
            create_model)
        from ldagroupedgibbssampler_tpu_torch.ops import _build
        from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (
            choose_backend, distributed_initialize)
        _, result["build_s"] = _build.build()
        check(result["build_s"] == 0.0, "a rank rebuilt the kernels")
        _build.library()
        addr = f"127.0.0.1:{port}"
        if world > 1:
            distributed_initialize(addr, num_processes=world, process_id=rank,
                                   device="cuda", timeout_s=180)
        else:       # distributed_initialize leaves one process alone
            torch.cuda.set_device(0)
            dist.init_process_group(
                backend=choose_backend("cuda", 1), init_method=f"tcp://{addr}",
                world_size=1, rank=0,
                timeout=datetime.timedelta(seconds=180))
        # the backend's own int16 all-reduce, which psum_counts works around
        try:
            dist.all_reduce(torch.ones(2, dtype=torch.int16, device="cuda"))
            result["int16_all_reduce"] = "accepted"
        except (RuntimeError, TypeError) as e:
            result["int16_all_reduce"] = f"refused ({type(e).__name__})"
        corpus = synth_corpus(Corpus)
        counters = launch_counters()
        for scheme in schemes:
            result[scheme] = parallel_scheme(
                torch, corpus, LDAConfig, create_model, counters, scheme,
                f"{scheme} ({world} {dist.get_backend()} ranks, rank {rank})")
        for serial in (False, True) if oracle_docs else ():
            result[f"oracle serial={serial}"] = sharded_adlda_oracle(
                torch, corpus, Corpus, LDAConfig, create_model, oracle_docs,
                serial)
        dist.destroy_process_group()
    except BaseException:
        result["error"] = traceback.format_exc()
        with open(path, "w") as f:
            json.dump(result, f)
        raise
    with open(path, "w") as f:
        json.dump(result, f)


def spawn_ranks(world, out_dir, tag, schemes, oracle_docs=0) -> list:
    """Run `parallel_rank` in `world` spawned processes; join each with a
    deadline and check every exit code. Returns the ranks' results."""
    import multiprocessing as mp
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=parallel_rank, args=(
        r, world, port, out_dir, tag, schemes, oracle_docs))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + PARALLEL_DEADLINE_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"{tag}_{r}.json")
        res = json.load(open(path)) if os.path.exists(path) else {}
        check(p.exitcode == 0 and "error" not in res,
              f"[7 parallel] {tag} rank {r} of {world} exited {p.exitcode}: "
              f"{res.get('error', 'no result (killed at the deadline?)')}")
        results.append(res)
    return results


def parallel_phase(torch, smi, serial_lls):
    """[7 parallel]: the five sharded schemes on torch.distributed, each rank
    a spawned process on the card: all five at 2 gloo ranks on cuda:0, then
    sharded_ggs and vocab_sharded_ggs at 1 NCCL rank, PARALLEL_ITERS
    iterations each on the whole corpus at K=100; then the sharded_adlda
    chain at 2 and at 4 gloo ranks on the first ORACLE_DOCS documents with
    the parallel launch, whose LL at ITERS must lie within 0.5% of the
    same ranks' chain with each rank's sweep the one-warp launch (the
    sequential chain of each rank: AD-LDA, exactly), from one seed; and
    within STALENESS_BAR of the single-device one-warp chain
    (`serial_lls`, from [4 adlda oracle], seed 2019): the ranks'
    staleness, which a replica older than one sweep would widen. Returns
    the launches of each kernel counter in the phase, by run."""
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "parallel")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    runs = {"2 gloo ranks": spawn_ranks(2, out_dir, "gloo", PARALLEL_SCHEMES,
                                        ORACLE_DOCS),
            "1 nccl rank": spawn_ranks(1, out_dir, "nccl", PARALLEL_NCCL)}
    oracle = {2: runs["2 gloo ranks"][0],
              4: spawn_ranks(4, out_dir, "gloo4", (), ORACLE_DOCS)[0]}
    seconds = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    launches = {}
    for run, ranks in runs.items():
        backend = ranks[0][PARALLEL_NCCL[0]]["backend"]
        check(backend == run.split()[1], f"{run}: backend {backend}")
        for scheme in PARALLEL_SCHEMES:
            if scheme not in ranks[0]:
                continue
            rs = [r[scheme] for r in ranks]
            for r in rs:
                for k, v in r["launches"].items():
                    launches.setdefault(k, {}).setdefault(run, 0)
                    launches[k][run] += v
            extra = ""
            if "zdraw_agree" in rs[0]:
                extra += ("; kernels vs plain at the ranks' shapes: counts "
                          "exact, z-draw agreement "
                          f"{[r['zdraw_agree'] for r in rs]} (ties "
                          f"{[r['zdraw_ties'] for r in rs]})")
            if "sweep_agree" in rs[0]:
                extra += ("; row 3 vs plain at the ranks' shapes (z "
                          "agreement, ties): "
                          f"{json.dumps([r['sweep_agree'] for r in rs])}")
            if "ndk_dtype" in rs[0]:
                extra += f"; n_dk all-reduce in {rs[0]['ndk_dtype']}"
            if "layout" in rs[0]:
                extra += f"; {rs[0]['layout']} layout"
            print(f"[7 parallel] {scheme}, {run} on {rs[0]['device']} of "
                  f"{name} ({smi}), K={K}, {PARALLEL_ITERS} iterations: LL "
                  f"init {rs[0]['ll0']:.1f} -> it{PARALLEL_ITERS} "
                  f"{rs[0]['ll10']:.1f}; counts exact against the gathered "
                  f"z; replicated tensors bit-equal; tokens per rank "
                  f"{[r['tokens'] for r in rs]}; launches per rank "
                  f"{json.dumps([r['launches'] for r in rs])}; ms/iteration "
                  f"(host clock, LL at {PARALLEL_ITERS} included) "
                  f"{[round(r['ms'], 3) for r in rs]}; all-reduce "
                  f"ms/iteration (CUDA events) "
                  f"{[round(r['allreduce_ms'], 3) for r in rs]}, "
                  f"{rs[0]['allreduce_calls']:.1f} calls and "
                  f"{rs[0]['allreduce_bytes'] / 2 ** 20:.3f} MiB an "
                  f"iteration a rank; set-up s "
                  f"{[round(r['setup_s'], 2) for r in rs]}{extra}",
                  flush=True)
    def traj(lls):
        return json.dumps([round(x, 1) for x in lls])
    for world, res in oracle.items():
        par, ser = res["oracle serial=False"], res["oracle serial=True"]
        gap = (par["lls"][-1] - ser["lls"][-1]) / abs(ser["lls"][-1])
        one = (par["lls"][-1] - serial_lls[-1]) / abs(serial_lls[-1])
        check(abs(gap) < 0.005, f"[7 sharded_adlda oracle] {world} ranks: "
              f"LL gap {gap:.5f} at iteration {ITERS} (parallel launch "
              f"{par['lls']}, one-warp launch {ser['lls']})")
        check(abs(one) < STALENESS_BAR[world], f"[7 sharded_adlda oracle] "
              f"{world} ranks: LL gap {one:.5f} at iteration {ITERS} to the "
              f"single-device one-warp chain {serial_lls} (bar "
              f"{STALENESS_BAR[world]})")
        print(f"[7 sharded_adlda oracle] first {ORACLE_DOCS} documents, "
              f"K={K}, seed 2019, {world} gloo ranks: LL init/10/20/30 with "
              f"each rank's parallel launch {traj(par['lls'])} "
              f"({par['ms']:.1f} ms/iteration), with its one-warp launch "
              f"{traj(ser['lls'])} ({ser['ms']:.1f} ms/iteration); relative "
              f"gap at {ITERS} {gap:+.6f} (bar 0.005); the single-device "
              f"one-warp chain {traj(serial_lls)}, the {world}-rank chain's "
              f"gap to it {one:+.6f} (the ranks' staleness, bar "
              f"{STALENESS_BAR[world]})", flush=True)
    int16 = {run: rs[0]["int16_all_reduce"] for run, rs in runs.items()}
    print(f"[7 parallel] {seconds:.1f} s; ranks spawned with the "
          f"kernels already built (build_s "
          f"{[r['build_s'] for rs in runs.values() for r in rs]}); an int16 "
          f"all-reduce: {json.dumps(int16)}; launches by counter and run "
          f"{json.dumps(launches)}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 8. ingestion and the sweeps at the NYTimes shape
# ---------------------------------------------------------------------------
# the NYTimes shape of benchmarks/text_scale_rehearsal.py: D, V, the mean
# document length (Poisson, at least 5 tokens), Zipf 1.1 over V
INGEST_DOCS, INGEST_VOCAB, INGEST_MEAN_LEN = 300_000, 102_660, 333
INGEST_ITERS = 5
INGEST_PREFIX = 2_000_000     # tokens held native against Python / NumPy
INGEST_BLOCKS = 8             # rows 1, 2, 4 meet their plain versions here
INGEST_SEED = 0x1234_5678_9ABC_DEF


def ingest_vocab(v: int, seed: int = 0) -> list:
    """`v` distinct lowercase pseudo-words of 3-12 letters (bytes), in
    draw order."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words, seen = [], set()
    while len(words) < v:
        m = 2 * (v - len(words))
        lens = rng.integers(3, 13, m).tolist()
        raw = letters[rng.integers(0, 26, (m, 12))].tobytes()
        for i, n in enumerate(lens):
            w = raw[12 * i: 12 * i + n]
            if w not in seen:
                seen.add(w)
                words.append(w)
                if len(words) == v:
                    break
    return words


def synth_ingest_file(path: str, docs: int, v: int, mean_len: int,
                      seed: int = 1, docs_a_chunk: int = 10_000):
    """A UCI text file at the NYTimes shape, one `docno:<d>\\tX\\t<text>`
    line a document, built in vectorised chunks (each token's bytes
    gathered from one blob of the words, each followed by a space).
    Returns (tokens written, seconds)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    words = ingest_vocab(v)
    wlen = np.array([len(w) for w in words], np.int64) + 1
    blob = np.frombuffer(b" ".join(words) + b" ", np.uint8)
    wstart = np.concatenate([[0], np.cumsum(wlen)[:-1]])
    cdf = np.cumsum(1.0 / np.arange(1, v + 1, dtype=np.float64) ** 1.1)
    lengths = np.maximum(5, rng.poisson(mean_len, docs)).astype(np.int64)
    with open(path, "wb") as f:
        for s in range(0, docs, docs_a_chunk):
            e = min(docs, s + docs_a_chunk)
            n = int(lengths[s:e].sum())
            ids = np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1],
                                             side="right"), v - 1)
            tl = wlen[ids]
            ends = np.cumsum(tl)
            src = (np.arange(int(ends[-1]), dtype=np.int64)
                   + np.repeat(wstart[ids] - (ends - tl), tl))
            text = blob[src]
            doc_end = ends[np.cumsum(lengths[s:e]) - 1]
            text[doc_end - 1] = ord("\n")   # a line's last space ends it
            buf = text.tobytes()
            parts, prev = [], 0
            for d, end in zip(range(s, e), doc_end.tolist()):
                parts.append(b"docno:%d\tX\t" % d)
                parts.append(buf[prev:end])
                prev = end
            f.write(b"".join(parts))
    return int(lengths.sum()), time.perf_counter() - t0


class timed_functions:
    """While active, each function `getattr(module, name)` of `targets`
    adds its seconds to `spent[name]` (the callers look it up there at
    call time)."""

    def __init__(self, spent: dict, *targets):
        self.spent, self.targets = spent, targets

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
        for m, n, fn in self.saved:
            setattr(m, n, self._wrap(fn, n))
        return self.spent

    def _wrap(self, fn, name):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spent[name] = (self.spent.get(name, 0.0)
                                    + time.perf_counter() - t0)
        return timed

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def host_peak_gib() -> float:
    """The process's peak resident host memory so far, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def ingest_run(torch, model, corpus):
    """add_instances, one warm-up iteration, then INGEST_ITERS timed, and
    2 under the profiler. Returns the numbers of the line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.add_instances(corpus)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model.sample(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.sample(INGEST_ITERS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / INGEST_ITERS
    return {"setup_s": setup_s, "ms_per_iteration": ms}


def ingest_ggs_kernels(torch, model, cuda_counts, cuda_zdraw):
    """Rows 2 and 1 at this shape: on the first INGEST_BLOCKS blocks
    against their plain versions (the z-draw with injected and Philox
    uniforms, every differing token a proven rounding tie, its N_kw the
    histogram of its z; the count kernel exact on layouts A and B), then
    timed on the whole layout (CUDA events) beside their bounds, the
    count kernel's plain version and torch.bincount on layout B."""
    st, b, cfg = model.state, model._blocks, model.config
    dev, k = model.device, cfg.topics
    nb, chunks, chunk = model._shape3
    block = chunks * chunk
    nbc = INGEST_BLOCKS
    seed = torch.tensor([INGEST_SEED], dtype=torch.int64, device=dev)
    phi = model._zdraw_phi(st.phi).contiguous()
    shape3 = model._shape3
    full = (model.wb.view(shape3), model.dla.view(shape3), st.z.view(shape3),
            st.theta, phi, seed, model.winb, model.firstb, model.windc)
    sub = (*(a[:nbc] for a in full[:3]), st.theta, phi, seed,
           model.winb[:nbc], model.firstb[:nbc],
           model.windc[:nbc * chunks])
    sub_slots = model._real_slots[model._real_slots < nbc * block]
    zkw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=b.vspan,
               dspan=b.dspan, num_topics=k, precise=cfg.zdraw_precise)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    u24 = torch.randint(0, 2 ** 24, tuple(sub[0].shape), generator=gen,
                        device=dev, dtype=torch.int32)
    real = sub[0] < b.vspan
    agree = {}
    zt = {key: v for key, v in zkw.items() if key != "precise"}
    for name, u in (("u24", u24), ("philox", None)):
        zk, nkw = cuda_zdraw.fused_zdraw_nkw(*sub, u, real_slots=sub_slots,
                                             **zkw)
        zr, _ = cuda_zdraw.fused_zdraw_nkw_reference(*sub, u, **zkw)
        agree[name] = float((zk == zr)[real].float().mean())
        check(agree[name] >= 0.999, f"[8 ingest] z-draw ({name}): only "
              f"{agree[name]:.6f} of the first {nbc} blocks' tokens agree "
              "with the plain version")
        agree[f"{name} ties"] = zdraw_ties(
            torch, f"[8 ingest] z-draw ({name})", zk, zr, sub, zt, u,
            cfg.zdraw_precise)
        hist = cuda_counts.blocked_label_counts_reference(
            sub[0].reshape(nbc, block), zk.reshape(nbc, block), sub[6],
            nwin=b.nwin_w, vspan=b.vspan, num_labels=k)
        check(torch.equal(nkw, hist), f"[8 ingest] z-draw ({name}): N_kw "
              "is not the histogram of its z")
        del zk, zr, nkw, hist
    z_b = st.z.view(-1, chunk)[model.srcb].view(model.dlb.shape)
    ckw_b = dict(nwin=b.nwin_d, vspan=b.dspan, num_labels=k)
    ckw_a = dict(nwin=b.nwin_w, vspan=b.vspan, num_labels=k)
    for lay, args, ckw in (
            ("B", (model.dlb[:nbc], z_b[:nbc].contiguous(),
                   model.windb[:nbc], model.firstdb[:nbc]), ckw_b),
            ("A", (model.wb[:nbc], st.z.view(model.wb.shape)[:nbc],
                   model.winb[:nbc], model.firstb[:nbc]), ckw_a)):
        check(torch.equal(cuda_counts.blocked_label_counts(*args, **ckw),
                          cuda_counts.blocked_label_counts_reference(
                              *args, **ckw)),
              f"[8 ingest] count kernel on layout {lay}'s first {nbc} "
              "blocks differs from its plain version")
    n_tok = model.corpus.num_tokens
    d_, v_ = model.corpus.num_docs, model.corpus.num_types
    zfull = dict(zkw, real_slots=model._real_slots)
    zdraw_ms = time_ms(torch, lambda: cuda_zdraw.fused_zdraw_nkw(
        *full, **zfull), reps=5, calls=3)
    zdraw_plain_ms = time_ms(torch, lambda: cuda_zdraw.
                             fused_zdraw_nkw_reference(*sub, **zkw),
                             reps=3, calls=1)
    slots = st.z.numel()
    zbytes = (4 * 4 * slots + 4 * (d_ + v_) * k + 8 + 4 * 2 * nb
              + 4 * nb * chunks + 4 * b.nwin_w * b.vspan * k)
    zb_ms, zb_by = bound(zbytes, 3.0 * n_tok * k)
    cargs = (model.dlb, z_b.contiguous(), model.windb, model.firstdb)
    counts_ms = time_ms(torch, lambda: cuda_counts.blocked_label_counts(
        *cargs, **ckw_b), reps=5, calls=3)
    sub_b = (model.dlb[:nbc], z_b[:nbc].contiguous(), model.windb[:nbc],
             model.firstdb[:nbc])
    counts_plain_ms = time_ms(torch, lambda: cuda_counts.
                              blocked_label_counts_reference(*sub_b, **ckw_b),
                              reps=3, calls=1)
    valid = model.dlb < b.dspan
    nrows = b.nwin_d * b.dspan
    key = ((model.windb.to(torch.int64)[:, None] * b.dspan
            + model.dlb)[valid] * k + cargs[1][valid])
    counts_lib_ms = time_ms(torch, lambda: torch.bincount(
        key, minlength=nrows * k), reps=5, calls=3)
    cbytes = 4 * (model.dlb.numel() + int(valid.sum()) + model.windb.numel()
                  + nrows * k)
    cb_ms, cb_by = bound(cbytes, 0)
    inst = cuda_counts.count_instance(b.dspan, k, block)
    del key, cargs, z_b, valid
    torch.cuda.empty_cache()
    return {
        "zdraw": {"ms": zdraw_ms, "plain_ms_first_blocks": zdraw_plain_ms,
                  "bound_ms": zb_ms, "bound_by": zb_by, "agreement": agree},
        "counts": {"ms": counts_ms,
                   "plain_ms_first_blocks": counts_plain_ms,
                   "library_ms": counts_lib_ms, "bound_ms": cb_ms,
                   "bound_by": cb_by, "instance": inst.kind,
                   "shared_bytes": inst.shared_bytes,
                   "layout": f"B, doc span {b.dspan}"}}


def ingest_pcgs_kernel(torch, model, cuda_pcgs):
    """Row 4 at this shape: the streamed PCGS sweep over the first
    d-window's documents, each cut to its slots in the first INGEST_BLOCKS
    blocks, against its plain version with injected and Philox uniforms
    (z agreement >= 0.999, each differing document's first token a proven
    rounding tie; N_kw the histogram of the kernel's z over those slots;
    the table's n_dk moved by exactly its moves), then timed on the whole
    layout with Philox uniforms beside its bound."""
    from types import SimpleNamespace

    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import longest_first
    from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24
    st, dev, b = model.state, model.device, model._sblocks
    k = model.config.topics
    block = b.w_local.shape[1]
    docs = b.dspan                                  # the first d-window
    off = model.doc_slot_offsets.to(torch.int64)
    slots = model.doc_slots[: int(off[docs])]
    doc = torch.repeat_interleave(torch.arange(docs, device=dev),
                                  off[1:docs + 1] - off[:docs])
    keep = slots < INGEST_BLOCKS * block
    sub_off = torch.zeros(docs + 1, dtype=torch.int32, device=dev)
    sub_off[1:] = torch.cumsum(torch.bincount(doc[keep], minlength=docs), 0)
    sub_slots = slots[keep].contiguous()
    order = torch.as_tensor(longest_first(sub_off.cpu().numpy()),
                            device=dev)
    visited = torch.zeros(st.z.numel(), dtype=torch.bool, device=dev)
    visited[sub_slots.long()] = True
    visited = visited.view(st.z.shape)
    # the tie proof walks the cut documents' slot lists
    view = SimpleNamespace(_slot_mask=visited, _slot_d=model._slot_d,
                           _slot_w=model._slot_w, config=model.config,
                           doc_slot_offsets=sub_off, doc_slots=sub_slots)
    doc_sel = (torch.arange(model.corpus.num_docs, device=dev) % 5) != 0
    table = model._ndk_table(st.ndk, st.alpha, doc_sel)
    phi_vk = st.phi.T.contiguous()
    seed = torch.tensor([INGEST_SEED], dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    u24 = torch.randint(0, 2 ** 24, tuple(st.z.shape), generator=gen,
                        device=dev, dtype=torch.int32)
    agree = {}
    w_v, d_v = model._slot_w[visited], model._slot_d[visited]
    for name, u in (("u24", u24), ("philox", None)):
        fn, args, kw = model._sweep_call(st.z, table, phi_vk, seed, u)
        check(fn is cuda_pcgs.fused_pcgs_sweep_streamed,
              f"[8 ingest] pcgs runs {fn.__name__}")
        args = (*args[:8], sub_off, sub_slots, u)
        kw = {**kw, "doc_order": order}
        zk, nkw_k, tb_k = fn(*args, **kw)
        zr, _, _ = cuda_pcgs.fused_pcgs_sweep_streamed_reference(
            *args, **without_order(kw))
        agree[name] = float((zk == zr)[visited].float().mean())
        check(agree[name] >= 0.999, f"[8 ingest] streamed PCGS ({name}): "
              f"only {agree[name]:.6f} of the cut documents' tokens agree "
              "with the plain version")
        words = u if u is not None else philox_u24(seed, st.z.numel())
        agree[f"{name} ties"] = ties_at_first_disagreement(
            torch, view, f"[8 ingest] streamed PCGS ({name})", st.z, zk, zr,
            table, phi_vk, words)
        del words
        hist = torch.zeros_like(nkw_k)
        hist.index_put_((w_v, zk[visited].long()),
                        torch.ones_like(w_v, dtype=torch.int32),
                        accumulate=True)
        check(torch.equal(nkw_k, hist), f"[8 ingest] streamed PCGS ({name}):"
              " N_kw is not the histogram of its z over the cut documents")
        moves = torch.zeros((k, table.shape[1]), dtype=torch.float32,
                            device=dev)
        for z, sign in ((zk, 1.0), (st.z, -1.0)):
            moves.index_put_((z[visited].long(), d_v), torch.full_like(
                d_v, sign, dtype=torch.float32), accumulate=True)
        check(torch.equal(tb_k[:k], table[:k] + moves),
              f"[8 ingest] streamed PCGS ({name}): the table's n_dk is not "
              "moved by exactly the kernel's moves")
        del zk, zr, nkw_k, tb_k, hist, moves
    fn, args, kw = model._sweep_call(st.z, table, phi_vk, seed)
    ms = time_ms(torch, lambda: fn(*args, **kw), reps=5, calls=3)
    sub_args = (*args[:8], sub_off, sub_slots, None)
    plain_ms = time_ms(torch, lambda: cuda_pcgs.
                       fused_pcgs_sweep_streamed_reference(
                           *sub_args, **without_order(kw)), reps=3, calls=1)
    slots_n, n = st.z.numel(), model.corpus.num_tokens
    d_, v_ = model.corpus.num_docs, model.corpus.num_types
    nbytes = (4 * 3 * slots_n + 4 * model.doc_slots.numel() + 4 * (d_ + 1)
              + 4 * n + 4 * v_ * k + 8 + 2 * 4 * table.numel()
              + 4 * b.nwin_w * model._vspan * k)
    b_ms, b_by = bound(nbytes, 3.0 * n * k)
    cut = int(sub_slots.numel())
    del table, phi_vk, u24, visited, view
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms_first_blocks": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "agreement": agree, "checked_tokens": cut}


def ingest_prefix(corpus, path, cell_kw, stream_kw):
    """Native against Python / NumPy on the documents of the first
    INGEST_PREFIX tokens: the tokenizer (the prefix's corpus also equal to
    the whole corpus's first documents), the cell blocks and the stream
    blocks, every field bit-equal. Returns seconds by step and path."""
    import dataclasses
    import itertools

    from ldagroupedgibbssampler_tpu_torch.corpus import native_blocks, ragged
    from ldagroupedgibbssampler_tpu_torch.corpus.pipeline import build_corpus
    from ldagroupedgibbssampler_tpu_torch.corpus.uci import iter_uci_lines
    m = int(np.searchsorted(corpus.doc_offsets, INGEST_PREFIX))
    raw = list(itertools.islice(iter_uci_lines(path), m))
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out
    nat = timed("tokenize native", lambda: build_corpus(raw))
    py = timed("tokenize python", lambda: build_corpus(raw, native=False))
    end = int(corpus.doc_offsets[m])
    for label, c in (("python", py), ("the whole corpus", corpus)):
        tok = c.tokens[:end] if c is corpus else c.tokens
        check(nat.vocab == c.vocab[: len(nat.vocab)]
              and np.array_equal(nat.tokens, tok)
              and np.array_equal(nat.doc_offsets, c.doc_offsets[: m + 1]),
              f"[8 ingest] the native tokenizer's prefix differs from "
              f"{label}'s")
    check(nat.vocab == py.vocab and nat.labels == py.labels
          and nat.doc_ids == py.doc_ids, "[8 ingest] prefix metadata differ")
    args = (nat.tokens, nat.token_doc_ids(), nat.num_types, nat.num_docs)
    a = timed("cell blocks native", lambda: native_blocks.
              build_cell_blocks_native(*args, **cell_kw))
    saved = ragged.NATIVE_THRESHOLD
    ragged.NATIVE_THRESHOLD = nat.num_tokens + 1     # the NumPy path
    try:
        b = timed("cell blocks numpy", lambda: ragged.build_cell_blocks(
            *args, **cell_kw))
    finally:
        ragged.NATIVE_THRESHOLD = saved
    c = timed("stream blocks native", lambda: native_blocks.
              build_stream_blocks_native(*args, **stream_kw))
    d = timed("stream blocks numpy", lambda: ragged.build_stream_blocks_seq(
        *args, **stream_kw))
    for x, y, what in ((a, b, "cell"), (c, d, "stream")):
        for f in dataclasses.fields(y):
            p, q = getattr(x, f.name), getattr(y, f.name)
            same = (p.dtype == q.dtype and np.array_equal(p, q)
                    if isinstance(q, np.ndarray) else p == q)
            check(same, f"[8 ingest] native {what} blocks differ from "
                  f"NumPy's in {f.name} on the prefix")
    return nat.num_tokens, m, secs


def ingest_phase(torch, smi, LDAConfig, create_model, cuda_counts,
                 cuda_zdraw, cuda_pcgs):
    """[8 ingest]: the NYTimes-shape corpus through the port's entry points:
    a UCI text file synthesised, `load_dataset` (the native tokenizer),
    `create_model(cfg).add_instances(corpus).sample(n)` for ggs K=100 with
    doc_span 1024 (the native cell blocks; rows 2 and 1) and pcgs K=100
    (the streamed layout: the native stream blocks and row 4), each with
    its launch counters set to 0 just before and read just after; the
    native call counters; exact recounts on the whole corpus; rows 1, 2, 4
    against their plain versions on the first blocks and timed at this
    shape; native against Python / NumPy on a 2M-token prefix. Returns
    (launches by scheme and counter, the kernels' numbers at this
    shape)."""
    from ldagroupedgibbssampler_tpu_torch.corpus import (
        _native_build, native_blocks, native_loader, pipeline)
    from ldagroupedgibbssampler_tpu_torch.models import fused_sweep
    from ldagroupedgibbssampler_tpu_torch.models.fusion import (
        launch_counters)
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_ingest")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "nytimes_shape.txt")
    raw_n, synth_s = synth_ingest_file(path, INGEST_DOCS, INGEST_VOCAB,
                                       INGEST_MEAN_LEN)
    size = os.path.getsize(path)
    _native_build.calls.clear()
    spent = {}
    timers = timed_functions(
        spent, (pipeline, "read_uci_file"),
        (native_loader, "tokenize_corpus_native"),
        (native_blocks, "build_cell_blocks_native"),
        (native_blocks, "build_stream_blocks_native"),
        (fused_sweep, "doc_visit_order"))
    counters = launch_counters()
    launches, runs, kernels = {}, {}, {}
    with timers:
        t0 = time.perf_counter()
        corpus = pipeline.load_dataset(path, stoplist_path=None,
                                       rare_threshold=0)
        load_s = time.perf_counter() - t0
        check(corpus.num_docs == INGEST_DOCS
              and corpus.num_types == INGEST_VOCAB
              and corpus.num_tokens == raw_n,
              f"[8 ingest] loaded D={corpus.num_docs} V={corpus.num_types} "
              f"N={corpus.num_tokens}, wrote {INGEST_DOCS} documents of "
              f"{raw_n} tokens over {INGEST_VOCAB} words")
        host_load = host_peak_gib()
        for scheme, extra in (("ggs", dict(doc_span=1024)), ("pcgs", {})):
            cfg = LDAConfig(scheme=scheme, topics=K, alpha=0.5, beta=0.01,
                            seed=2019, exec_time=-1, topic_interval=0,
                            device="cuda", **extra)
            model = create_model(cfg)
            for fn, attr in counters:
                setattr(fn, attr, 0)
            r = ingest_run(torch, model, corpus)
            launches[scheme] = {f"{fn.__name__}.{attr}": getattr(fn, attr)
                                for fn, attr in counters if getattr(fn, attr)}
            wall, busy, _ = profile_numbers(torch, lambda: model.sample(2), 2)
            r.update(busy_share=busy / wall, profiled_ms=wall,
                     slots=int(model.state.z.numel()),
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                     host_peak_gib=host_peak_gib())
            check_counts_exact(model, corpus, f"[8 ingest] {scheme}")
            ll = model.model_log_likelihood()
            check(np.isfinite(ll), f"[8 ingest] {scheme}: LL {ll}")
            r["ll"] = ll
            if scheme == "ggs":
                r["layout"] = (f"cell blocks, token_block {cfg.token_block}, "
                               f"vocab span {cfg.vocab_span}, doc span "
                               f"{cfg.doc_span}")
                cell_kw = dict(block=cfg.token_block, vspan=cfg.vocab_span,
                               dspan=cfg.doc_span, chunk=model._blocks.chunk)
                kernels.update(ingest_ggs_kernels(torch, model, cuda_counts,
                                                  cuda_zdraw))
            else:
                b = model._sblocks
                check(model._mode == "streamed",
                      f"[8 ingest] pcgs took the {model._mode} layout")
                r["layout"] = (f"stream blocks, block {b.w_local.shape[1]}, "
                               f"vocab span {model._vspan}, doc span "
                               f"{b.dspan}")
                stream_kw = dict(block=b.w_local.shape[1], vspan=b.vspan,
                                 dspan=b.dspan, chunk=b.chunk)
                kernels["pcgs_streamed"] = ingest_pcgs_kernel(torch, model,
                                                              cuda_pcgs)
            runs[scheme] = r
            del model
            torch.cuda.empty_cache()
    calls = dict(_native_build.calls)
    for name in ("tokenize_corpus_native", "build_cell_blocks_native",
                 "build_stream_blocks_native"):
        check(calls.get(name, 0) >= 1, f"[8 ingest] {name} ran "
              f"{calls.get(name, 0)} times on the main path")
    check(launches["ggs"].get("fused_zdraw_nkw.launches") == 1 + INGEST_ITERS
          and launches["ggs"].get("blocked_label_counts.launches", 0)
          >= 1 + INGEST_ITERS
          and launches["pcgs"].get("fused_pcgs_sweep_streamed.launches")
          == 1 + INGEST_ITERS,
          f"[8 ingest] launches {json.dumps(launches)}")
    print(f"[8 ingest] {smi}: a UCI file of {INGEST_DOCS} documents, "
          f"{raw_n} tokens over {INGEST_VOCAB} words ({size / 2 ** 20:.1f} "
          f"MiB) synthesised in {synth_s:.1f} s; load_dataset {load_s:.1f} s "
          f"(read_uci_file {spent.get('read_uci_file', 0):.1f} s, native "
          f"tokenizer {spent.get('tokenize_corpus_native', 0):.1f} s), host "
          f"peak {host_load:.1f} GiB; native cell blocks "
          f"{spent.get('build_cell_blocks_native', 0):.1f} s, native stream "
          f"blocks {spent.get('build_stream_blocks_native', 0):.1f} s, "
          f"doc_visit_order {spent.get('doc_visit_order', 0):.1f} s; native "
          f"calls {json.dumps(calls)}; launches {json.dumps(launches)}",
          flush=True)
    for scheme, r in runs.items():
        per = r["slots"] / corpus.num_tokens
        print(f"[8 ingest {scheme} K={K}] {r['layout']}: {r['slots']} slots "
              f"for {corpus.num_tokens} tokens ({per:.2f} a token); "
              f"add_instances "
              f"{r['setup_s']:.1f} s; {r['ms_per_iteration']:.3f} "
              f"ms/iteration over {INGEST_ITERS} (host clock), "
              f"{r['profiled_ms']:.3f} under the profiler at "
              f"{100 * r['busy_share']:.1f}% device busy; peak "
              f"{r['peak_gib']:.2f} GiB on the card, host peak "
              f"{r['host_peak_gib']:.1f} GiB; N_kw, n_dk, n_k exact on the "
              f"whole corpus; LL {r['ll']:.1f}", flush=True)
    z, c, p = kernels["zdraw"], kernels["counts"], kernels["pcgs_streamed"]
    print(f"[8 ingest kernels] z-draw: z agreement on the first "
          f"{INGEST_BLOCKS} blocks {json.dumps(z['agreement'])}, N_kw its "
          f"histogram; whole layout {z['ms']:.4f} ms, bound "
          f"{z['bound_ms']:.4f} ms ({z['bound_by']}), plain on the first "
          f"blocks {z['plain_ms_first_blocks']:.4f} ms. Count kernel "
          f"({c['layout']}, {c['instance']} instance, {c['shared_bytes']} B "
          f"of shared memory): exact on layouts A and B's first "
          f"{INGEST_BLOCKS} blocks; whole layout B {c['ms']:.4f} ms, bound "
          f"{c['bound_ms']:.4f} ms ({c['bound_by']}), torch.bincount "
          f"{c['library_ms']:.4f} ms, plain on the first blocks "
          f"{c['plain_ms_first_blocks']:.4f} ms. Streamed PCGS: z agreement "
          f"on the first d-window's documents cut to the first "
          f"{INGEST_BLOCKS} blocks ({p['checked_tokens']} tokens) "
          f"{json.dumps(p['agreement'])}, N_kw and the table's moves exact; "
          f"whole layout {p['ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
          f"({p['bound_by']}), plain on the cut documents "
          f"{p['plain_ms_first_blocks']:.4f} ms", flush=True)
    n_pre, m_pre, secs = ingest_prefix(corpus, path, cell_kw, stream_kw)
    print(f"[8 ingest prefix] the first {m_pre} documents ({n_pre} tokens): "
          f"native bit-equal to Python / NumPy in the tokenizer, the cell "
          f"blocks and the stream blocks, and to the whole corpus's first "
          f"documents; seconds " + json.dumps(
              {key: round(v, 3) for key, v in secs.items()}), flush=True)
    del corpus
    shutil.rmtree(work, ignore_errors=True)
    print(f"[8 ingest] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, kernels


# ---- 9. the chain-level checks ------------------------------------------
GEWEKE_JOBS = 8             # the chains' processes: one a host core


def chain_checks_phase(smi: str, jobs: int = GEWEKE_JOBS):
    """`[9 geweke]` and `[9 bf16 gate]`: the Geweke chains through every
    sampling kernel, then the bf16 gate; any failure raises."""
    from tools import card_bf16_gate, card_geweke_check
    t0 = time.perf_counter()
    reports = card_geweke_check.run(
        list(card_geweke_check.CHAINS), "cuda", jobs=jobs,
        echo=lambda line: print(f"[9 geweke] {line}", flush=True))
    failed = [r["name"] for r in reports if not r["ok"]]
    steps = sum(r["steps"] for r in reports)
    print(f"[9 geweke] {len(reports)} chains, {steps} steps in "
          f"{time.perf_counter() - t0:.1f} s ({jobs} processes); {smi}",
          flush=True)
    check(not failed, f"Geweke chains failed on the card: {failed}")
    report = card_bf16_gate.gate(card_bf16_gate.gate_corpus(), "cuda")
    for name in card_bf16_gate.CHECKS:
        print(f"[9 bf16 gate] "
              f"{card_bf16_gate.check_line(name, report['checks'][name])} "
              f"({report['seconds']:.1f} s)", flush=True)
    print(f"[9 bf16 gate] launches {json.dumps(report['launches'])}; "
          f"{smi}", flush=True)
    check(report["gate_pass"], "the bf16 gate failed on the card: "
          + json.dumps(report["checks"]) + " missing counters "
          + json.dumps(report["counters_missing"]))


# ---- 10. the large-K quality study ---------------------------------------
LARGEK_ITERS_C = 1000       # section C's chains (the study's default 3000)


def largek_phase(smi: str):
    """`[10 largek]`: sections A, B and C of the large-K study, C cut to
    LARGEK_ITERS_C iterations; any failure raises."""
    from tools import card_largek_quality as lq
    t0 = time.perf_counter()
    data = lq.study(lq.study_corpus(), "cuda", iters_c=LARGEK_ITERS_C,
                    echo=lambda line: print(f"[10 largek] {line}; {smi}",
                                            flush=True))
    for line in lq.summary_lines(data):
        print(f"[10 largek] {line}; {smi}", flush=True)
    per_chain = {tag: round(rec["ms_per_iteration"], 4)
                 for _, tag, _, rec in lq.chains_of(data)}
    print(f"[10 largek] launches {json.dumps(data['launches'])}; ms an "
          f"iteration {json.dumps(per_chain)}; phase "
          f"{time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    failed = lq.failures(data)
    missing = [n for n in lq.COUNTERS if data["launches"][n] <= 0]
    check(not failed and not missing, "the large-K study failed on the "
          f"card: {failed}; counters that did not move: {missing}")


# ---- 11. the PubMed-scale rehearsal ---------------------------------------
PUBMED_MESH_DEADLINE_S = 480   # the 8 ranks of the mesh arm, all together


def pubmed_phase(smi: str) -> dict:
    """`[11 pubmed]`: tools/card_pubmed_rehearsal.py at its defaults,
    held to PUBMED_REHEARSAL.json; any failure raises. Returns the
    launches of each counter by arm."""
    from tools import card_pubmed_rehearsal as pr
    with open(os.path.join(ROOT, "PUBMED_REHEARSAL.json")) as f:
        jax = json.load(f)
    t0 = time.perf_counter()
    corpus = pr.pubmed_corpus(pr.TOKENS)
    synth_s = time.perf_counter() - t0
    sub = jax["subsample"]
    check(corpus.num_docs == sub["docs"], f"[11 pubmed] {corpus.num_docs} "
          f"documents, the JAX record {sub['docs']}")
    bad = pr.corpus_mismatches(corpus, jax)
    check(not bad, f"[11 pubmed] {bad}")
    work = os.path.join(ROOT, "build", "chip_smoke", "pubmed")
    shutil.rmtree(work, ignore_errors=True)
    try:
        report = pr.rehearse(corpus, exec_tokens=pr.EXEC_TOKENS,
                             device="cuda", jax=jax, work_dir=work,
                             mesh_deadline_s=PUBMED_MESH_DEADLINE_S,
                             echo=lambda line: None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    a, mesh, card = report["analysis"], report["mesh"], report["card"]
    beside = report["beside_jax_record"]
    print(f"[11 pubmed] corpus D={corpus.num_docs} V={pr.V_FULL} "
          f"N={corpus.num_tokens} in {synth_s:.1f} s (numpy "
          f"{np.__version__}); {pr.RANKS} shards' tokens {a['shard_tokens']}"
          f", imbalance {a['shard_imbalance_maxmean']}, padded slots "
          f"{a['padded_slots']}, {a['measured_bytes_per_token']} B a token "
          f"at the JAX model's 13 B a slot, n_dk all-reduce "
          f"{json.dumps(a['ndk_allreduce_wire'])}; equal to "
          f"PUBMED_REHEARSAL.json: "
          f"{json.dumps({k: r['equal'] for k, r in beside.items() if 'equal' in r})}; "
          f"partition {a['build_seconds']:.1f} s; {smi}", flush=True)
    print(f"[11 pubmed] mesh: {pr.mesh_line(mesh)}; {smi}", flush=True)
    print(f"[11 pubmed] one card: {card['seconds']:.1f} s; "
          f"{pr.card_line(card)}; PubMed projected "
          f"{json.dumps(report['pubmed_projection'])}; {smi}", flush=True)
    print(f"[11 pubmed] phase {time.perf_counter() - t0:.1f} s", flush=True)
    for key in ("subsample", "shard_tokens", "shard_imbalance_maxmean",
                "measured_bytes_per_token", "executed_mesh_subsample"):
        check(beside[key]["equal"], f"[11 pubmed] {key}: ours "
              f"{beside[key]['ours']}, the JAX record "
              f"{beside[key]['jax_record']}")
    check(not report["failures"], f"[11 pubmed] {report['failures']}")
    launches = {"one card": card["launches"]}
    for r in mesh["rank_results"]:
        arm = launches.setdefault(f"{pr.RANKS} gloo ranks", {})
        for k, v in r["launches"].items():
            arm[k] = arm.get(k, 0) + v
    return launches


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--parent", default=None, help="a checkout whose "
                    "redesigned kernels phase 3 times beside these")
    args = ap.parse_args(argv)
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
    from ldagroupedgibbssampler_tpu_torch.models.fusion import launch_counters
    from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
    from ldagroupedgibbssampler_tpu_torch.ops import (cuda_alias_mh,
                                                      cuda_counts,
                                                      cuda_gamma,
                                                      cuda_left_to_right,
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
    # the native corpus builders (g++), one compiler a source, together
    from concurrent.futures import ThreadPoolExecutor

    from ldagroupedgibbssampler_tpu_torch.corpus import (_native_build,
                                                         ragged)
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(_native_build.build, sorted(
            p.stem for p in _native_build.NATIVE_DIR.glob("*.cpp"))))
    native_s = time.perf_counter() - t0
    print(f"[2 build] {path.name} in {build_s:.1f} s "
          f"(0 = already built); ptxas: {' | '.join(regs)}; native "
          f"{', '.join(lib.name for lib in libs)} in {native_s:.1f} s",
          flush=True)

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
    check(_native_build.calls["build_cell_blocks_native"] == 1,
          "the 20NG cell blocks were not built natively")
    # the NumPy builder of the same blocks, bit-equal
    saved, ragged.NATIVE_THRESHOLD = ragged.NATIVE_THRESHOLD, n_tok + 1
    try:
        t0 = time.perf_counter()
        numpy_blocks = corpus.cell_blocks(block=cfg.token_block,
                                          vspan=vspan, dspan=dspan)
        numpy_blocks_s = time.perf_counter() - t0
    finally:
        ragged.NATIVE_THRESHOLD = saved
    for name, a in vars(numpy_blocks).items():
        b_ = getattr(blocks, name)
        check(np.array_equal(a, b_) if isinstance(a, np.ndarray)
              else a == b_, f"[3 layout] native and NumPy {name} differ")
    del numpy_blocks
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
          f"slots, layout B {blocks.d_local.shape[0]} blocks, built by the "
          f"native builder in {build_blocks_s:.2f} s, by NumPy (bit-equal) "
          f"in {numpy_blocks_s:.2f} s", flush=True)

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
        agreement[f"{label} ties"] = zdraw_ties(
            torch, f"z-draw ({label})", zk, zr, zargs, zkw, u, precise)
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
    zdraw_k4096 = zdraw_large_k_full(torch, zargs, zkw, real_slots, blocks,
                                     n_tok, gen, cuda_zdraw, rnd)
    torch.cuda.empty_cache()
    pcgs_entries = pcgs_kernel_phase(torch, corpus, Corpus, LDAConfig,
                                     create_model, cuda_pcgs, _build)
    lightlda_entries = lightlda_kernel_phase(torch, corpus, LDAConfig,
                                             create_model, cuda_lightlda)
    adlda_entries = adlda_kernel_phase(torch, corpus, LDAConfig,
                                       create_model, cuda_pcgs)
    gamma_entry = gamma_phase(torch, corpus, cuda_gamma, rnd, smi)
    torch.cuda.empty_cache()
    l2r_entry = left_to_right_phase(torch, corpus, cuda_left_to_right, smi)
    torch.cuda.empty_cache()
    mh_rounds_entry, mh_pack_entry = alias_mh_phase(
        torch, corpus, Corpus, LDAConfig, create_model, cuda_alias_mh, smi,
        _build, parent=args.parent)
    torch.cuda.empty_cache()
    hdp_model = hdp_state(torch, corpus, LDAConfig, create_model)
    tables_entry, psi_entry = hdp_phase(torch, corpus, hdp_model, rnd, smi,
                                        _build, parent=args.parent)
    urn_entry = polya_urn_phase(torch, corpus, hdp_model, smi, _build,
                                parent=args.parent)
    vs_entry = vs_dirichlet_phase(torch, corpus, hdp_model, rnd, smi,
                                  _build, parent=args.parent)
    del hdp_model
    torch.cuda.empty_cache()
    pairwise_entries = pairwise_phase(torch, _build, smi,
                                      parent=args.parent)
    torch.cuda.empty_cache()

    # ---- 4. main path: the library entry point -------------------------
    cuda_counts.blocked_label_counts.launches = 0
    cuda_zdraw.fused_zdraw_nkw.launches = 0
    cuda_gamma.gamma.launches = cuda_gamma.dirichlet.launches = 0
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
        "blocked_label_counts": cuda_counts.blocked_label_counts.launches,
        "gamma": cuda_gamma.gamma.launches,
        "dirichlet": cuda_gamma.dirichlet.launches}
    check(launches["fused_zdraw_nkw"] == ITERS,
          f"z-draw kernel launched {launches['fused_zdraw_nkw']} times")
    check(launches["blocked_label_counts"] >= ITERS,
          f"count kernel launched {launches['blocked_label_counts']} times")
    # theta (one launch) and phi (two) every iteration, and at set-up
    check(launches["dirichlet"] == 3 * (ITERS + 1),
          f"Dirichlet kernels launched {launches['dirichlet']} times")
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
    after = profile_numbers(torch, lambda: model.sample(5), 5)
    draws = sum(c for _, name, c in after[2]
                if "dirichlet" in name or "gamma_kernel" in name)
    check(draws <= 4, f"[4 profile] theta and phi drawn in {draws} "
          "launches of the Gamma kernels an iteration")
    with eager_draws(torch, rnd):
        before = profile_numbers(torch, lambda: model.sample(5), 5)
    print(f"[4 profile] {profile_text(*after, 5, 'iteration')}; theta and "
          f"phi in {draws:.0f} launches of csrc/gamma.cu an iteration; the "
          f"same iterations with the eager generator draws of theta and phi "
          f"(the path before the kernels): "
          f"{profile_summary(*before, 'iteration')}", flush=True)
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
    _, serial_lls = adlda_oracle(torch, corpus, Corpus, LDAConfig,
                                 create_model)
    aliasmh_launches = aliasmh_main_path(torch, corpus, LDAConfig,
                                         create_model, cuda_counts,
                                         cuda_zdraw, cuda_alias_mh, smi)
    foldin_launches, l2r_launches = held_out_phase(
        torch, corpus, LDAConfig, create_model, cuda_counts, cuda_zdraw,
        cuda_left_to_right, smi)
    held_out_large_k(torch, corpus, LDAConfig, create_model, smi)
    base_options_phase(torch, corpus, LDAConfig, create_model, cuda_counts,
                       cuda_zdraw, cuda_pcgs, smi)
    # every launch counter of the port's wrappers
    counters = launch_counters()
    collapsed_phase(torch, corpus, Corpus, LDAConfig, create_model, counters)
    fused_phase(torch, corpus, Corpus, LDAConfig, create_model, counters,
                smi)
    chunked_launches, chunked_numbers, chunked_aliasmh = (
        sample_chunked_phase(torch, corpus, LDAConfig, create_model,
                             counters, rnd, smi))

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

    cli_held_out(torch, work, themes, rng, counters, cuda_zdraw)

    # ---- 6. the apps ----------------------------------------------------
    apps_launches = apps_phase(torch, corpus, Corpus, LDAConfig, counters,
                               smi, work)
    counts_entry["launches_apps"] = apps_launches["blocked_label_counts"]
    for entry in pcgs_entries:
        if entry["name"] == "fused_pcgs_sweep":
            entry["launches_apps"] = apps_launches["fused_pcgs_sweep"]
    # the pairwise kernels' main path: the apps' whole matrices and
    # distance() with ks in [6 similarity]
    for entry in pairwise_entries:
        entry["launches_apps"] = apps_launches[entry["name"]]
        entry["launches"] = sum(entry["launches_apps"].values())

    # ---- 7. the sharded schemes on torch.distributed --------------------
    parallel_launches = parallel_phase(torch, smi, serial_lls)

    # ---- 8. ingestion and the sweeps at the NYTimes shape ---------------
    ingest_launches, ingest_kernels = ingest_phase(
        torch, smi, LDAConfig, create_model, cuda_counts, cuda_zdraw,
        cuda_pcgs)

    # ---- 9. the chain-level checks --------------------------------------
    chain_checks_phase(smi)

    # ---- 10. the large-K quality study ----------------------------------
    largek_phase(smi)

    # ---- 11. the PubMed-scale rehearsal ---------------------------------
    pubmed_launches = pubmed_phase(smi)

    kernels = [
        {**counts_entry, "launches": aliasmh_launches["blocked_label_counts"],
         "launches_ggs": launches["blocked_label_counts"],
         "launches_foldin": foldin_launches["blocked_label_counts"],
         "launches_chunked": chunked_launches["blocked_label_counts"]},
        {"name": "fused_zdraw_nkw", "route": "cuda",
         "source": "ldagroupedgibbssampler_tpu_torch/csrc/zdraw.cu",
         "replaces": "ldagroupedgibbssampler_tpu/ops/pallas_zdraw.py:59",
         "launches": launches["fused_zdraw_nkw"],
         "launches_foldin": foldin_launches["fused_zdraw_nkw"],
         "launches_chunked": chunked_launches["fused_zdraw_nkw"],
         "launches_apps": apps_launches["fused_zdraw_nkw"],
         "max_abs_err": zdraw_err,
         "ms": zdraw_ms, "precise_ms": zdraw_precise_ms,
         "plain_ms": zdraw_plain_ms, "bound_ms": zdraw_bound,
         "bound_by": zdraw_by, "library_ms": None,
         "k4096": zdraw_k4096},
        *pcgs_entries,
        *lightlda_entries,
        *adlda_entries,
        {**gamma_entry,
         "launches": launches["gamma"] + launches["dirichlet"],
         "launches_by_wrapper": {k: launches[k]
                                 for k in ("gamma", "dirichlet")},
         "launches_pcgs": pcgs_launches["gamma"]
         + pcgs_launches["dirichlet"],
         "launches_chunked": chunked_launches["gamma"]
         + chunked_launches["dirichlet"],
         "chunked": chunked_numbers},
        {**l2r_entry, "launches": l2r_launches},
        {**mh_rounds_entry, "launches": aliasmh_launches["mh_rounds"],
         "launches_prepass": aliasmh_launches["entry_topics"],
         "launches_chunked": chunked_aliasmh["mh_rounds"]},
        {**mh_pack_entry, "launches": aliasmh_launches["pack_tables"],
         "launches_chunked": chunked_aliasmh["pack_tables"]},
        *pairwise_entries,
    ]
    # the draw kernels: launches on the ppu_hdplda K_max=100 main path
    # (the VS rows: nzvsspalias K=100), and in every run of phase 4
    draws = {**new_launches["draws"],
             "polyaurn K=100": pcgs_launches["draws polyaurn"]}
    for entry, key, main_run in (
            (tables_entry, "table_counts", "ppu_hdplda K=100"),
            (psi_entry, "psi_step", "ppu_hdplda K=100"),
            (urn_entry, "polya_urn", "ppu_hdplda K=100"),
            (vs_entry, "vs_dirichlet", "nzvsspalias K=100")):
        kernels.append({**entry, "launches": draws[main_run][key],
                        "launches_by_run": {run: d[key] for run, d in
                                            draws.items() if d[key]}})
    for entry in kernels:
        key = entry["name"] + (" collapsed" if entry.get("mode")
                               == "collapsed" else "")
        keys = ("gamma", "dirichlet") if key == "gamma" else (key,)
        entry["launches_parallel"] = {
            run: sum(parallel_launches.get(k, {}).get(run, 0) for k in keys)
            for run in ("2 gloo ranks", "1 nccl rank")}
        entry["launches_pubmed"] = {
            arm: sum(got.get(k, 0) for k in keys)
            for arm, got in pubmed_launches.items()}
    # phase 8's launches by scheme, and the kernel's numbers at its shape
    ingest_of = {"blocked_label_counts": "counts",
                 "fused_zdraw_nkw": "zdraw",
                 "fused_pcgs_sweep_streamed": "pcgs_streamed"}
    for entry in kernels:
        if entry["name"] in ingest_of and entry.get("mode", "pcgs") == "pcgs":
            entry["launches_ingest"] = {
                scheme: got.get(f"{entry['name']}.launches", 0)
                for scheme, got in ingest_launches.items()}
            entry["ingest"] = ingest_kernels[ingest_of[entry["name"]]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
