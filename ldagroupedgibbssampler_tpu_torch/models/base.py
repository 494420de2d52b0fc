"""Sampler base: chain state + the reference's run-lifecycle API.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/base.py`. The
reference defines `LDAGibbsSampler` (topics/LDAGibbsSampler.java:10-46) with
`addInstances / sample(iterations) / getters / lifecycle hooks`;
`TorchLDASampler` provides that surface: the lifecycle hooks `pre_sample`,
`post_sample`, `pre_iteration`, `pre_z`, `post_z`, `pre_phi`, `post_phi`
and `post_iteration` (overridable no-ops, called where the JAX `sample`
calls them), iteration listeners (`add_iteration_listener(fn)`, called as
`fn(model, it)` after `post_iteration`, as tui/IterationListener.java:5-7)
and the getters.

State is a mutable `LDAState` dataclass of tensors on the sampler's device.
Each scheme's `_step(state, doc_mask, type_mask)` replaces its fields in
place with the next iteration's tensors. z lives in the scheme's block
layout; the layout's `flat_index` (corpus token index of each slot, -1 on
padding) translates it to and from the canonical token order. Random bits
come from one `torch.Generator` on the device, seeded from the config;
held-out evaluation draws from a generator of its own, so a chain with a
test set is the same chain as without one. The `sample()` loop mirrors
`UncollapsedParallelLDA.sample` (topics/UncollapsedParallelLDA.java:
552-943): random scan over documents, types and topic rows, wall-clock
budget, abort flag / abort file, paranoid checks, per-iteration timings
with a profiler trace, the likelihood / log-posterior / held-out / stats
series every `topic_interval` iterations, windowed dumps, phi-mean
accumulation with burn-in + thinning, and hyperparameter optimisation.
Every feature costs nothing while its key is off. Iteration fusion
(`scan_chunk`) follows the JAX base's rule: groups of `scan_chunk`
event-free iterations run as one replay of a captured CUDA graph on the
card (`models/fusion.py`), bit-equal to single-stepping.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.foldin import fold_in
from ldagroupedgibbssampler_tpu_torch.evaluation.hyperopt import (
    learn_dirichlet_parameters, learn_symmetric_concentration)
from ldagroupedgibbssampler_tpu_torch.evaluation.likelihood import (
    log_posterior, matrix_density, model_log_likelihood)
from ldagroupedgibbssampler_tpu_torch.evaluation.marginal import (
    left_to_right_from_counts)
from ldagroupedgibbssampler_tpu_torch.evaluation.topwords import top_words
from ldagroupedgibbssampler_tpu_torch.models import randomscan
from ldagroupedgibbssampler_tpu_torch.models.fusion import FusedSteps
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.counts import (
    check_count_consistency, doc_topic_counts, tokens_per_topic,
    topic_word_counts)
from ldagroupedgibbssampler_tpu_torch.utils import matrix_io
from ldagroupedgibbssampler_tpu_torch.utils.device import resolve_device
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import (
    device_memory_stats)
from ldagroupedgibbssampler_tpu_torch.utils.timing import IterationStats

# rows of the pairwise-distance matrix computed at a time (2,048 x D float32)
_DISTANCE_ROWS = 2048


@dataclass
class LDAState:
    """One snapshot of the Markov chain; the sampler's step replaces its
    fields in place.

      z     <- per-token topic indicators, in the sampler's own layout
      ndk   <- document-topic counts [D, K] int32
      nkw   <- topic-type counts, [K, V] or [V, K] (`nkw_layout`) int32
      nk    <- tokens per topic [K] int32
      phi   <- topic-word distributions, oriented like nkw, f32
      theta <- GGS thetaMatrix [D, K] f32; None where theta is integrated out
      alpha <- [K] f32; beta <- float
    """
    z: torch.Tensor
    ndk: torch.Tensor
    nkw: torch.Tensor
    nk: torch.Tensor
    phi: torch.Tensor
    theta: Optional[torch.Tensor]
    alpha: torch.Tensor
    beta: float
    iteration: int


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def min_pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """Per-row min Euclidean distance to any OTHER row (the diagnostics of
    UncollapsedParallelLDA.java:723-806) through a Gram matmul, on x's
    device, `_DISTANCE_ROWS` rows of the [rows, rows] matrix at a time."""
    x = x.to(torch.float32)
    rows = x.shape[0]
    sq = (x * x).sum(dim=1)
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    for s in range(0, rows, _DISTANCE_ROWS):
        e = min(rows, s + _DISTANCE_ROWS)
        g = (sq[s:e, None] + sq[None, :] - 2.0 * (x[s:e] @ x.T)).clamp_min_(0)
        i = torch.arange(e - s, device=x.device)
        g[i, i + s] = torch.inf
        out[s:e] = g.min(dim=1).values
    return out.sqrt()


class TorchLDASampler:
    """Base class for the port's schemes. Subclasses implement
    `_prepare_device_data` (which sets the z layout: `_slot_mask`, the
    validity of every z slot, and `_flat_index`, the corpus token index of
    every slot), `_step` and the recounts `_count_nkw` / `_count_ndk`."""

    # Orientation of state.nkw / state.phi: "kv" = [K, V] (reference
    # orientation), "vk" = [V, K] (type-major, GGS).
    nkw_layout = "kv"
    # Whether phi rows are drawn with beta smoothing (LDAPartiallyCollapsed
    # GibbsSampler.java:95-118 fixes the unsmoothed draw flagged at
    # UncollapsedParallelLDA.java:1313-1315).
    smooth_phi = True
    # Whether `_step` can be captured as a CUDA graph (models/fusion.py):
    # False for a step that runs host code per token, whose fused groups
    # then run single-stepped.
    _capturable_step = True

    def __init__(self, config: LDAConfig, logger=None):
        self.config = config
        self.logger = logger
        self.device = resolve_device(config.device)
        self.generator: Optional[torch.Generator] = None
        # the generator of the draws every rank of a sharded scheme makes
        # alike (phi, replicated theta, the initial z); one device has one
        # generator, so it is `generator` there
        self.shared_generator: Optional[torch.Generator] = None
        self.corpus: Optional[Corpus] = None
        self.test_corpus: Optional[Corpus] = None
        self.state: Optional[LDAState] = None
        self._abort = False
        self._ll_history: list = []          # (iteration, ll)
        self._held_out_history: list = []
        self._phi_mean: Optional[torch.Tensor] = None   # [K, V] sum
        self._phi_mean_count = 0
        self._fold_in_theta: Optional[np.ndarray] = None
        self._last_delta_types: Optional[np.ndarray] = None
        self.doc_batch_builder = None
        self.topic_index_builder = None
        self.topic_batch_builder = None
        # the fused groups of the last sample() call (None without fusion)
        self.fused_steps: Optional[FusedSteps] = None
        self._iteration_listeners: list = []   # tui/IterationListener.java

    # ------------------------------------------------------------------
    # data loading (LDAGibbsSampler.addInstances / addTestInstances)
    # ------------------------------------------------------------------
    def add_instances(self, corpus: Corpus):
        """Random z init + count build (ModifiedSimpleLDA.addInstances
        :939-969 draws each token's initial topic uniformly)."""
        self.corpus = corpus
        self._seed_generators()
        self._prepare_device_data(corpus)
        self.state = self._init_state()
        self._make_builders(corpus)
        return self

    def _seed_generators(self):
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.effective_seed())
        self.shared_generator = self.generator

    def _make_builders(self, corpus: Corpus):
        """The random-scan builders over `corpus`."""
        cfg = self.config
        self.doc_batch_builder = randomscan.make_document_batch_builder(
            cfg, corpus.num_docs)
        self.topic_index_builder = randomscan.make_topic_index_builder(
            cfg, corpus)
        self.topic_batch_builder = randomscan.make_topic_batch_builder(cfg)

    def add_test_instances(self, corpus: Corpus):
        """The held-out documents (same vocabulary), scored every
        `topic_interval` iterations by the left-to-right estimator."""
        self.test_corpus = corpus
        w_pad, mask_pad = corpus.to_padded()
        self._test_pad = (torch.as_tensor(w_pad, device=self.device),
                          torch.as_tensor(mask_pad, device=self.device))
        return self

    def _prepare_device_data(self, corpus: Corpus):
        raise NotImplementedError

    def _nk(self, nkw: torch.Tensor) -> torch.Tensor:
        return (tokens_per_topic(nkw) if self.nkw_layout == "kv"
                else nkw.sum(dim=0, dtype=torch.int32))

    def _init_state(self) -> LDAState:
        """Uniform z over the layout's real slots, counts rebuilt from it,
        then the scheme's initial phi (and theta where it has one)."""
        cfg = self.config
        z = self._initial_z()
        nkw = self._merge_nkw(self._count_nkw(z))
        ndk = self._merge_ndk(self._count_ndk(z))
        alpha = torch.full((cfg.topics,), cfg.alpha, dtype=torch.float32,
                           device=self.device)
        beta = float(np.float32(cfg.beta))     # f32, as the JAX state's
        phi = self._initial_phi(nkw, beta)
        theta = self._initial_theta(ndk, alpha)
        return LDAState(z=z, ndk=ndk, nkw=nkw, nk=self._nk(nkw), phi=phi,
                        theta=theta, alpha=alpha, beta=beta, iteration=0)

    def _initial_z(self) -> torch.Tensor:
        """Uniform topics on the layout's real slots, 0 on padding."""
        z = torch.randint(0, self.config.topics, self._slot_mask.shape,
                          generator=self.generator, device=self.device,
                          dtype=torch.int32)
        return torch.where(self._slot_mask, z, 0)

    def _merge_nkw(self, nkw: torch.Tensor,
                   entry: Optional[torch.Tensor] = None) -> torch.Tensor:
        """N_kw of the whole corpus from this process's count (or, with
        `entry`, from its counts kept live from `entry`): the identity on
        one device, the merge over the ranks of a sharded scheme."""
        return nkw

    def _merge_ndk(self, ndk: torch.Tensor) -> torch.Tensor:
        """The state's n_dk from this process's count: the identity but
        where ranks hold partial counts of the same documents."""
        return ndk

    def _initial_phi(self, nkw, beta):
        """phi rows ~ Dir(n_k + beta), or Dir(n_k + 1e-3) for the
        unsmoothed schemes ([K, V] orientation)."""
        return rnd.dirichlet(nkw.to(torch.float32)
                             + (beta if self.smooth_phi else 0.0)
                             + (0.0 if self.smooth_phi else 1e-3),
                             self.shared_generator)

    def _initial_theta(self, ndk, alpha):
        return None   # only GGS carries theta in state

    def _step(self, state: LDAState, doc_mask: Optional[torch.Tensor],
              type_mask: Optional[torch.Tensor] = None):
        """One iteration, updating `state` in place. `doc_mask = None` is
        the full sweep (every document selected); `type_mask = None`
        redraws every phi column, else only the columns where it is True
        (the others keep their values up to the row's renormalisation)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # main loop (UncollapsedParallelLDA.sample:552-943)
    # ------------------------------------------------------------------
    def _mask(self, mask: np.ndarray) -> Optional[torch.Tensor]:
        """A builder's mask on the device, or None when it selects all."""
        return None if mask.all() else torch.as_tensor(mask,
                                                       device=self.device)

    def _doc_mask(self, mask: np.ndarray) -> Optional[torch.Tensor]:
        """The step's document mask from the builder's mask over the
        corpus (a rank of a sharded scheme takes its own documents)."""
        return self._mask(mask)

    def _should_stop(self, deadline) -> bool:
        """Cooperative abort (the flag, or an `abort` file in the working
        directory, UncollapsedParallelLDA.java:131,908-910) or the
        wall-clock budget; the ranks of a sharded scheme decide together."""
        return (self._abort or os.path.exists("abort")
                or (deadline is not None and time.time() > deadline))

    # ------------------------------------------------------------------
    # iteration fusion (config key scan_chunk), the JAX base's rule
    # ------------------------------------------------------------------
    def _fusable_chunk(self) -> int:
        """scan_chunk when iteration groups can be fused without changing
        any observable behaviour, else 1. Conditions: no per-iteration host
        work (hooks, listeners, paranoid checks, timing, phi-mean
        accumulation, hyperopt) and no runtime-feedback random scan
        (delta-N type masks, percentage topic batches)."""
        cfg = self.config
        if (cfg.scan_chunk <= 1 or cfg.paranoid or self._iteration_listeners
                or cfg.measure_timing or cfg.save_phi_means
                or cfg.hyperparam_optim_interval > 0
                or cfg.topic_index_building_scheme != "all"
                or cfg.topic_batch_building_scheme != "even"
                or float(cfg.percentage_split_size_topic) < 1.0
                or self._needs_delta()):
            return 1
        for h in ("pre_iteration", "post_iteration", "pre_z", "post_z",
                  "pre_phi", "post_phi"):
            if getattr(type(self), h) is not getattr(TorchLDASampler, h):
                return 1
        return max(1, int(cfg.scan_chunk))

    def _iteration_has_event(self, it: int) -> bool:
        cfg = self.config
        if cfg.topic_interval and cfg.topic_interval > 0 \
                and it % cfg.topic_interval == 0:
            return True
        if self.logger is not None and it % 100 == 0:
            return True          # device-metrics logging cadence
        return any(self._in_interval(it, w) for w in (
            cfg.diagnostic_interval, cfg.dn_diagnostic_interval,
            cfg.print_ndocs_interval, cfg.print_ntopwords_interval))

    def _fusable_span(self, it: int, end_it: int, chunk: int) -> int:
        """Length of the fused group starting at `it`: exactly `chunk`
        event-free iterations, else 1 (a fixed group size keeps one
        captured graph instead of one per remainder length)."""
        if it + chunk - 1 > end_it:
            return 1
        if any(self._iteration_has_event(j) for j in range(it, it + chunk)):
            return 1
        return chunk

    def sample(self, iterations: int | None = None):
        cfg = self.config
        iterations = iterations or cfg.iterations
        if self.state is None:
            raise RuntimeError("call add_instances first")
        deadline = time.time() + cfg.exec_time if cfg.exec_time > 0 else None
        self.pre_sample()
        start_iter = self.state.iteration
        # measure_timing (UncollapsedParallelLDA.java:1340-1347 wrote
        # per-thread phase files): per-iteration wall times to timings.txt
        # plus one torch.profiler trace of iterations 2-4 under
        # timing_data/, where the per-kernel device time lives
        timing = cfg.measure_timing and self.logger is not None
        profiler = None
        fuse = self._fusable_chunk()
        self.fused_steps = FusedSteps(self) if fuse > 1 else None
        end_it = start_iter + iterations
        it = start_iter + 1
        while it <= end_it:
            # scan_chunk: a group of event-free iterations is one replay of
            # a captured CUDA graph (models/fusion.py), the same _step with
            # the same masks and draws as single-stepping; the abort flag
            # and the deadline are checked once a group. The topic index
            # builder of a fusable run ("all") selects every type.
            n = self._fusable_span(it, end_it, fuse) if fuse > 1 else 1
            if n >= 2:
                self.fused_steps.run([self.doc_batch_builder.doc_mask(j)
                                      for j in range(it, it + n)])
                it += n
                if self._should_stop(deadline):
                    break
                continue
            t0 = time.perf_counter()
            self.pre_iteration()
            doc_mask = self._doc_mask(self.doc_batch_builder.doc_mask(it))
            type_mask = self._mask(self.topic_index_builder.type_mask(
                it, self._last_delta_types))
            self.pre_z()
            need_prev = (self._needs_delta() or self._in_interval(
                it, cfg.dn_diagnostic_interval))
            prev_nkw = self.state.nkw.clone() if need_prev else None
            # topic-batch row selection (PercentageTopicBatchBuilder):
            # unselected phi rows keep their previous draw — exact, since
            # rows are independent Dirichlets given counts
            topic_mask = self._mask(self.topic_batch_builder.topic_mask(it))
            prev_phi = self.state.phi if topic_mask is not None else None
            self._step(self.state, doc_mask, type_mask)
            self.post_z()
            if prev_phi is not None:
                tm = (topic_mask[:, None] if self.nkw_layout == "kv"
                      else topic_mask[None, :])
                self.state.phi = torch.where(tm, self.state.phi, prev_phi)
            self.post_phi()
            if prev_nkw is not None:
                # the types whose counts moved, along the type axis of
                # either orientation
                topic_axis = 0 if self.nkw_layout == "kv" else 1
                self._last_delta_types = _np((self.state.nkw != prev_nkw)
                                             .any(dim=topic_axis))
            if cfg.paranoid:
                self._paranoid_checks()
            if timing:
                self.logger.log_timing(f"iteration_{it}",
                                       (time.perf_counter() - t0) * 1e3)
                if it == start_iter + 2:
                    profiler = self._start_trace()
                elif it == start_iter + 4 and profiler is not None:
                    self._stop_trace(profiler)
                    profiler = None
            self._periodic_logging(it, t0)
            self._interval_dumps(it, prev_nkw)
            self._accumulate_phi_mean(it, iterations)
            if (cfg.hyperparam_optim_interval > 0
                    and it % cfg.hyperparam_optim_interval == 0):
                self._optimize_hyperparameters()
            self.post_iteration()
            for listener in self._iteration_listeners:
                listener(self, it)
            if self._should_stop(deadline):
                break
            it += 1
        if self.fused_steps is not None:
            self.fused_steps.close()
        if profiler is not None:      # stopped inside the trace window
            self._stop_trace(profiler)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.post_sample()
        return self

    # ------------------------------------------------------------------
    # lifecycle hooks (LDAGibbsSampler.java:10-46): overridable no-ops,
    # called by the single-stepped iterations of sample(); a fused group
    # calls none, and overriding any of the per-iteration ones turns
    # fusion off (_fusable_chunk)
    # ------------------------------------------------------------------
    def pre_sample(self):
        """Before the first iteration of sample()."""

    def post_sample(self):
        """After the last iteration of sample(), the device synchronised."""

    def pre_iteration(self):
        """At the top of an iteration, before its masks are built."""

    def pre_z(self):
        """After the iteration's masks, just before the step."""

    def post_z(self):
        """Right after the step, before the topic-batch phi restore."""

    def pre_phi(self):
        """Never called, as in the JAX package: each scheme's `_step` draws
        z and phi in one call, so nothing runs between them (a fault of
        the reference's contract, ROADMAP C)."""

    def post_phi(self):
        """After the step and the topic-batch phi restore."""

    def post_iteration(self):
        """After every iteration's logging, before the listeners."""

    def add_iteration_listener(self, fn):
        """Register `fn(model, it)`, called after `post_iteration` of every
        single-stepped iteration (tui/IterationListener.java:5-7); a
        registered listener turns fusion off."""
        self._iteration_listeners.append(fn)

    def _start_trace(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_trace(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        if self.logger.run_dir is None:      # a rank that writes nothing
            return
        trace_dir = os.path.join(self.logger.run_dir, "timing_data")
        os.makedirs(trace_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    # ------------------------------------------------------------------
    # periodic work inside the loop
    # ------------------------------------------------------------------
    def _nkw_kv(self) -> torch.Tensor:
        """Counts in the reference's [K, V] orientation."""
        nkw = self.state.nkw
        return nkw if self.nkw_layout == "kv" else nkw.T

    def _phi_kv(self) -> torch.Tensor:
        phi = self.state.phi
        return phi if self.nkw_layout == "kv" else phi.T

    def _needs_delta(self) -> bool:
        return isinstance(self.topic_index_builder, (
            randomscan.DeltaNTopicIndexBuilder,
            randomscan.MixedMandelbrotDeltaNTopicIndexBuilder))

    def model_log_likelihood(self) -> float:
        st = self.state
        return float(model_log_likelihood(st.ndk, self._nkw_kv(), st.alpha,
                                          st.beta))

    def _theta_matrix(self) -> torch.Tensor:
        """theta of every document on the device: the chain's draw where
        the scheme has one, else the mean estimate."""
        st = self.state
        return (st.theta if st.theta is not None
                else torch.as_tensor(self.get_theta_estimate(),
                                     device=self.device))

    def log_posterior(self) -> float:
        """The Doss & George log posterior of the state
        (evaluation/likelihood.py::log_posterior)."""
        st = self.state
        return float(log_posterior(st.ndk, self._nkw_kv(),
                                   self._theta_matrix(), self._phi_kv(),
                                   st.alpha, st.beta))

    def _periodic_logging(self, it: int, t0: float):
        cfg = self.config
        interval = cfg.topic_interval
        if interval is None or interval <= 0 or it % interval != 0:
            return
        st = self.state
        stats = IterationStats(iteration=it,
                               total_ms=(time.perf_counter() - t0) * 1e3)
        if cfg.compute_likelihood:
            ll = self.model_log_likelihood()
            self._ll_history.append((it, ll))
            if self.logger:
                self.logger.log_likelihood(it, ll)
        if self.logger and cfg.start_diagnostic > 0 \
                and it >= cfg.start_diagnostic:
            self.logger.log_posterior(it, self.log_posterior())
            if cfg.compute_doc_topic_distances:
                # min pairwise Euclidean distances between theta rows and
                # between phi rows, one CSV row per diagnostic iteration
                # (UncollapsedParallelLDA.java:723-806)
                self.logger.log_min_distances(
                    "min_doc_distances.csv", it,
                    _np(min_pairwise_distances(self._theta_matrix())))
                self.logger.log_min_distances(
                    "min_topic_distances.csv", it,
                    _np(min_pairwise_distances(self._phi_kv())))
        if self.test_corpus is not None:
            hll = self._held_out_log_likelihood()
            self._held_out_history.append((it, hll))
            if self.logger:
                self.logger.log_held_out_ll(it, hll)
        if self.logger is None:
            return
        if cfg.log_type_topic_density:
            stats.density_nkw = float(matrix_density(st.nkw))
        if cfg.log_document_density:
            stats.density_ndk = float(matrix_density(
                self.get_document_topic_matrix()))
        if cfg.log_phi_density:
            stats.density_phi = float(matrix_density(st.phi))
        self.logger.log_stats_row(stats.as_row())
        if cfg.log_tokens_per_topic:
            self.logger.log_tokens_per_topic(_np(st.nk))
        # device memory every RESOURCE_LOG_INTERVAL iterations — the JMX
        # MemoryMXBean equivalent (UncollapsedParallelLDA.java:1972-2048)
        if it % 100 == 0:
            self.logger.log_device_metrics(it,
                                           device_memory_stats(self.device))

    @staticmethod
    def _in_interval(it: int, intervals) -> bool:
        """intervals = flat (a1, b1, a2, b2, ...) iteration windows
        (Configuration-README.txt `diagnostic_interval`)."""
        pairs = list(intervals or ())
        return any(a <= it <= b for a, b in zip(pairs[::2], pairs[1::2]))

    def _interval_dumps(self, it: int, prev_nkw):
        """Windowed artifact dumps (UncollapsedParallelLDA.java:829-833 and
        :945-968): binary phi/N/M snapshots + z CSV inside
        `diagnostic_interval`, delta-N magnitude inside
        `dn_diagnostic_interval`, doc-topic / top-word console prints
        inside their windows."""
        cfg = self.config
        if self.logger is None:
            return
        if self._in_interval(it, cfg.diagnostic_interval):
            # every rank of a sharded scheme gathers; one writes
            base = self.logger.run_dir
            ndk, z = self.get_document_topic_matrix(), self.get_z_indicators()
            if base is not None:
                matrix_io.write_binary_double_matrix(
                    self.get_phi(), it, os.path.join(base, "phi"))
                matrix_io.write_binary_int_matrix(
                    self.get_topic_type_counts(), it,
                    os.path.join(base, "N"))
                matrix_io.write_binary_int_matrix(ndk, it,
                                                  os.path.join(base, "M"))
            self.logger.save_z(it, z)
        if (self._in_interval(it, cfg.dn_diagnostic_interval)
                and prev_nkw is not None):
            delta = int((self.state.nkw.to(torch.int64)
                         - prev_nkw.to(torch.int64)).abs().sum())
            self.logger._append("delta_n.txt", f"{it}\t{delta}")
        if (self._in_interval(it, cfg.print_ndocs_interval)
                and cfg.print_ndocs_cnt > 0):
            theta = self.get_theta_estimate()[: cfg.print_ndocs_cnt]
            print(f"Iteration {it} doc-topic means:\n{np.round(theta, 4)}")
        if (self._in_interval(it, cfg.print_ntopwords_interval)
                and cfg.print_ntopwords_cnt > 0):
            for k, ws in enumerate(self.get_top_words(
                    cfg.print_ntopwords_cnt)):
                print(f"Iteration {it} topic {k}: {' '.join(ws)}")

    def _accumulate_phi_mean(self, it: int, total_iters: int):
        cfg = self.config
        if not cfg.save_phi_means:
            return
        burn_iter = int(total_iters * cfg.phi_mean_burnin / 100.0)
        if it <= burn_iter or (it - burn_iter) % max(cfg.phi_mean_thin, 1):
            return
        phi = self._phi_kv()
        self._phi_mean = (phi.clone() if self._phi_mean is None
                          else self._phi_mean + phi)
        self._phi_mean_count += 1

    def _optimize_hyperparameters(self):
        """optimizeAlpha / optimizeBeta (ModifiedSimpleLDA.java:812-905)."""
        st = self.state
        ndk = self.get_document_topic_matrix()
        lengths = ndk.sum(axis=1)
        if self.config.symmetric_alpha:
            a = learn_symmetric_concentration(ndk, lengths,
                                              self.config.topics,
                                              float(st.alpha[0]))
            alpha = np.full(self.config.topics, a)
        else:
            alpha = learn_dirichlet_parameters(_np(st.alpha), ndk, lengths)
        nkw = _np(self._nkw_kv())
        b = learn_symmetric_concentration(nkw, nkw.sum(axis=1),
                                          self.corpus.num_types,
                                          float(st.beta))
        st.alpha = torch.as_tensor(alpha, dtype=torch.float32,
                                   device=self.device)
        st.beta = float(np.float32(b))

    def _paranoid_checks(self):
        """ParanoidUncollapsedParallelLDA invariants
        (test subclass, SURVEY.md §4.3) run inline each iteration."""
        st = self.state
        nkw_kv = self._nkw_kv()
        checks = check_count_consistency(nkw_kv, st.ndk,
                                         self.corpus.num_tokens)
        for name, ok in checks.items():
            if not ok:
                raise AssertionError(
                    f"paranoid: invariant {name} violated at iteration "
                    f"{st.iteration}")
        phi_sums = self._phi_kv().sum(dim=-1)
        # Inactive HDP topics have all-zero phi rows by design
        # (PoissonPolyaUrnHLDA.java:810-819); every other row must
        # normalise (ensureConsistentPhi).
        if not bool((((phi_sums - 1.0).abs() < 1e-3)
                     | (phi_sums == 0.0)).all()):
            raise AssertionError("paranoid: phi rows not normalised "
                                 "(ensureConsistentPhi)")
        # recount N_kw from z (ensureConsistentTopicTypeCounts proper,
        # UncollapsedParallelLDA.java:299-338): catches any kernel/layout
        # drift between the z array and the count matrices
        k, v = self.config.topics, self.corpus.num_types
        ref = np.bincount(self.corpus.tokens.astype(np.int64) * k
                          + self.get_z_indicators(), minlength=v * k)
        if not np.array_equal(_np(nkw_kv).T.reshape(-1), ref):
            raise AssertionError(
                "paranoid: N_kw does not match a recount of z "
                f"(iteration {st.iteration})")

    def _held_out_generator(self, iteration: int) -> torch.Generator:
        """The held-out estimator's own generator, seeded from (seed,
        iteration): the chain's generator never advances for it, as the
        JAX package's fold_in(key, 7919) leaves the chain's key alone."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.config.effective_seed() * 1_000_003 + 7919)
                         * 1_000_003 + iteration) & 0x7FFF_FFFF_FFFF_FFFF)
        return gen

    def _held_out_log_likelihood(self, gumbel=None) -> float:
        """Left-to-right held-out LL of the test documents under the
        current counts, with 100 particles (base.py:650-657 of the JAX
        package). `gumbel` injects each position's noise (tests)."""
        st = self.state
        w_pad, mask_pad = self._test_pad
        gen = (None if gumbel is not None
               else self._held_out_generator(st.iteration))
        return float(left_to_right_from_counts(
            w_pad, mask_pad, self._nkw_kv(), st.nk, st.alpha, st.beta, 100,
            gen, gumbel))

    # ------------------------------------------------------------------
    # accessors (LDAGibbsSampler / LDASamplerWithPhi getters)
    # ------------------------------------------------------------------
    def abort(self):
        self._abort = True

    def get_abort(self) -> bool:
        return self._abort

    def get_phi(self) -> np.ndarray:
        """phi in the reference's [K, V] orientation."""
        return _np(self._phi_kv())

    def get_topic_type_counts(self) -> np.ndarray:
        """K×V counts (topicTypeCountMapping)."""
        return _np(self._nkw_kv())

    def get_type_topic_matrix(self) -> np.ndarray:
        """V×K counts (typeTopicCounts; the reference keeps both
        orientations, UncollapsedParallelLDA.java:373-375)."""
        return self.get_topic_type_counts().T

    def get_document_topic_matrix(self) -> np.ndarray:
        return _np(self.state.ndk)

    def get_tokens_per_topic(self) -> np.ndarray:
        return _np(self.state.nk)

    def get_alpha(self) -> np.ndarray:
        return _np(self.state.alpha)

    def get_beta(self) -> float:
        return float(self.state.beta)

    def get_theta_estimate(self) -> np.ndarray:
        """Mean-estimate theta = (ndk + alpha) / (len_d + alphaSum)
        (ModifiedSimpleLDA.getThetaEstimate:617-778)."""
        ndk = self.get_document_topic_matrix().astype(np.float64)
        alpha = self.get_alpha().astype(np.float64)
        denom = ndk.sum(axis=1, keepdims=True) + alpha.sum()
        return (ndk + alpha[None, :]) / np.maximum(denom, 1e-12)

    def get_zbar(self) -> np.ndarray:
        """Empirical doc-topic proportions ndk / len_d (getZbar)."""
        ndk = self.get_document_topic_matrix().astype(np.float64)
        return ndk / np.maximum(ndk.sum(axis=1, keepdims=True), 1.0)

    def get_log_likelihoods(self) -> list:
        return list(self._ll_history)

    def get_held_out_log_likelihoods(self) -> list:
        return list(self._held_out_history)

    def get_phi_means(self) -> Optional[np.ndarray]:
        """Mean of the phi draws kept by `save_phi_means` (burn-in and
        thinning applied), [K, V]; None before the first one."""
        if self._phi_mean is None or self._phi_mean_count == 0:
            return None
        return _np(self._phi_mean) / self._phi_mean_count

    def get_fold_in_theta(self) -> Optional[np.ndarray]:
        """The post-burn-in theta mean of the last `sample_z_given_phi`."""
        return self._fold_in_theta

    def get_top_words(self, n: int | None = None) -> list:
        return top_words(self.get_topic_type_counts(), self.corpus.vocab,
                         n or self.config.no_top_words)

    def set_phi(self, phi, vocab=None, labels=None):
        """setPhi with alphabet verification
        (UncollapsedParallelLDA.java:1913-1926). `phi` is [K, V]."""
        if vocab is not None and list(vocab) != list(self.corpus.vocab):
            raise ValueError("vocabulary mismatch in set_phi")
        phi = torch.as_tensor(np.asarray(phi, np.float32), device=self.device)
        if phi.shape != self._phi_kv().shape:
            raise ValueError(f"phi must be [K, V] = "
                             f"{tuple(self._phi_kv().shape)}")
        self.state.phi = (phi if self.nkw_layout == "kv"
                          else phi.T.contiguous())

    def sample_z_given_phi(self, iterations: int = 100):
        """Resample z (and the count matrices) holding phi fixed —
        LDASamplerWithPhi.sampleZGivenPhi
        (UncollapsedParallelLDA.java:975-1014) — by `evaluation/foldin.py`
        over this sampler's corpus, on the GGS z-draw and count kernels,
        with the chain's generator. phi and theta stay; the post-burn-in
        theta mean is kept for `get_fold_in_theta`."""
        cfg = self.config
        corpus, generator, blocks = self._fold_in_part()
        res = fold_in(self._phi_kv(), corpus, self.state.alpha, generator,
                      int(iterations), token_block=cfg.token_block,
                      vocab_span=cfg.vocab_span, doc_span=cfg.doc_span,
                      blocks=blocks)
        self._fold_in_theta = _np(self._docs_whole(res.theta_mean))
        self._adopt_fold_in(res)
        return self

    def _fold_in_part(self):
        """What this process folds in: (corpus, generator, its cell blocks
        or None to build them)."""
        return self.corpus, self.generator, self._fold_in_blocks()

    def _fold_in_blocks(self):
        """Cell blocks of this corpus to fold in on (None: build them)."""
        return None

    def _docs_whole(self, rows):
        """Per-document rows of the whole corpus from this process's rows:
        the identity but where ranks hold parts of the documents."""
        return rows

    def _adopt_fold_in(self, res):
        """Take a fold-in's z into this sampler's layout and recount."""
        self._rebuild_counts(torch.as_tensor(self._z_from_flat(res.flat_z()),
                                             device=self.device))

    def get_z_indicators(self) -> np.ndarray:
        """Per-token topic assignments in flat corpus order."""
        z = self.state.z.cpu().numpy().reshape(-1)
        idx = self._flat_index
        out = np.zeros(self.corpus.num_tokens, np.int32)
        valid = idx >= 0
        out[idx[valid]] = z[valid]
        return out

    def _z_from_flat(self, z_flat: np.ndarray) -> np.ndarray:
        """Inverse of get_z_indicators: canonical order -> own layout."""
        z_flat = np.asarray(z_flat, np.int32)
        if z_flat.shape != (self.corpus.num_tokens,):
            raise ValueError(f"z must hold one topic per token "
                             f"({self.corpus.num_tokens}), got "
                             f"{z_flat.shape}")
        z = np.zeros(self._flat_index.shape, np.int32)
        valid = self._flat_index >= 0
        z[valid] = z_flat[self._flat_index[valid]]
        return z.reshape(tuple(self._slot_mask.shape))

    def _rebuild_counts(self, z: torch.Tensor):
        """z in this sampler's layout becomes the state's z, with its
        counts recounted."""
        st = self.state
        nkw = self._merge_nkw(self._count_nkw(z))
        st.z, st.nkw, st.ndk = z, nkw, self._merge_ndk(self._count_ndk(z))
        st.nk = self._nk(nkw)

    def set_z_indicators(self, z_flat):
        """Rebuild counts from imported z and redraw phi through the
        scheme's own initial draw (setZIndicators,
        UncollapsedParallelLDA.java:1797-1843)."""
        self._rebuild_counts(torch.as_tensor(self._z_from_flat(z_flat),
                                             device=self.device))
        self.state.phi = self._initial_phi(self.state.nkw, self.state.beta)

    def swap_corpus_tokens(self, corpus: Corpus):
        """Replace the training tokens with a same-shape corpus, keeping
        the chain's latents: z carries over by canonical token index,
        counts are rebuilt for the new tokens, and phi, theta and the
        generator's state are preserved (set_z_indicators' phi redraw is
        undone). The data-replication step of a Geweke ("getting it
        right") chain, as the JAX package's `swap_corpus_tokens`."""
        if self.corpus is None:
            raise RuntimeError("call add_instances first")
        if (corpus.num_docs, corpus.num_tokens, corpus.num_types) != (
                self.corpus.num_docs, self.corpus.num_tokens,
                self.corpus.num_types):
            raise ValueError("swap_corpus_tokens needs a corpus of the "
                             "same documents, tokens and types")
        z = self.get_z_indicators()
        st = self.state
        phi, theta = st.phi, st.theta
        rng_state = self.generator.get_state()
        self.corpus = corpus
        self._prepare_device_data(corpus)
        self.set_z_indicators(z)
        st.phi, st.theta = phi, theta
        self.generator.set_state(rng_state)
        return self

    def _count_nkw(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _count_ndk(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # checkpoint / resume, in the JAX package's npz format
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        """z in canonical token order plus the state tensors, as the JAX
        package writes them."""
        np.savez(path, **self._checkpoint_arrays())

    def _checkpoint_arrays(self) -> dict:
        """The checkpoint's arrays. Its `key` field, which the port has no
        use for, holds seed and iteration so that the JAX package can load
        the file."""
        st = self.state
        nwords = 4 if self.config.prng_impl == "rbg" else 2
        key = np.zeros(nwords, np.uint32)
        key[0] = self.config.effective_seed() & 0xFFFFFFFF
        key[1] = st.iteration
        return dict(z=self.get_z_indicators(), ndk=_np(st.ndk),
                    nkw=_np(st.nkw), nk=_np(st.nk), phi=_np(st.phi),
                    theta=(_np(st.theta) if st.theta is not None
                           else np.zeros(0)),
                    alpha=_np(st.alpha), beta=np.float32(st.beta),
                    iteration=np.int32(st.iteration), key=key)

    def state_from_numpy(self, arrays: dict) -> LDAState:
        """An LDAState on this sampler's device from numpy arrays in the
        checkpoint format (z in canonical token order [N]; nkw and phi in
        this scheme's orientation). The counts are recounted from z with
        the port's own kernels, and a mismatch raises ValueError."""
        if self.corpus is None:
            raise RuntimeError("call add_instances first")
        dev = self.device
        z = torch.as_tensor(self._z_from_flat(np.asarray(arrays["z"])),
                            device=dev)
        state = LDAState(
            z=z,
            ndk=torch.as_tensor(np.asarray(arrays["ndk"], np.int32),
                                device=dev),
            nkw=torch.as_tensor(np.asarray(arrays["nkw"], np.int32),
                                device=dev),
            nk=torch.as_tensor(np.asarray(arrays["nk"], np.int32),
                               device=dev),
            phi=torch.as_tensor(np.asarray(arrays["phi"], np.float32),
                                device=dev),
            theta=(torch.as_tensor(np.asarray(arrays["theta"], np.float32),
                                   device=dev)
                   if np.asarray(arrays["theta"]).size else None),
            alpha=torch.as_tensor(np.asarray(arrays["alpha"], np.float32),
                                  device=dev).reshape(-1).expand(
                                      self.config.topics).contiguous(),
            beta=float(np.asarray(arrays["beta"])),
            iteration=int(np.asarray(arrays["iteration"])))
        for name, recount in (("nkw", self._merge_nkw(self._count_nkw(z))),
                              ("ndk", self._merge_ndk(self._count_ndk(z)))):
            if not torch.equal(recount, getattr(state, name)):
                raise ValueError(f"checkpoint {name} does not match a "
                                 "recount of its z")
        if not torch.equal(self._nk(state.nkw), state.nk):
            raise ValueError("checkpoint nk does not match its nkw")
        return state

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint written by this package's or the JAX
        package's `save_checkpoint` (after `add_instances` on the same
        corpus). The JAX PRNG key in the file is ignored: the port's
        generator is reseeded from `cfg.seed` and the checkpoint's
        iteration, so a resumed chain is reproducible but does not replay
        the JAX chain's draws."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as d:
            self.state = self.state_from_numpy(self._arrays_from_file(dict(d)))
        self._reseed(self.config.effective_seed() * 1_000_003
                     + self.state.iteration)
        return self

    def _arrays_from_file(self, arrays: dict) -> dict:
        """A checkpoint file's arrays as `state_from_numpy` takes them."""
        return arrays

    def _reseed(self, seed: int):
        self.generator.manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)


class FlatLayoutMixin:
    """z in canonical token order, the JAX package's "flat" layout
    (`models/base.py:177-183`), for the serial collapsed oracle: one slot
    per token, every slot real. Mixed in before TorchLDASampler."""

    def _prepare_device_data(self, corpus: Corpus):
        n = corpus.num_tokens
        self._flat_index = np.arange(n, dtype=np.int64)
        self._slot_mask = torch.ones(n, dtype=torch.bool, device=self.device)
        self._slot_w = torch.as_tensor(corpus.tokens.astype(np.int64),
                                       device=self.device)
        self._slot_d = torch.as_tensor(
            corpus.token_doc_ids().astype(np.int64), device=self.device)

    def _count_nkw(self, z):
        return topic_word_counts(z, self._slot_w, self._slot_mask,
                                 self.config.topics, self.corpus.num_types)

    def _count_ndk(self, z):
        return doc_topic_counts(z, self._slot_d, self._slot_mask,
                                self.corpus.num_docs, self.config.topics)
