"""Sampler base: chain state + the reference's run-lifecycle API.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/base.py`
(the subset that schemes `ggs` and the PCGS family need). The reference
defines `LDAGibbsSampler` (topics/LDAGibbsSampler.java:10-46) with
`addInstances / sample(iterations) / getters / lifecycle hooks`;
`TorchLDASampler` provides that surface with one lifecycle hook,
`post_iteration` (the HDP family's per-iteration statistics), and without
iteration listeners, which nothing here uses.

State is a mutable `LDAState` dataclass of tensors on the sampler's device.
Each scheme's `_step(state, doc_mask)` replaces its fields in place with
the next iteration's tensors. z lives in the scheme's block layout; the
layout's `flat_index` (corpus token index of each slot, -1 on padding)
translates it to and from the canonical token order. Random bits come from
one `torch.Generator` on the device, seeded from the config. The `sample()` loop mirrors
`UncollapsedParallelLDA.sample` (topics/UncollapsedParallelLDA.java:
552-943): wall-clock budget, abort flag / abort file, and the likelihood /
log-posterior series every `topic_interval` iterations.

Not ported yet (a config that asks for them raises in `add_instances`):
hyperparameter optimisation, topic index / topic batch random scan,
paranoid checks, timing traces, phi means, diagnostic dumps. Iteration
fusion (`scan_chunk`) is ignored: it never changed results.
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
from ldagroupedgibbssampler_tpu_torch.evaluation.likelihood import (
    log_posterior, model_log_likelihood)
from ldagroupedgibbssampler_tpu_torch.models import randomscan
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.counts import (
    doc_topic_counts, tokens_per_topic, topic_word_counts)
from ldagroupedgibbssampler_tpu_torch.utils.device import resolve_device


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


def unported_options(cfg: LDAConfig) -> list[str]:
    """Config keys set to a value the port does not implement yet."""
    batch = cfg.topic_batch_building_scheme
    checks = {
        "hyperparam_optim_interval": cfg.hyperparam_optim_interval > 0,
        "topic_index_building_scheme":
            cfg.topic_index_building_scheme != "all",
        "topic_batch_building_scheme":
            batch not in ("even", "percentage") or (
                batch == "percentage"
                and float(cfg.percentage_split_size_topic) < 1.0),
        "paranoid": cfg.paranoid,
        "measure_timing": cfg.measure_timing,
        "save_phi_means": cfg.save_phi_means,
        "compute_doc_topic_distances": cfg.compute_doc_topic_distances,
        "diagnostic_interval": bool(cfg.diagnostic_interval),
        "dn_diagnostic_interval": bool(cfg.dn_diagnostic_interval),
        "print_ndocs_interval": bool(cfg.print_ndocs_interval),
        "print_ntopwords_interval": bool(cfg.print_ntopwords_interval),
    }
    return [k for k, on in checks.items() if on]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


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

    def __init__(self, config: LDAConfig, logger=None):
        self.config = config
        self.logger = logger
        self.device = resolve_device(config.device)
        self.generator: Optional[torch.Generator] = None
        self.corpus: Optional[Corpus] = None
        self.state: Optional[LDAState] = None
        self._abort = False
        self._ll_history: list = []          # (iteration, ll)
        self.doc_batch_builder = None

    # ------------------------------------------------------------------
    # data loading (LDAGibbsSampler.addInstances)
    # ------------------------------------------------------------------
    def add_instances(self, corpus: Corpus):
        """Random z init + count build (ModifiedSimpleLDA.addInstances
        :939-969 draws each token's initial topic uniformly)."""
        cfg = self.config
        unported = unported_options(cfg)
        if unported:
            raise ValueError("not ported to ldagroupedgibbssampler_tpu_torch "
                             f"yet: config keys {unported}")
        self.corpus = corpus
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.effective_seed())
        self._prepare_device_data(corpus)
        self.state = self._init_state()
        self.doc_batch_builder = randomscan.make_document_batch_builder(
            cfg, corpus.num_docs)
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
        z = torch.randint(0, cfg.topics, self._slot_mask.shape,
                          generator=self.generator, device=self.device,
                          dtype=torch.int32)
        z = torch.where(self._slot_mask, z, 0)
        nkw = self._count_nkw(z)
        ndk = self._count_ndk(z)
        alpha = torch.full((cfg.topics,), cfg.alpha, dtype=torch.float32,
                           device=self.device)
        beta = float(cfg.beta)
        phi = self._initial_phi(nkw, beta)
        theta = self._initial_theta(ndk, alpha)
        return LDAState(z=z, ndk=ndk, nkw=nkw, nk=self._nk(nkw), phi=phi,
                        theta=theta, alpha=alpha, beta=beta, iteration=0)

    def _initial_phi(self, nkw, beta):
        """phi rows ~ Dir(n_k + beta), or Dir(n_k + 1e-3) for the
        unsmoothed schemes ([K, V] orientation)."""
        return rnd.dirichlet(nkw.to(torch.float32)
                             + (beta if self.smooth_phi else 0.0)
                             + (0.0 if self.smooth_phi else 1e-3),
                             self.generator)

    def _initial_theta(self, ndk, alpha):
        return None   # only GGS carries theta in state

    def _step(self, state: LDAState, doc_mask: Optional[torch.Tensor]):
        """One iteration, updating `state` in place. `doc_mask = None` is
        the full sweep (every document selected)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # main loop (UncollapsedParallelLDA.sample:552-943)
    # ------------------------------------------------------------------
    def sample(self, iterations: int | None = None):
        cfg = self.config
        iterations = iterations or cfg.iterations
        if self.state is None:
            raise RuntimeError("call add_instances first")
        deadline = time.time() + cfg.exec_time if cfg.exec_time > 0 else None
        start_iter = self.state.iteration
        for it in range(start_iter + 1, start_iter + iterations + 1):
            mask = self.doc_batch_builder.doc_mask(it)
            doc_mask = (None if mask.all()
                        else torch.as_tensor(mask, device=self.device))
            self._step(self.state, doc_mask)
            self._periodic_logging(it)
            self.post_iteration()
            # cooperative abort: flag or an `abort` file in the working
            # directory (UncollapsedParallelLDA.java:131,908-910)
            if self._abort or os.path.exists("abort"):
                break
            if deadline is not None and time.time() > deadline:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def post_iteration(self):
        """Lifecycle hook after every iteration's logging
        (LDAGibbsSampler.java:10-46); a no-op here."""

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

    def model_log_likelihood(self) -> float:
        st = self.state
        return float(model_log_likelihood(st.ndk, self._nkw_kv(), st.alpha,
                                          st.beta))

    def _periodic_logging(self, it: int):
        cfg = self.config
        interval = cfg.topic_interval
        if interval is None or interval <= 0 or it % interval != 0:
            return
        st = self.state
        if cfg.compute_likelihood:
            ll = self.model_log_likelihood()
            self._ll_history.append((it, ll))
            if self.logger:
                self.logger.log_likelihood(it, ll)
        if self.logger is None:
            return
        if cfg.start_diagnostic > 0 and it >= cfg.start_diagnostic:
            theta = (st.theta if st.theta is not None
                     else torch.as_tensor(self.get_theta_estimate()))
            lp = float(log_posterior(st.ndk, self._nkw_kv(), theta,
                                     self._phi_kv(), st.alpha, st.beta))
            self.logger.log_posterior(it, lp)
        if cfg.log_tokens_per_topic:
            self.logger.log_tokens_per_topic(_np(st.nk))

    # ------------------------------------------------------------------
    # accessors (LDAGibbsSampler / LDASamplerWithPhi getters)
    # ------------------------------------------------------------------
    def abort(self):
        self._abort = True

    def get_phi(self) -> np.ndarray:
        """phi in the reference's [K, V] orientation."""
        return _np(self._phi_kv())

    def get_topic_type_counts(self) -> np.ndarray:
        """K×V counts (topicTypeCountMapping)."""
        return _np(self._nkw_kv())

    def get_document_topic_matrix(self) -> np.ndarray:
        return _np(self.state.ndk)

    def get_tokens_per_topic(self) -> np.ndarray:
        return _np(self.state.nk)

    def get_alpha(self) -> np.ndarray:
        return _np(self.state.alpha)

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

    def set_z_indicators(self, z_flat):
        """Rebuild counts from imported z and redraw phi through the
        scheme's own initial draw (setZIndicators,
        UncollapsedParallelLDA.java:1797-1843)."""
        st = self.state
        z = torch.as_tensor(self._z_from_flat(z_flat), device=self.device)
        nkw = self._count_nkw(z)
        st.z, st.nkw, st.ndk = z, nkw, self._count_ndk(z)
        st.nk = self._nk(nkw)
        st.phi = self._initial_phi(nkw, st.beta)

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
        for name, recount in (("nkw", self._count_nkw(z)),
                              ("ndk", self._count_ndk(z))):
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
            self.state = self.state_from_numpy(dict(d))
        self.generator.manual_seed(
            (self.config.effective_seed() * 1_000_003 + self.state.iteration)
            & 0x7FFF_FFFF_FFFF_FFFF)
        return self


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
