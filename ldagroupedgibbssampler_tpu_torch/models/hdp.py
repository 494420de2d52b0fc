"""HDP-LDA family: schemes `ppu_hdplda`, `ppu_hlda`,
`ppu_hdplda_all_topics`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/hdp.py`.
Reference classes:
  - `PoissonPolyaUrnHDPLDA` (topics/PoissonPolyaUrnHDPLDA.java): HDP-LDA
    with Poisson Polya-Urn phi and a dynamic active-topic set: two psi
    samplers (PoissonBasedPsiSampler :342-400, GEMBasedPsiSampler
    :402-500), a Gamma prior over new-topic indices (UniformGamma /
    GeometricGamma :505-563), topic birth and death in postZ (:565-625),
    Antoniak table draws (sampleL, :1112-).
  - `PoissonPolyaUrnHDPLDAInfiniteTopics`: the same model over all K_max
    topics, no birth or death, a GEM psi over all K_max sticks
    (:211-280).
  - `PoissonPolyaUrnHLDA`: grows the topic count contiguously
    (`newNumTopics = activeInData + Poisson(gamma)`, :300), always the
    Poisson psi, and its Antoniak draw uses the concentration gamma, not
    alpha * psi_k (sampleL :871-894).

All three keep a fixed [K_max] state and an `active` mask; the
reference's re-compaction of the topic array is a memory optimisation that
does not change the chain. One iteration:

  1. z-sweep: the PCGS sweep kernel (csrc/pcgs.cu, `positive_support`
     off) with alpha_k = alpha0 * psi_k * active_k: the HDP conditional
     (n_dk + alpha0 psi_k) phi_kw is the PCGS conditional with that alpha
     vector. Inactive topics have alpha_k = 0 and zero phi rows, so they
     get exactly zero probability;
  2. table counts l_k = sum_j Binomial(D(j, k), a_k / (a_k + j - 1)), with
     D(j, k) = #docs with n_dk >= j from a [K, M] histogram of n_dk;
  3. birth and death (ppu_hdplda, ppu_hlda): empty topics die, n_add ~
     Poisson(gamma) new indices are born (drawn from the index prior for
     hdplda, the lowest inactive ones for hlda);
  4. psi: the GEM stick-breaking posterior or the Poisson sufficient
     statistics, per `hdp_psi_sampler`;
  5. phi: Polya-Urn rows (normalised Poisson(beta + n_kw)); inactive rows
     zeroed.

Nothing in `_step` reads a value back to the host; `post_iteration` reads
n_k once an iteration for the active-topic statistics, as the JAX class
does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.models.base import (LDAState,
                                                          TorchLDASampler,
                                                          _np)
from ldagroupedgibbssampler_tpu_torch.models.fused_sweep import (
    FusedPCGSSweepMixin)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

_EPS = 1e-30


@dataclass
class HDPState(LDAState):
    """LDAState plus the HDP latents:

      psi    <- [K_max] f32 global topic proportions
      tables <- [K_max] f32 the last Antoniak table counts l_k
      active <- [K_max] bool active-topic mask

    `alpha` is the effective prior alpha0 * psi * active; theta is None.
    """
    psi: torch.Tensor
    tables: torch.Tensor
    active: torch.Tensor


def doc_count_ge_histogram(ndk, max_count: int) -> torch.Tensor:
    """D(j, k) = #docs with n_dk >= j for j = 1..max_count, as int32
    [K, M]: the reverse cumulative sum of a per-topic histogram of the n_dk
    values (DocTopicTokenFreqTable.java:130-150)."""
    _d, k = ndk.shape
    clipped = ndk.clamp(0, max_count).to(torch.int64)
    flat = (torch.arange(k, device=ndk.device)[None, :] * (max_count + 1)
            + clipped).reshape(-1)
    hist = torch.bincount(flat, minlength=k * (max_count + 1))
    hist = hist.reshape(k, max_count + 1)
    ge_all = hist.flip(1).cumsum(dim=1).flip(1)
    return ge_all[:, 1:].to(torch.int32)


def sample_table_counts(ndk, a, max_count: int,
                        generator: torch.Generator) -> torch.Tensor:
    """l_k = sum_j Binomial(#docs with n_dk >= j, a_k / (a_k + j - 1)),
    f32 [K] (DocTopicTokenFreqTable + sampleL,
    PoissonPolyaUrnHDPLDA.java:1112-1160; at j = 1 with a_k = 0 the
    probability is 1, as written). `a` is alpha0 * psi_k (hdplda) or the
    concentration gamma on every topic (hlda). `max_count` may exceed the
    longest document: a j beyond every n_dk draws Binomial(0, p) = 0."""
    j = torch.arange(1, max_count + 1, dtype=torch.float32,
                     device=ndk.device)
    ge = doc_count_ge_histogram(ndk, max_count)
    a = torch.as_tensor(a).to(torch.float32)
    denom = a[:, None] + j[None, :] - 1.0
    p = torch.where(denom > 0, a[:, None] / denom.clamp_min(_EPS), 1.0)
    return rnd.binomial(ge, p.clamp(0.0, 1.0), generator).sum(dim=1)


def calc_k(percentile: float, tokens_per_topic) -> int:
    """Number of largest topics whose cumulative share of the token mass
    first exceeds `percentile` (config key `hdp_k_percentile`;
    PoissonPolyaUrnHDPLDAInfiniteTopics.java:335-359, with its
    first-index-exceeding convention: the index j, not j + 1)."""
    alloc = np.sort(np.asarray(tokens_per_topic))[::-1]
    if alloc.size == 0:
        return 0
    ecdf = np.cumsum(alloc)
    total = max(float(ecdf[-1]), 1.0)
    idx = np.nonzero(ecdf / total > percentile)[0]
    return int(idx[0]) if idx.size else int(alloc.size)


def gem_psi(tables, gamma: float, generator: torch.Generator):
    """Stick-breaking psi from the GEM posterior given the table counts
    (GEMBasedPsiSampler, PoissonPolyaUrnHDPLDA.java:402-500):
    nu_k ~ Beta(1 + l_k, gamma + sum_{j>k} l_j), psi_k = nu_k
    prod_{i<k} (1 - nu_i), normalised. Topics with l_k = 0 get the
    Beta(1, gamma + rest) residual mass (the GEM sampler ignores births).
    `tables` is [..., K]; each row draws its own psi."""
    rest = tables.flip(-1).cumsum(dim=-1).flip(-1) - tables
    b = rnd.beta(1.0 + tables, gamma + rest.clamp_min(0.0) + _EPS,
                 generator).clamp(1e-7, 1.0 - 1e-7)
    log1m = torch.log1p(-b)
    log_remain = torch.cumsum(log1m, dim=-1) - log1m   # sum over i < k
    psi = torch.exp(torch.log(b) + log_remain)
    return psi / psi.sum(dim=-1, keepdim=True)


def poisson_psi(tables, births, generator: torch.Generator):
    """Poisson psi (PoissonBasedPsiSampler, PoissonPolyaUrnHDPLDA.java:
    342-400): eta_k ~ Poisson(l_k) plus the birth increments (:620-624),
    psi = eta / sum(eta); uniform if every eta is 0. `tables` is [..., K]."""
    eta = rnd.poisson(tables, generator) + births.to(torch.float32)
    total = eta.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, eta / total.clamp_min(1.0),
                       1.0 / eta.shape[-1])


def sample_birth_candidates(gamma: float, k_max: int, budget: int,
                            dist: str, generator: torch.Generator,
                            device) -> torch.Tensor:
    """The postZ topic-birth candidates (PoissonPolyaUrnHDPLDA.java:
    580-586): n_add ~ Poisson(gamma) index draws from the Gamma prior.

    Returns births int32 [K_max], how many draws landed on each index (the
    psi increments); a topic is (re)born iff births > 0. n_add stays on
    the device and is truncated to `budget` draws. `dist` is "geometric"
    (GeometricGamma(1/(1+gamma)), :111; indices past K_max clip to the
    last) or "uniform" (UniformGamma, :510-520)."""
    if dist not in ("geometric", "uniform"):
        raise ValueError(f"unknown hdp_gamma_dist {dist!r}")
    n_add = rnd.poisson(torch.full((), gamma, device=device), generator)
    if dist == "uniform":
        cand = torch.randint(0, k_max, (budget,), generator=generator,
                             device=device)
    else:
        p = 1.0 / (1.0 + gamma)
        u = torch.rand(budget, generator=generator,
                       device=device).clamp_min(1e-12)
        cand = torch.floor(torch.log(u) / np.log1p(-p)).to(
            torch.int64).clamp(0, k_max - 1)
    valid = (torch.arange(budget, device=device) < n_add).to(torch.int32)
    return torch.zeros(k_max, dtype=torch.int32, device=device).index_add_(
        0, cand, valid)


class PoissonPolyaUrnHDPLDAInfiniteTopics(FusedPCGSSweepMixin,
                                          TorchLDASampler):
    """Scheme `ppu_hdplda_all_topics`: no active mask and no birth or
    death; all K_max sticks carry GEM mass
    (PoissonPolyaUrnHDPLDAInfiniteTopics.java:211-280)."""

    nkw_layout = "kv"
    smooth_phi = True
    # inactive topics and Polya-Urn phi carry exact zeros
    fused_positive_support = False
    # birth and death (postZ, PoissonPolyaUrnHDPLDA.java:565-625)
    use_active_mask = False

    def __init__(self, config, logger=None):
        super().__init__(config, logger=logger)
        self.active_topic_history: list[int] = []
        self.k_percentile_history: list[int] = []
        self.topic_occurrence_count = None

    # -- knobs the subclasses override -------------------------------------
    def _psi_sampler_name(self) -> str:
        return "gem"          # …InfiniteTopics.java:83

    def _table_concentration(self, state: HDPState):
        return state.alpha    # alphaCoef * psi_k (…InfiniteTopics.java:396)

    # -- state -------------------------------------------------------------
    def _prepare_device_data(self, corpus):
        super()._prepare_device_data(corpus)
        # the table counts' j range: the longest document
        self._max_count = max(1, int(corpus.doc_lengths().max()))

    def _init_state(self) -> HDPState:
        """The base draw (uniform z, phi ~ Dir(N_kw + beta) from its
        counts), then z reset to z % start and recounted; phi stays the
        draw from the uniform z, as in the JAX package."""
        base = super()._init_state()
        cfg, dev = self.config, self.device
        k_max = cfg.topics
        start = max(1, min(cfg.hdp_start_topics, k_max))
        topics = torch.arange(k_max, device=dev)
        if self.use_active_mask:
            # psi[i] = 1/nrStartTopics on the start topics
            # (PoissonPolyaUrnHDPLDA.java:105-108)
            active = topics < start
            psi = torch.where(active, 1.0 / start, 0.0)
        else:
            # a GEM prior draw over all sticks (…InfiniteTopics.java:223-227)
            active = torch.ones(k_max, dtype=torch.bool, device=dev)
            psi = gem_psi(torch.zeros(k_max, device=dev), cfg.hdp_gamma,
                          self.generator)
        # initial z uniform over the start set (initialDrawTopicIndicator,
        # PoissonPolyaUrnHDPLDA.java:142)
        z = torch.where(self._slot_mask, base.z % start, 0)
        nkw = self._count_nkw(z)
        return HDPState(z=z, ndk=self._count_ndk(z), nkw=nkw,
                        nk=self._nk(nkw), phi=base.phi, theta=None,
                        alpha=float(cfg.alpha) * psi * active, beta=base.beta,
                        iteration=0, psi=psi,
                        tables=torch.zeros(k_max, device=dev), active=active)

    # -- birth and death -----------------------------------------------------
    def _update_active(self, state: HDPState, nk):
        """postZ: empty topics die (updateNrActiveTopics :630-638), births
        from the Gamma prior. Returns (active, births)."""
        cfg = self.config
        births = sample_birth_candidates(
            cfg.hdp_gamma, cfg.topics, cfg.hdp_birth_budget,
            cfg.hdp_gamma_dist, self.generator, self.device)
        return (state.active & (nk > 0)) | (births > 0), births

    # -- iteration -----------------------------------------------------------
    def _step(self, state: HDPState, doc_mask):
        """One iteration, replacing the fields of `state` in place."""
        cfg = self.config
        z, ndk, nkw = self._fused_zsweep(state.z, state.ndk, state.alpha,
                                         state.phi.T.contiguous(), doc_mask)
        nk = self._nk(nkw)
        tables = sample_table_counts(ndk, self._table_concentration(state),
                                     self._max_count, self.generator)
        if self.use_active_mask:
            active, births = self._update_active(state, nk)
        else:
            active = state.active
            births = torch.zeros(cfg.topics, dtype=torch.int32,
                                 device=self.device)
        if self._psi_sampler_name() == "poisson":
            psi = poisson_psi(tables, births, self.generator)
        else:
            psi = gem_psi(tables, cfg.hdp_gamma, self.generator)
        # Polya-Urn phi; inactive rows zeroed (PoissonPolyaUrnHLDA.java:
        # 810-819)
        phi, _zero = rnd.polya_urn_dirichlet(nkw, float(cfg.beta),
                                             self.generator)
        if self.use_active_mask:
            phi = phi * active[:, None]
        state.z, state.ndk, state.nkw, state.nk = z, ndk, nkw, nk
        state.phi, state.psi, state.tables, state.active = (phi, psi,
                                                            tables, active)
        state.alpha = float(cfg.alpha) * psi * active
        state.iteration += 1

    # -- HDPSamplerWithPhi extras (topics/HDPSamplerWithPhi.java:5-10) -------
    def post_iteration(self):
        nk = _np(self.state.nk)
        if self.use_active_mask:
            active = int(_np(self.state.active).sum())
        else:
            active = int((nk > 0).sum())
        self.active_topic_history.append(active)
        self.k_percentile_history.append(
            calc_k(self.config.hdp_k_percentile, nk))
        occ = (nk > 0).astype(np.int64)
        self.topic_occurrence_count = (
            occ if self.topic_occurrence_count is None
            else self.topic_occurrence_count + occ)

    def get_active_topic_history(self) -> list[int]:
        return list(self.active_topic_history)

    def get_k_percentile_history(self) -> list[int]:
        """Per-iteration calc_k statistic: the number of largest topics
        covering `hdp_k_percentile` of the token mass
        (PoissonPolyaUrnHDPLDAInfiniteTopics.java:322-323, 335-359)."""
        return list(self.k_percentile_history)

    def get_topic_occurrence_count(self):
        return self.topic_occurrence_count

    def get_psi(self) -> np.ndarray:
        return _np(self.state.psi)

    def get_active_mask(self) -> np.ndarray:
        return _np(self.state.active)

    # -- checkpoints, in the JAX package's HDP format (no theta) -------------
    def _checkpoint_arrays(self) -> dict:
        """The JAX HDP class's format: no theta, plus psi, tables and
        active."""
        arrays = super()._checkpoint_arrays()
        del arrays["theta"]
        st = self.state
        return {**arrays, "psi": _np(st.psi), "tables": _np(st.tables),
                "active": _np(st.active)}

    def state_from_numpy(self, arrays: dict) -> HDPState:
        """The base's checked state (counts recounted from z) plus psi,
        tables and active (all active where the file has no mask, as the
        JAX loader does)."""
        base = super().state_from_numpy({**arrays, "theta": np.zeros(0)})
        dev = self.device
        psi = np.asarray(arrays["psi"], np.float32)
        active = (np.asarray(arrays["active"], bool) if "active" in arrays
                  else np.ones(psi.shape, bool))
        return HDPState(**vars(base), psi=torch.as_tensor(psi, device=dev),
                        tables=torch.as_tensor(
                            np.asarray(arrays["tables"], np.float32),
                            device=dev),
                        active=torch.as_tensor(active, device=dev))


class PoissonPolyaUrnHDPLDA(PoissonPolyaUrnHDPLDAInfiniteTopics):
    """Scheme `ppu_hdplda` (PoissonPolyaUrnHDPLDA.java:44): empty topics
    die, n_add ~ Poisson(gamma) new indices are drawn from the index prior
    (geometric by default, :111), and the psi sampler is `hdp_psi_sampler`
    (GEM by default, :116; Poisson :115/342-400)."""

    use_active_mask = True

    def _psi_sampler_name(self) -> str:
        return self.config.hdp_psi_sampler


class PoissonPolyaUrnHLDA(PoissonPolyaUrnHDPLDAInfiniteTopics):
    """Scheme `ppu_hlda` (PoissonPolyaUrnHLDA.java:54): the topic count
    grows contiguously (`newNumTopics = activeInData + Poisson(gamma)`,
    :300: new topics take the lowest inactive indices), psi is always the
    Poisson one (:221-225/846), and the Antoniak draw uses the
    concentration gamma (sampleL :871-894). A born slot gets one
    pseudo-table (eta += 1), so it carries psi mass into the next sweep
    (the reference's psi[i] = 1 init, :108-110)."""

    use_active_mask = True

    def _psi_sampler_name(self) -> str:
        return "poisson"

    def _table_concentration(self, state: HDPState):
        return torch.full((self.config.topics,), self.config.hdp_gamma,
                          dtype=torch.float32, device=self.device)

    def _update_active(self, state: HDPState, nk):
        cfg = self.config
        n_add = rnd.poisson(torch.full((), cfg.hdp_gamma,
                                       device=self.device),
                            self.generator).clamp_max(cfg.hdp_birth_budget)
        in_data = state.active & (nk > 0)
        # rank the inactive slots by index; the n_add lowest are born
        inactive_rank = torch.cumsum(~in_data, dim=0) - 1
        births = ~in_data & (inactive_rank < n_add)
        return in_data | births, births.to(torch.int32)
