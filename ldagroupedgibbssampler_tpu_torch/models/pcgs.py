"""PCGS family: the uncollapsed / partially-collapsed parallel samplers.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/pcgs.py`.
Reference classes:
  - `UncollapsedParallelLDA` (topics/UncollapsedParallelLDA.java, scheme
    `uncollapsed`): z-draws score (n_dk + alpha_k) * phi[k][w] with phi
    fixed within the sweep (:1509-1513) and n_dk updated per token; phi
    rows then redrawn Dir(n_k) without beta smoothing (:1306-1316, flagged
    incorrect at :1313-1315 but kept for experiment parity).
  - `LDAPartiallyCollapsedGibbsSampler` (scheme `pcgs`,
    topics/LDAPartiallyCollapsedGibbsSampler.java:95-118): the same z-step,
    phi ~ Dir(beta + n_k).
  - `EfficientUncollapsedParallelLDA` (scheme `efficient_uncollapsed`,
    topics/EfficientUncollapsedParallelLDA.java:86-100): the same chain as
    `uncollapsed`; its two-ended cumsum scan is a JVM micro-optimisation.

One iteration: the sweep kernel (models/fused_sweep.py, csrc/pcgs.cu)
draws every token's z with in-sweep n_dk updates and counts N_kw, then phi
rows are whole-matrix Dirichlet draws (ops/random.py). State is kept in the
reference's orientation: nkw and phi are [K, V] (`nkw_layout = "kv"`).
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.models.base import (LDAState,
                                                          TorchLDASampler)
from ldagroupedgibbssampler_tpu_torch.models.fused_sweep import (
    FusedPCGSSweepMixin)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd


class UncollapsedParallelLDA(FusedPCGSSweepMixin, TorchLDASampler):
    """Scheme `uncollapsed`: PCGS engine with the historical unsmoothed
    phi ~ Dir(n_k) draw."""

    nkw_layout = "kv"
    smooth_phi = False
    # phi rows are floored Dirichlet draws and alpha > 0, so the
    # conditional is positive for every topic
    fused_positive_support = True

    def _sample_phi(self, nkw, beta, type_mask=None, prev_phi=None):
        """phi | z, w. `prev_phi` is the phi the sweep just used: a type
        mask redraws only its columns by the conditional Dirichlet, and
        nzvsspalias's draw depends on it."""
        prior = beta if self.smooth_phi else 1e-7
        if type_mask is None:
            return rnd.dirichlet(nkw, self.shared_generator, prior=prior)
        conc = nkw.to(torch.float32) + prior
        return rnd.conditional_dirichlet(prev_phi, conc, type_mask,
                                         self.shared_generator)

    def _step(self, state: LDAState, doc_mask, type_mask=None):
        """One iteration, replacing the fields of `state` in place."""
        z, ndk, nkw = self._fused_zsweep(state.z, state.ndk, state.alpha,
                                         state.phi.T.contiguous(), doc_mask)
        nkw = self._merge_nkw(nkw)
        state.z, state.ndk, state.nkw = z, ndk, nkw
        state.nk = self._nk(nkw)
        state.phi = self._sample_phi(nkw, state.beta, type_mask, state.phi)
        state.iteration += 1


class LDAPartiallyCollapsedGibbsSampler(UncollapsedParallelLDA):
    """Scheme `pcgs`: proper beta-smoothed phi
    (LDAPartiallyCollapsedGibbsSampler.java:95-118)."""

    smooth_phi = True


class EfficientUncollapsedParallelLDA(UncollapsedParallelLDA):
    """Scheme `efficient_uncollapsed`: same chain as `uncollapsed`
    (EfficientUncollapsedParallelLDA.java:10 is a draw-mechanism
    micro-optimisation only)."""
