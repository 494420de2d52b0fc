"""Polya-Urn LDA (Terenin et al. 2018), scheme `polyaurn`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/polyaurn.py`.
Reference: topics/PolyaUrnSpaliasLDA.java — phi rows are normalised Poisson
counts c_kw ~ Poisson(beta + n_kw) (types/PolyaUrnDirichlet.java:23-48),
so phi has exact zeros wherever the draw is zero, and the z-step proposes
only topics with phi > 0 (sparse alias tables over the support, :67-70,
180). Here phi is one whole-matrix `torch.poisson` draw, and the PCGS sweep
kernel gives a zero-phi topic exactly zero probability: with
`fused_positive_support = False` it clamps each draw to the last topic
whose mass is nonzero.
"""

from __future__ import annotations

import numpy as np

from ldagroupedgibbssampler_tpu_torch.models.pcgs import (
    UncollapsedParallelLDA)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd


class PolyaUrnSpaliasLDA(UncollapsedParallelLDA):
    smooth_phi = True
    # Polya-Urn phi has exact-zero atoms: the last-nonzero clamp must be
    # computed, not assumed
    fused_positive_support = False

    def _sample_phi(self, nkw, beta, prev_phi=None):
        phi, _zero = rnd.polya_urn_dirichlet(nkw, float(self.config.beta),
                                             self.generator)
        return phi

    _initial_phi = _sample_phi

    def get_phi_density(self) -> float:
        """Phi sparsity diagnostic (`log_phi_density`,
        LDAUtils.calculatePhiDensity:1754): the share of nonzero phi
        entries."""
        return float((np.asarray(self.get_phi()) > 0).mean())
