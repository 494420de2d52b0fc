"""Polya-Urn LDA (Terenin et al. 2018), scheme `polyaurn`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/polyaurn.py`.
Reference: topics/PolyaUrnSpaliasLDA.java — phi rows are normalised Poisson
counts c_kw ~ Poisson(beta + n_kw) (types/PolyaUrnDirichlet.java:23-48),
so phi has exact zeros wherever the draw is zero, and the z-step proposes
only topics with phi > 0 (sparse alias tables over the support, :67-70,
180). Here phi is one whole-matrix Polya-Urn draw (`ops/random.py::
polya_urn_dirichlet`: on the card the kernel of csrc/polya_urn.cu, two
launches; on the CPU `torch.poisson` from the generator), and the PCGS
sweep kernel gives a zero-phi topic exactly zero probability: with
`fused_positive_support = False` it clamps each draw to the last topic
whose mass is nonzero.
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.models.pcgs import (
    UncollapsedParallelLDA)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

_EPS = 1e-30


def keep_unmasked_columns(phi, type_mask, prev_phi):
    """The sparse-phi schemes' partial update (JAX `polyaurn.py:43-48`):
    the columns outside `type_mask` take the previous draw's values, then
    every row is renormalised. `type_mask = None` keeps the fresh draw."""
    if type_mask is None:
        return phi
    phi = torch.where(type_mask[None, :], phi, prev_phi)
    return phi / phi.sum(dim=-1, keepdim=True).clamp_min(_EPS)


class PolyaUrnSpaliasLDA(UncollapsedParallelLDA):
    smooth_phi = True
    # Polya-Urn phi has exact-zero atoms: the last-nonzero clamp must be
    # computed, not assumed
    fused_positive_support = False

    def _sample_phi(self, nkw, beta, type_mask=None, prev_phi=None):
        phi, _zero = rnd.polya_urn_dirichlet(nkw, float(self.config.beta),
                                             self.generator, zero_mask=False)
        return keep_unmasked_columns(phi, type_mask, prev_phi)

    _initial_phi = _sample_phi

    def get_phi_density(self) -> float:
        """Phi sparsity diagnostic (`log_phi_density`,
        LDAUtils.calculatePhiDensity:1754): the share of nonzero phi
        entries."""
        return float((np.asarray(self.get_phi()) > 0).mean())
