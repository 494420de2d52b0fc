"""NZVS-Spalias: variable-selection (spike-and-slab) phi, scheme
`nzvsspalias`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/nzvs.py`.
Reference: topics/NZVSSpaliasUncollapsedParallelLDA.java: phi rows drawn by
`VSDirichlet.nextDistribution` (types/VSDirichlet.java), a zero-inflated
Dirichlet where zero-count coordinates enter the support only with their
posterior inclusion probability, which depends on how many coordinates of
the row were zero in the previous draw. Here `ops/random.py::vs_dirichlet`
draws the whole [K, V] matrix at once, and the sweep kernel gives the
excluded coordinates zero probability as it does for the Polya-Urn
sampler (`positive_support` off).
"""

from __future__ import annotations

from ldagroupedgibbssampler_tpu_torch.models.polyaurn import (
    PolyaUrnSpaliasLDA)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd


class NZVSSpaliasUncollapsedParallelLDA(PolyaUrnSpaliasLDA):
    vs_prior = 0.5
    # True: the reference's sequential zeroPhi chain (a Python loop over
    # the V columns), the parity knob of the Geweke tests; the chain runs
    # the vectorised form
    vs_sequential = False

    def _sample_phi(self, nkw, beta, prev_phi=None):
        """phi ~ VS-Dirichlet(N_k + beta) given the previous draw's zeros;
        `prev_phi=None` means a dense previous draw (zeroPhi = 0), the
        reference's bootstrap from its parent's dense init."""
        phi, _zero = rnd.vs_dirichlet(nkw, float(self.config.beta),
                                      self.vs_prior, self.generator,
                                      previous_phi=prev_phi,
                                      sequential=self.vs_sequential)
        return phi

    _initial_phi = _sample_phi
