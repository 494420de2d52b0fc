"""Spalias — sparse partially-collapsed LDA (Magnusson et al.), scheme
`spalias`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/spalias.py`.
The reference (topics/SpaliasUncollapsedParallelLDA.java) splits the PCGS
conditional (n_dk + alpha_k) phi[k][w] into a sparse document part and a
prior part drawn from per-type Walker alias tables (:39-115, :277-293).
That decomposition saves a scalar CPU core O(K) work per token; the chain
it samples is the PCGS chain (phi fixed within the sweep, n_dk updated per
token), which the port draws with the dense sweep kernel, as the JAX
package does.
"""

from __future__ import annotations

from ldagroupedgibbssampler_tpu_torch.models.pcgs import (
    LDAPartiallyCollapsedGibbsSampler)


class SpaliasUncollapsedParallelLDA(LDAPartiallyCollapsedGibbsSampler):
    """Same Markov chain as PCGS; see the module docstring."""
