"""LightLDA-style Metropolis-Hastings samplers: schemes `lightpclda`,
`lightpcldaw2`, `lightcollapsed`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/lightlda.py`.
Reference classes:
  - `LightPCLDA` (topics/LightPCLDA.java): MH z-draws against uncollapsed
    phi, word proposal q_w(k) ∝ phi[k][w] (:50-70), then a doc proposal;
    phi ~ Dir(beta + N_kw) after the sweep.
  - `LightPCLDAtypeTopicProposal` (topics/LightPCLDAtypeTopicProposal.java
    :23-53): the word proposal from the sweep-entry type-topic counts,
    N_kw + beta.
  - `CollapsedLightLDA` (topics/CollapsedLightLDA.java): the collapsed
    target with sweep-stale global counts, (beta + N_kw) / (V beta + n_k)
    as both word target and proposal; phi ~ Dir(N_kw + beta) is only a
    diagnostic draw.

One iteration: the MH sweep kernel (`ops/cuda_lightlda.py`,
`csrc/lightlda.cu`) runs two MH steps per token (word proposal, then the
doc proposal drawn from bf16(n_dk^-i + alpha)) with in-sweep n_dk updates
and counts N_kw; then the scheme's phi draw. The sweep takes the JAX
package's resident or streamed layout by its TPU budget rule with two word
tables (`models/fused_sweep.py`), so each document's tokens are visited in
the JAX kernel's order.

Where the JAX package has no fused MH sweep (its streamed budget is over
even at vspan 128, K ≳ 2000) it runs its XLA `lightlda_sweep`, whose doc
proposal is the LightLDA mixture (a random token of the document or an
alpha draw) and whose word proposal is a Gumbel-max draw. The port has no
such fallback: it runs the kernel on the streamed layout at vspan 128.
That chain is a different MH transition with the same target.
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.models.base import LDAState
from ldagroupedgibbssampler_tpu_torch.models.pcgs import UncollapsedParallelLDA
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd


class LightPCLDA(UncollapsedParallelLDA):
    """Scheme `lightpclda`: PC target, word proposal from phi."""

    smooth_phi = True
    # the JAX streamed MH kernel buffers two bf16 word tables (target +
    # proposal, pallas_lightlda.py:446-447): the layout rule counts both
    _streamed_word_tables = 2

    def _word_tables(self, state: LDAState):
        """Linear-space [V, K] word target and proposal tables."""
        phi_vk = state.phi.T.contiguous()
        return phi_vk, phi_vk

    def _step(self, state: LDAState, doc_mask, type_mask=None):
        """One iteration, replacing the fields of `state` in place."""
        tw, qw = self._word_tables(state)
        z, ndk, nkw = self._fused_zsweep(state.z, state.ndk, state.alpha,
                                         tw, doc_mask, proposal_vk=qw)
        state.z, state.ndk, state.nkw = z, ndk, nkw
        state.nk = self._nk(nkw)
        state.phi = self._sample_phi(nkw, state.beta, type_mask, state.phi)
        state.iteration += 1


class LightPCLDAtypeTopicProposal(LightPCLDA):
    """Scheme `lightpcldaw2`: PC target, word proposal from the sweep-entry
    type-topic counts N_kw + beta (LightPCLDAtypeTopicProposal.java
    :23-53)."""

    def _word_tables(self, state: LDAState):
        return (state.phi.T.contiguous(),
                (state.nkw.T.to(torch.float32) + state.beta).contiguous())


class CollapsedLightLDA(LightPCLDA):
    """Scheme `lightcollapsed`: collapsed target with the sweep-entry
    global counts (CollapsedLightLDA.java:737-817, the staleness contract
    of adlda), word proposal from the same counts. The kernel's N_kw is the
    per-sweep count merge; the inherited phi ~ Dir(N_kw + beta) is only a
    diagnostic draw of the collapsed chain."""

    def _sample_phi(self, nkw, beta, type_mask=None, prev_phi=None):
        """The collapsed chain's diagnostic phi draw, Dir(N_kw + beta),
        ignores a type mask, as the JAX package's does."""
        return rnd.dirichlet(nkw, self.generator, prior=beta)

    def _word_tables(self, state: LDAState):
        num_types = self.corpus.num_types
        tw = ((state.beta + state.nkw.T.to(torch.float32))
              / (state.beta * num_types
                 + state.nk.to(torch.float32))[None, :]).contiguous()
        return tw, tw
