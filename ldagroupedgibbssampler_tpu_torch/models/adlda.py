"""ADLDA, Approximate Distributed LDA (Newman et al. 2009): scheme `adlda`.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/adlda.py`.
Reference: topics/ADLDA.java + topics/MyWorkerRunnable.java: the global
typeTopicCounts / tokensPerTopic are copied into per-thread replicas
(ADLDA.java:176-210), each worker runs a collapsed sweep over its document
shard against its increasingly stale replica, and the replicas are merged
and re-broadcast once per iteration (:302-332).

One iteration here is the collapsed live-count mode of the PCGS sweep
kernel (`models/fused_sweep.py`, `ops/cuda_pcgs.py`, csrc/pcgs.cu) on the
JAX package's resident or streamed layout: the conditional
(n_dk + alpha)(beta + N_kw - own)/(V beta + n_k - own) with the token's
own assignment excluded exactly; the kernel's N_kw output is the merge.
phi ~ Dir(N_kw + beta) is only a diagnostic draw of the collapsed chain.

Staleness contract. The reference's workers are stale across workers by up
to one whole sweep. The JAX package's TPU kernel keeps N_kw and n_k live
from one 128-token chunk to the next of its in-order grid, so its counts
are stale within a chunk. The port's kernel runs one warp per document in
parallel. It keeps N_kw live in global memory (each token reads its word's
row when it draws, each changed token updates it with atomics at once) and
V beta + n_k warp-local: each warp flushes its net moves into the global
V beta + n_k and reloads its own view at the start of every batch of at
most 32 of a document's tokens. So a draw's N_kw misses only the other
warps' moves in flight, and its n_k only the other warps' moves since its
batch began; its own moves are always in. All three are members of the
AD-LDA approximation family; the port's is not the TPU's chunk schedule,
and chip_smoke.py measures its likelihood gap to the sequential chain
(`_serial_sweep`, the one-warp launch, which is that chain bit for bit).
On a CPU device the sweep is the plain version, which is that sequential
chain: there `adlda` is the exact collapsed Gibbs sampler over the
layout's visit order.
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.models.base import (LDAState,
                                                          TorchLDASampler)
from ldagroupedgibbssampler_tpu_torch.models.fused_sweep import (
    FusedPCGSSweepMixin)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.counts import tokens_per_topic


class ADLDA(FusedPCGSSweepMixin, TorchLDASampler):
    nkw_layout = "kv"
    smooth_phi = True
    # the collapsed conditional is positive everywhere (alpha, beta > 0)
    fused_positive_support = True
    # the layout rule counts the live-count operands (JAX package's gate)
    _streamed_collapsed = True

    def _step(self, state: LDAState, doc_mask, type_mask=None):
        """One iteration, replacing the fields of `state` in place. The
        phi draw is only diagnostic and ignores a type mask, as the JAX
        package's does."""
        # V beta as f32(beta) * V rounded to f32, added as a host scalar:
        # no host-to-device copy, so the step can be captured
        v_beta = float(np.float32(state.beta)
                       * np.float32(self.corpus.num_types))
        nk_plus = state.nk.to(torch.float32) + v_beta
        z, ndk, nkw = self._fused_zsweep(
            state.z, state.ndk, state.alpha,
            state.nkw.T.to(torch.float32).contiguous(), doc_mask,
            nk_plus=nk_plus, beta=state.beta)
        nkw = self._merge_nkw(nkw, entry=state.nkw)
        state.z, state.ndk, state.nkw = z, ndk, nkw
        state.nk = tokens_per_topic(nkw)
        state.phi = rnd.dirichlet(nkw.to(torch.float32) + state.beta,
                                  self.shared_generator)
        state.iteration += 1
