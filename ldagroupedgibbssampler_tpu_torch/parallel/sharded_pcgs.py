"""Sharded PCGS: documents sharded, phi replicated, one merge per sweep
(schemes `sharded_pcgs` and `sharded_uncollapsed`).

The port's counterpart of `ldagroupedgibbssampler_tpu/parallel/
sharded_pcgs.py`. Documents are conditionally independent given phi, so
sharding them is exact: each rank runs the single-device PCGS sweep (the
PCGS mode of the sweep kernel, `ops/cuda_pcgs.py`, csrc/pcgs.cu, on the
layout the single-device rule picks for its documents) over its own
documents against the replicated phi, with n_dk live within the sweep;
then one all-reduce of N_kw, and phi ~ Dir(beta + n_k) redrawn
identically on every rank from the merged counts. Per rank this is the
JAX package's `doc_sequential_sweep` without its `self_correction`.
"""

from __future__ import annotations

from ldagroupedgibbssampler_tpu_torch.models.pcgs import (
    LDAPartiallyCollapsedGibbsSampler)
from ldagroupedgibbssampler_tpu_torch.parallel.sharded import (
    DocShardedMixin)


class ShardedPCGS(DocShardedMixin, LDAPartiallyCollapsedGibbsSampler):
    """Scheme `sharded_pcgs`: beta-smoothed phi, documents sharded."""

    smooth_phi = True


class ShardedUncollapsedLDA(ShardedPCGS):
    """Scheme `sharded_uncollapsed`: the historical unsmoothed phi ~
    Dir(n_k) draw (UncollapsedParallelLDA.java:1306-1316, flagged
    incorrect at :1313-1315 but kept for experiment parity), documents
    sharded."""

    smooth_phi = False
