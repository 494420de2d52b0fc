"""Sharded ADLDA: per-rank collapsed sweeps against a rank-local replica
of the counts, one merge per sweep (scheme `sharded_adlda`).

The port's counterpart of `ldagroupedgibbssampler_tpu/parallel/
sharded_adlda.py`, which is the reference's AD-LDA (ADLDA.java:176-332,
Newman et al. 2009): each worker copies the global N_kw / n_k, sweeps its
documents collapsed, and the copies are merged and re-broadcast once per
iteration.

Each rank runs the single-device `adlda` step (`models/adlda.py`): the
collapsed mode of the sweep kernel (`ops/cuda_pcgs.py`, csrc/pcgs.cu) over
its documents, starting from the merged N_kw and n_k of the last
iteration, which the kernel then keeps live with the rank's own moves:
Newman et al.'s per-processor replica. The merge is exact: N_kw = replica
+ all-reduce(rank's N_kw - replica), so the merged counts are the
histogram of the ranks' z.

This differs from the JAX package, which sweeps each shard against the
stale replica with the own-count self-correction
(ldagroupedgibbssampler_tpu/ops/kernels.py:84-115): within a rank the
port's replica is live, across ranks it is stale by one sweep, as in the
reference. Both are members of the AD-LDA approximation family. What a
rank's parallel launch adds to AD-LDA is held to the same ranks' one-warp
launch (each rank's sequential chain) by chip_smoke.py's
`[7 sharded_adlda oracle]`; the ranks' staleness itself leaves the chain
behind the single-device sequential chain per iteration (a few percent of
the likelihood on 2,000 documents after 30 iterations, more with more
ranks), a gap the same check bounds.
"""

from __future__ import annotations

from ldagroupedgibbssampler_tpu_torch.models.adlda import ADLDA
from ldagroupedgibbssampler_tpu_torch.parallel.sharded import (
    DocShardedMixin)


class ShardedADLDA(DocShardedMixin, ADLDA):
    """Scheme `sharded_adlda`: documents sharded, N_kw live per rank and
    merged once per sweep."""
