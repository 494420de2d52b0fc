"""Sharded GGS: documents sharded over the ranks (scheme `sharded_ggs`).

The port's counterpart of `ldagroupedgibbssampler_tpu/parallel/
sharded_ggs.py`. Each rank owns the documents [bounds[r], bounds[r+1])
(`partition_documents`) and runs the single-device GGS step
(`models/ggs.py`) on the cell blocks of those documents:

  1. theta_d ~ Dir(n_d + alpha) for its documents, with its own generator
     (rank-local, as the JAX package's `fold_in(key, shard)`);
  2. the z-draw kernel (`ops/cuda_zdraw.py`, csrc/zdraw.cu) draws its
     tokens' z and counts its N_kw;
  3. the count kernel (`ops/cuda_counts.py`, csrc/label_counts.cu)
     rebuilds its n_dk;
  4. one all-reduce of N_kw ([V, K] int32) over the ranks, the only
     communication of an iteration;
  5. phi ~ Dir(beta + n_k) from the merged counts, drawn identically on
     every rank with the shared generator: a replicated computation
     instead of a broadcast.

The JAX package's per-shard sweep (its flat XLA inverse-CDF draw) is the
same draw as the z-draw kernel's, so per rank the port's step is the
single-device one and only the merge is new.
"""

from __future__ import annotations

from ldagroupedgibbssampler_tpu_torch.models.ggs import (
    LDAGroupedGibbsSampler)
from ldagroupedgibbssampler_tpu_torch.parallel.sharded import (  # noqa: F401
    DocShardedMixin, partition_documents)


class ShardedGGS(DocShardedMixin, LDAGroupedGibbsSampler):
    """GGS with documents sharded over `mesh` (default: every rank of the
    process group, or one rank without one)."""
