"""Distribution layer: the sharded schemes on `torch.distributed`, one
process per rank (the port's counterpart of
`ldagroupedgibbssampler_tpu/parallel/`)."""

from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, distributed_initialize, make_mesh, psum)
from ldagroupedgibbssampler_tpu_torch.parallel.sharded import (  # noqa: F401
    state_from_jax_z)
from ldagroupedgibbssampler_tpu_torch.parallel.sharded_ggs import (  # noqa
    ShardedGGS)
