"""PyTorch/CUDA port of the LDA Gibbs-sampling framework.

A second package beside the JAX reference `ldagroupedgibbssampler_tpu`:
the same samplers written with PyTorch tensors on an explicit device, and
the reference's Pallas TPU kernels rewritten as hand-written CUDA kernels
for Hopper (`csrc/`, built at first use by `ops/_build.py`). It imports
neither JAX nor the reference package; the host-side modules it needs are
its own copies.

It holds all 23 schemes of the JAX registry (the 18 single-device ones
and the five sharded ones of `parallel/`), the experiment runner
`python -m ldagroupedgibbssampler_tpu_torch.tui.parallel_lda` and its
secondary drivers, the apps (`similarity/`, `classify/`) and the corpus
pipeline, through `create_model(cfg)`. The sampler's interface
(`add_instances`, `sample`, the lifecycle hooks, iteration listeners,
getters, checkpoints, and `sample_chunked` of the GGS family) is
documented in `models/base.py` and `models/ggs.py`.
Entry points run on `cuda` unless the config asks for `device = cpu`.
"""

__version__ = "0.1.0"

from ldagroupedgibbssampler_tpu_torch.models.registry import (  # noqa: F401
    SCHEMES, create_model)
