"""PyTorch/CUDA port of the LDA Gibbs-sampling framework.

A second package beside the JAX reference `ldagroupedgibbssampler_tpu`:
the same samplers written with PyTorch tensors on an explicit device, and
the reference's Pallas TPU kernels rewritten as hand-written CUDA kernels
for Hopper (`csrc/`, built at first use by `ops/_build.py`). It imports
neither JAX nor the reference package; the host-side modules it needs are
its own copies.

Ported so far: schemes `ggs` (and its invalid comparison variant
`ggs_test`), `pcgs`, `uncollapsed`, `efficient_uncollapsed`, `spalias` and
`polyaurn` end to end, through `create_model(cfg)` and the experiment
driver `python -m ldagroupedgibbssampler_tpu_torch.tui.parallel_lda`.
Entry points run on `cuda` unless the config asks for `device = cpu`.
"""

__version__ = "0.1.0"

from ldagroupedgibbssampler_tpu_torch.models.registry import (  # noqa: F401
    SCHEMES, create_model)
