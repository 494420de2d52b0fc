"""Run-directory logging, console capture, timing, matrix IO, host
sampling helpers and device selection."""

from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import RunLogger  # noqa: F401
from ldagroupedgibbssampler_tpu_torch.utils.timing import IterationStats, Timing  # noqa: F401
