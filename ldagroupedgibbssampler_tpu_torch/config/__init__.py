"""Config / flag system: the typed run configuration, INI parsing and CLI
overrides."""

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig  # noqa: F401
from ldagroupedgibbssampler_tpu_torch.config.ini import (  # noqa: F401
    ParsedConfig, parse_ini)
from ldagroupedgibbssampler_tpu_torch.config.cli import parse_args  # noqa: F401
