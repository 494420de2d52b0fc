"""Data ingestion: plain Python/NumPy, producing a `Corpus` of flat ragged
token-id arrays plus vocabulary."""

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus  # noqa: F401
from ldagroupedgibbssampler_tpu_torch.corpus.pipeline import (  # noqa: F401
    build_corpus, load_dataset)
