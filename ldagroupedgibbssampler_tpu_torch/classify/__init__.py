"""Classification layer — device equivalents of ``cc.mallet.classify``
(the port's counterpart of `ldagroupedgibbssampler_tpu/classify/`)."""

from ldagroupedgibbssampler_tpu_torch.classify.confusion import (
    EnhancedConfusionMatrix)
from ldagroupedgibbssampler_tpu_torch.classify.kl_classifier import (
    KLDivergenceClassifier, KLDivergenceClassifierMultiCorpus)

__all__ = ["EnhancedConfusionMatrix", "KLDivergenceClassifier",
           "KLDivergenceClassifierMultiCorpus"]
