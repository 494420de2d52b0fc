"""Scheme registry — mirrors ParallelLDA.createModel
(topics/tui/ParallelLDA.java:401-490) for the schemes the port has so far.
Any other scheme name raises `ValueError` naming the ported ones.
"""

from __future__ import annotations

import importlib

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig

# scheme -> (module, class, human description printed by createModel)
SCHEMES = {
    "ggs": ("ggs", "LDAGroupedGibbsSampler",
            "LDA Grouped Gibbs Sampler. GGS by George and Doss (2025)."),
    "ggs_test": ("ggs", "LDAGroupedGibbsSamplerTest",
                 "Invalid GGS comparison variant (stale theta)."),
    "ggs_aliasmh": ("ggs_aliasmh", "LDAGroupedGibbsSamplerAliasMH",
                    "GGS with O(1)-per-token alias-MH z-draws — the "
                    "sublinear large-K mode (LightLDA-style count "
                    "proposals on the grouped target)."),
    "pcgs": ("pcgs", "LDAPartiallyCollapsedGibbsSampler",
             "Partially Collapsed Gibbs Sampler. PCGS by Magnusson et al. "
             "(2018)."),
    "uncollapsed": ("pcgs", "UncollapsedParallelLDA",
                    "Uncollapsed Parallel LDA. PCGS by Magnusson et al. "
                    "(2018)."),
    "efficient_uncollapsed": ("pcgs", "EfficientUncollapsedParallelLDA",
                              "EfficientUncollapsedParallelLDA Parallel "
                              "LDA."),
    "spalias": ("spalias", "SpaliasUncollapsedParallelLDA",
                "SpaliasUncollapsed Parallel LDA."),
    "polyaurn": ("polyaurn", "PolyaUrnSpaliasLDA",
                 "PolyaUrnSpaliasLDA Parallel LDA."),
    "adlda": ("adlda", "ADLDA",
              "Approximate Distributed LDA. ADLDA by Newman et al. (2009)."),
    "collapsed": ("cgs", "SerialCollapsedLDA",
                  "Collapsed Serial LDA. CGS of Griffiths and Steyvers "
                  "(2004)."),
    "lightpclda": ("lightlda", "LightPCLDA", "Light PC LDA."),
    "lightpcldaw2": ("lightlda", "LightPCLDAtypeTopicProposal",
                     "Light PC LDA with proposal 2."),
    "lightcollapsed": ("lightlda", "CollapsedLightLDA",
                       "CollapsedLightLDA Parallel LDA."),
}


def create_model(config: LDAConfig, scheme: str | None = None, logger=None,
                 verbose: bool = False):
    """Instantiate a sampler for `scheme` (default: config.scheme)."""
    scheme = scheme or config.scheme
    if scheme not in SCHEMES:
        raise ValueError(f"Invalid model type {scheme!r}: the PyTorch port "
                         f"has schemes {sorted(SCHEMES)}")
    module_name, class_name, description = SCHEMES[scheme]
    module = importlib.import_module(
        f"ldagroupedgibbssampler_tpu_torch.models.{module_name}")
    if verbose:
        print(description)
    return getattr(module, class_name)(config, logger=logger)
