"""Sampler layer: the sampler base, scheme `ggs`, the PCGS family
(`fused_sweep`, `pcgs`, `spalias`, `polyaurn`) and the registry."""
