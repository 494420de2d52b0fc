"""Sampler layer: the sampler base, scheme `ggs` and the registry."""
