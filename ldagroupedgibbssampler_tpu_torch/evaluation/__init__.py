"""Evaluation: likelihoods and top-word extraction."""
