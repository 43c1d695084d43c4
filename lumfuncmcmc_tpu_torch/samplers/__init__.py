"""Ensemble sampler and chain diagnostics."""
