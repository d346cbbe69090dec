"""Deterministic synthetic training data (port of ``repro.data``)."""
