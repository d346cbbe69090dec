"""Checkpoints in the reference's format (port of ``repro.checkpoint``)."""
