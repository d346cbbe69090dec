"""Training substrate: optimizers, gradient accumulation, the loop (port of
``repro.training``)."""
