"""LM serving: continuous-batching engine and token sampler."""
