"""Host substrate shared by the serving stacks: interfaces, telemetry and
adaptive batching (copies of the jax-free ``repro.core`` modules)."""
