"""Model and shape configurations (copies of ``repro.configs``)."""
