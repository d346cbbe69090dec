"""PyTorch / CUDA port of the ``repro`` serving system for NVIDIA Hopper.

Mirrors ``repro``'s subpackage layout module for module. Imports ``torch``
and never ``jax`` or ``repro``; the parity tests are the only code that
imports both."""
