"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the single real CPU
device; only launch/dryrun.py forces 512 placeholder devices."""

import jax
import pytest
from repro.launch.mesh import compat_make_mesh


@pytest.fixture(scope="session")
def local_mesh():
    return compat_make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="session")
def train_rules_1d():
    from repro.distributed.sharding import train_rules
    return train_rules(multi_pod=False)


@pytest.fixture(scope="session")
def serve_rules_1d():
    from repro.distributed.sharding import serve_rules
    return serve_rules(multi_pod=False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs CUDA kernels on an NVIDIA GPU; skipped (with "
        "its reason) where torch.cuda.is_available() is false")
