"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see the single real CPU device; only launch/dryrun.py forces 512."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers",
        "multidevice: needs multiple jax devices (tests/multidevice/ runs "
        "in a subprocess with XLA_FLAGS=--xla_force_host_platform_"
        "device_count=8; this conftest imports jax, so forcing cannot "
        "happen in-process)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "inside the test's fixture when torch.cuda.is_available() is False")
