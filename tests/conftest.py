import os
import sys
from pathlib import Path

# NOTE: deliberately NO XLA_FLAGS device-count override here — tests must
# see the real single CPU device (the 512-device mesh is dry-run only).
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax
import pytest


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a machine without one")
