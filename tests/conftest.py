"""Shared fixtures. NOTE: no XLA_FLAGS here by design — tests must see the
real single-device view; only the dry-run subprocess forces 512 devices."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
