import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end tests")
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA card and nvcc; skips without")
