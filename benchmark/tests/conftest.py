"""Settings of the benchmark's own tests (``tests/conftest.py`` does not
reach this folder).

    python -m pytest benchmark/tests -q

Tests that need a card carry the ``cuda`` marker and decide in the
``cuda_device`` fixture, never at import, whether there is one.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
