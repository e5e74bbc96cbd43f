"""The benchmark's CPU tests. ``gpu`` marks the tests that need the card;
they decide inside a fixture whether one is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell's kernels run only on the card")
    return "cuda"
