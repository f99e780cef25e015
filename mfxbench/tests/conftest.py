"""The benchmark's own tests. Tests that need an NVIDIA card carry the
``card`` marker and decide inside the test, through the ``cuda_card``
fixture, whether one is there; on the CPU they skip."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda")
