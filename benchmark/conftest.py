"""pytest settings of the benchmark's own tests (`python -m pytest
benchmark/tests`): the `card` marker, for tests that need an NVIDIA card;
they skip without one, decided inside a fixture."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a card test runs on the chip")
    return torch.device("cuda")
