"""pytest settings of the benchmark's own tests (portbench/tests).

Tests that need a CUDA card carry the `card` marker; whether a card is
there is decided inside the `card` fixture, never while a module is
imported. Run them all, on the machine with the card, by

    python3 -m pytest portbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the kernels on the card")
    return "cuda"
