"""pytest settings of the benchmark's own tests (``port_bench/tests``).

``card``: a test that needs an NVIDIA GPU. Whether one is there is decided
inside the ``card`` fixture, never while a module is imported, so every
pytest worker collects the same tests; here, without a card, they skip.
Run them on the card with ``python3 -m pytest port_bench/tests -m card``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda:0")
