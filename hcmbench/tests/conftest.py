"""Settings of the benchmark's own tests: the marker of tests that need a
CUDA card, the CPU in the card's place for every other test, and one
intra-op thread for torch in each test process."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def cpu_in_the_cards_place(request, monkeypatch):
    """Tests not marked ``card`` rehearse on the CPU (tests/tiny.py)."""
    if request.node.get_closest_marker("card") is None:
        from hcmbench import harness
        from hcmbench.tests.tiny import CpuCard

        monkeypatch.setattr(harness, "CARD", CpuCard())


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
