"""One intra-op thread for the port's CPU tests.

pytest-xdist runs several workers on the machine's cores, and each worker's
torch would otherwise start an intra-op pool the size of the machine: the
port's tests, whose tensors are small, then spend their time contending for
cores.  Every ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, a
module-scoped autouse fixture that sets ``torch.set_num_threads(1)`` for the
module's tests and restores the count after them.  It lives here, in a port
test module, so that the JAX package's tests run as they always have.
Nothing else changes: the same cases, shapes, orders of summation and
tolerances.
"""

import pytest
import torch


def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from _one_thread()


def test_one_thread_inside_a_port_module():
    assert torch.get_num_threads() == 1


def test_the_fixture_restores_the_count():
    """Run the fixture's body by hand from another count: it sets one
    thread and puts the count back."""
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        gen = _one_thread()
        next(gen)
        assert torch.get_num_threads() == 1
        with pytest.raises(StopIteration):
            next(gen)
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
