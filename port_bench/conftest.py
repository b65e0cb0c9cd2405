"""pytest settings of the benchmark's own tests.

    python -m pytest port_bench/tests -q

Tests that need a CUDA card take the ``card`` fixture and carry the
``card`` marker; the fixture skips them, with a reason, where there is
none.  The decision is made when the test runs, never at import.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)
