"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the root of the repository. Tests marked `gpu` need a CUDA card and skip
inside the test where there is none (on the card: `-m gpu`)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
