"""The benchmark's own tests: `python -m pytest portbench -q` (about a
minute on a CPU). Tests that need a card carry the `card` marker and take
the `card` fixture, which skips them where there is none; on the card's
machine run them with `python -m pytest portbench -q -m card`."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
