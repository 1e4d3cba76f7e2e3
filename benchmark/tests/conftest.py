"""CPU tests of the benchmark at small shapes (``python -m pytest
benchmark/tests -q``); the tests marked ``cuda`` run on the card only."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")
