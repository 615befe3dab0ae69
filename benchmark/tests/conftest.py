"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``. Tests
marked ``cuda`` (the repository's marker for tests that need the card) skip
here; on the card ``python -m pytest benchmark/tests -q -m cuda`` runs them."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH), str(BENCH / 'tests')):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where torch sees none (decided when a
    test asks, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; torch sees no CUDA device')
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
