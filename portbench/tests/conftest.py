"""Tests of the benchmark: ``python -m pytest portbench/tests`` from the root
of the checkout (the CPU tests), ``python -m pytest portbench/tests -m cuda``
on a machine with the card. Tests marked ``cuda`` skip where no card is
found; the decision is made inside a fixture, never at import."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("cuda") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
