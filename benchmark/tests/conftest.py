"""The benchmark's own tests run on the CPU from the root of the checkout
(``python -m pytest benchmark/tests -q``); the card's tests carry the
``cuda`` marker and skip without a card, decided inside the fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
