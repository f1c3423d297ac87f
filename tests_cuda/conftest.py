"""GPU test tier for the PyTorch/CUDA port.

Holds each hand-written CUDA kernel against its plain-torch version on
the card, at small shapes that reach every masking and tie case and
every states-per-lane variant of the kernels.  Run on a machine with an
NVIDIA Hopper GPU, from the repository root:

    python -m pytest tests_cuda -q

Every test takes the ``device`` fixture, which skips (with a reason)
when ``torch.cuda.is_available()`` is False.  This tier imports no JAX,
so it runs where the JAX package is not installed.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture
def device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.RandomState(0)
