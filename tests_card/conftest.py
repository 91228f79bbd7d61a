"""The port's card-only tests: ``python3 -m pytest tests_card -q`` on a
machine with an NVIDIA GPU.

These cases launch the kernels and run the port's CUDA paths; each is held
to the port's plain versions or to a float64 run of the port on the CPU.
Nothing here imports jax or the JAX package (tests/ holds the port to that
package on the CPU), so the directory collects on a machine that has only
torch, numpy and pytest.  Without a card every case skips.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
