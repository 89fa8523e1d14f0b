"""Tests of the benchmark itself, on the CPU: ``python -m pytest
portbench/tests -q`` from the repository's root.  A test that needs the
card is marked `card` and skips here, deciding inside its fixture."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32, the control's precision, "
                    "exists only there")
    return torch.device("cuda", 0)


# traffic parameters that cut a cell down to what a CPU test run holds
TRAIN_SHRINK = {"n_train": 6, "n_test": 2, "num_sampling": 6,
                "num_valid": 2, "batch_size": 2, "len_s": [1.3, 1.6],
                "sample_rows": 2}
ENHANCE_SHRINK = {"batch_size": 4, "len_s": [1.3, 1.8], "sample_every": 2}
