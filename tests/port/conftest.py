"""Shared setup of the PyTorch port's tests.

The port's CPU tests hold each ported function against its JAX twin on the
same numpy-seeded inputs.  PyTorch runs single-threaded here: the suite
runs under several xdist workers, and torch's default thread count would
oversubscribe the cores.
"""
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none.  Decided
    inside the fixture, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda", 0)
