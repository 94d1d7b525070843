"""Shared setup of the PyTorch port's tests.

The port's CPU tests hold each ported function against its JAX twin on the
same numpy-seeded inputs.  PyTorch runs single-threaded here: the suite
runs under several xdist workers, and torch's default thread count would
oversubscribe the cores.  Each test starts with an empty cache of captured
steps.
"""
import pytest
import torch

from vi_diffusion_processes_tpu_torch.optim import compiled

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_graph_cache():
    """No test replays a graph that another captured: the process's cache of
    captured steps (``optim/compiled.py``) starts empty in each, so a new
    ``CapturedStep``'s first call captures."""
    compiled.clear_cache()
    yield
    compiled.clear_cache()


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none.  Decided
    inside the fixture, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda", 0)
