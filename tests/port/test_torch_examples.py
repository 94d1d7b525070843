"""The port's documentation examples (``vi_diffusion_processes_tpu_torch/
examples/``) against the JAX examples of ``docs/examples/``, on the CPU.

Each port example's ``run(device="cpu", data=...)`` is held to the numbers
that the JAX script gave (``example_goldens.npz``, written by
``tests/port/make_example_goldens.py``), on the JAX script's own draws where
the port cannot make them (``data``): one-step results (``natgrad_vgp``,
``kernels_tour``, ``time_sharded_smoothing``) to 1e-8 of each output's
scale, iterated traces and predictions to 1e-6, and the limits each module
states with its one-ulp probe (``RTOLS``, ``ENTRY_RTOLS``).  The
importance-weighted example runs on standard normals fed from numpy, the
same as the golden's.  The sharded example spawns its ranks and has its own
file (``test_torch_examples_sharded.py``).

Marked slow: the goldens regenerated from the JAX examples equal the
committed file, and every port example runs as ``__main__`` with
``--device cpu`` under the JAX integration test's per-example time limit.
"""
import importlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from vi_diffusion_processes_tpu_torch.examples import EXAMPLES
from vi_diffusion_processes_tpu_torch.examples._common import errors

from .make_example_goldens import GOLDEN_PATH

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIVE = [name for name in EXAMPLES if name != "time_sharded_smoothing"]
#: the JAX integration test's limit per example (tests/integration/test_examples.py:22)
PER_EXAMPLE_TIMEOUT_S = int(os.environ.get("EXAMPLE_TIMEOUT_S", "420"))


def module(name):
    return importlib.import_module(f"vi_diffusion_processes_tpu_torch.examples.{name}")


def goldens(name):
    """(the inputs ``run`` takes, the outputs it is held to) of one example."""
    g = np.load(GOLDEN_PATH)
    prefix, data = f"{name}/", f"{name}/data/"
    inputs = {k[len(data):]: g[k] for k in g.files if k.startswith(data)}
    outputs = {k[len(prefix):]: g[k] for k in g.files
               if k.startswith(prefix) and not k.startswith(data)}
    return inputs, outputs


def check_against_goldens(name):
    mod = module(name)
    inputs, want = goldens(name)
    assert sorted(inputs) == sorted(mod.DATA), name
    got = mod.run(device="cpu", data=inputs or None)
    far = {k: v for k, v in errors(mod, got, want).items() if not v[0] <= v[1]}
    assert not far, far
    return got


def test_every_jax_example_has_a_twin():
    jax_names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "docs", "examples"))
                       if f.endswith(".py"))
    assert sorted(EXAMPLES) == jax_names
    assert sorted({k.split("/")[0] for k in np.load(GOLDEN_PATH).files}) == jax_names


def test_importing_the_examples_runs_nothing():
    code = ("import importlib\n"
            "from vi_diffusion_processes_tpu_torch.examples import EXAMPLES\n"
            "for name in EXAMPLES:\n"
            "    importlib.import_module(f'vi_diffusion_processes_tpu_torch.examples.{name}')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("name", LIVE)
def test_example_matches_the_jax_example(name):
    check_against_goldens(name)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_card_unless_told(name, monkeypatch):
    """With no device named, ``run`` asks for the card: here, without one,
    it raises before it computes anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module(name).run()


@pytest.mark.slow
def test_goldens_regenerate_from_the_jax_examples():
    from .make_example_goldens import generate

    fresh = generate()
    committed = np.load(GOLDEN_PATH)
    assert sorted(fresh) == sorted(committed.files)
    for key, value in fresh.items():
        np.testing.assert_allclose(value, committed[key], rtol=1e-9, atol=0, err_msg=key)


@pytest.mark.slow
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_as_a_script(name):
    class _Timeout(Exception):
        pass

    def _raise(signum, frame):
        raise _Timeout(f"{name} exceeded {PER_EXAMPLE_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(PER_EXAMPLE_TIMEOUT_S)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", f"vi_diffusion_processes_tpu_torch.examples.{name}",
             "--device", "cpu"], cwd=ROOT, capture_output=True, text=True)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert proc.returncode == 0, proc.stderr
