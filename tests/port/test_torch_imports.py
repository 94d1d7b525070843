"""The port stands alone: importing every module of it loads no JAX."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = "vi_diffusion_processes_tpu_torch"

_SCRIPT = f"""
import importlib, pkgutil, sys
import {PKG}
names = [m.name for m in pkgutil.walk_packages({PKG}.__path__, "{PKG}.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not bad, bad
assert "vi_diffusion_processes_tpu" not in sys.modules
print(len(names))
"""


def test_importing_every_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every ported module was imported


@pytest.mark.parametrize("word", ["import jax", "from jax", "import flax", "from flax", "optax"])
def test_no_source_file_names_jax(word):
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    assert word not in fh.read(), os.path.join(root, f)
