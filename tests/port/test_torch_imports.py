"""The port stands alone: importing every module of it, and the two scripts
that drive it on the card, loads no JAX."""
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
print(" ".join(names))
"""

#: every module that holds ported code; a new slice adds its own here
MODULES = """
config interop exp.data exp.metrics exp.runners likelihoods.base likelihoods.gaussian
models.cvi_dp models.cvi_dp_packed models.cvi_dp_packed_batched models.vdp models.vdp_packed
ops._build ops.btd ops.cuda_riccati ops.cuda_scan ops.quadrature optim.trainers optim.compiled
sde.base sde.drift sde.utils sde.zoo ssm.state_space_model ssm.transforms utils.linalg
utils.shapes ops.blocked_scan ssm.emission ssm.mean_functions ssm.conditionals
kernels.base kernels.matern kernels.misc parallel.pskf parallel.sites parallel.kalman
models.posterior models.gpr models.cvi_dp_packed_ch likelihoods.discrete models.cvi
models.cvi_packed models.sparse_cvi kernels.spatial kernels.spatio_temporal
models.spatio_temporal models.spatio_packed optim.bijectors optim.natgrad models.variational
models.svgp kernels.composite likelihoods.multistage likelihoods.pep models.pep
models.sparse_pep models.iwvi exp.cli exp.__main__ exp.logging exp.plots utils.validation
utils.tracing utils.checkpoint utils.serving utils.native parallel.sharded
models.cvi_dp_sharded parallel.dryrun
examples examples._common examples._natgrad_svgp examples.cvi_dp_double_well
examples.vdp_inference examples.natgrad_vgp examples.gpr_regression
examples.sparse_classification examples.kernels_tour examples.spatio_temporal_cvi
examples.time_sharded_smoothing examples.factor_analysis examples.stacked_kernels
examples.multistage_demand examples.pep_classification examples.sparse_pep_classification
examples.iwvi_importance_weighted
""".split()
SCRIPTS = ["chip_smoke.py", "profile_step.py"]


def test_importing_every_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    missing = [m for m in MODULES if f"{PKG}.{m}" not in imported]
    assert not missing, missing


@pytest.mark.parametrize("script", SCRIPTS)
def test_importing_a_card_script_loads_no_jax(script):
    """The scripts import the port inside their functions: import those
    modules too, as a run on the card would."""
    code = f"""
import importlib.util, re, sys
spec = importlib.util.spec_from_file_location("script", {script!r})
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)  # runs nothing: main() is under the __main__ check
source = open({script!r}, encoding="utf-8").read()
names = sorted(set(re.findall(r"^\\s*from ({PKG}[\\w.]*) import", source, re.M)))
assert len(names) >= 5, names
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not bad, bad
assert "vi_diffusion_processes_tpu" not in sys.modules
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("word", ["import jax", "from jax", "import flax", "from flax", "optax"])
def test_no_source_file_names_jax(word):
    paths = [os.path.join(REPO, script) for script in SCRIPTS]
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        paths += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    assert len(paths) > len(MODULES)
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            assert word not in fh.read(), path
