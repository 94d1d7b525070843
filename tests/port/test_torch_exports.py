"""Every public name of each JAX sub-package (its ``__all__``) is
importable from the same sub-package of the port, and the top-level names
too.  ``EXCEPTIONS`` lists the names the port does not have, with the
reason.  Module by module, each JAX module's ``__all__`` (read from its
source with ``ast``, so no JAX is imported) is in its twin's, but for the
absences that ``MODULE_ABSENCES`` and ``NOT_PORTED`` name with their
reasons."""
import ast
import importlib
import pathlib

import pytest

PACKAGES = ["", "exp", "kernels", "likelihoods", "models", "ops", "optim", "parallel", "sde",
            "ssm", "utils"]
#: (sub-package, name) → why the port has no such export
EXCEPTIONS = {}
TOP_LEVEL = ["config", "BTD", "StateSpaceModel", "ssm_from_covariances"]

ROOT = pathlib.Path(__file__).resolve().parents[2]
JAX_MODULES = sorted(
    str(p.relative_to(ROOT / "vi_diffusion_processes_tpu").with_suffix("")).replace("/", ".")
    for p in (ROOT / "vi_diffusion_processes_tpu").rglob("*.py") if p.name != "__init__.py")
#: JAX module → why the port has no twin of it
NOT_PORTED = {
    "ops.pallas_scan": "the Pallas kernels K1-K3 became ops/cuda_scan.py and csrc/cuda_scan.cu",
    "ops.pallas_riccati": "the Pallas kernel K4 became ops/cuda_riccati.py and "
                          "csrc/cuda_riccati.cu",
    "ops.chmat": "channel-major matrices exist for the TPU's tile padding alone",
    "ops.achmat": "channel-major matrices exist for the TPU's tile padding alone",
}
#: (module, name) → why the port's twin does not export that name
MODULE_ABSENCES = {
    ("ops.blocked_scan", "blocked_assoc_scan"):
        "serves the TPU's window layout; the port scans with assoc_scan",
    ("ops.blocked_scan", "blocked_assoc_scan_packed"):
        "serves the TPU's window layout; the port scans with assoc_scan",
    ("utils.validation", "validated_dataclass"):
        "validates JAX pytree dataclasses; the port's models check in their constructors",
}


def _module(root, pkg):
    return importlib.import_module(f"{root}.{pkg}" if pkg else root)


def _public(module):
    return list(getattr(module, "__all__", []))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_exports_every_jax_name(pkg):
    jax_mod = _module("vi_diffusion_processes_tpu", pkg)
    port_mod = _module("vi_diffusion_processes_tpu_torch", pkg)
    names = TOP_LEVEL if not pkg else _public(jax_mod)
    missing = [n for n in names if not hasattr(port_mod, n) and (pkg, n) not in EXCEPTIONS]
    assert not missing, missing
    if pkg:
        assert sorted(_public(port_mod)) == sorted(
            n for n in _public(jax_mod) if (pkg, n) not in EXCEPTIONS)


@pytest.mark.parametrize("pkg", [p for p in PACKAGES if p])
def test_port_exports_are_the_port_s_own(pkg):
    port_mod = _module("vi_diffusion_processes_tpu_torch", pkg)
    for name in _public(port_mod):
        obj = getattr(port_mod, name)
        assert getattr(obj, "__module__", "vi_diffusion_processes_tpu_torch").startswith(
            "vi_diffusion_processes_tpu_torch"), (name, obj)


def _source_all(path):
    """The module's ``__all__`` as its source states it, or None."""
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
            return list(ast.literal_eval(node.value))
    return None


@pytest.mark.parametrize("module", JAX_MODULES)
def test_each_module_exports_its_jax_twin_s_names(module):
    jax_path = ROOT / "vi_diffusion_processes_tpu" / (module.replace(".", "/") + ".py")
    names = _source_all(jax_path) or []
    if module in NOT_PORTED:
        assert not (ROOT / "vi_diffusion_processes_tpu_torch" / jax_path.relative_to(
            ROOT / "vi_diffusion_processes_tpu")).exists(), module
        return
    port_mod = importlib.import_module(f"vi_diffusion_processes_tpu_torch.{module}")
    port_all = set(getattr(port_mod, "__all__", []))
    absent = {n for (m, n) in MODULE_ABSENCES if m == module}
    assert absent <= set(names), f"{module}: an absence the reference does not export"
    assert not absent & port_all, f"{module}: a listed absence is exported after all"
    missing = [n for n in names if n not in absent and n not in port_all]
    assert not missing, f"{module}: {missing}"
    assert all(hasattr(port_mod, n) for n in port_all), module
