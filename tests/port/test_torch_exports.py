"""Every public name of each JAX sub-package (its ``__all__``) is
importable from the same sub-package of the port, and the top-level names
too.  ``EXCEPTIONS`` lists the names the port does not have, with the
reason."""
import importlib

import pytest

PACKAGES = ["", "exp", "kernels", "likelihoods", "models", "ops", "optim", "parallel", "sde",
            "ssm", "utils"]
#: (sub-package, name) → why the port has no such export
EXCEPTIONS = {}
TOP_LEVEL = ["config", "BTD", "StateSpaceModel", "ssm_from_covariances"]


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
