"""Generate the goldens of the port's documentation examples from the JAX ones.

Run from the repo root::

    python -m tests.port.make_example_goldens

Each script of ``docs/examples/`` runs with ``runpy.run_path`` on the CPU
with float64 on (as ``tests/integration/test_examples.py`` runs it), and the
numbers it prints and asserts on are read from the globals it returns:
traces, predictions, marginals, smoothed moments, trained parameters, and
the draws that the port cannot make itself (the simulated ``path`` and
``obs_y``, the multi-stage counts ``y``).  They are written to
``tests/port/example_goldens.npz`` as ``"<example>/<name>"``; the inputs the
port's ``run(data=...)`` takes are under ``"<example>/data/<name>"``.
Nothing in ``docs/examples/`` changes.

The importance-weighted example draws inside its jitted step, so its
golden is not the script's own run: it runs with ``jax.jit`` as the
identity and every ``jax.random.normal`` answered by numpy's
``default_rng(IWVI_NORMAL_SEED)`` in the order asked, which the port's
example takes as ``data={"normal_seed": IWVI_NORMAL_SEED}``.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import runpy

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
EXAMPLES_DIR = ROOT / "docs" / "examples"
GOLDEN_PATH = pathlib.Path(__file__).resolve().parent / "example_goldens.npz"
EXAMPLES = sorted(p.stem for p in EXAMPLES_DIR.glob("*.py"))
IWVI_NORMAL_SEED = 0
SSM_FIELDS = ("initial_mean", "chol_initial_covariance", "state_transitions", "state_offsets",
              "chol_process_covariances")


def _setup_jax():
    """The CPU, a virtual mesh of 8 devices (the sharded example's), and x64."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def _ssm(prefix, q):
    return {f"{prefix}{name}": getattr(q, name) for name in SSM_FIELDS}


def _marginals(prefix, ssm):
    means, covs = ssm.marginals()
    return {f"{prefix}means": means, f"{prefix}covs": covs}


def _cvi_dp_double_well(g):
    return {"data/path": g["path"], "data/obs_y": g["obs_y"], "elbos": g["elbos"],
            "elbo_trace": g["trainer"].elbo_trace, "means": g["means"], "covs": g["covs"]}


def _vdp_inference(g):
    return {"data/path": g["path"], "data/obs_y": g["obs_y"], "elbo": g["elbo"],
            "elbo_trace": g["trainer"].elbo_trace, "m": g["m"], "s": g["s"], "rmse": g["err"]}


def _natgrad_vgp(g):
    return {"loss0": g["loss0"], "elbo": g["vgp"].elbo(g["q1"]),
            "gpr_loglik": g["gpr"].log_likelihood(), **_marginals("", g["q1"])}


def _gpr_regression(g):
    kernel = g["kernel"]
    return {"loss": g["loss_fn"](kernel), "lengthscale": kernel.lengthscale,
            "variance": kernel.variance, "f_mu": g["f_mu"], "f_var": g["f_var"]}


def _sparse_classification(g):
    return {"l0": g["l0"], "l1": g["l1"], **_ssm("q/", g["q"]), "f_mu": g["f_mu"],
            "f_var": g["f_var"], "acc": g["acc"]}


def _kernels_tour(g):
    out = {}
    for name, k in {**g["kernels"], **g["combos"]}.items():
        ssm = k.state_space_model(g["t"])
        out.update(_marginals(f"{name}/", ssm))
        out[f"{name}/dims"] = [k.state_dim, k.output_dim, ssm.num_transitions]
    out["sum_f_var"] = g["f_var"]
    return out


def _spatio_temporal_cvi(g):
    model, data = g["model"], (g["inputs"], g["y"])
    return {"elbo": model.elbo(data), "f_mu": g["f_mu"], "f_var": g["f_var"], "corr": g["corr"]}


def _time_sharded_smoothing(g):
    return {"means": g["smoothed"].means, "covs": g["smoothed"].covs, "ref_means": g["ref"].means,
            "logz": g["logz"]}


def _natgrad_fit(g):
    return {"loss": g["loss"], **_ssm("q/", g["q"]), "f_mu": g["f_mu"], "f_var": g["f_var"]}


def _multistage_demand(g):
    return {"data/y": g["y"], "losses": g["losses"], **_ssm("q/", g["q"])}


def _pep_classification(g):
    model = g["model"]
    return {"energy": g["energy"], "nat1": model.sites.nat1, "nat2": model.sites.nat2,
            "f_mu": g["f_mu"], "f_var": g["f_var"], "p_mu": g["p_mu"], "acc": g["acc"],
            "corr": g["corr"]}


def _sparse_pep_classification(g):
    return {"e0": g["e0"], "e1": g["e1"], "energy": g["energy"], "f_mu": g["f_mu"],
            "f_var": g["f_var"], "acc": g["acc"], "corr": g["corr"]}


def _iwvi_importance_weighted(g):
    return {"data/normal_seed": IWVI_NORMAL_SEED, "iw0": g["iw0"], "iw": g["iw"],
            "exact": g["exact"], **_ssm("q/", g["q"])}


READERS = {
    "cvi_dp_double_well": _cvi_dp_double_well,
    "factor_analysis": _natgrad_fit,
    "gpr_regression": _gpr_regression,
    "iwvi_importance_weighted": _iwvi_importance_weighted,
    "kernels_tour": _kernels_tour,
    "multistage_demand": _multistage_demand,
    "natgrad_vgp": _natgrad_vgp,
    "pep_classification": _pep_classification,
    "sparse_classification": _sparse_classification,
    "sparse_pep_classification": _sparse_pep_classification,
    "spatio_temporal_cvi": _spatio_temporal_cvi,
    "stacked_kernels": _natgrad_fit,
    "time_sharded_smoothing": _time_sharded_smoothing,
    "vdp_inference": _vdp_inference,
}


@contextlib.contextmanager
def _fed_normals(seed):
    """``jax.jit`` as the identity and ``jax.random.normal`` answered by
    numpy's ``default_rng(seed)``, in the order the script asks."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    real = jax.jit, jax.random.normal

    def normal(key, shape=(), dtype=float):
        return jnp.asarray(rng.normal(size=tuple(shape)), dtype)

    jax.jit, jax.random.normal = (lambda fn, **_: fn), normal
    try:
        yield
    finally:
        jax.jit, jax.random.normal = real


def example_goldens(name: str) -> dict:
    """Run one JAX example; its golden numbers as float64 numpy arrays."""
    _setup_jax()
    path = str(EXAMPLES_DIR / f"{name}.py")
    fed = _fed_normals(IWVI_NORMAL_SEED) if name == "iwvi_importance_weighted" else (
        contextlib.nullcontext())
    with fed:
        g = runpy.run_path(path, run_name="__main__")
    return {f"{name}/{k}": np.asarray(v, np.float64) for k, v in READERS[name](g).items()}


def generate() -> dict:
    out = {}
    for name in EXAMPLES:
        out.update(example_goldens(name))
    return out


def main() -> None:
    goldens = generate()
    np.savez_compressed(GOLDEN_PATH, **goldens)
    print(f"wrote {len(goldens)} arrays to {GOLDEN_PATH}")


if __name__ == "__main__":
    main()
