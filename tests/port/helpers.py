"""Helpers for carrying JAX values into the port's tests."""
import dataclasses

import numpy as np


def to_np(x):
    """A JAX dataclass / named tuple / array tree as nested dicts of numpy
    arrays keyed by field name (the input format of the port's ``interop``)."""
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if x is None or isinstance(x, (bool, int, float, str, tuple)):
        return x
    return np.array(x)  # a writable copy


def assert_close_scaled(actual, expected, rtol, err_msg=""):
    """``|a − e| ≤ rtol·max|e|`` elementwise: relative to the array's scale,
    so entries that pass through zero do not blow the relative error up."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=rtol * scale, err_msg=err_msg)


def riccati_inputs(rng, n, batch=()):
    """Pivot-sweep inputs shaped like tests/unit/test_pallas_scan.py:21-28."""
    kd = rng.uniform(2.0, 3.0, batch + (n,))
    b2 = 0.2 * rng.uniform(0.5, 1.0, batch + (n,))
    b2[..., -1] = 0.0
    return kd, b2


def affine_inputs(rng, n, batch=()):
    return rng.uniform(-0.999, 0.999, batch + (n,)), rng.normal(size=batch + (n,))


def naturals(rng, n, batch=()):
    """``(nat1, nat2d, nat2s)`` shaped like test_pallas_scan.py:118-124."""
    kd = rng.uniform(2.0, 3.0, batch + (n,))
    ks = 0.4 * rng.uniform(-1.0, 1.0, batch + (n - 1,))
    return rng.normal(size=batch + (n,)), -0.5 * kd, -ks


def double_well_models(batch=3, t_points=300, dtype="float64"):
    """JAX ``CVISitesSDE`` models shaped like
    tests/unit/test_cvi_dp_packed_batched.py:28-55: one double-well prior and
    grid, distinct observations and ``p(x0)`` per trajectory, linearized."""
    import jax
    import jax.numpy as jnp

    from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE

    dtype = getattr(jnp, dtype)
    sde = DoubleWellSDE(q_mat=jnp.asarray([[0.8]], dtype))
    grid = jnp.linspace(0.0, 4.0, t_points, dtype=dtype)
    linearize = jax.jit(lambda m: m.set_linearized_prior())
    models = []
    for j in range(batch):
        rng = np.random.default_rng(100 + j)
        obs_idx = np.arange(7 + j, t_points - 1, 13)
        obs_t = grid[obs_idx]
        obs_y = jnp.asarray(
            np.sign(np.sin((1.1 + 0.2 * j) * np.asarray(obs_t)))[:, None]
            + 0.2 * rng.normal(size=(len(obs_idx), 1)), dtype)
        models.append(linearize(CVISitesSDE.initialize(
            prior_ssm=None, time_grid=grid, input_data=(obs_t, obs_y),
            likelihood=Gaussian(variance=jnp.asarray(0.04, dtype)),
            prior_initial_state=GaussianState(
                mu=jnp.full((1,), 0.1 * j, dtype), cov=jnp.asarray([[0.8 + 0.1 * j]], dtype)),
            prior_sde=sde, stabilize_ssm=True, clip_state_transitions=(-1.0, 1.0),
        )))
    return models


def port_cvi_dp(jmodel, sde_name="DoubleWellSDE"):
    """The port's CPU twin of a JAX ``CVISitesSDE``."""
    from vi_diffusion_processes_tpu_torch import interop

    tree = to_np(jmodel)
    return interop.cvi_dp_from_numpy(
        tree,
        interop.sde_from_numpy(sde_name, tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"),
        device="cpu",
    )


def row_perturbation(x, row, seed=11):
    """``x [B, T]`` with row ``row`` replaced by other values of its range."""
    rng = np.random.default_rng(seed)
    out = x.copy()
    out[row] = x[row] * rng.uniform(0.8, 1.2, x.shape[-1])
    return out
