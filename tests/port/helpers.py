"""Helpers for carrying JAX values into the port's tests."""
import dataclasses

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from vi_diffusion_processes_tpu_torch.ops._build import KERNELS


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


class NoHostSync(TorchFunctionMode):
    """Fails on every call that reads a value on the host or copies one to
    the device, and on every checked ``torch.linalg`` factorization and
    data-dependent shape (boolean masks, ``nonzero``, ``unique``), which wait
    for the device: what stream capture refuses on the card."""

    BANNED = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__float__,
              torch.Tensor.__int__, torch.Tensor.__index__, torch.Tensor.tolist,
              torch.Tensor.cpu, torch.Tensor.numpy, torch.tensor,
              torch.linalg.cholesky, torch.linalg.inv, torch.linalg.solve, torch.linalg.eigh,
              torch.linalg.lu_factor, torch.cholesky, torch.inverse,
              torch.nonzero, torch.Tensor.nonzero, torch.unique, torch.masked_select}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        host_copy = (func in (torch.as_tensor, torch.asarray)
                     and not isinstance(args[0], torch.Tensor))
        masked = (func is torch.Tensor.__getitem__ and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if isinstance(args[1], tuple) else (args[1],))))
        if func in self.BANNED or host_copy or masked:
            raise AssertionError(f"host read or copy inside the step: {func.__name__}")
        return func(*args, **(kwargs or {}))


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: a route reads ``is_cuda``
    (``ops/quad_kl.py::kernel_drift``), and the kernels' wrappers then run
    their plain versions."""

    @property
    def is_cuda(self):
        return True


def decide_on_card(monkeypatch, module):
    """Make ``module.kernel_drift`` decide as for a tensor on the card: on
    CPU tensors the fused route runs the kernels' plain versions."""
    from vi_diffusion_processes_tpu_torch.ops import quad_kl

    monkeypatch.setattr(module, "kernel_drift", lambda sde, d, x, prefix: quad_kl.kernel_drift(
        sde, d, x.as_subclass(OnCard), prefix))


def all_launches(**nonzero):
    """The whole ``launch_counts()`` dict: every kernel of ``KERNELS`` at 0
    but those named in ``nonzero``; raises on a name that is no kernel."""
    unknown = sorted(set(nonzero) - set(KERNELS))
    if unknown:
        raise KeyError(f"not a kernel: {unknown}")
    return {name: nonzero.get(name, 0) for name in KERNELS}


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


def kernel_spec(jkernel):
    """A JAX kernel as the ``(name, leaves)`` pair that the port's
    ``interop.kernel_from_numpy`` takes: numpy leaves by field name for a
    leaf kernel, the list of its parts' pairs for a combinator."""
    name = type(jkernel).__name__
    if name == "SparseSpatioTemporalKernel":
        return name, {"kernel_space": kernel_spec(jkernel.kernel_space),
                      "kernel_time": kernel_spec(jkernel.kernel_time),
                      "inducing_space": np.array(jkernel.inducing_space)}
    if hasattr(jkernel, "kernels"):
        return name, [kernel_spec(k) for k in jkernel.kernels]
    return name, {k: v for k, v in to_np(jkernel).items() if v is not None}


def port_kernel(jkernel):
    """The port's CPU twin of a JAX kernel."""
    from vi_diffusion_processes_tpu_torch import interop

    return interop.kernel_from_numpy(*kernel_spec(jkernel), device="cpu")


def port_ssm(jssm):
    """The port's CPU twin of a JAX ``StateSpaceModel``."""
    from vi_diffusion_processes_tpu_torch import interop

    return interop._ssm(to_np(jssm), "cpu")


SSM_FIELDS = ("initial_mean", "chol_initial_covariance", "state_transitions",
              "state_offsets", "chol_process_covariances")


def trainable_ssm(ssm):
    """A copy of a port ``StateSpaceModel`` whose fields are leaves that
    require gradients."""
    from vi_diffusion_processes_tpu_torch.ssm.state_space_model import StateSpaceModel

    return StateSpaceModel(**{f: getattr(ssm, f).detach().clone().requires_grad_()
                              for f in SSM_FIELDS})


def assert_ssm_close(tssm, jssm, rtol):
    """Every field of a port SSM against the JAX one, ``rtol`` of its scale."""
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(tssm, f).detach().numpy(), np.asarray(getattr(jssm, f)),
                            rtol, err_msg=f)


def uneven_grid(rng, n, t1=10.0):
    """A sorted grid of ``n`` points on [0, t1] with uneven gaps."""
    return np.sort(rng.uniform(0.0, t1, size=n))


def vanderpol_data(t_points, dtype="float64", t1=2.0):
    """The grid, observation indices and observations of
    tests/unit/test_cvi_dp_packed_ch.py:24-54: ``(sin 1.1t, cos 1.1t)`` plus
    0.2·N(0, I₂) from ``default_rng(4)`` every 13 points from index 8."""
    grid = np.linspace(0.0, t1, t_points).astype(dtype)
    obs_idx = np.arange(8, t_points - 1, 13)
    t = grid[obs_idx].astype(np.float64)
    noise = np.random.default_rng(4).normal(size=(len(obs_idx), 2))
    obs_y = (np.stack([np.sin(1.1 * t), np.cos(1.1 * t)], -1) + 0.2 * noise).astype(dtype)
    return grid, obs_idx, obs_y


def vanderpol_model_jax(t_points, dtype="float64"):
    """The JAX ``CVISitesSDE`` of test_cvi_dp_packed_ch.py:24-54 (Van der
    Pol, a = τ = 1, q = 0.5·I₂, Gaussian likelihood 0.04, p(x₀) = N(0,
    0.5·I₂), clip (−2, 2)), linearized."""
    import jax
    import jax.numpy as jnp

    from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu.sde.zoo import VanderPolOscillatorSDE

    jdtype = getattr(jnp, dtype)
    grid, obs_idx, obs_y = vanderpol_data(t_points, dtype)
    sde = VanderPolOscillatorSDE(a=jnp.asarray(1.0, jdtype), tau=jnp.asarray(1.0, jdtype),
                                 q_mat=0.5 * jnp.eye(2, dtype=jdtype))
    model = CVISitesSDE.initialize(
        prior_ssm=None, time_grid=jnp.asarray(grid),
        input_data=(jnp.asarray(grid[obs_idx]), jnp.asarray(obs_y)),
        likelihood=Gaussian(variance=jnp.asarray(0.04, jdtype)),
        prior_initial_state=GaussianState(mu=jnp.zeros((2,), jdtype),
                                          cov=0.5 * jnp.eye(2, dtype=jdtype)),
        prior_sde=sde, stabilize_ssm=True, clip_state_transitions=(-2.0, 2.0),
    )
    return jax.jit(lambda m: m.set_linearized_prior())(model)


def vanderpol_model_port(t_points, dtype="float64", device="cpu"):
    """The same model built with the port's API alone."""
    import torch

    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE

    tdtype = getattr(torch, dtype)
    grid, obs_idx, obs_y = vanderpol_data(t_points, dtype)
    grid = torch.tensor(grid, device=device)
    eye = torch.eye(2, dtype=tdtype, device=device)
    model = CVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid,
        input_data=(grid[torch.tensor(obs_idx, device=device)], torch.tensor(obs_y, device=device)),
        likelihood=Gaussian(0.04, dtype=tdtype).to(device),
        prior_initial_state=GaussianState(mu=torch.zeros(2, dtype=tdtype, device=device),
                                          cov=0.5 * eye),
        prior_sde=VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * eye, dtype=tdtype).to(device),
        stabilize_ssm=True, clip_state_transitions=(-2.0, 2.0),
    )
    return model.set_linearized_prior()


def cvi_data(likelihood: str, n: int = 64):
    """``(t, y [n, 1])`` of tests/unit/test_cvi_packed.py:24-37: Poisson
    counts of rate ``exp(0.8 sin 1.1t)`` or Bernoulli labels of probability
    ``sigmoid(sin t)`` at ``n`` points on [0, 6], from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 6.0, n)
    if likelihood == "Poisson":
        y = rng.poisson(np.exp(0.8 * np.sin(1.1 * t))).astype(np.float64)
    else:
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-np.sin(t)))).astype(np.float64)
    return t, y[:, None]


def cvi_model_port(kernel: str, likelihood: str, n: int = 64, dtype="float64", device="cpu",
                   lr: float = 0.3):
    """A CVI model of those data built with the port's API alone: ``kernel``
    ``"Matern12"`` or ``"Matern32"`` (lengthscale 1.2, variance 0.9),
    ``likelihood`` ``"Poisson"`` or ``"Bernoulli"``."""
    import torch

    from vi_diffusion_processes_tpu_torch.kernels import matern
    from vi_diffusion_processes_tpu_torch.likelihoods import discrete
    from vi_diffusion_processes_tpu_torch.models.cvi import CVIGaussianProcess

    tdtype = getattr(torch, dtype)
    t, y = cvi_data(likelihood, n)
    k = getattr(matern, kernel)(lengthscale=1.2, variance=0.9, dtype=tdtype).to(device)
    return CVIGaussianProcess.initialize(
        k, getattr(discrete, likelihood)().to(device), torch.tensor(t, dtype=tdtype, device=device),
        torch.tensor(y, dtype=tdtype, device=device), learning_rate=lr)
