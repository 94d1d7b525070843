"""Joint posterior sampling by Matheron's correction
(``ConditionalProcess.sample_state_trajectories``, ``sample_state``,
``sample_f``) against the JAX package's predictions.

A Matern32 GPR posterior on 20 points from a numpy seed
(tests/integration/test_posterior_sampling.py:13-25), float64, built in the
port and in the JAX package from the same arrays.  Samples cannot match
``jax.random``'s, so the port's samples are held to the moments that the JAX
package's ``predict_state``, ``predict_f``, posterior chain and smoother
give: every mean within 5 standard errors, every variance and covariance
within 5 of theirs (``√((σ_a²σ_b² + σ_ab²)/(S−1))``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels.matern import Matern32 as JMatern32
from vi_diffusion_processes_tpu.models.gpr import GaussianProcessRegression as JGPR
from vi_diffusion_processes_tpu.parallel.pskf import filter_smoother_with_sites
from vi_diffusion_processes_tpu.parallel.sites import gaussian_observation_sites
from vi_diffusion_processes_tpu.ssm.mean_functions import LinearMeanFunction as JLinear
from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
from vi_diffusion_processes_tpu_torch.ssm.mean_functions import LinearMeanFunction

NOISE = 0.1
S = 20_000


def _data():
    rng = np.random.default_rng(8)
    t = np.sort(rng.uniform(0, 4, size=20))
    y = (np.sin(2 * t) + 0.3 * rng.normal(size=20))[:, None]
    return t, y


@functools.lru_cache(maxsize=None)
def _gpr(mean_coefficient=None):
    t, y = _data()
    mean = None if mean_coefficient is None else LinearMeanFunction(coefficient=mean_coefficient)
    return GaussianProcessRegression(
        kernel=Matern32(lengthscale=0.8, variance=1.2), time_points=torch.tensor(t),
        observations=torch.tensor(y), chol_obs_covariance=torch.tensor([[np.sqrt(NOISE)]]),
        mean_function=mean)


def _jax_gpr(mean_coefficient=None):
    t, y = _data()
    mean = None if mean_coefficient is None else JLinear(coefficient=jnp.asarray(mean_coefficient))
    return JGPR(kernel=JMatern32(lengthscale=jnp.asarray(0.8), variance=jnp.asarray(1.2)),
                time_points=jnp.asarray(t), observations=jnp.asarray(y),
                chol_obs_covariance=jnp.asarray([[np.sqrt(NOISE)]]), mean_function=mean)


def _jax(fn, *args):
    """``fn(*args)`` jitted, as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _assert_moments(samples, mean, cov):
    """``samples [S, M, k]`` against the mean ``[M, k]`` and the covariance
    ``[M, k, k]`` of each point."""
    s = samples.shape[0]
    centred = samples - samples.mean(0)
    emp = np.einsum("smi,smj->mij", centred, centred) / (s - 1)
    var = np.diagonal(cov, axis1=-2, axis2=-1)
    assert np.all(np.abs(samples.mean(0) - mean) < 5.0 * np.sqrt(var / s))
    se = np.sqrt((var[:, :, None] * var[:, None, :] + cov**2) / (s - 1))
    assert np.all(np.abs(emp - cov) < 5.0 * se)


def test_sample_state_matches_predict_state():
    post = _gpr().posterior
    with torch.no_grad():
        t_new = torch.tensor([-0.5, 0.3, 1.1, 1.1001, 2.9, 4.6])
        samples = post.sample_state(t_new, torch.Generator().manual_seed(0), (S,))
    means, covs = _jax(lambda t: _jax_gpr().posterior.predict_state(t), jnp.asarray(t_new.numpy()))
    assert tuple(samples.shape) == (S, 6, 2)
    _assert_moments(samples.numpy(), means, covs)


def test_sample_f_matches_predict_f_with_a_mean_function():
    post = _gpr(0.5).posterior
    with torch.no_grad():
        t_new = torch.linspace(0.5, 3.5, 7, dtype=torch.float64)
        f = post.sample_f(t_new, torch.Generator().manual_seed(1), (S,))
    mean, var = _jax(lambda t: _jax_gpr(0.5).posterior.predict_f(t), jnp.asarray(t_new.numpy()))
    assert tuple(f.shape) == (S, 7, 1)
    _assert_moments(f.numpy(), mean, var[..., None])


def test_conditioning_samples_match_the_posterior_chain():
    post = _gpr().posterior
    with torch.no_grad():
        _, u = post.sample_state_trajectories(
            torch.tensor([1.0]), torch.Generator().manual_seed(2), (S,))
    means, covs = _jax(lambda: _jax_gpr().posterior.dist.marginals())
    assert tuple(u.shape) == (S, 20, 2)
    _assert_moments(u.numpy(), means, covs)


def test_two_points_in_one_interval_have_the_exact_joint():
    """The cross-covariance of two new points between the same pair of
    conditioning points, against the smoother on the grid that holds them
    (tests/integration/test_posterior_sampling.py:35-80)."""
    gpr = _gpr()
    t_pts = gpr.time_points.numpy()
    t_new = np.array([t_pts[7] + 0.25 * (t_pts[8] - t_pts[7]), 0.5 * (t_pts[7] + t_pts[8])])
    with torch.no_grad():
        samples = gpr.posterior.sample_state(
            torch.tensor(t_new), torch.Generator().manual_seed(3), (S,))[..., 0].numpy()
    t_all = np.sort(np.concatenate([t_pts, t_new]))
    idx = np.searchsorted(t_all, t_new)
    y_dense = np.zeros((len(t_all), 1))
    observed = np.isin(t_all, t_pts)
    y_dense[observed] = gpr.observations.numpy()

    def smoother(grid, y_dense, mask):
        jgpr = _jax_gpr()
        nat1, nat2, _ = gaussian_observation_sites(
            jgpr.kernel.generate_emission_model(grid).emission_matrix,
            jgpr.chol_obs_covariance, y_dense)
        _, smooth = filter_smoother_with_sites(
            jgpr.kernel.state_space_model(grid), nat1 * mask[:, None], nat2 * mask[:, None, None])
        return smooth.means, smooth.covs, smooth.gains

    means, covs, gains = _jax(smoother, jnp.asarray(t_all), jnp.asarray(y_dense),
                              jnp.asarray(observed, jnp.float64))
    # Cov(x_a, x_b) for consecutive a < b: E_a S_b
    cross = (gains[idx[0]] @ covs[idx[1]])[0, 0]
    var = covs[idx, 0, 0]
    want = np.array([[var[0], cross], [cross, var[1]]])
    assert idx[1] == idx[0] + 1
    _assert_moments(samples[:, None, :], means[idx, 0][None], want[None])


@pytest.mark.parametrize("sample_shape", [(), (3,), (2, 2), (0,)])
def test_sample_shapes(sample_shape):
    post = _gpr().posterior
    with torch.no_grad():
        s, u = post.sample_state_trajectories(torch.tensor([0.2, 3.0, 5.0]),
                                              torch.Generator().manual_seed(4), sample_shape)
    assert tuple(s.shape) == tuple(sample_shape) + (3, 2)
    assert tuple(u.shape) == tuple(sample_shape) + (20, 2)
