"""The port's non-conjugate CVI (``models/cvi.py``) against the JAX package
and against its own exact GPR.

The Poisson cases of ``cvi_cases.py`` (Matern12 and Matern32, n = 64, lr
0.3, float64) against the JAX package to 1e-9 (``cvi_cases.py`` says how);
a Gaussian likelihood at lr 1 against GPR; the loss's kernel gradient
against differences.  The Bernoulli cases are in
``test_torch_cvi_bernoulli.py``, the packed step in
``test_torch_cvi_packed.py``.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.cvi import CVIGaussianProcess
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression

from .cvi_cases import STEPS, check_evaluations, check_update_sites, jax_cvi, port_cvi
from .helpers import assert_close_scaled

#: the closed-form variational expectations; Bernoulli's quadrature is in
#: test_torch_cvi_bernoulli.py
NAMES = ["matern12-poisson", "matern32-poisson"]


@pytest.mark.parametrize("name", NAMES)
def test_update_sites_matches_jax(name):
    check_update_sites(name)


@pytest.mark.parametrize("name", NAMES)
def test_marginals_and_elbos_match_jax(name):
    check_evaluations(name)


def test_classic_elbo_rises():
    """The classic ELBO improves, monotonically after warm-up
    (tests/integration/test_cvi.py:47-60)."""
    model = port_cvi(jax_cvi("matern32-poisson", lr=0.5))
    elbos = []
    with torch.no_grad():
        for _ in range(16):
            elbos.append(float(model.classic_elbo()))
            model = model.update_sites()
    assert elbos[-1] > elbos[0]
    assert elbos[-1] >= elbos[-2] - 1e-8


def _gaussian_data():
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 4, size=25))
    y = (np.sin(2 * t) + 0.2 * rng.normal(size=25))[:, None]
    return torch.tensor(t), torch.tensor(y)


def test_gaussian_likelihood_at_lr_one_is_gpr():
    """With a Gaussian likelihood and lr 1 one update gives the exact sites:
    both ELBOs equal the GPR log-likelihood and the posteriors agree
    (tests/integration/test_cvi.py:22-44)."""
    noise = 0.08
    t, y = _gaussian_data()
    kernel = Matern32(lengthscale=0.9, variance=1.1)
    model = CVIGaussianProcess.initialize(kernel, Gaussian(noise), t, y, learning_rate=1.0)
    gpr = GaussianProcessRegression(kernel, t, y, torch.tensor([[np.sqrt(noise)]]))
    with torch.no_grad():
        model = model.update_sites()
        want = float(gpr.log_likelihood())
        np.testing.assert_allclose(float(model.elbo()), want, rtol=1e-8)
        np.testing.assert_allclose(float(model.classic_elbo()), want, rtol=1e-8)
        q_means, q_covs = model.dist_q.marginals()
        p_means, p_covs = gpr.posterior_state_space_model().marginals()
    np.testing.assert_allclose(q_means.numpy(), p_means.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(q_covs.numpy(), p_covs.numpy(), rtol=1e-6, atol=1e-8)


def test_loss_gradient_in_the_kernel_matches_differences():
    """``loss()`` is differentiable in the kernel's parameters: its gradient
    against central differences (step 1e-6, rtol 1e-5)."""
    model = port_cvi(jax_cvi("matern32-bernoulli"))
    with torch.no_grad():
        for _ in range(2):
            model = model.update_sites()
    kernel = model.kernel
    model.loss().backward()
    for name, param in kernel.named_parameters():
        with torch.no_grad():
            base = param.clone()
            param.copy_(base + 1e-6)
            up = float(model.loss())
            param.copy_(base - 1e-6)
            down = float(model.loss())
            param.copy_(base)
        np.testing.assert_allclose(float(param.grad), (up - down) / 2e-6, rtol=1e-5,
                                   err_msg=name)


def test_predictions_at_the_training_points():
    """The posterior process at the training points gives the smoothed
    marginals, and ``predict_log_density`` is the likelihood's predictive
    density there."""
    model = port_cvi(jax_cvi("matern12-poisson"))
    with torch.no_grad():
        for _ in range(STEPS):
            model = model.update_sites()
        f_mu, f_var = model.posterior_marginals_f()
        p_mu, p_var = model.posterior.predict_f(model.time_points)
        density = model.predict_log_density(model.time_points, model.observations)
    assert_close_scaled(p_mu.numpy(), f_mu.numpy(), 1e-8)
    assert_close_scaled(p_var.numpy(), f_var.numpy(), 1e-6)
    want = model.likelihood.predict_density(f_mu, f_var, model.observations)
    assert_close_scaled(density.numpy(), want.numpy(), 1e-6)
