"""The port's sparse CVI (``models/sparse_cvi.py``) against the JAX package
and against its own exact GPR.

n = 200 points on [0, 10] from a numpy seed, m = 20 inducing points on
[−0.05, 10.05], lr 0.8, float64: Matern12 under a Poisson likelihood (d = 1:
``dist_q`` runs the pivot sweep and the scalar recurrences, kernels K1 and
K2 on the card) and Matern32 under a Bernoulli one (d = 2: the
Schur-segment UDU').  Three ``update_sites``; the pair sites after each,
``classic_elbo`` and ``predict_log_density`` before the first and after the
last, to 1e-9 of their scale.  One jitted JAX function per case takes a step
and evaluates the model it was given.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import Matern12 as JMatern12
from vi_diffusion_processes_tpu.kernels import Matern32 as JMatern32
from vi_diffusion_processes_tpu.likelihoods import Bernoulli as JBernoulli
from vi_diffusion_processes_tpu.likelihoods import Poisson as JPoisson
from vi_diffusion_processes_tpu.models.sparse_cvi import SparseCVIGaussianProcess as JSparse
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
from vi_diffusion_processes_tpu_torch.models.sparse_cvi import SparseCVIGaussianProcess

from .helpers import assert_close_scaled, port_kernel, to_np

RTOL = 1e-9
STEPS = 3
CASES = {"matern12-poisson": (JMatern12, JPoisson), "matern32-bernoulli": (JMatern32, JBernoulli)}


def _data(likelihood):
    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(0.0, 10.0, size=200))
    f = np.sin(0.9 * t) + 0.3
    if likelihood == "Poisson":
        y = rng.poisson(np.exp(f)).astype(np.float64)
    else:
        y = (rng.uniform(size=t.shape) < 1.0 / (1.0 + np.exp(-2.0 * f))).astype(np.float64)
    return t, y[:, None]


def _jax_model(name):
    kernel_cls, lik_cls = CASES[name]
    kernel = kernel_cls(lengthscale=jnp.asarray(1.3), variance=jnp.asarray(0.8))
    return JSparse.initialize(kernel, lik_cls(), jnp.linspace(-0.05, 10.05, 20),
                              learning_rate=0.8)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    data = tuple(jnp.asarray(x) for x in _data(CASES[name][1].__name__))
    step_and_eval = jax.jit(lambda m, xy: (m.update_sites(xy), m.classic_elbo(xy),
                                           m.predict_log_density(xy)))
    model, sites, evals = _jax_model(name), [], []
    for _ in range(STEPS + 1):
        new, elbo, density = step_and_eval(model, data)
        sites.append((np.asarray(new.nat1), np.asarray(new.nat2)))
        evals.append((np.asarray(elbo), np.asarray(density)))
        model = new
    return sites[:STEPS], (evals[0], evals[STEPS])


def _port_model(name):
    jmodel = _jax_model(name)
    lik = interop.likelihood_from_numpy({}, "cpu", name=CASES[name][1].__name__)
    return interop.sparse_cvi_from_numpy(to_np(jmodel), port_kernel(jmodel.kernel), lik,
                                         device="cpu")


def _port_data(name):
    return tuple(torch.tensor(x) for x in _data(CASES[name][1].__name__))


@pytest.mark.parametrize("name", list(CASES))
def test_update_sites_matches_jax(name):
    sites, _ = _jax_run(name)
    model, data = _port_model(name), _port_data(name)
    for k, (nat1, nat2) in enumerate(sites):
        model = model.update_sites(data)
        assert_close_scaled(model.nat1.numpy(), nat1, RTOL, err_msg=f"nat1, step {k + 1}")
        assert_close_scaled(model.nat2.numpy(), nat2, RTOL, err_msg=f"nat2, step {k + 1}")


@pytest.mark.parametrize("name", list(CASES))
def test_classic_elbo_and_predictive_density_match_jax(name):
    _, evals = _jax_run(name)
    model, data = _port_model(name), _port_data(name)
    for k, (elbo, density) in enumerate(evals):
        if k:
            for _ in range(STEPS):
                model = model.update_sites(data)
        with torch.no_grad():
            assert_close_scaled(model.classic_elbo(data).numpy(), elbo, RTOL)
            assert_close_scaled(model.predict_log_density(data).numpy(), density, RTOL)
        assert float(model.loss(data).detach()) == -float(model.elbo(data).detach())


def test_gaussian_sparse_cvi_is_gpr_when_dense():
    """Inducing points on the data and lr 1: the sites reach the exact
    posterior, so the ELBO is the GPR log-likelihood
    (tests/integration/test_sparse_models.py:44-62)."""
    noise = 0.1
    rng = np.random.default_rng(9)
    t = np.sort(rng.uniform(0, 4, size=24))
    y = (np.sin(2 * t) + 0.3 * rng.normal(size=24))[:, None]
    t, y = torch.tensor(t), torch.tensor(y)
    kernel = Matern32(lengthscale=0.8, variance=1.2)
    model = SparseCVIGaussianProcess.initialize(kernel, Gaussian(noise), t, learning_rate=1.0)
    gpr = GaussianProcessRegression(kernel, t, y, torch.tensor([[np.sqrt(noise)]]))
    with torch.no_grad():
        for _ in range(2):
            model = model.update_sites((t, y))
        np.testing.assert_allclose(float(model.classic_elbo((t, y))), float(gpr.log_likelihood()),
                                   rtol=1e-6)
        q_means, _ = model.dist_q.marginals()
        p_means, _ = gpr.posterior_state_space_model().marginals()
    np.testing.assert_allclose(q_means.numpy(), p_means.numpy(), rtol=1e-5, atol=1e-6)
