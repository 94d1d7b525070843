"""The port's power-EP likelihoods (``likelihoods/pep.py``) and PEP model
(``models/pep.py``) against the JAX package, float64.

* ``PEPScalarLikelihood(Bernoulli)``: the α-power log expected density, its
  first and second derivatives in μ and their ``gradient_correction`` at
  α ∈ {0.5, 1.0}, on means and variances that include a negative cavity
  variance (floored at 1e-300 under the root, as in the reference), to
  1e-10 of their scale; ``PEPGaussian`` in closed form;
* ``PowerExpectationPropagation`` on the data of
  docs/examples/pep_classification.py at n = 60 (Matern52, d = 3,
  Bernoulli, α = 0.9, lr 0.5): the sites and normalizers after each of
  three ``update_sites``, and the ELBO and the predictive density after the
  last, to 1e-9 of their scale; the energy to ``ENERGY_RTOL``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import Matern52 as JMatern52
from vi_diffusion_processes_tpu.likelihoods import Bernoulli as JBernoulli
from vi_diffusion_processes_tpu.likelihoods import Gaussian as JGaussian
from vi_diffusion_processes_tpu.likelihoods import pep as jpep
from vi_diffusion_processes_tpu.models import PowerExpectationPropagation as JPEP
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.likelihoods import pep
from vi_diffusion_processes_tpu_torch.likelihoods.discrete import Bernoulli
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian

from .helpers import assert_close_scaled, port_kernel, to_np

LIK_RTOL, RTOL, STEPS = 1e-10, 1e-9, 3
#: the energy holds ``A(q)``, the normalizer of the jitter-free posterior SSM,
#: whose ``chol Q̄`` (Matern52, Q̄ of order Δt⁵) keeps about 7 digits: a one-ulp
#: change of the lengthscale moves the JAX package's ``A(q)`` by 2.3e-5 here,
#: 1.0e-6 of the energy, and the port differs from it by 8.4e-6 (3.6e-7)
ENERGY_RTOL = 1e-6


def _moments(seed=0, n=25):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(n, 1)) * 2.0
    var = rng.uniform(0.05, 3.0, size=(n, 1))
    var[3, 0] = -0.2  # a cavity that lost positive definiteness
    y = (rng.uniform(size=(n, 1)) < 0.5).astype(np.float64)
    return mu, var, y


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_pep_likelihood_matches_jax(alpha):
    mu, var, y = _moments()
    jlik = jpep.PEPScalarLikelihood(base=JBernoulli())
    jled, (jg1, jg2) = jlik.grad_log_expected_density(jnp.asarray(mu), jnp.asarray(var),
                                                      jnp.asarray(y), alpha=alpha)
    jl1, jl2 = jpep.gradient_correction((jnp.asarray(mu), jnp.asarray(var)), (jg1, jg2))
    lik = pep.PEPScalarLikelihood(Bernoulli())
    led, (g1, g2) = lik.grad_log_expected_density(torch.tensor(mu), torch.tensor(var),
                                                  torch.tensor(y), alpha=alpha)
    l1, l2 = pep.gradient_correction((torch.tensor(mu), torch.tensor(var)), (g1, g2))
    for got, want, name in ((led, jled, "I"), (g1, jg1, "dI"), (g2, jg2, "d2I"), (l1, jl1, "L1"),
                            (l2, jl2, "L2")):
        assert_close_scaled(got.numpy(), np.asarray(want), LIK_RTOL, err_msg=name)
    assert not g2.requires_grad


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_pep_gaussian_matches_jax(alpha):
    mu, var, _ = _moments(1)
    y = np.random.default_rng(2).normal(size=mu.shape)
    jlik = jpep.PEPGaussian(base=JGaussian(variance=jnp.asarray(0.3)))
    jled, (jg1, jg2) = jlik.grad_log_expected_density(
        jnp.asarray(mu), jnp.asarray(np.abs(var)), jnp.asarray(y), alpha=alpha)
    lik = interop.likelihood_from_numpy(("Gaussian", {"variance": np.asarray(0.3)}), "cpu",
                                        name="PEPGaussian")
    assert isinstance(lik, pep.PEPGaussian) and isinstance(lik.base, Gaussian)
    led, (g1, g2) = lik.grad_log_expected_density(
        torch.tensor(mu), torch.tensor(np.abs(var)), torch.tensor(y), alpha=alpha)
    for got, want in ((led, jled), (g1, jg1), (g2, jg2)):
        assert_close_scaled(got.numpy(), np.asarray(want), LIK_RTOL)
    with torch.no_grad():
        assert_close_scaled(lik.variational_expectations(torch.tensor(mu), torch.tensor(
            np.abs(var)), torch.tensor(y)).numpy(), np.asarray(jlik.variational_expectations(
                jnp.asarray(mu), jnp.asarray(np.abs(var)), jnp.asarray(y))), LIK_RTOL)


def _data(n=60):
    """docs/examples/pep_classification.py:18-23 at n points."""
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 6, size=n))
    f_true = 4.0 * np.sin(1.5 * t)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-f_true))).astype(float)[:, None]
    return t, y


def _jax_model():
    t, y = _data()
    return JPEP.initialize(
        kernel=JMatern52(lengthscale=jnp.asarray(1.0), variance=jnp.asarray(4.0)),
        likelihood=jpep.PEPScalarLikelihood(base=JBernoulli()),
        time_points=jnp.asarray(t), observations=jnp.asarray(y), alpha=0.9, learning_rate=0.5)


@functools.lru_cache(maxsize=None)
def _jax_run():
    model = _jax_model()
    step = jax.jit(lambda m: m.update_sites())
    states = []
    for _ in range(STEPS):
        model = step(model)
        states.append((np.asarray(model.sites.nat1), np.asarray(model.sites.nat2),
                       np.asarray(model.site_log_norm)))
    t, y = _data()
    evals = jax.jit(lambda m: (m.energy(), m.elbo(), m.predict_log_density(
        (jnp.asarray(t), jnp.asarray(y)))))(model)
    return states, [np.asarray(x) for x in evals]


def _port_model():
    jmodel = _jax_model()
    lik = interop.likelihood_from_numpy(("Bernoulli", {}), "cpu", name="PEPScalarLikelihood")
    return interop.pep_from_numpy(to_np(jmodel), port_kernel(jmodel.kernel), lik, device="cpu")


def test_pep_update_sites_matches_jax():
    states, _ = _jax_run()
    model = _port_model()
    for k, (nat1, nat2, log_norm) in enumerate(states):
        model = model.update_sites()
        assert_close_scaled(model.sites.nat1.numpy(), nat1, RTOL, err_msg=f"nat1 {k + 1}")
        assert_close_scaled(model.sites.nat2.numpy(), nat2, RTOL, err_msg=f"nat2 {k + 1}")
        assert_close_scaled(model.site_log_norm.numpy(), log_norm, RTOL, err_msg=f"norm {k + 1}")


def test_pep_energy_elbo_and_density_match_jax():
    _, (energy, elbo, density) = _jax_run()
    model = _port_model()
    for _ in range(STEPS):
        model = model.update_sites()
    data = tuple(torch.tensor(x) for x in _data())
    with torch.no_grad():
        assert_close_scaled(model.energy().numpy(), energy, ENERGY_RTOL)
        assert_close_scaled(model.elbo().numpy(), elbo, RTOL)
        assert float(model.loss()) == -float(model.elbo())
        assert_close_scaled(model.predict_log_density(data).numpy(), density, RTOL)


def test_pep_converter_round_trip():
    jmodel = _jax_model()
    tree = to_np(jmodel)
    back = interop.fields_to_numpy(_port_model())
    for k in ("time_points", "observations", "site_log_norm"):
        np.testing.assert_array_equal(back[k], tree[k])
    for k in ("nat1", "nat2"):
        np.testing.assert_array_equal(back["sites"][k], tree["sites"][k])
    assert (back["alpha"], back["learning_rate"]) == (0.9, 0.5)
