"""The port's Poisson and Bernoulli likelihoods and the quadrature defaults
of the likelihood base class against the JAX package.

Means and variances of q(f) and counts from a numpy seed, float64; every
quantity to rtol 1e-12 of its scale.  Bernoulli's log-probability takes
``logaddexp(0, f)``, which ``softplus`` would miss by up to 1e-10 above its
threshold of 20: the inputs reach ``|f| = 30``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.likelihoods.discrete import Bernoulli as JBernoulli
from vi_diffusion_processes_tpu.likelihoods.discrete import Poisson as JPoisson
from vi_diffusion_processes_tpu_torch.likelihoods.discrete import Bernoulli, Poisson

from .helpers import assert_close_scaled

RTOL = 1e-12
LIKELIHOODS = {
    "poisson": (lambda: JPoisson(), lambda: Poisson()),
    "poisson-binsize": (lambda: JPoisson(binsize=0.5), lambda: Poisson(binsize=0.5)),
    "bernoulli": (lambda: JBernoulli(), lambda: Bernoulli()),
}


def _inputs(name):
    rng = np.random.default_rng(5)
    f = np.concatenate([rng.normal(0.0, 1.5, size=(37, 1)), [[-30.0], [25.0], [30.0]]])
    f_vars = rng.uniform(0.05, 2.0, size=f.shape)
    if name.startswith("poisson"):
        y = rng.poisson(np.exp(np.clip(f, -5, 3))).astype(np.float64)
    else:
        y = (rng.uniform(size=f.shape) < 0.5).astype(np.float64)
    return f, f_vars, y


def _pair(name):
    make_j, make_t = LIKELIHOODS[name]
    return make_j(), make_t()


@pytest.mark.parametrize("name", list(LIKELIHOODS))
def test_log_density_and_variational_expectations(name):
    jlik, tlik = _pair(name)
    f, f_vars, y = _inputs(name)
    t = [torch.tensor(x) for x in (f, f_vars, y)]
    assert_close_scaled(tlik.log_probability_density(t[0], t[2]).numpy(),
                        jlik.log_probability_density(jnp.asarray(f), jnp.asarray(y)), RTOL)
    assert_close_scaled(tlik.variational_expectations(*t).numpy(),
                        jlik.variational_expectations(*(jnp.asarray(x) for x in (f, f_vars, y))),
                        RTOL)


@pytest.mark.parametrize("name", list(LIKELIHOODS))
def test_predict_density_and_moments(name):
    jlik, tlik = _pair(name)
    f, f_vars, y = _inputs(name)
    f, f_vars = f[:-3], f_vars[:-3]  # exp(30) would dominate the Poisson moments' scale
    y = y[:-3]
    jf, jv, jy = (jnp.asarray(x) for x in (f, f_vars, y))
    tf, tv, ty = (torch.tensor(x) for x in (f, f_vars, y))
    assert_close_scaled(tlik.predict_density(tf, tv, ty).numpy(),
                        jlik.predict_density(jf, jv, jy), RTOL)
    for got, want in zip(tlik.predict_mean_and_var(tf, tv), jlik.predict_mean_and_var(jf, jv)):
        assert_close_scaled(got.numpy(), want, RTOL)


def test_bernoulli_log_probability_is_exact_far_out():
    """``y·f − log(1 + eᶠ)`` at ``f = ±25``: ``−log(1 + e⁻²⁵) ≈ −1.4e-11``
    for y = 1, f = 25, which ``softplus`` would give as 0; the subtraction
    itself loses the digits below 25's spacing of 3.6e-15."""
    f = torch.tensor([[25.0], [-25.0]], dtype=torch.float64)
    got = Bernoulli().log_probability_density(f, torch.ones_like(f)).numpy()
    want = [-np.log1p(np.exp(-25.0)), -25.0 - np.log1p(np.exp(-25.0))]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
