"""The port's sparse PEP (``models/sparse_pep.py``) against the JAX package,
float64, on the data of docs/examples/sparse_pep_classification.py at
n = 80 with M = 15 inducing points (Bernoulli, α = 1, lr 0.5), under
Matern12 (d = 1: the leave-fraction-out posteriors are one batched pivot
sweep, kernel K1 on the card) and the example's Matern52 (d = 3).

The pair sites and the per-site normalizers after each of three
``update_sites``, and after the last the classic ELBO, the predictive
density and the energy (with the normalizers of the M + 1
leave-fraction-out posteriors), to 1e-9 of their scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import Matern12 as JMatern12
from vi_diffusion_processes_tpu.kernels import Matern52 as JMatern52
from vi_diffusion_processes_tpu.likelihoods import Bernoulli as JBernoulli
from vi_diffusion_processes_tpu.likelihoods.pep import PEPScalarLikelihood as JPEPLik
from vi_diffusion_processes_tpu.models import SparsePowerExpectationPropagation as JSparsePEP
from vi_diffusion_processes_tpu_torch import interop

from .helpers import assert_close_scaled, port_kernel, to_np

RTOL, STEPS = 1e-9, 3
CASES = {"matern12": (JMatern12, 0.15), "matern52": (JMatern52, 0.08)}


def _data(n=80):
    """docs/examples/sparse_pep_classification.py:20-24 at n points."""
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 1.0, n)
    f_true = np.cos(t * 20.0)
    y = ((f_true + rng.normal(size=n)) > 0).astype(float)[:, None]
    return t, y


def _jax_model(name):
    cls, lengthscale = CASES[name]
    return JSparsePEP.initialize(
        kernel=cls(lengthscale=jnp.asarray(lengthscale), variance=jnp.asarray(1.0)),
        likelihood=JPEPLik(base=JBernoulli()),
        inducing_points=jnp.asarray(np.linspace(0.0, 1.0, 15)), alpha=1.0, learning_rate=0.5)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    data = tuple(jnp.asarray(x) for x in _data())
    model = _jax_model(name)
    step = jax.jit(lambda m: m.update_sites(data))
    states = []
    for _ in range(STEPS):
        model = step(model)
        states.append(tuple(np.asarray(x) for x in (model.nat1, model.nat2, model.log_norm)))
    evals = jax.jit(lambda m: (m.classic_elbo(data), m.predict_log_density(data),
                               m.energy(data)))(model)
    return states, [np.asarray(x) for x in evals]


def _port_model(name):
    jmodel = _jax_model(name)
    lik = interop.likelihood_from_numpy(("Bernoulli", {}), "cpu", name="PEPScalarLikelihood")
    return interop.sparse_pep_from_numpy(to_np(jmodel), port_kernel(jmodel.kernel), lik,
                                         device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_update_sites_matches_jax(name):
    states, _ = _jax_run(name)
    model, data = _port_model(name), tuple(torch.tensor(x) for x in _data())
    for k, (nat1, nat2, log_norm) in enumerate(states):
        model = model.update_sites(data)
        assert_close_scaled(model.nat1.numpy(), nat1, RTOL, err_msg=f"nat1 {k + 1}")
        assert_close_scaled(model.nat2.numpy(), nat2, RTOL, err_msg=f"nat2 {k + 1}")
        assert_close_scaled(model.log_norm.numpy(), log_norm, RTOL, err_msg=f"log_norm {k + 1}")


@pytest.mark.parametrize("name", list(CASES))
def test_elbo_density_and_energy_match_jax(name):
    _, (elbo, density, energy) = _jax_run(name)
    model, data = _port_model(name), tuple(torch.tensor(x) for x in _data())
    for _ in range(STEPS):
        model = model.update_sites(data)
    with torch.no_grad():
        assert_close_scaled(model.classic_elbo(data).numpy(), elbo, RTOL)
        assert float(model.loss(data)) == -float(model.elbo(data))
        assert_close_scaled(model.predict_log_density(data).numpy(), density, RTOL)
        assert_close_scaled(model.energy(data).numpy(), energy, RTOL)


def test_fractions_and_converter_round_trip():
    jmodel = _jax_model("matern12")
    model = _port_model("matern12")
    t = torch.tensor(_data()[0])
    np.testing.assert_array_equal(model.fraction_sites(t).numpy(),
                                  np.asarray(jmodel.fraction_sites(jnp.asarray(_data()[0]))))
    tree = to_np(jmodel)
    back = interop.fields_to_numpy(model)
    for k in ("inducing_points", "nat1", "nat2", "log_norm"):
        np.testing.assert_array_equal(back[k], tree[k])
