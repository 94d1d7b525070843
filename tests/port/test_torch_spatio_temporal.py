"""The port's spatio-temporal models (``models/spatio_temporal.py``) against
the JAX package, on the data and model of ``spatio_cases``.

* ``SpatioTemporalSparseCVI``: three generic ``update_sites`` at
  ``m_space`` ∈ {1, 3} (d = 2 and 6), the sites after each step, and
  ``elbo``, ``space_time_predict_f`` and ``predict_log_density`` before the
  first step and after the last, to 1e-9 of their scale in float64;
* ``SpatioTemporalSparseVariational``: the ELBO and its gradient in every
  field of ``dist_q`` at a perturbed ``q``, to 1e-9, and a short Adam run
  that raises the ELBO (tests/integration/test_spatio_temporal.py:36-64);
* the dense-GPR oracle of tests/integration/test_spatio_temporal_oracle.py:20
  on the port alone: data on the space × time inducing grid, ten steps at
  lr 1, the ELBO equal to the dense product-kernel log marginal likelihood
  and the predictive mean to its posterior mean.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.models.spatio_temporal import (
    SpatioTemporalSparseVariational as JVariational,
)
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12
from vi_diffusion_processes_tpu_torch.kernels.spatial import SpatialMatern32
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.spatio_temporal import SpatioTemporalSparseCVI

from . import spatio_cases as sc
from .helpers import SSM_FIELDS, assert_close_scaled, port_kernel, to_np, trainable_ssm

RTOL = 1e-9


@pytest.mark.parametrize("m_space", [1, 3])
def test_generic_update_sites_matches_jax(m_space):
    sites, _ = sc.jax_generic(m_space)
    model, xy = sc.port_model(m_space), sc.port_data()
    for k, (nat1, nat2) in enumerate(sites):
        model = model.update_sites(xy)
        assert_close_scaled(model.nat1.numpy(), nat1, RTOL, err_msg=f"nat1, step {k + 1}")
        assert_close_scaled(model.nat2.numpy(), nat2, RTOL, err_msg=f"nat2, step {k + 1}")


@pytest.mark.parametrize("m_space", [1, 3])
def test_elbo_prediction_and_density_match_jax(m_space):
    _, evals = sc.jax_generic(m_space)
    model, xy = sc.port_model(m_space), sc.port_data()
    for k, (elbo, (f_mu, f_var), density) in enumerate(evals):
        if k:
            for _ in range(sc.STEPS):
                model = model.update_sites(xy)
        with torch.no_grad():
            assert_close_scaled(model.elbo(xy).numpy(), elbo, RTOL, err_msg=f"elbo {k}")
            mu, var = model.space_time_predict_f(xy[0])
            assert_close_scaled(mu.numpy(), f_mu, RTOL, err_msg=f"mean {k}")
            assert_close_scaled(var.numpy(), f_var, RTOL, err_msg=f"var {k}")
            assert_close_scaled(model.predict_log_density(xy).numpy(), density, RTOL)
            assert float(model.loss(xy)) == -float(model.elbo(xy))


def _perturbed_q(jq, seed=3):
    """The prior SSM with its offsets, initial mean and transitions moved,
    so that no gradient vanishes by symmetry."""
    rng = np.random.default_rng(seed)
    return jq.replace(
        state_offsets=jq.state_offsets + 0.05 * rng.normal(size=jq.state_offsets.shape),
        initial_mean=jq.initial_mean + 0.1 * rng.normal(size=jq.initial_mean.shape),
        state_transitions=jq.state_transitions
        * (1.0 + 0.01 * rng.normal(size=jq.state_transitions.shape)),
    )


@functools.lru_cache(maxsize=None)
def _jax_variational():
    cvi = sc.jax_model(3)
    model = JVariational.initialize(
        cvi.kernel.inducing_space, cvi.inducing_time, cvi.kernel.kernel_space,
        cvi.kernel.kernel_time, cvi.likelihood, num_data=300,
    )
    model = model.replace(dist_q=_perturbed_q(model.dist_q))
    xy = sc.jax_data()
    value, grads = jax.jit(jax.value_and_grad(lambda q: model.replace(dist_q=q).elbo(xy)))(
        model.dist_q)
    return model, np.asarray(value), {f: np.asarray(getattr(grads, f)) for f in SSM_FIELDS}


def _port_variational(jmodel):
    lik = interop.likelihood_from_numpy(to_np(jmodel.likelihood), "cpu")
    return interop.spatio_variational_from_numpy(to_np(jmodel), port_kernel(jmodel.kernel), lik,
                                                 device="cpu")



def test_variational_elbo_and_gradient_match_jax():
    jmodel, value, grads = _jax_variational()
    model = _port_variational(jmodel)
    assert model.num_data == 300
    q = trainable_ssm(model.dist_q)
    elbo = model.replace(dist_q=q).elbo(sc.port_data())
    elbo.backward()
    assert_close_scaled(elbo.detach().numpy(), value, RTOL)
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(q, f).grad.numpy(), grads[f], RTOL, err_msg=f)


def test_variational_adam_raises_the_elbo():
    """Adam on every field of ``dist_q`` from the prior
    (tests/integration/test_spatio_temporal.py:36-64, 40 steps at 0.05;
    here 15 steps at 0.02 from the prior)."""
    jmodel = _jax_variational()[0]
    model = _port_variational(jmodel)
    model = model.replace(dist_q=trainable_ssm(interop._ssm(to_np(jmodel.kernel.state_space_model(
        jmodel.inducing_time)), "cpu")))
    xy = sc.port_data()
    leaves = [getattr(model.dist_q, f) for f in SSM_FIELDS]
    opt = torch.optim.Adam(leaves, lr=0.02)
    losses = []
    for _ in range(15):
        opt.zero_grad()
        loss = model.loss(xy)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_cvi_at_the_inducing_grid_is_dense_gpr():
    """The port's twin of tests/integration/test_spatio_temporal_oracle.py:20."""
    x_unique = np.array([0.0, 0.6, 1.0])
    t_unique = np.array([2.0, 2.5, 3.0, 3.75])
    xx, tt = np.meshgrid(x_unique, t_unique)
    inputs = np.stack([xx.ravel(), tt.ravel()], axis=-1)
    inputs = inputs[np.argsort(inputs[:, 1], kind="stable")]
    y = np.random.default_rng(0).normal(size=(inputs.shape[0], 1))
    noise = 0.35
    ks = SpatialMatern32(variance=1.3, lengthscale=0.7)
    kt = Matern12(lengthscale=1.1, variance=0.9)
    model = SpatioTemporalSparseCVI.initialize(
        torch.tensor(x_unique[:, None]), torch.tensor(t_unique), ks, kt, Gaussian(noise),
        learning_rate=1.0)
    xy = (torch.tensor(inputs), torch.tensor(y))
    for _ in range(10):
        model = model.update_sites(xy)

    with torch.no_grad():
        ks_gram = ks(xy[0][:, :1]).numpy()
    kt_gram = 0.9 * np.exp(-np.abs(inputs[:, 1:2] - inputs[:, 1:2].T) / 1.1)
    k = ks_gram * kt_gram
    kn = k + noise * np.eye(len(y))
    alpha = np.linalg.solve(kn, y[:, 0])
    loglik = (-0.5 * y[:, 0] @ alpha - np.log(np.diag(np.linalg.cholesky(kn))).sum()
              - 0.5 * len(y) * np.log(2 * np.pi))
    with torch.no_grad():
        np.testing.assert_allclose(float(model.elbo(xy)), loglik, rtol=1e-6, atol=1e-6)
        st_mean, _ = model.space_time_predict_f(xy[0])
    np.testing.assert_allclose(st_mean.numpy()[:, 0], k @ alpha, rtol=1e-5, atol=1e-6)


def test_dist_p_and_dist_q_match_jax():
    """The kernel holds one temporal module M times: its prior SSM and the
    posterior SSM after three steps equal the JAX package's: the prior to
    1e-12 of each field's scale (``chol Q`` of ``P∞ − A P∞ Aᵀ`` loses 3-4
    digits to cancellation, and the two packages round that difference
    apart by up to 5e-14), the posterior to 1e-9."""
    jmodel = sc.jax_model(3)
    model = sc.port_model(3)
    jp = jmodel.dist_p
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(model.dist_p, f).detach().numpy(),
                            np.asarray(getattr(jp, f)), 1e-12, err_msg=f)
    sites, _ = sc.jax_generic(3)
    jq = jax.jit(lambda m: m.dist_q)(jmodel.replace(nat1=jnp.asarray(sites[-1][0]),
                                                    nat2=jnp.asarray(sites[-1][1])))
    q = model.replace(nat1=torch.tensor(sites[-1][0]), nat2=torch.tensor(sites[-1][1])).dist_q
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(q, f).detach().numpy(), np.asarray(getattr(jq, f)), RTOL,
                            err_msg=f)


def test_converters_round_trip():
    jmodel = sc.jax_model(3)
    tree = to_np(jmodel)
    back = interop.fields_to_numpy(sc.port_model(3))
    for k in ("inducing_time", "nat1", "nat2"):
        np.testing.assert_array_equal(back[k], tree[k])
    assert back["learning_rate"] == tree["learning_rate"] and back["num_data"] is None
    jvar = _jax_variational()[0]
    back = interop.fields_to_numpy(_port_variational(jvar))
    for f in SSM_FIELDS:
        np.testing.assert_array_equal(back["dist_q"][f], np.asarray(getattr(jvar.dist_q, f)))
