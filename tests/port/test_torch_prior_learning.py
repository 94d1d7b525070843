"""Drift learning: the port's prior gradients against the JAX package.

The model is ``bench.py``'s double-well flagship cut in T, after 5 packed
site steps so that the posterior is away from its initial path.  Both
gradients are taken with respect to every parameter of the SDE (``q_mat``,
``scale`` and ``c``); the port's flow through the pivot sweep and the
recurrences by their custom backward passes, the JAX package's by autodiff
of its CPU scans.  Tolerances: float64 rtol 1e-8 of each gradient (the two
sides differ in scan association and in the adjoint's summation order);
float32 model (float64 naturals) 1e-3 of each gradient's scale.  The same
in float64 under the MLP drift of ``prior_sde/mlpdrift.yaml`` (``q_mat``,
``w1``, ``b1``, ``w2``, ``b2``; JAX's ``PRNGKey(0)`` draw) at T = 1,000,
where the drift's Jacobian is that of its relus, by ``jacrev`` on both
sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.models import cvi_dp_packed as jp
from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE as JCVISitesSDE
from vi_diffusion_processes_tpu.sde.utils import Gaussian as JGaussian
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu.sde.zoo import MLPDrift as JMLPDrift
from vi_diffusion_processes_tpu_torch import interop

from .helpers import assert_close_scaled, to_np

PARAMS = ("q_mat", "scale", "c")
MLP_PARAMS = ("q_mat", "w1", "b1", "w2", "b2")


@functools.lru_cache(maxsize=None)
def _models(t_size, dtype, prior="dw"):
    """The flagship cut to ``t_size`` points after 5 site steps: JAX, port;
    with ``prior="mlp"`` under the MLP drift instead of the double well."""
    dtype = getattr(jnp, dtype)
    grid = jnp.linspace(0.0, 10.0, t_size, dtype=dtype)
    rng = np.random.default_rng(0)
    obs_idx = np.arange(10, t_size - 1, max(10, t_size // 200))
    obs_t = grid[obs_idx]
    obs_y = jnp.asarray(np.sign(np.sin(0.6 * np.asarray(obs_t)))[:, None]
                        + 0.2 * rng.normal(size=(len(obs_idx), 1)), dtype)
    jmodel = jax.jit(lambda m: m.set_linearized_prior())(JCVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid, input_data=(obs_t, obs_y),
        likelihood=JGaussianLik(variance=jnp.asarray(0.04, dtype)),
        prior_initial_state=JGaussian(mu=jnp.zeros((1,), dtype), cov=jnp.asarray([[0.8]], dtype)),
        prior_sde=(JMLPDrift.initialize(jax.random.PRNGKey(0), jnp.asarray([[0.8]], dtype))
                   if prior == "mlp" else JDoubleWell(q_mat=jnp.asarray([[0.8]], dtype))),
    ))
    state = jp.pack_state(jmodel)
    step = jax.jit(jp.packed_natgrad_step)
    for _ in range(5):
        state, _ = step(jmodel, state, 0.3)
    jmodel = jp.unpack_state(jmodel, state)
    tree = to_np(jmodel)
    tmodel = interop.cvi_dp_from_numpy(
        tree,
        interop.sde_from_numpy("MLPDrift" if prior == "mlp" else "DoubleWellSDE",
                               tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"),
        device="cpu",
    )
    return jmodel, tmodel


@pytest.mark.parametrize("t_size,dtype,rtol", [(5000, "float64", 1e-8), (2000, "float32", 1e-3)],
                         ids=["f64-T5000", "f32-T2000"])
@pytest.mark.parametrize("which", ["kl", "ve"])
def test_prior_gradients_match_jax(which, t_size, dtype, rtol):
    jmodel, tmodel = _models(t_size, dtype)
    method = f"grad_{which}_wrt_prior_params"
    ref = jax.jit(lambda m: getattr(m, method)())(jmodel)
    got = getattr(tmodel, method)()
    assert sorted(got) == sorted(PARAMS)
    for name in PARAMS:
        g, r = got[name].detach().numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        assert np.all(np.isfinite(g)) and np.any(g != 0), name
        if dtype == "float64":
            np.testing.assert_allclose(g, r, rtol=rtol, err_msg=name)
        else:
            assert_close_scaled(g, r, rtol, err_msg=name)


@pytest.mark.parametrize("which", ["kl", "ve"])
def test_mlp_prior_gradients_match_jax(which):
    jmodel, tmodel = _models(1000, "float64", "mlp")
    method = f"grad_{which}_wrt_prior_params"
    ref = jax.jit(lambda m: getattr(m, method)())(jmodel)
    got = getattr(tmodel, method)()
    assert sorted(got) == sorted(MLP_PARAMS)
    for name in MLP_PARAMS:
        g, r = got[name].detach().numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        assert np.all(np.isfinite(g)) and np.any(g != 0), name
        np.testing.assert_allclose(g, r, rtol=1e-8, err_msg=name)


def _port_vdp_model():
    """A small double-well VDP model with a non-trivial ``(A, b)``."""
    import torch

    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    rng = np.random.default_rng(3)
    grid = torch.linspace(0.0, 5.0, 256, dtype=torch.float64)
    obs_idx = np.arange(20, 255, 37)
    obs_y = torch.tensor(np.sign(np.sin(1.3 * grid[obs_idx].numpy()))[:, None]
                         + 0.2 * rng.normal(size=(len(obs_idx), 1)))
    model = VariationalMarkovGP.initialize(
        (grid[obs_idx], obs_y), DoubleWellSDE(q=[[0.8]]), grid, Gaussian(0.04))
    return model.replace(A=torch.tensor(rng.uniform(0.1, 0.8, size=tuple(model.A.shape))),
                         b=torch.tensor(rng.normal(0.0, 0.3, size=tuple(model.b.shape))))


@pytest.mark.parametrize("which", ["cvi", "vdp"])
def test_earlier_model_keeps_its_drift(which):
    """The reference builds a new SDE and a new model at every
    ``optimize_prior_sde`` and the old model keeps its drift
    (optim/trainers.py:141-146, :238-243).  So does the port: a model
    captured before the step gives bit for bit the same drift and the same
    prior gradients after it, while the trainer's model has moved."""
    import torch

    from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer

    if which == "cvi":
        before = _models(2000, "float64")[1]
        trainer = CVISitesTrainer(before, learn_prior_sde=True, prior_sde_lr=0.05)
        grad_name = "grad_kl_wrt_prior_params"
    else:
        before = _port_vdp_model()
        trainer = VDPTrainer(before, learn_prior_sde=True, prior_sde_lr=0.05)
        grad_name = "grad_prior_sde_params"
    x = torch.linspace(-2.0, 2.0, 9, dtype=torch.float64)[:, None]
    start = interop.sde_params_to_numpy(before.prior_sde)
    drift_before = before.prior_sde.drift(x).detach().clone()
    grads_before = {k: v.clone() for k, v in getattr(before, grad_name)().items()}

    for _ in range(2):
        trainer.optimize_prior_sde()

    assert trainer.model is not before
    assert trainer.model.prior_sde is not before.prior_sde
    learned = interop.sde_params_to_numpy(trainer.model.prior_sde)
    for name in PARAMS:
        assert np.all(learned[name] != start[name]), name
        np.testing.assert_array_equal(
            interop.sde_params_to_numpy(before.prior_sde)[name], start[name], err_msg=name)
    assert torch.equal(before.prior_sde.drift(x).detach(), drift_before)
    assert not torch.equal(trainer.model.prior_sde.drift(x).detach(), drift_before)
    grads_after = getattr(before, grad_name)()
    for name in PARAMS:
        assert torch.equal(grads_after[name], grads_before[name]), name
