"""The port's generic (unpacked) CVI-DP update rules against the JAX package.

The models are those of ``tests/unit/test_cvi_dp_packed_batched.py:28-55``
(double well, T = 300), built and linearized by the JAX package and carried
across by ``interop``.  Tolerances are that test's own: float64 rtol 1e-8 on
the sites and 1e-10 on the ELBOs; float32 5e-3 on the sites and 2e-4 on the
ELBOs.  On the CPU ``dist_q.marginals()`` runs the plain versions of K1 and
K2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSSM as JCVISitesSSM
from vi_diffusion_processes_tpu.optim.trainers import CVISitesTrainer as JTrainer
from vi_diffusion_processes_tpu.sde.utils import ssm_kl_with_grads_wrt_exp_params as j_ssm_kl
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSSM
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer
from vi_diffusion_processes_tpu_torch.sde.utils import ssm_kl_with_grads_wrt_exp_params

from .helpers import assert_close_scaled, double_well_models, port_cvi_dp, to_np

LR = 0.3
TOL = {"float64": (1e-8, 1e-10), "float32": (5e-3, 2e-4)}


def _site_arrays(m):
    return {
        "g_nat1": m.girsanov_sites.nat1, "g_nat2_diag": m.girsanov_sites.nat2_diag,
        "g_nat2_sub": m.girsanov_sites.nat2_sub, "d_nat1": m.data_sites.nat1,
        "d_nat2": m.data_sites.nat2, "fx_mus": m.fx_mus, "fx_covs": m.fx_covs,
    }


def _assert_sites_close(tmodel, jmodel, tol):
    ref = _site_arrays(jmodel)
    for name, got in _site_arrays(tmodel).items():
        assert got.numpy().dtype == np.asarray(ref[name]).dtype, name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[name]), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.fixture(scope="module", params=["float64", "float32"])
def models(request):
    jmodel = double_well_models(batch=2, dtype=request.param)[1]
    return request.param, jmodel, port_cvi_dp(jmodel)


def test_three_generic_steps_match_jax(models):
    dtype, jmodel, tmodel = models
    site_tol, elbo_tol = TOL[dtype]
    jstep = jax.jit(lambda m: m.update_data_sites(LR).update_girsanov_sites(LR))
    jelbo = jax.jit(lambda m: m.classic_elbo())
    for _ in range(3):
        jmodel = jstep(jmodel)
        tmodel = tmodel.update_data_sites(LR).update_girsanov_sites(LR)
        assert not tmodel.fx_mus.requires_grad and not tmodel.girsanov_sites.nat1.requires_grad
        np.testing.assert_allclose(float(tmodel.classic_elbo().detach()), float(jelbo(jmodel)),
                                   rtol=elbo_tol, atol=elbo_tol)
    _assert_sites_close(tmodel, jmodel, site_tol)


def test_kl_and_its_gradients_match_jax(models):
    dtype, jmodel, tmodel = models
    site_tol, elbo_tol = TOL[dtype]
    jkl, jgrads = jax.jit(lambda m: m.grad_kl_wrt_exp_param())(jmodel)
    tkl, tgrads = tmodel.grad_kl_wrt_exp_param()
    np.testing.assert_allclose(float(tkl), float(jkl), rtol=max(elbo_tol, 1e-9))
    for g, r in zip(tgrads, jgrads):
        assert not g.requires_grad
        assert_close_scaled(g.numpy(), np.asarray(r), site_tol)
    np.testing.assert_allclose(float(tmodel.kl_q_p().detach()), float(jkl), rtol=max(elbo_tol, 1e-9))
    obj, (g1, g2) = tmodel.local_objective_and_gradients(
        *tmodel._obs_moments(tmodel.fx_mus, tmodel.fx_covs))
    jobj, (j1, j2) = jmodel.local_objective_and_gradients(
        *jmodel._obs_moments(jmodel.fx_mus, jmodel.fx_covs))
    np.testing.assert_allclose(float(obj), float(jobj), rtol=max(elbo_tol, 1e-9))
    assert_close_scaled(g1.numpy(), np.asarray(j1), site_tol)
    assert_close_scaled(g2.numpy(), np.asarray(j2), site_tol)


def test_generic_step_matches_the_packed_step():
    """Inside the port, float64: the two routes make the same updates."""
    tmodel = port_cvi_dp(double_well_models(batch=1)[0])
    state = tp.pack_state(tmodel)
    for _ in range(3):
        tmodel = tmodel.update_data_sites(LR).update_girsanov_sites(LR)
        state, elbo = tp.packed_natgrad_step(tmodel, state, LR)
        np.testing.assert_allclose(float(tmodel.classic_elbo().detach()), float(elbo), rtol=1e-8)
    _assert_sites_close(tmodel, tp.unpack_state(tmodel, state), 1e-8)


def test_generic_trainer_matches_jax():
    jmodel = double_well_models(batch=1)[0]
    tmodel = port_cvi_dp(jmodel)
    jtrainer = JTrainer(jmodel, sites_lr=0.5, max_inner_iters=5, use_packed=False)
    ttrainer = CVISitesTrainer(tmodel, sites_lr=0.5, max_inner_iters=5, use_packed=False)
    jelbo, telbo = jtrainer.perform_inference(), ttrainer.perform_inference()
    np.testing.assert_allclose(telbo, jelbo, rtol=1e-8)
    np.testing.assert_allclose(ttrainer.elbo_trace, jtrainer.elbo_trace, rtol=1e-8)
    _assert_sites_close(ttrainer.model, jtrainer.model, 1e-8)
    # the packed route from the same start takes the same steps
    packed = CVISitesTrainer(tmodel, sites_lr=0.5, max_inner_iters=5)
    np.testing.assert_allclose(packed.perform_inference(), telbo, rtol=1e-8)


def _ssm_prior_models():
    """``CVISitesSSM`` on a linear (SSM) prior: the linearized double well."""
    jsde = double_well_models(batch=1)[0]
    jmodel = JCVISitesSSM.initialize(
        jsde.dist_p, jsde.time_grid,
        (jsde.time_grid[jsde.obs_indices], jsde.observations), jsde.likelihood,
    )
    tsde = port_cvi_dp(jsde)
    tmodel = CVISitesSSM.initialize(
        tsde.dist_p, tsde.time_grid,
        (tsde.time_grid[tsde.obs_indices], tsde.observations), tsde.likelihood,
    )
    return jmodel, tmodel


def test_ssm_prior_model_matches_jax():
    jmodel, tmodel = _ssm_prior_models()
    jstep = jax.jit(lambda m: m.update_data_sites(LR).update_girsanov_sites(LR))
    for _ in range(2):
        jmodel = jstep(jmodel)
        tmodel = tmodel.update_data_sites(LR).update_girsanov_sites(LR)
    _assert_sites_close(tmodel, jmodel, 1e-8)
    np.testing.assert_allclose(float(tmodel.kl_q_p().detach()), float(jmodel.kl_q_p()), rtol=1e-9)
    np.testing.assert_allclose(float(tmodel.classic_elbo().detach()), float(jmodel.classic_elbo()),
                               rtol=1e-9)
    jkl, jgrads = j_ssm_kl(jmodel.dist_q, jmodel.dist_p)
    tkl, tgrads = ssm_kl_with_grads_wrt_exp_params(tmodel.dist_q, tmodel.dist_p)
    np.testing.assert_allclose(float(tkl), float(jkl), rtol=1e-9)
    # with q near p the gradients are differences of terms of order 1/(dt q):
    # held to the sites' absolute tolerance
    for g, r in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8, atol=1e-8)


def test_trainer_on_an_ssm_prior_takes_the_generic_route():
    _, tmodel = _ssm_prior_models()
    trainer = CVISitesTrainer(tmodel, max_inner_iters=3, max_outer_iters=1)
    elbos = trainer.optimize()
    assert len(elbos) == 1 and np.isfinite(elbos[0])
    assert len(trainer.elbo_trace) >= 1 and np.all(np.diff(trainer.elbo_trace) > -1e-6)
