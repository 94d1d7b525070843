"""The Van der Pol prior at d = 2 through the port, against the JAX package:
the SDE (drift, channel drift, Jacobian, expectations, the VDP drift
energy), ``interop.sde_from_numpy``, ``build_prior_sde``, both trainers
(with one outer iteration of drift learning) and both runners, float64.

The JAX CVI-DP trainer runs its generic update rules here
(``use_packed=False``): the port's trainer takes its packed d ≥ 2 step, and
``test_torch_cvi_dp_ch.py`` holds that step equal to the generic rules, so
the JAX package's packed step is not compiled again.  The trainers take
discrete branches on ELBO comparisons; runs agree to 1e-8 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.exp import runners as jrunners
from vi_diffusion_processes_tpu.exp.data import DPDataset as JDPDataset
from vi_diffusion_processes_tpu.exp.data import build_prior_sde as j_build
from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE as JCVISitesSDE
from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussian
from vi_diffusion_processes_tpu.models.vdp import VariationalMarkovGP as JVDP
from vi_diffusion_processes_tpu.optim.trainers import CVISitesTrainer as JCVITrainer
from vi_diffusion_processes_tpu.optim.trainers import VDPTrainer as JVDPTrainer
from vi_diffusion_processes_tpu.sde import utils as ju
from vi_diffusion_processes_tpu.sde.drift import LinearDrift as JLinearDrift
from vi_diffusion_processes_tpu.ssm.state_space_model import StateSpaceModel as JSSM
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.exp import runners as trunners
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_cvi_dp, run_vdp
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer
from vi_diffusion_processes_tpu_torch.sde import utils as tu
from vi_diffusion_processes_tpu_torch.sde.drift import LinearDrift

from .helpers import (
    assert_close_scaled,
    port_cvi_dp,
    to_np,
    vanderpol_data,
    vanderpol_model_jax,
)

RTOL = 1e-10
T = 64


def _pair(**kwargs):
    jsde = j_build("vanderpol", q=0.5, **kwargs)
    return jsde, interop.sde_from_numpy(type(jsde).__name__, to_np(jsde), device="cpu")


def _close(got, ref, rtol=RTOL, err_msg=""):
    assert_close_scaled(got.detach().numpy(), np.asarray(ref), rtol, err_msg=err_msg)


def test_drift_jacobian_and_expectations_match_jax():
    jsde, tsde = _pair(a=1.3, tau=0.7)
    assert tsde.state_dim == 2
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 7, 2))
    _close(tsde.drift(torch.tensor(x)), jsde.drift(jnp.asarray(x)))
    ch = tsde.drift_ch((torch.tensor(x[..., 0]), torch.tensor(x[..., 1])))
    jch = jsde.drift_ch((jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1])))
    for got, ref in zip(ch, jch):
        _close(got, ref)
    m = rng.normal(size=(30, 2))
    a = rng.normal(size=(30, 2, 2))
    s = a @ np.swapaxes(a, -1, -2) * 0.1 + 0.05 * np.eye(2)
    jm, js = jnp.asarray(m), jnp.asarray(s)
    _close(tsde.gradient_drift(torch.tensor(m)), jax.jit(jsde.gradient_drift)(jm))
    # the Jacobian in closed form: [[τa(1 − x₁²), −τa], [τ/a, 0]]
    jac = np.stack([np.stack([1.3 * 0.7 * (1 - m[:, 0] ** 2), np.full(30, -1.3 * 0.7)], -1),
                    np.stack([np.full(30, 0.7 / 1.3), np.zeros(30)], -1)], -2)
    _close(tsde.gradient_drift(torch.tensor(m)), jac)
    _close(tsde.expected_drift(torch.tensor(m), torch.tensor(s)),
           jax.jit(jsde.expected_drift)(jm, js))
    _close(tsde.expected_gradient_drift(torch.tensor(m), torch.tensor(s)),
           jax.jit(jsde.expected_gradient_drift)(jm, js))
    lin_a, lin_b = rng.normal(size=(30, 2, 2)), rng.normal(size=(30, 2))
    got = tu.squared_drift_difference_along_Gaussian_path(
        tsde, LinearDrift(A=torch.tensor(lin_a), b=torch.tensor(lin_b)),
        tu.Gaussian(torch.tensor(m), torch.tensor(s)), 0.01)
    ref = jax.jit(lambda m_, s_: ju.squared_drift_difference_along_Gaussian_path(
        jsde, JLinearDrift(A=jnp.asarray(lin_a), b=jnp.asarray(lin_b)), ju.Gaussian(m_, s_),
        0.01))(jm, js)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL)


def test_interop_and_build_prior_sde_know_vanderpol():
    jsde, tsde = _pair(a=1.3, tau=0.7)
    built = build_prior_sde("vanderpol", q=0.5, device="cpu", a=1.3, tau=0.7)
    for sde in (tsde, built):
        assert type(sde).__name__ == "VanderPolOscillatorSDE"
        params = interop.sde_params_to_numpy(sde)
        assert sorted(params) == sorted(to_np(jsde)) == ["a", "q_mat", "tau"]
        for name, value in params.items():
            np.testing.assert_array_equal(value, np.asarray(getattr(jsde, name)))
    default = build_prior_sde("vanderpol", device="cpu")
    assert default.q.tolist() == [[1.0, 0.0], [0.0, 1.0]] and default.a.item() == 1.0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_prior_sde("vanderpol")  # no card here, and no silent CPU
    with pytest.raises(ValueError, match="unknown SDE"):
        interop.sde_from_numpy("NoSuchSDE", {"q_mat": np.eye(2)}, device="cpu")


@pytest.fixture(scope="module")
def jax_model():
    return vanderpol_model_jax(T)


@pytest.fixture
def jitted_jax(monkeypatch):
    """The JAX model's methods that its trainers and runners call outside
    ``jax.jit``, jitted: eager, they compile op by op (``dist_q.marginals()``
    alone takes 10 s on the CPU)."""
    for cls, name in ((JCVISitesSDE, "set_linearized_prior"),
                      (JCVISitesSDE, "grad_kl_wrt_prior_params"),
                      (JCVISitesSDE, "grad_ve_wrt_prior_params"), (JSSM, "marginals")):
        monkeypatch.setattr(cls, name, lambda self, f=jax.jit(getattr(cls, name)): f(self))


def _port(jmodel):
    return port_cvi_dp(jmodel, "VanderPolOscillatorSDE")


def test_cvi_trainer_routes_by_state_dimension(jax_model):
    tmodel = _port(jax_model)
    assert CVISitesTrainer(tmodel)._packed[2].fn is tch.packed_natgrad_step_ch
    assert CVISitesTrainer(tmodel, use_packed=False)._packed is None
    # above d = 8 the generic update rules, as in the JAX trainer
    assert CVISitesTrainer(tmodel.replace(observations=torch.zeros(5, 9)))._packed is None


def test_cvi_trainer_at_d2_matches_jax(jax_model):
    """Two outer iterations (sites, re-linearization, re-basing) of the
    port's packed route against the JAX generic route; the port's generic
    route takes the same steps."""
    kwargs = dict(sites_lr=0.5, max_inner_iters=3, max_outer_iters=2)
    jtrainer = JCVITrainer(jax_model, use_packed=False, **kwargs)
    ttrainer = CVISitesTrainer(_port(jax_model), **kwargs)
    jelbos, telbos = jtrainer.optimize(), ttrainer.optimize()
    np.testing.assert_allclose(telbos, jelbos, rtol=1e-8)
    np.testing.assert_allclose(ttrainer.elbo_trace, jtrainer.elbo_trace, rtol=1e-8)
    for got, ref in zip(ttrainer.model.girsanov_sites, jtrainer.model.girsanov_sites):
        _close(got, ref, 1e-8)
    _close(ttrainer.model.fx_mus, jtrainer.model.fx_mus, 1e-8)
    generic = CVISitesTrainer(_port(jax_model), use_packed=False, **kwargs)
    np.testing.assert_allclose(generic.optimize(), telbos, rtol=1e-8)


def test_cvi_drift_learning_at_d2_matches_jax(jax_model, jitted_jax):
    """One outer iteration with ``learn_prior_sde=True``: Adam moves ``a``,
    ``tau`` and ``q_mat`` as the JAX trainer does."""
    kwargs = dict(sites_lr=0.5, max_inner_iters=2, max_outer_iters=1, learn_prior_sde=True,
                  prior_sde_lr=0.05)
    jtrainer = JCVITrainer(jax_model, use_packed=False, **kwargs)
    ttrainer = CVISitesTrainer(_port(jax_model), **kwargs)
    np.testing.assert_allclose(ttrainer.optimize(), jtrainer.optimize(), rtol=1e-8)
    learned = interop.sde_params_to_numpy(ttrainer.model.prior_sde)
    assert learned["a"].item() != 1.0 and learned["tau"].item() != 1.0
    for name, value in learned.items():
        np.testing.assert_allclose(value, np.asarray(getattr(jtrainer.model.prior_sde, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
    for got, ref in zip(ttrainer.model.prior_nats, jtrainer.model.prior_nats):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-8 * max(1.0, float(np.abs(ref).max())))


def _vdp_models(t_points=101):
    """A d = 2 VDP model on the Van der Pol prior, in both packages, with a
    non-trivial ``(A, b)`` so that every term of the step is exercised."""
    grid, obs_idx, obs_y = vanderpol_data(t_points)
    rng = np.random.default_rng(3)
    a0 = 0.3 * np.eye(2) + 0.1 * rng.normal(size=(t_points - 1, 2, 2))
    b0 = 0.1 * rng.normal(size=(t_points - 1, 2))
    jsde, tsde = _pair()
    jmodel = JVDP.initialize((jnp.asarray(grid[obs_idx]), jnp.asarray(obs_y)), jsde,
                             jnp.asarray(grid), JGaussian(variance=jnp.asarray(0.04)))
    jmodel = jmodel.replace(A=jnp.asarray(a0), b=jnp.asarray(b0))
    tmodel = interop.vdp_from_numpy(to_np(jmodel), tsde,
                                    interop.likelihood_from_numpy({"variance": 0.04}, "cpu"),
                                    device="cpu")
    return jmodel, tmodel


def test_vdp_trainer_at_d2_matches_jax():
    """``VDPTrainer`` at d = 2 runs the generic ``inference_step`` and
    ``elbo``, as the JAX trainer does."""
    jmodel, tmodel = _vdp_models()
    kwargs = dict(lr=0.05, x0_lr=0.02, warmup_steps=2, max_iters=4)
    jtrainer, ttrainer = JVDPTrainer(jmodel, **kwargs), VDPTrainer(tmodel, **kwargs)
    assert not ttrainer._packed
    np.testing.assert_allclose(ttrainer.optimize(n_rounds=1), jtrainer.optimize(n_rounds=1),
                               rtol=1e-8)
    np.testing.assert_allclose(ttrainer.elbo_trace, jtrainer.elbo_trace, rtol=1e-8)
    for name in ("A", "b", "lambda_lagrange", "psi_lagrange", "q_initial_mean", "q_initial_cov"):
        _close(getattr(ttrainer.model, name), getattr(jtrainer.model, name), 1e-8, name)


@pytest.fixture(scope="module")
def dataset():
    """The training observations of ``vanderpol_model_jax`` (so that the
    runners' JAX programs are those of the model above, compiled once) and
    three test points between them, as a dataset of each package."""
    grid, obs_idx, obs_y = vanderpol_data(T)
    test_idx = np.array([15, 40, 55])
    t = grid[test_idx]
    test_y = np.stack([np.sin(1.1 * t), np.cos(1.1 * t)], -1)
    test_y += 0.2 * np.random.default_rng(6).normal(size=test_y.shape)
    arrays = dict(latent_path=np.zeros((T, 2)), time_grid=grid, obs_times=grid[obs_idx],
                  obs_values=obs_y, test_times=t, test_values=test_y, x0=np.ones(2))
    jdata = JDPDataset(noise_stddev=0.2, **{k: jnp.asarray(v) for k, v in arrays.items()})
    return jdata, interop.dataset_from_numpy(dict(arrays, noise_stddev=0.2), device="cpu")


def test_run_cvi_dp_on_vanderpol_matches_jax(dataset, monkeypatch, jitted_jax):
    jdata, tdata = dataset
    kwargs = dict(prior_sde="vanderpol", q=0.5, sites_lr=0.5, max_inner_iters=3,
                  max_outer_iters=2, clip_state_transitions=(-2.0, 2.0))
    monkeypatch.setattr(jrunners, "CVISitesTrainer",
                        functools.partial(JCVITrainer, use_packed=False))
    ref = jrunners.run_cvi_dp(jrunners.ExperimentConfig(**kwargs), jdata)
    out = run_cvi_dp(ExperimentConfig(**kwargs), tdata)
    np.testing.assert_allclose(out["elbos"], ref["elbos"], rtol=1e-8)
    _close(out["posterior_means"], ref["posterior_means"], 1e-8)
    _close(out["posterior_covs"], ref["posterior_covs"], 1e-8)
    assert out["posterior_covs"].shape == (T, 2, 2)
    for key in ("nlpd", "rmse"):  # the full-covariance NLPD at d = 2
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-8, err_msg=key)


def test_run_vdp_on_vanderpol_matches_jax(dataset, monkeypatch, jitted_jax):
    """``run_vdp`` with both runners' trainers held to 10 fixed-point steps."""
    jdata, tdata = dataset
    monkeypatch.setattr(jrunners, "VDPTrainer", functools.partial(JVDPTrainer, max_iters=10))
    monkeypatch.setattr(trunners, "VDPTrainer", functools.partial(VDPTrainer, max_iters=10))
    kwargs = dict(prior_sde="vanderpol", q=0.5, vdp_lr=0.01, vdp_warmup_steps=2)
    ref = jrunners.run_vdp(jrunners.ExperimentConfig(**kwargs), jdata)
    out = run_vdp(ExperimentConfig(**kwargs), tdata)
    assert isinstance(out["model"], VariationalMarkovGP) and out["model"].state_dim == 2
    np.testing.assert_allclose(out["elbos"], ref["elbos"], rtol=1e-8)
    _close(out["posterior_means"], ref["posterior_means"], 1e-8)
    _close(out["posterior_covs"], ref["posterior_covs"], 1e-8)
    for key in ("nlpd", "rmse"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-8, err_msg=key)
