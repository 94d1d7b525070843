"""The port against the JAX package's golden traces of GPR, of VDP and of
batched drift learning (``tests/golden/traces.npz``).

The GPR goldens are one log-likelihood and its three gradients, rtol 1e-6.
The other two runs take discrete branches on ELBO comparisons or accumulate Adam
moments, so they are in float64 and must reproduce the recorded traces to
rtol 1e-6 (the learned parameters to 1e-5), as the JAX golden test does.
Whatever the JAX package draws with ``jax.random`` (the VDP dataset, the
simulated paths) is drawn by the JAX package here and carried across as
numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.golden.generate import GOLDEN_PATH, SEED
from vi_diffusion_processes_tpu.exp.runners import ExperimentConfig as JConfig
from vi_diffusion_processes_tpu.exp.runners import make_dataset
from vi_diffusion_processes_tpu.sde.utils import euler_maruyama as j_euler_maruyama
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_vdp
from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32, OrnsteinUhlenbeck
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

from .helpers import to_np


VDP_CONFIG = dict(prior_sde="ou", prior_sde_kwargs={"decay": 1.0}, q=1.0, vdp_lr=0.05,
                  vdp_warmup_steps=5, max_outer_iters=10)


def _vdp_dataset():
    """The VDP golden's dataset (``tests/golden/generate.py:75-88``), drawn by
    the JAX package."""
    data = dict(t1=5.0, num_grid=501, num_observations=25, noise_stddev=0.2, seed=SEED)
    return interop.dataset_from_numpy(to_np(make_dataset(JConfig(**VDP_CONFIG, **data))),
                                      device="cpu")


def test_gpr_reproduces_golden_loglik_and_gradients():
    """``tests/golden/generate.py:35-61``: Matern32 on 1,000 sorted uniform
    points; the gradients in lengthscale, variance and noise."""
    rng = np.random.default_rng(SEED)
    n = 1000
    t = np.sort(rng.uniform(0.0, 50.0, size=n))
    y = (np.sin(0.7 * t) + 0.25 * rng.normal(size=n))[:, None]
    kernel = Matern32(lengthscale=1.5, variance=0.8)
    noise = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    model = GaussianProcessRegression(kernel, torch.tensor(t), torch.tensor(y), noise[None, None])
    loglik = model.log_likelihood()
    loglik.backward()
    golden = np.load(GOLDEN_PATH)
    np.testing.assert_allclose(float(loglik.detach()), golden["gpr_loglik"], rtol=1e-6)
    grads = [float(kernel.lengthscale.grad), float(kernel.variance.grad), float(noise.grad)]
    np.testing.assert_allclose(grads, golden["gpr_grads"], rtol=1e-6)


def test_exact_loglik_of_the_vdp_dataset_reproduces_golden():
    """``tests/golden/generate.py:90-99``: the exact smoother log-likelihood
    under the OU kernel, the anchor of the VDP trace."""
    dataset = _vdp_dataset()
    model = GaussianProcessRegression(
        OrnsteinUhlenbeck(decay=1.0, diffusion=1.0), dataset.obs_times, dataset.obs_values,
        torch.tensor([[0.2]], dtype=torch.float64))
    with torch.no_grad():
        loglik = float(model.log_likelihood())
    np.testing.assert_allclose(loglik, np.load(GOLDEN_PATH)["vdp_exact_loglik"], rtol=1e-6)


def test_run_vdp_reproduces_golden_elbos():
    """``tests/golden/generate.py:64-100``: OU prior, 501-point grid."""
    out = run_vdp(ExperimentConfig(**VDP_CONFIG), _vdp_dataset())
    golden = np.load(GOLDEN_PATH)["vdp_elbos"]
    np.testing.assert_allclose(np.asarray(out["elbos"]), golden, rtol=1e-6)
    assert np.isfinite(out["nlpd"]) and np.isfinite(out["rmse"])
    assert out["posterior_means"].shape == (501, 1) and out["posterior_covs"].shape == (501, 1, 1)
    assert bool((out["posterior_covs"] > 0).all())
    assert not out["posterior_means"].requires_grad


def test_batched_learning_reproduces_golden_trace_and_parameters():
    """``tests/golden/generate.py:161-246`` with the port's generic update
    rules: three trajectories share one SDE, five site steps each, then one
    Adam(0.05) step on the summed ``∂(KL − VE)/∂θ_p`` over every leaf of the
    SDE (``q_mat`` included), three times."""
    batch, n = 3, 501
    grid_j = jnp.linspace(0.0, 5.0, n)
    true_sde = JDoubleWell(q_mat=jnp.asarray([[0.8]]))
    key = jax.random.PRNGKey(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    obs_idx = np.arange(10, n - 1, 10)

    grid = torch.tensor(np.asarray(grid_j))
    sde = DoubleWellSDE(q=[[0.8]], scale=2.0, c=0.5)
    likelihood = Gaussian(0.04)
    models = []
    for i in range(batch):
        path = j_euler_maruyama(true_sde, jnp.asarray([1.0]), grid_j, jax.random.fold_in(key, i))
        obs_y = np.asarray(path)[obs_idx] + 0.2 * rng.normal(size=(len(obs_idx), 1))
        models.append(CVISitesSDE.initialize_sde(
            sde, grid, (grid[obs_idx], torch.tensor(obs_y)), likelihood))

    opt = torch.optim.Adam(sde.parameters(), lr=0.05)
    mean_trace = []
    for _outer in range(3):
        for _inner in range(5):
            models = [m.update_data_sites(0.5).update_girsanov_sites(0.5) for m in models]
            with torch.no_grad():
                mean_trace.append(float(np.mean([float(m.classic_elbo()) for m in models])))
        grads = [(m.grad_kl_wrt_prior_params(), m.grad_ve_wrt_prior_params()) for m in models]
        for name, p in sde.named_parameters():
            p.grad = sum(g_kl[name] + g_ve[name] for g_kl, g_ve in grads)
        opt.step()
        models = [m.set_linearized_prior() for m in models]

    golden = np.load(GOLDEN_PATH)
    np.testing.assert_allclose(mean_trace, golden["batched_learning_elbos"], rtol=1e-6)
    np.testing.assert_allclose([float(sde.scale.detach()), float(sde.c.detach())],
                               golden["batched_learned_params"], rtol=1e-5)
