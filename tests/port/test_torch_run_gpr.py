"""The port's ``run_gpr`` against the JAX package's, and the port's dense
route against the JAX package's channelized one.

``run_gpr`` takes 60 Adam steps on a dataset that the JAX package draws
(``jax.random``) and that is carried across as numpy arrays; float64.  The
60 losses, NLPD, RMSE and the learned hyperparameters agree to 1e-6: Adam's
moments accumulate the rounding differences of 60 gradients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vi_diffusion_processes_tpu import kernels as jk
from vi_diffusion_processes_tpu.exp import runners as jrunners
from vi_diffusion_processes_tpu.models.gpr import GaussianProcessRegression as JGPR
from vi_diffusion_processes_tpu.parallel import pskf as jpskf
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_gpr
from vi_diffusion_processes_tpu_torch.kernels.matern import OrnsteinUhlenbeck
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression

from .helpers import port_kernel, to_np

A = jnp.asarray


@functools.lru_cache(maxsize=None)
def _run_gpr_pair():
    config = dict(q=1.2)
    data = dict(prior_sde="ou", prior_sde_kwargs={"decay": 1.0}, t1=5.0, num_grid=501,
                num_observations=25, noise_stddev=0.2, seed=7)
    jconfig = jrunners.ExperimentConfig(**config, **data)
    jdataset = jrunners.make_dataset(jconfig)
    jout = jrunners.run_gpr(jconfig, jdataset)
    dataset = interop.dataset_from_numpy(to_np(jdataset), device="cpu")
    return jout, run_gpr(ExperimentConfig(**config), dataset), dataset


def test_run_gpr_matches_jax():
    jout, out, _ = _run_gpr_pair()
    assert len(out["losses"]) == 60
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-6)
    np.testing.assert_allclose(out["nlpd"], jout["nlpd"], rtol=1e-6)
    np.testing.assert_allclose(out["rmse"], jout["rmse"], rtol=1e-6)
    assert out["losses"][-1] < out["losses"][0]
    learned = interop.kernel_params_to_numpy(out["kernel"])
    np.testing.assert_allclose(learned["decay"], np.asarray(jout["kernel"].decay), rtol=1e-6)
    np.testing.assert_allclose(learned["diffusion"], np.asarray(jout["kernel"].diffusion),
                               rtol=1e-6)
    assert out["model"].kernel is out["kernel"]


def test_run_gpr_leaves_the_callers_kernel_alone():
    _, default, dataset = _run_gpr_pair()
    mine = OrnsteinUhlenbeck(decay=1.0, diffusion=1.2)
    out = run_gpr(ExperimentConfig(q=1.2), dataset, kernel=mine)
    assert out["kernel"] is not mine
    assert float(mine.decay) == 1.0 and float(mine.diffusion) == 1.2
    assert mine.decay.grad is None
    assert float(out["kernel"].decay) != 1.0
    # the same start gives the same run as the default kernel
    np.testing.assert_allclose(out["losses"], default["losses"], rtol=1e-12)


def test_dense_route_matches_the_channelized_route_of_the_jax_package():
    """At N = 4,100 the JAX package takes its channelized layout
    (``pskf.CH_THRESHOLD`` = 4,096); the port has one dense route.  Forward
    only, d = 2: the log-likelihood to 1e-8."""
    n = 4100
    assert n >= jpskf.CH_THRESHOLD
    rng = np.random.default_rng(9)
    t = np.linspace(0.0, 40.0, n)
    y = (np.sin(0.7 * t) + 0.25 * rng.normal(size=n))[:, None]
    jkernel = jk.Matern32(lengthscale=A(1.5), variance=A(0.8))
    ref = jax.jit(lambda: JGPR(kernel=jkernel, time_points=A(t), observations=A(y),
                               chol_obs_covariance=A([[0.3]])).log_likelihood())()
    with torch.no_grad():
        got = GaussianProcessRegression(
            port_kernel(jkernel), torch.tensor(t), torch.tensor(y),
            torch.tensor([[0.3]], dtype=torch.float64)).log_likelihood()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-8)
