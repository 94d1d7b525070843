"""The port's ``run_cvi_dp`` against the JAX package's golden ELBO trace.

Same configuration as ``tests/golden/generate.py::_config_cvi_dp`` (double
well, 10,001-point grid, 15 inner iterations), on the dataset that JAX
``make_dataset`` draws, carried across as numpy arrays.  The trainer takes
discrete branches on ELBO comparisons, so the run is in float64 and must
reproduce ``traces.npz::cvi_dp_elbos`` to rtol 1e-6, as the JAX golden
test does.
"""
import numpy as np

from tests.golden.generate import GOLDEN_PATH, SEED
from vi_diffusion_processes_tpu.exp.runners import ExperimentConfig as JConfig
from vi_diffusion_processes_tpu.exp.runners import make_dataset
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_cvi_dp
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer

from .helpers import to_np

CONFIG = dict(prior_sde="dw", q=0.8, sites_lr=0.5, max_inner_iters=15, max_outer_iters=1)
DATA = dict(t1=10.0, num_grid=10_001, num_observations=50, noise_stddev=0.2, seed=SEED)


def test_run_cvi_dp_reproduces_golden_elbos():
    dataset = interop.dataset_from_numpy(
        to_np(make_dataset(JConfig(**CONFIG, **DATA))), device="cpu")
    out = run_cvi_dp(ExperimentConfig(**CONFIG), dataset)
    golden = np.load(GOLDEN_PATH)["cvi_dp_elbos"]
    np.testing.assert_allclose(np.asarray(out["elbos"]), golden, rtol=1e-6)
    assert np.isfinite(out["nlpd"]) and np.isfinite(out["rmse"])
    means, covs = out["posterior_means"], out["posterior_covs"]
    assert means.shape == (10_001, 1) and covs.shape == (10_001, 1, 1)
    assert bool((covs > 0).all())


def test_trainer_refuses_routes_outside_the_slice():
    """``use_packed=False`` runs at d = 1 and gives the packed route's
    ELBOs; a d = 2 model that is not an SDE-CVI model takes the generic
    update rules."""
    dataset = interop.dataset_from_numpy(
        to_np(make_dataset(JConfig(**CONFIG, **dict(DATA, num_grid=201, num_observations=20)))),
        device="cpu")
    sde = build_prior_sde("dw", q=0.8, device="cpu")
    model = CVISitesSDE.initialize_sde(
        sde, dataset.time_grid, (dataset.obs_times, dataset.obs_values), Gaussian(0.04))
    trainer = CVISitesTrainer(model, max_inner_iters=3, max_outer_iters=1, use_packed=False)
    elbos = trainer.optimize()
    assert len(elbos) == 1 and np.isfinite(elbos[0]) and len(trainer.elbo_trace) >= 1
    packed = CVISitesTrainer(model, max_inner_iters=3, max_outer_iters=1)
    np.testing.assert_allclose(packed.optimize(), elbos, rtol=1e-8)

    class TwoD:
        state_dim = 2

    assert CVISitesTrainer(model=TwoD())._packed is None
