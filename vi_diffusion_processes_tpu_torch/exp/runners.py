"""CVI-DP and VDP experiment runners
(vi_diffusion_processes_tpu/exp/runners.py:35-260).

Only the configuration fields that :func:`run_cvi_dp` and :func:`run_vdp`
read are ported.  The dataset is required: the JAX ``make_dataset`` draws
with ``jax.random``, which PyTorch cannot reproduce.  Artifacts and plots
(``output_dir``) are not ported yet (slice I of ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..likelihoods.gaussian import Gaussian
from ..models.cvi_dp import CVISitesSDE
from ..models.vdp import VariationalMarkovGP
from ..optim.trainers import CVISitesTrainer, VDPTrainer
from .data import DPDataset, build_prior_sde
from .metrics import grid_indices, nlpd, nlpd_full, rmse

__all__ = ["ExperimentConfig", "run_cvi_dp", "run_vdp"]


@dataclasses.dataclass
class ExperimentConfig:
    """The CVI-DP and VDP fields of the reference's configs/cvi_base.yaml
    and vi_base.yaml."""

    prior_sde: str = "dw"
    prior_sde_kwargs: Dict = dataclasses.field(default_factory=dict)
    q: float = 1.0
    sites_lr: float = 0.5
    max_inner_iters: int = 20
    max_outer_iters: int = 10
    learn_prior_sde: bool = False
    prior_sde_lr: float = 0.01
    stabilize_ssm: bool = True
    clip_state_transitions: tuple = (-1.0, 1.0)
    # vdp trainer
    vdp_lr: float = 0.05
    vdp_warmup_steps: int = 20


def _metrics(model_means, model_covs, dataset: DPDataset) -> Dict[str, float]:
    """NLPD (full predictive covariance) + RMSE at the grid indices of the
    test times (runners.py:122-135)."""
    idx = grid_indices(dataset.time_grid, dataset.test_times)
    m = model_means[idx]
    s = model_covs[idx]
    noise = dataset.noise_stddev**2
    if s.dim() == m.dim() + 1:
        nlpd_val = nlpd_full(m, s, dataset.test_values, noise)
    else:
        nlpd_val = nlpd(m, s, dataset.test_values, noise)
    return {"nlpd": float(nlpd_val), "rmse": float(rmse(m, dataset.test_values))}


def _prior_and_likelihood(config: ExperimentConfig, dataset: DPDataset):
    device = dataset.time_grid.device
    sde = build_prior_sde(config.prior_sde, q=config.q, device=device, **config.prior_sde_kwargs)
    return sde, Gaussian(variance=dataset.noise_stddev**2).to(device)


def run_cvi_dp(config: ExperimentConfig, dataset: DPDataset) -> Dict:
    """CVI-DP experiment (runners.py:192-226) on the dataset's device."""
    sde, likelihood = _prior_and_likelihood(config, dataset)
    model = CVISitesSDE.initialize_sde(
        sde,
        dataset.time_grid,
        (dataset.obs_times, dataset.obs_values),
        likelihood,
        stabilize_ssm=config.stabilize_ssm,
        clip_state_transitions=config.clip_state_transitions,
    )
    trainer = CVISitesTrainer(
        model,
        sites_lr=config.sites_lr,
        max_inner_iters=config.max_inner_iters,
        max_outer_iters=config.max_outer_iters,
        learn_prior_sde=config.learn_prior_sde,
        prior_sde_lr=config.prior_sde_lr,
    )
    elbos = trainer.optimize()
    model = trainer.model
    with torch.no_grad():
        means, covs = model.dist_q.marginals()
    return {
        "model": model,
        "elbos": elbos,
        "posterior_means": means,
        "posterior_covs": covs,
        "learned_prior_sde": model.prior_sde,
        **_metrics(means, covs, dataset),
    }


def run_vdp(config: ExperimentConfig, dataset: DPDataset) -> Dict:
    """VDP experiment (runners.py:229-260) on the dataset's device."""
    sde, likelihood = _prior_and_likelihood(config, dataset)
    model = VariationalMarkovGP.initialize(
        (dataset.obs_times, dataset.obs_values), sde, dataset.time_grid, likelihood
    )
    trainer = VDPTrainer(
        model,
        lr=config.vdp_lr,
        warmup_steps=config.vdp_warmup_steps,
        learn_prior_sde=config.learn_prior_sde,
        prior_sde_lr=config.prior_sde_lr,
    )
    elbos = trainer.optimize(n_rounds=3 if config.learn_prior_sde else 1)
    model = trainer.model
    with torch.no_grad():
        means, covs = model.forward_pass()
    return {
        "model": model,
        "elbos": elbos,
        "posterior_means": means,
        "posterior_covs": covs,
        "learned_prior_sde": model.prior_sde,
        **_metrics(means, covs, dataset),
    }
