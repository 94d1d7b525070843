"""Experiment runners: configuration → trained model + metrics
(vi_diffusion_processes_tpu/exp/runners.py).

Equivalents of the reference's Hydra entry points
(docs/diffusion_processes/cvi_dp.py:25, vi_markov_gp.py:24, gpr_linear.py,
gpr_non_linear.py, stock/sgpr_stock.py): a plain dataclass config whose
fields map onto the reference's ``configs/*.yaml`` keys, the trainers of
:mod:`~..optim.trainers`, NLPD and RMSE on the held-out split, and with
``output_dir`` the reference's artifacts.  Every runner takes a dataset, or
draws one with :func:`make_dataset` on the card.

Overrides ``key=value`` parse their value as a YAML 1.1 scalar or flow list
(:func:`parse_yaml_value`), as the JAX package does with
``yaml.safe_load``; PyYAML is needed only for :meth:`ExperimentConfig.from_yaml`.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..likelihoods.gaussian import Gaussian
from ..models.cvi_dp import CVISitesSDE
from ..models.vdp import VariationalMarkovGP
from ..optim.trainers import CVISitesTrainer, VDPTrainer
from .data import DPDataset, _np, build_prior_sde, get_observations
from .metrics import grid_indices, nlpd, nlpd_full, rmse

__all__ = [
    "ExperimentConfig",
    "run_cvi_dp",
    "run_vdp",
    "run_gpr",
    "run_sgpr",
    "make_dataset",
    "parse_yaml_value",
]

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1: a float needs a
# dot, so ``1e-3`` is a string there and here
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# forms that PyYAML resolves to values this parser does not build
_UNSUPPORTED = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text.startswith("-") else 1
    body = text.lstrip("+-")
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if len(body) > 1 and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    if text.endswith(".inf"):
        return float("-inf") if text.startswith("-") else float("inf")
    if text == ".nan":
        return float("nan")
    return float(text)


def _split_flow(body: str):
    """Items of a flow sequence body, split at the commas outside brackets
    and quotes."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    last = body[start:]
    if last.strip() or items:
        items.append(last)
    if items and not items[-1].strip():
        items.pop()  # a trailing comma
    return items


def parse_yaml_value(text: str):
    """The value that ``yaml.safe_load(text)`` gives for an override: null,
    bool, int, float (YAML 1.1: ``1e-3`` stays a string, ``1.0e-3`` is a
    float), a quoted or plain string, or a flow sequence ``[a, b]`` of such
    values.  Raises ``ValueError`` on YAML this parser does not build
    (mappings, timestamps, sexagesimal numbers, tags, anchors)."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow sequence: {text!r}")
        return [parse_yaml_value(item) for item in _split_flow(text[1:-1])]
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body
    if text[:1] in ("{", "!", "&", "*", "|", ">", "%", "@", "`") or _UNSUPPORTED.match(text):
        raise ValueError(f"override value not supported: {text!r}")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


@dataclasses.dataclass
class ExperimentConfig:
    """Mirror of configs/cvi_base.yaml + vi_base.yaml + prior_sde/*.yaml
    (runners.py:36-64)."""

    prior_sde: str = "dw"
    prior_sde_kwargs: Dict = dataclasses.field(default_factory=dict)
    q: float = 1.0
    t0: float = 0.0
    t1: float = 10.0
    num_grid: int = 1001
    num_observations: int = 40
    noise_stddev: float = 0.316
    seed: int = 33
    # trainer
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
    # sgpr
    num_inducing: int = 20
    # artifacts: when set, runners save posteriors/statistics npz + plots
    # here (cvi_dp.py:140-155 semantics)
    output_dir: Optional[str] = None

    @classmethod
    def from_yaml(cls, path, overrides=()) -> "ExperimentConfig":
        """Load a config from YAML with Hydra-style ``key=value`` overrides
        (docs/diffusion_processes/README.md:37-49).  Dotted keys index into
        dict fields (``prior_sde_kwargs.decay=2.0``).  Needs PyYAML."""
        import pathlib

        import yaml

        raw = yaml.safe_load(pathlib.Path(path).read_text()) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        return cls(**raw)._apply_overrides(overrides)

    @classmethod
    def from_yaml_overrides(cls, overrides=()) -> "ExperimentConfig":
        """Defaults + ``key=value`` overrides only (no YAML file)."""
        return cls()._apply_overrides(overrides)

    def _apply_overrides(self, overrides) -> "ExperimentConfig":
        known = {f.name for f in dataclasses.fields(self)}
        for item in overrides:
            key, sep, value = item.partition("=")
            if not sep:
                raise ValueError(f"override must be key=value, got {item!r}")
            value = parse_yaml_value(value)
            head, _, rest = key.partition(".")
            if head not in known:
                raise ValueError(f"unknown config key: {head!r}")
            if rest:
                getattr(self, head)[rest] = value
            else:
                setattr(self, head, value)
        if isinstance(self.clip_state_transitions, list):
            self.clip_state_transitions = tuple(self.clip_state_transitions)
        return self


def make_dataset(config: ExperimentConfig, device=None) -> DPDataset:
    """The configuration's synthetic dataset (runners.py:110-120), drawn
    from a CPU generator seeded with ``config.seed`` and moved to ``device``
    (the card unless the caller names another device)."""
    sde = build_prior_sde(config.prior_sde, q=config.q, device="cpu", **config.prior_sde_kwargs)
    return get_observations(
        sde,
        torch.Generator().manual_seed(config.seed),
        t0=config.t0,
        t1=config.t1,
        num_grid=config.num_grid,
        num_observations=config.num_observations,
        noise_stddev=config.noise_stddev,
        device=device,
    )


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


def _save_run(output_dir: str, result: Dict, dataset: DPDataset, legend: str) -> bool:
    """Save the posterior and statistics artifacts into the run directory
    (cvi_dp.py:140-155 key set; runners.py:138-189): ``posteriors.npz``,
    ``training_statistics.npz``, ``cvi_model.npz`` for a CVI-DP model and
    ``learnt_prior_params.npz`` (``param_i`` in ``nn.Module`` parameter
    order).  Draws ``objective.png`` and ``posterior.png`` when matplotlib
    imports; returns whether it did."""
    os.makedirs(output_dir, exist_ok=True)
    m = _np(result["posterior_means"])
    s = _np(result["posterior_covs"])
    trace = result.get("elbos", result.get("losses", []))
    np.savez(os.path.join(output_dir, "posteriors.npz"),
             cvi_m=m, cvi_S=s, time_grid=_np(dataset.time_grid))
    np.savez(os.path.join(output_dir, "training_statistics.npz"),
             elbo=np.asarray(trace, dtype=np.float64), nlpd=result["nlpd"], rmse=result["rmse"])
    model = result["model"]
    if hasattr(model, "data_sites"):
        g = model.girsanov_sites
        np.savez(
            os.path.join(output_dir, "cvi_model.npz"),
            data_sites_nat1=_np(model.data_sites.nat1),
            data_sites_nat2=_np(model.data_sites.nat2),
            girsanov_sites_nat1=_np(g.nat1),
            girsanov_sites_nat2_diag=_np(g.nat2_diag),
            girsanov_sites_nat2_subdiag=_np(g.nat2_sub),
        )
    if result.get("learned_prior_sde") is not None:
        params = result["learned_prior_sde"].parameters()
        np.savez(os.path.join(output_dir, "learnt_prior_params.npz"),
                 **{f"param_{i}": _np(p) for i, p in enumerate(params)})
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    from .plots import plot_line, plot_posterior

    if len(trace):
        plot_line(trace, os.path.join(output_dir, "objective.png"), title="objective")
    plot_posterior(
        m, s, dataset.obs_times, dataset.obs_values, dataset.time_grid,
        latent_process=dataset.latent_path,
        test_observations=(dataset.test_times, dataset.test_values),
        output_path=os.path.join(output_dir, "posterior.png"),
        model_legend=legend,
    )
    return True


def _finish(config: ExperimentConfig, result: Dict, dataset: DPDataset, legend: str) -> Dict:
    if config.output_dir is not None:
        result["plots_written"] = _save_run(config.output_dir, result, dataset, legend)
    return result


def _prior_and_likelihood(config: ExperimentConfig, dataset: DPDataset):
    device = dataset.time_grid.device
    sde = build_prior_sde(config.prior_sde, q=config.q, device=device, **config.prior_sde_kwargs)
    return sde, Gaussian(variance=dataset.noise_stddev**2).to(device)


def run_cvi_dp(config: ExperimentConfig, dataset: Optional[DPDataset] = None) -> Dict:
    """CVI-DP experiment (runners.py:192-226) on the dataset's device; the
    dataset is :func:`make_dataset`'s on the card when none is given."""
    dataset = dataset if dataset is not None else make_dataset(config)
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
    return _finish(config, {
        "model": model,
        "elbos": elbos,
        "posterior_means": means,
        "posterior_covs": covs,
        "learned_prior_sde": model.prior_sde,
        **_metrics(means, covs, dataset),
    }, dataset, "CVI-DP")


def run_vdp(config: ExperimentConfig, dataset: Optional[DPDataset] = None) -> Dict:
    """VDP experiment (runners.py:229-260) on the dataset's device; the
    dataset is :func:`make_dataset`'s on the card when none is given."""
    dataset = dataset if dataset is not None else make_dataset(config)
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
    return _finish(config, {
        "model": model,
        "elbos": elbos,
        "posterior_means": means,
        "posterior_covs": covs,
        "learned_prior_sde": model.prior_sde,
        **_metrics(means, covs, dataset),
    }, dataset, "VDP")


def run_gpr(config: ExperimentConfig, dataset: Optional[DPDataset] = None, kernel=None) -> Dict:
    """Exact-GPR baseline on the same data (runners.py:263-309) on the
    dataset's device: a state-space kernel whose hyperparameters Adam(0.05)
    trains for 60 steps on ``−log p(y)``, then ``predict_f`` at the test
    times.  The kernel is an OU kernel of decay 1 and diffusion ``config.q``
    unless the caller gives one; the caller's kernel is copied, not changed,
    and ``out["kernel"]`` is the trained one.  The dataset is
    :func:`make_dataset`'s on the card when none is given."""
    from ..kernels.matern import OrnsteinUhlenbeck
    from ..models.gpr import GaussianProcessRegression

    dataset = dataset if dataset is not None else make_dataset(config)
    dtype = dataset.obs_values.dtype
    device = dataset.obs_values.device
    if kernel is None:
        kernel = OrnsteinUhlenbeck(decay=1.0, diffusion=config.q, dtype=dtype)
    kernel = copy.deepcopy(kernel).to(device)
    model = GaussianProcessRegression(
        kernel=kernel,
        time_points=dataset.obs_times,
        observations=dataset.obs_values,
        chol_obs_covariance=torch.tensor([[dataset.noise_stddev]], dtype=dtype, device=device),
    )
    # the reference's Adam defaults (b1 0.9, b2 0.999, eps 1e-8) are torch's
    opt = torch.optim.Adam(kernel.parameters(), lr=0.05)
    losses = []
    for _ in range(60):
        opt.zero_grad(set_to_none=True)
        loss = model.loss()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))

    with torch.no_grad():
        f_mu, f_var = model.posterior.predict_f(dataset.test_times)
    return {
        "model": model,
        "losses": losses,
        "kernel": kernel,
        "nlpd": float(nlpd(f_mu, f_var, dataset.test_values, dataset.noise_stddev**2)),
        "rmse": float(rmse(f_mu, dataset.test_values)),
    }


class _Exp(torch.nn.Module):
    """A positive parameter trained as its logarithm."""

    def forward(self, log_value):
        return torch.exp(log_value)

    def right_inverse(self, value):
        return torch.log(value)


def run_sgpr(config: ExperimentConfig, dataset: Optional[DPDataset] = None) -> Dict:
    """Sparse-GPR baseline (stock/sgpr_stock.py:33-60; runners.py:312-380):
    an SVGP with ``config.num_inducing`` inducing times evenly spread over
    the observations, a Matern32 kernel of lengthscale and variance 1 and a
    Gaussian likelihood of the dataset's noise variance.  One Adam(0.05)
    trains the three log hyperparameters and the five ``dist_q`` tensors
    jointly on ``−ELBO``, at most ``10·max_outer_iters`` steps, until
    ``|ΔELBO| < 1e-2``.  The dataset is :func:`make_dataset`'s on the card
    when none is given."""
    from torch.nn.utils import parametrize

    from ..kernels.matern import Matern32
    from ..models.svgp import SparseVariationalGaussianProcess
    from ..ssm.state_space_model import StateSpaceModel

    dataset = dataset if dataset is not None else make_dataset(config)
    dtype = dataset.obs_values.dtype
    device = dataset.obs_values.device
    t = dataset.obs_times
    z = torch.linspace(float(t[0]), float(t[-1]), config.num_inducing, dtype=dtype, device=device)
    kernel = Matern32(1.0, 1.0, dtype=dtype).to(device)
    likelihood = Gaussian(variance=dataset.noise_stddev**2, dtype=dtype).to(device)
    # positive hyperparameters train in log space (the reference trains
    # through gpflow's bijectors)
    for module, name in ((kernel, "lengthscale"), (kernel, "variance"), (likelihood, "variance")):
        parametrize.register_parametrization(module, name, _Exp())
    model = SparseVariationalGaussianProcess.initialize(kernel, likelihood, z)
    leaves = {f.name: getattr(model.dist_q, f.name).detach().clone().requires_grad_()
              for f in dataclasses.fields(StateSpaceModel)}
    model = model.replace(dist_q=StateSpaceModel(**leaves))
    data = (t, dataset.obs_values)
    # the reference's Adam defaults (b1 0.9, b2 0.999, eps 1e-8) are torch's
    opt = torch.optim.Adam([*kernel.parameters(), *likelihood.parameters(), *leaves.values()],
                           lr=0.05)
    elbos = []
    optim_tol = 1e-2
    for _ in range(config.max_outer_iters * 10):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(data)
        loss.backward()
        opt.step()
        elbos.append(-float(loss.detach()))
        if len(elbos) > 1 and abs(elbos[-1] - elbos[-2]) < optim_tol:
            break

    with torch.no_grad():
        f_mu, f_var = model.posterior.predict_f(dataset.test_times)
    noise = dataset.noise_stddev**2
    return {
        "model": model,
        "elbos": elbos,
        "nlpd": float(nlpd(f_mu, f_var, dataset.test_values, noise)),
        "rmse": float(rmse(f_mu, dataset.test_values)),
    }
