"""Synthetic diffusion-process data (vi_diffusion_processes_tpu/exp/data.py).

Equivalent of docs/diffusion_processes/generate_data.py:25
(``get_observations``): simulate a latent SDE path with Euler–Maruyama on a
dense grid, observe a random subset with Gaussian noise, hold out a test
split; and the reference's ``.npz`` format, the grid rebuild and k-folds.

``jax.random`` cannot be reproduced in PyTorch, so the simulation is split
into its random draws (:func:`draw_observations`, from a CPU
``torch.Generator``) and a deterministic assembly
(:func:`assemble_observations`), which given the JAX package's own draws
gives the JAX dataset.  Draws and simulation run on the CPU, and the
dataset is then moved to its device: a seed gives the same dataset on the
CPU and on the card.  The ``.npz`` files of the two packages are
interchangeable.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import default_float, resolve_device
from ..sde import zoo
from ..sde.utils import euler_maruyama

__all__ = [
    "DPDataset",
    "ObservationDraws",
    "draw_observations",
    "assemble_observations",
    "get_observations",
    "build_prior_sde",
    "modify_time_grid",
    "get_k_folds",
    "save_dataset_npz",
    "load_exp_data",
]


class DPDataset(NamedTuple):
    latent_path: torch.Tensor  # [T, d]
    time_grid: torch.Tensor  # [T]
    obs_times: torch.Tensor  # [n_train]
    obs_values: torch.Tensor  # [n_train, d]
    test_times: torch.Tensor  # [n_test]
    test_values: torch.Tensor  # [n_test, d]
    noise_stddev: float
    x0: torch.Tensor

    def to(self, device) -> "DPDataset":
        """The dataset with every tensor on ``device``."""
        return DPDataset(*(x.to(device) if isinstance(x, torch.Tensor) else x for x in self))


class ObservationDraws(NamedTuple):
    """The random numbers of one :func:`get_observations` call, in the
    order of the JAX package's four sub-keys (exp/data.py:53)."""

    path_noise: torch.Tensor  # [T−1, d] standard normals of the Euler–Maruyama path
    obs_indices: torch.Tensor  # [n] distinct interior grid indices, as drawn
    obs_noise: torch.Tensor  # [n, d] standard normals of the observation noise
    split: torch.Tensor  # [n] a permutation; its first n_test entries are the test set


def draw_observations(
    generator: torch.Generator, num_grid: int, num_observations: int, state_dim: int,
    dtype=None,
) -> ObservationDraws:
    """The draws of :func:`get_observations` from a CPU ``generator``:
    path increments, ``num_observations`` distinct indices among the
    interior grid points ``1 … num_grid − 2``, observation noise and the
    train/test permutation."""
    dtype = dtype or default_float()
    if num_observations > num_grid - 2:
        raise ValueError(
            f"{num_observations} observations need as many interior grid points, "
            f"the grid has {num_grid - 2}")
    path_noise = torch.randn((num_grid - 1, state_dim), generator=generator, dtype=dtype)
    obs_indices = torch.randperm(num_grid - 2, generator=generator)[:num_observations] + 1
    obs_noise = torch.randn((num_observations, state_dim), generator=generator, dtype=dtype)
    split = torch.randperm(num_observations, generator=generator)
    return ObservationDraws(path_noise, obs_indices, obs_noise, split)


def assemble_observations(
    sde,
    draws: ObservationDraws,
    time_grid: torch.Tensor,
    x0: torch.Tensor,
    noise_stddev: float,
    test_fraction: float = 0.2,
) -> DPDataset:
    """Simulate, observe and split as generate_data.py:25-68 does, from
    given draws, on the tensors' device: the path by :func:`euler_maruyama`
    on ``draws.path_noise``, the observations at the sorted indices plus
    ``noise_stddev·obs_noise``, the test set at ``sort(split[:n_test])``
    with ``n_test = round(test_fraction·n)``."""
    path = euler_maruyama(sde, x0, time_grid, noise=draws.path_noise)  # [T, d]
    idx = torch.sort(draws.obs_indices.to(time_grid.device)).values
    values = path[idx] + noise_stddev * draws.obs_noise
    n = idx.shape[0]
    n_test = int(round(test_fraction * n))
    split = draws.split.to(time_grid.device)
    test_sel = torch.sort(split[:n_test]).values
    train_sel = torch.sort(split[n_test:]).values
    return DPDataset(
        latent_path=path,
        time_grid=time_grid,
        obs_times=time_grid[idx[train_sel]],
        obs_values=values[train_sel],
        test_times=time_grid[idx[test_sel]],
        test_values=values[test_sel],
        noise_stddev=noise_stddev,
        x0=x0,
    )


def get_observations(
    sde,
    generator: torch.Generator,
    t0: float = 0.0,
    t1: float = 10.0,
    num_grid: int = 1001,
    num_observations: int = 40,
    noise_stddev: float = 0.1,
    test_fraction: float = 0.2,
    x0: Optional[torch.Tensor] = None,
    device=None,
) -> DPDataset:
    """Simulate + subsample + split (generate_data.py:25-68; JAX
    exp/data.py:41-82).  ``generator`` is a CPU ``torch.Generator``; the
    draws and the simulation run on the CPU in the default float dtype
    (a copy of ``sde`` on the CPU), and the dataset lands on ``device``:
    the CUDA card unless the caller names another device."""
    device = resolve_device(device)
    dtype = default_float()
    cpu_sde = copy.deepcopy(sde).to("cpu")
    d = cpu_sde.state_dim
    grid = torch.linspace(t0, t1, num_grid, dtype=dtype)
    x0 = torch.ones(d, dtype=dtype) if x0 is None else torch.as_tensor(x0, dtype=dtype).cpu()
    draws = draw_observations(generator, num_grid, num_observations, d, dtype)
    with torch.no_grad():
        dataset = assemble_observations(cpu_sde, draws, grid, x0, noise_stddev, test_fraction)
    return dataset.to(device)


#: name → (class, default ``theta``) of the one-parameter drifts
_THETA_SDES = {
    "benes": (zoo.BenesSDE, 1.0),
    "sine": (zoo.SineDiffusionSDE, 0.0),
    "sqrt": (zoo.SqrtDiffusionSDE, 1.0),
}


def build_prior_sde(name: str, dtype=torch.float64, q: float = 1.0, device=None, **kwargs):
    """Prior SDE by the reference's config name (exp/data.py:85-113).
    ``"vanderpol"`` takes ``a`` and ``tau`` (1 each by default) and the
    diffusion ``q·I₂``.  ``"mlpdrift"`` draws its weights from
    ``kwargs["generator"]`` (a CPU ``torch.Generator``; seed 0 when none is
    given).  Built on ``device``: the CUDA card unless the caller names
    another device."""
    q1 = [[q]]
    if name == "ou":
        sde = zoo.OrnsteinUhlenbeckSDE(decay=kwargs.get("decay", 1.0), q=q1, dtype=dtype)
    elif name == "dw":
        sde = zoo.DoubleWellSDE(
            q=q1, scale=kwargs.get("scale", 4.0), c=kwargs.get("c", 1.0), dtype=dtype
        )
    elif name in _THETA_SDES:
        cls, theta = _THETA_SDES[name]
        sde = cls(theta=kwargs.get("theta", theta), q=q1, dtype=dtype)
    elif name == "mlpdrift":
        generator = kwargs.get("generator")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sde = zoo.MLPDrift.initialize(generator, q1, dtype=dtype)
    elif name == "vanderpol":
        sde = zoo.VanderPolOscillatorSDE(
            a=kwargs.get("a", 1.0), tau=kwargs.get("tau", 1.0), q=q * torch.eye(2, dtype=dtype),
            dtype=dtype,
        )
    else:
        raise ValueError(f"unknown prior sde: {name}")
    return sde.to(resolve_device(device))


def modify_time_grid(time_grid: torch.Tensor, dt: float) -> torch.Tensor:
    """Rebuild a uniform grid over the same span with step ``dt``
    (exp_dp_utils.py:177-186), rounded to ``dt``'s decimal places so
    observation times land exactly on grid nodes; same dtype and device."""
    t0 = float(time_grid[0])
    t1 = float(time_grid[-1])
    n_decimals = str(dt)[::-1].find(".")
    grid = np.arange(t0, t1 + dt, dt)
    return torch.as_tensor(np.round(grid, max(n_decimals, 0)), dtype=time_grid.dtype,
                           device=time_grid.device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_dataset_npz(path, dataset: DPDataset, sde_name: str = "", q: float = 1.0,
                     decay: float = 0.0) -> None:
    """Write a reference-compatible ``.npz`` (generate_data.py:128-141 key
    set: sde, decay, Q, x0, sigma, latent_process, observations,
    observation_grid, time_grid, test_observations, test_grid)."""
    d = dataset.latent_path.shape[-1]
    np.savez(
        path,
        sde=sde_name,
        decay=decay,
        Q=q * np.eye(d),
        x0=_np(dataset.x0).reshape(1, d),
        sigma=dataset.noise_stddev,
        latent_process=_np(dataset.latent_path),
        observations=_np(dataset.obs_values),
        observation_grid=_np(dataset.obs_times),
        time_grid=_np(dataset.time_grid),
        test_observations=_np(dataset.test_values),
        test_grid=_np(dataset.test_times),
    )


def load_exp_data(path, device=None) -> DPDataset:
    """Load a reference-format ``.npz`` (exp_dp_utils.py:108-125) into a
    :class:`DPDataset` on ``device`` (the card unless the caller names
    another device); Q, decay and the SDE name stay in the file."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        def t(key):
            return torch.as_tensor(data[key], device=device)

        return DPDataset(
            latent_path=t("latent_process"),
            time_grid=t("time_grid"),
            obs_times=t("observation_grid"),
            obs_values=t("observations"),
            test_times=t("test_grid"),
            test_values=t("test_observations"),
            noise_stddev=float(data["sigma"]),
            x0=t("x0").reshape(-1),
        )


def get_k_folds(times: torch.Tensor, values: torch.Tensor, k_folds: int, seed: int = 0):
    """Shuffled k-fold train/test splits with times kept sorted within each
    fold (exp_dp_utils.py:294-320), from numpy's ``default_rng(seed)`` as in
    the JAX package.  Returns ``(train_sets, test_sets)``, each entry a
    ``(times, values)`` tuple."""
    n = times.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(perm, k_folds)
    train_sets, test_sets = [], []
    for i in range(k_folds):
        test_idx = torch.as_tensor(np.sort(folds[i]), device=times.device)
        train_idx = torch.as_tensor(
            np.sort(np.concatenate([folds[j] for j in range(k_folds) if j != i])),
            device=times.device)
        train_sets.append((times[train_idx], values[train_idx]))
        test_sets.append((times[test_idx], values[test_idx]))
    return train_sets, test_sets
