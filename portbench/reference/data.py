"""The datasets of a run: a frozen NumPy copy of the experiment CLI's
generator (the program's ``exp/data.py::get_observations``).

Per dataset: an Euler–Maruyama path of the prior SDE from ``x0`` on a
uniform grid, ``num_observations`` distinct interior grid indices, Gaussian
noise of ``noise_stddev`` on the path there, and a random 20% test split.
The draws come from ``numpy.random.default_rng(seed)`` in a fixed order, so
one seed gives the same pool on any machine.  The paths of a pool are
simulated together, one vectorized step at a time.
"""
from __future__ import annotations

import importlib

import numpy as np

__all__ = ["make_grid", "draw_pool"]

#: rows of noise drawn at a time in the Euler–Maruyama loop
_CHUNK = 4096


def make_grid(config: dict, num_grid: int) -> np.ndarray:
    return np.linspace(config["t0"], config["t1"], num_grid, dtype=np.float64)


def prior_module(name: str):
    return importlib.import_module(f"{__package__}.priors.{name}")


def draw_pool(config: dict, num_grid: int, num_observations: int, count: int, seed: int,
              test_fraction: float = 0.2) -> dict:
    """``count`` datasets on one grid.  Returns ``grid [T]``, ``obs_idx
    [count, n_train]`` (sorted grid indices), ``obs_y [count, n_train, d]``,
    ``test_idx``, ``test_y`` and ``noise_stddev``."""
    rng = np.random.default_rng(seed)
    d = config["state_dim"]
    grid = make_grid(config, num_grid)
    if num_observations > num_grid - 2:
        raise ValueError(f"{num_observations} observations need as many interior grid points")
    idx = np.stack([np.sort(rng.choice(num_grid - 2, num_observations, replace=False) + 1)
                    for _ in range(count)])
    obs_noise = rng.standard_normal((count, num_observations, d))
    split = np.stack([rng.permutation(num_observations) for _ in range(count)])

    drift = prior_module(config["prior_sde"]).drift
    kw = config["prior_sde_kwargs"]
    chol_q = np.linalg.cholesky(config["q"] * np.eye(d))
    dts = grid[1:] - grid[:-1]
    path = np.empty((num_grid, count, d))
    x = np.broadcast_to(np.asarray(config["x0"], dtype=np.float64), (count, d)).copy()
    path[0] = x
    for start in range(0, num_grid - 1, _CHUNK):
        stop = min(start + _CHUNK, num_grid - 1)
        noise = rng.standard_normal((stop - start, count, d)) @ chol_q.T
        noise *= np.sqrt(dts[start:stop])[:, None, None]
        for k in range(start, stop):
            x = x + drift(x, kw, np) * dts[k] + noise[k - start]
            path[k + 1] = x

    rows = np.arange(count)[:, None]
    values = path[idx, rows] + config["noise_stddev"] * obs_noise  # [count, n, d]
    n_test = int(round(test_fraction * num_observations))
    test_sel = np.sort(split[:, :n_test], axis=1)
    train_sel = np.sort(split[:, n_test:], axis=1)
    return {
        "grid": grid,
        "obs_idx": np.take_along_axis(idx, train_sel, 1),
        "obs_y": np.take_along_axis(values, train_sel[..., None], 1),
        "test_idx": np.take_along_axis(idx, test_sel, 1),
        "test_y": np.take_along_axis(values, test_sel[..., None], 1),
        "noise_stddev": float(config["noise_stddev"]),
    }
