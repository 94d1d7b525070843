"""Posterior / trace plotting for the experiment harness
(vi_diffusion_processes_tpu/exp/plots.py).

Equivalents of the reference's matplotlib utilities in
docs/diffusion_processes/exp_dp_utils.py — ``plot_posterior`` (:19-97),
``plot_params_of_vi_markov`` (:100-120), ``plot_line`` (:227-239),
``plot_all_posterior`` (:242-279) — redesigned as pure save-to-path
functions (no ``plt.show()``; runners save into the run directory).
wandb image logging mirrors :74-75 and is active only when a wandb run
exists (exp/logging.py style).

Matplotlib is imported at the first plot, with the Agg backend, so the
module imports where matplotlib is missing and plots work headless.  Every
array argument may be a tensor on any device or a numpy array.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .data import _np

__all__ = [
    "plot_line",
    "plot_posterior",
    "plot_all_posterior",
    "plot_params_of_vdp",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _wandb_log_image(name: str, fig) -> None:
    """Mirror exp_dp_utils.py:74-75: log the figure when a wandb run is live."""
    try:
        import wandb  # type: ignore

        if wandb.run is not None:
            wandb.log({name: wandb.Image(fig)})
    except ImportError:
        pass


def plot_line(vals: Sequence[float], output_path: Optional[str] = None, title: str = ""):
    """Iteration-trace plot (exp_dp_utils.py:227-239)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(_np(vals))
    ax.set_xlabel("Iterations")
    ax.set_title(title)
    if output_path:
        fig.savefig(output_path)
    _wandb_log_image(title or "line", fig)
    plt.close(fig)
    return fig


def plot_posterior(
    m,
    s,
    observation_grid,
    observation_val,
    time_grid,
    latent_process=None,
    latent_process_grid=None,
    output_path: Optional[str] = None,
    test_observations: Optional[Tuple] = None,
    model_legend: Optional[str] = None,
):
    """Posterior mean ± 2σ per output dim over observations and the latent
    path (exp_dp_utils.py:19-97).  ``m [N, D]``; ``s`` is ``[N, D, D]``
    (full covariance — diagonal is taken) or ``[N, D]`` (variances)."""
    plt = _plt()
    m = _np(m)
    s = _np(s)
    n, d = m.shape
    var = np.diagonal(s, axis1=-2, axis2=-1) if s.ndim == 3 else s
    if latent_process_grid is None:
        latent_process_grid = time_grid
    fig, axs = plt.subplots(d, 1, figsize=(12, 3 * d), squeeze=False)
    for i in range(d):
        ax = axs[i][0]
        obs = _np(observation_val)
        ax.plot(_np(observation_grid), obs[:, i] if obs.ndim > 1 else obs,
                "x", color="black", label="observations")
        if test_observations is not None:
            ty = _np(test_observations[1])
            ax.plot(_np(test_observations[0]),
                    ty[:, i] if ty.ndim > 1 else ty,
                    "x", color="red", label="test-observations")
        if latent_process is not None:
            lp = _np(latent_process)
            ax.plot(_np(latent_process_grid),
                    lp[:, i] if lp.ndim > 1 else lp, alpha=0.3, color="black")
        sd = np.sqrt(var[:, i])
        ax.plot(_np(time_grid), m[:, i], color="tab:blue", label=model_legend)
        ax.fill_between(_np(time_grid), m[:, i] - 2 * sd, m[:, i] + 2 * sd,
                        color="tab:blue", alpha=0.2)
        ax.set_xlabel("Time (t)")
        ax.set_xlim([float(time_grid[0]), float(time_grid[-1])])
    axs[0][0].set_title("Posterior")
    if model_legend:
        axs[0][0].legend()
    if output_path:
        fig.savefig(output_path)
    _wandb_log_image("Posterior", fig)
    plt.close(fig)
    return fig


def plot_all_posterior(
    posteriors: dict,
    observation_grid,
    observation_val,
    time_grid,
    latent_process=None,
    output_path: Optional[str] = None,
):
    """Overlay several models' 1-D posteriors (exp_dp_utils.py:242-279).

    ``posteriors`` maps legend → ``(m [N, 1], var [N, 1])``; colors cycle
    like the reference (Proposed/GPR/Archambeau et al.).
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(15, 5))
    ax.plot(_np(observation_grid), _np(observation_val), "x",
            color="red", label="observations")
    if latent_process is not None:
        ax.plot(_np(time_grid), _np(latent_process), alpha=0.3,
                color="black")
    colors = ["tab:blue", "tab:red", "tab:green", "tab:orange", "tab:purple"]
    t = _np(time_grid)
    for color, (legend, (m, var)) in zip(colors, posteriors.items()):
        m = _np(m).reshape(len(t))
        sd = 2 * np.sqrt(_np(var).reshape(len(t)))
        ax.plot(t, m, color=color, label=legend)
        ax.plot(t, m + sd, color=color, lw=0.8)
        ax.plot(t, m - sd, color=color, lw=0.8)
    ax.set_xlim([float(t[0]), float(t[-1])])
    ax.legend()
    if output_path:
        fig.savefig(output_path)
    _wandb_log_image("AllPosteriors", fig)
    plt.close(fig)
    return fig


def plot_params_of_vdp(vdp, output_path: Optional[str] = None):
    """VDP diagnostics: A, b and the Lagrange multipliers
    (exp_dp_utils.py:100-120)."""
    plt = _plt()
    fig, axs = plt.subplots(2, 2, figsize=(12, 8))
    panels = [
        ("A", vdp.A), ("b", vdp.b),
        ("lambda", vdp.lambda_lagrange), ("psi", vdp.psi_lagrange),
    ]
    for ax, (name, val) in zip(axs.ravel(), panels):
        ax.plot(_np(val).reshape(len(_np(val)), -1))
        ax.set_title(name)
    if output_path:
        fig.savefig(output_path)
    _wandb_log_image("VDP params", fig)
    plt.close(fig)
    return fig
