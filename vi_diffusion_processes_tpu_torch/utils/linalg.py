"""Small dense linear-algebra helpers (vi_diffusion_processes_tpu/utils/linalg.py).

Only what the ported slices need.  The JAX package's unrolled
small-block forms exist to dodge TPU tile padding; here the d=1 blocks
short-circuit to elementwise arithmetic and anything larger goes to
``torch.linalg``.  All functions batch over leading dimensions.
"""
from __future__ import annotations

import torch

__all__ = [
    "transpose_last",
    "cholesky_with_jitter",
    "cho_solve",
    "tri_solve",
    "chol_psd",
    "gaussian_kl",
    "inv_small",
]


def transpose_last(x: torch.Tensor) -> torch.Tensor:
    """Swap the last two axes (batched matrix transpose)."""
    return x.transpose(-1, -2)


def cholesky_with_jitter(x: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Cholesky of a PSD matrix with a diagonal jitter (linalg.py:27)."""
    from ..config import default_jitter

    if jitter is None:
        jitter = default_jitter()
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return chol_psd(x + jitter * eye)


def tri_solve(l: torch.Tensor, b: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """Solve ``L x = b`` (or ``Lᵀ x = b``) for lower-triangular ``L``;
    leading batch dims broadcast (linalg.py:65)."""
    if l.shape[-1] == 1 and b.shape[-2] == 1:
        return b / l[..., :1, :1]
    if transpose:
        return torch.linalg.solve_triangular(transpose_last(l), b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L Lᵀ) x = b`` given a lower Cholesky factor (linalg.py:47)."""
    return tri_solve(l, tri_solve(l, b), transpose=True)


def chol_psd(x: torch.Tensor) -> torch.Tensor:
    """Cholesky with the d=1 ``sqrt`` short-circuit (linalg.py:168).  The
    input is symmetrized first, as ``jnp.linalg.cholesky`` does."""
    if x.shape[-1] == 1:
        return torch.sqrt(x)
    return torch.linalg.cholesky(0.5 * (x + transpose_last(x)))


def gaussian_kl(
    mean_q: torch.Tensor,
    chol_q: torch.Tensor,
    mean_p: torch.Tensor,
    chol_p: torch.Tensor,
) -> torch.Tensor:
    """KL( N(mean_q, LqLqᵀ) ‖ N(mean_p, LpLpᵀ) ), batched (linalg.py:403)."""
    d = mean_q.shape[-1]
    lp_inv_lq = tri_solve(chol_p, chol_q)
    trace = torch.sum(lp_inv_lq**2, dim=(-1, -2))
    alpha = tri_solve(chol_p, (mean_p - mean_q)[..., None])[..., 0]
    maha = torch.sum(alpha**2, dim=-1)
    log_det_q = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chol_q, dim1=-2, dim2=-1))), dim=-1
    )
    log_det_p = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chol_p, dim1=-2, dim2=-1))), dim=-1
    )
    return 0.5 * (trace + maha - d + log_det_p - log_det_q)


def inv_small(a: torch.Tensor) -> torch.Tensor:
    """``a⁻¹`` of small blocks ``[..., d, d]`` (linalg.py:335); a division at
    d = 1."""
    if a.shape[-1] == 1:
        return 1.0 / a
    return torch.linalg.inv(a)
