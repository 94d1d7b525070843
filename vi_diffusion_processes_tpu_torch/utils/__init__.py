"""Public names of :mod:`vi_diffusion_processes_tpu_torch.utils` (vi_diffusion_processes_tpu/utils/__init__.py)."""
from .linalg import (
    block_diag,
    cholesky_with_jitter,
    kron,
    solve_psd,
    symmetrize,
    transpose_last,
)
from .shapes import augment_matrix, augment_square_matrix, to_delta_time

__all__ = [
    "block_diag",
    "cholesky_with_jitter",
    "kron",
    "solve_psd",
    "symmetrize",
    "transpose_last",
    "augment_matrix",
    "augment_square_matrix",
    "to_delta_time",
]
