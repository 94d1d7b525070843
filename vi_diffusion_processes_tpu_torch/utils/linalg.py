"""Small dense linear-algebra helpers (vi_diffusion_processes_tpu/utils/linalg.py).

Only what the ported slices need.  The JAX package's unrolled
small-block forms exist to dodge TPU tile padding and are not carried
over; here d = 1 blocks short-circuit to elementwise arithmetic, 2×2 and
3×3 systems are solved in closed form, and anything larger goes to
``torch.linalg``.  Inside the scans these helpers are called once per level
on stacks of tiny blocks, so none of them reads a status flag back to the
host: the factorizations use the ``*_ex`` variants with ``check_errors=False``
and a failed Cholesky gives NaNs, as ``jnp.linalg.cholesky`` does.  All
functions batch over leading dimensions.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = [
    "transpose_last",
    "eye_like",
    "symmetrize",
    "matmul_small",
    "matvec_small",
    "solve_small",
    "solve_psd",
    "logdet_pos",
    "block_diag",
    "kron",
    "mvn_logpdf",
    "cholesky_with_jitter",
    "cho_solve",
    "tri_solve",
    "chol_psd",
    "gaussian_kl",
    "inv_small",
    "inv_pd",
    "qr_solve",
]


def transpose_last(x: torch.Tensor) -> torch.Tensor:
    """Swap the last two axes (batched matrix transpose)."""
    return x.transpose(-1, -2)


def eye_like(x: torch.Tensor) -> torch.Tensor:
    """The identity of the size, dtype and device of the blocks ``[..., d, d]``."""
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


def symmetrize(x: torch.Tensor) -> torch.Tensor:
    """The symmetric part ``(x + xᵀ)/2`` over the last two axes."""
    return 0.5 * (x + transpose_last(x))


def cholesky_with_jitter(x: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Cholesky of a PSD matrix with a diagonal jitter (linalg.py:27)."""
    from ..config import default_jitter

    if jitter is None:
        jitter = default_jitter()
    return chol_psd(x + jitter * eye_like(x))


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
    chol, info = torch.linalg.cholesky_ex(symmetrize(x), check_errors=False)
    return torch.where((info > 0)[..., None, None], torch.full_like(chol, math.nan), chol)


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


#: up to this size a stack of blocks is multiplied as a broadcast product
#: and a sum, two elementwise launches; beyond it by ``@``
_ELEMENTWISE_MAX_DIM = 8


def matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matmul over the last two axes (linalg.py:222).  Tiny blocks go
    through a broadcast product and a sum: the batched GEMM that ``@`` calls
    is far off its rate on 100,000 blocks of 2×2 to 4×4 (``profile_step.py
    --scan`` times both)."""
    if max(a.shape[-2], a.shape[-1], b.shape[-1]) > _ELEMENTWISE_MAX_DIM:
        return a @ b
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def matvec_small(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``A v``: ``a [..., m, k]``, ``v [..., k]`` → ``[..., m]``
    (linalg.py:256)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def _adjugate2(a: torch.Tensor):
    a00, a01 = a[..., 0, 0], a[..., 0, 1]
    a10, a11 = a[..., 1, 0], a[..., 1, 1]
    adj = torch.stack([torch.stack([a11, -a01], -1), torch.stack([-a10, a00], -1)], -2)
    return adj, a00 * a11 - a01 * a10


def _adjugate3(a: torch.Tensor):
    # rows of c: the cofactor rows of aᵀ (linalg.py:314)
    c = torch.linalg.cross(torch.roll(a, -1, dims=-2), torch.roll(a, -2, dims=-2), dim=-1)
    return transpose_last(c), torch.sum(a[..., 0, :] * c[..., 0, :], dim=-1)


def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a⁻¹ b`` for small blocks (linalg.py:280): a division at d = 1, the
    adjugate at d = 2 and 3, LU without the host-side status check beyond."""
    d = a.shape[-1]
    if d == 1 and b.shape[-2] == 1:
        return b / a[..., :1, :1]
    if d in (2, 3):
        adj, det = _adjugate2(a) if d == 2 else _adjugate3(a)
        return matmul_small(adj, b) / det[..., None, None]
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


def inv_small(a: torch.Tensor) -> torch.Tensor:
    """``a⁻¹`` of small blocks ``[..., d, d]`` (linalg.py:335)."""
    d = a.shape[-1]
    if d == 1:
        return 1.0 / a
    if d in (2, 3):
        adj, det = _adjugate2(a) if d == 2 else _adjugate3(a)
        return adj / det[..., None, None]
    return torch.linalg.inv_ex(a, check_errors=False)[0]


def inv_pd(a: torch.Tensor) -> torch.Tensor:
    """``a⁻¹`` of symmetric positive-definite blocks ``[..., d, d]``
    (chmat.py ``minv_pd``): the closed forms of :func:`inv_small` up to
    d = 3, the Cholesky inverse ``L⁻ᵀL⁻¹`` beyond."""
    if a.shape[-1] <= 3:
        return inv_small(a)
    return cho_solve(chol_psd(a), eye_like(a).expand(a.shape))


def qr_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for general square ``a`` by Householder QR
    (linalg.py:324), batch dims broadcast.  Kept for the API: the JAX package
    takes QR to avoid LU on the TPU, and :func:`solve_small` keeps its own
    route here."""
    q, r = torch.linalg.qr(a)
    return torch.linalg.solve_triangular(r, transpose_last(q) @ b, upper=True)


def solve_psd(
    a: torch.Tensor, b: torch.Tensor, chol: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Solve ``a x = b`` for symmetric positive-definite ``a`` via Cholesky
    (linalg.py:41)."""
    return cho_solve(chol_psd(a) if chol is None else chol, b)


def logdet_pos(a: torch.Tensor) -> torch.Tensor:
    """``log det a`` for matrices with positive determinant (linalg.py:341):
    the closed-form determinant for d ≤ 3, ``slogdet`` beyond."""
    d = a.shape[-1]
    if d == 1:
        return torch.log(a[..., 0, 0])
    if d in (2, 3):
        return torch.log(_adjugate2(a)[1] if d == 2 else _adjugate3(a)[1])
    return torch.linalg.slogdet(a)[1]


def block_diag(matrices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Batched block-diagonal concatenation (linalg.py:355): inputs
    ``[..., rᵢ, cᵢ]`` with identical batch dims → ``[..., Σrᵢ, Σcᵢ]``."""
    if len(matrices) == 1:
        return matrices[0]
    rows = []
    for i, m in enumerate(matrices):
        blocks = [
            m if i == j else m.new_zeros(m.shape[:-1] + (other.shape[-1],))
            for j, other in enumerate(matrices)
        ]
        rows.append(torch.cat(blocks, dim=-1))
    return torch.cat(rows, dim=-2)


def kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product over the last two axes (linalg.py:378)."""
    m, n = a.shape[-2:]
    p, q = b.shape[-2:]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (m * p, n * q))


def mvn_logpdf(x: torch.Tensor, mean: torch.Tensor, chol_cov: torch.Tensor) -> torch.Tensor:
    """Multivariate normal log-density with a Cholesky-parameterized
    covariance (linalg.py:389): ``x, mean [..., d]``, ``chol_cov
    [..., d, d]`` → ``[...]``."""
    d = x.shape[-1]
    alpha = tri_solve(chol_cov, (x - mean)[..., None])[..., 0]
    maha = torch.sum(alpha**2, dim=-1)
    log_det = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chol_cov, dim1=-2, dim2=-1))), dim=-1
    )
    return -0.5 * (maha + log_det + d * math.log(2.0 * math.pi))
