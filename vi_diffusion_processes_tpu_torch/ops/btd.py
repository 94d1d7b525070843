"""Block-tridiagonal algebra (vi_diffusion_processes_tpu/ops/btd.py).

The d = 1 dispatchers: the Riccati pivot sweep, the scalar affine
recurrences, the parallel UDU' built on them, and the scalar-channel
``dist_q`` composition (naturals → SSM parameters → marginals) of
``models/cvi_dp_packed.py:125-197``.  At d ≥ 2: the matrix ``affine_scan``
and the Schur-segment UDU' :func:`btd_udu_parallel`, both on the generic
associative scan.  The dense algebra (``btd_to_dense`` … ``btd_solve_sym_vec``)
and the sequential :func:`btd_udu` are reference tools: their recursions
are plain loops over the block axis.  Dispatch is by dtype and device:
float64 sweeps run K1 and float32 sweeps K4; the wrappers launch their
CUDA kernels for CUDA tensors and run their plain PyTorch versions for CPU
tensors.  Every wrapper is differentiable.  The JAX package's
``n >= 4096``, ``n >= 1024`` and ``backend == "tpu"`` gates have no
counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..utils import tracing
from ..utils.linalg import (
    chol_psd,
    cho_solve,
    eye_like,
    inv_pd,
    matmul_small,
    matvec_small,
    symmetrize,
    transpose_last,
    tri_solve,
)
from .blocked_scan import assoc_scan
from .cuda_riccati import _riccati_d_sweep_f32_unchecked
from .cuda_scan import _riccati_d_sweep_unchecked, dist_q_1d_planes, linear_recurrence

__all__ = [
    "BTD",
    "btd_to_dense",
    "btd_from_dense",
    "btd_matvec",
    "btd_add",
    "btd_scale",
    "btd_cholesky",
    "btd_chol_solve_vec",
    "btd_tri_solve_vec",
    "btd_logdet_from_chol",
    "btd_blocks_of_inverse",
    "btd_udu",
    "btd_udu_parallel",
    "btd_solve_sym_vec",
    "btd_udu_parallel_1d",
    "riccati_d_scalar",
    "scalar_affine_all",
    "affine_scan",
    "dist_q_1d_core",
    "dist_q_1d",
]


@dataclass(frozen=True)
class BTD:
    """Symmetric block-tridiagonal matrix: ``diag [..., N, d, d]`` and the
    sub-diagonal blocks ``sub [..., N-1, d, d]`` (btd.py ``BTD``)."""

    diag: torch.Tensor
    sub: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.diag.shape[-3]

    @property
    def block_dim(self) -> int:
        return self.diag.shape[-1]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.diag.shape[:-3])


def _stack_blocks(blocks, like: torch.Tensor) -> torch.Tensor:
    """Per-block results of a loop, stacked on the block axis ``-3``; ``like``
    (already of the right shape) stands in when the loop ran no step."""
    return torch.stack(blocks, dim=-3) if blocks else like.clone()


def btd_to_dense(m: BTD, symmetric: bool = True) -> torch.Tensor:
    """Densify to ``[..., N·d, N·d]`` (btd.py:79-93; tests and debugging)."""
    n, d = m.num_blocks, m.block_dim
    out = m.diag.new_zeros(m.batch_shape + (n, d, n, d))
    idx = torch.arange(n, device=m.diag.device)
    # the two index arrays sit apart, so their axis comes first
    out[..., idx, :, idx, :] = m.diag.movedim(-3, 0)
    if n > 1:
        out[..., idx[1:], :, idx[:-1], :] = m.sub.movedim(-3, 0)
        if symmetric:
            out[..., idx[:-1], :, idx[1:], :] = transpose_last(m.sub).movedim(-3, 0)
    return out.reshape(m.batch_shape + (n * d, n * d))


def btd_from_dense(dense: torch.Tensor, n: int, d: int) -> BTD:
    """The in-band blocks of a dense ``[..., N·d, N·d]`` matrix (btd.py:96-108)."""
    blocks = dense.reshape(tuple(dense.shape[:-2]) + (n, d, n, d))
    idx = torch.arange(n, device=dense.device)
    return BTD(
        diag=blocks[..., idx, :, idx, :].movedim(0, -3),
        sub=blocks[..., idx[1:], :, idx[:-1], :].movedim(0, -3),
    )


def btd_matvec(m: BTD, vec: torch.Tensor, symmetric: bool = True) -> torch.Tensor:
    """``K x`` for ``x [..., N, d]`` (btd.py:111-122)."""
    y = matvec_small(m.diag, vec)
    lower = matvec_small(m.sub, vec[..., :-1, :])
    y = y + torch.cat([torch.zeros_like(vec[..., :1, :]), lower], dim=-2)
    if symmetric:
        upper = matvec_small(transpose_last(m.sub), vec[..., 1:, :])
        y = y + torch.cat([upper, torch.zeros_like(vec[..., :1, :])], dim=-2)
    return y


def btd_add(a: BTD, b: BTD) -> BTD:
    return BTD(diag=a.diag + b.diag, sub=a.sub + b.sub)


def btd_scale(a: BTD, s) -> BTD:
    return BTD(diag=a.diag * s, sub=a.sub * s)


def btd_cholesky(m: BTD) -> BTD:
    """Blocked Cholesky ``K = L Lᵀ`` of a symmetric PD BTD matrix
    (btd.py:137-167): ``L₀L₀ᵀ = D₀``, ``Cₖ = BₖLₖ⁻ᵀ``,
    ``Lₖ₊₁Lₖ₊₁ᵀ = Dₖ₊₁ − CₖCₖᵀ``.  ``L`` is lower block-bidiagonal."""
    diag, sub = m.diag.movedim(-3, 0), m.sub.movedim(-3, 0)
    ls, cs = [chol_psd(diag[0])], []
    for b_k, d_next in zip(sub, diag[1:]):
        c_k = transpose_last(tri_solve(ls[-1], transpose_last(b_k)))
        cs.append(c_k)
        ls.append(chol_psd(d_next - c_k @ transpose_last(c_k)))
    return BTD(diag=_stack_blocks(ls, m.diag), sub=_stack_blocks(cs, m.sub))


def btd_tri_solve_vec(l: BTD, rhs: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """Solve ``L x = rhs`` (or ``Lᵀ x = rhs``) for lower block-bidiagonal
    ``L``, ``rhs [..., N, d]`` (btd.py:170-203)."""
    ld, ls, r = l.diag.movedim(-3, 0), l.sub.movedim(-3, 0), rhs.movedim(-2, 0)

    def solve(lk, v):
        return tri_solve(lk, v[..., None], transpose=transpose)[..., 0]

    n = ld.shape[0]
    if not transpose:
        xs = [solve(ld[0], r[0])]
        for k in range(n - 1):
            xs.append(solve(ld[k + 1], r[k + 1] - matvec_small(ls[k], xs[-1])))
    else:  # Lᵀ is upper block-bidiagonal: backward substitution
        xs = [solve(ld[-1], r[-1])]
        for k in range(n - 2, -1, -1):
            xs.append(solve(ld[k], r[k] - matvec_small(transpose_last(ls[k]), xs[-1])))
        xs.reverse()
    return torch.stack(xs, dim=-2)


def btd_chol_solve_vec(l: BTD, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``(L Lᵀ) x = rhs`` given the BTD Cholesky factor (btd.py:206-208)."""
    return btd_tri_solve_vec(l, btd_tri_solve_vec(l, rhs), transpose=True)


def btd_logdet_from_chol(l: BTD) -> torch.Tensor:
    """``log |L Lᵀ| = 2 Σ log diag(L)`` (btd.py:211-215)."""
    diag = torch.diagonal(l.diag, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(torch.abs(diag)), dim=(-1, -2))


def btd_blocks_of_inverse(l: BTD) -> BTD:
    """In-band blocks of ``(L Lᵀ)⁻¹`` from the BTD Cholesky factor by the
    backward block recursion of btd.py:218-254: ``Σ_NN = L_N⁻ᵀL_N⁻¹``,
    ``G_k = −L_k⁻ᵀCₖᵀ``, ``Σ_{k,k+1} = G_kΣ_{k+1,k+1}``,
    ``Σ_kk = L_k⁻ᵀL_k⁻¹ + G_kΣ_{k+1,k+1}G_kᵀ``.  Returns ``diag[k] = Σ_kk``
    and ``sub[k] = Σ_{k+1,k}``."""
    ld, ls = l.diag.movedim(-3, 0), l.sub.movedim(-3, 0)

    def inv_from_chol(lk):
        linv = tri_solve(lk, eye_like(lk).expand(lk.shape))
        return transpose_last(linv) @ linv

    sigmas, subs = [inv_from_chol(ld[-1])], []
    for k in range(ld.shape[0] - 2, -1, -1):
        g_k = -tri_solve(ld[k], transpose_last(ls[k]), transpose=True)
        cross = g_k @ sigmas[-1]
        subs.append(transpose_last(cross))
        sigmas.append(inv_from_chol(ld[k]) + cross @ transpose_last(g_k))
    return BTD(diag=_stack_blocks(sigmas[::-1], l.diag), sub=_stack_blocks(subs[::-1], l.sub))


def btd_udu(k: BTD) -> Tuple[torch.Tensor, torch.Tensor]:
    """``K = U D Uᵀ`` with unit upper block-bidiagonal ``U`` by the
    sequential backward recursion ``D_k = K_kk − b_kᵀ D_{k+1}⁻¹ b_k``
    (btd.py:257-283; ``b_k = K[k+1, k]``).  Returns ``(D [..., N, d, d],
    U [..., N-1, d, d])`` with ``U[k] = U[k, k+1] = b_kᵀ D_{k+1}⁻¹``.  The
    plain reference of :func:`btd_udu_parallel`, and the float32 route of
    ``naturals_to_ssm_params``."""
    kd, ks = k.diag.movedim(-3, 0), k.sub.movedim(-3, 0)
    ds, us = [kd[-1]], []
    for i in range(kd.shape[0] - 2, -1, -1):
        ut_i = cho_solve(chol_psd(ds[-1]), ks[i])  # U_iᵀ = D_{i+1}⁻¹ b_i
        us.append(transpose_last(ut_i))
        ds.append(kd[i] - transpose_last(ut_i) @ ks[i])
    return _stack_blocks(ds[::-1], k.diag), _stack_blocks(us[::-1], k.sub)


def _schur_compose(later, earlier):
    """Join two adjacent segments by eliminating their shared interface
    (btd.py:482-492).  A segment ``[i..j]`` is its boundary quadratic form
    ``(A, B, C)`` over ``x_i²``, ``x_i·x_j``, ``x_j²`` with the interior
    eliminated; the pivot ``M = C_earlier + A_later`` is positive definite."""
    a_r, b_r, c_r = later
    a_l, b_l, c_l = earlier
    m_inv = inv_pd(c_l + a_r)
    blm = matmul_small(b_l, m_inv)
    a_new = symmetrize(a_l - matmul_small(blm, transpose_last(b_l)))
    b_new = -matmul_small(blm, b_r)
    c_new = symmetrize(
        c_r - matmul_small(transpose_last(b_r), matmul_small(m_inv, b_r)))
    return a_new, b_new, c_new


def btd_udu_parallel(k: BTD) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`btd_udu` as one reverse associative scan of Schur segments:
    the math of ``btd_udu_parallel_ch``, ``udu_channels`` and
    ``btd_udu_parallel_dense`` (btd.py:286-614) on ``[N-1, d, d]`` stacks.

    ``D_k`` is the Schur complement of the suffix ``K[k:, k:]`` onto
    ``x_k``.  Segment ``[k, k+1]`` starts as ``(0, b_kᵀ, K_{k+1,k+1})``; the
    reverse scan gives the suffix ``[k..N-1]`` as ``(A_k, B_k, C_k)``, and
    ``D_k = K_kk + A_k − B_k C_k⁻¹ B_kᵀ``, ``D_{N-1} = K_{N-1,N-1}``,
    ``U_k = b_kᵀ D_{k+1}⁻¹``.  Every pivot is positive definite, so the
    scan is stable where the 2d×2d transfer-matrix product is not.  The
    scan never pads, so no element needs to be neutral: the JAX package's
    identity flag and its guarded pivots have no counterpart.  Inverses are
    :func:`inv_pd`'s (closed forms up to d = 3)."""
    kd, b = k.diag, k.sub
    if b.shape[-3] == 0:
        return kd, b
    b_t = transpose_last(b)
    a_s, b_s, c_s = assoc_scan(
        _schur_compose,
        (torch.zeros_like(b).movedim(-3, 0), b_t.movedim(-3, 0), kd[..., 1:, :, :].movedim(-3, 0)),
        reverse=True,
    )
    a_s, b_s, c_s = (x.movedim(0, -3) for x in (a_s, b_s, c_s))
    corr = matmul_small(b_s, matmul_small(inv_pd(c_s), transpose_last(b_s)))
    d_head = symmetrize(kd[..., :-1, :, :] + a_s - corr)
    d_blocks = torch.cat([d_head, kd[..., -1:, :, :]], dim=-3)
    return d_blocks, matmul_small(b_t, inv_pd(d_blocks[..., 1:, :, :]))


def btd_solve_sym_vec(k: BTD, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``K x = rhs`` through ``K = U D Uᵀ`` (btd.py:940-970): ``U z =
    rhs`` backward, ``w = D⁻¹z``, ``Uᵀ x = w`` forward."""
    d_blocks, u_super = btd_udu(k)
    u, r = u_super.movedim(-3, 0), rhs.movedim(-2, 0)
    zs = [r[-1]]
    for i in range(r.shape[0] - 2, -1, -1):
        zs.append(r[i] - matvec_small(u[i], zs[-1]))
    z = torch.stack(zs[::-1], dim=-2)
    w = cho_solve(chol_psd(d_blocks), z[..., None])[..., 0].movedim(-2, 0)
    xs = [w[0]]
    for i in range(1, w.shape[0]):
        xs.append(w[i] - matvec_small(transpose_last(u[i - 1]), xs[-1]))
    return torch.stack(xs, dim=-2)


def riccati_d_scalar(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``D_k = kd_k − b2_k/D_{k+1}`` on ``[..., N]`` channels (btd.py:672-704).

    float64 runs kernel K1 and float32 the sequential-order windowed sweep
    K4 (the x64-off configuration), on CUDA, or their plain versions on
    the CPU.  Contract: ``b2[..., N−1] = 0``, the structural zero that every
    caller here builds in.  It is not checked (as in btd.py:672): reading it
    on the host would wait for the device on every sweep.  The public
    ``riccati_d_sweep`` and ``riccati_d_sweep_f32`` check it and raise."""
    if kd.dtype == torch.float32:
        return _riccati_d_sweep_f32_unchecked(kd.contiguous(), b2.contiguous())
    return _riccati_d_sweep_unchecked(kd.contiguous(), b2.contiguous())


def scalar_affine_all(t: torch.Tensor, c: torch.Tensor, x0, *, reverse: bool = False) -> torch.Tensor:
    """``x_k = t_k x_{k±1} + c_k`` on scalar channels ``[..., N]``
    (btd.py:803-822): kernel K2 on CUDA, its plain version on the CPU."""
    return linear_recurrence(t.contiguous(), c.contiguous(), x0, reverse)


def btd_udu_parallel_1d(k: BTD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel UDU' for scalar blocks (btd.py:631-669): the pivots
    ``D [..., N, 1, 1]`` and the superdiagonal ``U [..., N-1, 1, 1]`` with
    ``U_k = K[k, k+1] / D_{k+1}``."""
    kd = k.diag[..., 0, 0]
    ks = k.sub[..., 0, 0]
    b2 = torch.cat([ks**2, torch.zeros_like(kd[..., :1])], dim=-1)
    d_scalar = riccati_d_scalar(kd, b2)
    u_scalar = ks / d_scalar[..., 1:]
    return d_scalar[..., :, None, None], u_scalar[..., :, None, None]


def affine_scan(
    t_mats: torch.Tensor, c_vecs: torch.Tensor, x0: torch.Tensor, *, reverse: bool = False
) -> torch.Tensor:
    """``x_k = T_k x_{k±1} + c_k`` (btd.py:848): ``t_mats [..., N, d, d]``,
    ``c_vecs [..., N, d]``, and the boundary value ``x0 [..., d]`` (before
    the first element, or after the last with ``reverse``).  Returns all N
    values.  d = 1 runs K2; d ≥ 2 the associative scan over ``(T, c)``."""
    if t_mats.shape[-1] == 1:
        xs = scalar_affine_all(t_mats[..., 0, 0], c_vecs[..., 0], x0[..., 0], reverse=reverse)
        return xs[..., None]

    def compose(e1, e2):
        # e2 is applied after e1 in recursion order; a reverse scan passes
        # (later suffix, earlier element), for which the same formula holds
        a1, b1 = e1
        a2, b2 = e2
        return matmul_small(a2, a1), matvec_small(a2, b1) + b2

    ca, cb = assoc_scan(
        compose, (t_mats.movedim(-3, 0), c_vecs.movedim(-2, 0)), reverse=reverse
    )
    return (matvec_small(ca, x0) + cb).movedim(0, -2)


def _naturals_to_ssm_1d(nat1, nat2d, nat2s):
    """Scalar-channel ``naturals_to_ssm_params`` (cvi_dp_packed.py:125-145):
    ``(a, b, qv, mu0, p0v, mu)`` in the input dtype, through the sweep (K1
    or K4) and K2, over ``[..., N]`` channels."""
    kd = -2.0 * nat2d
    ks = -nat2s
    b2 = torch.cat([ks**2, torch.zeros_like(kd[..., :1])], dim=-1)
    d_blocks = riccati_d_scalar(kd, b2)
    u = ks / d_blocks[..., 1:]
    a = -u
    covs = 1.0 / d_blocks
    # means: U z = θ (backward), w = D⁻¹ z, Uᵀ μ = w (forward)
    z_rest = scalar_affine_all(-u, nat1[..., :-1], nat1[..., -1], reverse=True)
    z = torch.cat([z_rest, nat1[..., -1:]], dim=-1)
    w = covs * z
    mu_rest = scalar_affine_all(-u, w[..., 1:], w[..., 0])
    mu = torch.cat([w[..., :1], mu_rest], dim=-1)
    b = mu[..., 1:] - a * mu[..., :-1]
    return a, b, covs[..., 1:], mu[..., 0], covs[..., 0], mu


def _marginals_1d(a, b, qv, mu0, p0v):
    """Scalar marginal means/vars (cvi_dp_packed.py:148-177): the two
    recurrences ``m_k = a_k m_{k−1} + b_k`` and ``v_k = a_k² v_{k−1} + qv_k``
    through K2."""
    m_rest = scalar_affine_all(a, b, mu0)
    v_rest = scalar_affine_all(a * a, qv, p0v)
    return (torch.cat([mu0[..., None], m_rest], dim=-1),
            torch.cat([p0v[..., None], v_rest], dim=-1))


def dist_q_1d_core(nat1, nat2d, nat2s, compute_dtype):
    """naturals → SSM params + marginals as a composition of the sweep and
    K2 (cvi_dp_packed.py:187-197): the algebra in the naturals' dtype,
    marginals in ``compute_dtype``.  Returns ``(a, b, qv, mu0, p0v, means,
    vars)``; kernel K3 is held against it, and its backward is this
    composition's VJP."""
    a, b, qv, mu0, p0v, _ = _naturals_to_ssm_1d(nat1, nat2d, nat2s)
    a, b, qv, mu0, p0v = (x.to(compute_dtype) for x in (a, b, qv, mu0, p0v))
    means, varis = _marginals_1d(a, b, qv, mu0, p0v)
    return a, b, qv, mu0, p0v, means, varis


def dist_q_1d(nat1, nat2d, nat2s, compute_dtype):
    """The d = 1 naturals → SSM params → marginals chain by the naturals'
    dtype: float64 (the x64 policy) takes kernel K3, one launch on CUDA;
    float32 (x64 off) takes its composition :func:`dist_q_1d_core`, one K4
    and four float32 K2 launches.  Counts the route (``utils/tracing.py``):
    ``dist_q_1d.k3`` where K3 launches, ``dist_q_1d.plain`` otherwise (K3's
    plain version on the CPU, or the composition), which a captured step
    counts again at each replay."""
    if nat1.dtype == torch.float64:
        tracing.count("dist_q_1d.k3" if nat1.is_cuda else "dist_q_1d.plain")
        return dist_q_1d_planes(nat1, nat2d, nat2s, compute_dtype)
    tracing.count("dist_q_1d.plain")
    return dist_q_1d_core(nat1, nat2d, nat2s, compute_dtype)
