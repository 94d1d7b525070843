"""The port's dense BTD algebra, ``btd_udu`` and the Schur-segment UDU'
against the JAX package (ops/btd.py), float64, 1e-10 of the scale.

The matrices follow ``tests/unit/test_btd.py:23-35`` (N = 6, d = 3,
unbatched and with a batch of 2): symmetric positive-definite diagonal
blocks and small sub-diagonal ones, from numpy seeds.  The Schur scan is
held against the sequential recursion at d = 1 to 4 and against the JAX
package's ``udu_channels`` (through ``btd_udu_parallel_ch``) at d = 2, and
``U D Uᵀ`` must rebuild ``K``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.ops import btd as jb
from vi_diffusion_processes_tpu_torch.ops import btd as tb

from .helpers import assert_close_scaled

RTOL = 1e-10
N, D = 6, 3
BATCHES = [(), (2,)]


def _spd_btd(seed, n=N, d=D, batch=()):
    """``(diag, sub)`` of a symmetric positive-definite BTD matrix."""
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=batch + (n, d, d))
    diag = diag @ np.swapaxes(diag, -1, -2) + 2 * d * np.eye(d)
    sub = 0.3 * rng.normal(size=batch + (n - 1, d, d))
    return diag, sub


def _pair(diag, sub):
    return (jb.BTD(diag=jnp.asarray(diag), sub=jnp.asarray(sub)),
            tb.BTD(diag=torch.tensor(diag), sub=torch.tensor(sub)))


def _close(got, ref, rtol=RTOL, err_msg=""):
    assert_close_scaled(got.detach().numpy(), np.asarray(ref), rtol, err_msg=err_msg)


@pytest.fixture(params=BATCHES, ids=["one", "batch2"])
def pair(request):
    batch = request.param
    return batch, _pair(*_spd_btd(0, batch=batch))


def test_btd_properties_and_dense_round_trip(pair):
    batch, (jm, tm) = pair
    assert (tm.num_blocks, tm.block_dim, tm.batch_shape) == (N, D, batch)
    for symmetric in (True, False):
        dense = tb.btd_to_dense(tm, symmetric=symmetric)
        assert dense.shape == batch + (N * D, N * D)
        _close(dense, jb.btd_to_dense(jm, symmetric=symmetric))
    back = tb.btd_from_dense(tb.btd_to_dense(tm), N, D)
    assert torch.equal(back.diag, tm.diag) and torch.equal(back.sub, tm.sub)


@pytest.mark.parametrize("symmetric", [True, False])
def test_btd_matvec_add_scale(pair, symmetric):
    batch, (jm, tm) = pair
    x = np.random.default_rng(1).normal(size=batch + (N, D))
    _close(tb.btd_matvec(tm, torch.tensor(x), symmetric=symmetric),
           jb.btd_matvec(jm, jnp.asarray(x), symmetric=symmetric))
    dense = tb.btd_to_dense(tm, symmetric=symmetric).numpy()
    _close(tb.btd_matvec(tm, torch.tensor(x), symmetric=symmetric).reshape(batch + (N * D,)),
           np.einsum("...ij,...j->...i", dense, x.reshape(batch + (N * D,))))
    summed, scaled = tb.btd_add(tm, tm), tb.btd_scale(tm, -0.5)
    jsum, jscaled = jb.btd_add(jm, jm), jb.btd_scale(jm, -0.5)
    for got, ref in ((summed.diag, jsum.diag), (summed.sub, jsum.sub),
                     (scaled.diag, jscaled.diag), (scaled.sub, jscaled.sub)):
        _close(got, ref)


def test_btd_cholesky_logdet_and_solves(pair):
    batch, (jm, tm) = pair
    l, jl = tb.btd_cholesky(tm), jb.btd_cholesky(jm)
    _close(l.diag, jl.diag, err_msg="diag")
    _close(l.sub, jl.sub, err_msg="sub")
    _close(tb.btd_logdet_from_chol(l), jb.btd_logdet_from_chol(jl))
    _close(tb.btd_logdet_from_chol(l), np.linalg.slogdet(tb.btd_to_dense(tm).numpy())[1])
    rhs = np.random.default_rng(2).normal(size=batch + (N, D))
    for transpose in (False, True):
        _close(tb.btd_tri_solve_vec(l, torch.tensor(rhs), transpose=transpose),
               jb.btd_tri_solve_vec(jl, jnp.asarray(rhs), transpose=transpose),
               err_msg=f"transpose={transpose}")
    x = tb.btd_chol_solve_vec(l, torch.tensor(rhs))
    _close(x, jb.btd_chol_solve_vec(jl, jnp.asarray(rhs)))
    _close(tb.btd_matvec(tm, x), rhs)
    _close(tb.btd_solve_sym_vec(tm, torch.tensor(rhs)), jb.btd_solve_sym_vec(jm, jnp.asarray(rhs)))


def test_btd_blocks_of_inverse(pair):
    batch, (jm, tm) = pair
    inv, jinv = tb.btd_blocks_of_inverse(tb.btd_cholesky(tm)), jb.btd_blocks_of_inverse(
        jb.btd_cholesky(jm))
    _close(inv.diag, jinv.diag, err_msg="diag")
    _close(inv.sub, jinv.sub, err_msg="sub")
    # the in-band blocks of the dense inverse
    dense_inv = np.linalg.inv(tb.btd_to_dense(tm).numpy())
    band = tb.btd_from_dense(torch.tensor(dense_inv), N, D)
    _close(inv.diag, band.diag.numpy())
    _close(inv.sub, band.sub.numpy())


def test_btd_udu_matches_jax_and_rebuilds_k(pair):
    batch, (jm, tm) = pair
    d_blocks, u_super = tb.btd_udu(tm)
    jd, ju = jb.btd_udu(jm)
    _close(d_blocks, jd, err_msg="D")
    _close(u_super, ju, err_msg="U")
    _assert_rebuilds(tm, d_blocks, u_super)


def _assert_rebuilds(tm, d_blocks, u_super):
    """``U D Uᵀ = K`` with ``U`` unit upper block-bidiagonal."""
    n, d = tm.num_blocks, tm.block_dim
    batch = tm.batch_shape
    eye = torch.eye(d, dtype=d_blocks.dtype).expand(batch + (n, d, d))
    # U as a BTD: unit diagonal, U[k, k+1] = u_super[k] on the upper band
    u = tb.btd_to_dense(tb.BTD(diag=eye, sub=u_super.transpose(-1, -2)), symmetric=False)
    u = u.transpose(-1, -2)
    dmat = tb.btd_to_dense(tb.BTD(diag=d_blocks, sub=torch.zeros_like(u_super)))
    _close(u @ dmat @ u.transpose(-1, -2), tb.btd_to_dense(tm).numpy(), err_msg="U D Uᵀ")


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", BATCHES, ids=["one", "batch2"])
def test_schur_udu_matches_the_sequential_recursion(d, batch):
    """Three block counts: a level of the scan with an odd tail, one with
    an even tail, and a single segment."""
    for n in (37, 16, 2):
        _, tm = _pair(*_spd_btd(10 + d, n=n, d=d, batch=batch))
        d_blocks, u_super = tb.btd_udu_parallel(tm)
        ref_d, ref_u = tb.btd_udu(tm)
        _close(d_blocks, ref_d.numpy(), err_msg=f"D n={n}")
        _close(u_super, ref_u.numpy(), err_msg=f"U n={n}")
        _assert_rebuilds(tm, d_blocks, u_super)


def test_schur_udu_of_one_block_is_k():
    _, tm = _pair(*_spd_btd(3, n=1, d=2))
    d_blocks, u_super = tb.btd_udu_parallel(tm)
    assert torch.equal(d_blocks, tm.diag) and u_super.shape == (0, 2, 2)


def test_schur_udu_matches_jax_udu_channels():
    """The JAX package's channelized Schur scan at one shape (d = 2) of a
    CVI-like precision ``(−2Θ_diag, −Θ_sub)``, with a sub-diagonal of the
    size of the diagonal, as on a fine grid."""
    rng = np.random.default_rng(22)
    n, d = 41, 2
    a = rng.normal(size=(n, d, d))
    diag = 10.0 * (a @ np.swapaxes(a, -1, -2) + 4 * d * np.eye(d))
    sub = -9.0 * np.eye(d) + rng.normal(size=(n - 1, d, d))
    jm, tm = _pair(diag, sub)
    d_blocks, u_super = tb.btd_udu_parallel(tm)
    jd, ju = jb.btd_udu_parallel_ch(jm)
    _close(d_blocks, jd, err_msg="D")
    _close(u_super, ju, err_msg="U")
    _assert_rebuilds(tm, d_blocks, u_super)


def test_schur_udu_is_differentiable():
    """Autograd through the scan agrees with autograd through the
    sequential recursion."""
    diag, sub = _spd_btd(4, n=9, d=2)
    grads = []
    for fn in (tb.btd_udu_parallel, tb.btd_udu):
        leaves = [torch.tensor(diag, requires_grad=True), torch.tensor(sub, requires_grad=True)]
        d_blocks, u_super = fn(tb.BTD(*leaves))
        loss = torch.sum(torch.sin(d_blocks)) + torch.sum(u_super**2)
        g_diag, g_sub = torch.autograd.grad(loss, leaves)
        # K is symmetric: compare the gradients on its symmetric subspace
        grads.append((0.5 * (g_diag + g_diag.transpose(-1, -2)), g_sub))
    for g, r in zip(*grads):
        _close(g, r.numpy())
