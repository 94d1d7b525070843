"""The backward passes of K1, K2 and K4 against ``jax.vjp`` of the JAX package.

On the CPU each wrapper's ``torch.autograd.Function`` runs its plain
forward and the JAX package's adjoint formula (``_ric_bwd``,
``_linrec_bwd``, ``_riccati_bwd``); the JAX side differentiates its CPU
paths (``ops/btd.py::riccati_d_scalar`` and ``scalar_affine_all``) by
autodiff.  Same numpy-seeded inputs and cotangents on both sides.  K3's
backward is held in ``test_torch_dist_q_adjoint.py``.

Tolerances, relative to each gradient's scale: 1e-10 in float64 (the two
sides sum in different orders); 2e-4 in float32.  ``gradcheck`` holds the
float64 Functions, K3's included, against finite differences at N = 37.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.ops.btd import riccati_d_scalar as jax_riccati
from vi_diffusion_processes_tpu.ops.btd import scalar_affine_all as jax_affine
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import riccati_d_sweep_f32

from .helpers import affine_inputs, assert_close_scaled, naturals, riccati_inputs

SIZES = [1500, 5000]  # both ragged against the windows
TOL = {"float64": 1e-10, "float32": 2e-4}


@jax.jit
def _jax_riccati_vjp(kd, b2, g):
    return jax.vjp(jax_riccati, kd, b2)[1](g)


@jax.jit
def _jax_affine_vjp(t, c, x0, g):
    return jax.vjp(lambda *a: jax_affine(*a, reverse=False), t, c, x0)[1](g)


@jax.jit
def _jax_affine_rev_vjp(t, c, x0, g):
    return jax.vjp(lambda *a: jax_affine(*a, reverse=True), t, c, x0)[1](g)


def _grads(fn, inputs, cotangent):
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, cotangent)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", SIZES)
def test_sweep_vjp_matches_jax(rng, n, dtype):
    """K1 (float64) and K4 (float32)."""
    kd, b2 = (x.astype(dtype) for x in riccati_inputs(rng, n))
    g = rng.normal(size=n).astype(dtype)
    ref = _jax_riccati_vjp(jnp.asarray(kd), jnp.asarray(b2), jnp.asarray(g))
    fn = cs.riccati_d_sweep if dtype == "float64" else riccati_d_sweep_f32
    got = _grads(fn, (kd, b2), torch.tensor(g))
    assert_close_scaled(got[0].numpy(), ref[0], TOL[dtype], err_msg="kd")
    # b2[-1] is the structural zero of the sweep: JAX's autodiff through
    # sqrt(b2) gives NaN there, the adjoint formula 0
    assert_close_scaled(got[1].numpy()[:-1], np.asarray(ref[1])[:-1], TOL[dtype], err_msg="b2")
    assert float(got[1][-1]) == 0.0


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", SIZES)
def test_linear_recurrence_vjp_matches_jax(rng, n, dtype, reverse):
    """K2 with a tensor boundary value, which receives its own gradient."""
    t, c = (x.astype(dtype) for x in affine_inputs(rng, n))
    x0 = np.asarray(0.7, dtype)
    g = rng.normal(size=n).astype(dtype)
    jfn = _jax_affine_rev_vjp if reverse else _jax_affine_vjp
    ref = jfn(jnp.asarray(t), jnp.asarray(c), jnp.asarray(x0), jnp.asarray(g))
    got = _grads(lambda *a: cs.linear_recurrence(*a, reverse), (t, c, x0), torch.tensor(g))
    for name, gt, r in zip(("t", "c", "x0"), got, ref):
        assert gt.shape == np.shape(r) and gt.dtype == getattr(torch, dtype), name
        assert_close_scaled(gt.numpy(), r, TOL[dtype], err_msg=name)


def test_boundary_value_gradient_keeps_its_shape(rng):
    """``x0`` as a 0-d tensor broadcast over a batch, or batch-shaped."""
    t, c = (torch.tensor(x) for x in affine_inputs(rng, 300, (2,)))
    for reverse in (False, True):
        x0_scalar = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
        x0_batch = torch.tensor([0.3, 0.3], dtype=torch.float64, requires_grad=True)
        g = torch.tensor(rng.normal(size=(2, 300)))
        (gs,) = torch.autograd.grad(cs.linear_recurrence(t, c, x0_scalar, reverse), x0_scalar, g)
        (gb,) = torch.autograd.grad(cs.linear_recurrence(t, c, x0_batch, reverse), x0_batch, g)
        assert gs.shape == () and gb.shape == (2,)
        torch.testing.assert_close(gs, gb.sum())


def test_float64_functions_pass_gradcheck(rng):
    n = 37
    kd, b2 = (torch.tensor(x, requires_grad=True) for x in riccati_inputs(rng, n))
    b2_head = b2.detach()[:-1].clone().requires_grad_()  # b2[-1] stays the structural 0
    assert torch.autograd.gradcheck(
        lambda k, b: cs.riccati_d_sweep(k, torch.cat([b, b.new_zeros(1)])), (kd, b2_head))
    t, c = (torch.tensor(x, requires_grad=True) for x in affine_inputs(rng, n, (2,)))
    x0 = torch.tensor([0.7, -0.2], dtype=torch.float64, requires_grad=True)
    for reverse in (False, True):
        assert torch.autograd.gradcheck(lambda *a: cs.linear_recurrence(*a, reverse), (t, c, x0))
    nat = [torch.tensor(x, requires_grad=True) for x in naturals(rng, n)]
    assert torch.autograd.gradcheck(lambda *a: cs.dist_q_1d_planes(*a, torch.float64), nat)
