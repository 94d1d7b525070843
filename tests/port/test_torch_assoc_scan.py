"""The port's generic associative scan against ``lax.associative_scan``.

``fn`` composes affine maps ``x ↦ M x + v`` on 3×3 matrices, which is
associative and does not commute, so a wrong operand order in either
direction shows in every row past the first.  Both sides run the same
odd–even recursion with the same association, so float64 results agree to
rounding: tolerance 1e-12 of each output's scale.  ``gradcheck`` holds the
autograd of both directions against finite differences at N = 7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vi_diffusion_processes_tpu_torch.ops.blocked_scan import assoc_scan

from .helpers import assert_close_scaled

D = 3


def _elems(n, batch=()):
    rng = np.random.default_rng(n + 17 * len(batch))
    mats = 0.9 * rng.normal(size=(n,) + batch + (D, D)) / np.sqrt(D)
    return mats, rng.normal(size=(n,) + batch + (D,))


def _jax_fn(x, y):
    # y after x
    return y[0] @ x[0], jnp.einsum("...ij,...j->...i", y[0], x[1]) + y[1]


def _torch_fn(x, y):
    return y[0] @ x[0], (y[0] @ x[1][..., None])[..., 0] + y[1]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1000])
def test_matches_lax_associative_scan(n, reverse):
    mats, vecs = _elems(n)
    ref = jax.jit(lambda e: lax.associative_scan(_jax_fn, e, reverse=reverse))(
        (jnp.asarray(mats), jnp.asarray(vecs)))
    got = assoc_scan(_torch_fn, (torch.tensor(mats), torch.tensor(vecs)), reverse=reverse)
    assert len(got) == 2
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert_close_scaled(g.numpy(), np.asarray(r), 1e-12)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_matches_a_sequential_fold(reverse):
    """Against the definition, one element after another, in numpy: for a
    reverse scan ``fn``'s first argument is the combined later suffix."""
    n = 11
    mats, vecs = _elems(n)
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc, want = None, {}
    for k in order:
        e = (mats[k], vecs[k])
        acc = e if acc is None else (e[0] @ acc[0], e[0] @ acc[1] + e[1])
        want[k] = acc
    got = assoc_scan(_torch_fn, (torch.tensor(mats), torch.tensor(vecs)), reverse=reverse)
    for k in range(n):
        np.testing.assert_allclose(got[0][k].numpy(), want[k][0], rtol=0, atol=1e-13)
        np.testing.assert_allclose(got[1][k].numpy(), want[k][1], rtol=0, atol=1e-13)


def test_rows_may_carry_batch_axes():
    mats, vecs = _elems(9, batch=(2, 4))
    ref = lax.associative_scan(_jax_fn, (jnp.asarray(mats), jnp.asarray(vecs)))
    got = assoc_scan(_torch_fn, (torch.tensor(mats), torch.tensor(vecs)))
    for g, r in zip(got, ref):
        assert_close_scaled(g.numpy(), np.asarray(r), 1e-12)


def test_leading_axes_must_agree():
    with pytest.raises(ValueError):
        assoc_scan(_torch_fn, (torch.zeros(3, D, D), torch.zeros(4, D)))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_gradcheck(reverse):
    mats, vecs = (torch.tensor(x, requires_grad=True) for x in _elems(7))
    assert torch.autograd.gradcheck(
        lambda m, v: assoc_scan(_torch_fn, (m, v), reverse=reverse), (mats, vecs))
