"""The port's d ≥ 2 ``StateSpaceModel`` and matrix ``affine_scan`` against
the JAX package.

Random stable chains (``‖A‖ < 1``, random lower-triangular ``chol Q``) at
d = 2, 3 and 4, unbatched and with a batch of 3, built from numpy seeds and
handed to both sides.  Both sides scan with the same association order, so
float64 results differ by rounding only: tolerance 1e-10 of each output's
scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.ops.btd import affine_scan as j_affine_scan
from vi_diffusion_processes_tpu.ssm.state_space_model import StateSpaceModel as JSSM
from vi_diffusion_processes_tpu.ssm.state_space_model import (
    ssm_from_covariances as j_ssm_from_covariances,
)
from vi_diffusion_processes_tpu_torch.ops.btd import affine_scan
from vi_diffusion_processes_tpu_torch.ssm.state_space_model import ssm_from_covariances

from .helpers import assert_close_scaled, assert_ssm_close, port_ssm

N = 50
RTOL = 1e-10


def _chol(rng, shape, d):
    l = np.tril(0.3 * rng.normal(size=shape + (d, d)))
    idx = np.arange(d)
    l[..., idx, idx] = rng.uniform(0.3, 1.0, size=shape + (d,))
    return l


def _jax_ssm(d, batch=(), n=N):
    rng = np.random.default_rng(100 * d + len(batch))
    return JSSM(
        initial_mean=jnp.asarray(rng.normal(size=batch + (d,))),
        chol_initial_covariance=jnp.asarray(_chol(rng, batch, d)),
        state_transitions=jnp.asarray(0.9 * rng.normal(size=batch + (n, d, d)) / np.sqrt(d)),
        state_offsets=jnp.asarray(0.3 * rng.normal(size=batch + (n, d))),
        chol_process_covariances=jnp.asarray(_chol(rng, batch + (n,), d)),
    )


CASES = [(d, batch) for d in (2, 3, 4) for batch in ((), (3,))]
IDS = [f"d{d}-{'batched' if batch else 'single'}" for d, batch in CASES]


@pytest.mark.parametrize("d,batch", CASES, ids=IDS)
def test_marginals_and_subsequent_covariances(d, batch):
    jssm = _jax_ssm(d, batch)
    tssm = port_ssm(jssm)
    j_means, j_covs = jax.jit(lambda s: s.marginals())(jssm)
    means, covs = tssm.marginals()
    assert tuple(means.shape) == batch + (N + 1, d) and tuple(covs.shape) == batch + (N + 1, d, d)
    assert_close_scaled(means.numpy(), np.asarray(j_means), RTOL)
    assert_close_scaled(covs.numpy(), np.asarray(j_covs), RTOL)
    assert_close_scaled(tssm.marginal_means.numpy(), np.asarray(j_means), RTOL)
    assert_close_scaled(tssm.marginal_covariances.numpy(), np.asarray(j_covs), RTOL)
    assert_close_scaled(tssm.subsequent_covariances(covs).numpy(),
                        np.asarray(jssm.subsequent_covariances(j_covs)), RTOL)
    assert tssm.batch_shape == batch == jssm.batch_shape
    assert tssm.event_shape == (N + 1, d) == jssm.event_shape


@pytest.mark.parametrize("d,batch", CASES, ids=IDS)
def test_densities(d, batch):
    jssm = _jax_ssm(d, batch)
    tssm = port_ssm(jssm)
    states = np.random.default_rng(5).normal(size=batch + (N + 1, d))
    np.testing.assert_allclose(tssm.log_pdf(torch.tensor(states)).numpy(),
                               np.asarray(jssm.log_pdf(jnp.asarray(states))), rtol=RTOL)
    np.testing.assert_allclose(tssm.log_det_precision().numpy(),
                               np.asarray(jssm.log_det_precision()), rtol=RTOL)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_ssm_from_covariances_masks_zero_blocks(d):
    jssm = _jax_ssm(d)
    q = np.array(jssm.process_covariances)
    q[::7] = 0.0  # deterministic transitions: a zero factor, not NaNs
    args = (np.asarray(jssm.initial_mean), np.asarray(jssm.initial_covariance),
            np.asarray(jssm.state_transitions), np.asarray(jssm.state_offsets), q)
    ref = j_ssm_from_covariances(*(jnp.asarray(x) for x in args), jitter=1e-8)
    got = ssm_from_covariances(*(torch.tensor(x) for x in args), jitter=1e-8)
    assert_ssm_close(got, ref, RTOL)
    assert bool((got.chol_process_covariances[::7] == 0).all())
    assert bool(torch.isfinite(got.chol_process_covariances).all())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("d,batch", CASES, ids=IDS)
def test_matrix_affine_scan(d, batch, reverse):
    rng = np.random.default_rng(7 * d + len(batch))
    t_mats = 0.9 * rng.normal(size=batch + (N, d, d)) / np.sqrt(d)
    c_vecs = rng.normal(size=batch + (N, d))
    x0 = rng.normal(size=batch + (d,))
    ref = jax.jit(lambda t, c, x: j_affine_scan(t, c, x, reverse=reverse))(
        jnp.asarray(t_mats), jnp.asarray(c_vecs), jnp.asarray(x0))
    got = affine_scan(torch.tensor(t_mats), torch.tensor(c_vecs), torch.tensor(x0),
                      reverse=reverse)
    assert tuple(got.shape) == batch + (N, d)
    assert_close_scaled(got.numpy(), np.asarray(ref), RTOL)
    if not batch:  # and the recursion itself, one step after another
        x, want = x0, np.empty((N, d))
        for k in (range(N - 1, -1, -1) if reverse else range(N)):
            x = t_mats[k] @ x + c_vecs[k]
            want[k] = x
        assert_close_scaled(got.numpy(), want, RTOL)


def test_matrix_affine_scan_is_differentiable():
    rng = np.random.default_rng(2)
    t_mats = torch.tensor(0.5 * rng.normal(size=(6, 2, 2)), requires_grad=True)
    c_vecs = torch.tensor(rng.normal(size=(6, 2)), requires_grad=True)
    x0 = torch.tensor(rng.normal(size=(2,)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t, c, x: affine_scan(t, c, x, reverse=True), (t_mats, c_vecs, x0))
