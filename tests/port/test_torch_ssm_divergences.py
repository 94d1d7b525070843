"""The port's ``StateSpaceModel.precision``, ``normalizer``,
``kl_divergence``, ``log_det_precision`` and ``sample``, with ``qr_solve``
and ``gaussian_log_predictive_density``, against the JAX package.

Random stable chains from ``tests/tools/oracles.random_ssm_params`` (numpy
seeds) at d = 1, 2, 3 and N = 50, unbatched and with a batch of 2, float64;
every value to rtol 1e-10 of its scale.  ``jax.random`` cannot be
reproduced, so samples are held to their shapes, to the mean recursion of a
chain with almost no noise (rtol 1e-7, as the JAX package's own test), and
to the JAX chain's marginals by their moments: the sample mean within 5
standard errors, the sample variance within 5 of its standard errors
``σ²·√(2/(S−1))``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tools.oracles import random_ssm_params
from vi_diffusion_processes_tpu.sde.utils import (
    gaussian_log_predictive_density as j_log_predictive,
)
from vi_diffusion_processes_tpu.ssm.state_space_model import StateSpaceModel as JSSM
from vi_diffusion_processes_tpu.utils.linalg import qr_solve as j_qr_solve
from vi_diffusion_processes_tpu_torch.sde.utils import gaussian_log_predictive_density
from vi_diffusion_processes_tpu_torch.ssm.state_space_model import StateSpaceModel
from vi_diffusion_processes_tpu_torch.utils.linalg import qr_solve

from .helpers import assert_close_scaled

RTOL = 1e-10
N = 50
CASES = [(d, batch) for d in (1, 2, 3) for batch in ((), (2,))]
CASE_IDS = [f"d{d}-batch{len(b)}" for d, b in CASES]


def _pair(d, batch):
    """Two random chains on one grid: numpy parameters of q and p."""
    rng = np.random.default_rng(10 * d + len(batch))
    return random_ssm_params(rng, batch, N, d), random_ssm_params(rng, batch, N, d)


def _port(params):
    return StateSpaceModel(**{k: torch.tensor(v) for k, v in params.items()})


@functools.lru_cache(maxsize=None)
def _jax_values(d, batch):
    """One jitted JAX call per case: the precision, the normalizer, KL(q‖p)
    and the log-determinant of q."""
    qp, pp = _pair(d, batch)
    q, p = (JSSM(**{k: jnp.asarray(v) for k, v in x.items()}) for x in (qp, pp))

    @jax.jit
    def values(q, p):
        prec = q.precision()
        return prec.diag, prec.sub, q.normalizer(), q.kl_divergence(p), q.log_det_precision()

    return tuple(np.asarray(x) for x in values(q, p))


@pytest.mark.parametrize("d,batch", CASES, ids=CASE_IDS)
def test_precision(d, batch):
    diag, sub, *_ = _jax_values(d, batch)
    prec = _port(_pair(d, batch)[0]).precision()
    assert prec.diag.shape == diag.shape and prec.sub.shape == sub.shape
    assert_close_scaled(prec.diag.numpy(), diag, RTOL)
    assert_close_scaled(prec.sub.numpy(), sub, RTOL)


@pytest.mark.parametrize("d,batch", CASES, ids=CASE_IDS)
def test_normalizer(d, batch):
    want = _jax_values(d, batch)[2]
    assert_close_scaled(_port(_pair(d, batch)[0]).normalizer().numpy(), want, RTOL)


@pytest.mark.parametrize("d,batch", CASES, ids=CASE_IDS)
def test_kl_divergence(d, batch):
    want = _jax_values(d, batch)[3]
    qp, pp = _pair(d, batch)
    got = _port(qp).kl_divergence(_port(pp)).numpy()
    assert got.shape == batch
    assert_close_scaled(got, want, RTOL)


@pytest.mark.parametrize("d,batch", CASES, ids=CASE_IDS)
def test_log_det_precision(d, batch):
    want = _jax_values(d, batch)[4]
    assert_close_scaled(_port(_pair(d, batch)[0]).log_det_precision().numpy(), want, RTOL)


def test_kl_of_a_chain_with_itself_is_zero():
    q = _port(_pair(2, ())[0])
    assert abs(float(q.kl_divergence(q))) < 1e-10


def test_qr_solve_and_log_predictive_density():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 3, 3)) + 3.0 * np.eye(3)
    b = rng.normal(size=(4, 3, 2))
    assert_close_scaled(qr_solve(torch.tensor(a), torch.tensor(b)).numpy(),
                        j_qr_solve(jnp.asarray(a), jnp.asarray(b)), RTOL)
    # a batch of right-hand sides against one matrix
    assert_close_scaled(qr_solve(torch.tensor(a[0]), torch.tensor(b)).numpy(),
                        np.linalg.solve(a[0], b), RTOL)
    mean, x = rng.normal(size=(5, 2)), rng.normal(size=(5, 2))
    chol = np.linalg.cholesky(np.eye(2) + 0.3 * np.ones((2, 2)))
    got = gaussian_log_predictive_density(*(torch.tensor(v) for v in (mean, chol, x)))
    assert_close_scaled(got.numpy(), j_log_predictive(*(jnp.asarray(v) for v in (mean, chol, x))),
                        RTOL)


# ------------------------------------------------------------------ sampling
def _generator(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("sample_shape", [(), (1,), (4, 4), (0,), (0, 4)],
                         ids=["none", "s1", "s44", "s0", "s04"])
@pytest.mark.parametrize("d", [1, 2])
def test_sample_shapes(d, batch, sample_shape):
    ssm = _port(random_ssm_params(np.random.default_rng(1), batch, 3, d))
    samples = ssm.sample(_generator(), sample_shape)
    assert tuple(samples.shape) == sample_shape + batch + (4, d)
    assert samples.dtype == torch.float64
    assert bool(torch.isfinite(samples).all())


def _mean_recursion(params):
    out = [params["initial_mean"]]
    for i in range(params["state_offsets"].shape[-2]):
        out.append(np.einsum("...jk,...k->...j", params["state_transitions"][..., i, :, :],
                             out[-1]) + params["state_offsets"][..., i, :])
    return np.stack(out, axis=-2)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_almost_deterministic_chain_samples_its_mean(d):
    """With noise factors of √tiny every sample is the mean recursion
    (tests/unit/test_sampling_from_ssm.py:72-85)."""
    batch, n = (2,), 7
    params = random_ssm_params(np.random.default_rng(2), batch, n, d)
    tiny = np.sqrt(np.finfo(np.float64).tiny)
    params["chol_initial_covariance"] = np.broadcast_to(tiny * np.eye(d), batch + (d, d)).copy()
    params["chol_process_covariances"] = np.broadcast_to(
        tiny * np.eye(d), batch + (n, d, d)).copy()
    samples = _port(params).sample(_generator(), (5,)).numpy()
    expected = np.broadcast_to(_mean_recursion(params), samples.shape)
    np.testing.assert_allclose(samples, expected, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("d", [1, 2])
def test_sample_moments_match_the_marginals(d):
    s = 8192
    params = random_ssm_params(np.random.default_rng(4), (), N, d)
    samples = _port(params).sample(_generator(7), (s,)).numpy()
    jssm = JSSM(**{k: jnp.asarray(v) for k, v in params.items()})
    means, covs = (np.asarray(x) for x in jax.jit(lambda q: q.marginals())(jssm))
    var = np.diagonal(covs, axis1=-2, axis2=-1)
    se_mean = np.sqrt(var / s)
    assert np.all(np.abs(samples.mean(0) - means) < 5.0 * se_mean)
    se_var = var * np.sqrt(2.0 / (s - 1))
    assert np.all(np.abs(samples.var(0, ddof=1) - var) < 5.0 * se_var)
    if d == 2:  # the cross-covariance of the two components at every step
        centred = samples - samples.mean(0)
        cross = np.mean(centred[..., 0] * centred[..., 1], axis=0) * s / (s - 1)
        se_cross = np.sqrt((var[:, 0] * var[:, 1] + covs[:, 0, 1] ** 2) / (s - 1))
        assert np.all(np.abs(cross - covs[:, 0, 1]) < 5.0 * se_cross)


def test_sample_follows_its_generator():
    ssm = _port(random_ssm_params(np.random.default_rng(1), (), 9, 2))
    a, b = (ssm.sample(_generator(3), (4,)) for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, ssm.sample(_generator(4), (4,)))
