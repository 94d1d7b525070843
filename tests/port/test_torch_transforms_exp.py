"""The port's expectation-parameter transforms against the JAX package.

Inputs are a random stable SSM made with numpy from a seed; its expectation
parameters at d = 2 come from a numpy forward recursion, which also holds
the port's d = 2 ``marginals()`` (the generic associative scan).  float64,
rtol 1e-10 of each array's scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.sde.drift import linear_drift_from_ssm as j_drift_from_ssm
from vi_diffusion_processes_tpu.ssm import transforms as jt
from vi_diffusion_processes_tpu.ssm.state_space_model import StateSpaceModel as JSSM
from vi_diffusion_processes_tpu_torch.sde.drift import linear_drift_from_ssm
from vi_diffusion_processes_tpu_torch.ssm import transforms as tt
from vi_diffusion_processes_tpu_torch.ssm.state_space_model import StateSpaceModel

from .helpers import assert_close_scaled

N = 40
RTOL = 1e-10


def _ssm_fields(d, seed=0):
    rng = np.random.default_rng(seed)
    chol = lambda shape: np.tril(rng.normal(size=shape + (d, d)) * 0.2) + 0.7 * np.eye(d)
    return dict(
        initial_mean=rng.normal(size=d),
        chol_initial_covariance=chol(()),
        state_transitions=0.3 * rng.normal(size=(N, d, d)) + 0.5 * np.eye(d),
        state_offsets=rng.normal(size=(N, d)),
        chol_process_covariances=chol((N,)),
    )


def _expectations(f):
    """The expectation parameters of the SSM by the numpy forward recursion."""
    means, covs = [f["initial_mean"]], [f["chol_initial_covariance"] @ f["chol_initial_covariance"].T]
    for a, b, l in zip(f["state_transitions"], f["state_offsets"], f["chol_process_covariances"]):
        means.append(a @ means[-1] + b)
        covs.append(a @ covs[-1] @ a.T + l @ l.T)
    m, s = np.stack(means), np.stack(covs)
    eta_sub = f["state_transitions"] @ s[:-1] + m[1:, :, None] * m[:-1, None, :]
    return m, s + m[:, :, None] * m[:, None, :], eta_sub


def _both(f):
    return (JSSM(**{k: jnp.asarray(v) for k, v in f.items()}),
            StateSpaceModel(**{k: torch.tensor(v) for k, v in f.items()}))


@pytest.mark.parametrize("d", [1, 2])
def test_expectations_to_ssm_params_matches_jax_and_recovers_the_ssm(d):
    f = _ssm_fields(d)
    exps = _expectations(f)
    got = tt.expectations_to_ssm_params(*(torch.tensor(e) for e in exps))
    ref = jt.expectations_to_ssm_params(*(jnp.asarray(e) for e in exps))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert_close_scaled(g.numpy(), np.asarray(r), RTOL)
    # (A, b, chol P0, chol Q, mu0): the transform inverts the recursion
    a_s, offsets, chol_p0, chol_qs, mu0 = (g.numpy() for g in got)
    np.testing.assert_allclose(a_s, f["state_transitions"], rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(offsets, f["state_offsets"], rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(mu0, f["initial_mean"], rtol=1e-10)
    q = f["chol_process_covariances"] @ np.swapaxes(f["chol_process_covariances"], -1, -2)
    np.testing.assert_allclose(chol_qs @ np.swapaxes(chol_qs, -1, -2), q, rtol=1e-7, atol=1e-9)


def test_ssm_to_expectations_matches_jax_at_d1():
    f = _ssm_fields(1)
    jssm, tssm = _both(f)
    got, ref = tt.ssm_to_expectations(tssm), jt.ssm_to_expectations(jssm)
    for g, r, e in zip(got, ref, _expectations(f)):
        assert_close_scaled(g.numpy(), np.asarray(r), RTOL)
        assert_close_scaled(g.numpy(), e, RTOL)


def test_expectation_round_trip_at_d1():
    f = _ssm_fields(1, seed=1)
    _, tssm = _both(f)
    back = tt.expectations_to_ssm(*tt.ssm_to_expectations(tssm))
    for name, value in f.items():
        # d = 1 Cholesky factors are defined up to their sign
        got = getattr(back, name).numpy()
        ref = np.abs(value) if name.startswith("chol") else value
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10, err_msg=name)


def test_ssm_to_expectations_at_d2_names_slice_d():
    """Until slice D this raised, naming the slice; with the d = 2 marginals
    on the generic scan it gives the numpy recursion's and the JAX package's
    expectation parameters."""
    f = _ssm_fields(2)
    jssm, tssm = _both(f)
    got = tt.ssm_to_expectations(tssm)
    for g, r, e in zip(got, jt.ssm_to_expectations(jssm), _expectations(f)):
        assert_close_scaled(g.numpy(), np.asarray(r), RTOL)
        assert_close_scaled(g.numpy(), e, RTOL)


@pytest.mark.parametrize("d", [1, 2])
def test_linear_drift_from_ssm_matches_jax(d):
    jssm, tssm = _both(_ssm_fields(d))
    got, ref = linear_drift_from_ssm(tssm, 0.01), j_drift_from_ssm(jssm, 0.01)
    assert_close_scaled(got.A.numpy(), np.asarray(ref.A), RTOL)
    assert_close_scaled(got.b.numpy(), np.asarray(ref.b), RTOL)
