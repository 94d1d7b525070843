"""Quadrature, SDE linearization, SSM transforms and the Gaussian likelihood
of the port against their JAX twins, in float64 at rtol 1e-10 (the two
sides differ only in summation order and scan association)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.ops.quadrature import mvnquad as jax_mvnquad
from vi_diffusion_processes_tpu.sde import utils as jsu
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu.ssm import transforms as jtr
from vi_diffusion_processes_tpu.ssm.state_space_model import StateSpaceModel as JSSM
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.ops.quadrature import mvnquad
from vi_diffusion_processes_tpu_torch.sde import utils as tsu
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE
from vi_diffusion_processes_tpu_torch.ssm import transforms as ttr
from vi_diffusion_processes_tpu_torch.ssm.state_space_model import StateSpaceModel

from .helpers import to_np

RTOL = 1e-10
N = 200  # transitions


def _close(got, ref, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _random_ssm(rng, n=N):
    fields = dict(
        initial_mean=rng.normal(size=(1,)),
        chol_initial_covariance=rng.uniform(0.5, 1.0, (1, 1)),
        state_transitions=rng.uniform(0.5, 0.99, (n, 1, 1)),
        state_offsets=0.1 * rng.normal(size=(n, 1)),
        chol_process_covariances=rng.uniform(0.1, 0.5, (n, 1, 1)),
    )
    return (JSSM(**{k: jnp.asarray(v) for k, v in fields.items()}),
            StateSpaceModel(**{k: torch.tensor(v) for k, v in fields.items()}))


@pytest.mark.parametrize("d", [1, 2])
def test_mvnquad_matches_jax(rng, d):
    means = rng.normal(size=(7, d))
    a = rng.normal(size=(7, d, d))
    covs = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(d)
    ref = jax_mvnquad(lambda x: jnp.sin(x) * x**2, jnp.asarray(means), jnp.asarray(covs))
    got = mvnquad(lambda x: torch.sin(x) * x**2, torch.tensor(means), torch.tensor(covs))
    _close(got, ref)


def _dw_pair():
    jsde = JDoubleWell(q_mat=jnp.asarray([[0.8]]))
    return jsde, interop.sde_from_numpy("DoubleWellSDE", to_np(jsde), device="cpu")


def test_linearize_sde_matches_jax(rng):
    jsde, tsde = _dw_pair()
    grid = np.linspace(0.0, 2.0, N + 1)
    mu = rng.normal(size=(N, 1))
    cov = rng.uniform(0.1, 1.0, (N, 1, 1))
    init = (np.zeros(1), np.asarray([[0.8]]))
    ref = jsu.linearize_sde(jsde, jnp.asarray(grid), jsu.Gaussian(jnp.asarray(mu), jnp.asarray(cov)),
                            jsu.Gaussian(*map(jnp.asarray, init)))
    with torch.no_grad():
        got = tsu.linearize_sde(tsde, torch.tensor(grid), tsu.Gaussian(torch.tensor(mu), torch.tensor(cov)),
                                tsu.Gaussian(*map(torch.tensor, init)))
    for name in ("initial_mean", "chol_initial_covariance", "state_transitions",
                 "state_offsets", "chol_process_covariances"):
        _close(getattr(got, name), getattr(ref, name), atol=1e-14, msg=name)


def test_ssm_to_naturals_matches_jax(rng):
    jssm, tssm = _random_ssm(rng)
    for g, r in zip(ttr.ssm_to_naturals(tssm), jtr.ssm_to_naturals(jssm)):
        _close(g, r)


def test_naturals_to_ssm_params_d1_matches_jax(rng):
    jssm, _ = _random_ssm(rng)
    nats = [np.asarray(x) for x in jtr.ssm_to_naturals(jssm)]
    nats[0] = nats[0] + 0.1 * rng.normal(size=nats[0].shape)  # off the round trip
    ref = jtr.naturals_to_ssm_params(*map(jnp.asarray, nats))
    got = ttr.naturals_to_ssm_params(*map(torch.tensor, nats))
    for name, g, r in zip(["A", "b", "chol_p0", "chol_q", "mu0"], got, ref):
        _close(g, r, atol=1e-13, msg=name)


def test_marginals_d1_matches_jax(rng):
    jssm, tssm = _random_ssm(rng)
    for g, r in zip(tssm.marginals(), jssm.marginals()):
        _close(g, r)


def test_transform_girsanov_sites_matches_jax(rng):
    (j_old, t_old), (j_new, t_new) = _random_ssm(rng), _random_ssm(rng)
    sites = [rng.normal(size=s) for s in [(N + 1, 1), (N + 1, 1, 1), (N, 1, 1)]]
    ref = jsu.transform_girsanov_sites(jsu.BTDNaturals(*map(jnp.asarray, sites)), j_old, j_new)
    got = tsu.transform_girsanov_sites(tsu.BTDNaturals(*map(torch.tensor, sites)), t_old, t_new)
    for g, r in zip(got, ref):
        _close(g, r)


def test_gaussian_variational_expectations_matches_jax(rng):
    m, v, y = rng.normal(size=(50, 1)), rng.uniform(0.1, 1.0, (50, 1)), rng.normal(size=(50, 1))
    ref = JGaussianLik(variance=jnp.asarray(0.04)).variational_expectations(
        jnp.asarray(m), jnp.asarray(v), jnp.asarray(y))
    got = Gaussian(variance=0.04).variational_expectations(
        torch.tensor(m), torch.tensor(v), torch.tensor(y))
    _close(got, ref)
    with pytest.raises(ValueError, match="positive"):
        Gaussian(variance=0.0)


def test_d2_paths_raise_naming_their_slice(rng):
    nat = torch.zeros(5, 2), torch.zeros(5, 2, 2), torch.zeros(4, 2, 2)
    with pytest.raises(NotImplementedError, match="slice E"):
        ttr.naturals_to_ssm_params(*nat)
    ssm2 = StateSpaceModel(torch.zeros(2), torch.eye(2), torch.zeros(4, 2, 2),
                           torch.zeros(4, 2), torch.eye(2).expand(4, 2, 2))
    # d >= 2 marginals no longer raise: they run the generic associative scan
    means, covs = ssm2.marginals()
    assert torch.equal(means, torch.zeros(5, 2))
    assert torch.equal(covs, torch.eye(2).expand(5, 2, 2))
