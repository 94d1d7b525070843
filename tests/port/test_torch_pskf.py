"""The port's parallel Kalman engine against the JAX package's dense route.

Priors at d = 1, 2 and 4 (Matern12, Matern32, Matern52 + Matern12) on an
uneven grid of 60 points, below the JAX package's channelized threshold, so
both sides run the same maths in the same association order.  Sites are
random information-form potentials at two thirds of the points and exactly
zero precision at the rest, as a sparse model leaves them.  float64; the
tolerance is 1e-9 of each output's scale (the compose inverts
``I + C J`` in closed form here and by a solve there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu import kernels as jk
from vi_diffusion_processes_tpu.parallel import kalman as jkal
from vi_diffusion_processes_tpu.parallel import pskf as jpskf
from vi_diffusion_processes_tpu.parallel import sites as jsites
from vi_diffusion_processes_tpu_torch.parallel import kalman as tkal
from vi_diffusion_processes_tpu_torch.parallel import pskf as tpskf
from vi_diffusion_processes_tpu_torch.parallel import sites as tsites
from vi_diffusion_processes_tpu_torch.ssm.emission import EmissionModel

from .helpers import assert_close_scaled, assert_ssm_close, port_kernel, port_ssm, uneven_grid

A = jnp.asarray
N = 60
RTOL = 1e-9
KERNELS = {
    1: lambda: jk.Matern12(lengthscale=A(1.3), variance=A(0.7)),
    2: lambda: jk.Matern32(lengthscale=A(1.7), variance=A(0.6), state_mean=A([0.3, -0.2])),
    4: lambda: jk.Matern52(lengthscale=A(1.0), variance=A(1.0))
    + jk.Matern12(lengthscale=A(2.0), variance=A(0.5)),
}


@functools.lru_cache(maxsize=None)
def _case(d):
    """(JAX kernel, grid, JAX prior SSM, nat1, nat2_prec) with zero sites at
    every third point."""
    rng = np.random.default_rng(10 + d)
    grid = uneven_grid(rng, N)
    jkernel = KERNELS[d]()
    jssm = jkernel.state_space_model(A(grid))
    w = rng.normal(size=(N, d, d))
    prec = w @ np.swapaxes(w, -1, -2) + 0.1 * np.eye(d)
    nat1 = rng.normal(size=(N, d))
    prec[::3] = 0.0
    nat1[::3] = 0.0
    return jkernel, grid, jssm, nat1, prec


def _same(got, ref, msg=""):
    assert tuple(got.shape) == ref.shape, msg
    assert_close_scaled(got.detach().numpy(), np.asarray(ref), RTOL, err_msg=msg)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_filter_smoother_normalizer_and_posterior(d):
    _, _, jssm, nat1, prec = _case(d)
    tssm = port_ssm(jssm)
    j_filt, j_smooth = jax.jit(jpskf.filter_smoother_with_sites)(jssm, A(nat1), A(prec))
    t1, t2 = torch.tensor(nat1), torch.tensor(prec)
    filt, smooth = tpskf.filter_smoother_with_sites(tssm, t1, t2)
    for f in jpskf.FilterResult._fields:
        _same(getattr(filt, f), getattr(j_filt, f), f"filter {f}")
    for f in jpskf.SmootherResult._fields:
        _same(getattr(smooth, f), getattr(j_smooth, f), f"smoother {f}")
    # the two halves on their own
    alone = tpskf.parallel_filter(tssm, t1, t2)
    assert all(torch.equal(a, b) for a, b in zip(alone, filt))
    assert all(torch.equal(a, b) for a, b in zip(tpskf.parallel_smoother(tssm, alone), smooth))

    j_logz = jax.jit(jpskf.site_log_normalizer)(j_filt, A(nat1), A(prec))
    np.testing.assert_allclose(float(tpskf.site_log_normalizer(filt, t1, t2)), float(j_logz),
                               rtol=RTOL)
    # jitter-free by default; the covariances L Lᵀ to 1e-9, the factors of the
    # tiny posterior Q (order Δt³) to 1e-6
    j_post = jax.jit(jpskf.posterior_ssm_from_smoothed)(jssm, j_smooth)
    post = tpskf.posterior_ssm_from_smoothed(tssm, smooth)
    assert_ssm_close(post, j_post, 1e-6)
    for f in ("initial_mean", "state_transitions", "state_offsets", "process_covariances"):
        _same(getattr(post, f), getattr(j_post, f), f"posterior {f}")
    # the posterior SSM's marginals are the smoothed ones
    means, covs = post.marginals()
    assert_close_scaled(means.numpy(), smooth.means.numpy(), 1e-8)
    assert_close_scaled(covs.numpy(), smooth.covs.numpy(), 1e-8)


def test_filter_takes_a_batch_of_chains():
    """Two chains at d = 2, stacked, against each on its own."""
    _, _, jssm, nat1, prec = _case(2)
    tssm = port_ssm(jssm)
    rng = np.random.default_rng(3)
    nat1_b = np.stack([nat1, nat1 + 0.1 * rng.normal(size=nat1.shape)])
    prec_b = np.stack([prec, 0.5 * prec])
    batched = type(tssm)(*(torch.stack([getattr(tssm, f.name)] * 2)
                           for f in tssm.__dataclass_fields__.values()))
    filt, smooth = tpskf.filter_smoother_with_sites(
        batched, torch.tensor(nat1_b), torch.tensor(prec_b))
    logz = tpskf.site_log_normalizer(filt, torch.tensor(nat1_b), torch.tensor(prec_b))
    assert tuple(logz.shape) == (2,)
    for row in range(2):
        t1, t2 = torch.tensor(nat1_b[row]), torch.tensor(prec_b[row])
        f1, s1 = tpskf.filter_smoother_with_sites(tssm, t1, t2)
        assert_close_scaled(smooth.means[row].numpy(), s1.means.numpy(), 1e-12)
        assert_close_scaled(smooth.covs[row].numpy(), s1.covs.numpy(), 1e-12)
        np.testing.assert_allclose(float(logz[row]),
                                   float(tpskf.site_log_normalizer(f1, t1, t2)), rtol=1e-12)


def test_dense_filter_against_the_channelized_route():
    """N = 4,100 at d = 2 is past the JAX package's channelized threshold
    (4,096): there the reference runs its scalar-channel layout of the same
    maths, the port its one dense route.  Forward only, 1e-9 of the scale."""
    n, d = 4100, 2
    rng = np.random.default_rng(17)
    grid = uneven_grid(rng, n, t1=400.0)
    jssm = KERNELS[2]().state_space_model(A(grid))
    w = rng.normal(size=(n, d, d))
    prec = w @ np.swapaxes(w, -1, -2) + 0.1 * np.eye(d)
    nat1 = rng.normal(size=(n, d))
    prec[::3] = 0.0
    nat1[::3] = 0.0
    assert jpskf._ch_eligible(jssm, A(nat1))
    j_filt = jax.jit(jpskf.parallel_filter)(jssm, A(nat1), A(prec))
    t1, t2 = torch.tensor(nat1), torch.tensor(prec)
    filt = tpskf.parallel_filter(port_ssm(jssm), t1, t2)
    for f in jpskf.FilterResult._fields:
        _same(getattr(filt, f), getattr(j_filt, f), f"filter {f}")
    np.testing.assert_allclose(
        float(tpskf.site_log_normalizer(filt, t1, t2)),
        float(jpskf.site_log_normalizer(j_filt, A(nat1), A(prec))), rtol=RTOL)


def _observations(d, m=1):
    rng = np.random.default_rng(20 + d)
    return rng.normal(size=(N, m)), np.array([[0.4]])


@pytest.mark.parametrize("d", [1, 2, 4])
def test_kalman_filter(d):
    jkernel, grid, jssm, _, _ = _case(d)
    y, chol_r = _observations(d)
    j_em = jkernel.generate_emission_model(A(grid))
    jkf = jkal.KalmanFilter(jssm, j_em, A(y), A(chol_r))
    tkf = tkal.KalmanFilter(port_ssm(jssm), EmissionModel(torch.tensor(np.asarray(
        j_em.emission_matrix))), torch.tensor(y), torch.tensor(chol_r))
    np.testing.assert_allclose(float(tkf.log_likelihood()),
                               float(jax.jit(lambda k: k.log_likelihood())(jkf)), rtol=RTOL)
    j_post = jax.jit(lambda k: k.posterior_state_space_model())(jkf)
    post = tkf.posterior_state_space_model()
    assert_ssm_close(post, j_post, 1e-6)
    j_means, j_covs = j_post.marginals()
    means, covs = post.marginals()
    assert_close_scaled(means.numpy(), np.asarray(j_means), RTOL)
    assert_close_scaled(covs.numpy(), np.asarray(j_covs), RTOL)


def _f_sites(rng, n, m=1):
    w = rng.normal(size=(n, m, m))
    nat2 = -0.5 * (w @ np.swapaxes(w, -1, -2) + 0.2 * np.eye(m))
    return rng.normal(size=(n, m)), nat2


@pytest.mark.parametrize("d", [1, 2, 4])
def test_kalman_filter_with_sites_and_sites_log_likelihood(d):
    jkernel, grid, jssm, _, _ = _case(d)
    nat1, nat2 = _f_sites(np.random.default_rng(30 + d), N)
    j_em = jkernel.generate_emission_model(A(grid))
    t_em = port_kernel(jkernel).generate_emission_model(torch.tensor(grid))
    j_s = jsites.GaussianSites(A(nat1), A(nat2))
    t_s = tsites.GaussianSites(torch.tensor(nat1), torch.tensor(nat2))
    jkf = jkal.KalmanFilterWithSites(jssm, j_em, j_s)
    tkf = tkal.KalmanFilterWithSites(port_ssm(jssm), t_em, t_s)
    ref = float(jax.jit(lambda k: k.log_likelihood())(jkf))
    np.testing.assert_allclose(float(tkf.log_likelihood()), ref, rtol=RTOL)
    np.testing.assert_allclose(
        float(tsites.sites_log_likelihood(port_ssm(jssm), t_s, t_em)), ref, rtol=RTOL)
    for got, want in zip(tsites.back_project_nats(t_s, t_em.emission_matrix),
                         jsites.back_project_nats(j_s, j_em.emission_matrix)):
        _same(got, want)
    j_means, j_covs = jax.jit(lambda k: k.posterior_state_space_model().marginals())(jkf)
    means, covs = tkf.posterior_state_space_model().marginals()
    assert_close_scaled(means.numpy(), np.asarray(j_means), RTOL)
    assert_close_scaled(covs.numpy(), np.asarray(j_covs), RTOL)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_kalman_filter_with_sparse_sites(d):
    jkernel, grid, jssm, _, _ = _case(d)
    obs_idx = np.arange(2, N, 5)
    nat1, nat2 = _f_sites(np.random.default_rng(40 + d), len(obs_idx))
    j_em = jkernel.generate_emission_model(A(grid))
    t_em = port_kernel(jkernel).generate_emission_model(torch.tensor(grid))
    jkf = jkal.KalmanFilterWithSparseSites(
        jssm, j_em, jsites.GaussianSites(A(nat1), A(nat2)), A(obs_idx))
    tkf = tkal.KalmanFilterWithSparseSites(
        port_ssm(jssm), t_em, tsites.GaussianSites(torch.tensor(nat1), torch.tensor(nat2)),
        torch.tensor(obs_idx))
    np.testing.assert_allclose(float(tkf.log_likelihood()),
                               float(jax.jit(lambda k: k.log_likelihood())(jkf)), rtol=RTOL)
    j_means, j_covs = jax.jit(lambda k: k.posterior_state_space_model().marginals())(jkf)
    means, covs = tkf.posterior_state_space_model().marginals()
    assert_close_scaled(means.numpy(), np.asarray(j_means), RTOL)
    assert_close_scaled(covs.numpy(), np.asarray(j_covs), RTOL)


def test_gaussian_observation_sites_and_zero_sites():
    jkernel, grid, _, _, _ = _case(4)
    rng = np.random.default_rng(6)
    y = rng.normal(size=(N, 2))
    chol_r = np.array([[0.5, 0.0], [0.2, 0.7]])
    h = rng.normal(size=(N, 2, 4))
    ref = jsites.gaussian_observation_sites(A(h), A(chol_r), A(y))
    got = tsites.gaussian_observation_sites(torch.tensor(h), torch.tensor(chol_r), torch.tensor(y))
    for g, r in zip(got, ref):
        _same(g, r)
    zeros = tsites.GaussianSites.zeros_like_observations(torch.tensor(y))
    j_zeros = jsites.GaussianSites.zeros_like_observations(A(y))
    _same(zeros.nat1, j_zeros.nat1)
    _same(zeros.nat2, j_zeros.nat2)


def test_log_likelihood_is_differentiable_in_the_sites():
    _, _, jssm, nat1, prec = _case(2)
    tssm = port_ssm(jssm)
    t1 = torch.tensor(nat1[:8], requires_grad=True)
    small = type(tssm)(tssm.initial_mean, tssm.chol_initial_covariance,
                       tssm.state_transitions[:7], tssm.state_offsets[:7],
                       tssm.chol_process_covariances[:7])
    t2 = torch.tensor(prec[:8])
    assert torch.autograd.gradcheck(
        lambda th: tpskf.site_log_normalizer(tpskf.parallel_filter(small, th, t2), th, t2), (t1,))
