"""The small pieces under the Kalman engine against the JAX package: the
linear-algebra helpers, the shape helpers, the Gaussian likelihoods, the
emission models and the cyclic-reduction conditionals.

Inputs from numpy seeds, float64, tolerance 1e-11 of each output's scale
(closed forms and solves of well-conditioned blocks of size at most 5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu import kernels as jk
from vi_diffusion_processes_tpu.likelihoods import base as jlik_base
from vi_diffusion_processes_tpu.likelihoods import gaussian as jlik
from vi_diffusion_processes_tpu.ssm import conditionals as jcond
from vi_diffusion_processes_tpu.ssm import emission as jem
from vi_diffusion_processes_tpu.utils import linalg as jla
from vi_diffusion_processes_tpu.utils import shapes as jshapes
from vi_diffusion_processes_tpu_torch.likelihoods import base as tlik_base
from vi_diffusion_processes_tpu_torch.likelihoods import gaussian as tlik
from vi_diffusion_processes_tpu_torch.ssm import conditionals as tcond
from vi_diffusion_processes_tpu_torch.ssm import emission as tem
from vi_diffusion_processes_tpu_torch.utils import linalg as tla
from vi_diffusion_processes_tpu_torch.utils import shapes as tshapes

from .helpers import assert_close_scaled, port_kernel

A = jnp.asarray
T = torch.tensor
RTOL = 1e-11


def _same(got, ref, rtol=RTOL):
    assert tuple(got.shape) == tuple(ref.shape)
    assert_close_scaled(got.detach().numpy(), np.asarray(ref), rtol)


def _blocks(d, batch=(7,), seed=0):
    """Well-conditioned general blocks ``I + C J`` of two PSD factors, a PD
    block, and a right-hand side."""
    rng = np.random.default_rng(seed + d)
    w1, w2 = rng.normal(size=(2,) + batch + (d, d))
    c, j = w1 @ np.swapaxes(w1, -1, -2), w2 @ np.swapaxes(w2, -1, -2)
    return np.eye(d) + c @ j / d, c + np.eye(d), rng.normal(size=batch + (d, 3))


# ------------------------------------------------------------------- linalg
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_small_solves_inverses_and_logdets(d):
    a, pd, b = _blocks(d)
    _same(tla.solve_small(T(a), T(b)), np.linalg.solve(a, b))
    _same(tla.solve_small(T(a), T(b)), jla.solve_small(A(a), A(b)), 1e-10)
    _same(tla.inv_small(T(a)), np.linalg.inv(a))
    _same(tla.logdet_pos(T(a)), np.linalg.slogdet(a)[1])
    _same(tla.logdet_pos(T(a)), jla.logdet_pos(A(a)))
    _same(tla.solve_psd(T(pd), T(b)), jla.solve_psd(A(pd), A(b)))
    chol = np.linalg.cholesky(pd)
    _same(tla.solve_psd(T(pd), T(b), chol=T(chol)), np.linalg.solve(pd, b))
    _same(tla.chol_psd(T(pd)), chol)
    _same(tla.symmetrize(T(a)), jla.symmetrize(A(a)))
    _same(tla.matmul_small(T(a), T(b)), a @ b)
    _same(tla.matvec_small(T(a), T(b[..., 0])), jla.matvec_small(A(a), A(b[..., 0])))
    x, mean = b[..., 0], b[..., 1]
    _same(tla.mvn_logpdf(T(x), T(mean), T(chol)), jla.mvn_logpdf(A(x), A(mean), A(chol)))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_small_solves_are_differentiable(d):
    a, _, b = _blocks(d, batch=(2,))
    ta, tb = T(a, requires_grad=True), T(b, requires_grad=True)
    assert torch.autograd.gradcheck(tla.solve_small, (ta, tb))
    assert torch.autograd.gradcheck(tla.inv_small, (ta,))
    assert torch.autograd.gradcheck(tla.logdet_pos, (ta,))


def test_cholesky_of_a_non_pd_block_gives_nans_and_raises_nothing():
    """As ``jnp.linalg.cholesky``: no status flag is read back to the host."""
    good, bad = np.array([[2.0, 0.5], [0.5, 1.0]]), np.array([[1.0, 2.0], [2.0, 1.0]])
    out = tla.chol_psd(T(np.stack([good, bad])))
    np.testing.assert_allclose(out[0].numpy(), np.linalg.cholesky(good), rtol=1e-14)
    assert bool(torch.isnan(out[1]).all())
    assert bool(jnp.isnan(jla.chol_psd(A(bad))).any())


def test_block_diag_and_kron():
    rng = np.random.default_rng(2)
    mats = [rng.normal(size=(4, d, d)) for d in (1, 2, 3)]
    _same(tla.block_diag([T(m) for m in mats]), jla.block_diag([A(m) for m in mats]))
    assert tla.block_diag([T(mats[1])]).shape == (4, 2, 2)
    tall = [rng.normal(size=(4, 1, 2)), rng.normal(size=(4, 1, 3))]  # emission blocks
    _same(tla.block_diag([T(m) for m in tall]), jla.block_diag([A(m) for m in tall]))
    a, b = rng.normal(size=(4, 2, 3)), rng.normal(size=(4, 3, 2))
    _same(tla.kron(T(a), T(b)), jla.kron(A(a), A(b)))
    np.testing.assert_allclose(tla.kron(T(a[0]), T(b[0])).numpy(), np.kron(a[0], b[0]))


def test_shape_helpers():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(2, 3, 3))
    _same(tshapes.augment_matrix(T(m), 2), jshapes.augment_matrix(A(m), 2))
    assert tshapes.augment_matrix(T(m), 0).shape == (2, 3, 3)
    for fill in (False, True):
        _same(tshapes.augment_square_matrix(T(m), 2, fill_zeros=fill),
              jshapes.augment_square_matrix(A(m), 2, fill_zeros=fill))
    assert tshapes.augment_square_matrix(T(m), 0).shape == (2, 3, 3)
    grid = np.array([0.0, 0.5, 0.5, 2.0])
    _same(tshapes.to_delta_time(T(grid)), jshapes.to_delta_time(A(grid)))
    with pytest.raises(ValueError):
        tshapes.to_delta_time(T(grid[::-1].copy()))


# -------------------------------------------------------------- likelihoods
def _f_y(m=2, n=9, seed=4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, m)), rng.uniform(0.1, 0.8, size=(n, m)), rng.normal(size=(n, m))


def test_gaussian_likelihood():
    f, v, y = _f_y()
    jl, tl = jlik.Gaussian(variance=A(0.3)), tlik.Gaussian(0.3)
    for name, args in (("log_probability_density", (f, y)), ("variational_expectations", (f, v, y)),
                       ("predict_density", (f, v, y)), ("conditional_mean", (f,)),
                       ("conditional_variance", (f,)), ("_elementwise_log_prob", (f, y))):
        _same(getattr(tl, name)(*map(T, args)), getattr(jl, name)(*map(A, args)))
    for got, ref in zip(tl.predict_mean_and_var(T(f), T(v)), jl.predict_mean_and_var(A(f), A(v))):
        _same(got, ref)
    with pytest.raises(ValueError):
        tlik.Gaussian(-1.0)


def test_default_variational_expectations_by_gauss_hermite():
    """A likelihood that gives only its elementwise log-density inherits the
    20-point Gauss–Hermite default, exact here for the quadratic."""
    f, v, y = _f_y()

    class OnlyElementwise(tlik_base.Likelihood):
        def _elementwise_log_prob(self, ff, yy):
            return tlik.Gaussian._elementwise_log_prob(closed, ff, yy)

    class JOnlyElementwise(jlik_base.Likelihood):
        def _elementwise_log_prob(self, ff, yy):
            return jlik.Gaussian(variance=A(0.3))._elementwise_log_prob(ff, yy)

    closed = tlik.Gaussian(0.3)
    got = OnlyElementwise().variational_expectations(T(f), T(v), T(y))
    _same(got, JOnlyElementwise().variational_expectations(A(f), A(v), A(y)))
    _same(got, closed.variational_expectations(T(f), T(v), T(y)).detach())
    cube = tlik_base.quad_expectation(lambda x: x**3, T(f), T(v))
    _same(cube, jlik_base.quad_expectation(lambda x: x**3, A(f), A(v)))
    _same(cube, f**3 + 3 * f * v)
    for method, args in (("log_probability_density", (T(f), T(y))),
                         ("_elementwise_log_prob", (T(f), T(y)))):
        with pytest.raises(NotImplementedError):
            getattr(tlik_base.Likelihood(), method)(*args)


def test_multivariate_gaussian_likelihood():
    f, v, y = _f_y()
    rng = np.random.default_rng(5)
    w = rng.normal(size=(9, 2, 2))
    full = w @ np.swapaxes(w, -1, -2) + 0.1 * np.eye(2)
    chol = np.array([[0.5, 0.0], [0.2, 0.7]])
    jl, tl = jlik.MultivariateGaussian(chol_covariance=A(chol)), tlik.MultivariateGaussian(chol)
    assert tl.output_dim == 2 and isinstance(tl.chol_covariance, torch.nn.Parameter)
    _same(tl.log_probability_density(T(f), T(y)), jl.log_probability_density(A(f), A(y)))
    for s in (v, full):  # marginal variances, then full output covariances
        _same(tl.variational_expectations(T(f), T(s), T(y)),
              jl.variational_expectations(A(f), A(s), A(y)))
        _same(tl.predict_density(T(f), T(s), T(y)), jl.predict_density(A(f), A(s), A(y)))
        for got, ref in zip(tl.predict_mean_and_var(T(f), T(s)),
                            jl.predict_mean_and_var(A(f), A(s))):
            _same(got, ref)
    # a factor that carries a gradient is kept as it is
    noise = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    kept = tlik.MultivariateGaussian(noise[None, None])
    kept.predict_mean_and_var(T(f[:, :1]), T(v[:, :1]))[1].sum().backward()
    assert float(noise.grad) == pytest.approx(2 * 0.3 * 9)


# ----------------------------------------------------------------- emission
def test_emission_models():
    rng = np.random.default_rng(6)
    h, x = rng.normal(size=(3, 8, 2, 4)), rng.normal(size=(3, 8, 4))
    w = rng.normal(size=(3, 8, 4, 4))
    cov = w @ np.swapaxes(w, -1, -2)
    je, te = jem.EmissionModel(A(h)), tem.EmissionModel(T(h))
    assert (te.output_dim, te.state_dim, te.batch_shape) == (2, 4, (3,))
    _same(te.project_state_to_f(T(x)), je.project_state_to_f(A(x)))
    for full in (False, True):
        _same(te.project_state_covariance_to_f(T(cov), full),
              je.project_state_covariance_to_f(A(cov), full))
        for got, ref in zip(te.project_state_marginals_to_f(T(x), T(cov), full),
                            je.project_state_marginals_to_f(A(x), A(cov), full)):
            _same(got, ref)
    inner = rng.normal(size=(3, 8, 3, 4))
    jc = jem.ComposedPairEmissionModel(A(h), inner_emission_matrix=A(inner))
    tc = tem.ComposedPairEmissionModel(T(h), inner_emission_matrix=T(inner))
    _same(tc.project_state_to_inner(T(x)), jc.project_state_to_inner(A(x)))
    _same(tc.project_state_to_f(T(x)), jc.project_state_to_f(A(x)))
    hs = rng.normal(size=(3, 8, 1, 4))  # a stack of 3 single-output emissions
    js, ts = jem.StackEmissionModel(A(hs)), tem.StackEmissionModel(T(hs))
    _same(ts.project_state_to_f(T(x)), js.project_state_to_f(A(x)))
    for full in (False, True):
        _same(ts.project_state_covariance_to_f(T(cov), full),
              js.project_state_covariance_to_f(A(cov), full))


# ------------------------------------------------------------- conditionals
def test_cyclic_reduction_conditional_statistics():
    rng = np.random.default_rng(7)
    grid = np.cumsum(rng.uniform(0.1, 0.4, size=21))
    explained, conditioning = grid[0::2], grid[1::2]
    jkernel = jk.Matern32(lengthscale=A(1.5), variance=A(0.8))
    ref = jcond.cyclic_reduction_conditional_statistics(A(explained), A(conditioning), jkernel)
    got = tcond.cyclic_reduction_conditional_statistics(
        T(explained), T(conditioning), port_kernel(jkernel))
    for g, r in zip(got, ref):
        _same(g, r, 1e-8)


def test_base_conditional_predict_without_covariances():
    rng = np.random.default_rng(8)
    p, t, m = rng.normal(size=(5, 2, 4)), rng.normal(size=(5, 2, 2)), rng.normal(size=(5, 4))
    means, covs = tcond.base_conditional_predict(T(p), T(t), T(m))
    j_means, j_covs = jcond.base_conditional_predict(A(p), A(t), A(m))
    _same(means, j_means)
    _same(covs, j_covs)
