"""The port's composite kernels (``kernels/composite.py``) against the JAX
package, float64.

* ``PiecewiseKernel`` (three Matern32 regimes, two change points, one of
  them on a grid point): the prior SSM to 1e-10 of each field's scale
  (``SSM_RTOL``), the emission, the state means and the steady-state
  covariances to 1e-12;
* ``StackKernel`` / ``IndependentMultiOutputStack`` of a Matern12 and a
  Matern32 (docs/examples/stacked_kernels.py): the batched prior SSM and
  the stacked emission to 1e-12, ``+`` and ``*`` pairwise, and an SVGP with
  natural gradients, three steps at γ = 0.5 (that example's step), the SSM
  after each to 1e-8, but for the inert padded entry of ``P₀``
  (``PADDED_RTOL``);
* ``FactorAnalysisKernel`` (docs/examples/factor_analysis.py: two latent
  processes, three outputs, a time-varying weight function written in both
  libraries): the composed emission to 1e-12, and three SVGP natgrad steps
  to 1e-8;
* ``kernel_from_numpy`` builds each of them from the JAX leaves.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import FactorAnalysisKernel as JFactorAnalysis
from vi_diffusion_processes_tpu.kernels import IndependentMultiOutputStack as JStack
from vi_diffusion_processes_tpu.kernels import Matern12 as JMatern12
from vi_diffusion_processes_tpu.kernels import Matern32 as JMatern32
from vi_diffusion_processes_tpu.kernels import PiecewiseKernel as JPiecewise
from vi_diffusion_processes_tpu.likelihoods import Gaussian as JGaussian
from vi_diffusion_processes_tpu.models import SparseVariationalGaussianProcess as JSVGP
from vi_diffusion_processes_tpu.optim import natgrad_step as jnatgrad_step
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.kernels import composite
from vi_diffusion_processes_tpu_torch.kernels.base import Product, Sum
from vi_diffusion_processes_tpu_torch.optim.natgrad import natgrad_step

from .helpers import SSM_FIELDS, assert_close_scaled, kernel_spec, to_np

RTOL, NATGRAD_RTOL, STEPS = 1e-12, 1e-8, 3
#: the prior SSMs' fields: ``chol Q`` of ``P∞ − A P∞ Aᵀ`` over this grid's
#: smallest gaps loses digits to cancellation, and the two packages round it
#: apart by up to 6e-11 of its scale
SSM_RTOL = 1e-10
#: the padded state of the stack's Matern12 chain (identity-padded A and P₀,
#: Q = the 1e-10 jitter) is inert, f never sees it; its posterior P₀ comes
#: out of precision blocks of order 1e10 that cancel to order 1, so float64
#: keeps 4-6 of its digits: the port and the JAX package part by up to 4.8e-5
#: there over three steps (every other entry by at most 4e-11)
PADDED_RTOL = 1e-3
GRID = np.sort(np.concatenate([np.random.default_rng(3).uniform(0, 6, 40), [2.0]]))


def _same(got, ref, rtol=RTOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref), err_msg
    assert_close_scaled(got, np.asarray(ref), rtol, err_msg=err_msg)


def _port(jkernel):
    name, leaves = kernel_spec(jkernel)
    return interop.kernel_from_numpy(name, leaves, device="cpu")


def _jax_piecewise():
    return JPiecewise(
        kernels=tuple(JMatern32(lengthscale=jnp.asarray(ls), variance=jnp.asarray(v))
                      for ls, v in ((0.5, 1.0), (1.5, 0.4), (0.8, 2.0))),
        change_points=jnp.asarray([2.0, 4.2]),
    )


def _port_piecewise(jk):
    return interop.kernel_from_numpy("PiecewiseKernel", {
        "kernels": [kernel_spec(k) for k in jk.kernels],
        "change_points": np.array(jk.change_points)}, device="cpu")


def test_piecewise_kernel_matches_jax():
    jk = _jax_piecewise()
    k = _port_piecewise(jk)
    t = torch.tensor(GRID)
    jidx, jprior, jh, jmeans, jcovs = jax.jit(lambda kk, tt: (
        kk.split_time_indices(tt), kk.state_space_model(tt),
        kk.generate_emission_model(tt).emission_matrix, kk.state_means(tt),
        kk.steady_state_covariances(tt)))(jk, jnp.asarray(GRID))
    np.testing.assert_array_equal(k.split_time_indices(t).numpy(), np.asarray(jidx))
    prior = k.state_space_model(t)
    for f in SSM_FIELDS:
        _same(getattr(prior, f), getattr(jprior, f), SSM_RTOL, err_msg=f)
    _same(k.generate_emission_model(t).emission_matrix, jh)
    _same(k.state_means(t), jmeans)
    _same(k.steady_state_covariances(t), jcovs)
    assert interop.fields_to_numpy(k) is k  # a module is returned as it is


def _jax_stack():
    """docs/examples/stacked_kernels.py:29-32."""
    return JStack(kernels=(JMatern12(lengthscale=jnp.asarray(0.6), variance=jnp.asarray(1.0)),
                           JMatern32(lengthscale=jnp.asarray(1.0), variance=jnp.asarray(1.0))))


def test_stack_kernel_matches_jax():
    jk = _jax_stack()
    k = _port(jk)
    assert isinstance(k, composite.IndependentMultiOutputStack)
    assert (k.state_dim, k.output_dim, k.num_kernels) == (2, 2, 2)
    t, jt = torch.tensor(GRID), jnp.asarray(GRID)
    prior, jprior = k.state_space_model(t), jk.state_space_model(jt)
    assert prior.batch_shape == (2,)
    for f in SSM_FIELDS:
        _same(getattr(prior, f), getattr(jprior, f), SSM_RTOL, err_msg=f)
    states = np.random.default_rng(4).normal(size=(2, len(GRID), 2))
    emission, jemission = k.generate_emission_model(t), jk.generate_emission_model(jt)
    _same(emission.project_state_to_f(torch.tensor(states)),
          jemission.project_state_to_f(jnp.asarray(states)))
    _same(k.feedback_matrix, jk.feedback_matrix)
    _same(k.steady_state_covariance, jk.steady_state_covariance)


@pytest.mark.parametrize("op", ["add", "mul"])
def test_stack_combinators_match_jax(op):
    jk = getattr(_jax_stack(), f"__{op}__")(_jax_stack())
    k = getattr(_port(_jax_stack()), f"__{op}__")(_port(_jax_stack()))
    assert all(isinstance(c, Sum if op == "add" else Product) for c in k.kernels)
    assert k.state_dim == jk.state_dim
    t, jt = torch.tensor(GRID), jnp.asarray(GRID)
    prior, jprior = k.state_space_model(t), jk.state_space_model(jt)
    for f in SSM_FIELDS:
        _same(getattr(prior, f), getattr(jprior, f), SSM_RTOL, err_msg=f)


def _jweights(t):
    """docs/examples/factor_analysis.py:28-36."""
    a = jnp.stack([jnp.ones_like(t), 0.5 * jnp.sin(t), 0.3 * t / 6.0, jnp.ones_like(t),
                   jnp.cos(t), -0.5 * jnp.ones_like(t)], axis=-1)
    return a.reshape(t.shape + (3, 2))


def _tweights(t):
    a = torch.stack([torch.ones_like(t), 0.5 * torch.sin(t), 0.3 * t / 6.0, torch.ones_like(t),
                     torch.cos(t), -0.5 * torch.ones_like(t)], dim=-1)
    return a.reshape(t.shape + (3, 2))


def _jax_factor_analysis():
    return JFactorAnalysis.create(
        weight_function=_jweights,
        kernels=(JMatern32(lengthscale=jnp.asarray(1.5), variance=jnp.asarray(1.0)),
                 JMatern12(lengthscale=jnp.asarray(0.4), variance=jnp.asarray(1.0))),
        output_dim=3,
    ).replace(loading_matrix=jnp.asarray([[1.0, 0.3], [-0.2, 0.9]]))


def _port_factor_analysis(jk):
    return interop.kernel_from_numpy("FactorAnalysisKernel", {
        "kernels": [kernel_spec(k) for k in jk.kernels],
        "loading_matrix": np.array(jk.loading_matrix), "weight_function": _tweights,
        "output_dim": 3}, device="cpu")


def test_factor_analysis_emission_matches_jax():
    jk = _jax_factor_analysis()
    k = _port_factor_analysis(jk)
    assert (k.state_dim, k.output_dim) == (3, 3)
    t, jt = torch.tensor(GRID), jnp.asarray(GRID)
    emission, jemission = k.generate_emission_model(t), jk.generate_emission_model(jt)
    _same(emission.emission_matrix, jemission.emission_matrix)
    _same(emission.inner_emission_matrix, jemission.inner_emission_matrix)
    params = interop.kernel_params_to_numpy(k)
    np.testing.assert_array_equal(params["loading_matrix"], np.asarray(jk.loading_matrix))
    created = composite.FactorAnalysisKernel.create(_tweights, list(k.kernels), 3)
    np.testing.assert_array_equal(created.loading_matrix.detach().numpy(), np.eye(2))


def _svgp_data(n, outputs, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 4, n))
    f = np.stack([np.sin((1.0 + 0.5 * j) * t) for j in range(outputs)], axis=-1)
    return t, f + 0.1 * rng.normal(size=(n, outputs))


def _jax_svgp(name):
    kernel = _jax_stack() if name == "stack" else _jax_factor_analysis()
    z = jnp.linspace(0.0, 4.0, 25 if name == "stack" else 20)
    return JSVGP.initialize(kernel, JGaussian(variance=jnp.asarray(0.01)), inducing_points=z)


@functools.lru_cache(maxsize=None)
def _jax_natgrad(name):
    model = _jax_svgp(name)
    data = tuple(jnp.asarray(x) for x in _svgp_data(40, 2 if name == "stack" else 3, 5))
    step = jax.jit(lambda q: jnatgrad_step(
        lambda qq: model.replace(dist_q=qq).loss(data), q, gamma=0.5))
    q, out = model.dist_q, []
    for _ in range(STEPS):
        q, _, loss = step(q)
        out.append(({f: np.asarray(getattr(q, f)) for f in SSM_FIELDS}, np.asarray(loss)))
    return out


@pytest.mark.parametrize("name", ["stack", "factor_analysis"])
def test_svgp_natgrad_steps_match_jax(name):
    ref = _jax_natgrad(name)
    jmodel = _jax_svgp(name)
    kernel = _port(jmodel.kernel) if name == "stack" else _port_factor_analysis(jmodel.kernel)
    lik = interop.likelihood_from_numpy(to_np(jmodel.likelihood), "cpu")
    model = interop.svgp_from_numpy(to_np(jmodel), kernel, lik, device="cpu")
    data = tuple(torch.tensor(x) for x in _svgp_data(40, 2 if name == "stack" else 3, 5))
    q = model.dist_q
    for k, (fields, loss_ref) in enumerate(ref):
        q, _, loss = natgrad_step(lambda qq: model.replace(dist_q=qq).loss(data), q, gamma=0.5)
        assert_close_scaled(loss.numpy(), loss_ref, NATGRAD_RTOL, err_msg=f"loss {k + 1}")
        for f in SSM_FIELDS:
            got, want = getattr(q, f).numpy().copy(), fields[f].copy()
            if name == "stack" and f == "chol_initial_covariance":
                _same(got[0, 1, 1], want[0, 1, 1], PADDED_RTOL, err_msg=f"padded P0, step {k + 1}")
                got[0, 1, 1] = want[0, 1, 1] = 0.0
            _same(got, want, NATGRAD_RTOL, err_msg=f"{f}, step {k + 1}")
    with torch.no_grad():
        f_mu, _ = model.replace(dist_q=q).posterior.predict_f(data[0])
    assert tuple(f_mu.shape) == tuple(data[1].shape)
