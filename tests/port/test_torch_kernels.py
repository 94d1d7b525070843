"""Every ported kernel class, the combinators and the mean functions against
the JAX package, on an uneven grid drawn from a numpy seed.

The kernels are closed forms evaluated in float64 on both sides, so the
tolerance is 1e-12 of each output's scale; LEG's matrix exponential is a
Padé approximant of a different order on each side and gets 1e-10.  The
Cholesky factors inside ``state_space_model`` amplify rounding by the
condition of ``Q`` (a Matern52 ``Q`` over the smallest gaps is singular but
for the 1e-10 jitter), so the SSM is held by its covariances ``L Lᵀ`` at
1e-11 and by its factors at 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu import kernels as jk
from vi_diffusion_processes_tpu.ssm import mean_functions as jmf
from vi_diffusion_processes_tpu_torch.kernels import base as tk_base
from vi_diffusion_processes_tpu_torch.kernels import matern as tk_matern
from vi_diffusion_processes_tpu_torch.kernels import misc as tk_misc
from vi_diffusion_processes_tpu_torch.ssm import mean_functions as tmf

from .helpers import assert_close_scaled, assert_ssm_close, port_kernel, uneven_grid

A = jnp.asarray
_RNG = np.random.default_rng(0)
GRID = uneven_grid(_RNG, 40)
_LEG_N = 0.6 * _RNG.normal(size=(3, 3))
_LEG_R = 0.4 * _RNG.normal(size=(3, 3))

KERNELS = {
    "Matern12": lambda: jk.Matern12(lengthscale=A(1.3), variance=A(0.7)),
    "Matern12-mean": lambda: jk.Matern12(lengthscale=A(1.3), variance=A(0.7),
                                         state_mean=A([0.4])),
    "OrnsteinUhlenbeck": lambda: jk.OrnsteinUhlenbeck(decay=A(0.8), diffusion=A(1.4)),
    "Matern32": lambda: jk.Matern32(lengthscale=A(1.7), variance=A(0.6)),
    "Matern32-mean": lambda: jk.Matern32(lengthscale=A(1.7), variance=A(0.6),
                                         state_mean=A([0.3, -0.2])),
    "Matern52": lambda: jk.Matern52(lengthscale=A(2.1), variance=A(1.2)),
    "Constant": lambda: jk.Constant(variance=A(0.9)),
    "HarmonicOscillator": lambda: jk.HarmonicOscillator(variance=A(0.5), period=A(3.0)),
    "LEG": lambda: jk.LatentExponentiallyGenerated(N=A(_LEG_N), R=A(_LEG_R)),
    "Sum": lambda: jk.Matern52(lengthscale=A(1.0), variance=A(1.0))
    + jk.Matern12(lengthscale=A(2.0), variance=A(0.5)),
    "Sum-with-deterministic": lambda: jk.Sum(kernels=(
        jk.Matern32(lengthscale=A(1.5), variance=A(0.8)), jk.Constant(variance=A(0.4)),
        jk.HarmonicOscillator(variance=A(0.3), period=A(2.5)))),
    "Product": lambda: jk.Matern32(lengthscale=A(1.5), variance=A(0.8))
    * jk.Matern12(lengthscale=A(2.0), variance=A(0.5)),
    "IndependentMultiOutput": lambda: jk.IndependentMultiOutput(kernels=(
        jk.Matern32(lengthscale=A(1.5), variance=A(0.8)),
        jk.Matern12(lengthscale=A(2.0), variance=A(0.5)))),
}


def _assert_ssm(tssm, jssm):
    assert_ssm_close(tssm, jssm, 1e-6)
    for f in ("initial_mean", "state_transitions", "state_offsets", "initial_covariance",
              "process_covariances"):
        assert_close_scaled(getattr(tssm, f).detach().numpy(), np.asarray(getattr(jssm, f)),
                            1e-11, err_msg=f)


def _rtol(name):
    return 1e-10 if name == "LEG" else 1e-12


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_matches_jax(name):
    jkernel = KERNELS[name]()
    kernel = port_kernel(jkernel)
    rtol = _rtol(name)
    assert kernel.state_dim == jkernel.state_dim and kernel.output_dim == jkernel.output_dim
    t, jt = torch.tensor(GRID), A(GRID)

    def same(got, ref, tol=rtol, msg=""):
        assert tuple(got.shape) == ref.shape, msg
        assert_close_scaled(got.detach().numpy(), np.asarray(ref), tol, err_msg=msg)

    same(kernel.steady_state_covariance, jkernel.steady_state_covariance)
    if name == "Product":  # has none on either side
        for k in (kernel, jkernel):
            with pytest.raises(NotImplementedError):
                k.feedback_matrix
    else:
        same(kernel.feedback_matrix, jkernel.feedback_matrix)
    same(kernel.initial_mean((2,)), jkernel.initial_mean((2,)))
    same(kernel.initial_covariance(t[:1]), jkernel.initial_covariance(jt[:1]))
    got = kernel.transition_statistics(t[:-1], t[1:] - t[:-1])
    ref = jkernel.transition_statistics(jt[:-1], jt[1:] - jt[:-1])
    same(got[0], ref[0], msg="A")
    same(got[1], ref[1], msg="Q")
    same(kernel.state_transitions(t[:-1], t[1:] - t[:-1]), ref[0])
    same(kernel.process_covariances(t[:-1], t[1:] - t[:-1]), ref[1])
    same(kernel.state_offsets(t[:-1], t[1:] - t[:-1]),
         jkernel.state_offsets(jt[:-1], jt[1:] - jt[:-1]))
    same(kernel.generate_emission_model(t).emission_matrix,
         jkernel.generate_emission_model(jt).emission_matrix)
    _assert_ssm(kernel.state_space_model(t), jkernel.state_space_model(jt))
    _assert_ssm(kernel.build_finite_distribution(t), jkernel.state_space_model(jt))


def test_a_batched_grid_gives_a_batched_ssm():
    jkernel = KERNELS["Matern32-mean"]()
    grids = np.stack([GRID, GRID * 0.5 + 1.0])
    jssm = jkernel.state_space_model(A(grids))
    tssm = port_kernel(jkernel).state_space_model(torch.tensor(grids))
    assert tssm.batch_shape == (2,)
    _assert_ssm(tssm, jssm)


def test_kernels_are_modules_with_parameters():
    kernel = tk_matern.Matern52(1.0, 1.0) + tk_matern.Matern12(2.0, 0.5)
    assert isinstance(kernel, tk_base.Sum) and kernel.state_dim == 4
    assert sorted(n for n, _ in kernel.named_parameters()) == [
        "kernels.0.lengthscale", "kernels.0.variance",
        "kernels.1.lengthscale", "kernels.1.variance"]
    product = tk_matern.Matern32(1.0, 1.0) * tk_misc.Constant(0.5)
    assert isinstance(product, tk_base.Product) and product.state_dim == 2
    # the SSM reads the parameters at call time and is differentiable in them
    t = torch.tensor(GRID)
    ssm = kernel.state_space_model(t)
    ssm.chol_process_covariances.sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad)) for p in kernel.parameters())
    with torch.no_grad():
        kernel.kernels[0].lengthscale.mul_(2.0)
    assert not torch.equal(kernel.state_space_model(t).state_transitions, ssm.state_transitions)


@pytest.mark.parametrize("cls,kwargs", [
    (tk_matern.Matern12, dict(lengthscale=-1.0, variance=1.0)),
    (tk_matern.Matern32, dict(lengthscale=1.0, variance=0.0)),
    (tk_matern.Matern52, dict(lengthscale=0.0, variance=1.0)),
    (tk_matern.OrnsteinUhlenbeck, dict(decay=-0.5, diffusion=1.0)),
    (tk_misc.Constant, dict(variance=-1.0)),
    (tk_misc.HarmonicOscillator, dict(variance=1.0, period=0.0)),
], ids=lambda x: getattr(x, "__name__", ""))
def test_non_positive_hyperparameters_raise(cls, kwargs):
    with pytest.raises(ValueError, match="must be positive"):
        cls(**kwargs)


@pytest.mark.parametrize("name", ["Matern32", "Matern52", "Sum", "Product"])
def test_float32_grid_of_small_steps_gives_a_positive_definite_q(name):
    """At Δt = 1e-3 ``Q = P∞ − A P∞ Aᵀ`` is of order Δt³ (Matern32) or Δt⁵
    (Matern52) under terms of order 1: taken in float32 it comes out
    indefinite.  The port takes it in float64 and rounds: the float32 SSM is
    finite and its ``Q`` is the float64 one to float32 rounding."""
    kernel = port_kernel(KERNELS[name]())
    t64 = torch.linspace(0.0, 1.0, 1001, dtype=torch.float64)
    ssm32, ssm64 = kernel.state_space_model(t64.float()), kernel.state_space_model(t64)
    assert ssm32.state_transitions.dtype == torch.float32
    assert bool(torch.isfinite(ssm32.chol_process_covariances).all())
    a, q = kernel.transition_statistics(t64[:-1].float(), (t64[1:] - t64[:-1]).float())
    a64, q64 = kernel.transition_statistics(t64[:-1], t64[1:] - t64[:-1])
    assert q.dtype == torch.float32 and a.dtype == torch.float32
    # entry by entry: each entry of Q is a float32 rounding of the float64 one
    # (the float32 grid's own steps differ from 1e-3 by 1e-4 relative), down to
    # float64's own cancellation floor of a few 1e-16, far under the jitter
    np.testing.assert_allclose(q.detach().numpy(), q64.detach().numpy(), rtol=2e-3, atol=2e-15)
    jitter = 1e-10 * torch.eye(kernel.state_dim, dtype=torch.float64)
    assert bool((torch.linalg.eigvalsh(q.double().detach() + jitter) > 0).all())


def test_an_unsorted_grid_raises():
    with pytest.raises(ValueError, match="non-decreasing"):
        tk_matern.Matern32(1.0, 1.0).state_space_model(torch.tensor([0.0, 2.0, 1.0]))


# ----------------------------------------------------------- mean functions
NEW_T = np.sort(np.concatenate([np.random.default_rng(4).uniform(-1.0, 11.0, size=15),
                                [2.0, 5.5]]))
ACTIONS = np.array([2.0, 5.5, 8.0])


def _mean_functions(name):
    jkernel = KERNELS["Matern32"]()
    kernel = port_kernel(jkernel)
    rng = np.random.default_rng(8)
    jumps = rng.normal(size=(3, 2))
    if name == "zero":
        return jmf.ZeroMeanFunction(obs_dim=2), tmf.ZeroMeanFunction(obs_dim=2)
    if name == "linear":
        return (jmf.LinearMeanFunction(coefficient=A(0.7), obs_dim=1),
                tmf.LinearMeanFunction(coefficient=torch.tensor(0.7, dtype=torch.float64)))
    if name == "impulse":
        return (jmf.ImpulseMeanFunction(A(ACTIONS), A(jumps), kernel=jkernel),
                tmf.ImpulseMeanFunction(torch.tensor(ACTIONS), torch.tensor(jumps), kernel=kernel))
    return (jmf.StepMeanFunction(A(ACTIONS), A(jumps), kernel=jkernel),
            tmf.StepMeanFunction(torch.tensor(ACTIONS), torch.tensor(jumps), kernel=kernel))


@pytest.mark.parametrize("name", ["zero", "linear", "impulse", "step"])
def test_mean_function_matches_jax(name):
    jfn, tfn = _mean_functions(name)
    ref = jfn(A(NEW_T))
    got = tfn(torch.tensor(NEW_T))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def test_base_mean_function_is_abstract():
    with pytest.raises(NotImplementedError):
        tmf.MeanFunction()(torch.zeros(3))
