"""The port's packed CVI step (``models/cvi_packed.py``) against its generic
step and against the JAX package's jitted ``packed_site_step``.

The cases of ``cvi_cases.py`` (n = 64, lr 0.3).  In float64: the marginals
of ``pack_cvi`` and three packed steps against three ``update_sites`` to
1e-8 of their scale (the ELBO of the unpacked model to 1e-10), and the same
steps against the JAX package's from the same state to 1e-8.  In float32
(float64 naturals, float32 marginals: K3's dtype boundary at d = 1 and the
flagship's) to the JAX package's own test's tolerances
(tests/unit/test_cvi_packed.py:94-99): 2e-4 for the sites, 2e-3 for the
marginals.  The JAX state is built from the port's: the JAX ``pack_cvi``
compiles op by op when it is not jitted, and when it is, its emission guard
is traced away; the port's guard has its own tests, and the state converter
of ``interop`` a round trip.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.models.cvi_packed import PackedCVIGPState as JState
from vi_diffusion_processes_tpu.models.cvi_packed import packed_site_step as j_packed_site_step
from vi_diffusion_processes_tpu_torch import config, interop
from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32
from vi_diffusion_processes_tpu_torch.likelihoods.discrete import Poisson
from vi_diffusion_processes_tpu_torch.models.cvi import CVIGaussianProcess
from vi_diffusion_processes_tpu_torch.models.cvi_packed import (
    pack_cvi,
    packed_site_step,
    unpack_cvi,
)
from vi_diffusion_processes_tpu_torch.ssm.emission import EmissionModel
from vi_diffusion_processes_tpu_torch.ssm.mean_functions import LinearMeanFunction

from .cvi_cases import CASES, STEPS, jax_cvi, port_cvi
from .helpers import assert_close_scaled, to_np

RTOL = 1e-8


@pytest.mark.parametrize("name", list(CASES))
def test_packed_steps_match_the_generic_steps(name):
    model = port_cvi(jax_cvi(name))
    state = pack_cvi(model)
    with torch.no_grad():
        f_mu, f_var = model.posterior_marginals_f()
    assert_close_scaled(state.fx_mu.numpy(), f_mu[:, 0].numpy(), RTOL, err_msg="pack fx_mu")
    assert_close_scaled(state.fx_var.numpy(), f_var[:, 0].numpy(), RTOL, err_msg="pack fx_var")
    generic = model
    for _ in range(STEPS):
        generic = generic.update_sites()
        state = packed_site_step(model, state)
    with torch.no_grad():
        f_mu, f_var = generic.posterior_marginals_f()
        restored_elbo = float(unpack_cvi(model, state).elbo())
        generic_elbo = float(generic.elbo())
    assert_close_scaled(state.d_nat1.numpy(), generic.sites.nat1[:, 0].numpy(), RTOL)
    assert_close_scaled(state.d_nat2.numpy(), generic.sites.nat2[:, 0, 0].numpy(), RTOL)
    assert_close_scaled(state.fx_mu.numpy(), f_mu[:, 0].numpy(), RTOL)
    assert_close_scaled(state.fx_var.numpy(), f_var[:, 0].numpy(), RTOL)
    np.testing.assert_allclose(restored_elbo, generic_elbo, rtol=1e-10)


def _jax_state(state) -> JState:
    """The JAX packed state of a port state: channel tuples of ``[T]``."""
    def a(x):
        return jnp.asarray(x.numpy())

    d = state.h.shape[0]
    return JState(
        d_nat1=a(state.d_nat1), d_nat2=a(state.d_nat2), fx_mu=a(state.fx_mu),
        fx_var=a(state.fx_var), h=a(state.h), y=a(state.y),
        p_nat1=tuple(a(state.p_nat1[:, i]) for i in range(d)),
        p_nat2d=tuple(tuple(a(state.p_nat2d[:, i, j]) for j in range(d)) for i in range(d)),
        p_nat2s=tuple(tuple(a(state.p_nat2s[:, i, j]) for j in range(d)) for i in range(d)),
    )


@functools.lru_cache(maxsize=None)
def _jax_steps(name, dtype):
    """The JAX package's jitted packed step, three times from the port's
    packed state of the case."""
    jmodel = jax_cvi(name, dtype=getattr(jnp, dtype))
    state = _jax_state(pack_cvi(port_cvi(jmodel)))
    step = jax.jit(lambda s: j_packed_site_step(jmodel, s))
    for _ in range(STEPS):
        state = step(state)
    return {k: np.asarray(getattr(state, k)) for k in ("d_nat1", "d_nat2", "fx_mu", "fx_var")}


@pytest.mark.parametrize("name", ["matern12-poisson", "matern32-bernoulli"])
def test_packed_steps_match_jax(name):
    want = _jax_steps(name, "float64")
    model = port_cvi(jax_cvi(name))
    state = pack_cvi(model)
    for _ in range(STEPS):
        state = packed_site_step(model, state)
    for k, v in want.items():
        assert_close_scaled(getattr(state, k).numpy(), v, RTOL, err_msg=k)


def test_float32_packed_steps_track_the_generic_and_jax():
    """float32 model, float64 naturals: the packed step against the float32
    generic step and against the JAX package's float32 packed step."""
    name = "matern32-poisson"
    model = port_cvi(jax_cvi(name, dtype=jnp.float32))
    state = pack_cvi(model)
    assert state.p_nat1.dtype == torch.float64 and state.fx_mu.dtype == torch.float32
    generic = model
    for _ in range(STEPS):
        generic = generic.update_sites()
        state = packed_site_step(model, state)
    with torch.no_grad():
        f_mu = generic.posterior_marginals_f()[0][:, 0].numpy()
    np.testing.assert_allclose(state.d_nat1.numpy(), generic.sites.nat1[:, 0].numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.fx_mu.numpy(), f_mu, rtol=2e-3, atol=2e-3)
    want = _jax_steps(name, "float32")
    np.testing.assert_allclose(state.d_nat1.numpy(), want["d_nat1"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.fx_mu.numpy(), want["fx_mu"], rtol=2e-3, atol=2e-3)


def test_packed_step_with_the_float64_policy_off():
    """x64 off: float32 naturals take K3's composition (K4 and K2) at d = 1;
    the step tracks the float32 generic step as above."""
    with config.enable_x64(False):
        model = port_cvi(jax_cvi("matern12-poisson", dtype=jnp.float32))
        state = pack_cvi(model)
        assert state.p_nat1.dtype == torch.float32
        generic = model
        for _ in range(STEPS):
            generic = generic.update_sites()
            state = packed_site_step(model, state)
        with torch.no_grad():
            f_mu = generic.posterior_marginals_f()[0][:, 0].numpy()
    np.testing.assert_allclose(state.d_nat1.numpy(), generic.sites.nat1[:, 0].numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.fx_mu.numpy(), f_mu, rtol=2e-3, atol=2e-3)


def test_state_converter_stacks_the_jax_channels():
    """``interop.packed_cvi_state_from_numpy`` stacks a JAX state's channel
    tuples back into the port's layout: the round trip is exact."""
    state = pack_cvi(port_cvi(jax_cvi("matern32-poisson")))
    converted = interop.packed_cvi_state_from_numpy(to_np(_jax_state(state)), device="cpu")
    for k in ("p_nat1", "p_nat2d", "p_nat2s", "h", "y", "fx_mu", "fx_var", "d_nat1", "d_nat2"):
        assert torch.equal(getattr(converted, k), getattr(state, k)), k


class _TimeVaryingEmission(Matern32):
    """A Matern32 whose emission row grows with time."""

    def generate_emission_model(self, time_points):
        h = super().generate_emission_model(time_points).emission_matrix
        return EmissionModel(h * (1.0 + time_points)[:, None, None])


def _model(kernel=None, outputs=1, mean_function=None):
    t = torch.linspace(0.0, 1.0, 16, dtype=torch.float64)
    kernel = kernel or Matern32(lengthscale=1.0, variance=1.0)
    return CVIGaussianProcess.initialize(kernel, Poisson(), t, torch.zeros(16, outputs,
                                                                          dtype=torch.float64),
                                         mean_function=mean_function)


@pytest.mark.parametrize("case,match", [
    ("multi-output", "single output"),
    ("mean-function", "mean_function"),
    ("time-varying-emission", "time-invariant emission"),
])
def test_pack_rejects_what_the_packed_step_cannot_run(case, match):
    model = {
        "multi-output": lambda: _model(outputs=2),
        "mean-function": lambda: _model(mean_function=LinearMeanFunction(coefficient=0.5)),
        "time-varying-emission": lambda: _model(_TimeVaryingEmission(1.0, 1.0)),
    }[case]()
    with pytest.raises(ValueError, match=match):
        pack_cvi(model)
