"""The captured steps (``optim/compiled.py``) on the CPU.

A CUDA graph can only be captured on the card; what the CPU can show is
that the four packed d = 1 steps it captures there (``packed_natgrad_step``,
``packed_elbo``, ``packed_inference_step``, ``packed_vdp_elbo``) never read
a value on the host once warmed up, that a learning rate given as the 0-d
float64 tensor of a captured step gives the bits of the Python float, that
the port with a tensor rate agrees with the JAX steps jitted once with the
rate traced (the tolerances of ``test_torch_cvi_dp_packed.py`` and
``test_torch_vdp.py``), and how :class:`CapturedStep` keys and copies its
arguments.  The models are the flagship's double well at T = 2,000.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.models import cvi_dp_packed as jcp
from vi_diffusion_processes_tpu.models import vdp_packed as jvp
from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE as JCVISitesSDE
from vi_diffusion_processes_tpu.models.vdp import VariationalMarkovGP as JVDP
from vi_diffusion_processes_tpu.sde.utils import Gaussian as JGaussian
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu_torch import config, interop
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tcp
from vi_diffusion_processes_tpu_torch.models import vdp_packed as tvp
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.optim import compiled
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer
from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as TGaussian
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

from .helpers import NoHostSync, assert_close_scaled, to_np

T = 2000
#: the CVI-DP model's size in test_torch_cvi_dp_packed.py
T_JAX = 600
LR, X0_LR = 0.3, 0.02
#: the tolerances of test_torch_cvi_dp_packed.py: float64 model, and float32
#: model with float64 naturals
CVI_TOL = {"float64": 1e-9, "float32": 1e-4}


def _grid_and_data(dtype, every=20, seed=0):
    grid = np.linspace(0.0, 10.0, T)
    obs_idx = np.arange(10, T - 1, every)
    obs_y = (np.sign(np.sin(0.6 * grid[obs_idx]))[:, None]
             + 0.2 * np.random.default_rng(seed).normal(size=(len(obs_idx), 1)))
    cast = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return cast(grid), cast(grid[obs_idx]), cast(obs_y)


def _cvi_model(dtype=torch.float32):
    """The flagship at T = 2,000 with the port's own API, linearized under
    the float policy in force (float64 naturals with x64 on)."""
    grid, obs_t, obs_y = _grid_and_data(dtype)
    return CVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid, input_data=(obs_t, obs_y),
        likelihood=Gaussian(0.04, dtype=dtype),
        prior_initial_state=TGaussian(torch.zeros(1, dtype=dtype), torch.tensor([[0.8]], dtype=dtype)),
        prior_sde=DoubleWellSDE(q=[[0.8]], dtype=dtype),
    ).set_linearized_prior()


def _vdp_model(dtype=torch.float32):
    """VDP on the same data, with a random non-trivial ``(A, b)``."""
    grid, obs_t, obs_y = _grid_and_data(dtype, every=37, seed=3)
    model = VariationalMarkovGP.initialize(
        (obs_t, obs_y), DoubleWellSDE(q=[[0.8]], dtype=dtype), grid, Gaussian(0.04, dtype=dtype),
        prior_initial_state=TGaussian(torch.tensor([0.1], dtype=dtype), torch.tensor([[0.6]], dtype=dtype)))
    rng = np.random.default_rng(3)
    return model.replace(A=torch.tensor(rng.uniform(0.1, 0.8, model.A.shape), dtype=dtype),
                         b=torch.tensor(rng.normal(0.0, 0.3, model.b.shape), dtype=dtype))


def _rate(x):
    """A learning rate as a captured step holds it: a 0-d float64 tensor."""
    return torch.tensor(x, dtype=torch.float64)


def _fields(out):
    """Every tensor of a step's output, by name."""
    if isinstance(out, tuple):
        state, elbo = out
        return {**_fields(state), "elbo": elbo}
    if isinstance(out, torch.Tensor):
        return {"elbo": out}
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}


def _assert_bits_equal(got, ref):
    got, ref = _fields(got), _fields(ref)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        assert torch.equal(got[name], ref[name]), name


#: (step, x64) of the four captured functions; VDP has no naturals, and with
#: x64 off only its jitter changes
ROUTES = {
    "packed_natgrad_step": lambda m, s, lr, x0: tcp.packed_natgrad_step(m, s, lr),
    "packed_elbo": lambda m, s, lr, x0: tcp.packed_elbo(m, s),
    "packed_inference_step": lambda m, s, lr, x0: tvp.packed_inference_step(m, s, lr, x0),
    "packed_vdp_elbo": lambda m, s, lr, x0: tvp.packed_vdp_elbo(m, s),
}


def _route_inputs(route):
    if route.startswith("packed_inference") or route == "packed_vdp_elbo":
        model = _vdp_model()
        return model, tvp.pack_vdp(model)
    model = _cvi_model()
    return model, tcp.pack_state(model)


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "x64_off"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_warm_step_reads_nothing_on_the_host(route, x64):
    """After one warm-up call (the lazy first uses: quadrature grids, √2),
    the step runs under a mode that fails on any host read, with float rates
    and with tensor rates: the CPU's evidence that it can be captured."""
    with config.enable_x64(x64):
        model, state = _route_inputs(route)
        step = ROUTES[route]
        step(model, state, LR, X0_LR)
        lr, x0_lr = _rate(LR), _rate(X0_LR)
        with NoHostSync():
            step(model, state, LR, X0_LR)
            out = step(model, state, lr, x0_lr)
    assert all(bool(torch.isfinite(t).all()) for t in _fields(out).values())


def test_no_host_sync_mode_catches_the_reads_it_names():
    t = torch.ones(3)
    for read in (lambda: float(t.sum()), lambda: t.sum().item(), lambda: bool(t.sum()),
                 lambda: torch.tensor(2.0), lambda: torch.as_tensor(0.5), lambda: t.tolist()):
        with pytest.raises(AssertionError, match="host read"), NoHostSync():
            read()


CASES = {
    # (builder, x64, route)
    "cvi_x64_f32": (lambda: _cvi_model(torch.float32), True, "cvi"),
    "cvi_x64_f64": (lambda: _cvi_model(torch.float64), True, "cvi"),
    "cvi_x64_off": (lambda: _cvi_model(torch.float32), False, "cvi"),
    "vdp_f32": (lambda: _vdp_model(torch.float32), True, "vdp"),
    "vdp_f64": (lambda: _vdp_model(torch.float64), True, "vdp"),
    "vdp_warmup_f32": (lambda: _vdp_model(torch.float32), True, "vdp_warmup"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_rate_gives_the_bits_of_the_float_rate(case):
    """Three steps with ``lr`` (and ``x0_lr``) as 0-d float64 tensors equal
    three with the Python floats bit for bit, 0-d states keeping their dtype;
    the VDP warm-up steps at ``x0_lr = 0``."""
    build, x64, route = CASES[case]
    with config.enable_x64(x64):
        model = build()
        if route == "cvi":
            def step(s, lr, x0):
                return tcp.packed_natgrad_step(model, s, lr)

            start = tcp.pack_state(model)
        else:
            def step(s, lr, x0):
                return tvp.packed_inference_step(model, s, lr, x0)

            start = tvp.pack_vdp(model)
        lr, x0_lr = (1e-6, 0.0) if route == "vdp_warmup" else (LR, X0_LR)
        floats = tensors = start
        for _ in range(3):
            f_out, t_out = step(floats, lr, x0_lr), step(tensors, _rate(lr), _rate(x0_lr))
            _assert_bits_equal(t_out, f_out)
            floats, tensors = (f_out[0], t_out[0]) if route == "cvi" else (f_out, t_out)


def _jax_cvi(dtype):
    """The model of ``test_torch_cvi_dp_packed.py`` (T = 600), at which its
    float32 tolerance was set: the port takes the float32 model's marginals
    in float64 and casts them, the JAX package's CPU path in float32."""
    grid = jnp.linspace(0.0, 10.0, T_JAX, dtype=dtype)
    obs_idx = np.arange(10, T_JAX - 1, 12)
    obs_t = grid[obs_idx]
    obs_y = jnp.asarray(np.sign(np.sin(0.6 * np.asarray(obs_t)))[:, None]
                        + 0.2 * np.random.default_rng(0).normal(size=(len(obs_idx), 1)), dtype)
    model = JCVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid, input_data=(obs_t, obs_y),
        likelihood=JGaussianLik(variance=jnp.asarray(0.04, dtype)),
        prior_initial_state=JGaussian(mu=jnp.zeros((1,), dtype), cov=jnp.asarray([[0.8]], dtype)),
        prior_sde=JDoubleWell(q_mat=jnp.asarray([[0.8]], dtype)),
    )
    jmodel = jax.jit(lambda m: m.set_linearized_prior())(model)
    tree = to_np(jmodel)
    return jmodel, interop.cvi_dp_from_numpy(
        tree, interop.sde_from_numpy("DoubleWellSDE", tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"), device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_with_tensor_rate_matches_jax_jitted_once(dtype):
    """JAX's ``packed_natgrad_step`` jitted once, the rate a Python float
    that ``jax.jit`` traces (two rates, one compile), against the port with
    the rate as a tensor, to the tolerances of ``test_torch_cvi_dp_packed.py``."""
    rtol = CVI_TOL[dtype]
    jmodel, tmodel = _jax_cvi(getattr(jnp, dtype))
    jstep = jax.jit(jcp.packed_natgrad_step)
    compiled_before = jstep._cache_size()  # shared by every jit of the function
    jstate, tstate = jcp.pack_state(jmodel), tcp.pack_state(tmodel)
    for lr in (LR, 0.5 * LR, LR):
        jstate, jelbo = jstep(jmodel, jstate, lr)
        tstate, telbo = tcp.packed_natgrad_step(tmodel, tstate, _rate(lr))
        np.testing.assert_allclose(float(telbo), float(jelbo), rtol=rtol)
    assert jstep._cache_size() == compiled_before + 1
    for f in dataclasses.fields(tstate):
        assert_close_scaled(getattr(tstate, f.name).numpy(), np.asarray(getattr(jstate, f.name)),
                            rtol, err_msg=f.name)
    np.testing.assert_allclose(float(tcp.packed_elbo(tmodel, tstate)),
                               float(jax.jit(jcp.packed_elbo)(jmodel, jstate)), rtol=rtol)


def test_vdp_port_with_tensor_rates_matches_jax_jitted_once():
    """JAX's ``packed_inference_step`` jitted once with both rates traced,
    a warm-up step at ``x0_lr = 0`` among them, against the port with tensor
    rates, to the tolerances of ``test_torch_vdp.py``."""
    dtype = jnp.float64
    rng = np.random.default_rng(3)
    grid = jnp.linspace(0.0, 10.0, T, dtype=dtype)
    obs_idx = np.arange(10, T - 1, 37)
    obs_y = jnp.asarray(np.sign(np.sin(0.6 * np.asarray(grid[obs_idx])))[:, None]
                        + 0.2 * rng.normal(size=(len(obs_idx), 1)), dtype)
    jmodel = JVDP.initialize(
        (grid[obs_idx], obs_y), JDoubleWell(q_mat=jnp.asarray([[0.8]], dtype)), grid,
        JGaussianLik(variance=jnp.asarray(0.04, dtype)),
        prior_initial_state=JGaussian(mu=jnp.asarray([0.1], dtype), cov=jnp.asarray([[0.6]], dtype)))
    jmodel = jmodel.replace(A=jnp.asarray(rng.uniform(0.1, 0.8, jmodel.A.shape), dtype),
                            b=jnp.asarray(rng.normal(0.0, 0.3, jmodel.b.shape), dtype))
    tree = to_np(jmodel)
    tmodel = interop.vdp_from_numpy(
        tree, interop.sde_from_numpy("DoubleWellSDE", tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"), device="cpu")
    jstep = jax.jit(jvp.packed_inference_step)
    compiled_before = jstep._cache_size()
    jstate, tstate = jvp.pack_vdp(jmodel), tvp.pack_vdp(tmodel)
    for lr, x0_lr in ((1e-6, 0.0), (0.05, X0_LR), (0.05, X0_LR)):
        jstate = jstep(jmodel, jstate, lr, x0_lr)
        tstate = tvp.packed_inference_step(tmodel, tstate, _rate(lr), _rate(x0_lr))
    assert jstep._cache_size() == compiled_before + 1
    for name, rtol in (("a", 1e-9), ("b", 1e-9), ("lam", 1e-8), ("psi", 1e-8)):
        np.testing.assert_allclose(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
                                   rtol=rtol, atol=1e-10, err_msg=name)
    for name in ("q0_mean", "q0_var"):
        np.testing.assert_allclose(float(getattr(tstate, name)), float(getattr(jstate, name)),
                                   rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(float(tvp.packed_vdp_elbo(tmodel, tstate)),
                               float(jax.jit(jvp.packed_vdp_elbo)(jmodel, jstate)), rtol=1e-9)


def test_captured_step_on_the_cpu_calls_the_step():
    """On CPU tensors the wrapper is the step itself: the same bits, no
    capture; the trainers' packed d = 1 routes hold such wrappers."""
    model = _cvi_model()
    state = tcp.pack_state(model)
    step, elbo = CapturedStep(tcp.packed_natgrad_step), CapturedStep(tcp.packed_elbo)
    for _ in range(2):
        got, ref = step(model, state, LR), tcp.packed_natgrad_step(model, state, LR)
        _assert_bits_equal(got, ref)
        state = got[0]
    _assert_bits_equal(elbo(model, state), tcp.packed_elbo(model, state))
    assert (step.captures, step.replays, elbo.captures, elbo.replays) == (0, 0, 0, 0)
    trainer = CVISitesTrainer(model, max_inner_iters=2, max_outer_iters=1)
    trainer.optimize()
    assert all(isinstance(f, CapturedStep) and f.captures == 0 for f in trainer._packed[2:])
    vdp = VDPTrainer(_vdp_model(), warmup_steps=1, max_iters=2)
    vdp.optimize(n_rounds=1)
    assert vdp._step.captures == vdp._elbo.captures == 0 and vdp._step.replays == 0


def _key(*args):
    return compiled._flatten_call(args, {})[1]


def test_key_follows_structure_not_values():
    """A re-linearized model, a stepped state and another rate share the
    key (a copy, as with jax.jit); another grid, dtype or float policy, a
    rate given as a tensor, or another static value does not."""
    model = _cvi_model()
    state = tcp.pack_state(model)
    key = _key(model, state, LR)
    stepped, _ = tcp.packed_natgrad_step(model, state, LR)
    relinearized = tcp.unpack_state(model, stepped).relinearize()
    assert _key(relinearized, tcp.pack_state(relinearized), 0.5 * LR) == key
    assert _key(model, stepped, LR) == key
    assert _key(model, state, _rate(LR)) != key
    assert _key(model.replace(stabilize_ssm=False), state, LR) != key
    with config.enable_x64(False):
        assert _key(model, state, LR) != key
    wide = _cvi_model(torch.float64)
    assert _key(wide, tcp.pack_state(wide), LR) != key


def test_static_copy_shares_no_memory_and_keeps_the_key():
    """The graph's static inputs: every tensor copied, modules deep-copied
    with their parameters replaced, the structure unchanged."""
    model = _cvi_model()
    copied = compiled._map(model, lambda t: t.detach().clone())
    leaves, copies = [], []
    compiled._flatten(model, leaves, [])
    compiled._flatten(copied, copies, [])
    assert _key(copied) == _key(model) and len(leaves) == len(copies) > 20
    ptrs = {t.untyped_storage().data_ptr() for t in leaves}
    assert not any(t.untyped_storage().data_ptr() in ptrs for t in copies)
    assert all(torch.equal(a, b) for a, b in zip(leaves, copies))
    assert copied.prior_sde is not model.prior_sde
    assert isinstance(copied.prior_sde.scale, torch.nn.Parameter)
