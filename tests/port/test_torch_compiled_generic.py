"""The steps that the trainers capture beyond the packed d = 1 ones, on the CPU.

A CUDA graph can only be captured on the card (``test_torch_compiled_cuda.py``
replays them there).  What the CPU shows, for the d ≥ 2 packed step and its
ELBO (R1: ``packed_natgrad_step_ch``, ``packed_elbo_ch``), the generic site
step and ``classic_elbo`` (R2: ``optim/trainers.py::_site_step``, at d = 1
under an SDE prior, with a Gaussian and a Bernoulli likelihood, under an SSM
prior, and at d = 2) and VDP's generic step and ELBO (R3: ``_vdp_step``,
``_vdp_elbo`` at d = 2):

- once warmed up, each reads nothing on the host (``helpers.NoHostSync``),
  with float rates and with the 0-d float64 rates of a captured step, with
  the x64 policy on and off;
- a tensor rate gives the float rate's bits;
- the port's generic steps with tensor rates match the JAX trainers' own
  jitted ``_site_step``, ``_elbo`` and VDP ``_step``, ``_elbo`` with the
  rates traced (one compile each), to the tolerances of
  ``test_torch_cvi_dp_generic.py`` and ``test_torch_vanderpol.py``; the JAX
  ``packed_natgrad_step_ch`` is never compiled here (47-64 s): R1 is held to
  the port's generic step, which those tests hold to JAX;
- the trainers hold every route as a ``CapturedStep``, and a module that a
  step passes through is handed back as the caller's own.

R1 and the d = 2 routes run on the Van der Pol configuration of
``test_torch_cvi_dp_ch.py`` (T = 64), VDP at T = 101 as in
``test_torch_vanderpol.py``, the d = 1 routes on a double well at T = 200.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.models.vdp import VariationalMarkovGP as JVDP
from vi_diffusion_processes_tpu.optim.trainers import CVISitesTrainer as JCVITrainer
from vi_diffusion_processes_tpu.optim.trainers import VDPTrainer as JVDPTrainer
from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.sde.zoo import VanderPolOscillatorSDE as JVanderPol
from vi_diffusion_processes_tpu_torch import config, interop
from vi_diffusion_processes_tpu_torch.likelihoods.discrete import Bernoulli
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE, CVISitesSSM
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.optim import compiled, trainers
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer
from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as TGaussian
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE, VanderPolOscillatorSDE

from .helpers import (
    NoHostSync,
    assert_close_scaled,
    double_well_models,
    port_cvi_dp,
    to_np,
    vanderpol_data,
    vanderpol_model_jax,
    vanderpol_model_port,
)

T_D1, T_D2, T_VDP = 200, 64, 101
LR, X0_LR = 0.3, 0.02
#: test_torch_cvi_dp_generic.py's tolerances: (sites, ELBO) by dtype
GENERIC_TOL = {"float64": (1e-8, 1e-10), "float32": (5e-3, 2e-4)}
#: test_torch_vanderpol.py's and test_torch_cvi_dp_ch.py's at d = 2, float64
VANDERPOL_TOL = 1e-8
PACKED_CH_TOL = 1e-9


def _rate(x):
    """A learning rate as a captured step holds it: a 0-d float64 tensor."""
    return torch.tensor(x, dtype=torch.float64)


def _double_well(dtype=torch.float32, likelihood="gaussian"):
    """A double-well CVI-DP model at d = 1 with the port's API, linearized
    under the float policy in force; Bernoulli labels of the same signal
    for ``likelihood="bernoulli"``."""
    grid = torch.linspace(0.0, 4.0, T_D1, dtype=dtype)
    idx = np.arange(7, T_D1 - 1, 13)
    signal = np.sin(1.1 * grid[idx].numpy())
    noise = np.random.default_rng(0).normal(size=len(idx))
    if likelihood == "gaussian":
        y, lik = np.sign(signal) + 0.2 * noise, Gaussian(0.04, dtype=dtype)
    else:
        y, lik = (signal + 0.5 * noise > 0).astype(np.float64), Bernoulli()
    return CVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid, input_data=(grid[idx], torch.tensor(y[:, None], dtype=dtype)),
        likelihood=lik,
        prior_initial_state=TGaussian(torch.zeros(1, dtype=dtype), torch.tensor([[0.8]], dtype=dtype)),
        prior_sde=DoubleWellSDE(q=[[0.8]], dtype=dtype),
    ).set_linearized_prior()


def _ssm_prior(model):
    """The same data under the SDE model's linearized prior as an SSM."""
    return CVISitesSSM.initialize(model.dist_p, model.time_grid,
                                  (model.time_grid[model.obs_indices], model.observations),
                                  model.likelihood)


def _vdp_d2(dtype=torch.float64):
    """A d = 2 VDP model on the Van der Pol prior with a non-trivial ``(A, b)``
    (``test_torch_vanderpol.py::_vdp_models``, built with the port's API)."""
    grid, obs_idx, obs_y = vanderpol_data(T_VDP)
    rng = np.random.default_rng(3)
    a0 = 0.3 * np.eye(2) + 0.1 * rng.normal(size=(T_VDP - 1, 2, 2))
    b0 = 0.1 * rng.normal(size=(T_VDP - 1, 2))
    sde = VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * torch.eye(2, dtype=dtype), dtype=dtype)
    model = VariationalMarkovGP.initialize(
        (torch.tensor(grid[obs_idx], dtype=dtype), torch.tensor(obs_y, dtype=dtype)), sde,
        torch.tensor(grid, dtype=dtype), Gaussian(0.04, dtype=dtype))
    return model.replace(A=torch.tensor(a0, dtype=dtype), b=torch.tensor(b0, dtype=dtype))


def _packed_ch(model):
    return model, tch.pack_state_ch(model)


#: route → (build inputs, call the step or ELBO with (inputs, lr, x0_lr))
ROUTES = {
    "r1_step": (lambda dt: _packed_ch(vanderpol_model_port(T_D2, dt)),
                lambda s, lr, x0: tch.packed_natgrad_step_ch(*s, lr)),
    "r1_elbo": (lambda dt: _packed_ch(vanderpol_model_port(T_D2, dt)),
                lambda s, lr, x0: tch.packed_elbo_ch(*s)),
    "r2_d1_sde": (lambda dt: _double_well(getattr(torch, dt)),
                  lambda m, lr, x0: trainers._site_step(m, lr)),
    "r2_d1_bernoulli": (lambda dt: _double_well(getattr(torch, dt), "bernoulli"),
                        lambda m, lr, x0: trainers._site_step(m, lr)),
    "r2_d1_ssm": (lambda dt: _ssm_prior(_double_well(getattr(torch, dt))),
                  lambda m, lr, x0: trainers._site_step(m, lr)),
    "r2_d1_elbo": (lambda dt: _double_well(getattr(torch, dt)),
                   lambda m, lr, x0: trainers._classic_elbo(m)),
    "r2_d2": (lambda dt: vanderpol_model_port(T_D2, dt),
              lambda m, lr, x0: trainers._site_step(m, lr)),
    "r2_d2_elbo": (lambda dt: vanderpol_model_port(T_D2, dt),
                   lambda m, lr, x0: trainers._classic_elbo(m)),
    "r3_step": (lambda dt: _vdp_d2(getattr(torch, dt)),
                lambda m, lr, x0: trainers._vdp_step(m, lr, x0)),
    "r3_elbo": (lambda dt: _vdp_d2(getattr(torch, dt)),
                lambda m, lr, x0: trainers._vdp_elbo(m)),
}


def _tensors(out):
    """Every tensor of a step's output, by name (the modules' too)."""
    if isinstance(out, torch.Tensor):
        return {"": out}
    leaves, sig = [], []
    compiled._flatten(out, leaves, sig)
    return {str(i): t for i, t in enumerate(leaves)}


def _assert_bits_equal(got, ref, what=""):
    got, ref = _tensors(got), _tensors(ref)
    assert got.keys() == ref.keys(), what
    for name in ref:
        assert got[name].dtype == ref[name].dtype, (what, name)
        assert torch.equal(got[name], ref[name]), (what, name)


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "x64_off"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_warm_step_reads_nothing_on_the_host(route, x64):
    """After one warm-up call (the quadrature grids, ``√2``, the Hermite
    nodes), the step runs under a mode that fails on any host read, with
    float rates and with tensor rates; float32 models, whose naturals are
    float64 with x64 on."""
    build, step = ROUTES[route]
    with config.enable_x64(x64):
        inputs = build("float32")
        step(inputs, LR, X0_LR)
        lr, x0_lr = _rate(LR), _rate(X0_LR)
        with NoHostSync():
            step(inputs, LR, X0_LR)
            out = step(inputs, lr, x0_lr)
    assert all(bool(torch.isfinite(t).all()) for t in _tensors(out).values())


@pytest.mark.parametrize("read", ["cholesky", "inv", "solve", "nonzero", "unique", "mask"])
def test_no_host_sync_mode_catches_what_waits_for_the_device(read):
    """The checked factorizations and the data-dependent shapes, each of
    which waits for the device on the card."""
    a = torch.eye(3) * 2.0
    calls = {"cholesky": lambda: torch.linalg.cholesky(a), "inv": lambda: torch.linalg.inv(a),
             "solve": lambda: torch.linalg.solve(a, a), "nonzero": lambda: torch.nonzero(a),
             "unique": lambda: torch.unique(a), "mask": lambda: a[a > 1.0]}
    with pytest.raises(AssertionError, match="host read"), NoHostSync():
        calls[read]()
    with NoHostSync():  # their unchecked forms and a dense select pass
        torch.linalg.cholesky_ex(a, check_errors=False)
        torch.where(a > 1.0, a, 0.0)


#: case → (route, dtype, x64, the rates of three steps)
BITS = {
    "r1_f64": ("r1_step", "float64", True, [(LR, 0.0)] * 3),
    "r1_f32": ("r1_step", "float32", True, [(LR, 0.0)] * 3),
    "r1_x64_off": ("r1_step", "float32", False, [(LR, 0.0)] * 3),
    "r2_d1_sde_f32": ("r2_d1_sde", "float32", True, [(LR, 0.0), (0.5 * LR, 0.0), (LR, 0.0)]),
    "r2_d1_sde_x64_off": ("r2_d1_sde", "float32", False, [(LR, 0.0)] * 3),
    "r2_d1_ssm_f64": ("r2_d1_ssm", "float64", True, [(LR, 0.0)] * 3),
    "r2_d2_f32": ("r2_d2", "float32", True, [(LR, 0.0)] * 3),
    "r3_f32": ("r3_step", "float32", True, [(1e-6, 0.0), (0.05, X0_LR), (0.05, X0_LR)]),
    "r3_f64": ("r3_step", "float64", True, [(1e-6, 0.0), (0.05, X0_LR), (0.05, X0_LR)]),
}


def _carry(route, inputs, out):
    """The next step's inputs from a step's output."""
    if route == "r1_step":
        return inputs[0], out[0]
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("case", sorted(BITS))
def test_tensor_rate_gives_the_bits_of_the_float_rate(case):
    """Three steps with ``lr`` (and ``x0_lr``) as 0-d float64 tensors equal
    three with the Python floats bit for bit, every output keeping its
    dtype; VDP's first step is a warm-up step at ``x0_lr = 0``."""
    route, dtype, x64, rates = BITS[case]
    build, step = ROUTES[route]
    with config.enable_x64(x64):
        floats = tensors = build(dtype)
        for lr, x0_lr in rates:
            f_out = step(floats, lr, x0_lr)
            t_out = step(tensors, _rate(lr), _rate(x0_lr))
            _assert_bits_equal(t_out, f_out, case)
            floats, tensors = _carry(route, floats, f_out), _carry(route, tensors, t_out)


def test_packed_ch_step_with_tensor_rate_matches_the_generic_step():
    """R1 with a tensor rate against the port's generic step with one, three
    steps in float64, to ``test_torch_cvi_dp_ch.py``'s 1e-9 of each field's
    scale; R1 is not compiled on the JAX side."""
    model = vanderpol_model_port(T_D2)
    state, generic = tch.pack_state_ch(model), model
    for lr in (LR, 0.5 * LR, LR):
        state, elbo = tch.packed_natgrad_step_ch(model, state, _rate(lr))
        generic, generic_elbo = trainers._site_step(generic, _rate(lr))
        np.testing.assert_allclose(float(elbo), float(generic_elbo), rtol=PACKED_CH_TOL)
    ref = _site_fields(generic)
    for name, got in _site_fields(tch.unpack_state_ch(model, state)).items():
        assert_close_scaled(got.numpy(), ref[name].numpy(), PACKED_CH_TOL, err_msg=name)


def _site_fields(m):
    g, d = m.girsanov_sites, m.data_sites
    return {"g_nat1": g.nat1, "g_nat2_diag": g.nat2_diag, "g_nat2_sub": g.nat2_sub,
            "d_nat1": d.nat1, "d_nat2": d.nat2, "fx_mus": m.fx_mus, "fx_covs": m.fx_covs}


def _jax_case(case):
    """(JAX model, port model, (site, ELBO) tolerances) of a case."""
    if case.startswith("d1"):
        dtype = case.split("_")[1]
        jmodel = double_well_models(batch=1, dtype=dtype)[0]
        return jmodel, port_cvi_dp(jmodel), GENERIC_TOL[dtype]
    jmodel = vanderpol_model_jax(T_D2)
    return (jmodel, port_cvi_dp(jmodel, "VanderPolOscillatorSDE"),
            (VANDERPOL_TOL, VANDERPOL_TOL))


@pytest.mark.parametrize("case", ["d1_float64", "d2_float64"])
def test_generic_step_with_tensor_rate_matches_jax_jitted_once(case):
    """The JAX trainer's own jitted ``_site_step`` and ``_elbo``
    (trainers.py:49, :52), the rate a Python float that ``jax.jit`` traces
    (three rates, one compile), against the port's ``_site_step`` with the
    rate as a tensor, three steps.  Float64: a float32 model's tensor rate
    gives the float rate's bits (above), whose steps
    ``test_torch_cvi_dp_generic.py`` holds to JAX."""
    jmodel, tmodel, (site_tol, elbo_tol) = _jax_case(case)
    jtrainer = JCVITrainer(jmodel, use_packed=False)
    jstep, jelbo = jtrainer._site_step, jtrainer._elbo
    for lr in (LR, 0.5 * LR, LR):
        jmodel = jstep(jmodel, lr)
        tmodel, telbo = trainers._site_step(tmodel, _rate(lr))
        np.testing.assert_allclose(float(telbo), float(jelbo(jmodel)), rtol=elbo_tol,
                                   atol=elbo_tol)
    assert jstep._cache_size() == jelbo._cache_size() == 1
    ref = _site_fields(jmodel)
    for name, got in _site_fields(tmodel).items():
        assert got.dtype == getattr(torch, str(np.asarray(ref[name]).dtype)), name
        assert_close_scaled(got.numpy(), np.asarray(ref[name]), site_tol, err_msg=name)


def test_vdp_generic_step_with_tensor_rates_matches_jax_jitted_once():
    """The JAX ``VDPTrainer``'s own jitted generic ``_step`` and ``_elbo``
    (trainers.py:196-197) with both rates traced, a warm-up step at
    ``x0_lr = 0`` among them, against the port's ``_vdp_step`` and
    ``_vdp_elbo`` with tensor rates, to ``test_torch_vanderpol.py``'s 1e-8."""
    grid, obs_idx, obs_y = vanderpol_data(T_VDP)
    tree = to_np(_vdp_d2())
    jsde = JVanderPol(a=jnp.asarray(1.0), tau=jnp.asarray(1.0), q_mat=0.5 * jnp.eye(2))
    jmodel = JVDP.initialize((jnp.asarray(grid[obs_idx]), jnp.asarray(obs_y)), jsde,
                             jnp.asarray(grid), JGaussianLik(variance=jnp.asarray(0.04)))
    jmodel = jmodel.replace(A=jnp.asarray(tree["A"]), b=jnp.asarray(tree["b"]))
    tmodel = interop.vdp_from_numpy(
        to_np(jmodel), interop.sde_from_numpy("VanderPolOscillatorSDE", to_np(jsde), device="cpu"),
        interop.likelihood_from_numpy({"variance": 0.04}, "cpu"), device="cpu")
    jtrainer = JVDPTrainer(jmodel)
    assert not jtrainer._packed
    for lr, x0_lr in ((1e-6, 0.0), (0.05, X0_LR), (0.05, X0_LR)):
        jmodel = jtrainer._step(None, jmodel, lr, x0_lr)
        tmodel = trainers._vdp_step(tmodel, _rate(lr), _rate(x0_lr))
        np.testing.assert_allclose(float(trainers._vdp_elbo(tmodel)),
                                   float(jtrainer._elbo(None, jmodel)), rtol=VANDERPOL_TOL)
    assert jtrainer._step._cache_size() == jtrainer._elbo._cache_size() == 1
    for name in ("A", "b", "lambda_lagrange", "psi_lagrange", "q_initial_mean", "q_initial_cov"):
        assert_close_scaled(getattr(tmodel, name).numpy(), np.asarray(getattr(jmodel, name)),
                            VANDERPOL_TOL, err_msg=name)


def test_trainers_hold_every_route_as_a_captured_step():
    """Each route of both trainers is a ``CapturedStep``; on the CPU it calls
    the step itself (no capture), and the trainer runs as before."""
    d1, d2 = _double_well(torch.float64), vanderpol_model_port(T_D2)
    cases = [(CVISitesTrainer(d1, use_packed=False), "_generic", trainers._site_step),
             (CVISitesTrainer(_ssm_prior(d1)), "_generic", trainers._site_step),
             (CVISitesTrainer(d2), "_packed", tch.packed_natgrad_step_ch),
             (CVISitesTrainer(d2, use_packed=False), "_generic", trainers._site_step)]
    for trainer, route, fn in cases:
        wrapped = getattr(trainer, route)[-2:]
        assert all(isinstance(w, CapturedStep) for w in wrapped) and wrapped[0].fn is fn
        trainer.max_inner_iters, trainer.max_outer_iters = 2, 1
        assert np.isfinite(trainer.optimize()[0]) and len(trainer.elbo_trace) >= 1
        assert all(w.captures == w.replays == 0 for w in wrapped)
    vdp = VDPTrainer(_vdp_d2(), warmup_steps=1, max_iters=2)
    assert vdp._step.fn is trainers._vdp_step and vdp._elbo.fn is trainers._vdp_elbo
    assert np.isfinite(vdp.optimize(n_rounds=1)[0]) and vdp._step.captures == 0


def test_modules_passed_through_are_handed_back_as_the_callers_own():
    """A graph's output holds the static copies' modules where the step
    passes them through: they are left out of the output's leaves and
    handed back as the caller's own modules, in the order of the call's
    modules, while a module the step made is still copied."""
    model = _double_well(torch.float64)
    leaves, _, modules = compiled._flatten_call((model, LR), {})
    assert modules == [model.likelihood, model.prior_sde]
    static = compiled._map(model, lambda t: t.detach().clone())
    _, _, static_modules = compiled._flatten_call((static, LR), {})
    assert all(s is not m for s, m in zip(static_modules, modules))
    index = {id(m): i for i, m in enumerate(static_modules)}
    out = static.replace(fx_mus=static.fx_mus + 1.0)
    out_leaves, all_leaves = [], []
    compiled._flatten(out, out_leaves, [], kept=index)
    compiled._flatten(out, all_leaves, [])
    n_module = sum(1 for m in modules for _ in list(m.parameters()) + list(m.buffers()))
    assert len(out_leaves) == len(all_leaves) - n_module
    kept = {key: modules[i] for key, i in index.items()}
    handed = compiled._map(out, lambda t: t.clone(), kept)
    assert handed.prior_sde is model.prior_sde and handed.likelihood is model.likelihood
    made = out.replace(prior_sde=DoubleWellSDE(q=[[0.8]], dtype=torch.float64))
    copied = compiled._map(made, lambda t: t.clone(), kept)
    assert copied.prior_sde is not made.prior_sde and copied.likelihood is model.likelihood
