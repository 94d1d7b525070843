"""VDP's drift energy at d = 2 (``ops/vdp_energy.py``) on the CPU: the plain
version that the kernels are held to against
``squared_drift_difference_along_Gaussian_path`` and its autograd, the
adjoint's formulas against autograd, the route that
``VariationalMarkovGP.e_sde`` takes by device, state dimension and SDE, its
counters, and drift learning's gradients, which never take the route.

The kernels run only on the card (``test_torch_vdp_energy_cuda.py``); here
their wrappers run the plain versions, and a CPU tensor that says it lies
on the card shows the route.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.models import vdp as vdp_mod
from vi_diffusion_processes_tpu_torch.models.cvi_dp import _param_grads
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops import quad_kl as qk
from vi_diffusion_processes_tpu_torch.ops import vdp_energy as ve
from vi_diffusion_processes_tpu_torch.ops.quadrature import gauss_hermite_grid
from vi_diffusion_processes_tpu_torch.sde.base import SDE
from vi_diffusion_processes_tpu_torch.sde.drift import LinearDrift
from vi_diffusion_processes_tpu_torch.sde.utils import (
    Gaussian,
    squared_drift_difference_along_Gaussian_path,
)
from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE
from vi_diffusion_processes_tpu_torch.utils import tracing
from vi_diffusion_processes_tpu_torch.utils.linalg import cholesky_with_jitter, inv_small

from .helpers import vanderpol_model_port

F64 = torch.float64
CPU = torch.device("cpu")


def _sde(seed=0):
    """A Van der Pol SDE with a full, well-conditioned diffusion covariance."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(2, 2))
    q = 0.3 * m @ m.T + 0.4 * np.eye(2)
    return VanderPolOscillatorSDE(a=rng.uniform(0.5, 2.0), tau=rng.uniform(0.5, 2.0),
                                  q=torch.tensor(q), dtype=F64)


def _state(seed, n=9, zero_drift=False):
    """Random marginals ``m [n, 2]``, well-conditioned ``S [n, 2, 2]`` and a
    posterior drift ``(A, b)``, or ``A = b = 0`` (the trainer's first
    step)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 2))
    c = rng.normal(size=(n, 2, 2))
    s = 0.2 * c @ np.swapaxes(c, -1, -2) + 0.05 * np.eye(2)
    a = np.zeros((n, 2, 2)) if zero_drift else rng.normal(size=(n, 2, 2))
    b = np.zeros((n, 2)) if zero_drift else rng.normal(size=(n, 2))
    return [torch.tensor(x) for x in (m, s, a, b)]


def _energy_by_kernel(sde, m, s, a, b, dt):
    """``E_sde`` as the route takes it: ``½ Δt Σ_n e_n`` of the kernel's
    wrapper (the plain version on CPU tensors), the Cholesky in PyTorch."""
    z, w = gauss_hermite_grid(2, vdp_mod.SDE_QUAD_POINTS, F64, CPU)
    e = ve.vdp_energy(m, cholesky_with_jitter(s).contiguous(), a, b, inv_small(sde.q.detach()),
                      z, w, "vanderpol", (sde.a.detach(), sde.tau.detach()))
    return 0.5 * torch.sum(e) * dt


@pytest.mark.parametrize("seed,zero_drift", [(0, False), (1, False), (2, False), (3, True)])
def test_plain_version_is_the_drift_energy(seed, zero_drift):
    """The energy and its gradients in ``(m, S)`` through the kernel's plain
    version and through ``squared_drift_difference_along_Gaussian_path``
    (``mvnquad``), to 1e-12."""
    sde = _sde(seed)
    m, s, a, b = _state(seed, zero_drift=zero_drift)
    dt = torch.tensor(0.01, dtype=F64)
    results = []
    for fn in (lambda mm, ss: squared_drift_difference_along_Gaussian_path(
                   sde, LinearDrift(A=-a, b=b), Gaussian(mm, ss), dt),
               lambda mm, ss: _energy_by_kernel(sde, mm, ss, a, b, dt)):
        leaves = [m.clone().requires_grad_(), s.clone().requires_grad_()]
        energy = fn(*leaves)
        results.append((energy.detach(), torch.autograd.grad(energy, leaves)))
    (ref, ref_grads), (got, grads) = results
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=0)
    for name, g, r in zip(("m", "S"), grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12 * float(r.abs().max()), msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_adjoint_agrees_with_autograd(seed):
    """The adjoint's formulas (``vdp_energy_adjoint_plain``) against
    ``torch.autograd.grad`` on the plain forward, the wrapper of the adjoint
    kernel on CPU tensors, and the custom op's registered backward by
    ``gradcheck``."""
    sde = _sde(seed)
    m, s, a, b = _state(seed)
    chol = cholesky_with_jitter(s).contiguous()
    sigma_inv, params = inv_small(sde.q.detach()), (sde.a.detach(), sde.tau.detach())
    z, w = gauss_hermite_grid(2, 20, F64, CPU)
    g_e = torch.tensor(np.random.default_rng(seed + 10).normal(size=m.shape[0]))
    leaves = [x.clone().requires_grad_() for x in (m, chol, a, b)]
    e = ve.vdp_energy_plain(*leaves, sigma_inv, z, w,
                            lambda x: qk.vanderpol_drift(x, *params)[0])
    ref = torch.autograd.grad(e, leaves, g_e)
    got = ve.vdp_energy_adjoint_plain(g_e, m, chol, a, b, sigma_inv, z, w, *params)
    for name, g, r in zip(("mu", "L", "A", "b"), got, ref):
        assert g.shape == r.shape, name
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12 * float(r.abs().max()),
                                   msg=name)
    for g, r in zip(ve.vdp_energy_adjoint(g_e, m, chol, a, b, sigma_inv, z, w, "vanderpol",
                                          params), got):
        assert torch.equal(g, r)
    z3, w3 = gauss_hermite_grid(2, 3, F64, CPU)
    assert torch.autograd.gradcheck(
        lambda *x: ve.vdp_energy(*x, sigma_inv, z3, w3, "vanderpol", params),
        [x[:4].clone().requires_grad_() for x in (m, chol, a, b)])


def test_nan_in_chol_gives_nan():
    """No clamp: a NaN in ``L`` makes that transition's ``e_n`` NaN (the
    trainer reverts the step on it) and leaves the others finite."""
    sde = _sde(4)
    m, s, a, b = _state(4, n=5)
    chol = cholesky_with_jitter(s).contiguous()
    chol[3, 1, 0] = float("nan")
    z, w = gauss_hermite_grid(2, 20, F64, CPU)
    e = ve.vdp_energy(m, chol, a, b, inv_small(sde.q.detach()), z, w, "vanderpol",
                      (sde.a.detach(), sde.tau.detach()))
    assert torch.isnan(e[3]) and bool(torch.isfinite(e[[0, 1, 2, 4]]).all())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    sde = _sde(5)
    m, s, a, b = _state(5, n=4)
    chol = cholesky_with_jitter(s).contiguous()
    z, w = gauss_hermite_grid(2, 3, F64, CPU)
    params = (sde.a.detach(), sde.tau.detach())
    good = [m, chol, a, b, inv_small(sde.q.detach()), z, w]
    with pytest.raises(ValueError, match="no kernel for the drift"):
        ve.vdp_energy(*good, "double_well", params)
    bad = list(good)
    bad[2] = a.transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        ve.vdp_energy(*bad, "vanderpol", params)
    bad[2] = a[:-1]
    with pytest.raises(ValueError, match="shape"):
        ve.vdp_energy(*bad, "vanderpol", params)
    bad = list(good)
    # one Σ⁻¹ a transition is not the kernel's input
    bad[4] = good[4][None].expand(4, 2, 2).contiguous()
    with pytest.raises(ValueError, match="shape"):
        ve.vdp_energy(*bad, "vanderpol", params)
    with pytest.raises(TypeError, match="dtype"):
        ve.vdp_energy(*good, "vanderpol", (params[0].float(), params[1]))
    with pytest.raises(TypeError, match="tensor"):
        ve.vdp_energy(*good[:4], 1.0, z, w, "vanderpol", params)
    with pytest.raises(ValueError, match="g_e"):
        ve.vdp_energy_adjoint(torch.ones(3, dtype=F64), *good, "vanderpol", params)
    assert cs.launch_counts()["vdp_energy"] == cs.launch_counts()["vdp_energy_adjoint"] == 0


class _UserSDE(SDE):
    """An SDE that a user defines: a linear drift in ``d`` dimensions."""

    def __init__(self, d):
        super().__init__()
        self.d = d
        self.q_mat = torch.nn.Parameter(0.5 * torch.eye(d, dtype=F64))

    @property
    def state_dim(self):
        return self.d

    @property
    def q(self):
        return self.q_mat

    def drift(self, x, t=None):
        return -0.5 * x


class _ShiftedVanderPol(VanderPolOscillatorSDE):
    """A Van der Pol subclass with a drift of its own."""

    def drift(self, x, t=None):
        return super().drift(x, t) + 0.1


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the route reads
    ``is_cuda``, and the wrappers then run their plain versions."""

    @property
    def is_cuda(self):
        return True


def _vdp_model(sde, t_points=32):
    """VDP at d = 2 on the Van der Pol data of ``helpers``, under ``sde``,
    with a drift ``(A, b)`` away from zero."""
    cvi = vanderpol_model_port(t_points, "float64", "cpu")
    model = VariationalMarkovGP.initialize(
        (cvi.time_grid[cvi.obs_indices], cvi.observations), sde, cvi.time_grid, cvi.likelihood)
    rng = np.random.default_rng(8)
    return model.replace(A=torch.tensor(0.3 * rng.normal(size=tuple(model.A.shape))),
                         b=torch.tensor(0.3 * rng.normal(size=tuple(model.b.shape))))


def _route(sde, on_card, monkeypatch, d=2):
    """``E_sde`` and its gradients in ``(m, S)`` once at ``d`` under a CPU
    profile; returns them, the counters and how often ``vdp_energy`` was
    called."""
    calls = []

    def recorded(*args):
        calls.append(args)
        return ve.vdp_energy(*args)

    monkeypatch.setattr(vdp_mod, "vdp_energy", recorded)
    if d == 2:
        model = _vdp_model(sde)
        m, s = model.forward_pass()
        m, s = m[:-1].detach(), s[:-1].detach()
    else:
        rng = np.random.default_rng(d)
        n = 6
        c = rng.normal(size=(n, d, d))
        m = torch.tensor(rng.normal(size=(n, d)))
        s = torch.tensor(0.2 * c @ np.swapaxes(c, -1, -2) + 0.05 * np.eye(d))
        model = VariationalMarkovGP(
            prior_sde=sde, likelihood=None, grid=torch.linspace(0, 1, n + 1, dtype=F64),
            obs_indices=None, observations=None, A=torch.tensor(rng.normal(size=(n, d, d))),
            b=torch.tensor(rng.normal(size=(n, d))), lambda_lagrange=None, psi_lagrange=None,
            q_initial_mean=None, q_initial_cov=None, p_initial_mean=None, p_initial_cov=None)
    leaves = [m.clone().requires_grad_(), s.clone().requires_grad_()]
    m_in = leaves[0].as_subclass(_OnCard) if on_card else leaves[0]
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        energy = model.e_sde(m_in, leaves[1])
    counts = tracing.counters()
    tracing.reset()
    grads = torch.autograd.grad(energy, leaves)
    return torch.Tensor(energy.detach()), [torch.Tensor(g) for g in grads], counts, len(calls)


@pytest.mark.parametrize("sde_kind,d,on_card,route", [
    ("vanderpol", 2, True, "fused"),
    ("vanderpol", 2, False, "plain"),
    ("shifted", 2, True, "plain"),
    ("user", 2, True, "plain"),
    ("vanderpol_hook", 3, True, "plain"),
    ("vanderpol_hook", 1, True, "plain"),
])
def test_route_by_device_dimension_and_sde(sde_kind, d, on_card, route, monkeypatch):
    """The kernel's route at d = 2 on the card under a drift that a kernel
    knows; the plain path on the CPU, for a Van der Pol subclass with a
    drift of its own, for an SDE whose hook returns ``None`` and at any
    other d; one count of ``vdp_energy.<route>`` for the one decision.  On
    the CPU the route's energy and gradients are the plain path's to
    1e-12."""
    if sde_kind == "vanderpol":
        sde = _sde(6)
    elif sde_kind == "shifted":
        sde = _ShiftedVanderPol(a=1.2, tau=0.8, q=0.5 * torch.eye(2, dtype=F64))
    else:
        sde = _UserSDE(d)
        if sde_kind == "vanderpol_hook":  # a drift a kernel knows, claimed at another d
            monkeypatch.setattr(sde, "device_drift",
                                lambda: ("vanderpol", (torch.tensor(1.0, dtype=F64),) * 2))
    energy, grads, counts, calls = _route(sde, on_card, monkeypatch, d)
    assert counts == {f"vdp_energy.{route}": 1}
    assert calls == (route == "fused")
    if route == "fused":
        ref, ref_grads, _, _ = _route(sde, False, monkeypatch)
        torch.testing.assert_close(energy, ref, rtol=1e-12, atol=0)
        for g, r in zip(grads, ref_grads):
            torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12 * float(r.abs().max()))


def test_plain_route_is_bit_identical_to_the_former_expression():
    """On the CPU ``e_sde`` and its gradients are the former expression's,
    bit for bit."""
    model = _vdp_model(_sde(7))
    m, s = (x[:-1].detach() for x in model.forward_pass())
    results = []
    for fn in (model.e_sde, lambda mm, ss: squared_drift_difference_along_Gaussian_path(
            model.prior_sde, LinearDrift(A=-model.A, b=model.b), Gaussian(mm, ss), model.dt)):
        leaves = [m.clone().requires_grad_(), s.clone().requires_grad_()]
        energy = fn(*leaves)
        results.append((energy, torch.autograd.grad(energy, leaves)))
    (got, grads), (ref, ref_grads) = results
    assert torch.equal(got, ref)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def test_counters_count_each_decision_in_a_step():
    """A VDP step decides once (the Lagrange multipliers' gradient) and an
    ELBO once; off, nothing is counted."""
    model = _vdp_model(_sde(8))
    tracing.reset()
    model = model.inference_step(1e-3, 0.0)
    assert tracing.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model = model.inference_step(1e-3, 0.0)
        model.elbo()
    counts = tracing.counters()
    tracing.reset()
    assert counts == {"vdp_energy.plain": 2}


def test_drift_learning_gradients_never_take_the_route(monkeypatch):
    """``grad_prior_sde_params`` differentiates ``a``, ``τ`` and ``q``: it
    keeps the plain expression (never ``e_sde``) and gives the gradients of
    the former code, bit for bit."""
    model = _vdp_model(_sde(9))
    with torch.no_grad():
        m, s = model.forward_pass()
    with torch.enable_grad():
        loss = squared_drift_difference_along_Gaussian_path(
            model.prior_sde, LinearDrift(A=-model.A, b=model.b), Gaussian(m[1:], s[1:]),
            model.dt)
        ref = _param_grads(loss, model.prior_sde)

    def refused(*args):
        raise AssertionError("grad_prior_sde_params went through e_sde")

    monkeypatch.setattr(VariationalMarkovGP, "e_sde", refused)
    got = model.grad_prior_sde_params()
    assert set(got) == set(ref) == {"a", "tau", "q_mat"}
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
