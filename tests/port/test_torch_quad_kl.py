"""The Gauss–Hermite point loops at d = 2 (``ops/quad_kl.py``) on the CPU,
for both forms: the d = 2 KL's path term (``"quad_kl"``) and VDP's drift
energy (``"vdp_energy"``).  For each, the plain adjoint formulas of the
kernel against autograd, NaN in ``L``, what the wrappers refuse, the route
that ``_kl_packed_ch`` or ``VariationalMarkovGP.e_sde`` takes by device,
state dimension and SDE, and its counters; the decision itself
(``kernel_drift``); each model's CPU route bit for bit as before the
kernels; the drift energy's plain version against
``squared_drift_difference_along_Gaussian_path``; and drift learning's
gradients, which never take the route.

The kernels run only on the card (``test_torch_quad_kl_cuda.py``,
``test_torch_vdp_energy_cuda.py``); here their wrappers run the plain
versions, and a CPU tensor that says it lies on the card shows the route.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.config import default_jitter
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.models import vdp as vdp_mod
from vi_diffusion_processes_tpu_torch.models.cvi_dp import _param_grads
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.ops import quad_kl as qk
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts
from vi_diffusion_processes_tpu_torch.ops.quadrature import gauss_hermite_grid
from vi_diffusion_processes_tpu_torch.sde.base import SDE
from vi_diffusion_processes_tpu_torch.sde.drift import LinearDrift
from vi_diffusion_processes_tpu_torch.sde.utils import (
    Gaussian,
    squared_drift_difference_along_Gaussian_path,
)
from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE
from vi_diffusion_processes_tpu_torch.utils import tracing
from vi_diffusion_processes_tpu_torch.utils.linalg import (
    chol_psd,
    cholesky_with_jitter,
    inv_pd,
    inv_small,
    logdet_pos,
    matmul_small,
    matvec_small,
    transpose_last,
)

from .helpers import vanderpol_model_port

F64 = torch.float64
CPU = torch.device("cpu")
FORMS = ["quad_kl", "vdp_energy"]
#: the counter prefix of each form's route
PREFIX = {"quad_kl": "kl_quad", "vdp_energy": "vdp_energy"}


# ------------------------------------------------------------------ inputs
def _kl_inputs(seed, n=5, points=3, dtype=F64):
    """Random ``μ``, ``L``, ``A``, ``b``, SPD ``P``, a Gauss–Hermite grid of
    ``points²`` points, ``Δt``, ``a`` and ``τ``."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 2, 2))
    p = m @ np.swapaxes(m, -1, -2) + 0.5 * np.eye(2)
    chol = np.tril(rng.normal(size=(n, 2, 2))) * 0.5
    a = np.eye(2) + 0.2 * rng.normal(size=(n, 2, 2))
    tensors = [torch.tensor(x, dtype=dtype) for x in
               (rng.normal(size=(n, 2)), chol, a, 0.3 * rng.normal(size=(n, 2)), p)]
    z, w = gauss_hermite_grid(2, points, dtype, CPU)
    dt, drift_a, tau = (torch.tensor(v, dtype=dtype) for v in
                        (rng.uniform(0.001, 0.1), rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0)))
    return tensors, (z, w, dt), (drift_a, tau)


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


def _energy_inputs(seed, n=9, points=3):
    """``μ``, ``L``, ``A``, ``b`` of :func:`_state`, then ``Σ⁻¹`` of
    :func:`_sde` and a grid of ``points²`` points, and ``(a, τ)``."""
    sde = _sde(seed)
    m, s, a, b = _state(seed, n)
    z, w = gauss_hermite_grid(2, points, F64, CPU)
    return ([m, cholesky_with_jitter(s).contiguous(), a, b], (inv_small(sde.q.detach()), z, w),
            (sde.a.detach(), sde.tau.detach()))


def _inputs(form, seed, n, points):
    """``(inputs, fixed, params)`` of a form: the differentiable inputs, the
    others up to the drift, and the drift's ``(a, τ)``."""
    return (_kl_inputs if form == "quad_kl" else _energy_inputs)(seed, n=n, points=points)


#: transitions of each form's inputs
N = {"quad_kl": 5, "vdp_energy": 9}


# -------------------------------------------------------- both forms alike
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_plain_adjoint_agrees_with_autograd(form, seed):
    """The adjoint's formulas (``<form>_adjoint_plain``) against
    ``torch.autograd.grad`` on the plain forward, the wrapper of the adjoint
    kernel on CPU tensors, and the custom op's registered backward by
    ``gradcheck``."""
    inputs, fixed, params = _inputs(form, seed, N[form], 20)
    g = torch.tensor(np.random.default_rng(seed + 10).normal(size=N[form]), dtype=F64)
    leaves = [x.clone().requires_grad_() for x in inputs]
    out = getattr(qk, f"{form}_plain")(*leaves, *fixed,
                                       lambda x: qk.vanderpol_drift(x, *params)[0])
    ref = torch.autograd.grad(out, leaves, g)
    got = getattr(qk, f"{form}_adjoint_plain")(g, *inputs, *fixed, *params)
    assert len(got) == len(inputs)
    for name, gr, r in zip(("mu", "L", "A", "b", "P"), got, ref):
        assert gr.shape == r.shape, name
        torch.testing.assert_close(gr, r, rtol=1e-12, atol=1e-12 * float(r.abs().max()),
                                   msg=name)
    # the wrapper of the adjoint kernel on CPU tensors: the same formulas
    for gr, r in zip(getattr(qk, f"{form}_adjoint")(g, *inputs, *fixed, "vanderpol", params),
                     got):
        assert torch.equal(gr, r)
    small, fixed3, params3 = _inputs(form, seed, N[form], 3)
    assert torch.autograd.gradcheck(
        lambda *x: getattr(qk, form)(*x, *fixed3, "vanderpol", params3),
        [x.clone().requires_grad_() for x in small])


@pytest.mark.parametrize("form", FORMS)
def test_nan_in_chol_gives_nan(form):
    """No clamp: a NaN in ``L`` makes that transition's term NaN (the
    trainer rejects or reverts a step on it) and leaves the others
    finite."""
    inputs, fixed, params = _inputs(form, 4, 5, 20)
    inputs[1][3, 1, 0] = float("nan")
    out = getattr(qk, form)(*inputs, *fixed, "vanderpol", params)
    assert torch.isnan(out[3]) and bool(torch.isfinite(out[[0, 1, 2, 4]]).all())


#: where ``Δt`` (Q) or ``Σ⁻¹`` (V) lies among a form's arguments
_ONE_FOR_ALL = {"quad_kl": 7, "vdp_energy": 4}


@pytest.mark.parametrize("form,n", [("quad_kl", 5), ("vdp_energy", 4)])
def test_wrappers_refuse_what_the_kernel_does_not_take(form, n):
    inputs, fixed, params = _inputs(form, 5, n, 3)
    wrapper, adjoint = getattr(qk, form), getattr(qk, f"{form}_adjoint")
    good = [*inputs, *fixed]
    with pytest.raises(ValueError, match="no kernel for the drift"):
        wrapper(*good, "double_well", params)
    bad = list(good)
    bad[2] = good[2].transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*bad, "vanderpol", params)
    bad[2] = good[2][:-1]
    with pytest.raises(ValueError, match="shape"):
        wrapper(*bad, "vanderpol", params)
    bad = list(good)
    # one Δt or Σ⁻¹ a transition is not the kernel's input
    k = _ONE_FOR_ALL[form]
    bad[k] = good[k].expand((n,) + good[k].shape).contiguous()
    with pytest.raises(ValueError, match="shape"):
        wrapper(*bad, "vanderpol", params)
    with pytest.raises(TypeError, match="dtype"):
        wrapper(*good, "vanderpol", (params[0].float(), params[1]))
    bad[k] = 0.01
    with pytest.raises(TypeError, match="tensor"):
        wrapper(*bad, "vanderpol", params)
    with pytest.raises(ValueError, match="g_s" if form == "quad_kl" else "g_e"):
        adjoint(torch.ones(3, dtype=F64), *good, "vanderpol", params)
    assert launch_counts()[form] == launch_counts()[f"{form}_adjoint"] == 0


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


def test_device_drift_hooks():
    """The base SDE knows no kernel; Van der Pol names its kind and its
    parameters; a subclass with a drift of its own takes the plain path."""
    sde = VanderPolOscillatorSDE(a=1.3, tau=0.7, q=0.5 * torch.eye(2, dtype=F64))
    kind, (a, tau) = sde.device_drift()
    assert kind == "vanderpol" and a is sde.a and tau is sde.tau
    assert _ShiftedVanderPol(a=1.0, tau=1.0, q=torch.eye(2, dtype=F64)).device_drift() is None
    assert SDE().device_drift() is None


def test_kernel_drift_decides_counts_and_casts(monkeypatch):
    """``kernel_drift``: ``None`` off the card, at d ≠ 2 and for an SDE whose
    hook returns ``None``, each counted as ``plain``; on the card at d = 2
    the drift's parameters detached and in the dtype of the tensor that
    decides, counted as ``fused``; a kind that no kernel knows refused."""
    sde = VanderPolOscillatorSDE(a=1.3, tau=0.7, q=0.5 * torch.eye(2, dtype=F64))
    assert sde.a.requires_grad and sde.tau.requires_grad
    x = torch.zeros(4, 2, dtype=torch.float32)
    card = x.as_subclass(_OnCard)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert qk.kernel_drift(sde, 2, x, "route") is None
        assert qk.kernel_drift(sde, 3, card, "route") is None
        assert qk.kernel_drift(_UserSDE(2), 2, card, "route") is None
        kind, params = qk.kernel_drift(sde, 2, card, "route")
    counts = tracing.counters()
    tracing.reset()
    assert counts == {"route.plain": 3, "route.fused": 1}
    assert kind == "vanderpol" and len(params) == 2
    for p, ref in zip(params, (sde.a, sde.tau)):
        assert p.dtype == torch.float32 and not p.requires_grad
        assert torch.equal(p, ref.detach().float())
    monkeypatch.setattr(sde, "device_drift", lambda: ("double_well", (sde.a, sde.tau)))
    with pytest.raises(ValueError, match="no kernel for the drift 'double_well'"):
        qk.kernel_drift(sde, 2, card, "route")


# ------------------------------------------------------------ the routes
def _kl_args(model, p_var_form):
    """The KL's arguments at a Van der Pol model's state, as the step
    (``"step"``: each transition its own Δt) or the ELBO (``"elbo"``: the
    first Δt expanded) builds them."""
    consts = tch._step_constants(model)
    dtype, quad_z, quad_w, q, p_mu0, p_cov0 = consts
    (a, _), means, covs = tch._dist_q_ch(tch.pack_state_ch(model), dtype)
    if p_var_form == "step":
        dts = model.time_grid[1:] - model.time_grid[:-1]
        p_var = dts[:, None, None] * q
    else:
        p_var = (model.dt * q).expand((means.shape[0] - 1,) + tuple(q.shape))
    return tch._expectations(a, means, covs), (model.prior_sde, p_var, p_mu0, p_cov0, quad_z,
                                               quad_w, model.dt)


def _vdp_model(sde, t_points=32):
    """VDP at d = 2 on the Van der Pol data of ``helpers``, under ``sde``,
    with a drift ``(A, b)`` away from zero."""
    cvi = vanderpol_model_port(t_points, "float64", "cpu")
    model = VariationalMarkovGP.initialize(
        (cvi.time_grid[cvi.obs_indices], cvi.observations), sde, cvi.time_grid, cvi.likelihood)
    rng = np.random.default_rng(8)
    return model.replace(A=torch.tensor(0.3 * rng.normal(size=tuple(model.A.shape))),
                         b=torch.tensor(0.3 * rng.normal(size=tuple(model.b.shape))))


def _route_sde(form, sde_kind, d, monkeypatch):
    """The SDE of a route case; ``None`` for the Van der Pol model's own
    (``"quad_kl"``)."""
    if sde_kind == "vanderpol":
        return None if form == "quad_kl" else _sde(6)
    if sde_kind == "shifted":
        return _ShiftedVanderPol(a=1.2, tau=0.8, q=0.5 * torch.eye(2, dtype=F64))
    sde = _UserSDE(d)
    if sde_kind == "vanderpol_hook":  # a drift a kernel knows, claimed at another d
        monkeypatch.setattr(sde, "device_drift",
                            lambda: ("vanderpol", (torch.tensor(1.0, dtype=F64),) * 2))
    return sde


def _kl_route(sde, d, on_card):
    """One ``_kl_packed_ch`` call at ``d``, returning ``(KL,)``."""
    if d == 2:
        model = vanderpol_model_port(32, "float64", "cpu")
        expectations, (model_sde, *rest) = _kl_args(model, "step")
        sde = model_sde if sde is None else sde
    else:
        rng = np.random.default_rng(d)
        n, p = 6, 20**d
        expectations = [torch.tensor(rng.normal(size=s)) for s in ((n, d), (n, d, d),
                                                                   (n - 1, d, d))]
        rest = [torch.tensor(rng.normal(size=s)) for s in ((n - 1, d, d), (d,), (d, d), (p, d),
                                                           (p,), ())]
    e1, ed, es = expectations
    if on_card:
        e1 = e1.as_subclass(_OnCard)
    return lambda: (torch.Tensor(tch._kl_packed_ch(e1, ed, es, sde, *rest)),)


def _energy_route(sde, d, on_card):
    """One ``e_sde`` call at ``d``, returning ``E_sde`` and its gradients in
    ``(m, S)``."""
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

    def call():
        energy = model.e_sde(m_in, leaves[1])
        return (torch.Tensor(energy.detach()),
                *(torch.Tensor(g) for g in torch.autograd.grad(energy, leaves)))
    return call


def _route(form, sde, d, on_card, monkeypatch):
    """The form's route once at ``d`` under a CPU profile; returns its
    results, the counters and how often the kernel's wrapper was called."""
    calls = []
    module = tch if form == "quad_kl" else vdp_mod
    wrapper = getattr(qk, form)

    def recorded(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(module, form, recorded)
    call = (_kl_route if form == "quad_kl" else _energy_route)(sde, d, on_card)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = call()
    counts = tracing.counters()
    tracing.reset()
    return out, counts, len(calls)


@pytest.mark.parametrize("form,sde_kind,d,on_card,route", [
    ("quad_kl", "vanderpol", 2, True, "fused"),
    ("quad_kl", "vanderpol", 2, False, "plain"),
    ("quad_kl", "user", 2, True, "plain"),
    ("quad_kl", "vanderpol_hook", 3, True, "plain"),
    ("quad_kl", "vanderpol_hook", 1, True, "plain"),
    ("vdp_energy", "vanderpol", 2, True, "fused"),
    ("vdp_energy", "vanderpol", 2, False, "plain"),
    ("vdp_energy", "shifted", 2, True, "plain"),
    ("vdp_energy", "user", 2, True, "plain"),
    ("vdp_energy", "vanderpol_hook", 3, True, "plain"),
    ("vdp_energy", "vanderpol_hook", 1, True, "plain"),
])
def test_route_by_device_dimension_and_sde(form, sde_kind, d, on_card, route, monkeypatch):
    """The kernel's route at d = 2 on the card under a drift that a kernel
    knows; the plain path on the CPU, for a Van der Pol subclass with a
    drift of its own, for an SDE whose hook returns ``None`` and at any
    other d; one count of ``<prefix>.<route>`` for the one decision.  On
    CPU tensors the KL's two routes give the same bits (the kernel's
    wrapper runs the plain version), and the drift energy's route gives the
    plain path's energy and gradients to 1e-12."""
    sde = _route_sde(form, sde_kind, d, monkeypatch)
    out, counts, calls = _route(form, sde, d, on_card, monkeypatch)
    assert counts == {f"{PREFIX[form]}.{route}": 1}
    assert calls == (route == "fused")
    if form == "quad_kl" and sde_kind == "vanderpol":
        assert torch.equal(out[0], _route(form, sde, d, not on_card, monkeypatch)[0][0])
    if form == "vdp_energy" and route == "fused":
        (energy, *grads), ((ref, *ref_grads), _, _) = out, _route(form, sde, d, False,
                                                                  monkeypatch)
        torch.testing.assert_close(energy, ref, rtol=1e-12, atol=0)
        for g, r in zip(grads, ref_grads):
            torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12 * float(r.abs().max()))


@pytest.mark.parametrize("form,expected", [("quad_kl", {"kl_quad.plain": 3}),
                                           ("vdp_energy", {"vdp_energy.plain": 2})])
def test_counters_count_each_decision_in_a_step(form, expected):
    """A packed d = 2 CVI-DP step decides twice (the Girsanov gradient, the
    ELBO) and ``packed_elbo_ch`` once; a VDP step once (the Lagrange
    multipliers' gradient) and an ELBO once; off, nothing is counted."""
    if form == "quad_kl":
        model = vanderpol_model_port(32, "float64", "cpu")
        state = [tch.pack_state_ch(model)]

        def step_and_elbo():
            state[0], _ = tch.packed_natgrad_step_ch(model, state[0], 0.2)
            tch.packed_elbo_ch(model, state[0])
    else:
        model = [_vdp_model(_sde(8))]

        def step_and_elbo():
            model[0] = model[0].inference_step(1e-3, 0.0)
            model[0].elbo()
    tracing.reset()
    step_and_elbo()
    assert tracing.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step_and_elbo()
    counts = tracing.counters()
    tracing.reset()
    assert counts == expected


# --------------------------------------------------------------- the KL (Q)
def _kl_seed(e1, ed, es, sde, p_var, p_mu0, p_cov0, quad_z, quad_w, dt):
    """``_kl_packed_ch`` as it was before the kernel, kept as it was."""
    outer = tch._outer
    d = e1.shape[-1]
    var = ed - outer(e1, e1)
    mu_k, mu_next = e1[:-1], e1[1:]
    var_k, var_next = var[:-1], var[1:]
    cov_up = transpose_last(es) - outer(mu_k, mu_next)
    a = transpose_last(matmul_small(inv_pd(var_k), cov_up))
    b = mu_next - matvec_small(a, mu_k)
    qv = var_next - matmul_small(matmul_small(a, var_k), transpose_last(a))

    p_inv = inv_pd(p_var)
    trace = torch.sum(p_inv * transpose_last(qv), dim=(-1, -2))
    c_term = -(logdet_pos(qv) - logdet_pos(p_var)) - d + trace

    chol = chol_psd(var_k + default_jitter() * torch.eye(d, dtype=var.dtype, device=var.device))
    x = mu_k[:, None, :] + torch.einsum("nij,pj->npi", chol, 2.0**0.5 * quad_z)
    diff = x + dt * sde.drift(x) - (torch.einsum("nij,npj->npi", a, x) + b[:, None, :])
    weighted = torch.sum(torch.einsum("npi,nij->npj", diff, p_inv) * diff, dim=-1)
    kl_path = 0.5 * torch.sum(torch.sum(weighted * quad_w, dim=-1) + c_term)

    p0_inv = inv_pd(p_cov0)
    diff0 = p_mu0 - e1[0]
    kl_0 = 0.5 * (
        torch.sum(p0_inv * transpose_last(var[0]))
        + diff0 @ p0_inv @ diff0
        - d
        + logdet_pos(p_cov0)
        - logdet_pos(var[0])
    )
    return kl_path + kl_0


@pytest.mark.parametrize("p_var_form", ["step", "elbo"])
def test_cpu_route_is_bit_identical_to_the_former_expression(p_var_form):
    """At small T in float64 the KL and its gradients in the three
    expectation parameters, bit for bit."""
    model = vanderpol_model_port(64, "float64", "cpu")
    expectations, rest = _kl_args(model, p_var_form)
    results = []
    for fn in (tch._kl_packed_ch, _kl_seed):
        leaves = [x.detach().clone().requires_grad_() for x in expectations]
        kl = fn(*leaves, *rest)
        results.append((kl, torch.autograd.grad(kl, leaves)))
    (kl, grads), (kl_ref, grads_ref) = results
    assert torch.equal(kl, kl_ref)
    for g, g_ref in zip(grads, grads_ref):
        assert torch.equal(g, g_ref)


def test_vanderpol_drift_is_the_sdes():
    """The plain versions' drift is the SDE's, bit for bit, and its Jacobian
    the SDE's ``gradient_drift``."""
    sde = VanderPolOscillatorSDE(a=1.3, tau=0.7, q=0.5 * torch.eye(2, dtype=F64))
    x = torch.tensor(np.random.default_rng(3).normal(size=(4, 9, 2)))
    f, jac = qk.vanderpol_drift(x, sde.a, sde.tau)
    assert torch.equal(f, sde.drift(x))
    torch.testing.assert_close(jac, sde.gradient_drift(x), rtol=1e-14, atol=1e-14)


# ------------------------------------------------------ the drift energy (V)
def _energy_by_kernel(sde, m, s, a, b, dt):
    """``E_sde`` as the route takes it: ``½ Δt Σ_n e_n`` of the kernel's
    wrapper (the plain version on CPU tensors), the Cholesky in PyTorch."""
    z, w = gauss_hermite_grid(2, vdp_mod.SDE_QUAD_POINTS, F64, CPU)
    e = qk.vdp_energy(m, cholesky_with_jitter(s).contiguous(), a, b, inv_small(sde.q.detach()),
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
