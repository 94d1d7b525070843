"""The Gauss–Hermite point loops (``ops/quad_kl.py``) on the CPU, for both
forms at d = 2: the d = 2 KL's path term (``"quad_kl"``) and VDP's drift
energy (``"vdp_energy"``); and at d = 1 the KL's path term under the double
well (F, F′, at the end of the file).  For each, the plain adjoint formulas of the
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
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
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
from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model
from vi_diffusion_processes_tpu_torch.sde.zoo import (
    BenesSDE,
    DoubleWellSDE,
    MLPDrift,
    OrnsteinUhlenbeckSDE,
    SineDiffusionSDE,
    SqrtDiffusionSDE,
    VanderPolOscillatorSDE,
)
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

from .helpers import OnCard, decide_on_card, vanderpol_model_port

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


class _DoubleWell2D(DoubleWellSDE):
    """The double well's drift on each of two coordinates."""

    @property
    def state_dim(self):
        return 2


class _ShiftedDoubleWell(DoubleWellSDE):
    """A double-well subclass with a drift of its own."""

    def drift(self, x, t=None):
        return super().drift(x, t) + 0.1


_OnCard = OnCard


def test_device_drift_hooks():
    """The base SDE knows no kernel; Van der Pol names its kind and its
    parameters; a subclass with a drift of its own takes the plain path."""
    sde = VanderPolOscillatorSDE(a=1.3, tau=0.7, q=0.5 * torch.eye(2, dtype=F64))
    kind, (a, tau) = sde.device_drift()
    assert kind == "vanderpol" and a is sde.a and tau is sde.tau
    assert _ShiftedVanderPol(a=1.0, tau=1.0, q=torch.eye(2, dtype=F64)).device_drift() is None
    assert SDE().device_drift() is None
    well = DoubleWellSDE(q=[[0.8]])
    kind, (scale, c) = well.device_drift()
    assert kind == "double_well" and scale is well.scale and c is well.c
    assert _ShiftedDoubleWell(q=[[0.8]]).device_drift() is None


def test_kernel_drift_decides_counts_and_casts(monkeypatch):
    """``kernel_drift``: ``None`` off the card, at d ≠ 2 and for an SDE whose
    hook returns ``None``, each counted as ``plain``; on the card at d = 2
    the drift's parameters detached and in the dtype of the tensor that
    decides, counted as ``fused``; a drift that only another route's kernel
    knows (the double well at d = 2) takes the plain path; a kind that no
    kernel knows refused."""
    sde = VanderPolOscillatorSDE(a=1.3, tau=0.7, q=0.5 * torch.eye(2, dtype=F64))
    assert sde.a.requires_grad and sde.tau.requires_grad
    x = torch.zeros(4, 2, dtype=torch.float32)
    card = x.as_subclass(_OnCard)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert qk.kernel_drift(sde, 2, x, "kl_quad") is None
        assert qk.kernel_drift(sde, 3, card, "kl_quad") is None
        assert qk.kernel_drift(_UserSDE(2), 2, card, "kl_quad") is None
        kind, params = qk.kernel_drift(sde, 2, card, "kl_quad")
    counts = tracing.counters()
    tracing.reset()
    assert counts == {"kl_quad.plain": 3, "kl_quad.fused": 1}
    assert kind == "vanderpol" and len(params) == 2
    for p, ref in zip(params, (sde.a, sde.tau)):
        assert p.dtype == torch.float32 and not p.requires_grad
        assert torch.equal(p, ref.detach().float())
    monkeypatch.setattr(sde, "device_drift", lambda: ("double_well", (sde.a, sde.tau)))
    assert qk.kernel_drift(sde, 2, card, "kl_quad") is None
    monkeypatch.setattr(sde, "device_drift", lambda: ("lorenz", (sde.a, sde.tau)))
    with pytest.raises(ValueError, match="no kernel for the drift 'lorenz'"):
        qk.kernel_drift(sde, 2, card, "kl_quad")


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
    if sde_kind == "double_well":  # a drift only the d = 1 kernel knows
        return _DoubleWell2D(q=0.5 * torch.eye(2, dtype=F64))
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
    ("quad_kl", "double_well", 2, True, "plain"),
    ("vdp_energy", "vanderpol", 2, True, "fused"),
    ("vdp_energy", "vanderpol", 2, False, "plain"),
    ("vdp_energy", "shifted", 2, True, "plain"),
    ("vdp_energy", "user", 2, True, "plain"),
    ("vdp_energy", "vanderpol_hook", 3, True, "plain"),
    ("vdp_energy", "vanderpol_hook", 1, True, "plain"),
    ("vdp_energy", "double_well", 2, True, "plain"),
])
def test_route_by_device_dimension_and_sde(form, sde_kind, d, on_card, route, monkeypatch):
    """The kernel's route at d = 2 on the card under a drift that a kernel
    knows; the plain path on the CPU, for a Van der Pol subclass with a
    drift of its own, for an SDE whose hook returns ``None``, for the double
    well (whose kernel is the d = 1 KL's) and at any other d; one count of ``<prefix>.<route>`` for the one decision.  On
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


# ------------------------------------------------ d = 1: the double well (F)
def _pairs(t, seed, tiny=False, dt=0.01):
    """q's expectation parameters ``e1, ed [t]``, ``es [t − 1]`` of a
    Gauss–Markov path whose transitions ``x' = a x + b + N(0, q_v)`` have
    ``a`` near 1 and ``q_v`` near ``p_v = Δt·q`` (``p_var``, also returned);
    ``tiny`` puts the variance of point 0 at 3× the jitter."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=t)
    a = 1.0 - rng.uniform(0.0, 0.2, size=t - 1)
    p_var = rng.uniform(0.5, 1.5, size=t - 1) * dt
    qv = p_var * rng.uniform(0.8, 1.2, size=t - 1)
    v = np.empty(t)
    v[0] = 3.0 * default_jitter() if tiny else rng.uniform(0.05, 0.5)
    for k in range(t - 1):
        v[k + 1] = a[k] ** 2 * v[k] + qv[k]
    es = a * v[:-1] + m[1:] * m[:-1]
    return [torch.tensor(x) for x in (m, v + m**2, es, p_var)]


def _fixed_1d(dt=0.01):
    """The step's grid ``(z, w)``, ``Δt`` and jitter as 0-d tensors."""
    z, w = tp._quad_grid_1d(F64, CPU)
    return z, w, torch.tensor(dt, dtype=F64), torch.tensor(default_jitter(), dtype=F64)


#: the double well's ``(scale, c)``: the benchmark's, and a shallow wide well
WELLS = [(4.0, 1.0), (0.5, 2.0)]


@pytest.mark.parametrize("t,well,tiny", [
    (2, 0, False), (3, 0, False), (257, 0, False), (2, 1, False), (3, 1, False),
    (257, 1, False), (3, 0, True), (257, 1, True)])
def test_1d_twin_agrees_with_the_kl_path(t, well, tiny):
    """F's and F′'s formulas (``quad_kl_1d_plain``,
    ``quad_kl_1d_adjoint_plain``) against ``_kl_path`` and against autograd
    through ``_kl_packed``, ``KL₀`` included, in float64 on the CPU: 1e-12
    of the largest magnitude (one order in the sums and the difference
    ``(1 − a) x − b + Δt f`` against ``x + Δt f − (a x + b)``).  At a
    variance of 3× the jitter ``ḡ_es`` takes 1e-4: autograd's cotangent of
    ``a`` there subtracts two sums of the size of ``x`` whose difference,
    of the size of ``x − m₀``, is 4e4 times smaller, and ``ḡ_es`` divides it
    by ``v₀``.  Against the same formulas in extended precision (numpy's
    ``longdouble``) autograd read 1.3e-5 off at T = 3, the twin 5e-7 (the
    cancellation in ``cov = es − m₀m₁``, which both share)."""
    e1, ed, es, p_var = _pairs(t, t + 10 * well, tiny)
    z, w, dt, jitter = _fixed_1d()
    scale, c = (torch.tensor(v, dtype=F64) for v in WELLS[well])
    mu0, var0 = torch.tensor(0.3, dtype=F64), torch.tensor(0.8, dtype=F64)

    def drift(x):
        return scale * x * (c - torch.square(x))

    s = qk.quad_kl_1d_plain(e1, ed, es, p_var, z, w, dt, jitter, scale, c)
    ref = tp._kl_path(e1, ed, es, drift, p_var, z, w, dt)
    torch.testing.assert_close(0.5 * torch.sum(s), ref, rtol=1e-12, atol=0)
    leaves = [x.clone().requires_grad_() for x in (e1, ed, es)]
    ref_grads = torch.autograd.grad(
        tp._kl_packed(*leaves, drift, p_var, mu0, var0, z, w, dt), leaves)
    half = torch.full((t - 1,), 0.5, dtype=F64)
    grads = qk.quad_kl_1d_adjoint_plain(half, e1, ed, es, p_var, z, w, dt, jitter, scale, c,
                                        mu0, var0)
    for name, g, r in zip(("e1", "ed", "es"), grads, ref_grads):
        assert g.shape == r.shape, name
        limit = 1e-4 if tiny and name == "es" else 1e-12
        torch.testing.assert_close(g, r, rtol=0, atol=limit * float(r.abs().max()), msg=name)


@pytest.mark.parametrize("seed", [3, 4])
def test_1d_adjoint_twin_is_autograd_of_the_twin(seed):
    """The adjoint's formulas (``quad_kl_1d_adjoint_plain``, without
    ``KL₀``) against ``torch.autograd.grad`` through the forward twin, for a
    random cotangent; and on CPU tensors the wrappers are the twins bit for
    bit, ``p_var`` and ``g`` as one value expanded included."""
    e1, ed, es, p_var = _pairs(9, seed)
    z, w, dt, jitter = _fixed_1d()
    params = (torch.tensor(4.0, dtype=F64), torch.tensor(1.0, dtype=F64))
    g = torch.tensor(np.random.default_rng(seed).normal(size=8))
    leaves = [x.clone().requires_grad_() for x in (e1, ed, es)]
    ref = torch.autograd.grad(
        qk.quad_kl_1d_plain(*leaves, p_var, z, w, dt, jitter, *params), leaves, g)
    got = qk.quad_kl_1d_adjoint_plain(g, e1, ed, es, p_var, z, w, dt, jitter, *params)
    for name, a, r in zip(("e1", "ed", "es"), got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-12 * float(r.abs().max()), msg=name)
    mu0, var0 = torch.tensor(0.3, dtype=F64), torch.tensor(0.8, dtype=F64)
    for p in (p_var, p_var[:1].reshape(()).expand(8)):
        s = qk.quad_kl_1d(e1, ed, es, p, z, w, dt, jitter, "double_well", params)
        assert torch.equal(s, qk.quad_kl_1d_plain(e1, ed, es, p, z, w, dt, jitter, *params))
        for gg in (g, g[:1].reshape(()).expand(8)):
            got = qk.quad_kl_1d_adjoint(gg, e1, ed, es, p, z, w, dt, jitter, "double_well",
                                        params, mu0, var0)
            ref = qk.quad_kl_1d_adjoint_plain(gg, e1, ed, es, p, z, w, dt, jitter, *params, mu0,
                                              var0)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_1d_wrappers_refuse_what_the_kernel_does_not_take():
    e1, ed, es, p_var = _pairs(6, 6)
    z, w, dt, jitter = _fixed_1d()
    params = (torch.tensor(4.0, dtype=F64), torch.tensor(1.0, dtype=F64))
    good = [e1, ed, es, p_var, z, w, dt, jitter]
    with pytest.raises(ValueError, match="no kernel for the drift 'vanderpol'"):
        qk.quad_kl_1d(*good, "vanderpol", params)
    for k, bad, err, match in ((1, ed[:-1], ValueError, "ed has shape"),
                               (2, es[:-1], ValueError, "shape"),
                               (3, torch.stack([p_var, p_var], 1)[:, 0], ValueError,
                                "contiguous"),
                               (0, e1.float(), TypeError, "dtype"),
                               (7, 1e-10, TypeError, "tensor")):
        args = list(good)
        args[k] = bad
        with pytest.raises(err, match=match):
            qk.quad_kl_1d(*args, "double_well", params)
    with pytest.raises(ValueError, match="g has shape"):
        qk.quad_kl_1d_adjoint(torch.ones(6, dtype=F64), *good, "double_well", params)
    assert launch_counts()["quad_kl_1d"] == launch_counts()["quad_kl_1d_adjoint"] == 0


def _zoo_1d(kind):
    """A d = 1 SDE of the zoo, or a double well whose drift a subclass
    replaced."""
    q = [[0.8]]
    return {"double_well": lambda: DoubleWellSDE(q=q),
            "shifted_double_well": lambda: _ShiftedDoubleWell(q=q),
            "ou": lambda: OrnsteinUhlenbeckSDE(1.0, q),
            "benes": lambda: BenesSDE(1.0, q),
            "sine": lambda: SineDiffusionSDE(0.5, q),
            "sqrt": lambda: SqrtDiffusionSDE(1.0, q),
            "mlp": lambda: MLPDrift.initialize(torch.Generator().manual_seed(2), q)}[kind]()


@pytest.mark.parametrize("kind,on_card,route", [
    ("double_well", True, "fused"), ("double_well", False, "plain"),
    ("shifted_double_well", True, "plain"), ("ou", True, "plain"), ("benes", True, "plain"),
    ("sine", True, "plain"), ("sqrt", True, "plain"), ("mlp", True, "plain")])
def test_1d_route_by_device_and_sde(kind, on_card, route, monkeypatch):
    """The packed d = 1 step and ``packed_elbo``: F′ for the Girsanov
    gradient and F for each ELBO on the card under the double well; the
    plain path on the CPU, for a subclass with a drift of its own and for
    every other drift of the zoo; ``kl_quad_1d.<route>`` counted twice a
    step and once an ELBO.  The fused route's results (the twin's on CPU
    tensors) agree with the plain route's to 1e-12."""
    model = flagship_model(65, F64, CPU)
    model = model.replace(prior_sde=_zoo_1d(kind))
    calls = []
    for name in ("quad_kl_1d", "quad_kl_1d_adjoint"):
        monkeypatch.setattr(tp, name, lambda *a, _f=getattr(qk, name), _n=name:
                            calls.append(_n) or _f(*a))

    def run():
        state, elbo = tp.packed_natgrad_step(model, tp.pack_state(model), 0.5)
        return state, elbo, tp.packed_elbo(model, state)

    plain = run()
    if on_card:
        decide_on_card(monkeypatch, tp)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = run()
    counts = tracing.counters()
    tracing.reset()
    assert counts == {"dist_q_1d.plain": 3, f"kl_quad_1d.{route}": 3}
    assert calls == ([] if route == "plain" else ["quad_kl_1d_adjoint"] + ["quad_kl_1d"] * 2)
    for a, b in zip((got[0].g_nat1, got[0].g_nat2d, got[0].g_nat2s, got[1], got[2]),
                    (plain[0].g_nat1, plain[0].g_nat2d, plain[0].g_nat2s, plain[1], plain[2])):
        if route == "plain":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * float(b.abs().max()))
