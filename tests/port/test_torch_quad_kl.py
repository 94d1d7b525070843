"""The d = 2 KL's Gauss–Hermite path term (``ops/quad_kl.py``) on the CPU:
the packed step's CPU route bit for bit as before the kernel, the plain
adjoint formulas of the kernel against autograd, the route that
``_kl_packed_ch`` takes by device, state dimension and SDE, and its counters.

The kernels run only on the card (``test_torch_quad_kl_cuda.py``); here
their wrappers run the plain versions, and a CPU tensor that says it lies
on the card shows the route.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.config import default_jitter
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops import quad_kl as qk
from vi_diffusion_processes_tpu_torch.ops.quadrature import gauss_hermite_grid
from vi_diffusion_processes_tpu_torch.sde.base import SDE
from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE
from vi_diffusion_processes_tpu_torch.utils import tracing
from vi_diffusion_processes_tpu_torch.utils.linalg import (
    chol_psd,
    inv_pd,
    logdet_pos,
    matmul_small,
    matvec_small,
    transpose_last,
)

from .helpers import vanderpol_model_port

F64 = torch.float64


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


def _inputs(seed, n=5, points=3, dtype=F64):
    """Random ``μ``, ``L``, ``A``, ``b``, SPD ``P``, a Gauss–Hermite grid of
    ``points²`` points, ``Δt``, ``a`` and ``τ``."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 2, 2))
    p = m @ np.swapaxes(m, -1, -2) + 0.5 * np.eye(2)
    chol = np.tril(rng.normal(size=(n, 2, 2))) * 0.5
    a = np.eye(2) + 0.2 * rng.normal(size=(n, 2, 2))
    tensors = [torch.tensor(x, dtype=dtype) for x in
               (rng.normal(size=(n, 2)), chol, a, 0.3 * rng.normal(size=(n, 2)), p)]
    z, w = gauss_hermite_grid(2, points, dtype, torch.device("cpu"))
    dt, drift_a, tau = (torch.tensor(v, dtype=dtype) for v in
                        (rng.uniform(0.001, 0.1), rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0)))
    return tensors, (z, w, dt), (drift_a, tau)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_adjoint_agrees_with_autograd(seed):
    """The adjoint's formulas (``quad_kl_adjoint_plain``) against
    ``torch.autograd.grad`` on the plain forward, and the custom op's
    registered backward by ``gradcheck``."""
    tensors, (z, w, dt), (drift_a, tau) = _inputs(seed, points=20)
    g_s = torch.tensor(np.random.default_rng(seed + 10).normal(size=5), dtype=F64)
    leaves = [x.clone().requires_grad_() for x in tensors]
    s = qk.quad_kl_plain(*leaves, z, w, dt, lambda x: qk.vanderpol_drift(x, drift_a, tau)[0])
    ref = torch.autograd.grad(s, leaves, g_s)
    got = qk.quad_kl_adjoint_plain(g_s, *tensors, z, w, dt, drift_a, tau)
    for name, g, r in zip(("mu", "L", "A", "b", "P"), got, ref):
        assert g.shape == r.shape, name
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12 * float(r.abs().max()),
                                   msg=name)
    # the wrapper of the adjoint kernel on CPU tensors: the same formulas
    for g, r in zip(qk.quad_kl_adjoint(g_s, *tensors, z, w, dt, "vanderpol", (drift_a, tau)),
                    got):
        assert torch.equal(g, r)
    small, (z3, w3, dt3), params = _inputs(seed)
    assert torch.autograd.gradcheck(
        lambda *x: qk.quad_kl(*x, z3, w3, dt3, "vanderpol", params),
        [x.clone().requires_grad_() for x in small])


def test_vanderpol_drift_is_the_sdes():
    """The plain versions' drift is the SDE's, bit for bit, and its Jacobian
    the SDE's ``gradient_drift``."""
    sde = VanderPolOscillatorSDE(a=1.3, tau=0.7, q=0.5 * torch.eye(2, dtype=F64))
    x = torch.tensor(np.random.default_rng(3).normal(size=(4, 9, 2)))
    f, jac = qk.vanderpol_drift(x, sde.a, sde.tau)
    assert torch.equal(f, sde.drift(x))
    torch.testing.assert_close(jac, sde.gradient_drift(x), rtol=1e-14, atol=1e-14)


def test_nan_in_chol_gives_nan():
    """No clamp: a NaN in ``L`` makes that transition's ``s_n`` NaN (the
    trainer rejects a step on it) and leaves the others finite."""
    tensors, grid, params = _inputs(4, points=20)
    tensors[1][3, 1, 0] = float("nan")
    s = qk.quad_kl(*tensors, *grid, "vanderpol", params)
    assert torch.isnan(s[3]) and bool(torch.isfinite(s[[0, 1, 2, 4]]).all())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    tensors, grid, params = _inputs(5)
    with pytest.raises(ValueError, match="no kernel for the drift"):
        qk.quad_kl(*tensors, *grid, "double_well", params)
    bad = list(tensors)
    bad[2] = tensors[2].transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        qk.quad_kl(*bad, *grid, "vanderpol", params)
    bad[2] = tensors[2][:-1]
    with pytest.raises(ValueError, match="shape"):
        qk.quad_kl(*bad, *grid, "vanderpol", params)
    with pytest.raises(TypeError, match="dtype"):
        qk.quad_kl(*tensors, *grid, "vanderpol", (params[0].float(), params[1]))
    with pytest.raises(TypeError, match="tensor"):
        qk.quad_kl(*tensors, grid[0], grid[1], 0.01, "vanderpol", params)
    assert cs.launch_counts()["quad_kl"] == cs.launch_counts()["quad_kl_adjoint"] == 0


def test_device_drift_hooks():
    """The base SDE knows no kernel; Van der Pol names its kind and its
    parameters; a subclass with a drift of its own takes the plain path."""

    class Shifted(VanderPolOscillatorSDE):
        def drift(self, x, t=None):
            return super().drift(x, t) + 1.0

    sde = VanderPolOscillatorSDE(a=1.3, tau=0.7, q=0.5 * torch.eye(2, dtype=F64))
    kind, (a, tau) = sde.device_drift()
    assert kind == "vanderpol" and a is sde.a and tau is sde.tau
    assert Shifted(a=1.0, tau=1.0, q=torch.eye(2, dtype=F64)).device_drift() is None
    assert SDE().device_drift() is None


class _UserSDE(SDE):
    """An SDE that a user defines: a linear drift in ``d`` dimensions."""

    def __init__(self, d):
        super().__init__()
        self.d = d

    @property
    def state_dim(self):
        return self.d

    def drift(self, x, t=None):
        return -0.5 * x


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the route reads
    ``is_cuda``, and the wrappers then run their plain versions."""

    @property
    def is_cuda(self):
        return True


def _route(sde_kind, d, on_card, monkeypatch):
    """Run ``_kl_packed_ch`` once at ``d`` under a CPU profile; returns the
    KL, the counters and how often ``quad_kl`` was called."""
    calls = []

    def recorded(*args):
        calls.append(args)
        return qk.quad_kl(*args)

    monkeypatch.setattr(tch, "quad_kl", recorded)
    if d == 2:
        model = vanderpol_model_port(32, "float64", "cpu")
        expectations, (sde, *rest) = _kl_args(model, "step")
    else:
        rng = np.random.default_rng(d)
        n, p = 6, 20**d
        expectations = [torch.tensor(rng.normal(size=s)) for s in ((n, d), (n, d, d),
                                                                   (n - 1, d, d))]
        rest = [torch.tensor(rng.normal(size=s)) for s in ((n - 1, d, d), (d,), (d, d), (p, d),
                                                           (p,), ())]
    if sde_kind == "user":
        sde = _UserSDE(d)
    elif sde_kind == "vanderpol_hook":  # a drift a kernel knows, claimed at another d
        sde = _UserSDE(d)
        monkeypatch.setattr(sde, "device_drift",
                            lambda: ("vanderpol", (torch.tensor(1.0, dtype=F64),) * 2))
    e1, ed, es = expectations
    if on_card:
        e1 = e1.as_subclass(_OnCard)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        kl = tch._kl_packed_ch(e1, ed, es, sde, *rest)
    counts = tracing.counters()
    tracing.reset()
    return torch.Tensor(kl), counts, len(calls)


@pytest.mark.parametrize("sde_kind,d,on_card,route", [
    ("vanderpol", 2, True, "fused"),
    ("vanderpol", 2, False, "plain"),
    ("user", 2, True, "plain"),
    ("vanderpol_hook", 3, True, "plain"),
    ("vanderpol_hook", 1, True, "plain"),
])
def test_route_by_device_dimension_and_sde(sde_kind, d, on_card, route, monkeypatch):
    """The kernel's route at d = 2 on the card under a drift that a kernel
    knows; the plain path on the CPU, for an SDE whose hook returns
    ``None`` and at any other d; one count of ``kl_quad.<route>`` for the
    one decision.  On CPU tensors the kernel's wrapper runs the plain
    version, so both routes give the same bits."""
    kl, counts, calls = _route(sde_kind, d, on_card, monkeypatch)
    assert counts == {f"kl_quad.{route}": 1}
    assert calls == (route == "fused")
    if d == 2 and sde_kind == "vanderpol":
        assert torch.equal(kl, _route(sde_kind, d, not on_card, monkeypatch)[0])


def test_counters_count_each_decision_in_a_step():
    """A packed step on the CPU decides twice (the Girsanov gradient, the
    ELBO) and ``packed_elbo_ch`` once; off, nothing is counted."""
    model = vanderpol_model_port(32, "float64", "cpu")
    state = tch.pack_state_ch(model)
    tracing.reset()
    tch.packed_natgrad_step_ch(model, state, 0.2)
    assert tracing.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state, _ = tch.packed_natgrad_step_ch(model, state, 0.2)
        tch.packed_elbo_ch(model, state)
    counts = tracing.counters()
    tracing.reset()
    assert counts == {"kl_quad.plain": 3}
