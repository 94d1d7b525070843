"""Serving through ``torch.export``: GPR ``predict_f`` exported, saved,
loaded and run against the live call and the JAX package's, and the
kernels' custom ops (``vidp_torch::…``) that carry K1-K4 into an exported
program.  On the CPU the ops run the plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import matern as jmatern
from vi_diffusion_processes_tpu.models.gpr import GaussianProcessRegression as JGPR
from vi_diffusion_processes_tpu_torch.kernels import matern
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
from vi_diffusion_processes_tpu_torch.ops import cuda_riccati, cuda_scan
from vi_diffusion_processes_tpu_torch.utils import serving

from .helpers import affine_inputs, naturals, riccati_inputs


@pytest.mark.parametrize("kernel", ["Matern12", "Matern32"])
def test_exported_predict_f_equals_the_live_call_and_jax(kernel, tmp_path):
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 3, 14))
    y = rng.normal(size=(14, 1))
    t_new = np.linspace(0.2, 2.8, 9)
    jmodel = JGPR(kernel=getattr(jmatern, kernel)(lengthscale=jnp.asarray(0.8),
                                                 variance=jnp.asarray(1.0)),
                  time_points=jnp.asarray(t), observations=jnp.asarray(y),
                  chol_obs_covariance=jnp.asarray([[0.3]]))
    ref_mu, ref_var = jax.jit(lambda tn: jmodel.posterior.predict_f(tn))(jnp.asarray(t_new))
    model = GaussianProcessRegression(getattr(matern, kernel)(0.8, 1.0), torch.tensor(t),
                                      torch.tensor(y), torch.tensor([[0.3]], dtype=torch.float64))
    artifact = serving.export_jittable(lambda tn: model.posterior.predict_f(tn),
                                       torch.tensor(t_new))
    serving.save_artifact(artifact, tmp_path / "gpr.pt2")
    predict = serving.load_artifact(tmp_path / "gpr.pt2")
    f_mu, f_var = predict(torch.tensor(t_new))
    with torch.no_grad():
        live_mu, live_var = model.posterior.predict_f(torch.tensor(t_new))
    np.testing.assert_allclose(f_mu, live_mu, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(f_var, live_var, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(f_mu, ref_mu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(f_var, ref_var, rtol=1e-9, atol=1e-12)
    # other inputs of the same shape run through the frozen program too
    other = np.linspace(-0.5, 3.5, 9)
    with torch.no_grad():
        np.testing.assert_allclose(predict(torch.tensor(other))[0],
                                   model.posterior.predict_f(torch.tensor(other))[0], rtol=1e-12)


def test_exported_d1_program_holds_the_kernel_op():
    """At d = 1 the marginals run on K2: the exported graph holds its op."""
    t = torch.linspace(0.0, 2.0, 11, dtype=torch.float64)
    model = GaussianProcessRegression(matern.Matern12(0.5, 1.0), t, torch.sin(t)[:, None],
                                      torch.tensor([[0.2]], dtype=torch.float64))
    with torch.no_grad():
        program = torch.export.export(serving._Function(lambda x: model.posterior.predict_f(x)),
                                      (t[:5] + 0.1,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vidp_torch.linear_recurrence.default") == 2, targets


def _op_inputs(rng):
    kd, b2 = riccati_inputs(rng, 37, (2,))
    t, c = affine_inputs(rng, 37, (2,))
    nat1, nat2d, nat2s = naturals(rng, 29)
    return [torch.tensor(x) for x in (kd, b2, t, c, nat1, nat2d, nat2s)]


def test_the_four_ops_pass_opcheck():
    kd, b2, t, c, nat1, nat2d, nat2s = _op_inputs(np.random.default_rng(3))
    ops = torch.ops.vidp_torch
    torch.library.opcheck(ops.riccati_d_sweep.default, (kd, b2))
    torch.library.opcheck(ops.linear_recurrence.default, (t, c, torch.full((2,), 0.3,
                          dtype=torch.float64), True))
    torch.library.opcheck(ops.dist_q_1d_planes.default, (nat1, nat2d, nat2s, torch.float32))
    torch.library.opcheck(ops.riccati_d_sweep_f32.default, (kd.float(), b2.float()))


def test_wrappers_through_the_ops_equal_the_direct_route():
    """Each wrapper reaches its kernel through its custom op; on the CPU the
    op runs the plain version.  The wrappers' outputs equal a direct call of
    the plain versions, and their gradients the adjoint formulas called
    directly, bit for bit."""
    from vi_diffusion_processes_tpu_torch.ops.btd import dist_q_1d_core

    rng = np.random.default_rng(4)
    kd, b2, t, c, nat1, nat2d, nat2s = (x.requires_grad_() for x in _op_inputs(rng))
    x0 = torch.tensor([0.3, -0.2], dtype=torch.float64, requires_grad=True)
    kd4, b24 = (x.detach().float().requires_grad_() for x in (kd, b2))

    def grads(out, inputs, g):
        return torch.autograd.grad(out, inputs, g)

    # K1 and K4: the sweep adjoint
    for sweep, plain, k, b, floor in (
            (cuda_scan.riccati_d_sweep, cuda_scan.riccati_d_sweep_plain, kd, b2, 1e-300),
            (cuda_riccati.riccati_d_sweep_f32, cuda_riccati.riccati_d_sweep_f32_plain, kd4, b24,
             1e-30)):
        d = sweep(k, b)
        d_plain = plain(k.detach(), b.detach())
        assert torch.equal(d, d_plain)
        g = torch.tensor(rng.normal(size=d.shape), dtype=d.dtype)
        for got, want in zip(grads(d, (k, b), g),
                             cuda_scan.sweep_adjoint(b.detach(), d_plain, g, floor)):
            assert torch.equal(got, want)
    # K2 both ways: the transposed recurrence in the opposite direction
    for reverse in (False, True):
        x = cuda_scan.linear_recurrence(t, c, x0, reverse)
        x_plain = cuda_scan.linear_recurrence_plain(t.detach(), c.detach(), x0.detach(), reverse)
        assert torch.equal(x, x_plain)
        g = torch.tensor(rng.normal(size=x.shape))
        tt, zero = t.detach(), torch.zeros_like(t[..., :1])
        if reverse:
            ghat = cuda_scan.linear_recurrence_plain(torch.cat([zero, tt[..., :-1]], -1), g, 0.0)
            t_bar = ghat * torch.cat([x_plain[..., 1:], x0.detach()[..., None]], -1)
            x0_bar = tt[..., -1] * ghat[..., -1]
        else:
            ghat = cuda_scan.linear_recurrence_plain(torch.cat([tt[..., 1:], zero], -1), g, 0.0,
                                                     True)
            t_bar = ghat * torch.cat([x0.detach()[..., None], x_plain[..., :-1]], -1)
            x0_bar = tt[..., 0] * ghat[..., 0]
        for got, want in zip(grads(x, (t, c, x0), g), (t_bar, ghat, x0_bar)):
            assert torch.equal(got, want)
    # K3: the VJP of its K1 + K2 composition (mu0 = means[0] gets no cotangent
    # of its own, so that both sides sum the same terms)
    outs = cuda_scan.dist_q_1d_planes(nat1, nat2d, nat2s, torch.float64)
    plain = cuda_scan.dist_q_1d_planes_plain(nat1.detach(), nat2d.detach(), nat2s.detach(),
                                             torch.float64)
    for got, want in zip(outs, plain):
        assert torch.equal(got, want)
    gs = [torch.tensor(rng.normal(size=o.shape)) for o in outs]
    gs[3] = torch.zeros_like(gs[3])
    inputs = (nat1, nat2d, nat2s)
    want = grads(dist_q_1d_core(*inputs, torch.float64), inputs, gs)
    for got, w in zip(grads(outs, inputs, gs), want):
        assert torch.equal(got, w)
