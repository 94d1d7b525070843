"""The port's VDP model, generic and packed, against the JAX package.

The model is that of ``tests/unit/test_vdp_packed.py:19-43`` (double well,
T = 512, a random non-trivial ``(A, b)``), built by the JAX package and
carried across by ``interop``.  Tolerances are that test's own: rtol 1e-9
on ``a``, ``b``, q(x0) and the ELBO, 1e-8 on the multipliers (atol 1e-10);
float32 1e-3 of each channel's scale.  On the CPU the recurrences run K2's
plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.models import vdp_packed as jp
from vi_diffusion_processes_tpu.models.vdp import VariationalMarkovGP as JVDP
from vi_diffusion_processes_tpu.sde.utils import Gaussian as JGaussian
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import vdp_packed as tp
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as TGaussian
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

from .helpers import assert_close_scaled, to_np

N = 512
LR, X0_LR = 0.05, 0.02


def _jax_model(stabilize=False, dtype=jnp.float64):
    rng = np.random.default_rng(3)
    grid = jnp.linspace(0.0, 5.0, N, dtype=dtype)
    obs_idx = np.arange(20, N - 1, 37)
    obs_y = jnp.asarray(
        np.sign(np.sin(1.3 * np.asarray(grid[obs_idx])))[:, None]
        + 0.2 * rng.normal(size=(len(obs_idx), 1)), dtype)
    model = JVDP.initialize(
        (grid[obs_idx], obs_y), JDoubleWell(q_mat=jnp.asarray([[0.8]], dtype)), grid,
        JGaussianLik(variance=jnp.asarray(0.04, dtype)),
        prior_initial_state=JGaussian(mu=jnp.asarray([0.1], dtype), cov=jnp.asarray([[0.6]], dtype)),
        stabilize=stabilize,
    )
    return model.replace(
        A=jnp.asarray(rng.uniform(0.1, 0.8, size=model.A.shape), dtype),
        b=jnp.asarray(rng.normal(0.0, 0.3, size=model.b.shape), dtype),
    )


def _port_model(jmodel):
    tree = to_np(jmodel)
    return interop.vdp_from_numpy(
        tree,
        interop.sde_from_numpy("DoubleWellSDE", tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"),
        device="cpu",
    )


def _assert_packed_close(state, a, b, lam, psi, q0_mean, q0_var):
    """``state`` against arrays, at the tolerances of test_vdp_packed.py:59-68."""
    np.testing.assert_allclose(state.a.numpy(), a, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(state.b.numpy(), b, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(state.lam.numpy(), lam, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(state.psi.numpy(), psi, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(state.q0_mean), float(q0_mean), rtol=1e-9)
    np.testing.assert_allclose(float(state.q0_var), float(q0_var), rtol=1e-9)


def _generic_fields(m):
    return (np.asarray(m.A)[..., 0, 0], np.asarray(m.b)[..., 0],
            np.asarray(m.lambda_lagrange)[..., 0], np.asarray(m.psi_lagrange)[..., 0, 0],
            np.asarray(m.q_initial_mean)[0], np.asarray(m.q_initial_cov)[0, 0])


def _packed_fields(s):
    return tuple(np.asarray(getattr(s, k)) for k in ("a", "b", "lam", "psi", "q0_mean", "q0_var"))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "stabilize"])
def models(request):
    jmodel = _jax_model(stabilize=request.param)
    return jmodel, _port_model(jmodel)


def test_initialize_and_pack_match_jax(models):
    jmodel, tmodel = models
    obs_t = tmodel.grid[tmodel.obs_indices]
    own = VariationalMarkovGP.initialize(
        (obs_t, tmodel.observations), DoubleWellSDE(q=[[0.8]]), tmodel.grid, Gaussian(0.04),
        prior_initial_state=TGaussian(mu=torch.tensor([0.1], dtype=torch.float64),
                                      cov=torch.tensor([[0.6]], dtype=torch.float64)),
        stabilize=jmodel.stabilize,
    )
    assert torch.equal(own.obs_indices, tmodel.obs_indices) and own.stabilize == jmodel.stabilize
    fresh = JVDP.initialize(
        (jmodel.grid[jmodel.obs_indices], jmodel.observations), jmodel.prior_sde, jmodel.grid,
        jmodel.likelihood,
        prior_initial_state=JGaussian(mu=jmodel.p_initial_mean, cov=jmodel.p_initial_cov))
    for name in ("A", "b", "lambda_lagrange", "psi_lagrange", "q_initial_cov", "p_initial_mean"):
        np.testing.assert_array_equal(getattr(own, name).numpy(), np.asarray(getattr(fresh, name)))
    jstate, tstate = jp.pack_vdp(jmodel), tp.pack_vdp(tmodel)
    for name in ("a", "b", "lam", "psi", "q0_mean", "q0_var", "obs_mask", "y_dense"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)))
    carried = interop.packed_vdp_state_from_numpy(to_np(jstate), device="cpu")
    assert torch.equal(carried.y_dense, tstate.y_dense)
    # the default p(x0) is N(0, q)
    default = VariationalMarkovGP.initialize(
        (obs_t, tmodel.observations), DoubleWellSDE(q=[[0.8]]), tmodel.grid, Gaussian(0.04))
    assert default.p_initial_cov.tolist() == [[0.8]] and default.p_initial_mean.tolist() == [0.0]


@pytest.mark.parametrize("steps", [1, 3])
def test_generic_and_packed_steps_match_jax(models, steps):
    jmodel, tmodel = models
    jgen_step = jax.jit(lambda m: m.inference_step(LR, x0_lr=X0_LR))
    jpk_step = jax.jit(lambda s: jp.packed_inference_step(jmodel, s, LR, x0_lr=X0_LR))
    jgen, jstate = jmodel, jp.pack_vdp(jmodel)
    tgen, tstate = tmodel, tp.pack_vdp(tmodel)
    for _ in range(steps):
        jgen, jstate = jgen_step(jgen), jpk_step(jstate)
        tgen = tgen.inference_step(LR, x0_lr=X0_LR)
        tstate = tp.packed_inference_step(tmodel, tstate, LR, x0_lr=X0_LR)
        assert not tstate.a.requires_grad and not tgen.A.requires_grad
    # packed against JAX packed, generic against JAX generic, packed against generic
    _assert_packed_close(tstate, *_packed_fields(jstate))
    _assert_packed_close(tp.pack_vdp(tgen), *_generic_fields(jgen))
    _assert_packed_close(tstate, *_generic_fields(tgen))

    e_jgen = float(jax.jit(lambda m: m.elbo())(jgen))
    e_jpk = float(jax.jit(jp.packed_vdp_elbo)(jmodel, jstate))
    np.testing.assert_allclose(float(tgen.elbo().detach()), e_jgen, rtol=1e-9)
    np.testing.assert_allclose(float(tp.packed_vdp_elbo(tmodel, tstate)), e_jpk, rtol=1e-9)
    np.testing.assert_allclose(float(tp.packed_vdp_elbo(tmodel, tstate)), e_jgen, rtol=1e-9)
    restored = tp.unpack_vdp(tmodel, tstate)
    assert restored.A.shape == (N - 1, 1, 1) and restored.q_initial_cov.shape == (1, 1)
    np.testing.assert_allclose(float(restored.elbo().detach()), e_jgen, rtol=1e-9)


def test_hyperparameter_gradients_match_jax(models):
    jmodel, tmodel = models
    jg = jax.jit(lambda m: m.grad_prior_sde_params())(jmodel)
    tg = tmodel.grad_prior_sde_params()
    assert sorted(tg) == ["c", "q_mat", "scale"]
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(jg, name)), rtol=1e-8)
    for g, r in zip(tmodel.grad_initial_state(), jmodel.grad_initial_state()):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8)
    np.testing.assert_allclose(float(tmodel.kl_initial_state()), float(jmodel.kl_initial_state()),
                               rtol=1e-12)


def test_x0_lr_zero_leaves_q0_as_it_is(models):
    _, tmodel = models
    state = tp.pack_vdp(tmodel)
    new = tp.packed_inference_step(tmodel, state, LR)
    assert float(new.q0_mean) == float(state.q0_mean) and float(new.q0_var) == float(state.q0_var)
    gen = tmodel.inference_step(LR)
    assert torch.equal(gen.q_initial_mean, tmodel.q_initial_mean)
    assert torch.equal(gen.q_initial_cov, tmodel.q_initial_cov)
    assert not torch.equal(new.a, state.a)


def test_float32_steps_match_jax():
    jmodel = _jax_model(dtype=jnp.float32)
    tmodel = _port_model(jmodel)
    jstate, tstate = jp.pack_vdp(jmodel), tp.pack_vdp(tmodel)
    jstep = jax.jit(lambda s: jp.packed_inference_step(jmodel, s, LR, x0_lr=X0_LR))
    for _ in range(3):
        jstate = jstep(jstate)
        tstate = tp.packed_inference_step(tmodel, tstate, LR, x0_lr=X0_LR)
    for name, ref in zip(("a", "b", "lam", "psi", "q0_mean", "q0_var"), _packed_fields(jstate)):
        got = getattr(tstate, name)
        assert got.dtype == torch.float32, name
        assert_close_scaled(got.numpy(), ref, 1e-3, err_msg=name)
    np.testing.assert_allclose(float(tp.packed_vdp_elbo(tmodel, tstate)),
                               float(jax.jit(jp.packed_vdp_elbo)(jmodel, jstate)), rtol=1e-3)


def test_stabilization_replaces_nan_then_clips():
    """``nan → 1e-8`` first, then the clip, with ±inf mapped to the dtype's
    extremes as ``jnp.nan_to_num`` maps them."""
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 5e3, -0.5], dtype=torch.float64)
    ref = np.asarray(jp._stab(jnp.asarray(x.numpy()), True))
    np.testing.assert_array_equal(tp._stab(x, True).numpy(), ref)
    assert tp._stab(x, True).tolist() == [1e-8, 1e3, -1e3, 1e3, -0.5]
    assert tp._stab(x, False) is x


def test_pack_vdp_needs_d1():
    model = _port_model(_jax_model())
    wide = model.replace(b=torch.zeros(N - 1, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="state_dim == 1"):
        tp.pack_vdp(wide)


def test_trainer_with_drift_learning_matches_jax():
    """Two rounds of ``VDPTrainer`` under an OU prior with
    ``learn_prior_sde``: warm-up, fixed-point steps, then one Adam step on
    every leaf of the SDE (``decay`` and ``q_mat``).  rtol 1e-6, as the
    goldens: the loop branches on ELBO comparisons."""
    from vi_diffusion_processes_tpu.optim.trainers import VDPTrainer as JVDPTrainer
    from vi_diffusion_processes_tpu.sde.zoo import OrnsteinUhlenbeckSDE as JOU
    from vi_diffusion_processes_tpu_torch.optim.trainers import VDPTrainer

    base = _jax_model()
    jmodel = JVDP.initialize(
        (base.grid[base.obs_indices], base.observations),
        JOU(decay=jnp.asarray(1.0), q_mat=jnp.asarray([[0.8]])), base.grid, base.likelihood)
    tree = to_np(jmodel)
    tmodel = interop.vdp_from_numpy(
        tree, interop.sde_from_numpy("OrnsteinUhlenbeckSDE", tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"), device="cpu")
    kwargs = dict(lr=0.05, warmup_steps=3, max_iters=6, learn_prior_sde=True, prior_sde_lr=0.05)
    jtrainer, ttrainer = JVDPTrainer(jmodel, **kwargs), VDPTrainer(tmodel, **kwargs)
    jelbos, telbos = jtrainer.optimize(n_rounds=2), ttrainer.optimize(n_rounds=2)
    np.testing.assert_allclose(telbos, jelbos, rtol=1e-6)
    np.testing.assert_allclose(ttrainer.elbo_trace, jtrainer.elbo_trace, rtol=1e-6)
    learned = interop.sde_params_to_numpy(ttrainer.model.prior_sde)
    assert learned["decay"].item() != 1.0 and learned["q_mat"].item() != 0.8
    for name, value in learned.items():
        np.testing.assert_allclose(value, np.asarray(getattr(jtrainer.model.prior_sde, name)),
                                   rtol=1e-6, err_msg=name)


def test_trainer_names_slice_e_at_d2():
    """A d = 2 model runs ``VDPTrainer`` on the generic ``inference_step``
    (held against the JAX trainer in test_torch_vanderpol.py)."""
    from vi_diffusion_processes_tpu_torch.optim.trainers import VDPTrainer
    from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE

    narrow = _port_model(_jax_model())
    obs_times = narrow.grid[narrow.obs_indices]
    wide = VariationalMarkovGP.initialize(
        (obs_times, narrow.observations.repeat(1, 2)),
        VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * torch.eye(2, dtype=torch.float64)),
        narrow.grid, narrow.likelihood)
    trainer = VDPTrainer(wide, lr=0.01, warmup_steps=1, max_iters=2)
    elbo = trainer.perform_inference()
    assert not trainer._packed and np.isfinite(elbo) and trainer.model.A.shape == (N - 1, 2, 2)
    assert float(trainer.model.b.abs().max()) > 0
