"""The d = 1 SDE zoo, Euler–Maruyama and the VDP drift energy of the port
against the JAX package, on numpy-seeded inputs; float64, rtol 1e-10.

``euler_maruyama`` draws from a ``torch.Generator``, whose stream is not
``jax.random``'s: it is compared through a shared noise array, and its own
draws by their moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.exp.data import build_prior_sde as j_build
from vi_diffusion_processes_tpu.sde import utils as ju
from vi_diffusion_processes_tpu.sde import zoo as jzoo
from vi_diffusion_processes_tpu.sde.drift import LinearDrift as JLinearDrift
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.sde import utils as tu
from vi_diffusion_processes_tpu_torch.sde import zoo
from vi_diffusion_processes_tpu_torch.sde.drift import LinearDrift

from .helpers import assert_close_scaled, to_np

RTOL = 1e-10
SDES = [("benes", {"theta": 0.7}), ("sine", {"theta": 0.3}), ("sqrt", {"theta": 1.4}),
        ("mlpdrift", {}), ("dw", {}), ("ou", {"decay": 0.8})]


def _pair(name, kwargs):
    """The JAX SDE by its config name and the port's twin from its leaves."""
    jsde = j_build(name, q=0.8, **kwargs)
    return jsde, interop.sde_from_numpy(type(jsde).__name__, to_np(jsde), device="cpu")


@pytest.mark.parametrize("name,kwargs", SDES, ids=[n for n, _ in SDES])
def test_drift_and_linearization_match_jax(name, kwargs):
    jsde, tsde = _pair(name, kwargs)
    rng = np.random.default_rng(5)
    m, s = rng.normal(size=(30, 1)) + 0.5, rng.uniform(0.05, 0.5, size=(30, 1, 1))
    x = rng.normal(size=(30, 7, 1))
    assert_close_scaled(tsde.drift(torch.tensor(x)).detach().numpy(),
                        np.asarray(jsde.drift(jnp.asarray(x))), RTOL)
    assert_close_scaled(tsde.gradient_drift(torch.tensor(m)).detach().numpy(),
                        np.asarray(jsde.gradient_drift(jnp.asarray(m))), RTOL)
    assert_close_scaled(
        tsde.expected_drift(torch.tensor(m), torch.tensor(s)).detach().numpy(),
        np.asarray(jsde.expected_drift(jnp.asarray(m), jnp.asarray(s))), RTOL)
    assert_close_scaled(
        tsde.expected_gradient_drift(torch.tensor(m), torch.tensor(s)).detach().numpy(),
        np.asarray(jsde.expected_gradient_drift(jnp.asarray(m), jnp.asarray(s))), RTOL)
    (ch,) = tsde.drift_ch((torch.tensor(x[..., 0]),))
    assert_close_scaled(ch.detach().numpy(), np.asarray(jsde.drift_ch((jnp.asarray(x[..., 0]),))[0]),
                        RTOL)
    # the energy that VDP minimizes, against a linear drift
    a, b = rng.uniform(0.1, 0.8, size=(30, 1, 1)), rng.normal(size=(30, 1))
    got = tu.squared_drift_difference_along_Gaussian_path(
        tsde, LinearDrift(A=torch.tensor(-a), b=torch.tensor(b)),
        tu.Gaussian(torch.tensor(m), torch.tensor(s)), 0.01)
    ref = ju.squared_drift_difference_along_Gaussian_path(
        jsde, JLinearDrift(A=jnp.asarray(-a), b=jnp.asarray(b)),
        ju.Gaussian(jnp.asarray(m), jnp.asarray(s)), 0.01)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL)


@pytest.mark.parametrize("name,kwargs", SDES[:4], ids=[n for n, _ in SDES[:4]])
def test_build_prior_sde_knows_the_d1_zoo(name, kwargs):
    jsde = j_build(name, q=0.8, **kwargs)
    tsde = build_prior_sde(name, q=0.8, device="cpu", **kwargs)
    assert type(tsde).__name__ == type(jsde).__name__
    assert sorted(n for n, _ in tsde.named_parameters()) == sorted(to_np(jsde))
    for pname, p in tsde.named_parameters():
        assert p.shape == np.asarray(getattr(jsde, pname)).shape, pname
        if name != "mlpdrift":  # its weights are drawn, each side from its own stream
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(getattr(jsde, pname)))


def test_build_prior_sde_refuses_what_is_not_ported():
    # the d = 2 oscillator is in the zoo too
    assert build_prior_sde("vanderpol", device="cpu").state_dim == 2
    with pytest.raises(ValueError, match="unknown prior sde"):
        build_prior_sde("nope", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_prior_sde("benes")  # no card here, and no silent CPU


def test_mlp_drift_initialize_draws_from_the_generator():
    a = zoo.MLPDrift.initialize(torch.Generator().manual_seed(1), [[0.5]], hidden=4, stddev=2.0)
    b = zoo.MLPDrift.initialize(torch.Generator().manual_seed(1), [[0.5]], hidden=4, stddev=2.0)
    c = zoo.MLPDrift.initialize(torch.Generator().manual_seed(2), [[0.5]], hidden=4, stddev=2.0)
    assert a.w1.shape == (1, 4) and a.w2.shape == (4, 1) and a.b1.shape == (4,) and a.b2.shape == (1,)
    assert torch.equal(a.w1, b.w1) and not torch.equal(a.w1, c.w1)
    assert float(a.b1.abs().sum()) == 0.0 and a.q.tolist() == [[0.5]]
    assert a.drift(torch.zeros(5, 1, dtype=torch.float64)).shape == (5, 1)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "three"])
def test_euler_maruyama_matches_jax_on_shared_noise(batch, monkeypatch):
    jsde, tsde = _pair("dw", {})
    grid = np.linspace(0.0, 2.0, 81)
    rng = np.random.default_rng(9)
    x0 = rng.normal(size=batch + (1,))
    noise = rng.normal(size=(80,) + batch + (1,))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(noise, dtype))
    ref = ju.euler_maruyama(jsde, jnp.asarray(x0), jnp.asarray(grid), jax.random.PRNGKey(0))
    got = tu.euler_maruyama(tsde, torch.tensor(x0), torch.tensor(grid), noise=torch.tensor(noise))
    assert got.shape == batch + (81, 1) and not got.requires_grad
    assert_close_scaled(got.numpy(), np.asarray(ref), RTOL)
    with pytest.raises(ValueError, match="noise must have shape"):
        tu.euler_maruyama(tsde, torch.tensor(x0), torch.tensor(grid), noise=torch.tensor(noise[1:]))


def test_euler_maruyama_draws_have_the_ou_moments():
    """4,000 OU paths from one generator: the stationary variance q/(2λ) to
    5%, zero mean to 3 standard errors, and the same seed the same paths."""
    sde = build_prior_sde("ou", q=0.5, device="cpu", decay=1.0)
    grid = torch.linspace(0.0, 4.0, 401, dtype=torch.float64)
    x0 = torch.zeros(4000, 1, dtype=torch.float64)
    paths = tu.euler_maruyama(sde, x0, grid, torch.Generator().manual_seed(7))
    again = tu.euler_maruyama(sde, x0, grid, torch.Generator().manual_seed(7))
    assert torch.equal(paths, again)
    last = paths[:, -1, 0]
    np.testing.assert_allclose(float(last.var()), 0.25, rtol=0.05)
    assert abs(float(last.mean())) < 3 * 0.5 / np.sqrt(4000)
