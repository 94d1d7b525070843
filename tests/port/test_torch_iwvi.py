"""The port's importance-weighted VI (``models/iwvi.py``) against the JAX
package, float64, on docs/examples/iwvi_importance_weighted.py (Matern32,
d = 2, N = 40, 12 inducing points, Gaussian 0.1) with K = 8 samples and a
perturbed proposal.

The port draws from a ``torch.Generator`` and cannot follow ``jax.random``,
so the comparisons that need the same draws feed both sides the same
standard normals, made with numpy: ``jax.random.normal`` and ``torch.randn``
are replaced for the test by a queue of those arrays, consumed in the order
both samplers draw (the proposal's ``ε₀`` and ``ε``, then the prior's over
the union grid).  On the same draws, to 1e-9 of their scale: the log
importance weights (with and without q detached), the IW-ELBO, the DREGS
objective and its gradient in every field of ``dist_q``, and
``expected_value``.  On independent draws the IW-ELBO's mean over 64 seeds
agrees with the JAX package's within 4 standard errors of the difference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import Matern32 as JMatern32
from vi_diffusion_processes_tpu.likelihoods import Gaussian as JGaussian
from vi_diffusion_processes_tpu.models import ImportanceWeightedVI as JIWVI
from vi_diffusion_processes_tpu_torch import interop

from .helpers import SSM_FIELDS, assert_close_scaled, port_kernel, to_np, trainable_ssm

RTOL, K, SEEDS = 1e-9, 8, 64
NEW_T = np.array([0.3, 1.7, 2.05, 3.9])


def _data():
    """docs/examples/iwvi_importance_weighted.py:18-20."""
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 4, 40))
    y = (np.sin(2 * t) + 0.3 * rng.normal(size=40))[:, None]
    return t, y


def _jax_model():
    model = JIWVI.initialize(JMatern32(lengthscale=jnp.asarray(0.8), variance=jnp.asarray(1.2)),
                             JGaussian(variance=jnp.asarray(0.1)),
                             inducing_points=jnp.linspace(0, 4, 12), num_importance_samples=K)
    rng = np.random.default_rng(6)
    q = model.dist_q
    return model.replace(dist_q=q.replace(
        state_offsets=q.state_offsets + 0.1 * rng.normal(size=q.state_offsets.shape),
        initial_mean=q.initial_mean + 0.3 * rng.normal(size=q.initial_mean.shape)))


def _port_model():
    jmodel = _jax_model()
    lik = interop.likelihood_from_numpy(to_np(jmodel.likelihood), "cpu")
    return interop.iwvi_from_numpy(to_np(jmodel), port_kernel(jmodel.kernel), lik, device="cpu")


def _draws(n_points, seed=0, d=2, m=12):
    """The four standard-normal arrays of one Matheron sample."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(K, d)), rng.normal(size=(K, m - 1, d)),
            rng.normal(size=(K, d)), rng.normal(size=(K, m + n_points - 1, d))]


def _jax_feed(monkeypatch, draws):
    queue = list(draws)

    def normal(key, shape=(), dtype=float):
        out = queue.pop(0)
        assert out.shape == tuple(shape)
        return jnp.asarray(out, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


def _torch_feed(monkeypatch, draws):
    queue = list(draws)

    def randn(*shape, generator=None, dtype=None, device=None, **_):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        out = queue.pop(0)
        assert out.shape == shape
        return torch.tensor(out, dtype=dtype, device=device)

    monkeypatch.setattr(torch, "randn", randn)



def test_log_importance_weights_match_jax():
    rng = np.random.default_rng(1)
    t, y = _data()
    samples_s = rng.normal(size=(K, 40, 2))
    samples_u = rng.normal(size=(K, 12, 2))
    jmodel, model = _jax_model(), _port_model()
    want = jax.jit(jmodel.log_importance_weights)(jnp.asarray(samples_s), jnp.asarray(samples_u),
                                                  (jnp.asarray(t), jnp.asarray(y)))
    for stop in (False, True):
        got = model.log_importance_weights(torch.tensor(samples_s), torch.tensor(samples_u),
                                           (torch.tensor(t), torch.tensor(y)), stop)
        assert_close_scaled(got.detach().numpy(), np.asarray(want), RTOL)


def test_elbo_and_dregs_gradient_on_the_same_draws(monkeypatch):
    t, y = _data()
    draws = _draws(40)
    jmodel = _jax_model()
    jdata = (jnp.asarray(t), jnp.asarray(y))
    key = jax.random.PRNGKey(0)
    _jax_feed(monkeypatch, draws + draws)  # read as the jitted function is traced

    def run(q):
        elbo = jmodel.replace(dist_q=q).elbo(jdata, key)
        return elbo, jax.value_and_grad(
            lambda qq: jmodel.replace(dist_q=qq).dregs_objective(jdata, key))(q)

    jelbo, (jobj, jgrad) = jax.jit(run)(jmodel.dist_q)

    model = _port_model()
    data = (torch.tensor(t), torch.tensor(y))
    _torch_feed(monkeypatch, draws + draws)
    with torch.no_grad():
        elbo = model.elbo(data)
    q = trainable_ssm(model.dist_q)
    obj = model.replace(dist_q=q).dregs_objective(data)
    obj.backward()
    assert_close_scaled(elbo.numpy(), np.asarray(jelbo), RTOL)
    assert_close_scaled(obj.detach().numpy(), np.asarray(jobj), RTOL)
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(q, f).grad.numpy(), np.asarray(getattr(jgrad, f)), RTOL,
                            err_msg=f)


def test_expected_value_on_the_same_draws(monkeypatch):
    t, y = _data()
    draws = _draws(40 + len(NEW_T), seed=3)
    _jax_feed(monkeypatch, draws)
    want = jax.jit(lambda m: m.expected_value(jnp.asarray(NEW_T), (jnp.asarray(t), jnp.asarray(y)),
                                              jax.random.PRNGKey(1)))(_jax_model())
    _torch_feed(monkeypatch, draws)
    with torch.no_grad():
        got = _port_model().expected_value(torch.tensor(NEW_T), (torch.tensor(t), torch.tensor(y)))
    assert tuple(got.shape) == want.shape == (len(NEW_T), 1)
    assert_close_scaled(got.numpy(), np.asarray(want), RTOL)


@functools.lru_cache(maxsize=None)
def _jax_elbos():
    jmodel, (t, y) = _jax_model(), _data()
    keys = jax.random.split(jax.random.PRNGKey(5), SEEDS)
    return np.asarray(jax.jit(jax.vmap(
        lambda k: jmodel.elbo((jnp.asarray(t), jnp.asarray(y)), k)))(keys))


def test_elbo_moments_over_seeds_match_jax():
    ref = _jax_elbos()
    model, (t, y) = _port_model(), _data()
    data = (torch.tensor(t), torch.tensor(y))
    with torch.no_grad():
        got = np.array([float(model.elbo(data, torch.Generator().manual_seed(s)))
                        for s in range(SEEDS)])
    se = np.sqrt(got.var(ddof=1) / SEEDS + ref.var(ddof=1) / SEEDS)
    assert abs(got.mean() - ref.mean()) < 4.0 * se, (got.mean(), ref.mean(), se)
    # the spreads agree as well: a ratio of sample variances inside [1/3, 3]
    assert 1 / 3 < got.var(ddof=1) / ref.var(ddof=1) < 3


@pytest.mark.parametrize("num_samples", [None, 5])
def test_predict_f_samples_are_finite_resamples(num_samples):
    model, (t, y) = _port_model(), _data()
    with torch.no_grad():
        f = model.predict_f_samples(torch.tensor(NEW_T), (torch.tensor(t), torch.tensor(y)),
                                    torch.Generator().manual_seed(0), num_samples)
    assert tuple(f.shape) == (num_samples or K, len(NEW_T), 1)
    assert bool(torch.isfinite(f).all())


def test_converter_round_trip():
    tree = to_np(_jax_model())
    back = interop.fields_to_numpy(_port_model())
    np.testing.assert_array_equal(back["inducing_points"], tree["inducing_points"])
    for f in SSM_FIELDS:
        np.testing.assert_array_equal(back["dist_q"][f], tree["dist_q"][f])
    assert back["num_importance_samples"] == K
