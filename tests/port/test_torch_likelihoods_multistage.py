"""The port's multi-stage likelihood (``likelihoods/multistage.py``)
against the JAX package, float64.

* ``log_probability_density`` and ``variational_expectations`` over every
  branch of the decision tree (y = 0, 1 and counts from 2), to 1e-12 of
  their scale;
* ``sample_y`` by its branch frequencies and its mean count over 200,000
  draws at one latent value, within 5 standard errors of the exact values;
* docs/examples/multistage_demand.py at its size (80 points, three Matern32
  latent processes through ``IndependentMultiOutput``, a VGP trained by
  natural gradients with momentum, γ = 0.2): three steps, the SSM and the
  loss after each to ``NATGRAD_RTOL``, on the counts the JAX example
  samples.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.special import expit

from vi_diffusion_processes_tpu.kernels import IndependentMultiOutput as JIMO
from vi_diffusion_processes_tpu.kernels import Matern32 as JMatern32
from vi_diffusion_processes_tpu.likelihoods import MultiStageLikelihood as JMultiStage
from vi_diffusion_processes_tpu.models import VariationalGaussianProcess as JVGP
from vi_diffusion_processes_tpu.optim import natgrad_init as jnatgrad_init
from vi_diffusion_processes_tpu.optim import natgrad_step as jnatgrad_step
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.likelihoods.multistage import MultiStageLikelihood
from vi_diffusion_processes_tpu_torch.optim.natgrad import natgrad_init, natgrad_step

from .helpers import SSM_FIELDS, assert_close_scaled, port_kernel, to_np

RTOL, STEPS = 1e-12, 3
#: the example's 80 sorted uniform times leave a smallest gap of 3.2e-4, so
#: the Matern32 prior naturals reach 6e9 and ``naturals_to_ssm`` keeps about
#: 6 digits: a one-ulp change of one lengthscale moves the JAX package's SSM
#: by up to 5.7e-7 of its scale over the three steps, and the port differs
#: from it by up to 1.4e-6 (the loss by 2.3e-8)
NATGRAD_RTOL = 1e-5


def _inputs(n=60, seed=0):
    rng = np.random.default_rng(seed)
    f_means = rng.normal(size=(n, 3))
    f_vars = rng.uniform(0.05, 1.5, size=(n, 3))
    y = rng.integers(0, 6, size=(n, 1)).astype(np.float64)
    return f_means, f_vars, y


def test_log_density_and_variational_expectations_match_jax():
    f_means, f_vars, y = _inputs()
    assert set(np.unique(y)) == {0.0, 1.0, 2.0, 3.0, 4.0, 5.0}
    jlik, lik = JMultiStage(), MultiStageLikelihood()
    assert lik.latent_dim == 3
    assert_close_scaled(lik.log_probability_density(torch.tensor(f_means), torch.tensor(y)).numpy(),
                        np.asarray(jlik.log_probability_density(jnp.asarray(f_means),
                                                                jnp.asarray(y))), RTOL)
    got = lik.variational_expectations(torch.tensor(f_means), torch.tensor(f_vars), torch.tensor(y))
    want = jlik.variational_expectations(jnp.asarray(f_means), jnp.asarray(f_vars), jnp.asarray(y))
    assert_close_scaled(got.numpy(), np.asarray(want), RTOL)


def test_sample_y_follows_the_decision_tree():
    n = 200_000
    f = np.array([0.3, -0.8, 1.1])
    y = MultiStageLikelihood().sample_y(torch.tensor(np.broadcast_to(f, (n, 3)).copy()),
                                        torch.Generator().manual_seed(0))[:, 0].numpy()
    p0, p1, rate = expit(f[0]), expit(f[1]), np.exp(f[2])
    for value, p in ((0.0, p0), (1.0, (1 - p0) * p1)):
        frac = np.mean(y == value)
        assert abs(frac - p) < 5 * np.sqrt(p * (1 - p) / n), (value, frac, p)
    counts = y[y >= 2] - 2.0
    assert abs(counts.mean() - rate) < 5 * np.sqrt(rate / counts.size)


def _jax_vgp():
    """docs/examples/multistage_demand.py:16-34."""
    rng = np.random.default_rng(11)
    t = jnp.asarray(np.sort(rng.uniform(0, 5, 80)))
    lik = JMultiStage()
    f_true = jnp.stack([jnp.sin(1.5 * t), jnp.cos(2.0 * t), 0.3 * t - 0.5], axis=-1)
    y = lik.sample_y(f_true, jax.random.PRNGKey(11))
    kernel = JIMO(kernels=tuple(JMatern32(lengthscale=jnp.asarray(1.0),
                                          variance=jnp.asarray(1.0)) for _ in range(3)))
    return JVGP.initialize(kernel, lik, t, y)


@functools.lru_cache(maxsize=None)
def _jax_run():
    vgp = _jax_vgp()
    step = jax.jit(lambda q, s: jnatgrad_step(vgp.loss, q, gamma=0.2, state=s))
    q, state, out = vgp.dist_q, jnatgrad_init(vgp.dist_q), []
    for _ in range(STEPS):
        q, state, loss = step(q, state)
        out.append(({f: np.asarray(getattr(q, f)) for f in SSM_FIELDS}, np.asarray(loss)))
    return out


def test_multistage_vgp_natgrad_matches_jax():
    ref = _jax_run()
    jvgp = _jax_vgp()
    lik = interop.likelihood_from_numpy({}, "cpu", name="MultiStageLikelihood")
    vgp = interop.vgp_from_numpy(to_np(jvgp), port_kernel(jvgp.kernel), lik, device="cpu")
    q, state = vgp.dist_q, natgrad_init(vgp.dist_q)
    for k, (fields, loss_ref) in enumerate(ref):
        q, state, loss = natgrad_step(vgp.loss, q, gamma=0.2, state=state)
        assert_close_scaled(loss.numpy(), loss_ref, NATGRAD_RTOL, err_msg=f"loss {k + 1}")
        for f in SSM_FIELDS:
            assert_close_scaled(getattr(q, f).numpy(), fields[f], NATGRAD_RTOL,
                                err_msg=f"{f}, step {k + 1}")
    assert float(ref[-1][1]) < float(ref[0][1])
