"""The CVI models of the port's tests: the data of
tests/unit/test_cvi_packed.py:24-37 at n = 64, on the JAX side and the
port's, and the comparison of the generic step with the JAX package's.

One jitted JAX function per case takes a model one step on and evaluates it
(XLA shares the smoother of the two): three ``update_sites``, then
``posterior_marginals_f``, ``elbo`` and ``classic_elbo`` before the first
step and after the last, each to 1e-9 of its scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vi_diffusion_processes_tpu.kernels import Matern12 as JMatern12
from vi_diffusion_processes_tpu.kernels import Matern32 as JMatern32
from vi_diffusion_processes_tpu.likelihoods import Bernoulli as JBernoulli
from vi_diffusion_processes_tpu.likelihoods import Poisson as JPoisson
from vi_diffusion_processes_tpu.models import CVIGaussianProcess as JCVI
from vi_diffusion_processes_tpu_torch import interop

from .helpers import assert_close_scaled, cvi_data, port_kernel, to_np

N = 64
RTOL = 1e-9
STEPS = 3
#: name → (JAX kernel class, JAX likelihood class)
CASES = {
    "matern12-poisson": (JMatern12, JPoisson),
    "matern12-bernoulli": (JMatern12, JBernoulli),
    "matern32-poisson": (JMatern32, JPoisson),
    "matern32-bernoulli": (JMatern32, JBernoulli),
}


def jax_cvi(name: str, dtype=jnp.float64, lr: float = 0.3):
    """The JAX model of a case: lengthscale 1.2, variance 0.9."""
    kernel_cls, lik_cls = CASES[name]
    t, y = cvi_data(lik_cls.__name__)
    kernel = kernel_cls(lengthscale=jnp.asarray(1.2, dtype), variance=jnp.asarray(0.9, dtype))
    return JCVI.initialize(kernel, lik_cls(), jnp.asarray(t, dtype), jnp.asarray(y, dtype),
                           learning_rate=lr)


def port_cvi(jmodel):
    """The port's CPU twin of a JAX ``CVIGaussianProcess``."""
    lik = interop.likelihood_from_numpy(to_np(jmodel.likelihood), "cpu",
                                        name=type(jmodel.likelihood).__name__)
    return interop.cvi_from_numpy(to_np(jmodel), port_kernel(jmodel.kernel), lik, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX model's sites after each step and its evaluations before the
    first step and after the last."""
    model = jax_cvi(name)
    step_and_eval = jax.jit(lambda m: (m.update_sites(), m.posterior_marginals_f(), m.elbo(),
                                       m.classic_elbo()))
    sites, evals = [], []
    for _ in range(STEPS + 1):
        new, *values = step_and_eval(model)
        evals.append(jax.tree_util.tree_map(np.asarray, values))
        sites.append(tuple(np.asarray(x) for x in new.sites))
        model = new
    return sites[:STEPS], (evals[0], evals[STEPS])


def check_update_sites(name):
    sites, _ = jax_run(name)
    model = port_cvi(jax_cvi(name))
    for k, (nat1, nat2) in enumerate(sites):
        model = model.update_sites()
        assert_close_scaled(model.sites.nat1.numpy(), nat1, RTOL, err_msg=f"nat1, step {k + 1}")
        assert_close_scaled(model.sites.nat2.numpy(), nat2, RTOL, err_msg=f"nat2, step {k + 1}")


def check_evaluations(name):
    _, evals = jax_run(name)
    model = port_cvi(jax_cvi(name))
    for k, ((f_mu, f_var), elbo, classic) in enumerate(evals):
        if k:
            for _ in range(STEPS):
                model = model.update_sites()
        with torch.no_grad():
            (t_mu, t_var), t_elbo = model.posterior_marginals_f(), model.elbo()
            t_classic = model.classic_elbo()
        assert_close_scaled(t_mu.numpy(), f_mu, RTOL)
        assert_close_scaled(t_var.numpy(), f_var, RTOL)
        assert_close_scaled(t_elbo.numpy(), elbo, RTOL)
        assert_close_scaled(t_classic.numpy(), classic, RTOL)
