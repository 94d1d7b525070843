"""The spatio-temporal CVI models of the port's tests, on the JAX side and
the port's: the data and model of tests/unit/test_spatio_packed.py:24-40
(n = 150 points on [0, 10] with one spatial coordinate in [0, 1], Mt = 60
inducing times, ``m_space`` spatial inducing points, RBF(1, 0.5) in space,
Matern32(2, 1) in time, Gaussian(0.05), lr 0.5, float64), and the runs of
the JAX package's steps that the port is held against.

Each JAX function is jitted once with the model as an argument, so the
sorted and the shuffled data share one compile per shape.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vi_diffusion_processes_tpu.kernels.matern import Matern32 as JMatern32
from vi_diffusion_processes_tpu.kernels.spatial import SpatialRBF as JSpatialRBF
from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussian
from vi_diffusion_processes_tpu.models.spatio_temporal import SpatioTemporalSparseCVI as JCVI
from vi_diffusion_processes_tpu_torch import interop

from .helpers import port_kernel, to_np

N, MT, STEPS = 150, 60, 3


def data(order: str = "sorted"):
    """``(inputs [N, 2], y [N, 1])`` as numpy, the time last; ``"shuffled"``
    permutes the rows of the sorted data."""
    rng = np.random.default_rng(4)
    x_space = rng.uniform(0, 1, size=(N, 1))
    t = np.sort(rng.uniform(0, 10.0, size=N))
    y = (np.sin(2 * t) * np.cos(3 * x_space[:, 0]) + 0.1 * rng.normal(size=N))[:, None]
    inputs = np.concatenate([x_space, t[:, None]], axis=-1)
    if order == "shuffled":
        perm = np.random.default_rng(5).permutation(N)
        inputs, y = inputs[perm], y[perm]
    return inputs, y


def jax_data(order: str = "sorted"):
    return tuple(jnp.asarray(x) for x in data(order))


def port_data(order: str = "sorted"):
    return tuple(torch.tensor(x) for x in data(order))


def jax_model(m_space: int):
    return JCVI.initialize(
        jnp.linspace(0.05, 0.95, m_space)[:, None],
        jnp.linspace(0.0, 10.0, MT),
        JSpatialRBF(variance=jnp.asarray(1.0), lengthscale=jnp.asarray(0.5)),
        JMatern32(lengthscale=jnp.asarray(2.0), variance=jnp.asarray(1.0)),
        JGaussian(variance=jnp.asarray(0.05)),
        learning_rate=0.5,
    )


def port_model(m_space: int):
    """The port's CPU twin of :func:`jax_model`."""
    jmodel = jax_model(m_space)
    lik = interop.likelihood_from_numpy(to_np(jmodel.likelihood), "cpu")
    return interop.spatio_cvi_from_numpy(to_np(jmodel), port_kernel(jmodel.kernel), lik,
                                         device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_step_and_eval():
    return jax.jit(lambda m, xy: (m.update_sites(xy), m.elbo(xy), m.space_time_predict_f(xy[0]),
                                  m.predict_log_density(xy)))


@functools.lru_cache(maxsize=None)
def jax_generic(m_space: int, order: str = "sorted"):
    """The JAX generic step: the sites after each of STEPS steps, and the
    ELBO, ``space_time_predict_f`` and ``predict_log_density`` before the
    first step and after the last."""
    xy = jax_data(order)
    model, sites, evals = jax_model(m_space), [], []
    for _ in range(STEPS + 1):
        new, *values = _jax_step_and_eval()(model, xy)
        sites.append((np.asarray(new.nat1), np.asarray(new.nat2)))
        evals.append(jax.tree_util.tree_map(np.asarray, values))
        model = new
    return sites[:STEPS], (evals[0], evals[STEPS])


@functools.lru_cache(maxsize=None)
def _jax_pack():
    from vi_diffusion_processes_tpu.models.spatio_packed import pack_spatio

    return jax.jit(pack_spatio)


@functools.lru_cache(maxsize=None)
def _jax_packed_step(compute: str):
    from vi_diffusion_processes_tpu.models.spatio_packed import packed_spatio_site_step

    dtype = getattr(jnp, compute)
    return jax.jit(lambda m, c, s: packed_spatio_site_step(m, c, s, dtype))


def jax_pack(m_space: int, order: str = "sorted"):
    """The JAX ``(cache, state)`` of ``pack_spatio`` (jitted at this small
    size only)."""
    return _jax_pack()(jax_model(m_space), jax_data(order))


@functools.lru_cache(maxsize=None)
def jax_packed(m_space: int, order: str = "sorted", compute: str = "float64"):
    """The JAX packed state ``(nat1, nat2 [Mt+1, 2d, 2d])`` after each of
    STEPS steps."""
    from vi_diffusion_processes_tpu.models.spatio_packed import unpack_spatio

    model = jax_model(m_space)
    cache, state = jax_pack(m_space, order)
    out = []
    for _ in range(STEPS):
        state = _jax_packed_step(compute)(model, cache, state)
        restored = unpack_spatio(model, state)
        out.append((np.asarray(restored.nat1), np.asarray(restored.nat2)))
    return out
