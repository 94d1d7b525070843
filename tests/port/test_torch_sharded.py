"""Time sharding on ``torch.distributed``: the port's sharded filter and
smoother, sharded ``dist_q`` and sharded natgrad step against the JAX
package's unsharded functions, on 2 and 4 gloo ranks (spawned processes,
a file store, a 60 s group timeout and a join deadline), and the
multi-process dry run.

Lengths that no rank count divides: 23 filter points, 601 grid points.
Limits: the filter and smoother and ``dist_q`` 1e-10 (float64, the two
differ in scan association only); the natgrad step 1e-8 on the ELBO and
1e-6 on the sites, relative, the limits of ``__graft_entry__.py:284-285``;
the K1 boundary fold 1e-13 against one unsharded sweep.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vi_diffusion_processes_tpu.kernels import matern as jmatern
from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.models import cvi_dp_packed as jp
from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE as JCVISitesSDE
from vi_diffusion_processes_tpu.parallel.pskf import filter_smoother_with_sites
from vi_diffusion_processes_tpu.sde.utils import Gaussian as JGaussian
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu_torch.ops.cuda_scan import riccati_d_sweep_plain
from vi_diffusion_processes_tpu_torch.parallel.dryrun import failed_checks, run_ranks

from . import sharded_workers
from .helpers import riccati_inputs, to_np

N_FILTER, T_GRID, LR = 23, 601, 0.5
#: lengths that leave trailing ranks short (5, 7 on 4 ranks) or empty (1, 2)
UNEVEN = (1, 2, 4, 5, 7)
KERNELS = ("Matern32", "Matern52")  # d = 2 and 3
#: a spawned group's deadline: a hung rendezvous fails its test
TIMEOUT = 240


def _filter_inputs(seed, d):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 5, N_FILTER))
    l = rng.normal(size=(N_FILTER, d, d))
    return t, rng.normal(size=(N_FILTER, d)), 0.3 * l @ l.transpose(0, 2, 1)


@functools.lru_cache(maxsize=None)
def _jax_model():
    grid = jnp.linspace(0.0, 10.0, T_GRID)
    rng = np.random.default_rng(0)
    obs_idx = np.arange(10, T_GRID - 1, 12)
    obs_y = jnp.asarray(np.sign(np.sin(0.6 * np.asarray(grid[obs_idx])))[:, None]
                        + 0.2 * rng.normal(size=(len(obs_idx), 1)))
    model = JCVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid, input_data=(grid[obs_idx], obs_y),
        likelihood=JGaussianLik(variance=jnp.asarray(0.04)),
        prior_initial_state=JGaussian(mu=jnp.zeros((1,)), cov=jnp.asarray([[0.8]])),
        prior_sde=JDoubleWell(q_mat=jnp.asarray([[0.8]])),
    )
    model = jax.jit(lambda m: m.set_linearized_prior())(model)
    step = jax.jit(jp.packed_natgrad_step)
    state0 = jax.jit(jp.pack_state)(model)
    # one step first, so that the sites the checks start from are not zero
    state1, _ = step(model, state0, LR)
    state2, elbo2 = step(model, state1, LR)
    dist_q = jax.jit(lambda s: jp._dist_q_1d(s, jnp.float64))(state1)
    return model, state1, (state2, elbo2), dist_q


@functools.lru_cache(maxsize=None)
def _results(world):
    model, state1, _, _ = _jax_model()
    rng = np.random.default_rng(12)
    kd, b2 = riccati_inputs(rng, 97)
    inputs = {
        "smoother": {name: _filter_inputs(i, d) for i, (name, d) in enumerate(zip(KERNELS, (2, 3)))},
        "model": to_np(model), "state": to_np(state1), "lr": LR, "fold": (kd, b2),
        "uneven": UNEVEN,
    }
    if world == 2:  # dryrun_multichip's checks, in the same group
        inputs["dryrun"] = {"batch": 4, "t_batched": 64, "t_sharded": 2048, "t_smoother": 301}
    return run_ranks(sharded_workers.sharded_checks, world, inputs, timeout=TIMEOUT), inputs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_filter_and_smoother_equal_jax(world, kernel):
    results, inputs = _results(world)
    t, nat1, nat2 = inputs["smoother"][kernel]
    jkernel = getattr(jmatern, kernel)(lengthscale=jnp.asarray(0.7), variance=jnp.asarray(1.3))
    filt, smooth = filter_smoother_with_sites(jkernel.state_space_model(jnp.asarray(t)),
                                              jnp.asarray(nat1), jnp.asarray(nat2))
    ref = {f"filter_{k}": getattr(filt, k) for k in filt._fields}
    ref.update({f"smoother_{k}": getattr(smooth, k) for k in ("means", "covs", "gains")})
    for r in results:
        got = r[f"smoother_{kernel}"]
        assert sorted(got) == sorted(ref)
        for key, value in ref.items():
            np.testing.assert_allclose(got[key].numpy(), np.asarray(value), rtol=0,
                                       atol=1e-10 * max(1.0, float(jnp.abs(value).max())),
                                       err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_dist_q_equals_the_unsharded_and_jax(world):
    results, _ = _results(world)
    (ja, jb, jqv, _, _), jmeans, jvars = _jax_model()[3]
    ref = [np.asarray(x) for x in (ja, jb, jqv, jmeans, jvars)]
    for r in results:
        for name, got, mine, theirs in zip(("a", "b", "qv", "means", "vars"),
                                           r["dist_q"]["sharded"], r["dist_q"]["unsharded"], ref):
            scale = max(1.0, np.abs(theirs).max())
            np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=0, atol=1e-10 * scale,
                                       err_msg=name)
            np.testing.assert_allclose(got.numpy(), theirs, rtol=0, atol=1e-10 * scale,
                                       err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_natgrad_step_equals_jax(world):
    results, _ = _results(world)
    jstate, jelbo = _jax_model()[2]
    for r in results:
        assert abs(r["step"]["elbo"] - float(jelbo)) <= 1e-8 * abs(float(jelbo))
        for name, got in r["step"]["state"].items():
            ref = np.asarray(getattr(jstate, name))
            err = np.max(np.abs(got.numpy() - ref) / (1.0 + np.abs(ref)))
            assert err <= 1e-6, (name, err)
    assert len({r["step"]["elbo"] for r in results}) == 1  # the all_reduce'd ELBO


@pytest.mark.parametrize("world", [2, 4])
def test_k1_boundary_fold_equals_one_sweep(world):
    results, inputs = _results(world)
    import torch

    kd, b2 = inputs["fold"]
    ref = riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2)).numpy()
    for r in results:
        np.testing.assert_allclose(r["fold"].numpy(), ref, rtol=1e-13)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n", UNEVEN)
def test_uneven_and_empty_chunks_round_trip(world, n):
    results, _ = _results(world)
    for r in results:
        assert r["uneven"][n]["full"].tolist() == [2.0 * i for i in range(n)]
        assert r["uneven"][n]["pairs"].tolist() == [float(i) for i in range(1, n)]


def test_dryrun_multichip_on_two_cpu_ranks():
    """``dryrun_multichip(2, "cpu")``'s checks, run by the two-rank group of
    the other tests."""
    results = [r["dryrun"] for r in _results(2)[0]]
    assert len(results) == 2
    assert failed_checks(results) == []
    for r in results:
        assert all(rec["ok"] for rec in r.values())
        assert r["sharded_step"]["err_elbo"] <= 1e-8
    assert results[0]["outer"]["params"] == results[1]["outer"]["params"]


def test_a_rank_that_fails_fails_the_group():
    with pytest.raises(Exception):
        run_ranks(sharded_workers.uneven_chunks, 2, "not a length", timeout=TIMEOUT)
