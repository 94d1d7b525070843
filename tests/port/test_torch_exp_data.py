"""The port's data generation and ``.npz`` format against the JAX
package's (exp/data.py).

``jax.random`` cannot be reproduced in torch, so the assembly is fed JAX's
own draws, re-derived from the four sub-keys of ``exp/data.py:53``; it
must then equal JAX's ``get_observations`` to 1e-12 (float64).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.exp import data as jdata
from vi_diffusion_processes_tpu.exp import runners as jrunners
from vi_diffusion_processes_tpu_torch.exp import data as pdata
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, make_dataset

FIELDS = ("latent_path", "time_grid", "obs_times", "obs_values", "test_times", "test_values",
          "x0")
NPZ_KEYS = {"sde", "decay", "Q", "x0", "sigma", "latent_process", "observations",
            "observation_grid", "time_grid", "test_observations", "test_grid"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_draws(seed, num_grid, n, d):
    """The four draws of JAX ``get_observations`` (exp/data.py:53-67)."""
    k_sim, k_idx, k_noise, k_split = jax.random.split(jax.random.PRNGKey(seed), 4)
    eps = jax.random.normal(k_sim, (num_grid - 1, d), jnp.float64)
    idx = jax.random.choice(k_idx, np.arange(1, num_grid - 1), (n,), replace=False)
    noise = jax.random.normal(k_noise, (n, d))
    perm = jax.random.permutation(k_split, n)
    return pdata.ObservationDraws(*(torch.tensor(np.array(x)) for x in (eps, idx, noise, perm)))


CASES = {
    "dw": dict(prior_sde="dw", q=0.8, num_grid=201, num_observations=30, noise_stddev=0.2,
               seed=3, t1=4.0),
    "ou": dict(prior_sde="ou", prior_sde_kwargs={"decay": 1.5}, q=1.0, num_grid=157,
               num_observations=21, noise_stddev=0.3, seed=11, t1=5.0),
    "vanderpol": dict(prior_sde="vanderpol", q=0.5, num_grid=120, num_observations=17,
                      noise_stddev=0.1, seed=5, t1=3.0),
}


@functools.lru_cache(maxsize=None)
def _jax_dataset(name):
    return jrunners.make_dataset(jrunners.ExperimentConfig(**CASES[name]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_assembly_from_jax_draws_equals_jax_get_observations(name):
    cfg = ExperimentConfig(**CASES[name])
    ref = _jax_dataset(name)
    d = ref.latent_path.shape[-1]
    draws = _jax_draws(cfg.seed, cfg.num_grid, cfg.num_observations, d)
    sde = pdata.build_prior_sde(cfg.prior_sde, q=cfg.q, device="cpu", **cfg.prior_sde_kwargs)
    grid = torch.linspace(cfg.t0, cfg.t1, cfg.num_grid, dtype=torch.float64)
    with torch.no_grad():
        got = pdata.assemble_observations(sde, draws, grid, torch.ones(d, dtype=torch.float64),
                                          cfg.noise_stddev)
    for field in FIELDS:
        a, b = _np(getattr(got, field)), np.asarray(getattr(ref, field))
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(1.0, np.abs(b).max()),
                                   err_msg=field)
    assert got.noise_stddev == ref.noise_stddev


@pytest.mark.parametrize("dt", [0.1, 0.05, 0.25, 1.0])
def test_modify_time_grid_equals_jax(dt):
    grid = np.linspace(0.0, 5.0, 37)
    ref = np.asarray(jdata.modify_time_grid(jnp.asarray(grid), dt))
    got = pdata.modify_time_grid(torch.tensor(grid), dt)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k_folds,seed", [(3, 0), (5, 2)])
def test_get_k_folds_equals_jax(k_folds, seed):
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 10, 23))
    y = rng.normal(size=(23, 1))
    ref_train, ref_test = jdata.get_k_folds(jnp.asarray(t), jnp.asarray(y), k_folds, seed)
    train, test = pdata.get_k_folds(torch.tensor(t), torch.tensor(y), k_folds, seed)
    for got, ref in ((train, ref_train), (test, ref_test)):
        assert len(got) == len(ref) == k_folds
        for (gt, gy), (rt, ry) in zip(got, ref):
            np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
            np.testing.assert_array_equal(gy.numpy(), np.asarray(ry))


def test_npz_written_by_jax_loads_into_the_port(tmp_path):
    ref = _jax_dataset("dw")
    path = tmp_path / "jax.npz"
    jdata.save_dataset_npz(path, ref, sde_name="dw", q=0.8)
    assert set(np.load(path).files) == NPZ_KEYS
    got = pdata.load_exp_data(path, device="cpu")
    for field in FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, field)), np.asarray(getattr(ref, field)))
    assert got.noise_stddev == ref.noise_stddev


def test_npz_written_by_the_port_loads_into_jax(tmp_path):
    ds = make_dataset(ExperimentConfig(**CASES["ou"]), device="cpu")
    path = tmp_path / "port.npz"
    pdata.save_dataset_npz(path, ds, sde_name="ou", q=1.0, decay=1.5)
    assert set(np.load(path).files) == NPZ_KEYS
    ref_path = tmp_path / "jax.npz"
    jdata.save_dataset_npz(ref_path, _jax_dataset("ou"), sde_name="ou", q=1.0, decay=1.5)
    mine, theirs = np.load(path), np.load(ref_path)
    for key in NPZ_KEYS:
        assert mine[key].shape == theirs[key].shape, key
        assert mine[key].dtype == theirs[key].dtype, key
    got = jdata.load_exp_data(path)
    for field in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)), _np(getattr(ds, field)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_make_dataset_is_reproducible(name):
    cfg = ExperimentConfig(**CASES[name])
    a = make_dataset(cfg, device="cpu")
    b = make_dataset(cfg, device="cpu")
    for field in FIELDS:
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert a.obs_times.shape[0] + a.test_times.shape[0] == cfg.num_observations
    assert bool(torch.all(a.obs_times[1:] > a.obs_times[:-1]))
    # interior points only, on the grid
    idx = torch.searchsorted(a.time_grid, torch.cat([a.obs_times, a.test_times]))
    assert bool(torch.all((idx > 0) & (idx < cfg.num_grid - 1)))
    assert torch.equal(a.time_grid[idx], torch.cat([a.obs_times, a.test_times]))


def test_make_dataset_depends_on_the_seed():
    a = make_dataset(ExperimentConfig(**CASES["dw"]), device="cpu")
    b = make_dataset(ExperimentConfig(**{**CASES["dw"], "seed": 4}), device="cpu")
    assert not torch.equal(a.latent_path, b.latent_path)


def test_get_observations_lands_on_the_named_device_and_needs_one():
    sde = pdata.build_prior_sde("dw", device="cpu")
    ds = pdata.get_observations(sde, torch.Generator().manual_seed(0), num_grid=50,
                                num_observations=5, device="cpu")
    assert all(x.device.type == "cpu" for x in ds if isinstance(x, torch.Tensor))
    with pytest.raises(ValueError):
        pdata.draw_observations(torch.Generator(), 10, 9, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pdata.get_observations(sde, torch.Generator(), num_grid=50, num_observations=5)
