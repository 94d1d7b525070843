"""The port's runners, config and metrics against the JAX package's
(exp/runners.py, exp/metrics.py).

The runners run on a dataset that JAX ``make_dataset`` draws and that the
port reads back from the ``.npz`` JAX writes.  ELBO traces, NLPD and RMSE
agree to rtol 1e-6, the limit of the other runner tests
(``test_torch_drift_learning.py``, ``test_torch_goldens.py``,
``test_torch_run_gpr.py``): Adam's moments and the trainers' branches carry
the rounding of every step.
"""
import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vi_diffusion_processes_tpu.exp import data as jdata
from vi_diffusion_processes_tpu.exp import metrics as jmetrics
from vi_diffusion_processes_tpu.exp import runners as jrunners
from vi_diffusion_processes_tpu_torch.exp import metrics as pmetrics
from vi_diffusion_processes_tpu_torch.exp.data import load_exp_data
from vi_diffusion_processes_tpu_torch.exp.runners import (
    ExperimentConfig,
    parse_yaml_value,
    run_cvi_dp,
    run_sgpr,
    run_vdp,
)

DATA = dict(t1=4.0, num_grid=201, num_observations=30, noise_stddev=0.2, seed=3)
CONFIGS = {
    "run_cvi_dp": dict(prior_sde="dw", q=0.8, max_inner_iters=5, max_outer_iters=2),
    "run_vdp": dict(prior_sde="ou", prior_sde_kwargs={"decay": 1.0}, q=1.0, vdp_lr=0.01,
                    vdp_warmup_steps=3, max_outer_iters=2),
    # 20 observations of noise 1: Adam meets |ΔELBO| < 1e-2 well within its
    # 100 steps
    "run_sgpr": dict(prior_sde="dw", q=0.8, num_inducing=5, max_outer_iters=10,
                     num_observations=20, noise_stddev=1.0),
}
RUNNERS = {"run_cvi_dp": (run_cvi_dp, jrunners.run_cvi_dp),
           "run_vdp": (run_vdp, jrunners.run_vdp),
           "run_sgpr": (run_sgpr, jrunners.run_sgpr)}
ARTIFACTS = ("posteriors.npz", "training_statistics.npz", "learnt_prior_params.npz")


def _run(name, base):
    """(JAX result, port result) of one runner on JAX's dataset, which the
    port reads from the npz JAX writes; artifacts under ``base``."""
    config = CONFIGS[name]
    jds = jrunners.make_dataset(jrunners.ExperimentConfig(**{**DATA, **config}))
    jdata.save_dataset_npz(f"{base}/data.npz", jds, sde_name=config["prior_sde"], q=config["q"])
    ds = load_exp_data(f"{base}/data.npz", device="cpu")
    port, jax_fn = RUNNERS[name]
    jout = jax_fn(jrunners.ExperimentConfig(**config, output_dir=f"{base}/jax"), jds)
    out = port(ExperimentConfig(**config, output_dir=f"{base}/port"), ds)
    return jout, out


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    out = {}
    for name in RUNNERS:
        base = str(tmp_path_factory.mktemp(name))
        out[name] = (_run(name, base), base)
    return out


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runner_matches_jax(pairs, name):
    (jout, out), _ = pairs[name]
    assert len(out["elbos"]) == len(jout["elbos"])
    np.testing.assert_allclose(out["elbos"], np.asarray(jout["elbos"]), rtol=1e-6)
    np.testing.assert_allclose(out["nlpd"], jout["nlpd"], rtol=1e-6)
    np.testing.assert_allclose(out["rmse"], jout["rmse"], rtol=1e-6)


def test_run_sgpr_stops_where_jax_stops(pairs):
    (jout, out), _ = pairs["run_sgpr"]
    n = len(out["elbos"])
    assert n == len(jout["elbos"])
    assert n < 10 * CONFIGS["run_sgpr"]["max_outer_iters"], "stopped on |ΔELBO| < 1e-2"
    assert abs(out["elbos"][-1] - out["elbos"][-2]) < 1e-2
    assert out["elbos"][-1] > out["elbos"][0]


@pytest.mark.parametrize("name", ["run_cvi_dp", "run_vdp"])
def test_output_dir_writes_the_jax_key_set(pairs, name):
    (jout, out), base = pairs[name]
    expected = ARTIFACTS + (("cvi_model.npz",) if name == "run_cvi_dp" else ())
    for fname in expected:
        mine = np.load(f"{base}/port/{fname}")
        theirs = np.load(f"{base}/jax/{fname}")
        assert sorted(mine.files) == sorted(theirs.files), fname
        if fname == "learnt_prior_params.npz":
            # param_i in each package's own parameter order (the OU prior:
            # decay first in JAX's pytree, the diffusion first in the module)
            assert sorted(mine[k].size for k in mine.files) == sorted(
                theirs[k].size for k in theirs.files)
            continue
        for key in theirs.files:
            assert mine[key].shape == theirs[key].shape, (fname, key)
    stats = np.load(f"{base}/port/training_statistics.npz")
    np.testing.assert_allclose(stats["elbo"], out["elbos"])
    post = np.load(f"{base}/port/posteriors.npz")
    np.testing.assert_allclose(post["cvi_m"], np.load(f"{base}/jax/posteriors.npz")["cvi_m"],
                               rtol=1e-6, atol=1e-9)
    assert out["plots_written"]
    for png in ("objective.png", "posterior.png"):
        with open(f"{base}/port/{png}", "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_from_yaml_with_overrides_equals_jax(tmp_path):
    path = tmp_path / "exp.yaml"
    path.write_text("prior_sde: ou\nprior_sde_kwargs: {decay: 2.0}\nq: 0.5\nnum_grid: 301\n"
                    "clip_state_transitions: [-2.0, 2.0]\n")
    overrides = ["sites_lr=0.25", "prior_sde_kwargs.decay=3.0", "learn_prior_sde=yes",
                 "num_inducing=7", "output_dir=null", "clip_state_transitions=[-1.0, 0.5]",
                 "prior_sde_lr=1e-3", "vdp_lr=1.0e-3"]
    ref = jrunners.ExperimentConfig.from_yaml(path, overrides=overrides)
    got = ExperimentConfig.from_yaml(path, overrides=overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.prior_sde_lr == "1e-3"  # YAML 1.1: a float needs a dot, in both packages
    assert got.clip_state_transitions == (-1.0, 0.5)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ExperimentConfig()) == dataclasses.asdict(
        jrunners.ExperimentConfig())


@pytest.mark.parametrize("bad", ["nokey", "unknown_key=1"])
def test_overrides_reject_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jrunners.ExperimentConfig.from_yaml_overrides([bad])
    with pytest.raises(ValueError):
        ExperimentConfig.from_yaml_overrides([bad])


@pytest.mark.parametrize("text", [
    "true", "yes", "off", "null", "-1", "0.5", ".5", "1.0e-3", "1e-3", "dw", "[a,b]",
    "[-1.0, 1.0]", "", "~", "NO", "On", "0x1f", "017", "+3", "1_000", ".inf", "-.Inf",
    "1.", "3.0e+2", "1.0e3", "'quoted'", '"two words"', "[1, [2, 3]]", "[ ]", "[a, 'b,c']",
])
def test_override_parser_agrees_with_yaml(text):
    got, ref = parse_yaml_value(text), yaml.safe_load(text)
    assert got == ref and type(got) is type(ref)


@pytest.mark.parametrize("text", ["{a: 1}", "!!float 1", "12:30", "2001-12-14", "&a x"])
def test_override_parser_refuses_what_it_does_not_build(text):
    with pytest.raises(ValueError):
        parse_yaml_value(text)


def test_override_parser_reads_nan_as_yaml_does():
    assert np.isnan(parse_yaml_value(".nan")) and np.isnan(yaml.safe_load(".nan"))


@pytest.mark.parametrize("full", [True, False])
def test_calculate_nlpd_and_rmse_equal_jax(full):
    rng = np.random.default_rng(8)
    n, d = 40, 2
    grid = np.linspace(0.0, 4.0, n)
    m = rng.normal(size=(n, d))
    if full:
        l = rng.normal(size=(n, d, d))
        s = l @ l.transpose(0, 2, 1) + 0.1 * np.eye(d)
    else:
        s = rng.uniform(0.1, 1.0, size=(n, d))
    idx = np.sort(rng.choice(n, 9, replace=False))
    test = (grid[idx], rng.normal(size=(9, d)))
    ref = jmetrics.calculate_nlpd(jnp.asarray(m), jnp.asarray(s), jnp.asarray(grid),
                                  tuple(map(jnp.asarray, test)), 0.04)
    got = pmetrics.calculate_nlpd(torch.tensor(m), torch.tensor(s), torch.tensor(grid),
                                  tuple(map(torch.tensor, test)), 0.04)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    ref = jmetrics.calculate_rmse(jnp.asarray(m), jnp.asarray(grid), tuple(map(jnp.asarray, test)))
    got = pmetrics.calculate_rmse(torch.tensor(m), torch.tensor(grid), tuple(map(torch.tensor, test)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
