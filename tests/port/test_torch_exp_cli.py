"""The port's experiment CLI against the JAX package's (exp/cli.py).

Both CLIs draw their dataset from the config seed, with generators that
differ; here the port's ``make_dataset`` is replaced by a read of the
``.npz`` that the JAX package draws, so the two runs see the same data and
their JSON summary and JSONL records agree: the same keys and steps, the
values to rtol 1e-6 (the limit of ``test_torch_exp_runners.py``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.exp import cli as jcli
from vi_diffusion_processes_tpu.exp import data as jdata
from vi_diffusion_processes_tpu.exp import runners as jrunners
from vi_diffusion_processes_tpu_torch.exp import cli
from vi_diffusion_processes_tpu_torch.exp.data import load_exp_data
from vi_diffusion_processes_tpu_torch.exp.logging import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OVERRIDES = {
    "run_cvi_dp": ["prior_sde=dw", "q=0.8", "max_inner_iters=4", "max_outer_iters=2"],
    "run_vdp": ["prior_sde=ou", "prior_sde_kwargs.decay=1.0", "vdp_lr=0.01",
                "vdp_warmup_steps=3", "max_outer_iters=1"],
    "run_gpr": ["prior_sde=ou", "q=1.2"],
    "run_sgpr": ["prior_sde=dw", "q=0.8", "num_inducing=5", "noise_stddev=1.0"],
}
DATA = ["t1=4.0", "num_grid=151", "num_observations=20", "noise_stddev=0.2", "seed=3"]


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture
def jax_dataset_for_the_port(monkeypatch, tmp_path):
    """Make the port's CLI read the dataset that JAX's ``make_dataset``
    draws for the same config."""
    def from_jax(config, device=None):
        fields = {k: v for k, v in vars(config).items()}
        jds = jrunners.make_dataset(jrunners.ExperimentConfig(**fields))
        path = tmp_path / "jax_data.npz"
        jdata.save_dataset_npz(path, jds)
        return load_exp_data(path, device=device)

    monkeypatch.setattr(cli, "make_dataset", from_jax)


@pytest.mark.parametrize("runner", sorted(OVERRIDES))
def test_cli_matches_jax(runner, tmp_path, capsys, jax_dataset_for_the_port):
    args = [runner, *DATA, *OVERRIDES[runner]]
    assert jcli.main(args + ["--out", str(tmp_path / "jax.jsonl")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--out", str(tmp_path / "port.jsonl"), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(ref) == ["nlpd", "rmse", "runner"]
    assert got["runner"] == ref["runner"] == runner
    np.testing.assert_allclose([got["nlpd"], got["rmse"]], [ref["nlpd"], ref["rmse"]], rtol=1e-6)
    mine, theirs = _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")
    assert len(mine) == len(theirs) >= 2
    assert [r["step"] for r in mine] == [r["step"] for r in theirs]
    assert [r["step"] for r in mine] == list(range(len(mine) - 1)) + [-1]
    for a, b in zip(mine, theirs):
        assert sorted(a) == sorted(b)
    np.testing.assert_allclose([r["objective"] for r in mine[:-1]],
                               [r["objective"] for r in theirs[:-1]], rtol=1e-6)
    np.testing.assert_allclose([mine[-1]["nlpd"], mine[-1]["rmse"]], [got["nlpd"], got["rmse"]])


def test_generate_data_matches_jax(tmp_path, capsys):
    args = ["generate_data", *DATA, "prior_sde=dw", "q=0.8"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax.npz")]) == 0
    ref = json.loads(capsys.readouterr().out.strip())
    assert cli.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip())
    assert sorted(got) == sorted(ref)
    assert {k: got[k] for k in ("runner", "n_obs", "n_grid")} == {
        k: ref[k] for k in ("runner", "n_obs", "n_grid")}
    mine, theirs = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for key in theirs.files:
        assert mine[key].shape == theirs[key].shape, key


def test_cli_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run_gpr", "num_grid=51", "num_observations=5"])


def test_cli_runs_as_a_module(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "vi_diffusion_processes_tpu_torch.exp", "run_gpr",
         "num_grid=101", "num_observations=12", "--out", str(tmp_path / "m.jsonl"),
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["runner"] == "run_gpr" and np.isfinite(summary["nlpd"])
    assert len(_records(tmp_path / "m.jsonl")) == 61


def test_metrics_logger_round_trip(tmp_path):
    log = MetricsLogger(tmp_path / "sub" / "m.jsonl", config={"a": 1})
    log.log(0, objective=1.5)
    log.log(1, objective=torch.tensor(2.5, dtype=torch.float64), rmse=np.float64(0.25))
    records = log.read()
    log.close()
    assert [r["step"] for r in records] == [0, 1]
    assert records[1]["objective"] == 2.5 and records[1]["rmse"] == 0.25
    assert all(r["wall_time"] >= 0 for r in records)
    assert MetricsLogger().read() == []
