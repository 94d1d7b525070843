"""Slices I and J on the card: the kernels through their custom ops,
``torch.export`` serving, the CLI with its default device, and the sharded
step on two gloo ranks sharing the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_slice_ij_cuda.py --confcutdir=tests/port -m cuda

The ops launch the same kernels as the wrappers, so they are held to the
kernel tests' limits against the plain versions (``test_torch_kernels_cuda.py``).
"""
import json

import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.ops import cuda_riccati, cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts

from .helpers import affine_inputs, all_launches, naturals, riccati_inputs

pytestmark = pytest.mark.cuda


def _on(dev, *arrays):
    return [torch.tensor(a, device=dev) for a in arrays]


def test_the_four_ops_against_their_plain_versions(cuda_device):
    rng = np.random.default_rng(0)
    n = 100_003
    kd, b2 = _on(cuda_device, *riccati_inputs(rng, n))
    t, c = _on(cuda_device, *affine_inputs(rng, n))
    nat1, nat2d, nat2s = _on(cuda_device, *naturals(rng, n))
    ops = torch.ops.vidp_torch
    reset_launch_counts()
    d = ops.riccati_d_sweep(kd, b2)
    x = ops.linear_recurrence(t, c, torch.zeros((), dtype=t.dtype, device=cuda_device), True)
    x32 = ops.linear_recurrence(t.float(), c.float(), torch.zeros((), device=cuda_device), False)
    covs, a, w, means, varis = ops.dist_q_1d_planes(nat1, nat2d, nat2s, torch.float64)
    d32 = ops.riccati_d_sweep_f32(kd.float(), b2.float())
    torch.cuda.synchronize()
    assert launch_counts() == all_launches(riccati_d_sweep=1, linear_recurrence=2,
                                           dist_q_1d_planes=1, riccati_d_sweep_f32=1)
    torch.testing.assert_close(d, cs.riccati_d_sweep_plain(kd, b2), rtol=1e-12, atol=0)
    torch.testing.assert_close(x, cs.linear_recurrence_plain(t, c, 0.0, True), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(x32, cs.linear_recurrence_plain(t.float(), c.float(), 0.0),
                               rtol=1e-4, atol=1e-4)
    ref = cs.dist_q_1d_planes_plain(nat1, nat2d, nat2s, torch.float64)
    got = cs._dist_q_outputs(covs, a, w, means, varis)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(d32, cuda_riccati.riccati_d_sweep_f32_plain(kd.float(), b2.float()),
                               rtol=1e-4, atol=0)


def test_exported_d1_predict_f_launches_k2_on_the_card(cuda_device):
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12
    from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
    from vi_diffusion_processes_tpu_torch.utils import serving

    rng = np.random.default_rng(1)
    t = torch.tensor(np.sort(rng.uniform(0, 10, 5_000)), device=cuda_device)
    y = torch.sin(t)[:, None] + 0.1 * torch.tensor(rng.normal(size=(5_000, 1)), device=cuda_device)
    model = GaussianProcessRegression(Matern12(0.7, 1.0).to(cuda_device), t, y,
                                      torch.tensor([[0.3]], dtype=torch.float64,
                                                   device=cuda_device))
    t_new = torch.linspace(-1.0, 11.0, 300, dtype=torch.float64, device=cuda_device)
    predict = serving.load_artifact(
        serving.export_jittable(lambda x: model.posterior.predict_f(x), t_new))
    reset_launch_counts()
    f_mu, f_var = predict(t_new)
    torch.cuda.synchronize()
    assert launch_counts()["linear_recurrence"] == 2
    with torch.no_grad():
        ref_mu, ref_var = model.posterior.predict_f(t_new)
    torch.testing.assert_close(f_mu, ref_mu, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(f_var, ref_var, rtol=1e-12, atol=1e-14)


def test_cli_runs_on_the_card_by_default(cuda_device, tmp_path, capsys):
    from vi_diffusion_processes_tpu_torch.exp import cli

    reset_launch_counts()
    assert cli.main(["run_cvi_dp", "num_grid=2001", "max_inner_iters=3", "max_outer_iters=2",
                     "--out", str(tmp_path / "m.jsonl")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(summary["nlpd"]) and np.isfinite(summary["rmse"])
    counts = launch_counts()
    assert counts["dist_q_1d_planes"] > 0 and counts["riccati_d_sweep"] > 0, counts
    assert cli.main(["run_sgpr", "num_grid=2001", "--out", str(tmp_path / "s.jsonl")]) == 0
    gpu = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["run_sgpr", "num_grid=2001", "--device", "cpu"]) == 0
    cpu = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose([gpu["nlpd"], gpu["rmse"]], [cpu["nlpd"], cpu["rmse"]], rtol=1e-6)


def test_dryrun_on_two_ranks_sharing_the_card(cuda_device):
    from vi_diffusion_processes_tpu_torch.parallel.dryrun import dryrun_multichip

    results = dryrun_multichip(2, "cuda", backend="gloo", t_sharded=8192, timeout=600)
    for r in results:
        launches = r["sharded_step"]["launches"]
        assert launches["riccati_d_sweep"] == 2 and launches["dist_q_1d_planes"] == 0
