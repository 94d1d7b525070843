"""The exact-GPR path on the card against the same calls on the CPU.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/port/test_torch_gpr_cuda.py --confcutdir=tests/port -m cuda

The path runs plain PyTorch on both devices, apart from the d = 1 marginals
of ``predict_f`` (kernel K2 on the card), so float64 results differ by the
rounding of the device's elementwise kernels and reductions: 1e-9 of each
output's scale.  float32 at the benchmark's step of 1e-3 is held against
float64 on the card at 1e-4 relative.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.exp.data import DPDataset
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_gpr
from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12, Matern32, Matern52
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts
from vi_diffusion_processes_tpu_torch.ops.blocked_scan import assoc_scan
from vi_diffusion_processes_tpu_torch.ops.btd import affine_scan
from vi_diffusion_processes_tpu_torch.parallel.pskf import filter_smoother_with_sites
from vi_diffusion_processes_tpu_torch.parallel.sites import gaussian_observation_sites

from .helpers import assert_close_scaled

pytestmark = pytest.mark.cuda

KERNELS = {
    1: lambda dtype: Matern12(2.0, 0.5, dtype=dtype),
    2: lambda dtype: Matern32(1.0, 1.0, dtype=dtype),
    4: lambda dtype: Matern52(1.0, 1.0, dtype=dtype) + Matern12(2.0, 0.5, dtype=dtype),
}


def _model(d, n, dtype, device, t1=10.0):
    rng = np.random.default_rng(d)
    t = np.linspace(0.0, t1, n)
    y = (np.sin(0.3 * t) + 0.3 * rng.normal(size=n))[:, None]
    noise = torch.tensor([[0.3]], dtype=dtype, device=device, requires_grad=True)
    kernel = KERNELS[d](dtype).to(device)
    model = GaussianProcessRegression(
        kernel, torch.tensor(t, dtype=dtype, device=device),
        torch.tensor(y, dtype=dtype, device=device), noise)
    return model, [*kernel.parameters(), noise]


def _compose(x, y):
    return y[0] @ x[0], (y[0] @ x[1][..., None])[..., 0] + y[1]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [1, 2, 7, 1000, 100_000])
def test_assoc_scan_on_the_card_matches_the_cpu(cuda_device, n, reverse):
    rng = np.random.default_rng(n)
    mats = torch.tensor(0.9 * rng.normal(size=(n, 3, 3)) / np.sqrt(3))
    vecs = torch.tensor(rng.normal(size=(n, 3)))
    want = assoc_scan(_compose, (mats, vecs), reverse=reverse)
    got = assoc_scan(_compose, (mats.to(cuda_device), vecs.to(cuda_device)), reverse=reverse)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert_close_scaled(g.cpu().numpy(), w.numpy(), 1e-11)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_matrix_affine_scan_on_the_card(cuda_device, reverse):
    rng = np.random.default_rng(5)
    t_mats = torch.tensor(0.9 * rng.normal(size=(5000, 2, 2)) / np.sqrt(2))
    c_vecs, x0 = torch.tensor(rng.normal(size=(5000, 2))), torch.tensor(rng.normal(size=(2,)))
    want = affine_scan(t_mats, c_vecs, x0, reverse=reverse)
    got = affine_scan(*(x.to(cuda_device) for x in (t_mats, c_vecs, x0)), reverse=reverse)
    assert_close_scaled(got.cpu().numpy(), want.numpy(), 1e-10)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_log_likelihood_gradients_and_smoother_match_the_cpu(cuda_device, d):
    results = []
    for device in (cuda_device, torch.device("cpu")):
        model, params = _model(d, 3000, torch.float64, device)
        loglik = model.log_likelihood()
        grads = torch.autograd.grad(loglik, params)
        with torch.no_grad():
            emission = model.kernel.generate_emission_model(model.time_points)
            nat1, nat2, _ = gaussian_observation_sites(
                emission.emission_matrix, model.chol_obs_covariance, model.observations)
            _, smooth = filter_smoother_with_sites(
                model.kernel.state_space_model(model.time_points), nat1, nat2)
            new = torch.linspace(-1.0, 11.0, 50, dtype=torch.float64, device=device)
            f_mean, f_var = model.posterior.predict_f(new)
        results.append((loglik.detach().cpu(), [g.cpu() for g in grads], smooth,
                        f_mean.cpu(), f_var.cpu()))
    (l_gpu, g_gpu, s_gpu, m_gpu, v_gpu), (l_cpu, g_cpu, s_cpu, m_cpu, v_cpu) = results
    np.testing.assert_allclose(float(l_gpu), float(l_cpu), rtol=1e-9)
    for a, b in zip(g_gpu, g_cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9)
    assert_close_scaled(s_gpu.means.cpu().numpy(), s_cpu.means.numpy(), 1e-9)
    assert_close_scaled(s_gpu.covs.cpu().numpy(), s_cpu.covs.numpy(), 1e-9)
    assert_close_scaled(m_gpu.numpy(), m_cpu.numpy(), 1e-9)
    assert_close_scaled(v_gpu.numpy(), v_cpu.numpy(), 1e-9)


@pytest.mark.parametrize("d", [2, 4])
def test_float32_at_the_benchmarks_step_is_finite_and_near_float64(cuda_device, d):
    """N = 100,000 on [0, 100]: Δt = 1e-3, where ``Q`` is of order Δt³."""
    values = []
    for dtype in (torch.float32, torch.float64):
        model, params = _model(d, 100_000, dtype, cuda_device, t1=100.0)
        loglik = model.log_likelihood()
        grads = torch.autograd.grad(loglik, params)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        values.append((float(loglik.detach()), [float(g) for g in grads]))
    (l32, g32), (l64, g64) = values
    assert np.isfinite(l32)
    np.testing.assert_allclose(l32, l64, rtol=1e-4)
    np.testing.assert_allclose(g32, g64, rtol=1e-2)


def test_run_gpr_on_the_card_launches_k2(cuda_device):
    rng = np.random.default_rng(0)
    grid = torch.linspace(0.0, 10.0, 2001, dtype=torch.float64, device=cuda_device)
    idx = torch.arange(20, 2000, 20, device=cuda_device)
    y = torch.tensor(np.sin(0.6 * grid[idx].cpu().numpy())[:, None]
                     + 0.2 * rng.normal(size=(len(idx), 1)), device=cuda_device)
    test = torch.arange(len(idx), device=cuda_device) % 5 == 0
    dataset = DPDataset(
        latent_path=torch.zeros_like(grid)[:, None], time_grid=grid,
        obs_times=grid[idx[~test]], obs_values=y[~test], test_times=grid[idx[test]],
        test_values=y[test], noise_stddev=0.2, x0=torch.zeros(1, device=cuda_device))
    before = launch_counts()["linear_recurrence"]
    out = run_gpr(ExperimentConfig(q=0.8), dataset)
    assert launch_counts()["linear_recurrence"] > before
    assert len(out["losses"]) == 60 and out["losses"][-1] < out["losses"][0]
    assert np.isfinite(out["nlpd"]) and np.isfinite(out["rmse"])
    assert next(out["kernel"].parameters()).device.type == "cuda"
