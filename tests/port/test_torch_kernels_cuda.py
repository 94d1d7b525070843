"""The CUDA kernels K1–K3 against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  The file imports no JAX, so it also runs on a machine without
it, as the README says:

    python -m pytest tests/port/test_torch_kernels_cuda.py --confcutdir=tests/port -m cuda

Tolerances: f64 kernels to 1e-10 relative (pivots) or 1e-11 of the scale
(recurrences), f32 recurrences to 2e-6 of the scale, and the f32
``dist_q`` planes to the TPU kernel's contract (rtol 2e-4, atol 1e-6).
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

from .helpers import affine_inputs, assert_close_scaled, naturals, riccati_inputs

pytestmark = pytest.mark.cuda

SIZES = [4097, 100_000]
NAMES = ["a", "b", "qv", "mu0", "p0v", "means", "vars"]


@pytest.mark.parametrize("n", SIZES)
def test_riccati_kernel_matches_plain(cuda_device, n):
    kd, b2 = (torch.tensor(v, device=cuda_device)
              for v in riccati_inputs(np.random.default_rng(n), n, (2,)))
    before = cs.riccati_d_sweep.launches
    got = cs.riccati_d_sweep(kd, b2)
    assert cs.riccati_d_sweep.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), cs.riccati_d_sweep_plain(kd, b2).cpu().numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", SIZES)
def test_linear_recurrence_kernel_matches_plain(cuda_device, n, dtype, reverse):
    t, c = (torch.tensor(v, device=cuda_device, dtype=dtype)
            for v in affine_inputs(np.random.default_rng(n), n, (2,)))
    x0 = torch.tensor([0.7, -0.3], device=cuda_device, dtype=dtype)
    got = cs.linear_recurrence(t, c, x0, reverse)
    ref = cs.linear_recurrence_plain(t, c, x0, reverse)
    assert_close_scaled(got.cpu(), ref.cpu(), 1e-11 if dtype == torch.float64 else 2e-6)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", SIZES)
def test_dist_q_kernel_matches_plain(cuda_device, n, out_dtype):
    nat = [torch.tensor(v, device=cuda_device)
           for v in naturals(np.random.default_rng(n), n, (2,))]
    got = cs.dist_q_1d_planes(*nat, out_dtype)
    ref = cs.dist_q_1d_planes_plain(*nat, out_dtype)
    for nm, g, r in zip(NAMES, got, ref):
        assert g.dtype == out_dtype, nm
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=2e-4, atol=1e-6, err_msg=nm)


def test_packed_step_on_card_matches_cpu(cuda_device):
    """Three float64 packed steps with the kernels against the plain
    versions on the CPU: association order is the only difference."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    n = 3000
    grid = np.linspace(0.0, 10.0, n)
    idx = np.arange(50, n - 1, 50)
    y = np.sign(np.sin(0.6 * grid[idx]))[:, None] + 0.2 * np.random.default_rng(0).normal(size=(len(idx), 1))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        model = CVISitesSDE.initialize(
            prior_ssm=None, time_grid=torch.tensor(grid, device=dev),
            input_data=(torch.tensor(grid[idx], device=dev), torch.tensor(y, device=dev)),
            likelihood=Gaussian(0.04).to(dev),
            prior_initial_state=GaussianState(torch.zeros(1, dtype=torch.float64, device=dev),
                                              torch.tensor([[0.8]], device=dev)),
            prior_sde=DoubleWellSDE(q=[[0.8]]).to(dev),
        ).set_linearized_prior()
        state = pack_state(model)
        for _ in range(3):
            state, elbo = packed_natgrad_step(model, state, 0.3)
        out.append((float(elbo), state))
    (e_card, s_card), (e_cpu, s_cpu) = out
    np.testing.assert_allclose(e_card, e_cpu, rtol=1e-9)
    for name in ("g_nat1", "g_nat2d", "g_nat2s", "fx_mu", "fx_var"):
        assert_close_scaled(getattr(s_card, name).cpu(), getattr(s_cpu, name), 1e-9, err_msg=name)
