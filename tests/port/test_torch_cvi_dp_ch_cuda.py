"""The d = 2 CVI-DP path on the card against the same calls on the CPU.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/port/test_torch_cvi_dp_ch_cuda.py --confcutdir=tests/port -m cuda

The path is plain PyTorch on both devices (the Schur-segment UDU', the
matrix ``affine_scan``, the marginals scan) and reaches none of K1-K4; on
the card the quadrature KL is one kernel forward and one for its adjoint
(``ops/quad_kl.py``), which take the drift difference without the plain
expression's cancellation and sum the 400 points in another order.  So
float64 results differ by the rounding of the device's elementwise kernels,
reductions and GEMMs and by the plain path's cancellation (an emulation of
the kernel's arithmetic on the CPU moved the sites by 4e-11 of their scale
at this T): 1e-9 of each output's scale.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.ops.btd import BTD, btd_udu, btd_udu_parallel
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer

from .helpers import assert_close_scaled, vanderpol_model_port

pytestmark = pytest.mark.cuda

T = 500
FIELDS = ("g_nat1", "g_nat2d", "g_nat2s", "d_nat1", "d_nat2", "fx_mu", "fx_cov")


def _close(got, ref, rtol, err_msg=""):
    assert_close_scaled(got.detach().double().cpu().numpy(), ref.detach().double().cpu().numpy(),
                        rtol, err_msg=err_msg)


def _kernel_launches(device, steps):
    """K1-K4 never; on the card the quadrature KL's forward twice a step
    and its adjoint once."""
    on_card = torch.device(device).type == "cuda"
    return {k: {"quad_kl": 2 * steps, "quad_kl_adjoint": steps}.get(k, 0) if on_card else 0
            for k in launch_counts()}


def _steps(model, n=3):
    state, elbos = tch.pack_state_ch(model), []
    for _ in range(n):
        state, elbo = tch.packed_natgrad_step_ch(model, state, 0.2)
        elbos.append(elbo)
    return state, torch.stack(elbos)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_packed_ch_step_on_the_card_matches_the_cpu(cuda_device, dtype):
    reset_launch_counts()
    s_gpu, e_gpu = _steps(vanderpol_model_port(T, dtype, cuda_device))
    assert launch_counts() == _kernel_launches(cuda_device, 3)
    s_cpu, e_cpu = _steps(vanderpol_model_port(T, dtype, "cpu"))
    tol = 1e-9 if dtype == "float64" else 1e-4
    _close(e_gpu, e_cpu, tol, "ELBO")
    for name in FIELDS if dtype == "float64" else ("fx_mu", "fx_cov"):
        _close(getattr(s_gpu, name), getattr(s_cpu, name), tol, name)


@pytest.mark.parametrize("n", [2, 3, 2_000, 4_097])
def test_schur_udu_on_the_card_matches_the_sequential_recursion(cuda_device, n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, 2, 2))
    diag = a @ np.swapaxes(a, -1, -2) + 4.0 * np.eye(2)
    sub = -np.eye(2) + 0.3 * rng.normal(size=(n - 1, 2, 2))
    d_ref, u_ref = btd_udu(BTD(torch.tensor(diag), torch.tensor(sub)))
    d_gpu, u_gpu = btd_udu_parallel(BTD(torch.tensor(diag, device=cuda_device),
                                        torch.tensor(sub, device=cuda_device)))
    _close(d_gpu, d_ref, 1e-10, "D")
    _close(u_gpu, u_ref, 1e-10, "U")


def test_d2_trainer_on_the_card_matches_the_cpu(cuda_device):
    """The trainer's packed d = 2 route, re-linearization and re-basing."""
    results = []
    for device in (cuda_device, "cpu"):
        trainer = CVISitesTrainer(vanderpol_model_port(T, "float64", device), sites_lr=0.2,
                                  max_inner_iters=3, max_outer_iters=2)
        reset_launch_counts()
        results.append((trainer.optimize(), trainer.elbo_trace, trainer.model))
        counts = launch_counts()
        assert not any(v for k, v in counts.items() if not k.startswith("quad_kl"))
        if device == "cpu":
            assert not any(counts.values())
        else:  # every step and ELBO of the trainer took the kernels
            assert counts["quad_kl"] > 0 and counts["quad_kl_adjoint"] > 0
    (elbos, trace, model), (elbos_cpu, trace_cpu, model_cpu) = results
    np.testing.assert_allclose(elbos, elbos_cpu, rtol=1e-9)
    np.testing.assert_allclose(trace, trace_cpu, rtol=1e-9)
    _close(model.fx_covs, model_cpu.fx_covs, 1e-9, "fx_covs")
    for got, ref in zip(model.prior_nats, model_cpu.prior_nats):
        assert_close_scaled(got.cpu().numpy(), ref.numpy(), 1e-9)
