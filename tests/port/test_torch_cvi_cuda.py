"""Non-conjugate CVI on the card against the same calls on the CPU: the
generic step, the packed step (kernel K3 at d = 1), sparse CVI (kernels K1
and K2 at d = 1) and ``StateSpaceModel.sample`` (K2 at d = 1).

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/port/test_torch_cvi_cuda.py --confcutdir=tests/port -m cuda

float64 throughout: the card and the CPU differ by the rounding of their
reductions, of ``index_add_``'s atomics, of their ``exp`` and of the kernels
against their plain versions, so results agree to 1e-9 of their scale,
never bit for bit.  The one exception is the packed step at d = 2
(``PACKED_D2_RTOL``): it solves for the marginals in precision form, whose
entries grow as Δt⁻³ under Matern32, and on these inputs a one-ulp change of
the lengthscale moves its float64 outputs by up to 6.4e-8 of their scale in
the port and 1.4e-8 in the JAX package's packed step, on the CPU
(``python -m tests.port.packed_sensitivity [--jax]``, case
``card-test-N1000``), and on an H100 the card differs from the CPU by up to
6.6e-8.  Each test asserts the launches the card made.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12, Matern32
from vi_diffusion_processes_tpu_torch.likelihoods.discrete import Poisson
from vi_diffusion_processes_tpu_torch.models.cvi_packed import pack_cvi, packed_site_step
from vi_diffusion_processes_tpu_torch.models.sparse_cvi import SparseCVIGaussianProcess
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts

from .helpers import assert_close_scaled, cvi_model_port

pytestmark = pytest.mark.cuda

RTOL = 1e-9
PACKED_D2_RTOL = 3e-7
N = 1_000
STEPS = 3
CASES = [("Matern12", "Poisson"), ("Matern12", "Bernoulli"), ("Matern32", "Poisson"),
         ("Matern32", "Bernoulli")]
IDS = [f"{k}-{lik}" for k, lik in CASES]


def _close(got, ref, err_msg=""):
    assert_close_scaled(got.detach().double().cpu().numpy(), ref.detach().double().cpu().numpy(),
                        RTOL, err_msg=err_msg)


def _generic(kernel, likelihood, device):
    model = cvi_model_port(kernel, likelihood, N, device=device)
    for _ in range(STEPS):
        model = model.update_sites()
    with torch.no_grad():
        return model, model.posterior_marginals_f(), model.elbo(), model.classic_elbo()


@pytest.mark.parametrize("kernel,likelihood", CASES, ids=IDS)
def test_generic_cvi_on_the_card_matches_the_cpu(cuda_device, kernel, likelihood):
    reset_launch_counts()
    m_gpu, (mu_gpu, var_gpu), e_gpu, c_gpu = _generic(kernel, likelihood, cuda_device)
    counts = launch_counts()
    # update_sites and elbo launch no kernel; classic_elbo's KL takes q's
    # marginals, two K2 launches at d = 1
    assert counts == {**{k: 0 for k in counts},
                      "linear_recurrence": 2 if kernel == "Matern12" else 0}, counts
    m_cpu, (mu_cpu, var_cpu), e_cpu, c_cpu = _generic(kernel, likelihood, "cpu")
    _close(m_gpu.sites.nat1, m_cpu.sites.nat1, "nat1")
    _close(m_gpu.sites.nat2, m_cpu.sites.nat2, "nat2")
    for got, ref, what in ((mu_gpu, mu_cpu, "f mean"), (var_gpu, var_cpu, "f var"),
                           (e_gpu, e_cpu, "elbo"), (c_gpu, c_cpu, "classic elbo")):
        _close(got, ref, what)


def _packed(kernel, likelihood, device):
    model = cvi_model_port(kernel, likelihood, N, device=device)
    state = pack_cvi(model)
    for _ in range(STEPS):
        state = packed_site_step(model, state)
    return state


@pytest.mark.parametrize("kernel,likelihood", CASES, ids=IDS)
def test_packed_cvi_on_the_card_matches_the_cpu(cuda_device, kernel, likelihood):
    reset_launch_counts()
    s_gpu = _packed(kernel, likelihood, cuda_device)
    counts = launch_counts()
    # d = 1: one K3 in pack_cvi and one a step; d = 2: the Schur chain, no kernel
    k3 = STEPS + 1 if kernel == "Matern12" else 0
    assert counts == {**{k: 0 for k in counts}, "dist_q_1d_planes": k3}, counts
    fields = ("d_nat1", "d_nat2", "fx_mu", "fx_var")
    s_cpu = _packed(kernel, likelihood, "cpu")
    rtol = RTOL if kernel == "Matern12" else PACKED_D2_RTOL
    for name in fields:
        assert_close_scaled(getattr(s_gpu, name).cpu().numpy(), getattr(s_cpu, name).numpy(),
                            rtol, err_msg=name)


def _sparse(kernel_cls, device):
    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(0.0, 20.0, size=2_000))
    y = rng.poisson(np.exp(np.sin(0.9 * t) + 0.3))[:, None].astype(np.float64)
    data = (torch.tensor(t, device=device), torch.tensor(y, device=device))
    model = SparseCVIGaussianProcess.initialize(
        kernel_cls(lengthscale=1.3, variance=0.8).to(device), Poisson(),
        torch.linspace(-0.05, 20.05, 200, dtype=torch.float64, device=device), learning_rate=0.8)
    for _ in range(STEPS):
        model = model.update_sites(data)
    with torch.no_grad():
        return model, model.classic_elbo(data), model.predict_log_density(data)


@pytest.mark.parametrize("kernel_cls", [Matern12, Matern32], ids=["Matern12", "Matern32"])
def test_sparse_cvi_on_the_card_matches_the_cpu(cuda_device, kernel_cls):
    reset_launch_counts()
    m_gpu, e_gpu, p_gpu = _sparse(kernel_cls, cuda_device)
    counts = launch_counts()
    if kernel_cls is Matern12:
        # update_sites: dist_q (K1 and two K2) and the marginals (two K2);
        # classic_elbo: that twice more, and the KL's marginals (two K2);
        # predict_log_density: as update_sites
        want = {"riccati_d_sweep": STEPS + 3, "linear_recurrence": 4 * STEPS + 8 + 4}
    else:
        want = {}
    assert counts == {**{k: 0 for k in counts}, **want}, counts
    m_cpu, e_cpu, p_cpu = _sparse(kernel_cls, "cpu")
    _close(m_gpu.nat1, m_cpu.nat1, "nat1")
    _close(m_gpu.nat2, m_cpu.nat2, "nat2")
    _close(e_gpu, e_cpu, "classic elbo")
    _close(p_gpu, p_cpu, "predictive density")


@pytest.mark.parametrize("kernel_cls", [Matern12, Matern32], ids=["Matern12", "Matern32"])
def test_sample_on_the_card_has_the_marginals(cuda_device, kernel_cls):
    """8,192 joint samples of a prior chain at N = 200: mean and variance
    within 5 standard errors of ``marginals()``; K2 once at d = 1."""
    s = 8_192
    t = torch.linspace(0.0, 5.0, 200, dtype=torch.float64, device=cuda_device)
    ssm = kernel_cls(lengthscale=0.7, variance=1.3).to(cuda_device).state_space_model(t)
    with torch.no_grad():
        reset_launch_counts()
        samples = ssm.sample(torch.Generator(device=cuda_device).manual_seed(0), (s,))
        launches = launch_counts()["linear_recurrence"]
        means, covs = ssm.marginals()
    assert launches == (1 if kernel_cls is Matern12 else 0)
    samples, means = samples.cpu().numpy(), means.cpu().numpy()
    var = np.diagonal(covs.cpu().numpy(), axis1=-2, axis2=-1)
    assert np.all(np.abs(samples.mean(0) - means) < 5.0 * np.sqrt(var / s))
    assert np.all(np.abs(samples.var(0, ddof=1) - var) < 5.0 * var * np.sqrt(2.0 / (s - 1)))
