"""Slices G and H on the card against the same calls on the CPU, float64:
the generic and the packed spatio-temporal CVI steps at d = 6 (no kernel of
the port on their path), one natural-gradient step on a Matern12 VGP and
sparse PEP at d = 1 (kernels K1 and K2), and IWVI's log importance weights.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/port/test_torch_spatio_cuda.py --confcutdir=tests/port -m cuda

The card and the CPU differ by the rounding of their reductions and of
``index_add_``'s atomics, so results agree to 1e-9 of their scale.  Each
test asserts the launches the card made.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12, Matern32
from vi_diffusion_processes_tpu_torch.kernels.spatial import SpatialRBF
from vi_diffusion_processes_tpu_torch.likelihoods.discrete import Bernoulli
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.likelihoods.pep import PEPScalarLikelihood
from vi_diffusion_processes_tpu_torch.models.iwvi import ImportanceWeightedVI
from vi_diffusion_processes_tpu_torch.models.sparse_pep import SparsePowerExpectationPropagation
from vi_diffusion_processes_tpu_torch.models.spatio_packed import (
    pack_spatio,
    packed_spatio_site_step,
)
from vi_diffusion_processes_tpu_torch.models.spatio_temporal import SpatioTemporalSparseCVI
from vi_diffusion_processes_tpu_torch.models.variational import VariationalGaussianProcess
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.optim.natgrad import natgrad_step

from .helpers import assert_close_scaled

pytestmark = pytest.mark.cuda

RTOL = 1e-9
STEPS = 3
F64 = torch.float64


def _close(got, ref, err_msg=""):
    assert_close_scaled(got.detach().double().cpu().numpy(), ref.detach().double().cpu().numpy(),
                        RTOL, err_msg=err_msg)


def _spatio(device, n=600, mt=120):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(n, 1))
    t = np.sort(rng.uniform(0, 20.0, size=n))
    y = (np.sin(2 * t) * np.cos(3 * x[:, 0]) + 0.1 * rng.normal(size=n))[:, None]
    xy = (torch.tensor(np.concatenate([x, t[:, None]], -1), device=device),
          torch.tensor(y, device=device))
    model = SpatioTemporalSparseCVI.initialize(
        torch.linspace(0.05, 0.95, 3, dtype=F64, device=device)[:, None],
        torch.linspace(0.0, 20.0, mt, dtype=F64, device=device),
        SpatialRBF(1.0, 0.5).to(device), Matern32(2.0, 1.0).to(device),
        Gaussian(0.05).to(device), learning_rate=0.5)
    return model, xy


def _spatio_outputs(device):
    model, xy = _spatio(device)
    cache, state = pack_spatio(model, xy)
    generic = model
    for _ in range(STEPS):
        state = packed_spatio_site_step(model, cache, state)
        generic = generic.update_sites(xy)
    with torch.no_grad():
        return [generic.nat1, generic.nat2, generic.elbo(xy), state.nat1, state.nat2]


def test_spatio_steps_on_the_card_match_the_cpu(cuda_device):
    cs.reset_launch_counts()
    card = _spatio_outputs(cuda_device)
    torch.cuda.synchronize()
    assert not any(cs.launch_counts().values())  # d = 6: no kernel of the port
    for k, (a, b) in enumerate(zip(card, _spatio_outputs("cpu"))):
        _close(a, b, err_msg=f"output {k}")


def _natgrad(device):
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 20.0, 2_000))
    y = np.sin(2 * t)[:, None] + 0.2 * rng.normal(size=(2_000, 1))
    vgp = VariationalGaussianProcess.initialize(
        Matern12(0.7, 1.0).to(device), Gaussian(0.04).to(device), torch.tensor(t, device=device),
        torch.tensor(y, device=device))
    q1, _, loss = natgrad_step(vgp.loss, vgp.dist_q, gamma=1.0)
    with torch.no_grad():
        return [loss, vgp.elbo(q1), *q1.marginals()]


def test_natgrad_step_on_the_card_matches_the_cpu(cuda_device):
    cs.reset_launch_counts()
    card = _natgrad(cuda_device)
    torch.cuda.synchronize()
    counts = cs.launch_counts()
    assert counts["riccati_d_sweep"] > 0 and counts["linear_recurrence"] > 0, counts
    for a, b in zip(card, _natgrad("cpu")):
        _close(a, b)


def _sparse_pep(device):
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 1.0, 120)
    y = ((np.cos(t * 20.0) + rng.normal(size=120)) > 0).astype(float)[:, None]
    data = (torch.tensor(t, device=device), torch.tensor(y, device=device))
    model = SparsePowerExpectationPropagation.initialize(
        Matern12(0.15, 1.0).to(device), PEPScalarLikelihood(Bernoulli()),
        torch.linspace(0.0, 1.0, 25, dtype=F64, device=device), learning_rate=0.5)
    for _ in range(STEPS):
        model = model.update_sites(data)
    with torch.no_grad():
        return [model.nat1, model.nat2, model.log_norm, model.energy(data)]


def test_sparse_pep_on_the_card_matches_the_cpu(cuda_device):
    cs.reset_launch_counts()
    card = _sparse_pep(cuda_device)
    torch.cuda.synchronize()
    assert cs.launch_counts()["riccati_d_sweep"] > 0
    for a, b in zip(card, _sparse_pep("cpu")):
        _close(a, b)


def test_iwvi_log_weights_on_the_card_match_the_cpu(cuda_device):
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 4, 40))
    y = (np.sin(2 * t) + 0.3 * rng.normal(size=40))[:, None]
    samples = (rng.normal(size=(8, 40, 2)), rng.normal(size=(8, 12, 2)))
    out = []
    for device in (cuda_device, "cpu"):
        model = ImportanceWeightedVI.initialize(
            Matern32(0.8, 1.2).to(device), Gaussian(0.1).to(device),
            torch.linspace(0, 4, 12, dtype=F64, device=device))
        with torch.no_grad():
            out.append(model.log_importance_weights(
                *(torch.tensor(s, device=device) for s in samples),
                (torch.tensor(t, device=device), torch.tensor(y, device=device))))
    _close(*out)
