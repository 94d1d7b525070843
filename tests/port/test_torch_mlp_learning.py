"""Learning the MLP drift of ``prior_sde/mlpdrift.yaml`` (``1 → 3 (relu) →
1``): the port against the JAX package.

``run_cvi_dp`` with ``prior_sde="mlpdrift"`` and ``learn_prior_sde=True``
on double-well data, as the benchmark's configuration ``mlp1d_learn`` runs
it, cut to a 101-point grid and 5 inner × 2 outer iterations.  The JAX
runner draws its MLP from ``PRNGKey(0)``; the port's runner is handed the
same weights through ``interop.sde_from_numpy("MLPDrift", ...)``.  The run
is in float64 (the trainer branches on ELBO comparisons); the ELBO trace
and the five learned parameters match to rtol 1e-6, the limit of
``test_torch_drift_learning.py``, and each parameter moved.  Also: the
harness's ``build_prior_sde`` hands ``hidden`` and ``stddev`` to
``MLPDrift.initialize``.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.exp.data import build_prior_sde as jax_build_prior_sde
from vi_diffusion_processes_tpu.exp.runners import ExperimentConfig as JConfig
from vi_diffusion_processes_tpu.exp.runners import make_dataset
from vi_diffusion_processes_tpu.exp.runners import run_cvi_dp as jax_run_cvi_dp
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.exp import runners
from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_cvi_dp
from vi_diffusion_processes_tpu_torch.sde.zoo import MLPDrift

from .helpers import to_np

PARAMS = ("q_mat", "w1", "b1", "w2", "b2")


def test_run_cvi_dp_learns_the_mlp_drift_like_jax(monkeypatch):
    config = dict(prior_sde="mlpdrift", q=0.8, learn_prior_sde=True, max_inner_iters=5,
                  max_outer_iters=2)
    data = dict(t1=2.0, num_grid=101, num_observations=20, noise_stddev=0.2)
    jdataset = make_dataset(JConfig(prior_sde="dw", q=0.8, **data))
    ref = jax_run_cvi_dp(JConfig(**config, **data), jdataset)
    start = to_np(jax_build_prior_sde("mlpdrift", q=0.8))
    monkeypatch.setattr(runners, "build_prior_sde", lambda name, q, device, **kw: (
        interop.sde_from_numpy("MLPDrift", start, device=device)))
    dataset = interop.dataset_from_numpy(to_np(jdataset), device="cpu")
    out = run_cvi_dp(ExperimentConfig(**config), dataset)
    np.testing.assert_allclose(np.asarray(out["elbos"]), np.asarray(ref["elbos"]), rtol=1e-6)
    learned = interop.sde_params_to_numpy(out["learned_prior_sde"])
    assert sorted(learned) == sorted(PARAMS)
    for name in PARAMS:
        r = np.asarray(getattr(ref["learned_prior_sde"], name))
        np.testing.assert_allclose(learned[name], r, rtol=1e-6, err_msg=name)
        assert np.all(learned[name] != start[name]), name


@pytest.mark.parametrize("kwargs,hidden", [({}, 3), ({"hidden": 5, "stddev": 2.5}, 5)],
                         ids=["defaults", "given"])
def test_build_prior_sde_hands_on_the_widths(kwargs, hidden):
    """``hidden`` and ``stddev`` reach ``MLPDrift.initialize``; without them
    the MLP is 3 wide at scale 1, the bits of the draw as before."""
    sde = build_prior_sde("mlpdrift", q=0.5, device="cpu",
                          generator=torch.Generator().manual_seed(4), **kwargs)
    ref = MLPDrift.initialize(torch.Generator().manual_seed(4), [[0.5]],
                              **{"hidden": 3, "stddev": 1.0, **kwargs})
    assert sde.w1.shape == (1, hidden) and sde.w2.shape == (hidden, 1)
    got, want = dict(sde.named_parameters()), dict(ref.named_parameters())
    assert sorted(got) == sorted(want) == sorted(PARAMS)
    for name in PARAMS:
        assert torch.equal(got[name], want[name]), name
