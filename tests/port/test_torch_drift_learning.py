"""``run_cvi_dp`` with ``learn_prior_sde=True``: the port against the JAX
package on ``tests/integration/test_exp_harness.py:9-21,47-51``'s
configuration (double well, 101-point grid, 5 inner × 2 outer iterations),
on the dataset that JAX ``make_dataset`` draws, carried across as numpy
arrays.  The trainer takes discrete branches on ELBO comparisons, so the
run is in float64; the ELBO trace and the learned ``q_mat``, ``scale`` and
``c`` must match to rtol 1e-6, as the golden test holds the ELBOs.
"""
import numpy as np

from vi_diffusion_processes_tpu.exp.runners import ExperimentConfig as JConfig
from vi_diffusion_processes_tpu.exp.runners import make_dataset
from vi_diffusion_processes_tpu.exp.runners import run_cvi_dp as jax_run_cvi_dp
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_cvi_dp

from .helpers import to_np

PARAMS = ("q_mat", "scale", "c")


def test_run_cvi_dp_learns_the_drift_like_jax():
    """``tests/integration/test_exp_harness.py:9-21,47-51`` in float64."""
    config = dict(prior_sde="dw", q=0.8, learn_prior_sde=True, max_inner_iters=5,
                  max_outer_iters=2)
    jconfig = JConfig(**config, t1=2.0, num_grid=101, num_observations=20, noise_stddev=0.2)
    jdataset = make_dataset(jconfig)
    ref = jax_run_cvi_dp(jconfig, jdataset)
    dataset = interop.dataset_from_numpy(to_np(jdataset), device="cpu")
    out = run_cvi_dp(ExperimentConfig(**config), dataset)
    np.testing.assert_allclose(np.asarray(out["elbos"]), np.asarray(ref["elbos"]), rtol=1e-6)
    learned = interop.sde_params_to_numpy(out["learned_prior_sde"])
    assert sorted(learned) == sorted(PARAMS)
    for name, start in zip(PARAMS, ([[0.8]], 4.0, 1.0)):
        r = np.asarray(getattr(ref["learned_prior_sde"], name))
        np.testing.assert_allclose(learned[name], r, rtol=1e-6, err_msg=name)
        assert np.all(learned[name] != np.asarray(start)), name
