"""The port's exact GPR and its posterior process against the JAX package
(``run_gpr`` is in ``test_torch_run_gpr.py``).

Data from numpy seeds on an uneven grid whose gaps lie between 0.03 and
0.17 (over gaps of 1e-3 a Matern52 ``Q`` falls below the 1e-10 jitter, and
the gradient through its Cholesky factor then turns on the last digits: the
JAX package's own jitted and eager gradients differ by 2 % there); float64.  Log-likelihood, its
gradients and the predictions agree to rtol 1e-8 (the two sides differ in
how the tiny inverses are taken and in summation order, and the gradient
is a sum over 64 points).  New points include a training point (which must fall into the same
pair as ``jnp.searchsorted`` puts it), points before the first and after the
last training point, and interior points.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu import kernels as jk
from vi_diffusion_processes_tpu.models.gpr import GaussianProcessRegression as JGPR
from vi_diffusion_processes_tpu.ssm.conditionals import conditional_statistics as j_cond_stats
from vi_diffusion_processes_tpu.ssm.mean_functions import LinearMeanFunction as JLinear
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
from vi_diffusion_processes_tpu_torch.ssm.conditionals import conditional_statistics
from vi_diffusion_processes_tpu_torch.ssm.mean_functions import LinearMeanFunction

from .helpers import assert_close_scaled, port_kernel, to_np

A = jnp.asarray
N = 64
RTOL = 1e-8

#: name → (JAX kernel from a dict of leaves, the leaves, port parameter names)
CONFIGS = {
    "matern32": (
        lambda p: jk.Matern32(lengthscale=p["l"], variance=p["v"]),
        {"l": 1.5, "v": 0.8, "r": 0.3},
        {"l": "lengthscale", "v": "variance"},
    ),
    "matern52+matern12": (
        lambda p: jk.Matern52(lengthscale=p["l5"], variance=p["v5"])
        + jk.Matern12(lengthscale=p["l1"], variance=p["v1"]),
        {"l5": 1.0, "v5": 1.0, "l1": 2.0, "v1": 0.5, "r": 0.3},
        {"l5": "kernels.0.lengthscale", "v5": "kernels.0.variance",
         "l1": "kernels.1.lengthscale", "v1": "kernels.1.variance"},
    ),
    "ou": (
        lambda p: jk.OrnsteinUhlenbeck(decay=p["l"], diffusion=p["v"]),
        {"l": 0.9, "v": 1.3, "r": 0.25},
        {"l": "decay", "v": "diffusion"},
    ),
}


#: d = 1, 2 and 4, one of them with a linear mean function
CASES = [("ou", None), ("matern32", 0.05), ("matern52+matern12", None)]
CASE_IDS = [f"{name}-{'linear' if mean else 'zero'}-mean" for name, mean in CASES]


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(1)
    t = np.cumsum(rng.uniform(0.03, 0.17, size=N))
    y = (np.sin(0.7 * t) + 0.25 * rng.normal(size=N))[:, None]
    new = np.sort(np.concatenate([rng.uniform(t[0], t[-1], size=12),
                                  [-3.0, -0.5, t[0], t[37], t[-1], t[-1] + 0.5, t[-1] + 6.0]]))
    return t, y, new


def _models(name, mean_coefficient=None):
    make, params, _ = CONFIGS[name]
    t, y, _ = _data()
    jparams = {k: A(v) for k, v in params.items()}
    jmean = None if mean_coefficient is None else JLinear(coefficient=A(mean_coefficient))

    def jmodel(p):
        return JGPR(kernel=make(p), time_points=A(t), observations=A(y),
                    chol_obs_covariance=p["r"][None, None], mean_function=jmean)

    tmean = None if mean_coefficient is None else LinearMeanFunction(
        torch.tensor(mean_coefficient, dtype=torch.float64))
    noise = torch.tensor(params["r"], dtype=torch.float64, requires_grad=True)
    tmodel = GaussianProcessRegression(
        kernel=port_kernel(make(jparams)), time_points=torch.tensor(t),
        observations=torch.tensor(y), chol_obs_covariance=noise[None, None], mean_function=tmean)
    return jmodel, jparams, tmodel, noise


@pytest.mark.parametrize("name,mean", CASES, ids=CASE_IDS)
def test_log_likelihood_and_gradients(name, mean):
    jmodel, jparams, tmodel, noise = _models(name, mean)
    # value and gradient from two programs: XLA:CPU's fused value_and_grad of
    # this function at d = 4 is off by 2 % against central differences, which
    # jax.grad alone, eager JAX and the port all meet to 1e-8
    ref = jmodel(jparams).log_likelihood()  # eager: cheaper than a second compile
    ref_grads = jax.jit(jax.grad(lambda p: jmodel(p).log_likelihood()))(jparams)
    got = tmodel.log_likelihood()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL)
    np.testing.assert_allclose(float(tmodel.loss().detach()), -float(ref), rtol=RTOL)
    got.backward()
    grads = dict(tmodel.kernel.named_parameters())
    for key, pname in CONFIGS[name][2].items():
        np.testing.assert_allclose(float(grads[pname].grad), float(ref_grads[key]), rtol=RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(noise.grad), float(ref_grads["r"]), rtol=RTOL)


@pytest.mark.parametrize("name,mean", CASES, ids=CASE_IDS)
def test_predictions_at_new_points(name, mean):
    jmodel, jparams, tmodel, _ = _models(name, mean)
    new = _data()[2]
    (jf, jfv), (jy, jyv), (js, jsc) = jax.jit(lambda p: (
        jmodel(p).posterior.predict_f(A(new)), jmodel(p).posterior.predict_y(A(new)),
        jmodel(p).posterior.predict_state(A(new))))(jparams)
    with torch.no_grad():
        post = tmodel.posterior
        tn = torch.tensor(new)
        for got, ref in zip(post.predict_f(tn) + post.predict_y(tn) + post.predict_state(tn),
                            (jf, jfv, jy, jyv, js, jsc)):
            assert tuple(got.shape) == ref.shape
            assert_close_scaled(got.numpy(), np.asarray(ref), RTOL)
        full = post.predict_f(tn, full_output_cov=True)[1]
        assert tuple(full.shape) == (len(new), 1, 1)
        assert_close_scaled(full[..., 0].numpy(), np.asarray(jfv), RTOL)
        # y is noisier than f by the observation variance
        assert_close_scaled((post.predict_y(tn)[1] - post.predict_f(tn)[1]).numpy(),
                            np.full((len(new), 1), CONFIGS[name][1]["r"] ** 2), 1e-10)


def test_a_new_point_on_a_training_point_lands_in_the_same_pair():
    t, _, new = _data()
    jkernel = jk.Matern32(lengthscale=A(1.5), variance=A(0.8))
    jp, jt, jidx = j_cond_stats(A(new), A(t), jkernel)
    p, tt, idx = conditional_statistics(torch.tensor(new), torch.tensor(t), port_kernel(jkernel))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    on_grid = [i for i, x in enumerate(new) if x in t]
    assert len(on_grid) == 3
    assert [int(idx[i]) for i in on_grid] == [0, 37, N - 1]  # side="left"
    assert int(idx[0]) == 0 and int(idx[-1]) == N  # outside the grid: the padded pairs
    assert_close_scaled(p.detach().numpy(), np.asarray(jp), 1e-9)
    assert_close_scaled(tt.detach().numpy(), np.asarray(jt), 1e-9)


def test_smoothed_moments_match_the_posterior_ssm():
    jmodel, jparams, tmodel, _ = _models("matern52+matern12")
    j_means, j_covs = jax.jit(lambda p: jmodel(p).posterior_state_space_model().marginals())(
        jparams)
    with torch.no_grad():
        means, covs = tmodel.posterior_state_space_model().marginals()
    assert_close_scaled(means.numpy(), np.asarray(j_means), RTOL)
    assert_close_scaled(covs.numpy(), np.asarray(j_covs), RTOL)


def test_the_model_reads_its_kernel_at_call_time():
    """A training loop changes the kernel in place; the model caches nothing."""
    t, y, _ = _data()
    kernel = Matern32(1.5, 0.8)
    model = GaussianProcessRegression(kernel, torch.tensor(t), torch.tensor(y),
                                      torch.tensor([[0.3]], dtype=torch.float64))
    with torch.no_grad():
        first = float(model.log_likelihood())
        kernel.lengthscale.mul_(1.5)
        second = float(model.log_likelihood())
        fresh = float(model.replace(kernel=Matern32(2.25, 0.8)).log_likelihood())
    assert first != second
    assert second == fresh


def test_sampling_waits_for_its_slice():
    _, _, tmodel, _ = _models("ou")
    with torch.no_grad():
        post = tmodel.posterior
    for name in ("sample_state_trajectories", "sample_state", "sample_f"):
        with pytest.raises(NotImplementedError, match="D3"):
            getattr(post, name)(torch.zeros(2, dtype=torch.float64), None)


def test_gpr_from_numpy_round_trip():
    jmodel, jparams, tmodel, _ = _models("matern32")
    tree = {k: np.asarray(v) for k, v in to_np(jmodel(jparams)).items()
            if k in ("time_points", "observations", "chol_obs_covariance")}
    model = interop.gpr_from_numpy(tree, tmodel.kernel, device="cpu")
    with torch.no_grad():
        assert float(model.log_likelihood()) == float(tmodel.log_likelihood())
    with pytest.raises(NotImplementedError, match="slice H"):
        interop.kernel_from_numpy("PiecewiseKernel", {}, device="cpu")


def test_entry_points_raise_without_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    leaves = {"lengthscale": np.asarray(1.0), "variance": np.asarray(1.0)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.kernel_from_numpy("Matern32", leaves)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.gpr_from_numpy({}, kernel=None)
    assert interop.kernel_from_numpy("Matern32", leaves, device="cpu").state_dim == 2
