"""The port's utilities against the JAX package's: checkpoints, tracing,
the float policy, validation and the host C++ binding (serving is in
``test_torch_serving.py``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu import config as jconfig
from vi_diffusion_processes_tpu.kernels import matern as jmatern
from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussian
from vi_diffusion_processes_tpu.models.cvi import CVIGaussianProcess as JCVI
from vi_diffusion_processes_tpu.utils import checkpoint as jcheckpoint
from vi_diffusion_processes_tpu.utils import native as jnative
from vi_diffusion_processes_tpu.utils.validation import check_positive as jcheck_positive
from vi_diffusion_processes_tpu_torch import config
from vi_diffusion_processes_tpu_torch.kernels import matern
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.cvi import CVIGaussianProcess
from vi_diffusion_processes_tpu_torch.utils import checkpoint, native, tracing
from vi_diffusion_processes_tpu_torch.utils.validation import check_positive



def _cvi_pair(seed=0):
    """The JAX test's model (tests/unit/test_conditionals_extra.py:68-95)
    after one ``update_sites``, on both sides."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 3, 12))
    y = rng.normal(size=(12, 1))
    jm = JCVI.initialize(jmatern.Matern32(lengthscale=jnp.asarray(0.8), variance=jnp.asarray(1.0)),
                         JGaussian(variance=jnp.asarray(0.1)), jnp.asarray(t), jnp.asarray(y))
    jm = jax.jit(lambda m: m.update_sites())(jm)
    pm = CVIGaussianProcess.initialize(matern.Matern32(0.8, 1.0), Gaussian(0.1),
                                       torch.tensor(t), torch.tensor(y))
    return jm, pm, pm.update_sites()


def test_checkpoint_round_trip_of_cvi(tmp_path):
    jm, template, model = _cvi_pair()
    path = tmp_path / "ckpt.pt"
    checkpoint.save_checkpoint(path, model)
    restored = checkpoint.restore_checkpoint(path, template)
    assert restored is not model and restored.kernel is not template.kernel
    for name in ("nat1", "nat2"):
        np.testing.assert_allclose(getattr(restored.sites, name), getattr(model.sites, name),
                                   rtol=1e-12)
    with torch.no_grad():
        elbo, ref = float(restored.elbo()), float(model.elbo())
    np.testing.assert_allclose(elbo, ref, rtol=1e-12)
    np.testing.assert_allclose(elbo, float(jm.elbo()), rtol=1e-9)
    assert float(template.sites.nat1.abs().sum()) == 0.0  # the template is left alone


def test_checkpoint_restores_onto_the_templates_device_and_dtype(tmp_path):
    _, template, model = _cvi_pair(1)
    path = tmp_path / "ckpt.pt"
    checkpoint.save_checkpoint(path, model)
    flat = torch.load(path, weights_only=True)
    assert set(flat) >= {"kernel.lengthscale", "kernel.variance", "likelihood.variance",
                         "sites.nat1", "sites.nat2", "time_points", "observations"}
    restored = checkpoint.restore_checkpoint(path, template)
    assert restored.sites.nat1.dtype == template.sites.nat1.dtype
    assert restored.sites.nat1.device == template.sites.nat1.device
    with pytest.raises(KeyError):
        checkpoint.restore_checkpoint(path, {"missing": torch.zeros(2)})


def test_checkpoint_of_named_tuples_and_containers(tmp_path):
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, make_dataset

    ds = make_dataset(ExperimentConfig(num_grid=60, num_observations=6), device="cpu")
    tree = {"data": ds, "trace": [1.5, 2.5], "array": np.arange(3.0)}
    checkpoint.save_checkpoint(tmp_path / "c.pt", tree)
    back = checkpoint.restore_checkpoint(tmp_path / "c.pt", tree)
    assert type(back["data"]) is type(ds) and back["trace"] == [1.5, 2.5]
    assert all(torch.equal(a, b) for a, b in zip(back["data"], ds) if isinstance(a, torch.Tensor))
    np.testing.assert_array_equal(back["array"], np.arange(3.0))


def test_save_npz_artifacts_keys_equal_jax(tmp_path):
    jm, _, model = _cvi_pair()
    jcheckpoint.save_npz_artifacts(str(tmp_path / "j.npz"), sites_nat1=jm.sites.nat1,
                                   sites=jm.sites, trace=[1.0, 2.0])
    checkpoint.save_npz_artifacts(str(tmp_path / "p.npz"), sites_nat1=model.sites.nat1,
                                  sites=model.sites, trace=[1.0, 2.0])
    mine, theirs = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for key in theirs.files:
        assert mine[key].shape == theirs[key].shape
    np.testing.assert_allclose(mine["sites_nat1"], np.asarray(jm.sites.nat1), rtol=1e-9)


def test_trace_to_writes_an_annotated_region(tmp_path):
    with tracing.trace_to(tmp_path / "trace") as prof:
        with tracing.annotate("vidp_region"):
            torch.cumsum(torch.ones(64), 0)
    text = (tmp_path / "trace" / tracing.TRACE_FILE).read_text()
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert "vidp_region" in names
    assert any(e.key == "vidp_region" for e in prof.key_averages())


def test_set_default_float():
    jax_before = jconfig.default_float()
    assert config.default_float() == torch.float64
    try:
        config.set_default_float(torch.float32)
        jconfig.set_default_float(jnp.float32)
        assert config.default_float() == torch.float32
        assert config.default_jitter() == jconfig.default_jitter() == 1e-6
    finally:
        config.set_default_float(None)
        jconfig.set_default_float(None)
    assert config.default_float() == torch.float64 and jconfig.default_float() == jax_before
    with config.enable_x64(False):
        assert config.default_float() == torch.float32


@pytest.mark.parametrize("value", [1.0, 0.0, -1.0, [1.0, 2.0], [1.0, -2.0], 3, 0, None,
                                   np.array([True, False]), np.array([[0.5]])])
def test_check_positive_raises_where_jax_raises(value):
    def raises(fn, v):
        try:
            fn(v, "x")
        except ValueError as err:
            return str(err)
        return None

    assert raises(check_positive, value) == raises(jcheck_positive, value)


def test_kernels_and_likelihoods_share_the_check():
    with pytest.raises(ValueError, match="lengthscale must be positive"):
        matern.Matern32(-0.5, 1.0)
    with pytest.raises(ValueError, match="variance must be positive"):
        Gaussian(0.0)


@pytest.fixture(scope="module")
def btd():
    rng = np.random.default_rng(6)
    n, d = 20, 3
    diag = rng.normal(size=(n, d, d))
    diag = diag @ np.swapaxes(diag, -1, -2) + 2 * d * np.eye(d)
    return diag, 0.3 * rng.normal(size=(n - 1, d, d))


def test_native_library_builds():
    assert native.native_available() == jnative.native_available()


def test_native_cholesky_and_inverse_equal_jax_binding(btd):
    mine = native.btd_cholesky_native(*btd)
    theirs = jnative.btd_cholesky_native(*btd)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(native.btd_blocks_of_inverse_native(*mine),
                    jnative.btd_blocks_of_inverse_native(*theirs)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(np.linalg.LinAlgError):
        native.btd_cholesky_native(-np.eye(2)[None].repeat(3, axis=0), np.zeros((2, 2, 2)))


@pytest.mark.parametrize("drift,params", [("ou", (1.0,)), ("dw", (4.0, 1.0)),
                                          ("benes", (1.0,)), ("sine", (0.3,)),
                                          ("sqrt", (1.0,))])
def test_native_euler_maruyama_equals_jax_binding(drift, params):
    args = (drift, params, 0.8, np.linspace(-1.0, 1.0, 5), 200, 0.01, 11)
    np.testing.assert_array_equal(native.euler_maruyama_1d_native(*args),
                                  jnative.euler_maruyama_1d_native(*args))
