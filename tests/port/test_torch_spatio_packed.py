"""The port's packed spatio-temporal CVI step (``models/spatio_packed.py``)
against the JAX package and against the generic step, on the data and
model of ``spatio_cases``.

* float64, sorted times: ``pack_spatio``'s invariants and three packed steps
  against the JAX packed step at ``m_space = 1`` (d = 2), and against the
  generic step at ``m_space`` ∈ {1, 3} (d = 2 and 6), to 1e-9 of their
  scale (the JAX package holds its own pair to 1e-7 relative,
  tests/unit/test_spatio_packed.py:54-55).  The JAX packed step compiles in
  about 5 s at d = 2 and 65 s at d = 6, so the JAX side runs at d = 2; the
  port's generic step is held against the JAX one at d = 6 in
  ``test_torch_spatio_temporal.py``;
* shuffled times: the port sums each interval's sites with ``index_add_``,
  so its packed step equals the JAX *generic* step on the same rows (1e-9).
  The JAX packed step sums by a cumulative sum over rows it assumes sorted
  and is wrong there: this test asserts that it departs;
* float32 compute (the benchmark's ``packed_spatio_site_step(..., float32)``)
  after three steps against the float64 generic step, in the port and in
  the JAX package, to ``F32_RTOL`` of the sites' scale.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.models.spatio_packed import (
    pack_spatio,
    packed_spatio_site_step,
    unpack_spatio,
)

from . import spatio_cases as sc
from .helpers import assert_close_scaled, to_np

RTOL = 1e-9
#: float32 compute against the float64 generic step, as a share of the
#: sites' scale after three steps.  Measured on these inputs (CPU): the port
#: 7.5e-8 (d = 2) and 1.2e-7 (d = 6), the JAX package 1.2e-6 (d = 2)
F32_RTOL = 1e-5


def _port_generic(m_space, order="sorted"):
    model, xy = sc.port_model(m_space), sc.port_data(order)
    out = []
    for _ in range(sc.STEPS):
        model = model.update_sites(xy)
        out.append((model.nat1.numpy(), model.nat2.numpy()))
    return out


def _port_packed(m_space, order="sorted", compute=None, steps=sc.STEPS):
    model = sc.port_model(m_space)
    cache, state = pack_spatio(model, sc.port_data(order))
    out = []
    for _ in range(steps):
        state = packed_spatio_site_step(model, cache, state, compute)
        restored = unpack_spatio(model, state)
        out.append((restored.nat1.numpy(), restored.nat2.numpy()))
    return out


def _assert_sites(got, want, rtol, label):
    for k, ((n1, n2), (m1, m2)) in enumerate(zip(got, want)):
        assert_close_scaled(n1, m1, rtol, err_msg=f"{label}: nat1, step {k + 1}")
        assert_close_scaled(n2, m2, rtol, err_msg=f"{label}: nat2, step {k + 1}")


def test_pack_matches_jax():
    jcache, jstate = sc.jax_pack(1)
    cache, state = pack_spatio(sc.port_model(1), sc.port_data())
    for name in ("u", "var_floor", "init_mean", "init_cov", "y"):
        assert_close_scaled(getattr(cache, name).numpy(), np.asarray(getattr(jcache, name)), RTOL,
                            err_msg=name)
    np.testing.assert_array_equal(cache.idx.numpy(), np.asarray(jcache.idx))

    def stacked(channels):
        return np.stack([np.stack([np.asarray(x) for x in row], -1) for row in channels], -2)

    assert_close_scaled(cache.p_theta_diag.numpy(), stacked(jcache.p_theta_diag), RTOL)
    assert_close_scaled(cache.p_theta_sub.numpy(), stacked(jcache.p_theta_sub), RTOL)
    # the JAX state's folded nat2 unfolds to the port's
    back = interop.packed_spatio_state_from_numpy(to_np(jstate), device="cpu")
    np.testing.assert_array_equal(back.nat2.numpy(), state.nat2.numpy())
    np.testing.assert_array_equal(interop.fields_to_numpy(back)["nat1"], np.asarray(jstate.nat1))


def test_packed_step_matches_the_jax_packed_step():
    _assert_sites(_port_packed(1), sc.jax_packed(1), RTOL, "packed vs JAX packed")


@pytest.mark.parametrize("m_space", [1, 3])
def test_packed_step_matches_the_generic_step(m_space):
    if m_space == 1:
        _assert_sites(_port_packed(1), sc.jax_generic(1)[0], RTOL, "packed vs JAX generic")
    _assert_sites(_port_packed(m_space), _port_generic(m_space), RTOL, "packed vs port generic")


def test_shuffled_times_give_the_generic_answer():
    sites, _ = sc.jax_generic(1, "shuffled")
    _assert_sites(_port_packed(1, "shuffled"), sites, RTOL, "shuffled packed vs JAX generic")
    _assert_sites(_port_packed(3, "shuffled"), _port_generic(3), RTOL,
                  "shuffled packed vs sorted port generic")
    # the order does not change the generic step's sums beyond rounding
    _assert_sites(sites, sc.jax_generic(1)[0], RTOL, "JAX generic, shuffled vs sorted")
    # the JAX packed step's cumulative-sum reduction is wrong on these rows
    jax_packed = sc.jax_packed(1, "shuffled")[-1][0]
    scale = np.max(np.abs(sites[-1][0]))
    assert np.max(np.abs(jax_packed - sites[-1][0])) > 0.1 * scale


@pytest.mark.parametrize("side,m_space", [("port", 1), ("port", 3), ("jax", 1)])
def test_float32_packed_step_is_close_to_the_float64_generic_step(side, m_space):
    if side == "port":
        got = _port_packed(m_space, compute=torch.float32)
        generic = _port_generic(m_space)
    else:
        got = sc.jax_packed(m_space, compute="float32")
        generic = sc.jax_generic(m_space)[0]
    assert got[-1][0].dtype == np.float64  # the state keeps the model's dtype
    _assert_sites(got, generic, F32_RTOL, f"{side} float32 packed vs float64 generic")


def test_packed_steps_raise_the_elbo():
    """tests/unit/test_spatio_packed.py:61-69: 12 packed steps raise the
    ELBO by more than 1 (d = 6)."""
    model, xy = sc.port_model(3), sc.port_data()
    cache, state = pack_spatio(model, xy)
    for _ in range(12):
        state = packed_spatio_site_step(model, cache, state)
    with torch.no_grad():
        assert float(unpack_spatio(model, state).elbo(xy)) > float(model.elbo(xy)) + 1.0
