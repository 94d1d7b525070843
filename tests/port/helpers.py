"""Helpers for carrying JAX values into the port's tests."""
import dataclasses

import numpy as np


def to_np(x):
    """A JAX dataclass / named tuple / array tree as nested dicts of numpy
    arrays keyed by field name (the input format of the port's ``interop``)."""
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if x is None or isinstance(x, (bool, int, float, str, tuple)):
        return x
    return np.array(x)  # a writable copy


def assert_close_scaled(actual, expected, rtol, err_msg=""):
    """``|a − e| ≤ rtol·max|e|`` elementwise: relative to the array's scale,
    so entries that pass through zero do not blow the relative error up."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=rtol * scale, err_msg=err_msg)


def riccati_inputs(rng, n, batch=()):
    """Pivot-sweep inputs shaped like tests/unit/test_pallas_scan.py:21-28."""
    kd = rng.uniform(2.0, 3.0, batch + (n,))
    b2 = 0.2 * rng.uniform(0.5, 1.0, batch + (n,))
    b2[..., -1] = 0.0
    return kd, b2


def affine_inputs(rng, n, batch=()):
    return rng.uniform(-0.999, 0.999, batch + (n,)), rng.normal(size=batch + (n,))


def naturals(rng, n, batch=()):
    """``(nat1, nat2d, nat2s)`` shaped like test_pallas_scan.py:118-124."""
    kd = rng.uniform(2.0, 3.0, batch + (n,))
    ks = 0.4 * rng.uniform(-1.0, 1.0, batch + (n - 1,))
    return rng.normal(size=batch + (n,)), -0.5 * kd, -ks
