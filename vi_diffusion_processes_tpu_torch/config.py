"""Global numerical constants (vi_diffusion_processes_tpu/config.py:48-58).

The JAX package switches its float policy with ``jax_enable_x64``.  The
port has no such switch: every tensor carries its dtype, and the CVI
natural-parameter algebra is always float64 (models/cvi_dp.py).  The
jitter therefore follows the reference's x64-on value.
"""
from __future__ import annotations


def default_jitter() -> float:
    """Diagonal jitter used when factorizing near-singular covariances
    (the JAX package's value with x64 enabled)."""
    return 1e-10


#: Large-but-finite stand-in for infinity, mirroring markovflow/base.py:46.
APPROX_INF = 1e10
