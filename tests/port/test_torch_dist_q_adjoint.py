"""K3's backward against ``jax.vjp`` of the JAX package's composition.

``dist_q_1d_planes``'s backward is ``cvi_dp_packed.py::_dist_q_fused_bwd``
(:215-222): the VJP of ``_dist_q_core(..., float32)``, recomputed with
gradients on.  The port runs its plain forward on the CPU; the JAX side
differentiates ``_dist_q_core`` on its CPU path.  Same numpy-seeded
naturals and cotangents on both sides, N = 1500 (ragged against the 1024
windows).  Tolerance: 2e-4 of each gradient's scale, the float32
marginals' contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vi_diffusion_processes_tpu.models.cvi_dp_packed import _dist_q_core as jax_dist_q_core
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

from .helpers import assert_close_scaled, naturals


@jax.jit
def _jax_dist_q_vjp(nat1, nat2d, nat2s, cts):
    return jax.vjp(lambda *a: jax_dist_q_core(*a, jnp.float32), nat1, nat2d, nat2s)[1](cts)


def test_dist_q_vjp_matches_jax(rng):
    n = 1500
    nat = naturals(rng, n)
    shapes = [(n - 1,)] * 3 + [()] * 2 + [(n,)] * 2
    cts = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ref = _jax_dist_q_vjp(*(jnp.asarray(x) for x in nat), tuple(jnp.asarray(c) for c in cts))
    leaves = [torch.tensor(x, requires_grad=True) for x in nat]
    outs = cs.dist_q_1d_planes(*leaves, torch.float32)
    got = torch.autograd.grad(outs, leaves, [torch.tensor(c) for c in cts])
    for name, gt, r in zip(("nat1", "nat2d", "nat2s"), got, ref):
        assert gt.dtype == torch.float64, name
        assert_close_scaled(gt.numpy(), r, 2e-4, err_msg=name)
