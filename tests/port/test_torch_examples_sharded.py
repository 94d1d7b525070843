"""The port's time-sharded smoothing example against the JAX one, on two
gloo ranks on the CPU (its own file: the ranks are spawned processes).  The
4,001-point grid does not divide the ranks; the smoothed moments and the
log-normalizer equal the JAX example's (through its 8-device mesh) and the
single-process smoother's to 1e-8 of their scale."""
from vi_diffusion_processes_tpu_torch.examples.time_sharded_smoothing import N

from .test_torch_examples import check_against_goldens


def test_sharded_example_matches_the_jax_example():
    out = check_against_goldens("time_sharded_smoothing")
    (group,) = out["groups"]
    assert (group["ranks"], group["backend"]) == (2, "gloo")
    assert group["chunks"] == [[0, 2001], [2001, N]]
    assert out["err"] < 1e-8
