"""Learning the MLP drift (``prior_sde/mlpdrift.yaml``) on the card: the
benchmark configuration ``mlp1d_learn``'s fit against the same fit on the
CPU, a captured step replayed after an Adam step, and the KL's route.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_mlp_learn_cuda.py --confcutdir=tests/port -m cuda

The fit at T = 100,000 runs K1–K3 and, in drift learning, K1′ and K2′ on
the card, and their plain versions on the CPU; the KL's path term is the
plain expression on both.  The two sum in other orders, so the fits agree
to rounding (``FIT_LIMITS``: each accepted and each inner loop's ELBO
relative, each learned parameter and the marginals over their largest
magnitudes; read on an H100: 6.5e-12, 7.6e-12 and 1.2e-9).
"""
import pytest
import torch

from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, make_dataset
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.ops.quad_kl import kernel_drift
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer
from vi_diffusion_processes_tpu_torch.sde.zoo import MLPDrift
from vi_diffusion_processes_tpu_torch.utils import tracing

from .test_torch_compiled_cuda import _assert_bits_equal

pytestmark = pytest.mark.cuda

T = 100_000
#: the card's fit against the CPU's at T = 100,000
FIT_LIMITS = {"elbo": 1e-9, "params": 1e-8, "marginals": 1e-7}
PARAMS = ("q_mat", "w1", "b1", "w2", "b2")


def _model(dev, t_size):
    """``mlp1d_learn``'s model on one double-well dataset of ``t_size``
    points, 200 observations drawn: the MLP of ``mlp_seed`` 0."""
    data = make_dataset(ExperimentConfig(num_grid=t_size, num_observations=200, seed=7), dev)
    sde = build_prior_sde("mlpdrift", q=1.0, device=dev, hidden=3, stddev=1.0,
                          generator=torch.Generator().manual_seed(0))
    return CVISitesSDE.initialize_sde(sde, data.time_grid, (data.obs_times, data.obs_values),
                                      Gaussian(0.316**2).to(dev))


def _fit(dev):
    trainer = CVISitesTrainer(_model(dev, T), sites_lr=0.5, max_inner_iters=20,
                              max_outer_iters=10, learn_prior_sde=True, prior_sde_lr=0.01)
    outer = trainer.optimize()
    with torch.no_grad():
        means, covs = trainer.model.dist_q.marginals()
    params = {k: p.detach().cpu() for k, p in trainer.model.prior_sde.named_parameters()}
    return trainer.elbo_trace + outer, params, means.cpu(), covs.cpu()


def _scaled(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


def test_a_learned_fit_on_the_card_against_the_cpu(cuda_device):
    card, cpu = _fit(cuda_device), _fit(torch.device("cpu"))
    assert len(card[0]) == len(cpu[0]) > 10
    for got, ref in zip(card[0], cpu[0]):
        assert abs(got - ref) <= FIT_LIMITS["elbo"] * max(abs(ref), 1.0), (got, ref)
    assert sorted(card[1]) == sorted(PARAMS)
    for name in PARAMS:
        assert _scaled(card[1][name], cpu[1][name]) <= FIT_LIMITS["params"], name
    for got, ref in zip(card[2:], cpu[2:]):
        assert _scaled(got, ref) <= FIT_LIMITS["marginals"]


def test_captured_replay_after_an_adam_step(cuda_device):
    """At T = 2,000: the trainer's captured step, replayed after
    ``optimize_prior_sde`` has given the model a new SDE, equals the eager
    step of the new model bit for bit, and differs from the old model's."""
    trainer = CVISitesTrainer(_model(cuda_device, 2_000), learn_prior_sde=True,
                              prior_sde_lr=0.01, max_inner_iters=3)
    trainer.perform_inference()  # captures the step and the ELBO, then re-linearizes
    before = trainer.model
    trainer.optimize_prior_sde()
    after = trainer.model
    assert after.prior_sde is not before.prior_sde
    for name, p in after.prior_sde.named_parameters():
        assert not torch.equal(p, getattr(before.prior_sde, name)), name
    step = trainer._packed[2]
    state = tp.pack_state(after)
    assert step._graphs, "the step was captured"
    replayed = step(after, state, 0.5)
    _assert_bits_equal(replayed, tp.packed_natgrad_step(after, state, 0.5), "after Adam")
    old = tp.packed_natgrad_step(before, state, 0.5)
    assert not torch.equal(replayed[0].g_nat1, old[0].g_nat1)


def test_kernel_drift_takes_the_plain_route_for_the_mlp(cuda_device):
    """F knows the double well alone: the MLP on a card tensor takes the
    plain d = 1 path term, counted as ``kl_quad_1d.plain``."""
    sde = MLPDrift.initialize(torch.Generator().manual_seed(0), [[1.0]]).to(cuda_device)
    x = torch.zeros(8, dtype=torch.float64, device=cuda_device)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert kernel_drift(sde, 1, x, "kl_quad_1d") is None
    assert tracing.counters() == {"kl_quad_1d.plain": 1}
    tracing.reset()
