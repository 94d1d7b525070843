"""Learning the MLP drift (``prior_sde/mlpdrift.yaml``) on the card: the
benchmark configuration ``mlp1d_learn``'s fit against the same fit on the
CPU, the captured drift-learning step against eager learning, a captured
step replayed after an Adam step, and the KL's route.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_mlp_learn_cuda.py --confcutdir=tests/port -m cuda

The fit at T = 100,000 runs K1–K3 and, in drift learning, K1′ and K2′ on
the card, and their plain versions on the CPU; the KL's path term is the
plain expression on both.  The two sum in other orders, so the fits agree
to rounding (``FIT_LIMITS``: each accepted and each inner loop's ELBO
relative, each learned parameter and the marginals over their largest
magnitudes; read on an H100: 6.5e-12, 7.6e-12 and 1.2e-9).  The learning
step replayed as one CUDA graph (``optim/trainers.py::_prior_sde_step``)
against the same fit with the eager learning of
``test_torch_learn_step.py::EagerLearningTrainer`` (``torch.optim.Adam``),
in the same accepted steps, to ``LEARN_RTOL``, and against the same
function called uncaptured, bit for bit.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, make_dataset
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts
from vi_diffusion_processes_tpu_torch.ops.quad_kl import kernel_drift
from vi_diffusion_processes_tpu_torch.optim import trainers
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer
from vi_diffusion_processes_tpu_torch.sde.zoo import MLPDrift
from vi_diffusion_processes_tpu_torch.utils import tracing

from .test_torch_compiled_cuda import _assert_bits_equal
from .test_torch_learn_step import EagerLearningTrainer

pytestmark = pytest.mark.cuda

T = 100_000
#: the card's fit against the CPU's at T = 100,000
FIT_LIMITS = {"elbo": 1e-9, "params": 1e-8, "marginals": 1e-7}
PARAMS = ("q_mat", "w1", "b1", "w2", "b2")
#: the captured learning step's fit against the eager learning's through
#: torch.optim.Adam, each ELBO relative and each learned parameter over its
#: largest magnitude.  Read on an H100: 1.5e-12 in one ELBO.  The two Adams
#: round differently on the card (torch's foreach update takes p + s·(m/d)
#: and multiplies by 1/√(1 − β₂ᵗ); ``_adam`` takes torch's CPU order,
#: p + (s·m)/d, and divides), and the fit carries that last bit on; the
#: capture itself changes no bit (the test before this one).
LEARN_RTOL = 1e-11


def _model(dev, t_size):
    """``mlp1d_learn``'s model on one double-well dataset of ``t_size``
    points, 200 observations drawn: the MLP of ``mlp_seed`` 0."""
    data = make_dataset(ExperimentConfig(num_grid=t_size, num_observations=200, seed=7), dev)
    sde = build_prior_sde("mlpdrift", q=1.0, device=dev, hidden=3, stddev=1.0,
                          generator=torch.Generator().manual_seed(0))
    return CVISitesSDE.initialize_sde(sde, data.time_grid, (data.obs_times, data.obs_values),
                                      Gaussian(0.316**2).to(dev))


def _fit(dev, cls=CVISitesTrainer, launches=None, setup=None):
    """``mlp1d_learn``'s fit at T = 100,000 by the trainer class ``cls``,
    first handed to ``setup``; with a list ``launches``, the kernels'
    launches of each learning step appended to it."""
    trainer = cls(_model(dev, T), sites_lr=0.5, max_inner_iters=20,
                  max_outer_iters=10, learn_prior_sde=True, prior_sde_lr=0.01)
    if setup is not None:
        setup(trainer)
    if launches is not None:
        learn = trainer.optimize_prior_sde

        def counted():
            before = launch_counts()
            learn()
            after = launch_counts()
            launches.append({k: after[k] - before[k] for k in after})

        trainer.optimize_prior_sde = counted
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


def _learn_replay_pct() -> float:
    path = Path(__file__).resolve().parents[2] / "portbench" / "metrics" / "learn_replay_pct.py"
    spec = importlib.util.spec_from_file_location("reader_learn_replay_pct", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader.read({"fits": [{"failed": False}]})


def _uncaptured(trainer) -> None:
    """Let ``trainer`` call ``_prior_sde_step`` itself, not replay it: with
    its rates as the 0-d float64 device tensors of a graph's inputs."""
    def step(model, params, exp_avg, exp_avg_sq, *rates):
        rates = [torch.full((), r, dtype=torch.float64, device=model.time_grid.device)
                 for r in rates]
        return trainers._prior_sde_step(model, params, exp_avg, exp_avg_sq, *rates)

    trainer._prior_step = step


def test_captured_learning_is_the_uncaptured_step_bit_for_bit(cuda_device):
    """A whole fit whose learning step is captured (the first call warms up
    and captures, the other nine replay) and a second fit (ten replays)
    against the fit that runs the same function uncaptured: every ELBO and
    learned parameter bit for bit; each learning step launches what the
    uncaptured one and the eager learning launch (K1 and K2, and K2 for the
    adjoints); ``learn_replay_pct`` reads 100 in the traced second fit."""
    eager_launches, plain_launches, launches = [], [], []
    _fit(cuda_device, EagerLearningTrainer, eager_launches)
    plain = _fit(cuda_device, launches=plain_launches, setup=_uncaptured)
    first = _fit(cuda_device, launches=launches)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        second = _fit(cuda_device, launches=launches)
    replay_pct = _learn_replay_pct()
    tracing.reset()
    assert replay_pct == 100.0
    assert len(eager_launches) == len(plain_launches) == 10 and len(launches) == 20
    assert eager_launches[0]["riccati_d_sweep"] > 0 and eager_launches[0]["linear_recurrence"] > 0
    assert all(n == eager_launches[0] for n in eager_launches + plain_launches + launches)
    for fit in (first, second):
        assert fit[0] == plain[0]
        for name in PARAMS:
            assert torch.equal(fit[1][name], plain[1][name]), name


def test_captured_learning_against_torch_adam(cuda_device):
    """The captured fit against the fit with eager learning through
    ``torch.optim.Adam`` on the card: the same accepted steps, every ELBO
    and every learned parameter within ``LEARN_RTOL``."""
    eager = _fit(cuda_device, EagerLearningTrainer)
    fit = _fit(cuda_device)
    elbo = max(abs(g - r) / max(abs(r), 1.0) for g, r in zip(fit[0], eager[0]))
    params = max(_scaled(fit[1][n], eager[1][n]) for n in PARAMS)
    print(f"[learn] captured against torch.optim.Adam: elbo {elbo:.3e}, params {params:.3e}, "
          f"bit for bit {fit[0] == eager[0] and params == 0.0}")
    assert len(fit[0]) == len(eager[0])
    assert elbo <= LEARN_RTOL and params <= LEARN_RTOL


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
