"""CVI-DP's drift-learning step as one capturable function, on the CPU.

``optim/trainers.py::_prior_sde_step`` computes both prior gradients, one
Adam step as tensor ops (``_adam``) and the linearization at the new
parameters; on the card ``CVISitesTrainer.optimize_prior_sde`` replays it as
one CUDA graph (``test_torch_mlp_learn_cuda.py``).  What the CPU shows:

- ``_adam`` is ``torch.optim.Adam``'s update bit for bit, over 10 steps on
  fixed gradients, and so is VDP's eager step through the same learner;
- the step reads nothing on the host (``helpers.NoHostSync``), with float
  rates and with the 0-d float64 rates of a captured step, which give the
  same bits; so do K1's and K2's backward passes, which it runs on the card;
- a learned fit through the trainer equals, bit for bit, the same fit with
  the eager learning written out here (:class:`EagerLearningTrainer`:
  ``torch.optim.Adam`` and ``set_linearized_prior``).

The MLP drift of ``mlp1d_learn`` and the double well, at T = 400.
"""
import copy
from types import SimpleNamespace

import pytest
import torch

from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, make_dataset
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.ops import cuda_scan
from vi_diffusion_processes_tpu_torch.optim import trainers
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

from .helpers import NoHostSync

T = 400
#: parameter shapes of the MLP drift (``q_mat``, ``w1``, ``b1``, ``w2``, ``b2``)
SHAPES = {"q_mat": (1, 1), "w1": (1, 3), "b1": (3,), "w2": (3, 1), "b2": (1,)}


class EagerLearningTrainer(CVISitesTrainer):
    """``CVISitesTrainer`` whose drift learning runs eagerly, op by op: both
    prior gradients, ``torch.optim.Adam`` on copies of the SDE's
    parameters, a new SDE, ``set_linearized_prior``."""

    def __post_init__(self):
        super().__post_init__()
        self._params = {name: p.detach().clone().requires_grad_()
                        for name, p in self.model.prior_sde.named_parameters()}
        self._opt = torch.optim.Adam(self._params.values(), lr=self.prior_sde_lr)

    def optimize_prior_sde(self) -> None:
        g_kl = self.model.grad_kl_wrt_prior_params()
        g_ve = self.model.grad_ve_wrt_prior_params()
        for name, p in self._params.items():
            p.grad = g_kl[name] + g_ve[name]
        self._opt.step()
        new_sde = copy.deepcopy(self.model.prior_sde)
        with torch.no_grad():
            for name, p in new_sde.named_parameters():
                p.copy_(self._params[name])
        self.model = self.model.replace(prior_sde=new_sde).set_linearized_prior()


def learn_model(device, t_size, drift="mlp"):
    """A d = 1 CVI-DP model on one double-well dataset of ``t_size`` points
    (200 observations drawn, at most one a grid point): ``mlp1d_learn``'s
    MLP of ``mlp_seed`` 0, or a double well off the data's."""
    data = make_dataset(ExperimentConfig(num_grid=t_size, num_observations=200, seed=7), device)
    if drift == "mlp":
        sde = build_prior_sde("mlpdrift", q=1.0, device=device, hidden=3, stddev=1.0,
                              generator=torch.Generator().manual_seed(0))
    else:
        sde = DoubleWellSDE(q=[[0.8]], scale=3.0, c=1.2).to(device)
    return CVISitesSDE.initialize_sde(sde, data.time_grid, (data.obs_times, data.obs_values),
                                      Gaussian(0.316**2).to(device))


def _assert_same(a, b, what):
    assert sorted(a) == sorted(b), what
    for name in a:
        assert torch.equal(a[name], b[name]), (what, name)


@pytest.mark.parametrize("lr", [0.01, 0.3])
def test_adam_is_torch_adam_bit_for_bit(lr):
    """Ten steps of the learner (``_adam`` from ``state()``, then ``step``)
    against ``torch.optim.Adam`` on the same gradients, drawn once at scales
    from 1e-6 to 1e3: the parameters and both moments, bit for bit."""
    gen = torch.Generator().manual_seed(11)
    sde = build_prior_sde("mlpdrift", q=0.7, device="cpu", generator=gen)
    learner = trainers._PriorSDELearner(sde, lr)
    params = {name: p.detach().clone().requires_grad_() for name, p in sde.named_parameters()}
    opt = torch.optim.Adam(params.values(), lr=lr)
    for k in range(10):
        grads = {name: 10.0 ** (k % 10 - 6) * torch.randn(shape, dtype=torch.float64,
                                                          generator=gen)
                 for name, shape in SHAPES.items()}
        for name, p in params.items():
            p.grad = grads[name].clone()
        opt.step()
        sde = learner.step(sde, learner.adam(grads))
        _assert_same(learner.params, {n: p.detach() for n, p in params.items()}, k)
        _assert_same({n: p.detach() for n, p in sde.named_parameters()}, learner.params, k)
        _assert_same(learner.exp_avg, {n: opt.state[p]["exp_avg"] for n, p in params.items()}, k)
        _assert_same(learner.exp_avg_sq,
                     {n: opt.state[p]["exp_avg_sq"] for n, p in params.items()}, k)
    assert learner.steps == 10


@pytest.mark.parametrize("drift", ["mlp", "double_well"])
def test_learning_step_reads_nothing_on_the_host(drift):
    """``_prior_sde_step`` after one inner loop, under a mode that fails on
    any host read: with float rates, and with the 0-d float64 rates that a
    captured step holds, which give the same bits."""
    trainer = CVISitesTrainer(learn_model(torch.device("cpu"), T, drift), max_inner_iters=3,
                              learn_prior_sde=True, prior_sde_lr=0.01)
    trainer.perform_inference()
    state = trainer._prior_learner.state()
    tensor_rates = tuple(torch.tensor(r, dtype=torch.float64) for r in state[3:])
    with NoHostSync():
        by_float = trainers._prior_sde_step(trainer.model, *state)
        by_tensor = trainers._prior_sde_step(trainer.model, *state[:3], *tensor_rates)
    for got, ref in zip(by_float[:3], by_tensor[:3]):
        _assert_same(got, ref, "params and moments")
    for field in ("state_transitions", "state_offsets", "chol_process_covariances"):
        assert torch.equal(getattr(by_float[3], field), getattr(by_tensor[3], field)), field
    for got, ref in zip(by_float[4], by_tensor[4]):
        assert torch.equal(got, ref), "prior_nats"
    moved = by_float[0]
    for name, p in trainer.model.prior_sde.named_parameters():
        assert not torch.equal(moved[name], p.detach()), name


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_adjoints_read_nothing_on_the_host(reverse):
    """K2's backward pass (``_linrec_backward``, both directions) and K1's
    (``sweep_adjoint``, which runs K2) make their boundary values on the
    device: a Python number would be copied from the host."""
    gen = torch.Generator().manual_seed(3)
    t, c, g = (torch.rand(2, 50, dtype=torch.float64, generator=gen) for _ in range(3))
    x0 = torch.rand(2, dtype=torch.float64, generator=gen)
    x = cuda_scan.linear_recurrence(t, c, x0, reverse)
    ctx = SimpleNamespace(saved_tensors=(t, x, x0), reverse=reverse,
                          needs_input_grad=(True, True, True, False))
    b2 = torch.cat([0.1 * t[..., :-1], torch.zeros_like(t[..., :1])], dim=-1)
    d = cuda_scan.riccati_d_sweep(2.0 + t, b2)
    with NoHostSync():
        t_bar, c_bar, x0_bar, _ = cuda_scan._linrec_backward(ctx, g)
        kd_bar, b2_bar = cuda_scan.sweep_adjoint(b2, d, g, 1e-300)
    leaves = [t.clone().requires_grad_(), c.clone().requires_grad_(),
              x0.clone().requires_grad_()]
    ref = torch.autograd.grad(cuda_scan.linear_recurrence_plain(*leaves, reverse), leaves, g)
    for got, want in zip((t_bar, c_bar, x0_bar), ref):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    assert bool(torch.isfinite(kd_bar).all()) and bool(torch.isfinite(b2_bar).all())


@pytest.mark.parametrize("drift", ["mlp", "double_well"])
def test_learned_fit_equals_the_eager_learning(drift):
    """Three outer iterations with learning: the trainer's step (called
    directly on the CPU, as ``CapturedStep`` does) against the eager
    learning of :class:`EagerLearningTrainer`, bit for bit in every ELBO,
    every learned parameter and the linearized prior; one learner, one
    ``CapturedStep`` of ``_prior_sde_step``."""
    fits = []
    for cls in (CVISitesTrainer, EagerLearningTrainer):
        trainer = cls(learn_model(torch.device("cpu"), T, drift), max_inner_iters=4,
                      max_outer_iters=3, learn_prior_sde=True, prior_sde_lr=0.05)
        outer = trainer.optimize()
        fits.append((trainer, trainer.elbo_trace + outer))
    (captured, elbos), (eager, eager_elbos) = fits
    assert elbos == eager_elbos and len(elbos) > 3
    _assert_same({n: p.detach() for n, p in captured.model.prior_sde.named_parameters()},
                 {n: p.detach() for n, p in eager.model.prior_sde.named_parameters()}, "params")
    for field in ("state_transitions", "state_offsets", "chol_process_covariances"):
        assert torch.equal(getattr(captured.model.dist_p, field),
                           getattr(eager.model.dist_p, field)), field
    for got, ref in zip(captured.model.prior_nats, eager.model.prior_nats):
        assert torch.equal(got, ref), "prior_nats"
    assert isinstance(captured._prior_step, CapturedStep)
    assert captured._prior_step.fn is trainers._prior_sde_step
    assert captured._prior_learner.steps == 3
