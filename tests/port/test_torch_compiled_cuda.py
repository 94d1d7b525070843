"""The captured steps (``optim/compiled.py``) on the card, against the same
steps run eagerly.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_compiled_cuda.py --confcutdir=tests/port -m cuda

The flagship (``bench.py``'s double well, T = 100,000, float32 model) by
both routes of its step, K3 (float64 naturals) and K4 + K2 (x64 off), and
VDP on the same data (K2): replays against eager steps from the same state,
bit for bit, since a replay runs the eager step's kernels on the same
inputs.  The same for the routes of slice M: the d = 2 packed step and its
ELBO on the Van der Pol configuration (R1), the generic site step and
``classic_elbo`` on the flagship under its SDE prior and under an SSM prior
(R2: K1 5 and K2 20 times a step) and at d = 2 with x64 off at a small T
(the sequential UDU'), and VDP's generic step and ELBO at d = 2 (R3).  The
trainers over two outer iterations make one capture of each step.  Launch
counts after N replays are N times the captured launches.  A step that
cannot be captured raises, in the trainer too.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import numpy as np

from vi_diffusion_processes_tpu_torch import config
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE, CVISitesSSM
from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import (
    pack_state,
    packed_elbo,
    packed_natgrad_step,
)
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.models.vdp_packed import (
    pack_vdp,
    packed_inference_step,
    packed_vdp_elbo,
)
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.optim import trainers
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep, _flatten
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer
from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model
from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
from vi_diffusion_processes_tpu_torch.sde.zoo import OrnsteinUhlenbeckSDE, VanderPolOscillatorSDE

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[2]

T = 100_000
STEPS = 8
LR = 0.3
#: kernel launches of one step by route: float64 naturals take K3 twice, x64
#: off K4 twice and K2 eight times, and both the double well's KL kernel F
#: (the ELBO) and its adjoint F′ (the Girsanov gradient) once; VDP's step K2
#: four times and its ELBO twice
LAUNCHES = {"x64": {"dist_q_1d_planes": 2, "quad_kl_1d": 1, "quad_kl_1d_adjoint": 1},
            "x64_off": {"riccati_d_sweep_f32": 2, "linear_recurrence": 8, "quad_kl_1d": 1,
                        "quad_kl_1d_adjoint": 1}}
#: VDP's generic step at d = 2 on the card: its drift energy's kernel once
#: and its adjoint once (``ops/quad_kl.py``), no K1-K4
VDP_D2_LAUNCHES = {"vdp_energy": 1, "vdp_energy_adjoint": 1}


def _tensors(out):
    """Every tensor of a step's output (a state, a model, an ELBO or a
    pair), modules' included, by position."""
    leaves = []
    _flatten(out, leaves, [])
    return dict(enumerate(leaves))


def _assert_bits_equal(got, ref, what):
    got, ref = _tensors(got), _tensors(ref)
    assert got.keys() == ref.keys(), what
    for name in ref:
        assert got[name].dtype == ref[name].dtype, (what, name)
        assert torch.equal(got[name], ref[name]), (what, name)


def _expected(route: str, n: int) -> dict:
    return {k: LAUNCHES[route].get(k, 0) * n for k in launch_counts()}


def _vdp(dev, prior="dw"):
    """VDP on the flagship's data, under its double well or, for the
    trainer, the OU prior of ``chip_smoke.py``'s ``run_vdp`` (from
    ``A = b = 0`` the double well diverges at every rate but the warm-up's)."""
    model = flagship_model(T, torch.float32, dev)
    obs_t = model.time_grid[model.obs_indices]
    sde = (model.prior_sde if prior == "dw"
           else OrnsteinUhlenbeckSDE(1.0, [[0.8]], dtype=torch.float32).to(dev))
    return VariationalMarkovGP.initialize(
        (obs_t, model.observations), sde, model.time_grid, model.likelihood)


@pytest.mark.parametrize("route", ["x64", "x64_off"])
def test_flagship_replays_equal_eager_steps(cuda_device, route):
    """STEPS replays, the rate changing between them, against STEPS eager
    steps from the same state, bit for bit; every state handed back stays
    valid after later replays; one capture; the launches of N replays are N
    times the captured ones (K3 2·N, or K4 2·N and K2 8·N; F and F′ N)."""
    with config.enable_x64(route == "x64"):
        model = flagship_model(T, torch.float32, cuda_device)
        step, elbo_of = CapturedStep(packed_natgrad_step), CapturedStep(packed_elbo)
        start = pack_state(model)
        first = step(model, start, LR)  # warm-up and capture
        _assert_bits_equal(first, packed_natgrad_step(model, start, LR), "first call")
        eager, captured, held = first[0], first[0], []
        reset_launch_counts()
        for i in range(STEPS):
            lr = LR if i % 3 else 0.5 * LR
            captured = step(model, captured, lr)
            held.append(captured)
            captured = captured[0]
        replayed = launch_counts()
        for i, out in enumerate(held):
            ref = packed_natgrad_step(model, eager, LR if i % 3 else 0.5 * LR)
            _assert_bits_equal(out, ref, f"replay {i}")
            eager = ref[0]
        assert (step.captures, step.replays) == (1, STEPS)
        assert replayed == _expected(route, STEPS)
        assert next(iter(step._graphs.values())).launches == _expected(route, 1)
        _assert_bits_equal(elbo_of(model, captured), packed_elbo(model, captured), "elbo")
        _assert_bits_equal(elbo_of(model, captured), packed_elbo(model, captured), "elbo replay")
        assert (elbo_of.captures, elbo_of.replays) == (1, 1)


def test_vdp_replays_equal_eager_steps_warmup_included(cuda_device):
    """Warm-up steps (``x0_lr = 0``) and steps that move q(x₀) through one
    graph against eager steps, bit for bit, with the ELBO after each, at the
    double well's rate 1e-6; K2 four times a step and twice an ELBO."""
    model = _vdp(cuda_device)
    step, elbo_of = CapturedStep(packed_inference_step), CapturedStep(packed_vdp_elbo)
    rates = [(1e-6, 0.0)] * 3 + [(1e-6, 1e-6)] * (STEPS - 3)
    eager = captured = pack_vdp(model)
    for i, (lr, x0_lr) in enumerate(rates):
        before = launch_counts()
        captured = step(model, captured, lr, x0_lr)
        e_capt = elbo_of(model, captured)
        made = {k: v - before[k] for k, v in launch_counts().items()}
        eager = packed_inference_step(model, eager, lr, x0_lr)
        _assert_bits_equal(captured, eager, f"step {i}")
        _assert_bits_equal(e_capt, packed_vdp_elbo(model, eager), f"elbo {i}")
        assert made["linear_recurrence"] == 6 and sum(made.values()) == 6
    assert (step.captures, step.replays, elbo_of.captures) == (1, STEPS - 1, 1)


def _trainer_elbos(trainer_cls, model, eager: bool, **kwargs):
    trainer = trainer_cls(model, **kwargs)
    if eager:  # the same loop with the raw steps, as the reference jits them
        _eager_trainer(trainer)
    return trainer, trainer.optimize(**({"n_rounds": 2} if trainer_cls is VDPTrainer else {}))


def test_trainers_capture_each_step_once(cuda_device):
    """``CVISitesTrainer`` over two outer iterations (``relinearize()`` in
    between) and ``VDPTrainer`` over two rounds: one capture of the step and
    one of the ELBO each, the rest replays, and the ELBO trace of the same
    loop run eagerly, bit for bit."""
    model = flagship_model(T, torch.float32, cuda_device)
    kwargs = dict(max_inner_iters=4, max_outer_iters=2)
    trainer, elbos = _trainer_elbos(CVISitesTrainer, model, False, **kwargs)
    eager, ref = _trainer_elbos(CVISitesTrainer, model, True, **kwargs)
    assert elbos == ref and trainer.elbo_trace == eager.elbo_trace
    assert len(trainer.elbo_trace) >= 4
    step, elbo_of = trainer._packed[2:]
    assert (step.captures, elbo_of.captures) == (1, 1) and step.replays >= 4

    vkw = dict(warmup_steps=3, max_iters=4, lr=0.01, x0_lr=0.01)
    vdp, velbos = _trainer_elbos(VDPTrainer, _vdp(cuda_device, "ou"), False, **vkw)
    veager, vref = _trainer_elbos(VDPTrainer, _vdp(cuda_device, "ou"), True, **vkw)
    assert velbos == vref and vdp.elbo_trace == veager.elbo_trace
    assert len(vdp.elbo_trace) >= 2
    assert (vdp._step.captures, vdp._elbo.captures) == (1, 1) and vdp._step.replays >= 5


def test_failed_capture_raises(cuda_device):
    """A step that reads a value on the host warms up but cannot be
    captured: the wrapper raises and does not run it eagerly instead.  In a
    process of its own, which the failed capture leaves behind."""
    script = textwrap.dedent("""
        import torch
        from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep

        step = CapturedStep(lambda x, lr: x * float(x.sum()) * lr)
        try:
            step(torch.ones(8, device="cuda"), 0.5)
        except RuntimeError as err:
            print("raised", step.captures, type(err).__name__)
        else:
            print("ran", step.captures)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.stdout.split()[:2] == ["raised", "0"], proc.stdout + proc.stderr


#: K1-K4 launches of one generic d = 1 step (five dist_q, each K1 once and
#: K2 four times) and of one classic_elbo (two dist_q: the marginals and
#: the KL's)
GENERIC_LAUNCHES = {"riccati_d_sweep": 5, "linear_recurrence": 20}
GENERIC_ELBO_LAUNCHES = {"riccati_d_sweep": 2, "linear_recurrence": 8}


def _vanderpol(t_size, dev, dtype=torch.float32):
    """benchmarks/secondary.py:339-385's d = 2 configuration with the port's
    API (``chip_smoke.py::vanderpol_model``): the Van der Pol prior (a = τ =
    1, q = 0.5·I₂) on [0, 10], ``(sin 0.6t, cos 0.6t) + 0.2·N(0, I₂)`` every
    ``max(50, T/200)`` points from index 50, linearized."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    grid = np.linspace(0.0, 10.0, t_size).astype(np_dtype)
    idx = np.arange(50, t_size - 1, max(50, t_size // 200))
    noise = np.random.default_rng(0).normal(size=(len(idx), 2))
    y = (np.stack([np.sin(0.6 * grid[idx]), np.cos(0.6 * grid[idx])], -1)
         + 0.2 * noise).astype(np_dtype)
    eye = torch.eye(2, dtype=dtype, device=dev)
    grid_t = torch.tensor(grid, device=dev)
    return CVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid_t,
        input_data=(grid_t[torch.tensor(idx, device=dev)], torch.tensor(y, device=dev)),
        likelihood=Gaussian(0.04, dtype=dtype).to(dev),
        prior_initial_state=GaussianState(mu=torch.zeros(2, dtype=dtype, device=dev),
                                          cov=0.5 * eye),
        prior_sde=VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * eye, dtype=dtype).to(dev),
        stabilize_ssm=True, clip_state_transitions=(-2.0, 2.0),
    ).set_linearized_prior()


def _ssm_prior(model):
    return CVISitesSSM.initialize(model.dist_p, model.time_grid,
                                  (model.time_grid[model.obs_indices], model.observations),
                                  model.likelihood)


def _vdp_d2(dev, t_size=T):
    """VDP on the Van der Pol prior and data at d = 2, from ``A = b = 0``."""
    model = _vanderpol(t_size, dev)
    return VariationalMarkovGP.initialize(
        (model.time_grid[model.obs_indices], model.observations), model.prior_sde,
        model.time_grid, model.likelihood)


def _replays_equal_eager(step, start, rates, carry, launches=None):
    """``len(rates)`` replays of ``step`` (a ``CapturedStep``, captured by a
    first call here) against as many eager calls of ``step.fn`` from the same
    start, bit for bit, each output checked after all replays; the launches
    of the replays, if given, ``launches`` per step."""
    captured = step(*start, *rates[0])
    _assert_bits_equal(captured, step.fn(*start, *rates[0]), "first call")
    eager_args = captured_args = carry(start, captured)
    held = []
    before = launch_counts()
    for rate in rates:
        out = step(*captured_args, *rate)
        held.append(out)
        captured_args = carry(captured_args, out)
    made = {k: v - before[k] for k, v in launch_counts().items()}
    for i, (rate, out) in enumerate(zip(rates, held)):
        ref = step.fn(*eager_args, *rate)
        _assert_bits_equal(out, ref, f"replay {i}")
        eager_args = carry(eager_args, ref)
    assert (step.captures, step.replays) == (1, len(rates))
    if launches is not None:
        assert made == {k: launches.get(k, 0) * len(rates) for k in made}, made
    return captured_args


def _next_model(args, out):
    """The generic routes' carry: the model a step returned."""
    return (out[0] if isinstance(out, tuple) else out,)


def _next_state(args, out):
    """The packed d = 2 route's carry: the model and the new state."""
    return args[0], out[0]


def test_vanderpol_packed_step_replays_equal_eager_steps(cuda_device):
    """R1: the d = 2 packed step at T = 100,000 (no kernel of K1-K4; the
    quadrature KL's forward twice and its adjoint once a step, captured
    with the step) and its ELBO (the forward once)."""
    model = _vanderpol(T, cuda_device)
    step = CapturedStep(tch.packed_natgrad_step_ch)
    model, state = _replays_equal_eager(step, (model, tch.pack_state_ch(model)),
                                        [(0.2,), (0.1,), (0.2,), (0.2,)], _next_state,
                                        {"quad_kl": 2, "quad_kl_adjoint": 1})
    elbo_of = CapturedStep(tch.packed_elbo_ch)
    for what in ("elbo", "elbo replay"):
        before = launch_counts()
        _assert_bits_equal(elbo_of(model, state), tch.packed_elbo_ch(model, state), what)
        made = {k: v - before[k] for k, v in launch_counts().items()}
        assert made == {k: {"quad_kl": 2}.get(k, 0) for k in made}, made


@pytest.mark.parametrize("prior", ["sde", "ssm"])
def test_generic_step_replays_equal_eager_steps_with_k1_and_k2(cuda_device, prior):
    """R2 at d = 1 on the flagship at T = 100,000, under its SDE prior and
    under the linearized prior as an SSM: replays bit for bit, K1 5 and K2 20
    launches a replayed step, ``classic_elbo`` K1 twice and K2 eight times."""
    model = flagship_model(T, torch.float32, cuda_device)
    if prior == "ssm":
        model = _ssm_prior(model)
    step = CapturedStep(trainers._site_step)
    rates = [(LR,), (0.5 * LR,), (LR,), (LR,)]
    (model,) = _replays_equal_eager(step, (model,), rates, _next_model, GENERIC_LAUNCHES)
    graph = next(iter(step._graphs.values()))
    assert graph.launches == {k: GENERIC_LAUNCHES.get(k, 0) for k in graph.launches}
    elbo_of = CapturedStep(trainers._classic_elbo)
    elbo_of(model)
    before = launch_counts()
    _assert_bits_equal(elbo_of(model), trainers._classic_elbo(model), "elbo replay")
    made = {k: v - before[k] for k, v in launch_counts().items()}
    assert made == {k: 2 * GENERIC_ELBO_LAUNCHES.get(k, 0) for k in made}


def test_generic_d2_step_with_x64_off_replays_at_a_small_grid(cuda_device):
    """R2 at d = 2 with the float64 policy off: the sequential UDU', a
    Python loop over T, captured at T = 64 (its graph grows with T)."""
    with config.enable_x64(False):
        model = _vanderpol(64, cuda_device)
        _replays_equal_eager(CapturedStep(trainers._site_step), (model,), [(0.2,)] * 3,
                             _next_model, {})


def test_vdp_generic_step_replays_equal_eager_steps(cuda_device):
    """R3: VDP's generic step at d = 2 (the matrix ``affine_scan``, the drift
    energy's kernel and its adjoint) at T = 100,000, warm-up steps at
    ``x0_lr = 0`` and steps that move q(x₀) through one graph, and its
    ELBO."""
    rates = [(1e-6, 0.0), (1e-6, 0.0), (0.05, 0.05), (0.05, 0.05)]
    (model,) = _replays_equal_eager(CapturedStep(trainers._vdp_step), (_vdp_d2(cuda_device),),
                                    rates, _next_model, VDP_D2_LAUNCHES)
    elbo_of = CapturedStep(trainers._vdp_elbo)
    for what in ("elbo", "elbo replay"):
        _assert_bits_equal(elbo_of(model), trainers._vdp_elbo(model), what)


def _eager_trainer(trainer):
    """The same trainer with every captured step replaced by its function."""
    for name in ("_packed", "_generic"):
        fns = getattr(trainer, name, None)
        if isinstance(fns, tuple):
            setattr(trainer, name, tuple(getattr(f, "fn", f) for f in fns))
    if isinstance(trainer, VDPTrainer):
        trainer._step, trainer._elbo = trainer._step.fn, trainer._elbo.fn
    return trainer


@pytest.mark.parametrize("route", ["generic_sde", "generic_ssm", "vanderpol", "vdp_d2"])
def test_slice_m_trainers_capture_each_step_once(cuda_device, route):
    """Each trainer route of slice M over two outer iterations (rounds for
    VDP): one capture of the step and one of the ELBO, the rest replays, and
    the ELBO trace of the same loop run eagerly, bit for bit."""
    if route.startswith("generic"):
        model = flagship_model(T, torch.float32, cuda_device)
        model = _ssm_prior(model) if route == "generic_ssm" else model

        def make():
            return CVISitesTrainer(model, use_packed=False, max_inner_iters=3, max_outer_iters=2)
    elif route == "vanderpol":
        model = _vanderpol(10_000, cuda_device)

        def make():
            return CVISitesTrainer(model, sites_lr=0.2, max_inner_iters=3, max_outer_iters=2)
    else:
        model = _vdp_d2(cuda_device, 10_000)

        def make():
            return VDPTrainer(model, warmup_steps=3, max_iters=3, lr=0.05, x0_lr=0.05)
    run = (lambda t: t.optimize(n_rounds=2)) if route == "vdp_d2" else (lambda t: t.optimize())
    trainer, eager = make(), _eager_trainer(make())
    assert run(trainer) == run(eager) and trainer.elbo_trace == eager.elbo_trace
    assert len(trainer.elbo_trace) >= 2
    if route == "vdp_d2":
        step, elbo_of = trainer._step, trainer._elbo
    else:
        step, elbo_of = (trainer._packed or trainer._generic)[-2:]
    assert (step.captures, elbo_of.captures) == (1, 1) and step.replays >= 2


@pytest.mark.parametrize("route", ["generic", "vdp_d2"])
def test_failed_capture_on_slice_m_routes_raises(cuda_device, route):
    """With the quadrature's ``√2`` made on the host at every call again (a
    copy that stream capture refuses), the trainer's warm-up runs but its
    capture fails: the trainer raises and runs nothing eagerly instead.  In
    a process of its own, which the failed capture leaves behind."""
    script = textwrap.dedent(f"""
        import sys
        import torch
        sys.path.insert(0, "tests/port")
        from test_torch_compiled_cuda import _vdp_d2, flagship_model
        from vi_diffusion_processes_tpu_torch.ops import quadrature
        from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer

        quadrature._sqrt2 = quadrature._sqrt2.__wrapped__
        dev = torch.device("cuda", 0)
        if "{route}" == "generic":
            trainer = CVISitesTrainer(flagship_model(2000, torch.float32, dev), use_packed=False)
            step, run = trainer._generic[1], trainer.optimize
        else:
            trainer = VDPTrainer(_vdp_d2(dev, 2000), warmup_steps=2)
            step, run = trainer._step, lambda: trainer.optimize(n_rounds=1)
        try:
            run()
        except RuntimeError as err:
            print("raised", step.captures, len(trainer.elbo_trace), type(err).__name__)
        else:
            print("ran", step.captures)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.stdout.split()[:3] == ["raised", "0", "0"], proc.stdout + proc.stderr
