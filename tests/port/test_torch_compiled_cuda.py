"""The captured steps (``optim/compiled.py``) on the card, against the same
steps run eagerly.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_compiled_cuda.py --confcutdir=tests/port -m cuda

The flagship (``bench.py``'s double well, T = 100,000, float32 model) by
both routes of its step, K3 (float64 naturals) and K4 + K2 (x64 off), and
VDP on the same data (K2): replays against eager steps from the same state,
bit for bit, since a replay runs the eager step's kernels on the same
inputs.  The trainers over two outer iterations make one capture of each
step.  Launch counts after N replays are N times the captured launches.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from vi_diffusion_processes_tpu_torch import config
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
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer
from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model
from vi_diffusion_processes_tpu_torch.sde.zoo import OrnsteinUhlenbeckSDE

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[2]

T = 100_000
STEPS = 8
LR = 0.3
#: K1-K4 launches of one step by route: float64 naturals take K3 twice, x64
#: off K4 twice and K2 eight times; VDP's step K2 four times and its ELBO twice
LAUNCHES = {"x64": {"dist_q_1d_planes": 2}, "x64_off": {"riccati_d_sweep_f32": 2,
                                                        "linear_recurrence": 8}}


def _tensors(out):
    """Every tensor of a step's output, by name."""
    if isinstance(out, tuple):
        state, elbo = out
        return {**_tensors(state), "elbo": elbo}
    if isinstance(out, torch.Tensor):
        return {"elbo": out}
    return dict(vars(out))


def _assert_bits_equal(got, ref, what):
    got, ref = _tensors(got), _tensors(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, (what, name)
        assert torch.equal(got[name], ref[name]), (what, name)


def _expected(route: str, n: int) -> dict:
    return {k: LAUNCHES[route].get(k, 0) * n for k in cs.launch_counts()}


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
    times the captured ones (K3 2·N, or K4 2·N and K2 8·N)."""
    with config.enable_x64(route == "x64"):
        model = flagship_model(T, torch.float32, cuda_device)
        step, elbo_of = CapturedStep(packed_natgrad_step), CapturedStep(packed_elbo)
        start = pack_state(model)
        first = step(model, start, LR)  # warm-up and capture
        _assert_bits_equal(first, packed_natgrad_step(model, start, LR), "first call")
        eager, captured, held = first[0], first[0], []
        cs.reset_launch_counts()
        for i in range(STEPS):
            lr = LR if i % 3 else 0.5 * LR
            captured = step(model, captured, lr)
            held.append(captured)
            captured = captured[0]
        replayed = cs.launch_counts()
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
        before = cs.launch_counts()
        captured = step(model, captured, lr, x0_lr)
        e_capt = elbo_of(model, captured)
        made = {k: v - before[k] for k, v in cs.launch_counts().items()}
        eager = packed_inference_step(model, eager, lr, x0_lr)
        _assert_bits_equal(captured, eager, f"step {i}")
        _assert_bits_equal(e_capt, packed_vdp_elbo(model, eager), f"elbo {i}")
        assert made["linear_recurrence"] == 6 and sum(made.values()) == 6
    assert (step.captures, step.replays, elbo_of.captures) == (1, STEPS - 1, 1)


def _trainer_elbos(trainer_cls, model, eager: bool, **kwargs):
    trainer = trainer_cls(model, **kwargs)
    if eager:  # the same loop with the raw steps, as the reference jits them
        if trainer_cls is CVISitesTrainer:
            pack, unpack, step, elbo = trainer._packed
            trainer._packed = (pack, unpack, step.fn, elbo.fn)
        else:
            trainer._step, trainer._elbo = trainer._step.fn, trainer._elbo.fn
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
