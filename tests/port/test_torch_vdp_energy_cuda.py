"""VDP's drift energy kernels (``ops/quad_kl.py``, ``csrc/quad_kl.cu``) on
the card: against their plain PyTorch version, inside VDP's step, and a
whole fit through them against the same fit through the plain route.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_vdp_energy_cuda.py --confcutdir=tests/port -m cuda

The inputs are those that VDP's step hands the kernel in the benchmark cell
``vanderpol_vdp.fit10k`` (``portbench/jobs/vdp_fit.py``: float64, T = 10,000,
the pool's first dataset), at its first step (``A = b = 0``) and after the
20 warm-up steps and 3 steps at the cell's rate, and slices of them: N = 0
launches nothing, N = 1 and 31 leave the last block of 32 part empty.  Each
limit is set against the plain version evaluated in float64 on the
kernel's own inputs (the readings are in ``PERF.md``):

* float64: 1e-12 relative for ``e`` and 1e-12 of each cotangent's largest
  magnitude; only the order of the sum over the 400 points differs (the
  readings at T = 10,000 and 100,000: 1.1e-15 and 4.3e-15 at most);
* float32: 1e-5 against the float64 plain version on the same float32
  inputs (the readings: 4.9e-7 and 4.4e-7 at most).

At the first step the marginal means are 0 and the grid is symmetric, so
the cotangents of ``μ`` and ``b`` vanish but for rounding: there each
cotangent is held to the largest magnitude of the four.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

from vi_diffusion_processes_tpu_torch.models import vdp as vdp_mod
from vi_diffusion_processes_tpu_torch.ops import quad_kl as qk
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.jobs import vdp_fit  # noqa: E402
from portbench.reference import data as refdata  # noqa: E402

pytestmark = pytest.mark.cuda

NAMES = ("mu", "L", "A", "b")
#: (relative limit of e, limit of each cotangent over its largest magnitude)
LIMITS = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}
#: bytes of one [T−1, 400, 2] float64 tensor at T = 10,000
POINT_TENSOR_BYTES = 9_999 * 400 * 2 * 8


class PlainVanderPol(VanderPolOscillatorSDE):
    """The Van der Pol SDE with a drift of its own, the same formula: no
    kernel claims it, so VDP takes the plain route on the card."""

    def drift(self, x, t=None):
        return super().drift(x, t)


def _cell(dev):
    """The cell's configuration, a job on ``dev`` and the pool's datasets
    (the first is the harness's warm-up, then the four of the pool)."""
    cfg = json.loads((REPO / "portbench/configs/vanderpol_vdp.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/vdp_fit10k.json").read_text())
    pool = refdata.draw_pool(cfg, traffic["num_grid"], traffic["num_observations"],
                             traffic["pool"] + 1, traffic["pool_seed"])
    job = vdp_fit.Job(cfg, traffic, dev)
    return cfg, job, job.load(pool)


def _plain(sde):
    return PlainVanderPol(a=sde.a.detach(), tau=sde.tau.detach(), q=sde.q.detach(),
                          dtype=sde.q.dtype).to(sde.q.device)


def _model(job, data, sde=None):
    grid, obs_t, obs_y = data
    return vdp_mod.VariationalMarkovGP.initialize((obs_t, obs_y), sde or job.sde, grid,
                                                  job.likelihood)


def _kernel_inputs(model):
    """The arguments that one step hands ``vdp_energy``, detached:
    ``([μ, L, A, b, Σ⁻¹], (z, w), (a, τ))``."""
    calls, real = [], vdp_mod.vdp_energy
    vdp_mod.vdp_energy = lambda *args: calls.append(args) or real(*args)
    try:
        model.inference_step(1e-6, 0.0)
    finally:
        vdp_mod.vdp_energy = real
    *tensors, z, w, _, params = calls[0]
    return [x.detach() for x in tensors], (z, w), params


@pytest.fixture(scope="module")
def transitions():
    """The kernel's inputs at the first step and after 23 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    cfg, job, data = _cell(torch.device("cuda", 0))
    model = _model(job, data[1])
    first = _kernel_inputs(model)
    for _ in range(cfg["warmup_steps"]):
        model = model.inference_step(cfg["warmup_lr"], 0.0)
    for _ in range(3):
        model = model.inference_step(cfg["vdp_lr"], cfg["x0_lr"])
    return {"first": first, "later": _kernel_inputs(model)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("state,n", [("later", 0), ("later", 1), ("later", 31),
                                     ("later", 9_999), ("first", 9_999)])
def test_kernels_against_the_plain_version(transitions, dtype, state, n):
    """``e`` and the four cotangents of ``g_e`` (random) by the two kernels,
    against the plain forward and autograd through it in float64 on the
    same inputs; one launch of each kernel (none at N = 0)."""
    tensors, grid, params = transitions[state]
    tensors = [x[:n].contiguous().to(dtype) for x in tensors[:4]] + [tensors[4].to(dtype)]
    grid, params = [x.to(dtype) for x in grid], [x.to(dtype) for x in params]
    g_e = torch.randn(n, generator=torch.Generator().manual_seed(n), dtype=torch.float64)
    g_e = g_e.to(dtype).cuda()
    leaves = [x.clone().requires_grad_() for x in tensors[:4]]
    reset_launch_counts()
    e = qk.vdp_energy(*leaves, tensors[4], *grid, "vanderpol", params)
    grads = torch.autograd.grad(e, leaves, g_e)
    torch.cuda.synchronize()
    launched = int(n > 0)
    assert (launch_counts()["vdp_energy"], launch_counts()["vdp_energy_adjoint"]) == (
        launched, launched)
    assert e.shape == (n,) and e.dtype == dtype and all(g.dtype == dtype for g in grads)
    if n == 0:
        return

    ref_leaves = [x.double().requires_grad_() for x in tensors[:4]]
    a, tau = (p.double() for p in params)
    ref = qk.vdp_energy_plain(*ref_leaves, tensors[4].double(), *(x.double() for x in grid),
                              lambda x: qk.vanderpol_drift(x, a, tau)[0])
    ref_grads = torch.autograd.grad(ref, ref_leaves, g_e.double())
    e_limit, g_limit = LIMITS[dtype]
    rel = float(((e.detach().double() - ref) / ref.abs()).abs().max())
    assert rel <= e_limit, f"e: {rel:.3e}"
    largest = max(float(r.abs().max()) for r in ref_grads)
    for name, g, r in zip(NAMES, grads, ref_grads):
        scale = largest if state == "first" else float(r.abs().max())
        err = float((g.double() - r).abs().max()) / scale
        assert err <= g_limit, f"{name}: {err:.3e}"


def test_nan_in_chol_gives_nan_on_the_card(transitions):
    """No clamp in the kernels: a NaN in one ``L`` makes that ``e_n`` and
    its cotangents NaN, and no other."""
    tensors, grid, params = transitions["later"]
    tensors = [x[:100].clone() for x in tensors[:4]] + [tensors[4]]
    tensors[1][37, 1, 1] = float("nan")
    e = qk.vdp_energy(*tensors, *grid, "vanderpol", params)
    g = qk.vdp_energy_adjoint(torch.ones_like(e), *tensors, *grid, "vanderpol", params)
    bad = torch.zeros(100, dtype=torch.bool, device=e.device)
    bad[37] = True
    assert torch.equal(torch.isnan(e), bad)
    for name, x in zip(NAMES, g):
        assert torch.equal(torch.isnan(x).flatten(1).any(1), bad), name


def _step_peak_bytes(model):
    """Device memory a step allocates above what is held before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model.inference_step(0.05, 0.05)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def test_step_launches_once_each_and_makes_no_point_tensor(cuda_device):
    """One step at T = 10,000 launches the forward and the adjoint once
    each, an ELBO the forward once; the plain route, under a drift of its
    own, launches neither.  The step's peak memory falls by at least three
    ``[T−1, 400, 2]`` float64 tensors against the plain route's."""
    _, job, data = _cell(cuda_device)
    fused, plain = _model(job, data[1]), _model(job, data[1], _plain(job.sde))
    peaks = {}
    for label, model in (("fused", fused), ("plain", plain)):
        _step_peak_bytes(model)  # the grids, √2 and the library, made once
        reset_launch_counts()
        peaks[label] = _step_peak_bytes(model)
        model.elbo()
        torch.cuda.synchronize()
        counts = launch_counts()
        expected = (2, 1) if label == "fused" else (0, 0)
        assert (counts["vdp_energy"], counts["vdp_energy_adjoint"]) == expected, (label, counts)
    assert peaks["plain"] - peaks["fused"] >= 3 * POINT_TENSOR_BYTES, peaks


def test_fused_fit_is_the_plain_fit(cuda_device):
    """Whole fits of the cell (captured steps and ELBOs, as the benchmark
    runs them) through the kernels and through the plain route, on each of
    the pool's four datasets: the same accepted steps, and every accepted
    ELBO within 1e-9 of the plain fit's, relative to max(|ELBO|, 1).
    Datasets 2 and 3 diverge in both (``PERF.md`` §4)."""
    _, job, data = _cell(cuda_device)
    fused_sde, plain_sde = job.sde, _plain(job.sde)
    for i in range(1, 5):
        job.sde = fused_sde
        fused = job.fit(data[i])
        job.sde = plain_sde
        plain = job.fit(data[i])
        assert len(fused["trace"]) == len(plain["trace"]), i
        assert fused["rounds"] == pytest.approx(plain["rounds"], rel=1e-9, nan_ok=True), i
        for got, ref in zip(fused["trace"], plain["trace"]):
            assert abs(got - ref) <= 1e-9 * max(abs(ref), 1.0), (i, got, ref)
    job.sde = fused_sde
