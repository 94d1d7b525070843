"""The port's VDP fit (``VariationalMarkovGP.initialize`` →
``VDPTrainer.optimize`` → ``forward_pass``, through the benchmark's job
``portbench/jobs/vdp_fit.py``) against the plain reference
``portbench/reference/vdp.py`` on the CPU, in float64.

The datasets are ``portbench/reference/data.draw_pool``'s under the
configuration ``portbench/configs/vanderpol_vdp.json`` (Van der Pol,
a = τ = 1, q = I₂, noise 0.316, the CLI's trainer), on T = 201 points of
[0, 2] with 10 observations (8 train): Δt = 0.01, the step of the CLI's own
grid (1,001 points of [0, 10]).  On 201 points of [0, 10] (Δt = 0.05) the
Euler Lagrange recursion of both diverges after the first step, and every
later candidate is NaN down to the trainer's smallest rate.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.jobs import vdp_fit  # noqa: E402
from portbench.reference import data as refdata  # noqa: E402
from vi_diffusion_processes_tpu_torch import config  # noqa: E402
from vi_diffusion_processes_tpu_torch.optim import trainers  # noqa: E402

CONFIG = dict(json.loads((REPO / "portbench/configs/vanderpol_vdp.json").read_text()), t1=2.0)
LIMITS = json.loads((REPO / "portbench/limits/vanderpol_vdp.fit10k.json").read_text())
T, N_OBS = 201, 10
#: the short run: 2 warm-up steps and 6 iterations
SHORT = dict(warmup_steps=2, max_iters=6)
#: every gap of ``vdp_fit.Job.compare`` in float64: the two sides run the
#: same arithmetic in other orders (doubling scans against the port's
#: blocked scans, closed-form jumps against autograd), and read at most
#: 2.6e-15 on these fits, short and whole; float32 reads 2.7e-7 to 1.3e-6.
#: 1e-10 leaves 10⁴ of room above the one and fails the other by 10³.
TOL = 1e-10


def _answers(seed, x64=True, **changed):
    """The port's fit of dataset 1 of a pool drawn from ``seed``, and the
    reference's, under the configuration with ``changed`` keys."""
    cfg = dict(CONFIG, **changed)
    pool = refdata.draw_pool(cfg, T, N_OBS, 2, seed)
    job = vdp_fit.Job(cfg, {"num_grid": T}, torch.device("cpu"), x64=x64)
    try:
        answer = job.fit(job.load(pool)[1])
    finally:
        config.set_x64_enabled(True)
    return job, answer, job.reference(pool, 1, torch.device("cpu"))


@pytest.mark.parametrize("seed", [33, 34])
def test_short_fit_matches_the_reference(seed):
    job, answer, expected = _answers(seed, **SHORT)
    assert len(answer["trace"]) == SHORT["max_iters"]
    gaps = job.compare(answer, expected)
    assert max(gaps.values()) <= TOL, gaps


def test_stabilized_step_matches_the_reference():
    """The stabilizing clips (``stabilize``, off in the CLI) on 201 points
    of [0, 10], where they act: the first step after two warm-up steps, as
    the reference takes it, and not as the unclipped step.  (The steps
    after it overflow ψ, whose q(x₀) update the program's closed-form 2×2
    inverse and the reference's LAPACK inverse round apart.)"""
    changed = dict(t1=10.0, warmup_steps=2, max_iters=1)
    job, answer, expected = _answers(33, stabilize=True, **changed)
    _, unclipped, _ = _answers(33, stabilize=False, **changed)
    assert answer["trace"] != unclipped["trace"]
    gaps = job.compare(answer, expected)
    assert max(gaps.values()) <= TOL, gaps


def test_whole_fit_matches_the_reference():
    """The CLI's trainer as configured: 20 warm-up steps, then iterations
    until the ELBO moves by less than 1e-4 (97 here) or 200 have run."""
    job, answer, expected = _answers(33)
    assert 50 <= len(answer["trace"]) <= CONFIG["max_iters"]
    assert answer["finite"] and len(answer["trace"]) == len(expected["trace"])
    gaps = job.compare(answer, expected)
    assert max(gaps.values()) <= TOL, gaps


def test_float32_policy_fails_a_tolerance():
    """The program with its float64 policy off, against the same
    reference: at least one gap above the tolerance."""
    job, answer, expected = _answers(33, x64=False, **SHORT)
    assert answer["means"].dtype == torch.float32
    gaps = job.compare(answer, expected)
    assert max(gaps.values()) > TOL, gaps


def _exceeds_a_limit(job, answer, expected):
    gaps = job.compare(answer, expected)
    return any(gaps[key] > LIMITS[key] for key in vdp_fit.CHECKS), gaps


def test_unchanged_step_exceeds_the_cell_limits(monkeypatch):
    """A planted fault: a step that returns its state unchanged."""
    monkeypatch.setattr(trainers, "_vdp_step", lambda model, lr, x0_lr: model)
    exceeds, gaps = _exceeds_a_limit(*_answers(33, **SHORT))
    assert exceeds, gaps


def test_moved_drift_exceeds_the_cell_limits():
    """A planted fault: the answer's ``A`` moved by 1e-3 of itself."""
    job, answer, expected = _answers(33, **SHORT)
    a, b, m0, s0 = answer["drift"]
    answer["drift"] = (a * (1.0 + 1e-3), b, m0, s0)
    exceeds, gaps = _exceeds_a_limit(job, answer, expected)
    assert exceeds, gaps
