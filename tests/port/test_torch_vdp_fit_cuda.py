"""A whole float64 d = 2 VDP fit on the card, as the benchmark cell
``vanderpol_vdp.fit10k`` runs it (``portbench/jobs/vdp_fit.py``:
``VariationalMarkovGP.initialize`` → ``VDPTrainer.optimize`` →
``forward_pass`` at T = 10,000), with its step and ELBO captured, against
the same fit with both run eagerly: bit for bit.  Marked ``cuda``; the file
imports no JAX:

    python -m pytest tests/port/test_torch_vdp_fit_cuda.py --confcutdir=tests/port -m cuda
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
from vi_diffusion_processes_tpu_torch.optim.trainers import VDPTrainer  # noqa: E402

pytestmark = pytest.mark.cuda


def test_captured_fit_is_the_eager_fit(cuda_device):
    cfg = json.loads((REPO / "portbench/configs/vanderpol_vdp.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/vdp_fit10k.json").read_text())
    pool = refdata.draw_pool(cfg, traffic["num_grid"], traffic["num_observations"],
                             traffic["pool"] + 1, traffic["pool_seed"])
    job = vdp_fit.Job(cfg, traffic, cuda_device)
    data = job.load(pool)[1]
    trainers = []

    def made(eager):
        def make(*args, **kwargs):
            trainer = VDPTrainer(*args, **kwargs)
            if eager:  # the same loop with the raw functions
                trainer._step, trainer._elbo = trainer._step.fn, trainer._elbo.fn
            trainers.append(trainer)
            return trainer
        return make

    job._trainer = made(False)
    captured = job.fit(data)
    job._trainer = made(True)
    eager = job.fit(data)
    step, elbo_of = trainers[0]._step, trainers[0]._elbo
    steps = cfg["warmup_steps"] + cfg["max_iters"]
    assert (step.captures, step.replays) == (1, steps - 1)
    assert (elbo_of.captures, elbo_of.replays) == (1, cfg["max_iters"])
    assert len(captured["trace"]) == cfg["max_iters"] and captured["finite"]
    assert captured["trace"] == eager["trace"] and captured["rounds"] == eager["rounds"]
    for got, ref in zip((*captured["drift"], captured["means"], captured["covs"]),
                        (*eager["drift"], eager["means"], eager["covs"])):
        assert got.dtype == ref.dtype == torch.float64
        assert torch.equal(got, ref)
