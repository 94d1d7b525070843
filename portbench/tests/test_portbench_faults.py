"""The check fails the control and each fault a fit can have, at a tiny
size on the CPU: the program with its float64 policy off (the control),
an inner step that returns its state unchanged, half of the observations
left out of the data term with the rest counted twice, and an answer
altered where it is produced."""
import pytest
import torch

CONTROL_JOB = '''from portbench.jobs.cvi_fit import CHECKS, Job as _Job  # noqa: F401


class Job(_Job):
    def __init__(self, config, traffic, device, x64=True):
        super().__init__(config, traffic, device, x64=False)
'''


@pytest.mark.parametrize("config", ["dw1d", "vdp2d"])
def test_control_is_not_correct(checkout, restore_x64, config):
    from conftest import TINY

    checkout.write("jobs/cvi_fit_x64off.py", CONTROL_JOB)
    checkout.add_cell(f"{config}.control", config, "tiny_x64off",
                      dict(TINY, job="cvi_fit_x64off"))
    result = checkout.run(f"{config}.control")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _unchanged_step(monkeypatch):
    from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed, cvi_dp_packed_ch

    for module, elbo in ((cvi_dp_packed, cvi_dp_packed.packed_elbo),
                         (cvi_dp_packed_ch, cvi_dp_packed_ch.packed_elbo_ch)):
        monkeypatch.setattr(module, module.__name__.endswith("_ch") and "packed_natgrad_step_ch"
                            or "packed_natgrad_step",
                            lambda model, state, lr, elbo=elbo, **kw: (state, elbo(model, state)))


def _half_the_observations(monkeypatch):
    from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed, cvi_dp_packed_ch

    for module in (cvi_dp_packed, cvi_dp_packed_ch):
        original = module._masked_ve

        def half(model, state, means, variances, original=original):
            kept = torch.nonzero(state.obs_mask).flatten()[::2]
            mask = torch.zeros_like(state.obs_mask)
            mask[kept] = 2.0
            return original(model, state.replace(obs_mask=mask), means, variances)

        monkeypatch.setattr(module, "_masked_ve", half)


def _altered_answer(monkeypatch):
    from vi_diffusion_processes_tpu_torch.ssm.state_space_model import StateSpaceModel

    original = StateSpaceModel.marginals

    def altered(self):
        means, covs = original(self)
        means = means.clone()
        means[..., means.shape[-2] // 2, :] *= 1.0 + 1e-3
        return means, covs

    monkeypatch.setattr(StateSpaceModel, "marginals", altered)


@pytest.mark.parametrize("config", ["dw1d", "vdp2d"])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_the_observations, _altered_answer])
def test_fault_is_not_correct(checkout, monkeypatch, config, fault):
    fault(monkeypatch)
    result = checkout.run(f"{config}.tiny")
    assert result["correct"] is False
