"""What the examples share: the ``--device`` flag, numpy inputs as float64
tensors on the run's device, and a draw source of standard normals from
numpy."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ssm.state_space_model import SSM_FIELDS

F64 = torch.float64


def parse_device(description: str):
    """The ``--device`` flag of an example's command line (the card when it
    is left out)."""
    parser = argparse.ArgumentParser(description=description.strip().splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="a torch device such as cpu or cuda:0 (default: the CUDA card)")
    return parser.parse_args().device


def tensors(device, *arrays):
    """Each array as a float64 tensor on ``device``."""
    return tuple(torch.as_tensor(np.asarray(a), dtype=F64, device=device) for a in arrays)


def trainable(ssm):
    """``ssm`` with each of its fields a fresh leaf that requires a gradient,
    and those leaves, for an optimizer."""
    leaves = {k: getattr(ssm, k).detach().clone().requires_grad_() for k in SSM_FIELDS}
    return ssm.replace(**leaves), list(leaves.values())


def numpy_normals(seed: int):
    """A draw source for the samplers' ``generator`` argument (see
    :meth:`~..ssm.state_space_model.StateSpaceModel.sample`): each call
    returns the next standard normals of numpy's ``default_rng(seed)``, on
    the device and in the dtype asked for.  The same draws on any device,
    and the same as a reference fed from the same numpy generator in the
    same order; for comparisons, not for inference."""
    rng = np.random.default_rng(seed)

    def normal(shape, dtype=F64, device=None):
        return torch.as_tensor(rng.normal(size=tuple(shape)), dtype=dtype, device=device)

    return normal


def scaled_err(got, want) -> float:
    """``max|got − want|`` as a share of ``max|want|`` (inf on a shape
    mismatch)."""
    a = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got, np.float64)
    b = np.asarray(want.detach().cpu() if torch.is_tensor(want) else want, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if not b.size:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def errors(module, got: dict, want: dict) -> dict:
    """For each output in ``want``: ``(error, limit)`` of ``got``'s, with the
    example module's ``RTOL``, its ``RTOLS`` for named outputs, and its
    ``ENTRY_RTOLS`` (output → (index, limit)) for single entries, which are
    then left out of the output's own comparison."""
    out = {}
    for key, ref in want.items():
        value = got[key]
        entry = getattr(module, "ENTRY_RTOLS", {}).get(key)
        if entry is not None:
            index, limit = entry
            value = np.array(value.detach().cpu() if torch.is_tensor(value) else value, np.float64)
            ref = np.array(ref.detach().cpu() if torch.is_tensor(ref) else ref, np.float64)
            out[f"{key}{list(index)}"] = (scaled_err(value[index], ref[index]), limit)
            value[index] = ref[index] = 0.0
        out[key] = (scaled_err(value, ref), getattr(module, "RTOLS", {}).get(key, module.RTOL))
    return out
