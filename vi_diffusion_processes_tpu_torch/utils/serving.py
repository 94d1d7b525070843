"""Serving export: freeze a model function into a ``torch.export`` artifact
(vi_diffusion_processes_tpu/utils/serving.py).

The reference has no serving story.  The JAX package serializes a jitted
function as StableHLO with ``jax.export``; here ``torch.export`` traces the
function once at example inputs into an ``ExportedProgram``, saved as bytes
and reloaded without the model code.  The port's CUDA kernels enter the
program as the custom ops of ``ops/cuda_scan.py`` (``vidp_torch::…``), so a
program exported on the card launches the same kernels when it runs, and
importing the port registers them in the serving process.  A program is
pinned to the device and dtypes of its example inputs; tensors the function
closes over (the model's parameters) are frozen into it.

Typical use::

    model = GaussianProcessRegression(...)
    artifact = export_jittable(lambda tn: model.posterior.predict_f(tn), t_new)
    save_artifact(artifact, "gpr_predict.pt2")
    ...
    predict = load_artifact("gpr_predict.pt2")
    f_mu, f_var = predict(new_times)        # no model object needed
"""
from __future__ import annotations

import io
import pathlib
from typing import Callable, Union

import torch

__all__ = ["export_jittable", "save_artifact", "load_artifact"]


class _Function(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_jittable(fn: Callable, *example_args: torch.Tensor) -> bytes:
    """Trace ``fn`` at ``example_args`` (tensors with the shapes, dtypes and
    device to serve) without gradients, and return the saved
    ``ExportedProgram`` as bytes.  Raises where ``fn`` reads a tensor's value
    on the host, which a traced program cannot do."""
    with torch.no_grad():
        program = torch.export.export(_Function(fn), tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_artifact(artifact: bytes, path: Union[str, pathlib.Path]) -> None:
    pathlib.Path(path).write_bytes(artifact)


def load_artifact(source: Union[bytes, str, pathlib.Path]) -> Callable:
    """Load an artifact (bytes or a file path) into a callable that runs the
    frozen program."""
    from ..ops import cuda_riccati  # noqa: F401 (registers the four ops)

    if not isinstance(source, bytes):
        source = pathlib.Path(source).read_bytes()
    return torch.export.load(io.BytesIO(source)).module()
