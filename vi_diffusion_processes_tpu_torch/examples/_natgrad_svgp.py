"""The natural-gradient SVGP fit that the factor-analysis and stacked-kernel
examples share."""
from __future__ import annotations

import torch

from ..likelihoods.gaussian import Gaussian
from ..models.svgp import SparseVariationalGaussianProcess
from ..optim.natgrad import natgrad_step
from ._common import SSM_FIELDS


def fit(kernel, inducing_points, t, y, steps: int) -> dict:
    """An SVGP with Gaussian(0.01) noise, ``steps`` natural-gradient steps at
    γ = 0.5 on ``q``: the ELBO before, each step's loss, the fitted ``q``'s
    fields and ``predict_f`` at ``t``."""
    model = SparseVariationalGaussianProcess.initialize(
        kernel, Gaussian(0.01).to(t.device), inducing_points)
    data = (t, y)
    q, losses = model.dist_q, []
    with torch.no_grad():
        elbo0 = float(model.elbo(data))
    for _ in range(steps):
        q, _, loss = natgrad_step(lambda qq: model.replace(dist_q=qq).loss(data), q, gamma=0.5)
        losses.append(float(loss))
    with torch.no_grad():
        f_mu, f_var = model.replace(dist_q=q).posterior.predict_f(t)
    out = {"elbo0": elbo0, "losses": losses, "loss": losses[-1], "f_mu": f_mu, "f_var": f_var,
           "batch_shape": list(model.dist_q.batch_shape)}
    out.update({f"q/{name}": getattr(q, name).detach() for name in SSM_FIELDS})
    return out
