"""Carry values of the JAX package across into the port.

Each converter takes numpy arrays keyed by the JAX package's field names
(nested dicts for nested dataclasses and named tuples) and builds the
port's object on ``device``: the CUDA card unless the caller names another
device (``device="cpu"`` on a machine without one).  The port imports no
JAX: the caller does the ``np.asarray`` on every leaf, so the same model,
weights and state can be fed to both implementations.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from .config import resolve_device
from .exp.data import DPDataset
from .likelihoods.gaussian import Gaussian as GaussianLikelihood
from .models.cvi_dp import CVISitesSDE, DataSites
from .models.cvi_dp_packed import PackedCVIState
from .models.cvi_dp_packed_batched import BatchedPackedCVIState
from .models.vdp import VariationalMarkovGP
from .models.vdp_packed import PackedVDPState
from .sde import zoo
from .sde.utils import BTDNaturals, Gaussian
from .ssm.state_space_model import StateSpaceModel

__all__ = [
    "sde_from_numpy",
    "likelihood_from_numpy",
    "cvi_dp_from_numpy",
    "packed_state_from_numpy",
    "batched_packed_state_from_numpy",
    "vdp_from_numpy",
    "packed_vdp_state_from_numpy",
    "dataset_from_numpy",
    "sde_params_to_numpy",
]


def _t(x, device):
    return torch.as_tensor(np.asarray(x), device=device)


def sde_from_numpy(name: str, leaves: Mapping, device=None):
    """SDE from its JAX leaves, by class name: ``"DoubleWellSDE"`` (``q_mat``,
    ``scale``, ``c``), ``"OrnsteinUhlenbeckSDE"`` (``decay``, ``q_mat``),
    ``"BenesSDE"``, ``"SineDiffusionSDE"``, ``"SqrtDiffusionSDE"`` (``theta``,
    ``q_mat``) or ``"MLPDrift"`` (``w1``, ``b1``, ``w2``, ``b2``, ``q_mat``)."""
    q = np.asarray(leaves["q_mat"])
    dtype = torch.as_tensor(q).dtype
    if name == "DoubleWellSDE":
        sde = zoo.DoubleWellSDE(q=q, scale=leaves["scale"], c=leaves["c"], dtype=dtype)
    elif name == "OrnsteinUhlenbeckSDE":
        sde = zoo.OrnsteinUhlenbeckSDE(decay=leaves["decay"], q=q, dtype=dtype)
    elif name in ("BenesSDE", "SineDiffusionSDE", "SqrtDiffusionSDE"):
        sde = getattr(zoo, name)(theta=np.asarray(leaves["theta"]), q=q, dtype=dtype)
    elif name == "MLPDrift":
        sde = zoo.MLPDrift(
            *(np.asarray(leaves[k]) for k in ("w1", "b1", "w2", "b2")), q=q, dtype=dtype
        )
    else:
        raise NotImplementedError(f"SDE {name!r} is not ported yet (slice E of ROADMAP.md)")
    return sde.to(resolve_device(device))


def likelihood_from_numpy(leaves: Mapping, device=None) -> GaussianLikelihood:
    """Gaussian likelihood from its JAX leaves (``variance``)."""
    variance = np.asarray(leaves["variance"])
    lik = GaussianLikelihood(variance, dtype=torch.as_tensor(variance).dtype)
    return lik.to(resolve_device(device))


def _ssm(tree: Mapping, device) -> StateSpaceModel:
    return StateSpaceModel(
        **{k: _t(tree[k], device) for k in (
            "initial_mean",
            "chol_initial_covariance",
            "state_transitions",
            "state_offsets",
            "chol_process_covariances",
        )}
    )


def _nats(tree: Optional[Mapping], device) -> Optional[BTDNaturals]:
    if tree is None:
        return None
    return BTDNaturals(*(_t(tree[k], device) for k in BTDNaturals._fields))


def cvi_dp_from_numpy(tree: Mapping, prior_sde, likelihood, device=None) -> CVISitesSDE:
    """``CVISitesSDE`` from the JAX model's fields.  ``prior_sde`` and
    ``likelihood`` are port objects (see :func:`sde_from_numpy`)."""
    device = resolve_device(device)
    return CVISitesSDE(
        dist_p=None if tree["dist_p"] is None else _ssm(tree["dist_p"], device),
        likelihood=likelihood,
        time_grid=_t(tree["time_grid"], device),
        obs_indices=_t(tree["obs_indices"], device).long(),
        observations=_t(tree["observations"], device),
        girsanov_sites=_nats(tree["girsanov_sites"], device),
        data_sites=DataSites(
            nat1=_t(tree["data_sites"]["nat1"], device),
            nat2=_t(tree["data_sites"]["nat2"], device),
        ),
        prior_initial_state=Gaussian(
            mu=_t(tree["prior_initial_state"]["mu"], device),
            cov=_t(tree["prior_initial_state"]["cov"], device),
        ),
        fx_mus=_t(tree["fx_mus"], device),
        fx_covs=_t(tree["fx_covs"], device),
        prior_nats=_nats(tree.get("prior_nats"), device),
        prior_sde=prior_sde,
        stabilize_ssm=bool(tree.get("stabilize_ssm", True)),
        clip_state_transitions=tuple(tree.get("clip_state_transitions", (-1.0, 1.0))),
    )


def _fields_from_numpy(cls, tree: Mapping, device):
    """A dataclass of tensors from the JAX dataclass's fields of the same names."""
    device = resolve_device(device)
    return cls(**{f.name: _t(tree[f.name], device) for f in dataclasses.fields(cls)})


def packed_state_from_numpy(tree: Mapping, device=None) -> PackedCVIState:
    """``PackedCVIState`` from the JAX state's fields."""
    return _fields_from_numpy(PackedCVIState, tree, device)


def batched_packed_state_from_numpy(tree: Mapping, device=None) -> BatchedPackedCVIState:
    """``BatchedPackedCVIState`` from the JAX state's fields."""
    return _fields_from_numpy(BatchedPackedCVIState, tree, device)


def packed_vdp_state_from_numpy(tree: Mapping, device=None) -> PackedVDPState:
    """``PackedVDPState`` from the JAX state's fields."""
    return _fields_from_numpy(PackedVDPState, tree, device)


def vdp_from_numpy(tree: Mapping, prior_sde, likelihood, device=None) -> VariationalMarkovGP:
    """``VariationalMarkovGP`` from the JAX model's fields.  ``prior_sde`` and
    ``likelihood`` are port objects (see :func:`sde_from_numpy`)."""
    device = resolve_device(device)
    tensors = {
        f.name: _t(tree[f.name], device)
        for f in dataclasses.fields(VariationalMarkovGP)
        if f.name not in ("prior_sde", "likelihood", "stabilize")
    }
    tensors["obs_indices"] = tensors["obs_indices"].long()
    return VariationalMarkovGP(
        prior_sde=prior_sde, likelihood=likelihood,
        stabilize=bool(tree.get("stabilize", False)), **tensors,
    )


def dataset_from_numpy(tree: Mapping, device=None) -> DPDataset:
    """``DPDataset`` from the JAX dataset's fields (exp/data.py:30)."""
    device = resolve_device(device)
    return DPDataset(
        **{
            k: float(tree[k]) if k == "noise_stddev" else _t(tree[k], device)
            for k in DPDataset._fields
        }
    )


def sde_params_to_numpy(sde) -> dict:
    """``{parameter name: numpy array}`` of an SDE's ``nn.Parameter``s, the
    JAX pytree's leaf names (``q_mat``, ``scale``, ``c`` for the double well)."""
    return {name: p.detach().cpu().numpy() for name, p in sde.named_parameters()}
