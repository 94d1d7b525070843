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
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import resolve_device
from .exp.data import DPDataset
from .kernels import base as kernels_base
from .kernels import composite, matern, misc, spatial
from .kernels.spatio_temporal import SparseSpatioTemporalKernel
from .likelihoods.discrete import Bernoulli, Poisson
from .likelihoods.gaussian import Gaussian as GaussianLikelihood
from .likelihoods.multistage import MultiStageLikelihood
from .likelihoods.pep import PEPGaussian, PEPScalarLikelihood
from .models.cvi import CVIGaussianProcess, GaussianSites
from .models.cvi_dp import CVISitesSDE, DataSites
from .models.cvi_dp_packed import PackedCVIState
from .models.cvi_dp_packed_batched import BatchedPackedCVIState
from .models.cvi_packed import PackedCVIGPState
from .models.gpr import GaussianProcessRegression
from .models.iwvi import ImportanceWeightedVI
from .models.pep import PowerExpectationPropagation
from .models.sparse_pep import SparsePowerExpectationPropagation
from .models.svgp import SparseVariationalGaussianProcess
from .models.variational import VariationalGaussianProcess
from .models.sparse_cvi import SparseCVIGaussianProcess
from .models.spatio_packed import PackedSpatioState
from .models.spatio_temporal import SpatioTemporalSparseCVI, SpatioTemporalSparseVariational
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
    "kernel_from_numpy",
    "kernel_params_to_numpy",
    "gpr_from_numpy",
    "cvi_from_numpy",
    "packed_cvi_state_from_numpy",
    "sparse_cvi_from_numpy",
    "spatio_cvi_from_numpy",
    "spatio_variational_from_numpy",
    "packed_spatio_state_from_numpy",
    "vgp_from_numpy",
    "svgp_from_numpy",
    "pep_from_numpy",
    "sparse_pep_from_numpy",
    "iwvi_from_numpy",
    "fields_to_numpy",
]


def _t(x, device):
    return torch.as_tensor(np.asarray(x), device=device)


def sde_from_numpy(name: str, leaves: Mapping, device=None):
    """SDE from its JAX leaves, by class name: ``"DoubleWellSDE"`` (``q_mat``,
    ``scale``, ``c``), ``"OrnsteinUhlenbeckSDE"`` (``decay``, ``q_mat``),
    ``"BenesSDE"``, ``"SineDiffusionSDE"``, ``"SqrtDiffusionSDE"`` (``theta``,
    ``q_mat``), ``"MLPDrift"`` (``w1``, ``b1``, ``w2``, ``b2``, ``q_mat``) or
    ``"VanderPolOscillatorSDE"`` (``a``, ``tau``, ``q_mat [2, 2]``)."""
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
    elif name == "VanderPolOscillatorSDE":
        sde = zoo.VanderPolOscillatorSDE(a=leaves["a"], tau=leaves["tau"], q=q, dtype=dtype)
    else:
        raise ValueError(f"unknown SDE {name!r}")
    return sde.to(resolve_device(device))


def likelihood_from_numpy(leaves: Mapping, device=None, name: str = "Gaussian"):
    """Likelihood from its JAX leaves, by class name: ``"Gaussian"``
    (``variance``), ``"Poisson"`` (``binsize``), ``"Bernoulli"`` or
    ``"MultiStageLikelihood"`` (none); the power-EP wrappers
    ``"PEPScalarLikelihood"`` and ``"PEPGaussian"`` take their base's
    ``(name, leaves)`` pair."""
    if name in ("PEPScalarLikelihood", "PEPGaussian"):
        base = likelihood_from_numpy(leaves[1], device, name=leaves[0])
        return (PEPGaussian if name == "PEPGaussian" else PEPScalarLikelihood)(base)
    if name == "MultiStageLikelihood":
        lik = MultiStageLikelihood()
    elif name == "Gaussian":
        variance = np.asarray(leaves["variance"])
        lik = GaussianLikelihood(variance, dtype=torch.as_tensor(variance).dtype)
    elif name == "Poisson":
        lik = Poisson(binsize=float(leaves.get("binsize", 1.0)))
    elif name == "Bernoulli":
        lik = Bernoulli()
    else:
        raise ValueError(f"unknown likelihood {name!r}")
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


_LEAF_KERNELS = {
    "Matern12": (matern.Matern12, ("lengthscale", "variance")),
    "Matern32": (matern.Matern32, ("lengthscale", "variance")),
    "Matern52": (matern.Matern52, ("lengthscale", "variance")),
    "OrnsteinUhlenbeck": (matern.OrnsteinUhlenbeck, ("decay", "diffusion")),
    "Constant": (misc.Constant, ("variance",)),
    "HarmonicOscillator": (misc.HarmonicOscillator, ("variance", "period")),
}
_SPATIAL_KERNELS = {
    "SpatialRBF": spatial.SpatialRBF,
    "SpatialMatern12": spatial.SpatialMatern12,
    "SpatialMatern32": spatial.SpatialMatern32,
}
_COMBINATORS = {
    "Sum": kernels_base.Sum,
    "Product": kernels_base.Product,
    "IndependentMultiOutput": kernels_base.IndependentMultiOutput,
    "StackKernel": composite.StackKernel,
    "IndependentMultiOutputStack": composite.IndependentMultiOutputStack,
}


def kernel_from_numpy(
    name: str, leaves: Union[Mapping, Sequence[Tuple[str, object]]], device=None
):
    """Kernel from its JAX leaves, by class name.  A leaf kernel takes a
    mapping of its fields (``lengthscale`` and ``variance`` for the Matern
    family, ``decay`` and ``diffusion`` for ``"OrnsteinUhlenbeck"``,
    ``variance`` for ``"Constant"``, ``variance`` and ``period`` for
    ``"HarmonicOscillator"``, each with an optional ``state_mean``; ``N`` and
    ``R`` for ``"LatentExponentiallyGenerated"``; ``variance`` and
    ``lengthscale`` for the spatial kernels ``"SpatialRBF"``,
    ``"SpatialMatern12"``, ``"SpatialMatern32"``).  A combinator (``"Sum"``,
    ``"Product"``, ``"IndependentMultiOutput"``, ``"StackKernel"``,
    ``"IndependentMultiOutputStack"``) takes the list of its parts, each a
    ``(name, leaves)`` pair; ``"PiecewiseKernel"`` a mapping of ``kernels``
    (that list) and ``change_points``; ``"FactorAnalysisKernel"`` a mapping
    of ``kernels``, ``loading_matrix``, ``output_dim`` and
    ``weight_function``, a function of the time points' tensor to
    ``[..., N, o, m]`` written in torch.  ``"SparseSpatioTemporalKernel"`` takes a
    mapping of ``kernel_space`` and ``kernel_time``, each a ``(name, leaves)``
    pair, and ``inducing_space``: its one temporal kernel serves every
    spatial inducing point, as in the JAX package, whose tuple holds the same
    kernel M times.  The parameters take the dtype of the leaves."""
    device = resolve_device(device)
    if name == "SparseSpatioTemporalKernel":
        return SparseSpatioTemporalKernel.build(
            kernel_from_numpy(*leaves["kernel_space"], device=device),
            kernel_from_numpy(*leaves["kernel_time"], device=device),
            _t(leaves["inducing_space"], device),
        )
    if name == "PiecewiseKernel":
        return composite.PiecewiseKernel(
            [kernel_from_numpy(part, sub, device=device) for part, sub in leaves["kernels"]],
            _t(leaves["change_points"], device),
        )
    if name == "FactorAnalysisKernel":
        loading = np.asarray(leaves["loading_matrix"])
        return composite.FactorAnalysisKernel(
            [kernel_from_numpy(part, sub, device=device) for part, sub in leaves["kernels"]],
            loading, leaves["weight_function"], leaves["output_dim"],
            dtype=torch.as_tensor(loading).dtype,
        ).to(device)
    if name in _COMBINATORS:
        parts = [kernel_from_numpy(part, sub, device=device) for part, sub in leaves]
        return _COMBINATORS[name](parts)
    if name == "LatentExponentiallyGenerated":
        n = np.asarray(leaves["N"])
        kernel = misc.LatentExponentiallyGenerated(
            N=n, R=np.asarray(leaves["R"]), dtype=torch.as_tensor(n).dtype
        )
    elif name in _SPATIAL_KERNELS:
        variance = np.asarray(leaves["variance"])
        kernel = _SPATIAL_KERNELS[name](
            variance, np.asarray(leaves["lengthscale"]), dtype=torch.as_tensor(variance).dtype
        )
    elif name in _LEAF_KERNELS:
        cls, fields = _LEAF_KERNELS[name]
        values = {k: np.asarray(leaves[k]) for k in fields}
        state_mean = leaves.get("state_mean")
        kernel = cls(
            **values,
            state_mean=None if state_mean is None else np.asarray(state_mean),
            dtype=torch.as_tensor(values[fields[0]]).dtype,
        )
    else:
        raise ValueError(f"unknown kernel {name!r}")
    return kernel.to(device)


def kernel_params_to_numpy(kernel) -> dict:
    """``{parameter name: numpy array}`` of a kernel's ``nn.Parameter``s: the
    JAX dataclass's field names, prefixed ``kernels.<i>.`` inside a
    combinator.  A module that a kernel holds several times (the temporal
    kernel of ``SparseSpatioTemporalKernel``) is named once, under its first
    place."""
    return {name: p.detach().cpu().numpy() for name, p in kernel.named_parameters()}


def gpr_from_numpy(
    tree: Mapping, kernel, mean_function=None, device=None
) -> GaussianProcessRegression:
    """``GaussianProcessRegression`` from the JAX model's array fields
    (``time_points``, ``observations``, ``chol_obs_covariance``); ``kernel``
    and ``mean_function`` are port objects (see :func:`kernel_from_numpy`)."""
    device = resolve_device(device)
    return GaussianProcessRegression(
        kernel=kernel,
        mean_function=mean_function,
        **{k: _t(tree[k], device) for k in ("time_points", "observations", "chol_obs_covariance")},
    )


def cvi_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> CVIGaussianProcess:
    """``CVIGaussianProcess`` from the JAX model's fields (``time_points``,
    ``observations``, ``sites`` with ``nat1`` and ``nat2``,
    ``learning_rate``); ``kernel``, ``likelihood`` and ``mean_function`` are
    port objects (see :func:`kernel_from_numpy`, :func:`likelihood_from_numpy`)."""
    device = resolve_device(device)
    return CVIGaussianProcess(
        kernel=kernel,
        likelihood=likelihood,
        time_points=_t(tree["time_points"], device),
        observations=_t(tree["observations"], device),
        sites=GaussianSites(nat1=_t(tree["sites"]["nat1"], device),
                            nat2=_t(tree["sites"]["nat2"], device)),
        mean_function=mean_function,
        learning_rate=float(tree["learning_rate"]),
    )


def packed_cvi_state_from_numpy(tree: Mapping, device=None) -> PackedCVIGPState:
    """``PackedCVIGPState`` from the JAX state's fields.  The JAX state keeps
    the prior naturals as channel tuples (``p_nat1`` a d-tuple of ``[T]``,
    ``p_nat2d`` d × d of ``[T]``, ``p_nat2s`` d × d of ``[T−1]``); they are
    stacked into ``[T, d]``, ``[T, d, d]`` and ``[T−1, d, d]``."""
    device = resolve_device(device)

    def mat(rows):
        return np.stack([np.stack([np.asarray(x) for x in row], -1) for row in rows], -2)

    fields = {f: _t(tree[f], device) for f in ("d_nat1", "d_nat2", "fx_mu", "fx_var", "h", "y")}
    return PackedCVIGPState(
        p_nat1=_t(np.stack([np.asarray(x) for x in tree["p_nat1"]], -1), device),
        p_nat2d=_t(mat(tree["p_nat2d"]), device),
        p_nat2s=_t(mat(tree["p_nat2s"]), device),
        **fields,
    )


def sparse_cvi_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> SparseCVIGaussianProcess:
    """``SparseCVIGaussianProcess`` from the JAX model's fields
    (``inducing_points``, ``nat1``, ``nat2``, ``learning_rate``)."""
    device = resolve_device(device)
    return SparseCVIGaussianProcess(
        kernel=kernel,
        likelihood=likelihood,
        mean_function=mean_function,
        learning_rate=float(tree["learning_rate"]),
        **{k: _t(tree[k], device) for k in ("inducing_points", "nat1", "nat2")},
    )


def spatio_cvi_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> SpatioTemporalSparseCVI:
    """``SpatioTemporalSparseCVI`` from the JAX model's fields
    (``inducing_time``, ``nat1``, ``nat2``, ``num_data``, ``learning_rate``);
    ``kernel`` is a port ``SparseSpatioTemporalKernel``."""
    device = resolve_device(device)
    return SpatioTemporalSparseCVI(
        kernel=kernel,
        likelihood=likelihood,
        mean_function=mean_function,
        num_data=tree.get("num_data"),
        learning_rate=float(tree["learning_rate"]),
        **{k: _t(tree[k], device) for k in ("inducing_time", "nat1", "nat2")},
    )


def spatio_variational_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> SpatioTemporalSparseVariational:
    """``SpatioTemporalSparseVariational`` from the JAX model's fields
    (``inducing_time``, ``dist_q``, ``num_data``)."""
    device = resolve_device(device)
    return SpatioTemporalSparseVariational(
        kernel=kernel,
        likelihood=likelihood,
        inducing_time=_t(tree["inducing_time"], device),
        dist_q=_ssm(tree["dist_q"], device),
        mean_function=mean_function,
        num_data=tree.get("num_data"),
    )


def packed_spatio_state_from_numpy(tree: Mapping, device=None) -> PackedSpatioState:
    """``PackedSpatioState`` from the JAX state's fields: ``nat1 [Mt+1, 2d]``
    and ``nat2_sym [Mt+1, C]``, the upper triangle of each symmetric block
    row by row (spatio_packed.py:81-98), which is unfolded to ``nat2
    [Mt+1, 2d, 2d]``."""
    nat1 = np.asarray(tree["nat1"])
    folded = np.asarray(tree["nat2_sym"])
    two_d = nat1.shape[-1]
    rows, cols = np.triu_indices(two_d)
    nat2 = np.zeros(folded.shape[:-1] + (two_d, two_d), folded.dtype)
    nat2[..., rows, cols] = folded
    nat2[..., cols, rows] = folded
    device = resolve_device(device)
    return PackedSpatioState(nat1=_t(nat1, device), nat2=_t(nat2, device))


def vgp_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> VariationalGaussianProcess:
    """``VariationalGaussianProcess`` from the JAX model's fields
    (``time_points``, ``observations``, ``dist_q``)."""
    device = resolve_device(device)
    return VariationalGaussianProcess(
        kernel=kernel,
        likelihood=likelihood,
        time_points=_t(tree["time_points"], device),
        observations=_t(tree["observations"], device),
        dist_q=_ssm(tree["dist_q"], device),
        mean_function=mean_function,
    )


def svgp_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> SparseVariationalGaussianProcess:
    """``SparseVariationalGaussianProcess`` from the JAX model's fields
    (``inducing_points``, ``dist_q``, ``num_data``)."""
    device = resolve_device(device)
    return SparseVariationalGaussianProcess(
        kernel=kernel,
        likelihood=likelihood,
        inducing_points=_t(tree["inducing_points"], device),
        dist_q=_ssm(tree["dist_q"], device),
        mean_function=mean_function,
        num_data=tree.get("num_data"),
    )


def pep_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> PowerExpectationPropagation:
    """``PowerExpectationPropagation`` from the JAX model's fields
    (``time_points``, ``observations``, ``sites`` with ``nat1`` and ``nat2``,
    ``site_log_norm``, ``alpha``, ``learning_rate``); ``likelihood`` is a
    port power-EP wrapper."""
    device = resolve_device(device)
    return PowerExpectationPropagation(
        kernel=kernel,
        likelihood=likelihood,
        sites=GaussianSites(nat1=_t(tree["sites"]["nat1"], device),
                            nat2=_t(tree["sites"]["nat2"], device)),
        mean_function=mean_function,
        alpha=float(tree["alpha"]),
        learning_rate=float(tree["learning_rate"]),
        **{k: _t(tree[k], device) for k in ("time_points", "observations", "site_log_norm")},
    )


def sparse_pep_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> SparsePowerExpectationPropagation:
    """``SparsePowerExpectationPropagation`` from the JAX model's fields
    (``inducing_points``, ``nat1``, ``nat2``, ``log_norm``, ``alpha``,
    ``learning_rate``)."""
    device = resolve_device(device)
    return SparsePowerExpectationPropagation(
        kernel=kernel,
        likelihood=likelihood,
        mean_function=mean_function,
        alpha=float(tree["alpha"]),
        learning_rate=float(tree["learning_rate"]),
        **{k: _t(tree[k], device) for k in ("inducing_points", "nat1", "nat2", "log_norm")},
    )


def iwvi_from_numpy(
    tree: Mapping, kernel, likelihood, mean_function=None, device=None
) -> ImportanceWeightedVI:
    """``ImportanceWeightedVI`` from the JAX model's fields
    (``inducing_points``, ``dist_q``, ``num_importance_samples``)."""
    device = resolve_device(device)
    return ImportanceWeightedVI(
        kernel=kernel,
        likelihood=likelihood,
        inducing_points=_t(tree["inducing_points"], device),
        dist_q=_ssm(tree["dist_q"], device),
        mean_function=mean_function,
        num_importance_samples=int(tree["num_importance_samples"]),
    )


def fields_to_numpy(obj):
    """A port dataclass or named tuple of tensors as nested dicts of numpy
    arrays keyed by field name (the inverse of the ``*_from_numpy``
    converters on their array fields); other values are returned as they
    are, modules included."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: fields_to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_asdict"):
        return {k: fields_to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj
