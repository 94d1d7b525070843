"""Public names of :mod:`vi_diffusion_processes_tpu_torch.models` (vi_diffusion_processes_tpu/models/__init__.py)."""
from .cvi import CVIGaussianProcess, GaussianSites, back_project_nats
from .cvi_dp import CVISitesSDE, CVISitesSSM, DataSites
from .gpr import GaussianProcessRegression
from .iwvi import ImportanceWeightedVI
from .pep import PowerExpectationPropagation
from .posterior import AnalyticPosteriorProcess, ConditionalProcess
from .sparse_cvi import SparseCVIGaussianProcess
from .sparse_pep import SparsePowerExpectationPropagation
from .spatio_temporal import (
    SpatioTemporalSparseCVI,
    SpatioTemporalSparseVariational,
)
from .svgp import SparseVariationalGaussianProcess
from .variational import VariationalGaussianProcess
from .vdp import VariationalMarkovGP

__all__ = [
    "AnalyticPosteriorProcess",
    "ConditionalProcess",
    "CVIGaussianProcess",
    "CVISitesSDE",
    "CVISitesSSM",
    "DataSites",
    "GaussianProcessRegression",
    "GaussianSites",
    "ImportanceWeightedVI",
    "PowerExpectationPropagation",
    "SparseCVIGaussianProcess",
    "SparsePowerExpectationPropagation",
    "SparseVariationalGaussianProcess",
    "SpatioTemporalSparseCVI",
    "SpatioTemporalSparseVariational",
    "VariationalGaussianProcess",
    "VariationalMarkovGP",
    "back_project_nats",
]
