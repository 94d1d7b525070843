"""Public names of :mod:`vi_diffusion_processes_tpu_torch.kernels` (vi_diffusion_processes_tpu/kernels/__init__.py)."""
from .base import (
    ConcatKernel,
    IndependentMultiOutput,
    Kernel,
    NonStationaryKernel,
    Product,
    SDEKernel,
    StationaryKernel,
    Sum,
)
from .composite import (
    FactorAnalysisKernel,
    IndependentMultiOutputStack,
    PiecewiseKernel,
    StackKernel,
)
from .matern import Matern12, Matern32, Matern52, OrnsteinUhlenbeck
from .misc import Constant, HarmonicOscillator, LatentExponentiallyGenerated
from .spatial import SpatialMatern12, SpatialMatern32, SpatialRBF
from .spatio_temporal import SparseSpatioTemporalKernel

__all__ = [
    "ConcatKernel",
    "Constant",
    "FactorAnalysisKernel",
    "HarmonicOscillator",
    "IndependentMultiOutput",
    "IndependentMultiOutputStack",
    "Kernel",
    "LatentExponentiallyGenerated",
    "Matern12",
    "Matern32",
    "Matern52",
    "NonStationaryKernel",
    "OrnsteinUhlenbeck",
    "PiecewiseKernel",
    "Product",
    "SDEKernel",
    "SparseSpatioTemporalKernel",
    "SpatialMatern12",
    "SpatialMatern32",
    "SpatialRBF",
    "StackKernel",
    "StationaryKernel",
    "Sum",
]
