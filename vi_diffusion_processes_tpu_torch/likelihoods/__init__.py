"""Public names of :mod:`vi_diffusion_processes_tpu_torch.likelihoods` (vi_diffusion_processes_tpu/likelihoods/__init__.py)."""
from .base import Likelihood
from .discrete import Bernoulli, Poisson
from .gaussian import Gaussian, MultivariateGaussian
from .multistage import MultiStageLikelihood
from .pep import PEPGaussian, PEPScalarLikelihood

__all__ = [
    "Bernoulli",
    "Gaussian",
    "Likelihood",
    "MultiStageLikelihood",
    "MultivariateGaussian",
    "PEPGaussian",
    "PEPScalarLikelihood",
    "Poisson",
]
