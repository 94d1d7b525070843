"""Public names of :mod:`vi_diffusion_processes_tpu_torch.sde` (vi_diffusion_processes_tpu/sde/__init__.py)."""
from .base import SDE
from .drift import LinearDrift, linear_drift_from_ssm, linear_drift_to_ssm
from .utils import (
    Gaussian,
    euler_maruyama,
    linearize_sde,
    squared_drift_difference_along_Gaussian_path,
    ssm_kl_along_gaussian_path,
    transform_girsanov_sites,
)
from .zoo import (
    BenesSDE,
    DoubleWellSDE,
    MLPDrift,
    OrnsteinUhlenbeckSDE,
    SineDiffusionSDE,
    SqrtDiffusionSDE,
    VanderPolOscillatorSDE,
)

__all__ = [
    "SDE",
    "LinearDrift",
    "Gaussian",
    "BenesSDE",
    "DoubleWellSDE",
    "MLPDrift",
    "OrnsteinUhlenbeckSDE",
    "SineDiffusionSDE",
    "SqrtDiffusionSDE",
    "VanderPolOscillatorSDE",
    "euler_maruyama",
    "linearize_sde",
    "linear_drift_from_ssm",
    "linear_drift_to_ssm",
    "squared_drift_difference_along_Gaussian_path",
    "ssm_kl_along_gaussian_path",
    "transform_girsanov_sites",
]
