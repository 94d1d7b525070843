"""Public names of :mod:`vi_diffusion_processes_tpu_torch.ssm` (vi_diffusion_processes_tpu/ssm/__init__.py)."""
from .conditionals import (
    base_conditional_predict,
    conditional_predict,
    conditional_statistics,
    pairwise_marginals,
)
from .emission import ComposedPairEmissionModel, EmissionModel, StackEmissionModel
from .mean_functions import (
    ImpulseMeanFunction,
    LinearMeanFunction,
    MeanFunction,
    StepMeanFunction,
    ZeroMeanFunction,
)
from .state_space_model import StateSpaceModel, ssm_from_covariances
from .transforms import (
    expectations_to_ssm_params,
    naturals_to_ssm,
    naturals_to_ssm_params,
    naturals_to_ssm_params_no_smoothing,
    ssm_to_expectations,
    ssm_to_naturals,
    ssm_to_naturals_no_smoothing,
)

__all__ = [
    "ComposedPairEmissionModel",
    "EmissionModel",
    "ImpulseMeanFunction",
    "LinearMeanFunction",
    "MeanFunction",
    "StackEmissionModel",
    "StateSpaceModel",
    "StepMeanFunction",
    "ZeroMeanFunction",
    "base_conditional_predict",
    "conditional_predict",
    "conditional_statistics",
    "expectations_to_ssm_params",
    "naturals_to_ssm",
    "naturals_to_ssm_params",
    "naturals_to_ssm_params_no_smoothing",
    "pairwise_marginals",
    "ssm_from_covariances",
    "ssm_to_expectations",
    "ssm_to_naturals",
    "ssm_to_naturals_no_smoothing",
]
