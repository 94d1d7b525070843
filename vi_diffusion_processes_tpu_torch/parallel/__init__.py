"""Public names of :mod:`vi_diffusion_processes_tpu_torch.parallel` (vi_diffusion_processes_tpu/parallel/__init__.py)."""
from .kalman import KalmanFilter, KalmanFilterWithSites, KalmanFilterWithSparseSites
from .pskf import (
    FilterResult,
    SmootherResult,
    filter_smoother_with_sites,
    parallel_filter,
    parallel_smoother,
    posterior_ssm_from_smoothed,
    site_log_normalizer,
)
from .sharded import (
    sharded_associative_scan,
    time_sharded_filter,
    time_sharded_filter_smoother,
    time_sharded_smoother,
)

__all__ = [
    "FilterResult",
    "KalmanFilter",
    "KalmanFilterWithSites",
    "KalmanFilterWithSparseSites",
    "SmootherResult",
    "filter_smoother_with_sites",
    "parallel_filter",
    "parallel_smoother",
    "posterior_ssm_from_smoothed",
    "sharded_associative_scan",
    "site_log_normalizer",
    "time_sharded_filter",
    "time_sharded_filter_smoother",
    "time_sharded_smoother",
]
