"""PyTorch + CUDA port of :mod:`vi_diffusion_processes_tpu`.

Each module sits across from its JAX reference at the same sub-package
path.  The package imports ``torch`` and numpy only; the d=1 CVI-DP hot
loop runs on hand-written CUDA kernels (:mod:`.ops.cuda_scan`) for CUDA
tensors and on their plain PyTorch versions for CPU tensors.
"""

__version__ = "0.1.0"

from . import config
from .ops.btd import BTD
from .ssm.state_space_model import StateSpaceModel, ssm_from_covariances
