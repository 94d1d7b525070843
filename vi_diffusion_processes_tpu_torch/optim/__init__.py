"""Public names of :mod:`vi_diffusion_processes_tpu_torch.optim` (vi_diffusion_processes_tpu/optim/__init__.py)."""
from .bijectors import ordered, ordered_inverse, positive, positive_inverse
from .natgrad import NaturalGradientState, natgrad_init, natgrad_step
from .trainers import CVISitesTrainer, VDPTrainer

__all__ = [
    "CVISitesTrainer",
    "NaturalGradientState",
    "VDPTrainer",
    "natgrad_init",
    "natgrad_step",
    "ordered",
    "ordered_inverse",
    "positive",
    "positive_inverse",
]
