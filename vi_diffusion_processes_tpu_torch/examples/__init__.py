"""The documentation examples, ported (docs/examples/ in the JAX package).

One module per example, under the JAX script's name.  Each has
``run(device=None, data=None) -> dict``, which builds the example through
the port's public API on ``device`` (the CUDA card unless another is named)
and returns the numbers the script prints and asserts on, and a ``main()``
that prints them and makes the script's assertions::

    python -m vi_diffusion_processes_tpu_torch.examples.<name> [--device cpu]

``data`` carries the draws that a run would otherwise make itself (its
module's ``DATA`` names them), so that two runs, or the port and the JAX
package, see the same inputs.  Importing a module runs nothing.
"""

EXAMPLES = (
    "cvi_dp_double_well",
    "vdp_inference",
    "natgrad_vgp",
    "gpr_regression",
    "sparse_classification",
    "kernels_tour",
    "spatio_temporal_cvi",
    "time_sharded_smoothing",
    "factor_analysis",
    "stacked_kernels",
    "multistage_demand",
    "pep_classification",
    "sparse_pep_classification",
    "iwvi_importance_weighted",
)
