"""Plain references of the benchmark: NumPy, SciPy and plain PyTorch only.

Nothing here imports the program under test or the JAX package; every
quantity the program derives (linearized priors, naturals, sites,
marginals) is worked out again from the dataset the harness hands to both.
"""
