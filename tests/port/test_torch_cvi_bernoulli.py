"""The port's CVI under a Bernoulli likelihood, whose variational
expectations go through the likelihood base class's Gauss–Hermite
quadrature, against the JAX package: the Bernoulli cases of
``cvi_cases.py`` (Matern12 and Matern32, n = 64, lr 0.3, float64), to 1e-9.
"""
import pytest

from .cvi_cases import check_evaluations, check_update_sites

NAMES = ["matern12-bernoulli", "matern32-bernoulli"]


@pytest.mark.parametrize("name", NAMES)
def test_update_sites_matches_jax(name):
    check_update_sites(name)


@pytest.mark.parametrize("name", NAMES)
def test_marginals_and_elbos_match_jax(name):
    check_evaluations(name)
