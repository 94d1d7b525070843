"""How exact one γ = 1 natural-gradient step is at full width, by package.

docs/examples/natgrad_vgp.py at N = 100,000 on [0, 100] (Matern12(0.7, 1),
Gaussian(0.04), y = sin 2t + 0.2·N(0, 1) from ``default_rng(7)``, float64),
as ``chip_smoke.py::phase_natgrad_vgp`` builds it: one ``natgrad_step`` at
γ = 1 is exact inference, so the ELBO after it equals the GPR
log-likelihood and its marginals the GPR posterior's.  Prints one JSON line
per package and lengthscale (0.7, then the next float64 above it): the
ELBO's relative error and the marginals' largest error as a share of their
largest magnitude; and per package how far the step's marginals moved
between the two lengthscales (the one-ulp sensitivity of the route).

    python -m tests.port.natgrad_exactness          # both packages, on the CPU
    python -m tests.port.natgrad_exactness --port   # the port alone
    python -m tests.port.natgrad_exactness --sweep  # the pivot sweep alone

``--sweep`` prints, on a Matern12 chain whose smallest gap (1e-9) joins two
windows (:func:`chain_with_a_small_gap`: of 64 windows at 4,096 points, and
of the kernel's own at 4,096 and 100,000), the largest relative error
against a long-double recursion of the float64 sequential recursion, of
K1's plain version on the CPU and, where there is a card, of K1 itself.
"""
import argparse
import json

import numpy as np

from vi_diffusion_processes_tpu_torch.examples._common import scaled_err

N, T1, LENGTHSCALE = 100_000, 100.0, 0.7


def data(n: int = N):
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, T1, n))
    y = np.sin(2 * t)[:, None] + 0.2 * rng.normal(size=(n, 1))
    return t, y


def chain_with_a_small_gap(n=4096, windows=64, gap=1e-9, lengthscale=0.7, site=25.0):
    """The posterior precision of a Matern12 chain with a site of precision
    ``site`` at each of ``n`` points, gaps of about 1e-3, and one gap of
    ``gap`` between the last point of the first of ``windows`` windows and
    the first of the second: the pivot sweep's ``kd`` and ``b2``."""
    dt = np.random.default_rng(7).uniform(0.5e-3, 1.5e-3, n - 1)
    dt[-(-n // windows) - 1] = gap
    a = np.exp(-dt / lengthscale)
    q = 1.0 - a * a
    kd = np.full(n, site)
    kd[0] += 1.0
    kd[1:] += 1.0 / q
    kd[:-1] += a * a / q
    return kd, np.concatenate([(a / q) ** 2, [0.0]])


def chain_with_magnitudes(n=4096, windows=64, exponent=498, seed=5):
    """:func:`chain_with_a_small_gap` under a diagonal similarity that is
    constant in each window: ``kd_k·c_k²``, ``b2_k·c_k²·c_{k+1}²`` with
    ``c² = 2^e``, ``e`` drawn per window from ``[−exponent, exponent]`` (498:
    ``kd`` and ``b2`` span 1e±150 across windows).  Its pivots are the small
    gap chain's times ``c²``; powers of two keep the float64 inputs, and the
    float64 recursion's roundings, those of the unscaled chain.  Returns
    ``(kd, b2, c²)``."""
    kd, b2 = chain_with_a_small_gap(n, windows)
    e = np.random.default_rng(seed).integers(-exponent, exponent + 1, windows)
    c2 = np.ldexp(1.0, np.repeat(e, -(-n // windows))[:n])
    return kd * c2, b2 * c2 * np.append(c2[1:], 1.0), c2


def chain_with_weak_couplings(n=4096, windows=64, decades=300, seed=6):
    """``kd`` in [2, 3] and ``b2 = 0.2·kd_k·kd_{k+1}·10^−c`` with ``c`` drawn
    per window from ``[0, decades]``: the preconditioned ``kd~ = kd/s``
    reaches 1e150 at every element of a weakly coupled window."""
    rng = np.random.default_rng(seed)
    kd = rng.uniform(2.0, 3.0, n)
    c = np.repeat(rng.uniform(0.0, decades, windows), -(-n // windows))[:n]
    return kd, 0.2 * kd * np.append(kd[1:], 0.0) * 10.0 ** -c


def chain_with_a_zero(n=4096, windows=64, at="pivot_first", seed=7):
    """A random chain (``kd`` in [2, 3], ``b2`` in [0.1, 0.2]) with, on the
    boundary between windows 19 and 20, a zero pivot (``kd = b2 = 0``: the
    pivot is 0, the one before it −inf, the one before that ``kd``) at the
    first element of window 20 (``at="pivot_first"``) or the last of window
    19 (``"pivot_last"``), or a zero coupling (``b2 = 0``) at the last element
    of window 19 (``"coupling"``)."""
    rng = np.random.default_rng(seed)
    kd = rng.uniform(2.0, 3.0, n)
    b2 = 0.2 * rng.uniform(0.5, 1.0, n)
    b2[-1] = 0.0
    k = 20 * -(-n // windows) - (0 if at == "pivot_first" else 1)
    b2[k] = 0.0
    if at != "coupling":
        kd[k] = 0.0
    return kd, b2


def sweep_errors(kd, b2, pivots) -> dict:
    """The largest relative error against a long-double recursion of the
    float64 sequential recursion and of each of ``pivots`` (name → D).
    Where the exact pivot is 0 or infinite, a pivot must equal it (else its
    error is infinite)."""
    exact = np.empty(len(kd), np.longdouble)
    seq = np.empty(len(kd))
    exact[-1], seq[-1] = kd[-1], kd[-1]
    with np.errstate(divide="ignore"):
        for k in range(len(kd) - 2, -1, -1):
            exact[k] = np.longdouble(kd[k]) - np.longdouble(b2[k]) / exact[k + 1]
            seq[k] = kd[k] - b2[k] / seq[k + 1]
    regular = np.isfinite(exact) & (exact != 0)

    def rel(d):
        d = np.asarray(d).astype(np.longdouble)
        if not np.array_equal(d[~regular], exact[~regular]):
            return float("inf")
        return float(np.max(np.abs((d[regular] - exact[regular]) / exact[regular])))

    return {"float64_sequential": rel(seq), **{name: rel(d) for name, d in pivots.items()}}


def sweep_record() -> dict:
    """``sweep_errors`` on the small-gap chain with the gap on a boundary of
    64 windows, and of the kernel's own windows at 4,096 and 100,000
    points."""
    import torch

    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    record = {}
    for n, windows in ((4096, 64), (4096, 88), (100_000, 426)):
        kd, b2 = chain_with_a_small_gap(n, windows)
        pivots = {"plain_cpu": cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2)).numpy()}
        if torch.cuda.is_available():
            on_card = [torch.tensor(x, device="cuda") for x in (kd, b2)]
            pivots["k1_card"] = cs.riccati_d_sweep(*on_card).cpu().numpy()
        record[f"n={n} gap on a boundary of {windows} windows"] = sweep_errors(kd, b2, pivots)
    return record


def _record(elbo, loglik, marginals, ref_marginals) -> dict:
    return {"elbo_rel_err": abs(elbo - loglik) / abs(loglik),
            "means_err": scaled_err(marginals[0], ref_marginals[0]),
            "covs_err": scaled_err(marginals[1], ref_marginals[1])}


def jax_step(n: int = N, lengthscale: float = LENGTHSCALE):
    """The JAX package's step: (its record, the step's marginals)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from vi_diffusion_processes_tpu.kernels import Matern12
    from vi_diffusion_processes_tpu.likelihoods import Gaussian
    from vi_diffusion_processes_tpu.models import (
        GaussianProcessRegression,
        VariationalGaussianProcess,
    )
    from vi_diffusion_processes_tpu.optim import natgrad_step

    t, y = (jnp.asarray(a) for a in data(n))
    kernel = Matern12(lengthscale=jnp.asarray(lengthscale), variance=jnp.asarray(1.0))
    vgp = VariationalGaussianProcess.initialize(kernel, Gaussian(variance=jnp.asarray(0.04)), t, y)
    q1, _, _ = natgrad_step(lambda q: vgp.loss(q), vgp.dist_q, gamma=1.0)
    gpr = GaussianProcessRegression(kernel=kernel, time_points=t, observations=y,
                                    chol_obs_covariance=jnp.asarray([[0.2]]))
    marginals = [np.asarray(m) for m in q1.marginals()]
    return _record(float(vgp.elbo(q1)), float(gpr.log_likelihood()), marginals,
                   gpr.posterior_state_space_model().marginals()), marginals


def port_step(n: int = N, lengthscale: float = LENGTHSCALE):
    """The port's step on the CPU: (its record, the step's marginals)."""
    import torch

    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
    from vi_diffusion_processes_tpu_torch.models.variational import VariationalGaussianProcess
    from vi_diffusion_processes_tpu_torch.optim.natgrad import natgrad_step

    t, y = (torch.tensor(a) for a in data(n))
    vgp = VariationalGaussianProcess.initialize(Matern12(lengthscale, 1.0), Gaussian(0.04), t, y)
    q1, _, _ = natgrad_step(vgp.loss, vgp.dist_q, gamma=1.0)
    gpr = GaussianProcessRegression(vgp.kernel, t, y, torch.tensor([[0.2]], dtype=torch.float64))
    with torch.no_grad():
        marginals = [m.numpy() for m in q1.marginals()]
        return _record(float(vgp.elbo(q1)), float(gpr.log_likelihood()), marginals,
                       [m.numpy() for m in gpr.posterior_state_space_model().marginals()]), marginals


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--port", action="store_true", help="the port alone")
    parser.add_argument("--sweep", action="store_true", help="the pivot sweep alone")
    parser.add_argument("--n", type=int, default=N)
    args = parser.parse_args()
    if args.sweep:
        print(json.dumps({"sweep": sweep_record()}), flush=True)
        return
    steps = {"torch": port_step} if args.port else {"torch": port_step, "jax": jax_step}
    for package, step in steps.items():
        marginals = []
        for lengthscale in (LENGTHSCALE, float(np.nextafter(LENGTHSCALE, np.inf))):
            record, m = step(args.n, lengthscale)
            marginals.append(m)
            print(json.dumps({"package": package, "n": args.n, "lengthscale": lengthscale,
                              **record}), flush=True)
        print(json.dumps({"package": package, "n": args.n, "one_ulp_move": {
            "means": scaled_err(marginals[1][0], marginals[0][0]),
            "covs": scaled_err(marginals[1][1], marginals[0][1])}}), flush=True)


if __name__ == "__main__":
    main()
