"""The float64 sensitivity of the non-conjugate CVI step at d = 2, by route.

Each case takes a Matern32 CVI model with a Poisson or Bernoulli likelihood
three steps on, by the packed step (``pack_cvi`` and ``packed_site_step``)
and by the generic step (``update_sites``), once at the case's lengthscale
and once at the next float64 above it.  It prints, per route, how far the
sites and f-marginals moved, as a share of each output's largest magnitude.
The packed step solves for the marginals in precision form, whose entries
grow as Δt⁻³ under Matern32; the generic step runs the filter and smoother.

    python -m tests.port.packed_sensitivity          # the port, on the CPU
    python -m tests.port.packed_sensitivity --jax    # the JAX package, on the CPU
    python -m tests.port.packed_sensitivity --spatio # the packed spatio step

``--spatio`` instead probes the packed spatio-temporal step
(``models/spatio_packed.py``) at ``chip_smoke.py``'s full width at d = 6
(N = 20,000 on [0, 100], Mt = 10,000, Δt = 1.0e-2, Matern32 of lengthscale
5 in time, float64, three steps): the one-ulp change of the temporal
lengthscale by route, the packed step against the generic one, and on a
card each route on the card against the CPU.

With ``--jax`` the JAX package runs the same cases; without it, where a CUDA
device is present, the port's routes on the card are also held against the
CPU (the error the card tests meet), and ``--full`` adds the port's packed
step at the width of ``cvi_poisson_site_step_100k`` (N = 100,000 on
[0, 100], Poisson): its one-ulp change on the card, and the card against
the CPU.  One JSON line per case.

The cases are the inputs of ``chip_smoke.py::phase_cvi_reference``
(N = 2,000 on [0, 20], lengthscale 1.0, variance 1.0) and of
``tests/port/test_torch_cvi_cuda.py`` (N = 1,000 on [0, 6], lengthscale
1.2, variance 0.9), both at learning rate 0.3.
"""
import argparse
import json
import sys

import numpy as np

from .helpers import cvi_data

STEPS = 3
LR = 0.3


def smoke_data(likelihood: str, n: int = 2_000, t1: float = 20.0):
    """``chip_smoke.py``'s reference inputs: Poisson counts of rate
    ``exp(0.8 sin 0.3t)`` on a float32 grid from ``default_rng(0)``, or
    Bernoulli labels of probability ``sigmoid(sin 0.3t)`` from
    ``default_rng(1)``, on ``n`` points of [0, t1]."""
    t = np.linspace(0.0, t1, n)
    if likelihood == "Poisson":
        t32 = t.astype(np.float32)
        y = np.random.default_rng(0).poisson(np.exp(0.8 * np.sin(0.3 * t32)))[:, None]
    else:
        y = (np.random.default_rng(1).uniform(size=(n, 1))
             < 1.0 / (1.0 + np.exp(-np.sin(0.3 * t)))[:, None])
    return t, y.astype(np.float64)


#: name → (data builder, lengthscale, variance)
CASES = {
    "smoke-N2000": (smoke_data, 1.0, 1.0),
    "card-test-N1000": (lambda lik: cvi_data(lik, 1_000), 1.2, 0.9),
}


def _scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def _spread(moved: dict, base: dict) -> dict:
    return {route: max(_scaled(a, b) for a, b in zip(moved[route], base[route]))
            for route in base}


def jax_outputs(t, y, likelihood: str, lengthscale: float, variance: float) -> dict:
    """The JAX package's packed and generic routes, three steps each."""
    import jax
    import jax.numpy as jnp

    from vi_diffusion_processes_tpu import likelihoods
    from vi_diffusion_processes_tpu.kernels import Matern32
    from vi_diffusion_processes_tpu.models import CVIGaussianProcess
    from vi_diffusion_processes_tpu.models.cvi_packed import pack_cvi, packed_site_step

    kernel = Matern32(lengthscale=jnp.asarray(lengthscale), variance=jnp.asarray(variance))
    model = CVIGaussianProcess.initialize(kernel, getattr(likelihoods, likelihood)(),
                                          jnp.asarray(t), jnp.asarray(y), learning_rate=LR)

    @jax.jit
    def run(m):
        state, generic = pack_cvi(m), m
        for _ in range(STEPS):
            state, generic = packed_site_step(m, state), generic.update_sites()
        f_mu, f_var = generic.posterior_marginals_f()
        return ([state.d_nat1, state.d_nat2, state.fx_mu, state.fx_var],
                [generic.sites.nat1[:, 0], generic.sites.nat2[:, 0, 0], f_mu[:, 0], f_var[:, 0]])

    packed, generic = run(model)
    return {"packed": [np.asarray(x) for x in packed], "generic": [np.asarray(x) for x in generic]}


def port_outputs(t, y, likelihood: str, lengthscale: float, variance: float, device,
                 generic: bool = True) -> dict:
    """The port's packed (and generic) routes, three steps each."""
    import torch

    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32
    from vi_diffusion_processes_tpu_torch.likelihoods import discrete
    from vi_diffusion_processes_tpu_torch.models.cvi import CVIGaussianProcess
    from vi_diffusion_processes_tpu_torch.models.cvi_packed import pack_cvi, packed_site_step

    f64 = torch.float64
    model = CVIGaussianProcess.initialize(
        Matern32(lengthscale=lengthscale, variance=variance, dtype=f64).to(device),
        getattr(discrete, likelihood)().to(device), torch.tensor(t, dtype=f64, device=device),
        torch.tensor(y, dtype=f64, device=device), learning_rate=LR)
    state = pack_cvi(model)
    for _ in range(STEPS):
        state = packed_site_step(model, state)
    out = {"packed": [state.d_nat1, state.d_nat2, state.fx_mu, state.fx_var]}
    if generic:
        for _ in range(STEPS):
            model = model.update_sites()
        with torch.no_grad():
            f_mu, f_var = model.posterior_marginals_f()
        out["generic"] = [model.sites.nat1[:, 0], model.sites.nat2[:, 0, 0], f_mu[:, 0],
                          f_var[:, 0]]
    return {route: [x.detach().cpu().numpy() for x in xs] for route, xs in out.items()}


def spatio_outputs(lengthscale: float, device) -> dict:
    """The port's packed and generic spatio steps at full width, d = 6:
    the site naturals after three float64 steps, by route."""
    import torch

    import chip_smoke
    from vi_diffusion_processes_tpu_torch.models.spatio_packed import (
        pack_spatio,
        packed_spatio_site_step,
    )

    xy = tuple(torch.tensor(a, device=device) for a in chip_smoke.spatio_data())
    model = chip_smoke.spatio_model(3, device, lengthscale=lengthscale)
    cache, state = pack_spatio(model, xy)
    generic = model
    for _ in range(STEPS):
        state = packed_spatio_site_step(model, cache, state)
        generic = generic.update_sites(xy)
    return {"packed": [state.nat1.cpu().numpy(), state.nat2.cpu().numpy()],
            "generic": [generic.nat1.cpu().numpy(), generic.nat2.cpu().numpy()]}


def spatio_main(card) -> None:
    base, moved = (spatio_outputs(ls, "cpu") for ls in (5.0, float(np.nextafter(5.0, 6.0))))
    rec = {"side": "port", "case": "spatio-d6-full", "n": 20_000, "mt": 10_000,
           "dt": 100.0 / 9_999, "one_ulp_change": _spread(moved, base),
           "packed_against_generic": max(_scaled(a, b) for a, b in zip(base["packed"],
                                                                        base["generic"]))}
    if card is not None:
        on_card = spatio_outputs(5.0, card)
        rec["card_against_cpu"] = _spread(on_card, base)
        rec["packed_against_generic_on_the_card"] = max(
            _scaled(a, b) for a, b in zip(on_card["packed"], on_card["generic"]))
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--jax", action="store_true", help="run the JAX package's routes")
    parser.add_argument("--full", action="store_true",
                        help="add the packed step at N = 100,000, on the card and the CPU")
    parser.add_argument("--spatio", action="store_true",
                        help="probe the packed spatio step at full width instead")
    args = parser.parse_args(argv)
    if args.spatio:
        import torch

        spatio_main(torch.device("cuda", 0) if torch.cuda.is_available() else None)
        return 0
    if args.jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        side, card = "jax", None
    else:
        import torch

        side = "port"
        card = torch.device("cuda", 0) if torch.cuda.is_available() else None
    for name, (data, lengthscale, variance) in CASES.items():
        for likelihood in ("Poisson", "Bernoulli"):
            t, y = data(likelihood)
            up = float(np.nextafter(lengthscale, 2.0 * lengthscale))
            if args.jax:
                base, moved = (jax_outputs(t, y, likelihood, ls, variance)
                               for ls in (lengthscale, up))
            else:
                base, moved = (port_outputs(t, y, likelihood, ls, variance, "cpu")
                               for ls in (lengthscale, up))
            rec = {"side": side, "case": name, "likelihood": likelihood, "n": len(t),
                   "dt": float(t[1] - t[0]), "one_ulp_change": _spread(moved, base)}
            if card is not None:
                rec["card_against_cpu"] = _spread(
                    port_outputs(t, y, likelihood, lengthscale, variance, card), base)
            print(json.dumps(rec), flush=True)
    if args.full and card is not None:
        t, y = smoke_data("Poisson", 100_000, 100.0)
        base, moved = (port_outputs(t, y, "Poisson", ls, 1.0, card, generic=False)
                       for ls in (1.0, float(np.nextafter(1.0, 2.0))))
        cpu = port_outputs(t, y, "Poisson", 1.0, 1.0, "cpu", generic=False)
        print(json.dumps({"side": side, "case": "full-width-N100000", "likelihood": "Poisson",
                          "n": len(t), "dt": float(t[1] - t[0]),
                          "one_ulp_change_on_the_card": _spread(moved, base),
                          "card_against_cpu": _spread(base, cpu)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
