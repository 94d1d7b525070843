"""The d = 1 KL's kernels F and F′ (``ops/quad_kl.py``, ``csrc/quad_kl.cu``)
on the card, against their plain twin and against the plain route.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_quad_kl_1d_cuda.py --confcutdir=tests/port -m cuda

The inputs are those the third packed float64 step of the double-well
flagship at T = 100,000 (Δt = 1e-4) hands F′, and slices of them: N = 1
(T = 2), 63 and 99,999 pairs leave the last block of 64 part empty, 4,096
fills it.  F and F′ take the difference ``x + Δt f(x) − (a x + b)`` as
``(1 − a) x − b + Δt f(x)``, and each pair's closed forms and the chain
rule without fused multiply-adds, as their twin ``quad_kl_1d_plain`` does,
so the twin in the kernels' own dtype on the same inputs is the yardstick
(``LIMITS``, each over the largest magnitude): only the order of the sums
over the points moves.  At T = 100,000 the kernels read 3.7e-16 (``s``)
and 2.8e-15 (the cotangents) off it in float64, 2.0e-7 and 7.1e-7 in
float32 (``chip_smoke.py::phase_quad_kl_1d``).  In float32 the inputs decide
little: ``q_v = v' − a² v`` and ``1/p_v − 1/q_v`` cancel four digits and
more, so against the twin in float64 the float32 cotangents read 0.6–0.9
of their largest magnitudes, as the plain route's do.

The plain route (``_kl_path`` and autograd) subtracts two terms of the size
of ``x`` where their difference is about 1e2 smaller: a float64 step
through F and F′ moves the Girsanov sites by 3.5e-13 of their largest
magnitudes against the plain route, and the marginals refreshed from them
by 4.0e-10, the ELBO by 1.7e-10 (a float64 ELBO at T = 100,000 moves by as
much between any two rounding orders: ``PERF.md`` §6); a whole fit accepts
the same 18 steps, its ELBOs within 1.8e-10 (``STEP_LIMITS``,
``FIT_LIMIT``).
"""
import pytest
import torch

from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, make_dataset
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.ops import quad_kl as qk
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.optim import compiled
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer
from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model

from .helpers import NoHostSync, all_launches
from .test_torch_compiled_cuda import _assert_bits_equal

pytestmark = pytest.mark.cuda

T = 100_000
LR = 0.3
NAMES = ("e1", "ed", "es")
#: limit of s and of each cotangent over its largest magnitude, against the
#: twin in the same dtype on the same inputs
LIMITS = {torch.float64: 1e-13, torch.float32: 1e-5}
#: a step and ``packed_elbo`` through F and F′ against the plain route at
#: T = 100,000: the ELBOs relative, the Girsanov sites and the marginals each
#: over its largest magnitude
STEP_LIMITS = {"elbo": 1e-9, "sites": 1e-12, "marginals": 3e-9}
#: a whole fit through F and F′ against the plain route: each accepted ELBO
#: relative
FIT_LIMIT = 1e-9
SITES = ("g_nat1", "g_nat2d", "g_nat2s")
FIELDS = SITES + ("fx_mu", "fx_var")


def _adjoint_args(model, state):
    """The arguments that one packed step hands ``quad_kl_1d_adjoint``."""
    calls, real = [], tp.quad_kl_1d_adjoint
    tp.quad_kl_1d_adjoint = lambda *args: calls.append(args) or real(*args)
    try:
        tp.packed_natgrad_step(model, state, LR)
    finally:
        tp.quad_kl_1d_adjoint = real
    return calls[0]


@pytest.fixture(scope="module")
def pairs():
    """F′'s arguments in the third float64 flagship step at T = 100,000."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    model = flagship_model(T, torch.float64, torch.device("cuda", 0))
    state = tp.pack_state(model)
    for _ in range(2):
        state, _ = tp.packed_natgrad_step(model, state, LR)
    return _adjoint_args(model, state)


def _scaled(x, ref) -> float:
    ref = ref.double()
    return float((x.double() - ref).abs().max() / ref.abs().max())


def _plain(monkeypatch):
    """Send the d = 1 KL down the plain route."""
    monkeypatch.setattr(tp, "kernel_drift", lambda *args: None)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 63, 4_096, T - 1])
def test_kernels_against_the_plain_twin(pairs, dtype, n):
    """``s`` by F and the three cotangents of a random ``g`` (with ``KL₀``)
    by F′, against the twin in the same dtype on the same inputs; one launch
    of each."""
    _, e1, ed, es, p_var, z, w, dt, jitter, kind, params, mu0, var0 = pairs
    e1, ed, es, p_var = (x[:m].to(dtype) for x, m in ((e1, n + 1), (ed, n + 1), (es, n),
                                                      (p_var, n)))
    z, w, dt, jitter, mu0, var0 = (x.to(dtype) for x in (z, w, dt, jitter, mu0, var0))
    params = tuple(p.to(dtype) for p in params)
    g = torch.randn(n, generator=torch.Generator().manual_seed(n), dtype=torch.float64)
    g = g.to(dtype).cuda()
    reset_launch_counts()
    s = qk.quad_kl_1d(e1, ed, es, p_var, z, w, dt, jitter, kind, params)
    grads = qk.quad_kl_1d_adjoint(g, e1, ed, es, p_var, z, w, dt, jitter, kind, params, mu0,
                                  var0)
    torch.cuda.synchronize()
    assert launch_counts() == all_launches(quad_kl_1d=1, quad_kl_1d_adjoint=1)
    assert s.dtype == dtype and all(x.dtype == dtype for x in grads)

    ref_in = (e1, ed, es, p_var, z, w, dt, jitter, *params)
    ref = qk.quad_kl_1d_plain(*ref_in)
    limit = LIMITS[dtype]
    assert _scaled(s, ref) <= limit, f"s: {_scaled(s, ref):.3e}"
    ref_grads = qk.quad_kl_1d_adjoint_plain(g, *ref_in, mu0, var0)
    for name, x, r in zip(NAMES, grads, ref_grads):
        assert x.shape == r.shape, name
        assert _scaled(x, r) <= limit, f"{name}: {_scaled(x, r):.3e}"


def test_broadcast_inputs_give_the_same_bits(pairs):
    """``p_var`` and ``g`` as one value expanded (stride 0) give the bits
    of the same values laid out in full."""
    half, e1, ed, es, p_var, z, w, dt, jitter, kind, params, mu0, var0 = pairs
    one = p_var[:1].reshape(()).expand(p_var.shape)
    for pv in (one, one.contiguous()):
        assert pv.stride() == ((0,) if pv is one else (1,))
    s = [qk.quad_kl_1d(e1, ed, es, pv, z, w, dt, jitter, kind, params)
         for pv in (one, one.contiguous())]
    assert torch.equal(*s)
    assert half.stride() == (0,)
    for x, y in zip(*(qk.quad_kl_1d_adjoint(g, e1, ed, es, p_var, z, w, dt, jitter, kind,
                                            params, mu0, var0)
                      for g in (half, half.contiguous()))):
        assert torch.equal(x, y)


def test_nan_in_ed_gives_nan_on_the_card(pairs):
    """No clamp: a NaN in ``ed`` at point 37 makes the summands of its two
    pairs NaN, and the cotangents of the points those pairs touch."""
    half, e1, ed, es, p_var, z, w, dt, jitter, kind, params, mu0, var0 = pairs
    e1, ed, es, p_var, half = e1[:101], ed[:101].clone(), es[:100], p_var[:100], half[:100]
    ed[37] = float("nan")
    s = qk.quad_kl_1d(e1, ed, es, p_var, z, w, dt, jitter, kind, params)
    g_e1, g_ed, g_es = qk.quad_kl_1d_adjoint(half, e1, ed, es, p_var, z, w, dt, jitter, kind,
                                             params)
    pairs_bad = torch.zeros(100, dtype=torch.bool, device=s.device)
    pairs_bad[36:38] = True
    points_bad = torch.zeros(101, dtype=torch.bool, device=s.device)
    points_bad[36:39] = True
    assert torch.equal(torch.isnan(s), pairs_bad)
    assert torch.equal(torch.isnan(g_es), pairs_bad)
    for x in (g_e1, g_ed):
        assert torch.equal(torch.isnan(x), points_bad)


def test_launch_shape_takes_many_blocks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    shape = qk.launch_shape_1d(T - 1)
    per_block = shape["threads_per_block"] // shape["lanes_per_pair"]
    assert shape["grid"] == -(-(T - 1) // per_block) > 1
    assert qk.launch_shape_1d(T)["grid"] == -(-T // per_block)


def _step_and_elbo(model, state):
    """One packed step and ``packed_elbo`` of its state, with their launches."""
    reset_launch_counts()
    stepped, elbo = tp.packed_natgrad_step(model, state, LR)
    torch.cuda.synchronize()
    step_launches = launch_counts()
    reset_launch_counts()
    again = tp.packed_elbo(model, stepped)
    torch.cuda.synchronize()
    return stepped, float(elbo), float(again), step_launches, launch_counts()


def test_step_and_elbo_against_the_plain_route(pairs, monkeypatch):
    """A float64 flagship step and ``packed_elbo`` at T = 100,000 through F
    and F′ (F′ once and F once a step, F once an ELBO) against the same
    through the plain route (no F or F′): the ELBOs, the Girsanov sites and
    the marginals within ``STEP_LIMITS``."""
    model = flagship_model(T, torch.float64, torch.device("cuda", 0))
    state = tp.pack_state(model)
    for _ in range(2):
        state, _ = tp.packed_natgrad_step(model, state, LR)
    fused = _step_and_elbo(model, state)
    _plain(monkeypatch)
    plain = _step_and_elbo(model, state)
    assert fused[3] == all_launches(dist_q_1d_planes=2, quad_kl_1d=1, quad_kl_1d_adjoint=1)
    assert fused[4] == all_launches(dist_q_1d_planes=1, quad_kl_1d=1)
    assert plain[3] == all_launches(dist_q_1d_planes=2)
    assert plain[4] == all_launches(dist_q_1d_planes=1)
    for got, ref in ((fused[1], plain[1]), (fused[2], plain[2])):
        assert abs(got - ref) <= STEP_LIMITS["elbo"] * abs(ref), (got, ref)
    for name in FIELDS:
        err = _scaled(getattr(fused[0], name), getattr(plain[0], name))
        assert err <= STEP_LIMITS["sites" if name in SITES else "marginals"], f"{name}: {err:.3e}"


def _fit(dev):
    """A ``dw1d`` fit (``portbench/configs/dw1d.json``) on one dataset at
    T = 100,000: its ELBO trace and the trainer's launches."""
    data = make_dataset(ExperimentConfig(num_grid=T, num_observations=200, seed=7), dev)
    model = CVISitesSDE.initialize_sde(
        build_prior_sde("dw", q=1.0, device=dev, scale=4.0, c=1.0), data.time_grid,
        (data.obs_times, data.obs_values), Gaussian(0.316**2).to(dev))
    trainer = CVISitesTrainer(model, sites_lr=0.5, max_inner_iters=20, max_outer_iters=10)
    reset_launch_counts()
    trainer.optimize()
    torch.cuda.synchronize()
    return trainer.elbo_trace, launch_counts()


def test_a_fit_accepts_the_same_steps(cuda_device, monkeypatch):
    """A whole captured ``CVISitesTrainer`` fit through F and F′ accepts as
    many steps as one through the plain route, each ELBO within
    ``FIT_LIMIT``; F′ launches once a tried step, F once more."""
    fused, launches = _fit(cuda_device)
    compiled.clear_cache()
    _plain(monkeypatch)
    plain, plain_launches = _fit(cuda_device)
    assert len(fused) == len(plain) >= 10
    for got, ref in zip(fused, plain):
        assert abs(got - ref) <= FIT_LIMIT * abs(ref), (got, ref)
    assert launches["quad_kl_1d_adjoint"] > 0
    assert launches["quad_kl_1d"] > launches["quad_kl_1d_adjoint"]
    assert plain_launches["quad_kl_1d"] == plain_launches["quad_kl_1d_adjoint"] == 0


def test_captured_step_replays_its_eager_bits(cuda_device):
    """At T = 2,000 in float64: the warm step reads nothing on the host
    (``NoHostSync``); the replays of the captured step and ``packed_elbo``
    equal the eager calls bit for bit, and launch F′ once and F once a
    step, F once an ELBO."""
    model = flagship_model(2_000, torch.float64, cuda_device)
    start = tp.pack_state(model)
    tp.packed_natgrad_step(model, start, LR)  # makes the step's constants
    with NoHostSync():
        warm = tp.packed_natgrad_step(model, start, LR)
    _assert_bits_equal(warm, tp.packed_natgrad_step(model, start, LR), "warm step")
    step, elbo_of = CapturedStep(tp.packed_natgrad_step), CapturedStep(tp.packed_elbo)
    first = step(model, start, LR)  # warm-up and capture
    _assert_bits_equal(first, tp.packed_natgrad_step(model, start, LR), "first call")
    assert next(iter(step._graphs.values())).launches == all_launches(
        dist_q_1d_planes=2, quad_kl_1d=1, quad_kl_1d_adjoint=1)
    captured = eager = first[0]
    for i in range(3):
        rate = LR if i % 2 else 0.5 * LR
        reset_launch_counts()
        out = step(model, captured, rate)
        assert launch_counts() == all_launches(dist_q_1d_planes=2, quad_kl_1d=1,
                                               quad_kl_1d_adjoint=1)
        ref = tp.packed_natgrad_step(model, eager, rate)
        _assert_bits_equal(out, ref, f"replay {i}")
        captured, eager = out[0], ref[0]
    elbo_of(model, captured)
    reset_launch_counts()
    _assert_bits_equal(elbo_of(model, captured), tp.packed_elbo(model, captured), "elbo")
    # the replay, then the eager call
    assert launch_counts() == all_launches(dist_q_1d_planes=2, quad_kl_1d=2)
