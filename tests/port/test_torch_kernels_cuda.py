"""The CUDA kernels K1–K4 and their backward passes against their plain
PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  The file imports no JAX, so it also runs on a machine without
it, as the README says:

    python -m pytest tests/port/test_torch_kernels_cuda.py --confcutdir=tests/port -m cuda

The sweeps K1 and K4 also run at N = 1, at a last window one element long,
on runs larger than the shared memory and near the parabolic limit.

Tolerances: f64 kernels to 1e-10 relative (pivots) or 1e-11 of the scale
(recurrences), f32 recurrences to 2e-6 of the scale, the f32 pivot sweep K4
to 1e-4 relative, and the f32 ``dist_q`` planes to the TPU kernel's
contract (rtol 2e-4, atol 1e-6).  Each backward pass on the card is held
against autograd through the plain version on the card: 1e-9 of the
gradient's scale in f64, 1e-3 in f32 (and for K3, whose marginals are f32).
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.ops import cuda_riccati
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts
from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import (
    riccati_d_sweep_f32,
    riccati_d_sweep_f32_plain,
    window_shape,
)

from .helpers import affine_inputs, assert_close_scaled, naturals, riccati_inputs
from .natgrad_exactness import chain_with_a_zero, chain_with_weak_couplings

pytestmark = pytest.mark.cuda

SIZES = [4097, 100_000]
NAMES = ["a", "b", "qv", "mu0", "p0v", "means", "vars"]
#: The tiled kernels' edges: the shortest sequences, one tile of 512 elements
#: either side of full (1023 = 2 tiles, 1025 = 3 with one element in the
#: last), a last tile one element long at T ~ 100k, and T ~ 1M
EDGE_SIZES = [2, 3, 1023, 1025, 195 * cs.TILE + 1, 1_048_577]
#: The sweeps' edges: N = 1 (D = kd) and a last window one element long at
#: T ~ 100k (99,876 = 425 windows of 235 and one element)
SWEEP_EDGE_SIZES = [1] + EDGE_SIZES + [99_876]
BATCHES = [1, 2, 8]


@pytest.mark.parametrize("n", SIZES)
def test_riccati_kernel_matches_plain(cuda_device, n):
    kd, b2 = (torch.tensor(v, device=cuda_device)
              for v in riccati_inputs(np.random.default_rng(n), n, (2,)))
    before = launch_counts()["riccati_d_sweep"]
    got = cs.riccati_d_sweep(kd, b2)
    assert launch_counts()["riccati_d_sweep"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), cs.riccati_d_sweep_plain(kd, b2).cpu().numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("n", SIZES)
def test_riccati_f32_kernel_matches_plain(cuda_device, n):
    kd, b2 = (torch.tensor(v, device=cuda_device, dtype=torch.float32)
              for v in riccati_inputs(np.random.default_rng(n), n, (2,)))
    before = launch_counts()["riccati_d_sweep_f32"]
    got = riccati_d_sweep_f32(kd, b2)
    assert launch_counts()["riccati_d_sweep_f32"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), riccati_d_sweep_f32_plain(kd, b2).cpu().numpy(),
                               rtol=1e-4)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", SWEEP_EDGE_SIZES)
def test_riccati_kernel_edge_sizes(cuda_device, n, batch):
    kd, b2 = (torch.tensor(v, device=cuda_device)
              for v in riccati_inputs(np.random.default_rng(n + batch), n, (batch,)))
    before = launch_counts()["riccati_d_sweep"]
    got = cs.riccati_d_sweep(kd, b2)
    assert launch_counts()["riccati_d_sweep"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), cs.riccati_d_sweep_plain(kd, b2).cpu().numpy(),
                               rtol=1e-10)


def _extreme_chain(kind, n):
    """A chain at the edges of float64's range on the kernels' windows
    (``window_shape``), and the per-element factor ``c²`` of its magnitudes
    (1 where it has none): the random chain of :func:`riccati_inputs` under
    powers of two ``2^e``, ``e`` in [−498, 498] per window (1e±150), or the
    chains of ``natgrad_exactness.py`` with their special element or weak
    windows on the kernel's window boundaries."""
    nb, l = window_shape(n)
    c2 = np.ones(n)
    if kind == "magnitudes":
        kd, b2 = riccati_inputs(np.random.default_rng(n), n)
        e = np.random.default_rng(5).integers(-498, 499, nb)
        c2 = np.ldexp(1.0, np.repeat(e, l)[:n])
        kd, b2 = kd * c2, b2 * c2 * np.append(c2[1:], 1.0)
    elif kind == "weak_couplings":
        kd, b2 = chain_with_weak_couplings(n, nb)
    else:
        kd, b2 = chain_with_a_zero(n, nb, at=kind)
    return kd, b2, c2


@pytest.mark.parametrize("kind", ["magnitudes", "weak_couplings", "pivot_first", "pivot_last",
                                  "coupling"])
@pytest.mark.parametrize("n", [4096, 100_000])
def test_sweep_kernels_match_plain_on_extreme_chains(cuda_device, n, kind):
    """K1 against the plain version (rtol 1e-10; the pivots 0 and −inf of a
    zero pivot exactly), and on the power-of-two magnitudes its own run on
    the unscaled chain times ``c²``, bit for bit; K3 (f64 out) against its
    plain version on the naturals of the same chain (``covs`` to rtol 1e-10,
    every output finite), where no pivot is 0."""
    kd, b2, c2 = _extreme_chain(kind, n)
    k1 = cs.riccati_d_sweep(*(torch.tensor(x, device=cuda_device) for x in (kd, b2))).cpu().numpy()
    plain = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2)).numpy()
    regular = np.isfinite(plain) & (plain != 0)
    assert np.array_equal(k1[~regular], plain[~regular])
    np.testing.assert_allclose(k1[regular], plain[regular], rtol=1e-10)
    if kind == "magnitudes":
        unscaled = [torch.tensor(x / y, device=cuda_device) for x, y in
                    ((kd, c2), (b2, c2 * np.append(c2[1:], 1.0)))]
        assert np.array_equal(k1, cs.riccati_d_sweep(*unscaled).cpu().numpy() * c2)
    if kind.startswith("pivot"):
        return
    nat = [np.random.default_rng(1).normal(size=n), -0.5 * kd, -np.sqrt(b2[:-1])]
    got = cs.dist_q_1d_planes(*(torch.tensor(x, device=cuda_device) for x in nat), torch.float64)
    ref = cs.dist_q_1d_planes_plain(*(torch.tensor(x) for x in nat), torch.float64)
    for name, g, r in zip(NAMES, got, ref):
        assert bool(torch.isfinite(g).all()), name
    for i in (2, 4):  # qv and p0v: covs = 1/D
        np.testing.assert_allclose(got[i].cpu().numpy(), ref[i].numpy(), rtol=1e-10,
                                   err_msg=NAMES[i])


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", SWEEP_EDGE_SIZES)
def test_riccati_f32_kernel_edge_sizes(cuda_device, n, batch):
    kd, b2 = (torch.tensor(v, device=cuda_device, dtype=torch.float32)
              for v in riccati_inputs(np.random.default_rng(n + batch), n, (batch,)))
    before = launch_counts()["riccati_d_sweep_f32"]
    got = riccati_d_sweep_f32(kd, b2)
    assert launch_counts()["riccati_d_sweep_f32"] == before + 1
    ref = riccati_d_sweep_f32_plain(kd, b2, windows=window_shape(n))
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("n, batch, windows", [
    (100_000, 200, None),         # one block a sequence, its windows in several chunks
    (1_048_577, 8, None),         # several blocks a sequence, each run in several chunks
    (50_000, 1, (25, 2001)),      # long windows, one a block
    (4097, 1, (4097 + 5, 1)),     # more windows than elements
])
def test_riccati_f32_kernel_chunked_runs_and_explicit_windows(cuda_device, n, batch, windows):
    """The path that loads a block's run again for the exact recursion
    (a run larger than the shared memory) and windows other than the
    default, against the resident path or the plain version."""
    kd, b2 = (torch.tensor(v, device=cuda_device, dtype=torch.float32)
              for v in riccati_inputs(np.random.default_rng(n), n, (batch,)))
    shape = cuda_riccati.launch_shape(batch, n, cuda_device, windows)
    if windows is None:
        assert shape["windows_per_chunk"] < shape["windows_per_block"]
    got = cuda_riccati._forward(kd, b2, windows)
    if batch > 8:  # the plain version is slow at this batch: one sequence alone is resident
        ref = cuda_riccati._forward(kd[:1].contiguous(), b2[:1].contiguous(), windows)
        got = got[:1]
    else:
        ref = riccati_d_sweep_f32_plain(kd, b2, windows=windows)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4)


def test_riccati_f32_kernel_parabolic_case(cuda_device):
    """Near the parabolic limit at T = 100,000: within 2e-3 of the float64
    recursion, every pivot positive (test_pallas_riccati.py:25-36)."""
    n, a, qinv = 100_000, 0.9996, 12500.0
    kd = np.full(n, qinv * (1 + a * a))
    kd[-1] = qinv
    kd[50::500] += 25.0
    b2 = np.concatenate([np.full(n - 1, (qinv * a) ** 2), [0.0]])
    want = kd.copy()
    for k in range(n - 2, -1, -1):
        want[k] = kd[k] - b2[k] / want[k + 1]
    got = riccati_d_sweep_f32(torch.tensor(kd, device=cuda_device, dtype=torch.float32),
                              torch.tensor(b2, device=cuda_device, dtype=torch.float32))
    assert bool((got > 0).all())
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3)


def test_riccati_d_scalar_on_card_skips_the_b2_check(cuda_device):
    """The port's own sweeps reach the kernels without the host-side read of
    ``b2[..., -1]``; the public wrappers still raise."""
    from vi_diffusion_processes_tpu_torch.ops.btd import riccati_d_scalar

    for dtype, public in ((torch.float64, cs.riccati_d_sweep), (torch.float32, riccati_d_sweep_f32)):
        kd, b2 = (torch.tensor(v, device=cuda_device, dtype=dtype)
                  for v in riccati_inputs(np.random.default_rng(0), 4097))
        bad = b2.clone()
        bad[-1] = 0.5
        before = launch_counts()[public.__name__]
        assert bool(torch.isfinite(riccati_d_scalar(kd, bad)).all())
        assert launch_counts()[public.__name__] == before + 1
        with pytest.raises(ValueError, match="b2"):
            public(kd, bad)


def _adjoint_case(name, dev, n):
    """(kernel fn, plain fn, inputs, cotangent, tol, mask of b2's last entry)."""
    rng = np.random.default_rng(n)
    kd, b2 = (torch.tensor(v, device=dev) for v in riccati_inputs(rng, n))
    t, c = (torch.tensor(v, device=dev) for v in affine_inputs(rng, n))
    g = torch.tensor(rng.normal(size=n), device=dev)
    if name == "K1":
        return cs.riccati_d_sweep, cs.riccati_d_sweep_plain, (kd, b2), g, 1e-9
    if name == "K4":
        return (riccati_d_sweep_f32, riccati_d_sweep_f32_plain, (kd.float(), b2.float()),
                g.float(), 1e-3)
    if name == "K3":
        nat = [torch.tensor(v, device=dev) for v in naturals(rng, n)]
        cts = [torch.tensor(rng.normal(size=s), device=dev, dtype=torch.float32)
               for s in [(n - 1,)] * 3 + [()] * 2 + [(n,)] * 2]
        return (lambda *a: cs.dist_q_1d_planes(*a, torch.float32),
                lambda *a: cs.dist_q_1d_planes_plain(*a, torch.float32), nat, cts, 1e-3)
    _, dtype, direction = name.split("-")
    dt, rev = getattr(torch, dtype), direction == "rev"
    x0 = torch.tensor(0.7, dtype=dt, device=dev)
    return (lambda *a: cs.linear_recurrence(*a, rev), lambda *a: cs.linear_recurrence_plain(*a, rev),
            (t.to(dt), c.to(dt), x0), g.to(dt), 1e-9 if dt == torch.float64 else 1e-3)


@pytest.mark.parametrize("name", ["K1", "K2-float64-fwd", "K2-float64-rev", "K2-float32-fwd",
                                  "K2-float32-rev", "K3", "K4"])
def test_backward_matches_autograd_through_plain(cuda_device, name):
    fn, plain, inputs, ct, tol = _adjoint_case(name, cuda_device, 100_000)
    grads = []
    for f in (fn, plain):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        out = f(*leaves)
        before = launch_counts()["linear_recurrence"]
        grads.append(torch.autograd.grad(out, leaves, ct))
        if f is fn:
            assert launch_counts()["linear_recurrence"] > before  # the backward ran on K2
    for i, (g, r) in enumerate(zip(*grads)):
        if name in ("K1", "K4") and i == 1:
            # b2[-1] is the structural zero: autograd through the plain
            # version's sqrt(b2) gives NaN there, the adjoint formula 0
            g, r = g[:-1], r[:-1]
        assert_close_scaled(g.cpu(), r.cpu(), tol, err_msg=f"{name} input {i}")


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", SIZES)
def test_linear_recurrence_kernel_matches_plain(cuda_device, n, dtype, reverse):
    t, c = (torch.tensor(v, device=cuda_device, dtype=dtype)
            for v in affine_inputs(np.random.default_rng(n), n, (2,)))
    x0 = torch.tensor([0.7, -0.3], device=cuda_device, dtype=dtype)
    got = cs.linear_recurrence(t, c, x0, reverse)
    ref = cs.linear_recurrence_plain(t, c, x0, reverse)
    assert_close_scaled(got.cpu(), ref.cpu(), 1e-11 if dtype == torch.float64 else 2e-6)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", SIZES)
def test_dist_q_kernel_matches_plain(cuda_device, n, out_dtype):
    nat = [torch.tensor(v, device=cuda_device)
           for v in naturals(np.random.default_rng(n), n, (2,))]
    got = cs.dist_q_1d_planes(*nat, out_dtype)
    ref = cs.dist_q_1d_planes_plain(*nat, out_dtype)
    for nm, g, r in zip(NAMES, got, ref):
        assert g.dtype == out_dtype, nm
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=2e-4, atol=1e-6, err_msg=nm)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_linear_recurrence_kernel_edge_sizes(cuda_device, dtype, reverse, n, batch):
    t, c = (torch.tensor(v, device=cuda_device, dtype=dtype)
            for v in affine_inputs(np.random.default_rng(n + batch), n, (batch,)))
    x0 = torch.linspace(-0.5, 0.7, batch, device=cuda_device, dtype=dtype)
    before = launch_counts()["linear_recurrence"]
    got = cs.linear_recurrence(t, c, x0, reverse)
    assert launch_counts()["linear_recurrence"] == before + 1
    ref = cs.linear_recurrence_plain(t, c, x0, reverse)
    assert_close_scaled(got.cpu(), ref.cpu(), 1e-11 if dtype == torch.float64 else 2e-6)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_dist_q_kernel_edge_sizes(cuda_device, out_dtype, n, batch):
    nat = [torch.tensor(v, device=cuda_device)
           for v in naturals(np.random.default_rng(n + batch), n, (batch,))]
    before = launch_counts()["dist_q_1d_planes"]
    got = cs.dist_q_1d_planes(*nat, out_dtype)
    assert launch_counts()["dist_q_1d_planes"] == before + 1
    ref = cs.dist_q_1d_planes_plain(*nat, out_dtype)
    for nm, g, r in zip(NAMES, got, ref):
        assert g.dtype == out_dtype, nm
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=2e-4, atol=1e-6, err_msg=nm)


def test_riccati_f32_launch_shape_spreads_one_sequence(cuda_device):
    """One sequence of 100,000 takes many blocks, its run resident in shared
    memory; a batch too large for two blocks a sequence takes one block each."""
    one = cuda_riccati.launch_shape(1, 100_000, cuda_device)
    assert (one["windows"], one["window_length"]) == window_shape(100_000)
    assert one["blocks_per_sequence"] > 1 and one["grid"] == one["blocks_per_sequence"]
    assert one["windows_per_chunk"] == one["windows_per_block"]
    assert one["blocks_per_sequence"] * one["windows_per_block"] >= one["windows"]
    many = cuda_riccati.launch_shape(100_000, 100_000, cuda_device)
    assert many["grid"] == 100_000 and many["blocks_per_sequence"] == 1


@pytest.mark.parametrize("name, dtype", [("riccati_d_sweep", torch.float64),
                                         ("linear_recurrence", torch.float32),
                                         ("linear_recurrence", torch.float64),
                                         ("dist_q_1d_planes", torch.float32),
                                         ("dist_q_1d_planes", torch.float64)])
def test_launch_shape_spreads_one_sequence(cuda_device, name, dtype):
    """One sequence of 100,000 takes many blocks; a batch too large for two
    blocks a sequence takes one block each, with no grid sync."""
    one = cs.launch_shape(name, dtype, 1, 100_000, cuda_device)
    assert one["blocks_per_sequence"] > 1 and one["grid"] == one["blocks_per_sequence"]
    # at most one block a window (the sweep, K1) or a tile (the affine scans)
    parts = one["windows"] if name == "riccati_d_sweep" else -(-100_000 // one["tile"])
    assert one["blocks_per_sequence"] <= parts
    many = cs.launch_shape(name, dtype, 100_000, 100_000, cuda_device)
    assert many == {**many, "grid": 100_000, "blocks_per_sequence": 1}


def test_packed_step_on_card_matches_cpu(cuda_device):
    """Three float64 packed steps with the kernels against the plain
    versions on the CPU: association order is the only difference."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    n = 3000
    grid = np.linspace(0.0, 10.0, n)
    idx = np.arange(50, n - 1, 50)
    y = np.sign(np.sin(0.6 * grid[idx]))[:, None] + 0.2 * np.random.default_rng(0).normal(size=(len(idx), 1))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        model = CVISitesSDE.initialize(
            prior_ssm=None, time_grid=torch.tensor(grid, device=dev),
            input_data=(torch.tensor(grid[idx], device=dev), torch.tensor(y, device=dev)),
            likelihood=Gaussian(0.04).to(dev),
            prior_initial_state=GaussianState(torch.zeros(1, dtype=torch.float64, device=dev),
                                              torch.tensor([[0.8]], device=dev)),
            prior_sde=DoubleWellSDE(q=[[0.8]]).to(dev),
        ).set_linearized_prior()
        state = pack_state(model)
        for _ in range(3):
            state, elbo = packed_natgrad_step(model, state, 0.3)
        out.append((float(elbo), state))
    (e_card, s_card), (e_cpu, s_cpu) = out
    np.testing.assert_allclose(e_card, e_cpu, rtol=1e-9)
    for name in ("g_nat1", "g_nat2d", "g_nat2s", "fx_mu", "fx_var"):
        assert_close_scaled(getattr(s_card, name).cpu(), getattr(s_cpu, name), 1e-9, err_msg=name)


# Interior zeros: B rows laid end to end, with zero couplings at the row
# boundaries, as the batched CVI-DP step gives them to the kernels.  A row
# length of 512 puts every boundary on a tile edge of K1-K3.
ROW_LENGTHS = [511, 512, 513, 10_000]
ROW_BATCHES = [2, 8]


@pytest.mark.parametrize("batch", ROW_BATCHES)
@pytest.mark.parametrize("t_row", ROW_LENGTHS)
def test_sweep_kernels_decouple_at_interior_zeros(cuda_device, t_row, batch):
    """K1 (float64) and K4 (float32) on the flat chain against their plain
    versions row by row and against the kernels' own ``[B, T]`` call."""
    kd, b2 = (torch.tensor(v, device=cuda_device)
              for v in riccati_inputs(np.random.default_rng(t_row + batch), t_row, (batch,)))
    cases = ((cs.riccati_d_sweep, cs.riccati_d_sweep_plain, kd, b2, 1e-10),
             (riccati_d_sweep_f32, riccati_d_sweep_f32_plain, kd.float(), b2.float(), 1e-4))
    for kernel, plain, k, c, rtol in cases:
        before = launch_counts()[kernel.__name__]
        flat = kernel(k.reshape(-1), c.reshape(-1)).reshape(batch, t_row)
        assert launch_counts()[kernel.__name__] == before + 1
        assert torch.equal(flat[:, -1], k[:, -1])  # D = kd where b2 = 0
        np.testing.assert_allclose(flat.cpu().numpy(), plain(k, c).cpu().numpy(), rtol=rtol)
        np.testing.assert_allclose(flat.cpu().numpy(), kernel(k, c).cpu().numpy(), rtol=rtol)
        # another row 1 moves no other row beyond rounding
        k2 = k.clone()
        k2[1] *= 1.1
        moved = kernel(k2.reshape(-1), c.reshape(-1)).reshape(batch, t_row)
        keep = [j for j in range(batch) if j != 1]
        np.testing.assert_allclose(moved[keep].cpu().numpy(), flat[keep].cpu().numpy(),
                                   rtol=1e-13 if k.dtype == torch.float64 else 1e-5)
        assert not torch.allclose(moved[1], flat[1])


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("batch", ROW_BATCHES)
@pytest.mark.parametrize("t_row", ROW_LENGTHS)
def test_dist_q_kernel_decouples_at_interior_zeros(cuda_device, t_row, batch, out_dtype):
    """K3 on the flat chain ``[B·T]`` against its ``[B, T]`` call (one
    sequence per row) and its plain version: every row restarts from its own
    ``(mu0, P0)`` and ``a = 0`` across a boundary."""
    nat1, nat2d, nat2s = (torch.tensor(v, device=cuda_device)
                          for v in naturals(np.random.default_rng(t_row + batch), t_row, (batch,)))
    flat_sub = torch.nn.functional.pad(nat2s, (0, 1)).reshape(-1)[:-1].contiguous()
    before = launch_counts()["dist_q_1d_planes"]
    a, b, qv, _, _, means, varis = cs.dist_q_1d_planes(
        nat1.reshape(-1), nat2d.reshape(-1), flat_sub, out_dtype)
    assert launch_counts()["dist_q_1d_planes"] == before + 1
    pad = lambda x: torch.cat([x, x.new_zeros(1)]).reshape(batch, t_row)
    assert bool((pad(a)[:-1, -1] == 0).all())
    got = {"a": pad(a)[:, :-1], "b": pad(b)[:, :-1], "qv": pad(qv)[:, :-1],
           "means": means.reshape(batch, t_row), "vars": varis.reshape(batch, t_row)}
    got["mu0"], got["p0v"] = got["means"][:, 0], got["vars"][:, 0]
    rtol = 1e-9 if out_dtype == torch.float64 else 2e-6
    for label, fn in (("[B, T] call", cs.dist_q_1d_planes), ("plain", cs.dist_q_1d_planes_plain)):
        ref = dict(zip(NAMES, fn(nat1, nat2d, nat2s, out_dtype)))
        for name, g in got.items():
            assert_close_scaled(g.cpu(), ref[name].cpu(), rtol, err_msg=f"{name} vs {label}")


def _double_well_model(dev, n, seed, p_mu0=0.0, p_var0=0.8, dtype=torch.float64):
    """A double-well CVI-DP model on [0, 10] with its own observations."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    grid = np.linspace(0.0, 10.0, n)
    idx = np.arange(7 + seed, n - 1, 13)
    y = (np.sign(np.sin((0.6 + 0.2 * seed) * grid[idx]))[:, None]
         + 0.2 * np.random.default_rng(seed).normal(size=(len(idx), 1)))
    return CVISitesSDE.initialize(
        prior_ssm=None, time_grid=torch.tensor(grid, device=dev, dtype=dtype),
        input_data=(torch.tensor(grid[idx], device=dev, dtype=dtype),
                    torch.tensor(y, device=dev, dtype=dtype)),
        likelihood=Gaussian(0.04, dtype=dtype).to(dev),
        prior_initial_state=GaussianState(torch.full((1,), p_mu0, dtype=dtype, device=dev),
                                          torch.tensor([[p_var0]], dtype=dtype, device=dev)),
        prior_sde=DoubleWellSDE(q=[[0.8]], dtype=dtype).to(dev),
    ).set_linearized_prior()


def test_batched_step_on_card_matches_cpu(cuda_device):
    """Three float64 batched steps (B = 3, T = 512: the row boundaries on
    tile edges) with K3 on the flat chain against the CPU."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_batched import (
        pack_state_batched,
        packed_natgrad_step_batched,
    )

    out = []
    for dev in (cuda_device, torch.device("cpu")):
        models = [_double_well_model(dev, 512, j, 0.1 * j, 0.8 + 0.1 * j) for j in range(3)]
        state = pack_state_batched(models)
        before = launch_counts()["dist_q_1d_planes"]
        for _ in range(3):
            state, elbos = packed_natgrad_step_batched(models[0], state, 0.3)
        if dev.type == "cuda":
            assert launch_counts()["dist_q_1d_planes"] == before + 6
        out.append((elbos.cpu(), state))
    (e_card, s_card), (e_cpu, s_cpu) = out
    np.testing.assert_allclose(e_card.numpy(), e_cpu.numpy(), rtol=1e-9)
    for name in ("g_nat1", "g_nat2d", "g_nat2s", "d_nat1", "fx_mu", "fx_var"):
        assert_close_scaled(getattr(s_card, name).cpu(), getattr(s_cpu, name), 1e-9, err_msg=name)


def test_batched_step_with_x64_off_on_card_matches_cpu(cuda_device):
    """float32 naturals: K4 and four float32 K2 launches per ``dist_q`` on a
    flat chain whose windows cut the rows anywhere; against the CPU to 1e-3."""
    from vi_diffusion_processes_tpu_torch import config
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_batched import (
        pack_state_batched,
        packed_natgrad_step_batched,
    )

    out = []
    with config.enable_x64(False):
        for dev in (cuda_device, torch.device("cpu")):
            models = [_double_well_model(dev, 513, j, dtype=torch.float32) for j in range(3)]
            state = pack_state_batched(models)
            assert state.p_nat1.dtype == torch.float32
            before = launch_counts()["riccati_d_sweep_f32"]
            for _ in range(2):
                state, elbos = packed_natgrad_step_batched(models[0], state, 0.3)
            if dev.type == "cuda":
                assert launch_counts()["riccati_d_sweep_f32"] == before + 4
            out.append((elbos.cpu(), state))
    (e_card, s_card), (e_cpu, s_cpu) = out
    np.testing.assert_allclose(e_card.numpy(), e_cpu.numpy(), rtol=1e-3)
    for name in ("g_nat1", "g_nat2d", "fx_mu", "fx_var"):
        assert_close_scaled(getattr(s_card, name).cpu(), getattr(s_cpu, name), 1e-3, err_msg=name)


@pytest.mark.parametrize("stabilize", [False, True], ids=["plain", "stabilize"])
def test_vdp_step_on_card_matches_cpu(cuda_device, stabilize):
    """Three float64 VDP steps, packed (K2 four times a step) and generic,
    against the CPU: association order is the only difference."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
    from vi_diffusion_processes_tpu_torch.models.vdp_packed import (
        pack_vdp,
        packed_inference_step,
        packed_vdp_elbo,
    )
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    n = 1025
    rng = np.random.default_rng(3)
    grid = np.linspace(0.0, 5.0, n)
    idx = np.arange(20, n - 1, 37)
    y = np.sign(np.sin(1.3 * grid[idx]))[:, None] + 0.2 * rng.normal(size=(len(idx), 1))
    a0, b0 = rng.uniform(0.1, 0.8, size=(n - 1, 1, 1)), rng.normal(0.0, 0.3, size=(n - 1, 1))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        model = VariationalMarkovGP.initialize(
            (torch.tensor(grid[idx], device=dev), torch.tensor(y, device=dev)),
            DoubleWellSDE(q=[[0.8]]).to(dev), torch.tensor(grid, device=dev),
            Gaussian(0.04).to(dev), stabilize=stabilize,
        ).replace(A=torch.tensor(a0, device=dev), b=torch.tensor(b0, device=dev))
        state, generic = pack_vdp(model), model
        before = launch_counts()["linear_recurrence"]
        for _ in range(3):
            state = packed_inference_step(model, state, 0.05, 0.02)
        if dev.type == "cuda":
            assert launch_counts()["linear_recurrence"] == before + 12
        for _ in range(3):
            generic = generic.inference_step(0.05, 0.02)
        out.append((float(packed_vdp_elbo(model, state)), state, pack_vdp(generic)))
    (e_card, s_card, g_card), (e_cpu, s_cpu, _) = out
    np.testing.assert_allclose(e_card, e_cpu, rtol=1e-9)
    for name in ("a", "b", "lam", "psi", "q0_mean", "q0_var"):
        assert_close_scaled(getattr(s_card, name).cpu(), getattr(s_cpu, name), 1e-9, err_msg=name)
        assert_close_scaled(getattr(g_card, name).cpu(), getattr(s_cpu, name), 1e-8, err_msg=name)
