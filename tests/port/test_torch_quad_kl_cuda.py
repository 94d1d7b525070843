"""The d = 2 KL's quadrature kernels (``ops/quad_kl.py``, ``csrc/quad_kl.cu``)
on the card, against their plain PyTorch version.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports no JAX:

    python -m pytest tests/port/test_torch_quad_kl_cuda.py --confcutdir=tests/port -m cuda

The inputs are those the third packed float64 step of the Van der Pol
configuration at T = 100,000 (Δt = 1e-4) hands the kernel, and slices of
them: N = 1 (T = 2), 45 and 99,999 transitions leave the last block of 32
part empty, 4,096 fills it.  The kernel takes ``x + Δt f(x) − (A x + b)`` as
``(I − A) x − b + Δt f(x)``, whose terms have the size of the difference;
the plain expression subtracts two sums of the size of ``x`` and loses
``|x|/|diff|`` ≈ 1e4 ulps there.  So each limit below is set against the
plain version evaluated in float64 on the kernel's own inputs:

* float64: 1e-10 relative for ``s`` and 1e-10 of each cotangent's largest
  magnitude: the plain path's own cancellation is about 1e-12 at Δt = 1e-4
  (an emulation of the kernel's arithmetic on the CPU read 4.8e-13 and
  3.3e-13), and the order of the sum over the 400 points differs;
* float32: 1e-5 against the float64 plain version on the same float32
  inputs (the emulation read 2.6e-7 and 2.2e-7).  The plain version in
  float32 is no yardstick there: its cancellation puts it 3.6e-4 off.
"""
import pytest
import torch

from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.ops import quad_kl as qk
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep

from .test_torch_compiled_cuda import _assert_bits_equal, _vanderpol

pytestmark = pytest.mark.cuda

T = 100_000
NAMES = ("mu", "L", "A", "b", "P")
#: (relative limit of s, limit of each cotangent over its largest magnitude)
LIMITS = {torch.float64: (1e-10, 1e-10), torch.float32: (1e-5, 1e-5)}


def kernel_inputs(model, state, lr=0.2):
    """The arguments that one packed step hands ``quad_kl`` for its
    Girsanov gradient, detached: ``([μ, L, A, b, P], (z, w, Δt), (a, τ))``."""
    calls, real = [], tch.quad_kl
    tch.quad_kl = lambda *args: calls.append(args) or real(*args)
    try:
        tch.packed_natgrad_step_ch(model, state, lr)
    finally:
        tch.quad_kl = real
    *tensors, z, w, dt, _, params = calls[0]
    return [x.detach() for x in tensors], (z, w, dt), params


@pytest.fixture(scope="module")
def transitions():
    """The kernel's inputs in the third float64 step at T = 100,000."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    model = _vanderpol(T, torch.device("cuda", 0), torch.float64)
    state = tch.pack_state_ch(model)
    for _ in range(2):
        state, _ = tch.packed_natgrad_step_ch(model, state, 0.2)
    return kernel_inputs(model, state)


def _cast(xs, dtype):
    return [x.to(dtype) for x in xs]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 45, 4_096, T - 1])
def test_kernels_against_the_plain_version(transitions, dtype, n):
    """``s`` and the five cotangents of ``g_s`` (random) by the two
    kernels, against the plain forward and autograd through it in float64
    on the same inputs; one launch of each kernel."""
    tensors, grid, params = transitions
    tensors, grid, params = ([x[:n].contiguous().to(dtype) for x in tensors], _cast(grid, dtype),
                             _cast(params, dtype))
    g_s = torch.randn(n, generator=torch.Generator().manual_seed(n), dtype=torch.float64)
    g_s = g_s.to(dtype).cuda()
    leaves = [x.clone().requires_grad_() for x in tensors]
    reset_launch_counts()
    s = qk.quad_kl(*leaves, *grid, "vanderpol", params)
    grads = torch.autograd.grad(s, leaves, g_s)
    torch.cuda.synchronize()
    assert launch_counts()["quad_kl"] == 1 and launch_counts()["quad_kl_adjoint"] == 1
    assert s.dtype == dtype and all(g.dtype == dtype for g in grads)

    ref_leaves = [x.double().requires_grad_() for x in tensors]
    z, w, dt = _cast(grid, torch.float64)
    a, tau = _cast(params, torch.float64)
    ref = qk.quad_kl_plain(*ref_leaves, z, w, dt, lambda x: qk.vanderpol_drift(x, a, tau)[0])
    ref_grads = torch.autograd.grad(ref, ref_leaves, g_s.double())
    s_limit, g_limit = LIMITS[dtype]
    rel = float(((s.detach().double() - ref) / ref.abs()).abs().max())
    assert rel <= s_limit, f"s: {rel:.3e}"
    for name, g, r in zip(NAMES, grads, ref_grads):
        err = float((g.double() - r).abs().max() / r.abs().max())
        assert err <= g_limit, f"{name}: {err:.3e}"


def test_nan_in_chol_gives_nan_on_the_card(transitions):
    """No clamp in the kernels: a NaN in one ``L`` makes that ``s_n`` and
    its cotangents NaN, and no other."""
    tensors, grid, params = transitions
    tensors = [x[:100].clone() for x in tensors]
    tensors[1][37, 1, 1] = float("nan")
    s = qk.quad_kl(*tensors, *grid, "vanderpol", params)
    g = qk.quad_kl_adjoint(torch.ones_like(s), *tensors, *grid, "vanderpol", params)
    bad = torch.zeros(100, dtype=torch.bool, device=s.device)
    bad[37] = True
    assert torch.equal(torch.isnan(s), bad)
    for name, x in zip(NAMES, g):
        assert torch.equal(torch.isnan(x).flatten(1).any(1), bad), name


def test_launch_shape_takes_many_blocks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    shape = qk.launch_shape(T - 1)
    assert shape["grid"] == -(-(T - 1) // (shape["threads_per_block"]
                                        // shape["lanes_per_transition"]))
    assert shape["shared_memory_bytes"] == 3 * 400 * 8


def test_captured_float64_step_replays_its_eager_bits(cuda_device):
    """The float64 packed step at T = 2,000 through ``CapturedStep``: the
    replays equal the eager steps bit for bit, each replay launches the
    forward twice (the Girsanov gradient, the ELBO) and the adjoint once,
    and a replayed ``packed_elbo_ch`` the forward once."""
    model = _vanderpol(2_000, cuda_device, torch.float64)
    step, elbo_of = CapturedStep(tch.packed_natgrad_step_ch), CapturedStep(tch.packed_elbo_ch)
    start = tch.pack_state_ch(model)
    first = step(model, start, 0.2)  # warm-up and capture
    _assert_bits_equal(first, tch.packed_natgrad_step_ch(model, start, 0.2), "first call")
    assert next(iter(step._graphs.values())).launches == {
        k: {"quad_kl": 2, "quad_kl_adjoint": 1}.get(k, 0) for k in launch_counts()}
    captured = eager = first[0]
    reset_launch_counts()
    for i in range(3):
        out = step(model, captured, 0.2 if i % 2 else 0.1)
        ref = tch.packed_natgrad_step_ch(model, eager, 0.2 if i % 2 else 0.1)
        _assert_bits_equal(out, ref, f"replay {i}")
        captured, eager = out[0], ref[0]
    assert launch_counts()["quad_kl"] == 3 * 2 + 3 * 2  # replays, then the eager steps
    assert launch_counts()["quad_kl_adjoint"] == 3 + 3
    elbo_of(model, captured)
    reset_launch_counts()
    _assert_bits_equal(elbo_of(model, captured), tch.packed_elbo_ch(model, captured), "elbo")
    assert launch_counts()["quad_kl"] == 2 and launch_counts()["quad_kl_adjoint"] == 0
