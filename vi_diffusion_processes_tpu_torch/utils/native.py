"""ctypes bindings of the host C++ kernels ``native/btd_kernels.cpp``
(vi_diffusion_processes_tpu/utils/native.py, the port's own copy).

The library is the sequential host baseline: block-tridiagonal Cholesky,
the in-band blocks of its inverse and a batched scalar Euler–Maruyama.  It
is built at first use with ``g++`` from the repository's ``native/``
source, with the flags of ``native/Makefile``, into ``build/native/`` under
a name that carries a hash of the source (an edited source rebuilds; the
file appears by an atomic rename, so concurrent processes never load half
of it).  Every entry point takes and returns numpy arrays and has a NumPy
fallback where the library cannot be built, as in the JAX package;
:func:`native_available` says which runs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "load_native",
    "native_available",
    "btd_cholesky_native",
    "btd_blocks_of_inverse_native",
    "euler_maruyama_1d_native",
]

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "btd_kernels.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
#: native/Makefile's CXXFLAGS
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

DRIFT_TYPES = {"ou": 0, "dw": 1, "benes": 2, "sine": 3, "sqrt": 4}


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SOURCE.read_bytes())
    return _BUILD_DIR / f"libbtd_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_native() -> Optional[ctypes.CDLL]:
    """Load the library, building it first if needed; ``None`` where it
    cannot be built or loaded."""
    try:
        so = _library_path()
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([os.environ.get("CXX", "g++"), *_FLAGS, str(_SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None

    dptr = ctypes.POINTER(ctypes.c_double)
    lib.btd_cholesky.restype = ctypes.c_int
    lib.btd_cholesky.argtypes = [dptr, dptr, ctypes.c_int64, ctypes.c_int, dptr, dptr]
    lib.btd_blocks_of_inverse.restype = None
    lib.btd_blocks_of_inverse.argtypes = [dptr, dptr, ctypes.c_int64, ctypes.c_int, dptr, dptr]
    lib.euler_maruyama_1d.restype = None
    lib.euler_maruyama_1d.argtypes = [
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        dptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_uint64, dptr,
    ]
    return lib


def native_available() -> bool:
    return load_native() is not None


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def btd_cholesky_native(diag: np.ndarray, sub: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Block-tridiagonal Cholesky ``(L_diag [N, d, d], L_sub [N−1, d, d])``
    of ``(diag, sub)`` on the host; raises ``LinAlgError`` when the matrix
    is not positive definite."""
    diag = np.ascontiguousarray(diag, dtype=np.float64)
    sub = np.ascontiguousarray(sub, dtype=np.float64)
    n, d = diag.shape[0], diag.shape[-1]
    ldiag = np.empty_like(diag)
    lsub = np.empty_like(sub)
    lib = load_native()
    if lib is not None:
        rc = lib.btd_cholesky(_as_ptr(diag), _as_ptr(sub), n, d, _as_ptr(ldiag), _as_ptr(lsub))
        if rc != 0:
            raise np.linalg.LinAlgError("btd_cholesky: matrix not positive definite")
        return ldiag, lsub
    ldiag[0] = np.linalg.cholesky(diag[0])
    for k in range(n - 1):
        ck = np.linalg.solve(ldiag[k], sub[k].T).T
        lsub[k] = ck
        ldiag[k + 1] = np.linalg.cholesky(diag[k + 1] - ck @ ck.T)
    return ldiag, lsub


def btd_blocks_of_inverse_native(ldiag: np.ndarray, lsub: np.ndarray):
    """The in-band blocks of ``(L Lᵀ)⁻¹`` (Takahashi's recursion) on the host."""
    ldiag = np.ascontiguousarray(ldiag, dtype=np.float64)
    lsub = np.ascontiguousarray(lsub, dtype=np.float64)
    n, d = ldiag.shape[0], ldiag.shape[-1]
    sdiag = np.empty_like(ldiag)
    ssub = np.empty_like(lsub)
    lib = load_native()
    if lib is not None:
        lib.btd_blocks_of_inverse(_as_ptr(ldiag), _as_ptr(lsub), n, d, _as_ptr(sdiag),
                                  _as_ptr(ssub))
        return sdiag, ssub
    sig_next = None
    for k in range(n - 1, -1, -1):
        linv = np.linalg.inv(ldiag[k])
        base = linv.T @ linv
        if k < n - 1:
            g = -linv.T @ lsub[k].T
            cross = g @ sig_next
            ssub[k] = cross.T
            base = base + cross @ g.T
        sdiag[k] = base
        sig_next = sdiag[k]
    return sdiag, ssub


def euler_maruyama_1d_native(
    drift: str, params: Tuple[float, ...], sqrt_q: float,
    x0: np.ndarray, num_steps: int, dt: float, seed: int,
) -> np.ndarray:
    """Batched scalar Euler–Maruyama ``[B, num_steps]`` on the host, from the
    library's own generator (``seed``); the NumPy fallback draws from
    ``default_rng(seed)`` instead."""
    x0 = np.ascontiguousarray(x0, dtype=np.float64).reshape(-1)
    b = x0.shape[0]
    p0 = params[0] if len(params) > 0 else 0.0
    p1 = params[1] if len(params) > 1 else 0.0
    out = np.empty((b, num_steps), dtype=np.float64)
    lib = load_native()
    if lib is not None:
        lib.euler_maruyama_1d(
            DRIFT_TYPES[drift], p0, p1, sqrt_q, _as_ptr(x0), b, num_steps, dt,
            np.uint64(seed), _as_ptr(out),
        )
        return out
    rng = np.random.default_rng(seed)
    fns = {
        "ou": lambda x: -p0 * x,
        "dw": lambda x: p0 * x * (p1 - x**2),
        "benes": lambda x: p0 * np.tanh(x),
        "sine": lambda x: np.sin(x - p0),
        "sqrt": lambda x: np.sqrt(p0 * np.abs(x)),
    }
    f = fns[drift]
    x = x0.copy()
    out[:, 0] = x
    sdt = np.sqrt(dt) * sqrt_q
    for k in range(1, num_steps):
        x = x + f(x) * dt + sdt * rng.standard_normal(b)
        out[:, k] = x
    return out
