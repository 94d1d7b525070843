"""Build and load the port's CUDA kernels (``csrc/*.cu``, sharing ``csrc/*.cuh``).

The sources are compiled at first use with ``nvcc``, one process per
source started together, and linked into a shared library with a plain C
interface, loaded with :mod:`ctypes`.  The library lands in ``build/cuda/``
at the repository root, under a file name that carries a hash of the
sources and flags, so an edited source rebuilds; ptxas's register report
(``-Xptxas -v``) is kept beside it.  ``nvcc`` is taken from ``PATH``, else
from ``$CUDA_HOME/bin``, else from the CUDA toolkit that PyTorch detected;
without one the build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_seconds", "ptxas_report", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_int = ctypes.c_int
#: argtypes of every launcher in csrc/*.cu; each returns a cudaError_t
_SIGNATURES = {
    "vidp_riccati_f64": [_vp, _vp, _vp, _vp, _int, _int, _vp],
    "vidp_riccati_f32": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
    "vidp_riccati_f32_shape": [_int, _int, _int, _vp],
    "vidp_scan_shape": [_int, _int, _int, _vp],
    "vidp_linrec_f64": [_vp] * 5 + [_int, _int, _int, _vp],
    "vidp_linrec_f32": [_vp] * 5 + [_int, _int, _int, _vp],
    "vidp_dist_q_1d_f32": [_vp] * 9 + [_int, _int, _vp],
    "vidp_dist_q_1d_f64": [_vp] * 9 + [_int, _int, _vp],
}

#: wall seconds of the last compile in this process (0.0 when cached)
_last_build_seconds = [0.0]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or PyTorch's CUDA_HOME: "
        "the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvidp_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands side by side; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library."""
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _find_nvcc()
        tag = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
        t0 = time.perf_counter()
        outs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                     for src, o in zip(_sources(), objs)])
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        for o in objs:
            o.unlink()
        so.with_suffix(".ptxas.txt").write_text("".join(outs))
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
        _last_build_seconds[0] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Seconds the last compile in this process took (0.0 if it was cached)."""
    return _last_build_seconds[0]


def ptxas_report() -> str:
    """ptxas's per-kernel register and shared-memory lines of the last build."""
    path = _library_path().with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""
