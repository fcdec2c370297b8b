"""Build and load the port's CUDA kernels from ``spalinalg_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``. No PyTorch headers are
included, so a build takes seconds. The library goes under
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so an edited ``.cu`` rebuilds. Nothing here runs at import: a
CPU-only process never calls ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KernelBuildError", "find_nvcc", "library_path", "load_library"]

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_SPMV_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p]


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the sources."""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "are built from spalinalg_tpu_torch/csrc at first use")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspal_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    # Per-process temporary name: concurrent first uses do not collide.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc exited with {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and load them (once per process)."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name in ("spal_csr_spmv_f32", "spal_csr_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _SPMV_ARGTYPES
        fn.restype = ctypes.c_int
    lib.spal_error_string.argtypes = [ctypes.c_int]
    lib.spal_error_string.restype = ctypes.c_char_p
    return lib
