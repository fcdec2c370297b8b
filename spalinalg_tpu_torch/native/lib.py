"""The native host library, built from the port's own C++ source.

``spalinalg_tpu_torch/native/src/host_kernels.cpp`` is plain C++ with a C
interface and no tie to any framework: the port's copy of the functions it
needs from the JAX package's ``host_kernels.cpp``, each copied with its
first caller. It is compiled with ``g++ -O3 -fPIC -std=c++17 -shared``,
without ``-march=native``, so the library runs on any x86-64 host. The
build happens at first use, into ``build/native/`` at the repository root,
named by a hash of the source and flags; nothing is written beside the
source. A failed build raises :class:`NativeBuildError`: callers that need
the library do not drop to NumPy.

Bound so far: ``spal_spgemm_symbolic``, the SpGEMM symbolic phase.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["NativeBuildError", "SOURCE", "library_path", "load_library",
           "spgemm_symbolic"]

SOURCE = Path(__file__).resolve().parent / "src" / "host_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


class NativeBuildError(RuntimeError):
    """The C++ compiler or the source is missing, or the build failed."""


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    if not SOURCE.is_file():
        raise NativeBuildError(f"native source {SOURCE} not found")
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libspal_host_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found on PATH; the native host "
                               "library is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Per-process temporary name: concurrent first uses do not collide.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ exited with {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the library if needed and load it (once per process)."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.spal_spgemm_symbolic.restype = ctypes.c_int64
    lib.spal_spgemm_symbolic.argtypes = [
        _I64, _I64, ctypes.c_int64, _I64, _I64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def spgemm_symbolic(aptr, acol, nrows_a, bptr, bcol, ncols_b):
    """The SpGEMM symbolic phase of ``A·B`` on CSR structures with exact
    nnz: ``(a_idx, b_idx, gid, out_rowptr, out_colind)``, int64.

    Two calls, as the C function asks: the first counts the product terms,
    the second fills the arrays allocated for them and returns the output
    nnz.
    """
    lib = load_library()
    aptr = np.ascontiguousarray(aptr, dtype=np.int64)
    acol = np.ascontiguousarray(acol, dtype=np.int64)
    bptr = np.ascontiguousarray(bptr, dtype=np.int64)
    bcol = np.ascontiguousarray(bcol, dtype=np.int64)
    if (aptr.size != nrows_a + 1 or acol.size != aptr[-1]
            or bptr.size < 1 or bcol.size != bptr[-1]
            or (acol.size and (acol.min() < 0 or acol.max() >= bptr.size - 1))):
        raise ValueError("spgemm_symbolic: inconsistent CSR structures")
    total = lib.spal_spgemm_symbolic(aptr, acol, nrows_a, bptr, bcol,
                                     ncols_b, None, None, None, None, None)
    a_idx = np.empty(max(total, 1), dtype=np.int64)
    b_idx = np.empty(max(total, 1), dtype=np.int64)
    gid = np.empty(max(total, 1), dtype=np.int64)
    out_rowptr = np.zeros(nrows_a + 1, dtype=np.int64)
    out_colind = np.empty(max(total, 1), dtype=np.int64)
    pv = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    n_out = lib.spal_spgemm_symbolic(
        aptr, acol, nrows_a, bptr, bcol, ncols_b,
        pv(a_idx), pv(b_idx), pv(gid), pv(out_rowptr), pv(out_colind))
    return (a_idx[:total], b_idx[:total], gid[:total], out_rowptr,
            out_colind[:n_out].copy())
