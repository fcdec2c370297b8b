"""The native host library, built from the port's own C++ source.

``spalinalg_tpu_torch/native/src/host_kernels.cpp`` is plain C++ with a C
interface and no tie to any framework: the port's copy of the functions it
needs from the JAX package's ``host_kernels.cpp``, each copied with its
first caller. It is compiled with the JAX package's flags, ``g++ -O3
-march=native -fPIC -std=c++17 -shared``: the same source, flags and
compiler give the same bits in both packages on every host. (A build
with ``-mfma`` in place of ``-march=native`` does not: on a host with
AVX-512 its IC(0) sweep differed from the JAX library's in the last bit.)
The build
happens at first use, into ``build/native/`` at the repository root, named
by a hash of the source, the flags and the host's resolved native target
(``g++ -march=native -Q --help=target``), so a ``build/`` directory
carried to another CPU rebuilds instead of running instructions that host
lacks; nothing is written beside the source. A failed build raises
:class:`NativeBuildError`: callers that need the library do not drop to
NumPy.

Bound: ``spal_compress`` (COO -> compressed sort and merge);
``spal_spgemm_symbolic`` (the SpGEMM symbolic phase); ``spal_rcm``,
``spal_level_schedule``, ``spal_etree``, ``spal_chol_symbolic`` and
``spal_amd`` (orderings and the Cholesky symbolic phase); ``spal_ilu0`` and
``spal_ic0`` (the incomplete factorizations' numeric sweeps).
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
           "compress", "spgemm_symbolic", "rcm", "level_schedule", "etree",
           "chol_symbolic", "amd", "ilu0_values", "ic0_values"]

SOURCE = Path(__file__).resolve().parent / "src" / "host_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# The JAX package's flags (spalinalg_tpu/native/lib.py): the same code
# generation, hence the same bits, on every host.
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


class NativeBuildError(RuntimeError):
    """The C++ compiler or the source is missing, or the build failed."""


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found on PATH; the native host "
                               "library is built at first use")
    return cxx


@functools.cache
def native_target() -> str:
    """What ``-march=native`` resolves to on this host: g++'s list of the
    target options it enables (the CPU model and its instruction sets)."""
    proc = subprocess.run([_compiler(), "-march=native", "-Q",
                           "--help=target"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ -march=native -Q --help=target exited "
                               f"with {proc.returncode}: {proc.stderr}")
    return proc.stdout


def library_path() -> Path:
    """Where the library for the current source, flags and host target
    lives."""
    if not SOURCE.is_file():
        raise NativeBuildError(f"native source {SOURCE} not found")
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(native_target().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libspal_host_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = _compiler()
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
    lib.spal_compress.restype = ctypes.c_int64
    lib.spal_compress.argtypes = [
        _I64, _I64, _F64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, _I64, _I64, _F64,
    ]
    lib.spal_spgemm_symbolic.restype = ctypes.c_int64
    lib.spal_spgemm_symbolic.argtypes = [
        _I64, _I64, ctypes.c_int64, _I64, _I64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    for name in ("spal_rcm", "spal_etree", "spal_amd"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [_I64, _I64, ctypes.c_int64, _I64]
    lib.spal_level_schedule.restype = ctypes.c_int64
    lib.spal_level_schedule.argtypes = [_I64, _I64, ctypes.c_int64,
                                        ctypes.c_int32, _I64]
    lib.spal_chol_symbolic.restype = ctypes.c_int64
    lib.spal_chol_symbolic.argtypes = [
        _I64, _I64, ctypes.c_int64, _I64, _I64, _I64, _I64, ctypes.c_void_p]
    for name in ("spal_ilu0", "spal_ic0"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [_I64, _I64, _F64, ctypes.c_int64]
    return lib


def compress(major, minor, values, n_major, *, dedup, drop_zeros):
    """COO triplets in float64 -> ``(ptr, minor, values)``: a stable sort by
    (major, minor), duplicates summed left to right in that order when
    ``dedup``, exact zeros dropped when ``drop_zeros``. ``ptr`` has
    ``n_major + 1`` int64 entries; ``minor`` and ``values`` are exact-size
    copies."""
    lib = load_library()
    major = np.ascontiguousarray(major, dtype=np.int64)
    minor = np.ascontiguousarray(minor, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    nnz = major.size
    if minor.size != nnz or values.size != nnz:
        raise ValueError("compress: triplet arrays differ in length")
    if nnz and (major.min() < 0 or major.max() >= n_major):
        raise ValueError(f"compress: major index out of [0, {n_major})")
    ptr = np.zeros(n_major + 1, dtype=np.int64)
    out_minor = np.empty(max(nnz, 1), dtype=np.int64)
    out_values = np.empty(max(nnz, 1), dtype=np.float64)
    w = lib.spal_compress(major, minor, values, nnz, n_major, int(dedup),
                          int(drop_zeros), ptr, out_minor, out_values)
    return ptr, out_minor[:w].copy(), out_values[:w].copy()


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


def _structure(ptr, ind, n):
    """``ptr``/``ind`` as contiguous int64 arrays, checked against ``n``:
    the C functions index with them unchecked."""
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ind = np.ascontiguousarray(ind, dtype=np.int64)
    if (ptr.size != n + 1 or ind.size < ptr[-1] or np.any(np.diff(ptr) < 0)
            or (ptr[-1] and (ind[:ptr[-1]].min() < 0
                             or ind[:ptr[-1]].max() >= n))):
        raise ValueError("inconsistent CSR structure")
    return ptr, ind


def rcm(ptr, ind, n):
    """Reverse Cuthill-McKee permutation of a structurally symmetric
    structure."""
    lib = load_library()
    ptr, ind = _structure(ptr, ind, n)
    perm = np.empty(n, dtype=np.int64)
    lib.spal_rcm(ptr, ind, n, perm)
    return perm


def level_schedule(ptr, ind, n, *, lower):
    """``(n_levels, level of each row)`` of a triangular solve."""
    lib = load_library()
    ptr, ind = _structure(ptr, ind, n)
    lev = np.zeros(n, dtype=np.int64)
    n_levels = lib.spal_level_schedule(ptr, ind, n, int(lower), lev)
    return int(n_levels), lev


def etree(ptr, ind, n):
    """Elimination tree (``parent[j] = -1`` for roots)."""
    lib = load_library()
    ptr, ind = _structure(ptr, ind, n)
    parent = np.empty(n, dtype=np.int64)
    lib.spal_etree(ptr, ind, n, parent)
    return parent


def chol_symbolic(ptr, ind, n):
    """Supernodal symbolic phase on a POSTORDERED symmetric structure:
    ``(parent, snode_ptr, rows_ptr, rows_idx)``. Two calls, as the C
    function asks: the first sizes ``rows_idx``, the second fills it."""
    lib = load_library()
    ptr, ind = _structure(ptr, ind, n)
    parent = np.empty(max(n, 1), dtype=np.int64)
    nsn_out = np.zeros(1, dtype=np.int64)
    snode_ptr = np.zeros(n + 1, dtype=np.int64)
    rows_ptr = np.zeros(n + 1, dtype=np.int64)
    total = lib.spal_chol_symbolic(ptr, ind, n, parent, nsn_out, snode_ptr,
                                   rows_ptr, None)
    rows_idx = np.empty(max(total, 1), dtype=np.int64)
    lib.spal_chol_symbolic(ptr, ind, n, parent, nsn_out, snode_ptr,
                           rows_ptr, rows_idx.ctypes.data_as(ctypes.c_void_p))
    nsn = int(nsn_out[0])
    return (parent[:n], snode_ptr[: nsn + 1].copy(),
            rows_ptr[: nsn + 1].copy(), rows_idx[:total])


def amd(ptr, ind, n):
    """Approximate-minimum-degree permutation (``perm[k]`` = k-th pivot)."""
    lib = load_library()
    ptr, ind = _structure(ptr, ind, n)
    perm = np.empty(n, dtype=np.int64)
    lib.spal_amd(ptr, ind, n, perm)
    return perm


def ilu0_values(ptr, ind, values, n):
    """ILU(0) numeric sweep in float64 on a copy of ``values``:
    ``(values, bad_row)``, ``bad_row`` -1 on success, else the row of the
    first zero pivot or missing diagonal."""
    lib = load_library()
    ptr, ind = _structure(ptr, ind, n)
    values = np.array(values, dtype=np.float64, copy=True, order="C")
    if values.size < ptr[-1]:
        raise ValueError("fewer values than entries")
    bad = int(lib.spal_ilu0(ptr, ind, values, int(n)))
    return values, bad


def ic0_values(lptr, lind, lvalues, n):
    """IC(0) numeric sweep in float64 on a copy of the lower pattern's
    values (the diagonal last in each row): ``(values, bad_row)``."""
    lib = load_library()
    lptr, lind = _structure(lptr, lind, n)
    lvalues = np.array(lvalues, dtype=np.float64, copy=True, order="C")
    if lvalues.size < lptr[-1]:
        raise ValueError("fewer values than entries")
    bad = int(lib.spal_ic0(lptr, lind, lvalues, int(n)))
    return lvalues, bad
