"""Build and load the port's CUDA kernels from ``spalinalg_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc``, one process per
``.cu`` file, all started together, and linked into one shared library with
a plain C interface, loaded with ``ctypes``. No PyTorch headers are
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

from ...utils.profiling import annotate

__all__ = ["KernelBuildError", "find_nvcc", "launch", "library_path",
           "load_library"]

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_ENTRIES = {
    # (rowptr, colind, values, perm, x, y, nrows, lanes, variant, plan,
    #  nwin, npieces, nlong, partial, stream)
    **{f"spal_csr_spmv_{t}": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, _P]
       + [ctypes.c_longlong] * 3 + [_P, _P] for t in ("f32", "f64")},
    # (rowptr, colind, values, perm, X, Y, nrows, k, variant, plan, ntiles,
    #  max_window, pieces, npieces, nlong, budget, partial, stream)
    **{f"spal_csr_spmm_{t}": [_P] * 6 + [ctypes.c_longlong] * 2
       + [ctypes.c_int, _P] + [ctypes.c_longlong] * 2 + [_P]
       + [ctypes.c_longlong] * 3 + [_P, _P] for t in ("f32", "f64")},
    # (major, rowptr, colind, G, X, out, nse, nrows, k, variant, plan, n_a,
    #  n_b, n_c, stream)
    **{f"spal_csr_sddmm_{t}": [_P] * 6 + [ctypes.c_longlong] * 3
       + [ctypes.c_int, _P] + [ctypes.c_longlong] * 3 + [_P]
       for t in ("f32", "f64")},
    # (tptr, a_idx, b_idx, a, b, out, n_out, stream)
    **{f"spal_spgemm_terms_{t}": [_P] * 6 + [ctypes.c_longlong, _P]
       for t in ("f32", "f64")},
    # (indptr, indices, data, x, y, nbr, br, bc, nblocks, variant, stream)
    **{f"spal_bsr_spmv_{t}": [_P] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, _P]
       for t in ("f32", "bf16", "f64")},
    # (indptr, indices, data, X, Y, nbr, br, bc, nblocks, k, variant, stream)
    **{f"spal_bsr_spmm_{t}": [_P] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int] + [ctypes.c_longlong] * 2
       + [ctypes.c_int, _P] for t in ("f32", "bf16", "f64")},
    # (values, lpos, run_ptr, run_start, run_goff, vb, nse, nslab, g, major,
    #  nrows, stream)
    **{f"spal_bucket_scatter_{t}": [_P] * 6 + [ctypes.c_longlong] * 2
       + [_P, _P, ctypes.c_longlong, _P] for t in ("f32", "f64")},
    # (offsets, ndiag, data, x, y, nrows, ncols, transposed, stream)
    **{f"spal_dia_spmv_{t}": [_P, ctypes.c_int] + [_P] * 3
       + [ctypes.c_longlong] * 2 + [ctypes.c_int, _P] for t in ("f32", "f64")},
    # (xt, idx, val, out, S, N, K, L, stream)
    "spal_wide_gather_f32": [_P] * 4 + [ctypes.c_longlong] * 4 + [_P],
    # (ptr, idx, values, out, nrows_out, row0, col_shift, b, invert, vec,
    #  stream)
    **{f"spal_diagonal_{t}": [_P] * 4 + [ctypes.c_longlong] * 6 + [_P]
       for t in ("f32", "bf16", "f64")},
    # (p, ap, partial, partial_len, ticket, out, n, vec, stream) and
    # (r, inv, partial, partial_len, ticket, out, n, vec, stream)
    **{f"spal_cg_{name}_{t}": [_P] * 3 + [ctypes.c_longlong, _P, _P]
       + [ctypes.c_longlong] * 2 + [_P]
       for name in ("pap", "dots") for t in ("f32", "f64")},
    # (r, ap, inv, rz, pap, partial, partial_len, ticket, out, n, vec,
    #  stream)
    **{f"spal_cg_update_{t}": [_P] * 6 + [ctypes.c_longlong, _P, _P]
       + [ctypes.c_longlong] * 2 + [_P] for t in ("f32", "f64")},
    # (x, x_out, r, p, inv, rz, pap, rz_next, n, vec, stream)
    **{f"spal_cg_direction_{t}": [_P] * 8 + [ctypes.c_longlong] * 2 + [_P]
       for t in ("f32", "f64")},
}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the sources."""


def _sources():
    return sorted(CSRC.glob("*.cu"))


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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspal_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands at once; raise if any of them fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        output = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} exited with {proc.returncode}:"
                          f"\n{output}")
    if failed:
        raise KernelBuildError("\n".join(failed))


def _build(out: Path) -> None:
    # Per-process temporary names: concurrent first uses do not collide.
    stem = f"{out.name}.{os.getpid()}"
    objs = [out.with_name(f"{stem}.{src.stem}.o") for src in _sources()]
    tmp = out.with_name(f"{stem}.tmp")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for obj, src in zip(objs, _sources())])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and load them (once per process)."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.spal_error_string.argtypes = [ctypes.c_int]
    lib.spal_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call the C entry point ``name`` (building and loading the library
    if needed); raise if it reports a CUDA error. Every kernel of the port
    launches here, inside the span ``spal.launch``."""
    with annotate("spal.launch"):
        lib = load_library()
        code = getattr(lib, name)(*args)
    if code != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.spal_error_string(code).decode()} "
            f"(cudaError {code})")
