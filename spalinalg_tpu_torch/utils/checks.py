"""Structure checks before a kernel runs, and a determinism audit
(counterpart of ``spalinalg_tpu/utils/checks.py``).

The JAX package wraps compute in ``jax.experimental.checkify``, so an
out-of-range index inside compiled code surfaces as an error instead of a
silent clamp. On the card there is no such afterwards: a bad index that
reaches a kernel is an illegal address, which kills the CUDA context and
cannot be caught. So the port checks first. :func:`checked_structure`
runs the JAX package's five checks on the structure's device and reads
their results back once; :func:`checked_call` runs them on every CSR, CSC
and BSR argument and calls the function only if all pass.

Examples
--------
>>> from spalinalg_tpu_torch import CsrMatrix
>>> m = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0], device="cpu")
>>> checked_structure(m)().get() is None
True
>>> bad = CsrMatrix._from_parts(2, 2, m.rowptr, m.colind + 1, m.values)
>>> err, out = checked_call(lambda a: a.nnz, bad)
>>> err.get(), out
('minor index out of range', None)
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..errors import StructureError

__all__ = ["StructureCheckError", "checked_structure", "checked_call",
           "determinism_audit"]

# The JAX package's checks, in its order; the first that fails names the
# error.
_MESSAGES = ("ptr must be monotone non-decreasing", "ptr[0] must be 0",
             "nnz exceeds stored-element capacity",
             "minor index out of range", "ptr length mismatch")


class StructureCheckError:
    """The outcome of a structure check: :meth:`get` is ``None`` when the
    structure is sound, else the first failed check's message, which
    :meth:`throw` raises as a ``StructureError``."""

    def __init__(self, message: Optional[str] = None):
        self._message = message

    def get(self) -> Optional[str]:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise StructureError(self._message)

    def __repr__(self) -> str:
        return f"StructureCheckError({self._message!r})"


def _parts(mat):
    """``(ptr, minor, n_major, n_minor)`` of a CSR, CSC or BSR matrix, or
    None for anything else."""
    from ..formats.bsr import BsrMatrix
    from ..formats.compressed import _CompressedMatrix

    if isinstance(mat, _CompressedMatrix):
        cls = type(mat)
        return (mat._ptr, mat._minor, cls._major_dim(mat.nrows, mat.ncols),
                cls._minor_dim(mat.nrows, mat.ncols))
    if isinstance(mat, BsrMatrix):
        br, bc = mat.blocksize
        return mat.indptr, mat.indices, mat.nrows // br, mat.ncols // bc
    return None


def _check(ptr: torch.Tensor, minor: torch.Tensor, n_major: int,
           n_minor: int) -> StructureCheckError:
    if ptr.ndim != 1 or ptr.numel() == 0:
        return StructureCheckError("ptr length mismatch")
    last = ptr[-1]
    live = torch.arange(minor.numel(), device=minor.device) < last
    in_range = (minor >= 0) & (minor < n_minor)
    ok = torch.stack([
        (torch.diff(ptr) >= 0).all(),
        ptr[0] == 0,
        last <= minor.numel(),
        (in_range | ~live).all(),
    ]).cpu().numpy()                            # the one read back
    ok = np.append(ok, ptr.numel() == n_major + 1)
    bad = np.flatnonzero(~ok)
    return StructureCheckError(_MESSAGES[bad[0]] if bad.size else None)


def checked_structure(mat) -> Callable[[], StructureCheckError]:
    """A callable that validates ``mat``'s structure on its device: ``ptr``
    monotone, ``ptr[0] == 0``, ``ptr[-1]`` within the stored-element
    capacity, minor indices in range on the live slots, and the length of
    ``ptr``. Usage::

        err = checked_structure(csr)()
        err.throw()   # raises StructureError if the structure is corrupt
    """
    parts = _parts(mat)
    if parts is None:
        raise TypeError(f"no structure to check on {type(mat).__name__}")
    return lambda: _check(*parts)


def checked_call(fn, *args):
    """Validate every CSR, CSC and BSR argument, then run ``fn(*args)``:
    ``(err, out)``. Where a check fails, ``fn`` does not run (``out`` is
    ``None``): on the card, a bad index would kill the CUDA context."""
    for a in args:
        parts = _parts(a)
        if parts is not None:
            err = _check(*parts)
            if err.get() is not None:
                return err, None
    return StructureCheckError(), fn(*args)


def _host(out):
    if isinstance(out, torch.Tensor):
        return out.detach().cpu()
    return np.asarray(out)


def determinism_audit(fn, *args, repeats: int = 3) -> bool:
    """Re-run ``fn(*args)`` and check that every result is bitwise the
    first (the contract the port's sorted reductions keep)."""
    first = _host(fn(*args))
    for _ in range(repeats - 1):
        again = _host(fn(*args))
        same = (torch.equal(again, first) if isinstance(first, torch.Tensor)
                else np.array_equal(again, first))
        if not same:
            return False
    return True
