"""The conversion engine (counterpart of ``spalinalg_tpu/convert/engine.py``).

One sort/segment pipeline serves every format change:

    lexsort by (major, minor)  ->  [duplicate merge]  ->  [zero drop]
                               ->  ptr from the sorted majors

- **Host path** (NumPy, :func:`compress_host`): exact output sizes, used
  by the constructors from the host builders (COO, DOK). It is the JAX
  package's NumPy path, so both packages build the same structure and the
  same values bit for bit.
- **Device path** (torch, on whatever device the tensors live):
  :func:`transpose_structure` re-keys a compressed structure by its minor
  axis with one stable ``torch.sort``; it gives CSR<->CSC, transpose, and
  the transposed structure that the SpMV backward runs on.
  :func:`compress_device` is the whole pipeline with static shapes
  (``nse`` kept, merged and dropped slots as sentinel padding), behind
  ``DeviceCoo.to_csr_device``.

Padding convention: a compressed structure may store ``nse`` slots past
its logical ``nnz = ptr[-1]``. Those slots exist in storage and contribute
nothing; per-entry major ids map them to the sentinel ``n_major``.

Reference-semantic switches (SURVEY.md §2.1 invariants):
- COO->CSR/CSC: ``dedup=True, drop_zeros=True`` (`csr/conv/coo.rs:37-74`)
- DOK->CSR/CSC: ``dedup=False, drop_zeros=False`` (`csr/conv/dok.rs:4-85`)
- CSR<->CSC / transpose: every stored entry kept (`csr/conv/csc.rs`)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..dtypes import INDEX_DTYPE

__all__ = [
    "compress_host",
    "compress_device",
    "ptr_from_major",
    "expand_ptr_host",
    "major_ids",
    "TransposeStructure",
    "transpose_structure",
    "transpose_compressed",
]


# ======================================================================
# Host path (exact sizes; NumPy)
# ======================================================================


def compress_host(
    major: np.ndarray,
    minor: np.ndarray,
    values: np.ndarray,
    n_major: int,
    *,
    dedup: bool,
    drop_zeros: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort triplets by (major, minor) and compress to (ptr, minor, values).

    Returns exact-size arrays: ``ptr`` (``n_major + 1``, int64 host), sorted
    ``minor`` and ``values``. With ``dedup`` duplicates are summed in
    sorted order (the reference's last-seen-pointer merge,
    `csr/conv/coo.rs:37-58`); with ``drop_zeros`` exact numeric zeros are
    removed (`csr/conv/coo.rs:61-74`).
    """
    major = np.asarray(major, dtype=np.int64)
    minor = np.asarray(minor, dtype=np.int64)
    values = np.asarray(values)

    order = np.lexsort((minor, major))
    major, minor, values = major[order], minor[order], values[order]

    if dedup and major.size:
        is_new = np.empty(major.size, dtype=bool)
        is_new[0] = True
        is_new[1:] = (major[1:] != major[:-1]) | (minor[1:] != minor[:-1])
        gid = np.cumsum(is_new) - 1
        summed = np.zeros(int(gid[-1]) + 1, dtype=values.dtype)
        np.add.at(summed, gid, values)
        major, minor, values = major[is_new], minor[is_new], summed

    if drop_zeros:
        keep = values != 0
        major, minor, values = major[keep], minor[keep], values[keep]

    ptr = np.zeros(n_major + 1, dtype=np.int64)
    np.add.at(ptr, major + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, minor, values


def expand_ptr_host(ptr: np.ndarray) -> np.ndarray:
    """Expand a compressed pointer into per-entry major ids (host)."""
    ptr = np.asarray(ptr, dtype=np.int64)
    return np.repeat(np.arange(ptr.size - 1, dtype=np.int64), np.diff(ptr))


# ======================================================================
# Device path (torch; any device)
# ======================================================================


def major_ids(ptr: torch.Tensor, nse: int) -> torch.Tensor:
    """Per-entry major ids (int32) of a compressed pointer array.

    Slots at or past ``ptr[-1]`` (padding) map to the sentinel
    ``n_major = ptr.numel() - 1``. One ``searchsorted`` over the slot
    positions, with no host synchronisation.
    """
    pos = torch.arange(nse, dtype=ptr.dtype, device=ptr.device)
    return (torch.searchsorted(ptr, pos, right=True) - 1).to(INDEX_DTYPE)


class TransposeStructure(NamedTuple):
    """A compressed structure re-keyed by its minor axis.

    ``ptr`` (``n_minor + 1``) and ``minor`` (``nse``, the old major ids)
    describe the transpose; ``perm`` says which old slot each new slot
    holds, so the transposed values are ``values[perm]``; ``major`` holds
    the per-entry major ids of the original structure (padding ->
    ``n_major``). All four are int32. Padding slots stay padding and sort
    last.
    """

    ptr: torch.Tensor
    minor: torch.Tensor
    perm: torch.Tensor
    major: torch.Tensor


def transpose_structure(ptr: torch.Tensor, minor: torch.Tensor, *,
                        n_major: int, n_minor: int) -> TransposeStructure:
    """Transpose a compressed structure with one stable sort.

    Entries are already ordered by (major, minor), so a stable sort on the
    minor index alone orders them by (minor, major). Replaces the
    reference's 2-pass counting sort (`csr.rs:358-406`).
    """
    nse = minor.numel()
    major = major_ids(ptr, nse)
    pad = major >= n_major
    key = torch.where(pad, n_minor, minor.to(INDEX_DTYPE))
    key_sorted, perm = torch.sort(key, stable=True)
    new_minor = torch.where(key_sorted >= n_minor, 0, major[perm])
    targets = torch.arange(n_minor + 1, dtype=INDEX_DTYPE, device=ptr.device)
    new_ptr = torch.searchsorted(key_sorted, targets).to(INDEX_DTYPE)
    return TransposeStructure(new_ptr, new_minor.to(INDEX_DTYPE),
                              perm.to(INDEX_DTYPE), major)


def ptr_from_major(major_sorted: torch.Tensor, n_major: int) -> torch.Tensor:
    """``ptr[i]`` = the number of entries with major < ``i``, over sorted
    majors (sentinel padding ``n_major`` at the end), int32; ``ptr[n_major]``
    is the true nnz."""
    targets = torch.arange(n_major + 1, dtype=major_sorted.dtype,
                           device=major_sorted.device)
    return torch.searchsorted(major_sorted, targets).to(INDEX_DTYPE)


def _sort_triplets(major, minor, values, n_minor: int):
    """Stable sort of triplets by (major, minor): one stable ``argsort`` of
    the int64 key ``major·(n_minor + 1) + minor``, which orders as the JAX
    package's one- or two-pass stable sort does. Sentinel padding
    (``major == n_major``) sorts to the end."""
    key = major.to(torch.int64) * (n_minor + 1) + minor.to(torch.int64)
    order = torch.argsort(key, stable=True)
    return major[order], minor[order], values[order]


def compress_device(major: torch.Tensor, minor: torch.Tensor,
                    values: torch.Tensor, *, n_major: int, n_minor: int,
                    dedup: bool, drop_zeros: bool):
    """Device-side compress (``spalinalg_tpu/convert/engine.py:174-235``):
    ``(ptr, minor, values)`` with static shapes, on the tensors' device.

    ``nse`` is kept: merged and dropped slots become sentinel padding
    (``major == n_major``, minor 0, value 0), exactly as the JAX arrays have
    them. ``ptr`` has ``n_major + 1`` entries and ``ptr[-1]`` is the true
    nnz. Plain torch: the JAX package has no Pallas kernel here.
    """
    nse = major.shape[0]
    if nse == 0:
        return (torch.zeros(n_major + 1, dtype=INDEX_DTYPE,
                            device=major.device), minor.to(INDEX_DTYPE),
                values)
    major = major.to(INDEX_DTYPE)
    minor = minor.to(INDEX_DTYPE)
    major, minor, values = _sort_triplets(major, minor, values, n_minor)
    if dedup:
        is_new = torch.ones(nse, dtype=torch.bool, device=major.device)
        is_new[1:] = (major[1:] != major[:-1]) | (minor[1:] != minor[:-1])
        # Padding slots share (n_major, minor) keys: they collapse into
        # groups of their own, which stay padding below.
        gid = torch.cumsum(is_new, 0) - 1
        summed = values.new_zeros(nse).index_add_(0, gid, values)
        rep_major = torch.full((nse,), n_major, dtype=INDEX_DTYPE,
                               device=major.device)
        rep_major[gid] = major
        rep_minor = torch.zeros(nse, dtype=INDEX_DTYPE, device=major.device)
        rep_minor[gid] = minor
        live = torch.arange(nse, device=major.device) <= gid[-1]
        major = torch.where(live, rep_major, n_major)
        minor = torch.where(live, rep_minor, 0)
        values = torch.where(live, summed, 0)
    if drop_zeros:
        drop = (values == 0) | (major >= n_major)
        major = torch.where(drop, n_major, major)
        minor = torch.where(drop, 0, minor)
        major, minor, values = _sort_triplets(major, minor, values, n_minor)
        values = torch.where(major >= n_major, 0, values)
    return ptr_from_major(major, n_major), minor, values


def transpose_compressed(ptr, minor, values, *, n_major: int, n_minor: int):
    """``(ptr, minor, values)`` of the transposed structure, on the same
    device. Every stored entry is kept, explicit zeros included."""
    t = transpose_structure(ptr, minor, n_major=n_major, n_minor=n_minor)
    return t.ptr, t.minor, values[t.perm]
