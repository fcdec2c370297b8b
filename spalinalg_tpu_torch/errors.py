"""Validation errors for spalinalg_tpu_torch.

Counterpart of ``spalinalg_tpu/errors.py``: the same classes in the same
hierarchy, so code written against one package catches the other's errors
by the same names. The Rust reference panics on invalid input (e.g.
``assert!(nrows > 0)`` in `coo.rs:105-106`, the eight structural asserts in
`csr.rs:144-156`); here host-side validation raises these exceptions at
construction time, before any tensor reaches a device.
"""

from __future__ import annotations


class SpalinalgError(ValueError):
    """Base class for all spalinalg_tpu_torch validation errors."""


class ShapeError(SpalinalgError):
    """Invalid matrix shape (zero dims, mismatched operand shapes).

    Mirrors reference panics at `coo.rs:105-106`, `dok.rs:106-107`,
    `csr.rs:144-145`, `csc.rs:144-145` and the op shape asserts at
    `csr/ops/add.rs:9-10`, `csr/ops/mul.rs:8`.
    """


class IndexError_(SpalinalgError):
    """Entry index out of range.

    Mirrors reference panics on out-of-range triplets (`coo.rs:434-435`,
    `dok.rs:465-466`) and compressed-index range checks (`csr.rs:152-153`).
    """


class StructureError(SpalinalgError):
    """Malformed compressed structure.

    Mirrors the CSR/CSC constructor asserts (`csr.rs:144-164`,
    `csc.rs:144-164`): pointer length, ``ptr[0] == 0``, index/value length,
    pointer monotonicity, strictly-increasing indices within a row/column.
    Also raised when a structure has more entries than int32 indices can
    address.
    """


class DTypeError(SpalinalgError):
    """Unsupported scalar or index dtype (reference supports f32/f64 only,
    `scalar.rs:56-57`)."""
