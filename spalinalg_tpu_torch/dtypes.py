"""Scalar tier: supported dtypes and promotion rules.

Counterpart of ``spalinalg_tpu/dtypes.py`` (the reference's ``Scalar``
trait family, `scalar.rs:8-57`), expressed in torch dtypes:

- value dtypes: ``torch.float32``, ``torch.float64`` and ``torch.bfloat16``;
- index dtype: ``torch.int32`` on every device. A structure with more
  than ``2**31 - 1`` stored entries cannot be addressed and raises.

The host builders (COO, DOK) keep NumPy buffers, which have no bfloat16,
so they hold float32 or float64 (:func:`numpy_dtype`).
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import DTypeError, StructureError

VALUE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)

INDEX_DTYPE = torch.int32

# Largest entry count an int32 index or pointer can address.
MAX_NSE = 2**31 - 1

_BY_NAME = {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}
_NUMPY = {torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64)}


def _name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:  # "bfloat16" without a NumPy extension type
        return str(dtype)


def canonical_value_dtype(dtype) -> torch.dtype:
    """Validate a value dtype given as a torch dtype, NumPy dtype or name.

    Raises :class:`DTypeError` for anything outside the supported scalar
    set, mirroring the closed ``Scalar`` trait in `scalar.rs:55-57`.

    >>> canonical_value_dtype("float64")
    torch.float64
    """
    d = _BY_NAME.get(_name(dtype))
    if d is None:
        raise DTypeError(
            f"unsupported value dtype {_name(dtype)!r}: spalinalg_tpu_torch "
            "supports float32, float64 and bfloat16 (reference scalar set "
            "is f32/f64)"
        )
    return d


def numpy_dtype(dtype) -> np.dtype:
    """Host (NumPy) dtype of a value dtype; bfloat16 has none."""
    d = canonical_value_dtype(dtype)
    if d not in _NUMPY:
        raise DTypeError(
            f"{d} has no NumPy dtype: host builders and host arrays hold "
            "float32 or float64")
    return _NUMPY[d]


def result_dtype(*dtypes) -> torch.dtype:
    """Promotion rule for mixed-dtype ops: torch promotion within the
    supported set."""
    out = canonical_value_dtype(dtypes[0])
    for d in dtypes[1:]:
        out = torch.promote_types(out, canonical_value_dtype(d))
    return canonical_value_dtype(out)


def acc_dtype(values_dtype, x_dtype) -> torch.dtype:
    """Accumulation dtype of a product: the promoted type, except that
    bfloat16 accumulates in float32 (``spalinalg_tpu/ops/matvec.py``)."""
    d = result_dtype(values_dtype, x_dtype)
    return torch.float32 if d == torch.bfloat16 else d


def check_nse(nse: int) -> None:
    """Raise if ``nse`` stored entries exceed int32 addressing."""
    if nse > MAX_NSE:
        raise StructureError(
            f"{nse} stored entries exceed the int32 index range "
            f"({MAX_NSE})")
