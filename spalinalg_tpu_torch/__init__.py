"""spalinalg_tpu_torch — the PyTorch/CUDA port of spalinalg_tpu.

The same sparse formats and operations as ``spalinalg_tpu`` (the JAX
package, which stays the reference), on torch tensors, with the TPU's
Pallas kernels replaced by kernels written by hand for NVIDIA Hopper
(``csrc/``). This slice holds the main path:

    CooMatrix / DokMatrix  ->  CsrMatrix.from_coo(coo, device=...)  ->  csr @ x

Builders live on the host; a compressed matrix lives on the device it was
built for. The package imports torch and NumPy and never JAX.
"""

from __future__ import annotations

from .errors import (
    DTypeError,
    IndexError_,
    ShapeError,
    SpalinalgError,
    StructureError,
)
from .formats.coo import CooMatrix
from .formats.dok import DokMatrix
from .formats.compressed import CscMatrix, CsrMatrix
from .ops.matvec import csc_matvec, csr_matvec
from . import io
from . import utils

__version__ = "0.1.0"

__all__ = [
    "CooMatrix",
    "DokMatrix",
    "CsrMatrix",
    "CscMatrix",
    "SpalinalgError",
    "ShapeError",
    "IndexError_",
    "StructureError",
    "DTypeError",
    "csr_matvec",
    "csc_matvec",
    "io",
    "utils",
    "__version__",
]
