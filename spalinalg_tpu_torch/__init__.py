"""spalinalg_tpu_torch — the PyTorch/CUDA port of spalinalg_tpu.

The same sparse formats and operations as ``spalinalg_tpu`` (the JAX
package, which stays the reference), on torch tensors, with the TPU's
Pallas kernels replaced by kernels written by hand for NVIDIA Hopper
(``csrc/``). The ported paths:

    CooMatrix / DokMatrix  ->  CsrMatrix.from_coo(coo)  ->  csr @ x
    coo.to_device()  ->  DeviceCoo.to_csr_device()  (COO -> CSR on the device)
    csr @ X, csc @ X (SpMM)    a * b, a @ b, a ** k (SpGEMM)    a + b, a - b, -a
    csr.to_bsr(bs) | BsrMatrix(...)  ->  bsr.astype(torch.bfloat16)  ->  bsr @ x, bsr @ X
    diags, kron, hstack, vstack, block_diag, bmat, tril, triu, sprandom  ->  CSR
    DiaMatrix.from_diagonals(...) | DiaMatrix.from_csr(csr)  ->  dia @ x, dia @ X

Builders live on the host; a compressed matrix lives on the device it was
built for. An entry point that places data and is given no ``device``
places it on the card (``cuda``), unless a ``with default_device(...):``
scope names another (``device.py``). The package imports torch and NumPy
and never JAX.
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
from .formats.bsr import BsrMatrix
from .formats.device import DeviceCoo
from .formats.dia import DiaMatrix
from .device import default_device
from .ops.matvec import csc_matmat, csc_matvec, csr_matmat, csr_matvec
from .ops.spgemm import SpgemmPlan, spgemm, spgemm_apply, spgemm_plan
from .ops.structure import bmat, block_diag, hstack, kron, tril, triu, vstack
from .ops.construct import diags, sprandom
from . import io
from . import utils

__version__ = "0.1.0"

__all__ = [
    "CooMatrix",
    "DokMatrix",
    "CsrMatrix",
    "CscMatrix",
    "BsrMatrix",
    "DeviceCoo",
    "DiaMatrix",
    "default_device",
    "kron", "hstack", "vstack", "block_diag", "bmat", "tril", "triu",
    "diags", "sprandom",
    "SpalinalgError",
    "ShapeError",
    "IndexError_",
    "StructureError",
    "DTypeError",
    "csr_matvec",
    "csr_matmat",
    "csc_matvec",
    "csc_matmat",
    "spgemm",
    "spgemm_plan",
    "spgemm_apply",
    "SpgemmPlan",
    "io",
    "utils",
    "__version__",
]
