"""I/O tier: Matrix Market interop, npz checkpoint and resume, scipy and
``torch.sparse`` bridges, and carrying matrices across from the JAX
package."""

from .arrays import (bsr_from_arrays, csc_from_arrays, csr_from_arrays,
                     device_coo_from_arrays, dia_from_arrays, to_arrays)
from .checkpoint import load_npz, save_npz
from .matrix_market import read_matrix_market, write_matrix_market
from .scipy_interop import from_scipy, to_scipy
from .torch_interop import from_sparse_coo, to_sparse_coo, to_sparse_csr

__all__ = [
    "save_npz", "load_npz",
    "read_matrix_market", "write_matrix_market",
    "from_scipy", "to_scipy",
    "from_sparse_coo", "to_sparse_coo", "to_sparse_csr",
    "csr_from_arrays", "csc_from_arrays", "bsr_from_arrays",
    "dia_from_arrays", "device_coo_from_arrays", "to_arrays",
]
