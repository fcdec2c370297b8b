"""I/O tier: carrying matrices across from the JAX package."""

from .arrays import csc_from_arrays, csr_from_arrays, to_arrays

__all__ = ["csr_from_arrays", "csc_from_arrays", "to_arrays"]
