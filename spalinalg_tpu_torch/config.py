"""Frozen configuration (counterpart of ``spalinalg_tpu/config.py``).

A small, explicit config: the value dtype of new matrices, the parity
tolerances, and the name of the partition axis of the meshes that
:mod:`spalinalg_tpu_torch.parallel` builds. It is a frozen (hashable)
dataclass, read where it is needed and never from the environment.

Only ``partition_axis`` has a reader
(:func:`~spalinalg_tpu_torch.parallel.make_row_mesh`). ``default_dtype``,
``rtol_f32`` and ``rtol_f64`` are kept for parity with the JAX package's
``Config``, where nothing reads them either: nothing in the port reads
them, so setting them changes no result.

The JAX package's TPU knobs (``use_pallas``, ``bsr_stream_group``,
``max_bucket_width``, ``min_bucket_width``) have no counterpart: every
CUDA operand goes to its kernel, and the port has no Pallas, no stream
group and no ELL buckets. Passing one of them is a ``TypeError``.

Examples
--------
>>> from spalinalg_tpu_torch.config import Config, current_config, use
>>> current_config().partition_axis
'rows'
>>> with use(Config(partition_axis="shards")):
...     print(current_config().partition_axis)
shards
>>> Config(use_pallas=False)
Traceback (most recent call last):
...
TypeError: Config.__init__() got an unexpected keyword argument 'use_pallas'
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np

__all__ = ["Config", "default_config", "current_config", "use"]


@dataclass(frozen=True)
class Config:
    """Static knobs for dtypes, tolerances and distribution."""

    # Value dtype for newly created matrices when unspecified.
    default_dtype: str = "float64"
    # Numerical tolerance for parity checks against the CPU oracle.
    rtol_f32: float = 1e-5
    rtol_f64: float = 1e-12
    # Distribution: the axis name of meshes built by
    # spalinalg_tpu_torch.parallel.make_row_mesh.
    partition_axis: str = "rows"

    def with_(self, **kw) -> "Config":
        return replace(self, **kw)

    @property
    def np_default_dtype(self):
        return np.dtype(self.default_dtype)


_DEFAULT = Config()
_STACK = [_DEFAULT]


def default_config() -> Config:
    return _DEFAULT


def current_config() -> Config:
    """The active config (the innermost :func:`use` scope wins)."""
    return _STACK[-1]


@contextmanager
def use(cfg: Config):
    """Scope a config: ``with use(cfg.with_(partition_axis="x")): ...``"""
    _STACK.append(cfg)
    try:
        yield cfg
    finally:
        _STACK.pop()
