"""Segment sums (counterpart of ``spalinalg_tpu/ops/reduction.py``).

The JAX package builds a scatter-free gather plan because scatters
serialise on the TPU; a GPU adds into a segment's slot directly, so the
port keeps only the function: ``out[g] = sum(stream[i] for seg[i] == g)``.
Its caller is the level-scheduled triangular solve
(``linalg/triangular.py``).

>>> import torch
>>> segment_sum(torch.tensor([1.0, 2.0, 3.0, 4.0]),
...             torch.tensor([0, 0, 2, 2]), 3).tolist()
[3.0, 0.0, 7.0]
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum"]


def segment_sum(stream: torch.Tensor, seg: torch.Tensor,
                n_groups: int) -> torch.Tensor:
    """Per-group sums of ``stream`` (groups named by ``seg``, int64, on the
    stream's device), ``n_groups`` of them; an empty group sums to 0. On
    a CUDA tensor the adds of one group go through atomics, so their order,
    and the last bits of the sum, may differ between runs."""
    out = torch.zeros((n_groups,) + tuple(stream.shape[1:]),
                      dtype=stream.dtype, device=stream.device)
    return out.index_add_(0, seg, stream)
