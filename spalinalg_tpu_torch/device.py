"""Where the port places data when the caller names no device.

Every public entry point that places data takes ``device=None`` and
resolves it here, in this order:

1. an explicit ``device`` wins;
2. otherwise the device of the innermost ``with default_device(...):``
   scope (the counterpart of ``jax.default_device``);
3. otherwise ``torch.device("cuda")``: the card.

There is no check of ``torch.cuda.is_available()`` that drops to the CPU:
on a machine without a card, an unscoped call that names no device fails
where torch first places a tensor on ``cuda``.

>>> resolve_device("cuda:0")
device(type='cuda', index=0)
>>> with default_device("cpu"):
...     resolve_device(None)
device(type='cpu')
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Union

import torch

__all__ = ["default_device", "resolve_device"]

DeviceLike = Union[str, torch.device, int]

_SCOPED: contextvars.ContextVar[Optional[torch.device]] = \
    contextvars.ContextVar("spalinalg_tpu_torch_default_device", default=None)


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point places data on (module docstring)."""
    if device is not None:
        return torch.device(device)
    scoped = _SCOPED.get()
    return scoped if scoped is not None else torch.device("cuda")


@contextlib.contextmanager
def default_device(device: DeviceLike) -> Iterator[torch.device]:
    """Within the block, entry points that name no device place data on
    ``device``; scopes nest, and the innermost one wins."""
    dev = torch.device(device)
    token = _SCOPED.set(dev)
    try:
        yield dev
    finally:
        _SCOPED.reset(token)
