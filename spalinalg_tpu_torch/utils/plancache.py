"""One structure-keyed plan cache (counterpart of
``spalinalg_tpu/utils/plancache.py``).

Plans (transpose structures, CSC mirrors) are built once per structure and
reused across calls. The contract:

- the key is built here, from the ``id()`` **and** the shape of every
  keying tensor, plus the caller's extra fields (matrix dimensions). Two
  matrices that share one array but differ in shape never alias: the JAX
  package's DIA plane cache keyed on identity alone and did (ROADMAP
  queue C);
- an entry lives exactly as long as its keying tensors: the cache holds
  them only weakly, and drops the entry when the first of them is
  collected, before its ``id`` can be reused. A structure that is
  dropped takes its plan's device memory with it;
- structure tensors are treated as immutable: writing into one in place
  after its plan was built leaves the plan stale.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Hashable, Sequence

__all__ = ["StructureCache"]


class StructureCache:
    """Maps a live structure to its built plan.

    >>> import torch
    >>> cache = StructureCache()
    >>> a = torch.arange(3)
    >>> built = []
    >>> def build():
    ...     built.append(1)
    ...     return "plan"
    >>> cache.get((a,), build)
    'plan'
    >>> cache.get((a,), build)   # hit: builder not re-run
    'plan'
    >>> cache.get((a[:2],), build)   # another tensor: a new entry
    'plan'
    >>> len(built), len(cache)
    (2, 1)
    >>> del a                        # the structure goes, its plan with it
    >>> len(cache)
    0
    """

    def __init__(self):
        self._data: dict = {}

    def __len__(self) -> int:
        return len(self._data)

    def get(self, tensors: Sequence[Any], build: Callable[[], Any],
            *extra: Hashable) -> Any:
        """Return the plan for ``tensors`` (and ``extra``), building it
        on a miss."""
        key = tuple((id(t), tuple(t.shape)) for t in tensors) + extra
        plan = self._data.get(key)
        if plan is None:
            plan = build()
            self._data[key] = plan
            for t in tensors:
                weakref.finalize(t, self._data.pop, key, None)
        return plan

    def clear(self) -> None:
        """Drop every entry (the next ``get`` of each structure builds
        anew)."""
        self._data.clear()
