"""Faults planted under a run, to show that the output check catches them.

Each fault is a context manager that breaks the timed path while it is
open: the port's call or the user loop's step, never the plain reference.
``tools/readings.py`` reads them on the card at a cell's own size; the
tests read them on the CPU at a toy size.
"""

from __future__ import annotations

import contextlib

import torch


def _nudge(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its first element raised by a hundredth of its largest
    magnitude: an answer altered where it is produced."""
    d = torch.zeros_like(t)
    d.view(-1)[0] = 0.01 * t.detach().abs().max()
    return t + d


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _cg_result(change):
    import spalinalg_tpu_torch.linalg as linalg

    def make(old):
        def cg(*args, **kwargs):
            res = old(*args, **kwargs)
            return res._replace(x=change(res.x))
        return cg
    return _patched(linalg, "cg", make)


def _product(change):
    """``CsrMatrix @`` with its output changed by ``change(out, operand)``."""
    from spalinalg_tpu_torch import CsrMatrix

    def make(old):
        def matmul(self, other):
            return change(old(self, other), other)
        return matmul
    return _patched(CsrMatrix, "__matmul__", make)


def _half_batch():
    """The loss averaged over the first half of the rows it is given."""
    from .loops import gcn

    class HalfF:
        def __getattr__(self, name):
            return getattr(torch.nn.functional, name)

        @staticmethod
        def cross_entropy(logits, labels):
            h = logits.shape[0] // 2
            return torch.nn.functional.cross_entropy(logits[:h], labels[:h])

    return _patched(gcn, "F", lambda old: HalfF())


def _no_step():
    """Adam's step leaves every parameter as it was."""
    return _patched(torch.optim.Adam, "step", lambda old: (
        lambda self, closure=None: None))


def _leaf_unchanged():
    """Adam's step leaves the last parameter (the output layer's bias, the
    smallest leaf) as it was and moves the others."""
    def make(old):
        def step(self, closure=None):
            last = self.param_groups[-1]["params"][-1]
            keep = last.detach().clone()
            out = old(self, closure)
            with torch.no_grad():
                last.copy_(keep)
            return out
        return step
    return _patched(torch.optim.Adam, "step", make)


FAULTS = {
    "cg": {
        "state_unchanged": lambda: _cg_result(torch.zeros_like),
        "answer_altered": lambda: _cg_result(_nudge),
    },
    "pagerank": {
        "state_unchanged": lambda: _product(lambda out, x: x.clone()),
        "answer_altered": lambda: _product(lambda out, x: _nudge(out)),
    },
    "gcn": {
        "state_unchanged": _no_step,
        "leaf_unchanged": _leaf_unchanged,
        "half_batch": _half_batch,
        "answer_altered": lambda: _product(lambda out, x: _nudge(out)),
    },
}
