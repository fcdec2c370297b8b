"""Share of the roofline of the SpMM's backward, ``Âᵀ·G``: the forward's
compulsory work at the same width over the device time from the gradient
reaching the SpMM's output (a tensor hook records an event) to the
gradient leaving for its input (another hook)."""

from spbench import roofline


def read(rec):
    return roofline.brackets_share(rec.tracer.brackets("spmm_bwd"))
