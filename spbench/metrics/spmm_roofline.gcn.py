"""Share of the CSR SpMM's roofline in the GCN's forward: the compulsory
work of each timed ``Â @ (H·W)`` (``roofline.csr_spmm_work`` from its
shapes) over the device time between CUDA events the benchmark records
around the port's call."""

from spbench import roofline


def read(rec):
    return roofline.brackets_share(rec.tracer.brackets("spmm_fwd"))
