"""Share of the CSR SpMV's roofline: the compulsory work of each timed
``A @ x`` (``roofline.csr_spmv_work`` from its shapes) over the device
time between CUDA events the benchmark records around the port's call."""

from spbench import roofline


def read(rec):
    return roofline.brackets_share(rec.tracer.brackets("spmv"))
