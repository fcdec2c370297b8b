"""Host microseconds of each halo exchange in the profiled units: the
port's span ``spal.halo`` (``parallel/spmv.py::_operand``: the neighbours'
sends and receives into the operand window posted and waited for, the own
slice copied into it), host seconds over its count, read from the
port's registry (``spalinalg_tpu_torch.utils.profiling.span_totals()``),
which holds the profiled units only. The registry read is rank 0's, an
edge rank with one neighbour. Taken under the profiler, so with its cost
per host op."""

from spbench import port_spans


def read(rec):
    return port_spans.per_call("spal.halo", "host_s", 1e6)
