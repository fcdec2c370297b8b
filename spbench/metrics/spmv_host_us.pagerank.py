"""Host microseconds of each ``A @ x`` in the profiled units, from the
port's entry (``ops/matvec.py``) to its kernel launch's return: the port's
span ``spal.spmv``, host seconds over its count, read from the port's
registry (``spalinalg_tpu_torch.utils.profiling.span_totals()``), which
holds the profiled units only. Taken under the profiler, so with its cost
per host op."""

from spbench import port_spans


def read(rec):
    return port_spans.per_call("spal.spmv", "host_s", 1e6)
