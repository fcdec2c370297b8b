"""Device milliseconds of each CG call's Jacobi set-up (the diagonal
rebuilt from the CSR arrays, and its inverse): the port's span
``spal.precond``, device seconds between its CUDA events over its count,
read from the port's registry
(``spalinalg_tpu_torch.utils.profiling.span_totals()``), which holds the
profiled units only."""

from spbench import port_spans


def read(rec):
    return port_spans.per_call("spal.precond", "device_s", 1e3)
