"""Device milliseconds of each CG call's Jacobi set-up on the ``DistCsr``
(this rank's inverse diagonal, read from its shard's rows at the diagonal
``rank·rows_per_shard``): the port's span ``spal.precond``, device
seconds between its CUDA events over its count, read from the port's
registry (``spalinalg_tpu_torch.utils.profiling.span_totals()``), which
holds the profiled units only. The registry read is rank 0's."""

from spbench import port_spans


def read(rec):
    return port_spans.per_call("spal.precond", "device_s", 1e3)
