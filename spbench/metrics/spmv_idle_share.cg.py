"""Share of the profiled window in which the device sat idle while the
host was inside the port's ``A @ x`` before its launch: the idle gaps that
the trace labels ``<benchmark span>/spal.spmv`` (the port's span the
outermost host op over the gap), over the window. None where the port's
registry (``spalinalg_tpu_torch.utils.profiling.span_totals()``, the
profiled units only) holds no ``spal.spmv``."""

from spbench import port_spans


def read(rec):
    return port_spans.idle_share_under(rec, "spal.spmv")
