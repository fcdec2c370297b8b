"""Share of the profiled window in which a card sat idle while its host
was inside the port's ``A @ x`` before its launch: the idle gaps that the
rank's trace labels ``<benchmark span>/spal.spmv``, over that rank's
window, the largest over the gang's ranks (``record.ranks``). None where
the port's registry (rank 0's ``span_totals()``, the profiled units only)
holds no ``spal.spmv``."""

from spbench import port_spans


def read(rec):
    if port_spans.totals("spal.spmv") is None:
        return None
    shares = []
    for r in rec.ranks:
        trace = r.get("trace")
        if not trace or not trace["window_s"]:
            continue
        idle = sum(s for label, s in trace["idle_gaps"]
                   if label.endswith("/spal.spmv"))
        shares.append(100.0 * idle / trace["window_s"])
    return max(shares) if shares else None
