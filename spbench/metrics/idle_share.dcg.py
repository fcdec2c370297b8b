"""Share of the profiled window in which no operation ran on the device
(the union of device operations' intervals), on the idlest card of the
gang (``record.ranks``): the card whose busy time and window the result
line reports."""


def read(rec):
    shares = [100.0 * (1.0 - r["busy_s"] / r["window_s"])
              for r in rec.ranks if r.get("window_s")]
    return max(shares) if shares else None
