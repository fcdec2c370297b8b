"""Share of the profiled window in which no operation ran on the device
(the union of device operations' intervals)."""


def read(rec):
    if rec.trace is None or not rec.trace["window_s"]:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.trace["window_s"])
