"""Device operations (kernels, copies, fills) in the profiled CG calls,
over their iterations: the per-call work (the Jacobi diagonal, the first
residual) spread over the iterations it serves."""


def read(rec):
    if rec.trace is None or not rec.iterations:
        return None
    return rec.trace["device_count"] / rec.iterations
