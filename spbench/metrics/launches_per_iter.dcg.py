"""Device operations (kernels, copies, fills, NCCL's sends, receives and
all-reduces) in rank 0's profiled CG calls, over their iterations: the
per-call work (the Jacobi diagonal, the first residual, the steps run
ahead of the test) spread over the iterations it serves."""


def read(rec):
    if rec.trace is None or not rec.iterations:
        return None
    return rec.trace["device_count"] / rec.iterations
