"""Peak device memory of the run, set-up included, on the fullest card of
the gang (each rank's ``torch.cuda.max_memory_allocated``, from
``record.ranks``), in GiB."""


def read(rec):
    peak = max((r["peak_bytes"] for r in rec.ranks), default=0)
    return peak / 2**30 if peak else None
