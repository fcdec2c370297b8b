"""Peak device memory of the run, set-up included, on the fullest chip
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
