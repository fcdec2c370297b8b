"""Seconds of rank 0's device conversion of its own slab's triplets to CSR
(``DeviceCoo.to_csr_device``: ``convert/engine.py::compress_device``),
host clock to a synchronise, in set-up; every rank builds a slab of the
same size at once. The rank-local entry that follows
(``shard_from_rows``) is ``dist_entry_s`` under ``timings``."""


def read(rec):
    return rec.timings.get("csr_build_s")
