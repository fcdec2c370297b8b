"""Seconds of the port's device conversion of the cell's triplets to CSR
(``DeviceCoo.to_csr_device``: ``convert/engine.py::compress_device``),
host clock to a synchronise, in set-up."""


def read(rec):
    return rec.timings.get("csr_build_s")
