"""Per cent of a card's profiled window taken by NCCL's kernels (every
device operation whose name starts with ``nccl``: the halo exchange's
send and receive, the dot products' ``all_reduce``), the largest over the
gang's ranks (``record.ranks``, each rank's own trace and window).

NCCL's kernels spin on the card while their rank waits for a late peer,
so this counts that waiting as well as the transfer: it reads how long
the cards sat in communication, not how many bytes moved. None where no
rank ran an NCCL kernel (a CPU gang runs none)."""


def read(rec):
    shares = []
    for r in rec.ranks:
        trace = r.get("trace")
        if not trace or not trace["window_s"]:
            continue
        nccl = sum(s for name, s, _ in trace["device_ops"]
                   if name.startswith("nccl"))
        if nccl:
            shares.append(100.0 * nccl / trace["window_s"])
    return max(shares) if shares else None
