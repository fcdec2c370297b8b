"""Share of the local CSR SpMV's roofline on the gang's slowest card: for
each rank, the compulsory work of one product of its halo-local block
(``roofline.csr_spmv_work(rows_per_shard, rows_per_shard + 2·halo, its
entries, 8)``: ``rows_per_shard`` rows, the operand with both neighbours'
slabs, the rank's own stored entries) over the mean device time of its
``csr_spmv_vector<double>`` launches in its trace; the lowest over the
ranks. Shapes come from the cell's configuration (its grid dealt out in
z-slabs, ``structures/stencil27_slab.py``). None where no rank's trace
holds the kernel."""

from spbench import harness, roofline
from spbench.structures import stencil27_slab

KERNEL = "csr_spmv_vector<double"
ITEMSIZE = 8


def read(rec):
    launches = {}
    for r in rec.ranks:
        trace = r.get("trace")
        hits = [(s, c) for name, s, c in (trace or {}).get("device_ops", ())
                if KERNEL in name]
        if hits:
            launches[r["rank"]] = (sum(s for s, _ in hits),
                                   sum(c for _, c in hits))
    if not launches:
        return None
    cfg = harness.load_cell(rec.cell).config
    nx, ny, nz = cfg["grid"]
    world = len(rec.ranks)
    rows = nx * ny * nz // world
    halo = nx * ny                # a slab's reach: one plane each way
    shares = []
    for rank, (seconds, count) in launches.items():
        nnz = stencil27_slab.nnz(nx, ny, nz,
                                 *stencil27_slab.planes(nz, rank, world))
        nbytes, flops = roofline.csr_spmv_work(rows, rows + 2 * halo, nnz,
                                               ITEMSIZE)
        shares.append(100.0 * roofline.bound_s(nbytes, flops, ITEMSIZE)
                      * count / seconds)
    return min(shares)
