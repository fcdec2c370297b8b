"""The ``cg_dist`` loop and its cell's readers on the CPU: toy gangs of 2
and 4 ranks on gloo through ``run.py``'s launcher (``gang_cg_dist.py``),
sound and with the halo exchange dropped; the slab structure against the
whole grid's; the cell's readers on made-up records."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from spbench import gang, harness, roofline
from spbench.structures import stencil27, stencil27_slab

SCRIPT = Path(__file__).with_name("gang_cg_dist.py")
SEED = 2 ** 31 + 23
CELL = "hpcg-256-x4.dcg50"


def _gang(world: int, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop(gang.T0_ENV, None)
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--world", str(world), "--seed",
         str(SEED), "--seconds", "0.5", *extra],
        capture_output=True, text=True, timeout=115, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def _ranks(err: str) -> list:
    prefix = "[rank 0] notes: "
    line = [s for s in err.splitlines() if s.startswith(prefix)][-1]
    return json.loads(line[len(prefix):])["ranks"]


@pytest.mark.parametrize("world", [2, 4])
def test_cg_dist_gang_is_correct(world):
    """Every rank runs the same units; rank 0's check holds the gathered
    solutions against the whole grid's reference within the cell's
    limits; the gang's flops are counted once."""
    line, err = _gang(world)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == world
    assert [r["units"] for r in _ranks(err)] == [line["attempted"]] * world
    assert line["checks"]["x_gap"]["value"] < 1e-14
    assert line["metrics"]["cg_gflops"]["value"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_cg_dist_check_fails_without_the_halo(world):
    """The halo exchange dropped in every rank (zero slabs in place of the
    neighbours' entries): the run completes and its check fails on
    ``x_gap``."""
    line, _ = _gang(world, "--drop-halo")
    assert line["correct"] is False
    x_gap = line["checks"]["x_gap"]
    assert x_gap["value"] > 1e3 * x_gap["limit"]


def test_cg_dist_traced_readers():
    """A traced toy gang reports the registry's halo and SpMV spans, the
    idle shares, the launches and rank 0's build; the card-only readers
    (NCCL, the SpMV kernel, device peak and device time) read nothing on
    the CPU."""
    line, _ = _gang(2, "--trace", "1")
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["halo_host_us.dcg"]["value"] > 0
    assert metrics["spmv_host_us.dcg"]["value"] > 0
    assert metrics["csr_build_s.dcg"]["value"] > 0
    assert metrics["launches_per_iter.dcg"]["value"] >= 0
    assert 0 <= metrics["idle_share.dcg"]["value"] <= 100
    assert 0 <= metrics["spmv_idle_share.dcg"]["value"] <= 100
    for name in ("comm_share.dcg", "spmv_roofline.dcg", "jacobi_ms.dcg",
                 "peak_mem_gib.dcg"):
        assert name not in metrics


@pytest.mark.parametrize("grid,world", [((6, 5, 8), 4), ((4, 3, 6), 2),
                                        ((5, 4, 4), 1)])
def test_slabs_make_the_whole_operator(grid, world):
    """The ranks' slabs, their rows shifted back to the whole grid's ids,
    are the whole grid's triplets; their counts add up."""
    nx, ny, nz = grid
    whole = set(zip(*(t.tolist() for t in stencil27.triplets(nx, ny, nz))))
    slabs, total = set(), 0
    for rank in range(world):
        z0, z1 = stencil27_slab.planes(nz, rank, world)
        rows, cols, vals = stencil27_slab.triplets(nx, ny, nz, z0, z1)
        assert rows.numel() == stencil27_slab.nnz(nx, ny, nz, z0, z1)
        total += rows.numel()
        slabs |= set(zip((rows + z0 * nx * ny).tolist(), cols.tolist(),
                         vals.tolist()))
    assert slabs == whole and total == stencil27.nnz(nx, ny, nz)


def test_cell_sizes():
    """The configuration's stated sizes are the structure's."""
    cfg = harness.load_cell(CELL).config
    nx, ny, nz = cfg["grid"]
    world = cfg["ranks"]
    assert cfg["rows"] == nx * ny * nz
    assert cfg["entries"] == stencil27.nnz(nx, ny, nz)
    assert cfg["rank_entries"] == [
        stencil27_slab.nnz(nx, ny, nz, *stencil27_slab.planes(nz, r, world))
        for r in range(world)]
    assert cfg["rank_rows"] * world == cfg["rows"]
    assert cfg["halo_rows"] == nx * ny


def _record(ranks, iterations=0, timings=None):
    return harness.Record(cell=CELL, trace=ranks[0]["trace"], tracer=None,
                          iterations=iterations, busy_s=ranks[0]["busy_s"],
                          peak_bytes=ranks[0]["peak_bytes"],
                          timings=timings or {}, ranks=ranks)


def _rank(rank, ops, busy_s, window_s=2.0, peak=0, gaps=(), count=1):
    return {"rank": rank, "units": 3, "peak_bytes": peak, "busy_s": busy_s,
            "window_s": window_s,
            "trace": {"window_s": window_s, "busy_s": busy_s,
                      "device_ops": ops, "idle_gaps": list(gaps),
                      "device_count": count}}


SPMV = "void (anonymous namespace)::csr_spmv_vector<double, false>(int const*)"


def test_readers_on_made_up_ranks():
    """comm_share: the largest NCCL share of a rank's window; idle_share:
    the idlest card; peak: the fullest card; spmv_roofline: the lowest
    rank's share of its slab's bound."""
    ops0 = [[SPMV, 0.4, 153], ["ncclDevKernel_SendRecv(x)", 0.1, 153],
            ["ncclDevKernel_AllReduce_Sum_f64(x)", 0.02, 300]]
    ops1 = [[SPMV, 0.5, 153], ["ncclDevKernel_SendRecv(x)", 0.3, 153]]
    ranks = [_rank(0, ops0, 1.8, peak=3 * 2**30),
             _rank(1, ops1, 1.5, peak=5 * 2**30)]
    rec = _record(ranks)
    read = harness.metric_reader
    assert read("comm_share.dcg")(rec) == pytest.approx(15.0)
    assert read("idle_share.dcg")(rec) == pytest.approx(25.0)
    assert read("peak_mem_gib.dcg")(rec) == pytest.approx(5.0)
    cfg = harness.load_cell(CELL).config
    nx, ny, nz = cfg["grid"]
    rows = nx * ny * nz // 2
    nnz = stencil27_slab.nnz(nx, ny, nz, *stencil27_slab.planes(nz, 1, 2))
    nbytes, flops = roofline.csr_spmv_work(rows, rows + 2 * nx * ny, nnz, 8)
    want = 100 * roofline.bound_s(nbytes, flops, 8) * 153 / 0.5
    assert read("spmv_roofline.dcg")(rec) == pytest.approx(want)
    quiet = _record([_rank(0, [], 0.0), _rank(1, [], 0.0)])
    assert read("comm_share.dcg")(quiet) is None
    assert read("spmv_roofline.dcg")(quiet) is None
    assert read("peak_mem_gib.dcg")(quiet) is None


def test_registry_readers(cpu):
    """``halo_host_us.dcg`` and ``jacobi_ms.dcg`` read the port's registry
    (host µs a halo span; device ms a ``spal.precond``, None on the
    CPU)."""
    from spalinalg_tpu_torch.utils import profiling

    read = harness.metric_reader
    rec = _record([_rank(0, [], 0.0)])
    profiling.reset()
    try:
        assert read("halo_host_us.dcg")(rec) is None
        with profiling.tracing():
            for _ in range(4):
                with profiling.annotate("spal.halo", device=cpu):
                    time.sleep(0.001)
            with profiling.annotate("spal.precond", device=cpu):
                pass
        us = read("halo_host_us.dcg")(rec)
        assert 1000 <= us < 1e5
        assert read("jacobi_ms.dcg")(rec) is None
    finally:
        profiling.reset()


def test_spmv_and_launch_readers(cpu):
    """``spmv_idle_share.dcg``: the largest rank's idle gaps under
    ``spal.spmv`` over its window, None without the span in the registry;
    ``launches_per_iter.dcg``: rank 0's device operations over the
    profiled iterations; ``csr_build_s.dcg``: rank 0's build."""
    from spalinalg_tpu_torch.utils import profiling

    read = harness.metric_reader
    gaps0 = [["cg_dist.solve/spal.spmv", 0.02], ["cg_dist.solve/x", 0.5]]
    gaps1 = [["cg_dist.solve/spal.spmv", 0.06],
             ["cg_dist.solve/spal.spmv.y", 0.4]]
    rec = _record([_rank(0, [], 1.0, gaps=gaps0, count=1500),
                   _rank(1, [], 1.0, window_s=1.5, gaps=gaps1)],
                  iterations=150, timings={"csr_build_s": 2.5})
    assert read("csr_build_s.dcg")(rec) == 2.5
    assert read("launches_per_iter.dcg")(rec) == pytest.approx(10.0)
    assert read("launches_per_iter.dcg")(_record([_rank(0, [], 1.0)])) is None
    profiling.reset()
    try:
        assert read("spmv_idle_share.dcg")(rec) is None
        with profiling.tracing():
            with profiling.annotate("spal.spmv", device=cpu):
                pass
        assert read("spmv_idle_share.dcg")(rec) == pytest.approx(4.0)
        assert read("spmv_host_us.dcg")(rec) > 0
    finally:
        profiling.reset()
