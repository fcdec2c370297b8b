"""Toy cells of the benchmark's three loops, for tests: the cells'
traffic and limits files, at sizes a CPU test can hold."""

import copy

from spbench import harness

TOY_GRAPH = {"structure": "kronecker", "scale": 9, "edgefactor": 4,
             "nodes": 512, "features": 7, "classes": 5, "train_nodes": 50,
             "initiator": [0.57, 0.19, 0.19, 0.05], "graph_seed": 4,
             "dtype": "float32"}
CELLS = {
    "cg": ("hpcg-256.cg50",
           {"structure": "stencil27", "grid": [6, 5, 4], "dtype": "float64"},
           {"maxiter": 5}),
    "gcn": ("graph500-s22.gcn3", TOY_GRAPH, {}),
    "pagerank": ("graph500-s22.pagerank20", TOY_GRAPH, {}),
}


def cell(kind: str, trace: bool = False) -> harness.Cell:
    """The toy cell of loop ``kind``, with the real cell's traffic, limits
    and metrics."""
    name, config, overrides = CELLS[kind]
    real = harness.load_cell(name)
    out = copy.deepcopy(real)
    out.name = f"toy.{kind}"
    out.config = dict(config)
    out.traffic = dict(real.traffic, **overrides)
    return out
