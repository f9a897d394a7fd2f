"""Cells cut to a size the CPU runs in seconds, for the tests: the
program's plain kernels stand in for the card's."""
import copy

import torch

from portbench import spec

CUTS = {
    "sparse_qm9": ({"layers": 2}, {"batch": 4}),
    "dense_knn_readme": ({"depth": 2, "num_positions": 64}, {"batch": 2}),
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    model, mix = CUTS[cell.config["name"]]
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(model)
    cell.mix = {**copy.deepcopy(cell.mix), **mix}
    if cell.mix["loop"] == "serve":
        cell.mix.update(pool=4, warmup=2, trace_requests=5)
    else:
        cell.mix.update(block=2, trace_blocks=2)
    return cell


CPU = torch.device("cpu")
