"""On the card: the control (the program's own TF32 path, float32 matmul
precision "high") and the program in bfloat16 ("medium") come out not
correct in each training cell, at the cell's own size. The benchmark's runs
do not run this; ``readings.py`` reads the same numbers over many seeds."""
import pytest
import torch

from portbench import faults, harness, loops, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("mode", faults.PRECISIONS)
def test_lower_precision_fails(name, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.cell(name)
    device = torch.device("cuda", 0)
    loops.set_precision(tf32=False)
    with faults.planted(mode, cell.family):
        result = harness.run_cell(cell, 2 ** 31 + 21, 0.0 if cell.mix["loop"] == "train"
                                  else 1.0, False, device, 0.0)
    assert not result["correct"], result["checks"]
