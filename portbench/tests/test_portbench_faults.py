"""A run with its timed path broken underneath comes out not correct; the
same run unbroken comes out correct. Each cell's own limits; the card's check
skipped, the rest of a run driven on the CPU at a tiny size."""
import pytest

from portbench import faults, harness, loops

from ._tiny import CPU, tiny_cell

CASES = [(c, f) for c in ("sparse_qm9.train_g96", "dense_knn_readme.train_b8")
         for f in ("unchanged", "half_batch")] + \
        [("dense_knn_readme.serve_b64", f)
         for f in ("half_batch", "answer_altered", "tail_nodes", "one_tile")]


def _run(cell):
    loops.set_precision(tf32=False)
    return harness.run_cell(cell, 2 ** 31 + 11, 0.05, False, CPU, 0.0)


@pytest.mark.parametrize("name", sorted({c for c, _ in CASES}))
def test_sound_run_is_correct(name):
    assert _run(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault):
    cell = tiny_cell(name)
    with faults.planted(fault, cell.family):
        result = _run(cell)
    assert not result["correct"], result["checks"]
