"""The numbers that decide ``correct``, each against the limit its cell's
``limits/<cell>.json`` holds (``PERF.md`` gives the readings each limit was
set from).

Training: the program's first micro-steps against the reference's on the
same weights and batches:
- ``loss_gap``: the widest relative gap of a micro-step's loss;
- ``grad_gap``: the first gradient as the optimizer holds it after one
  micro-step, by the worst leaf: |norm(program) - norm(reference)| over the
  larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the parameters' change over the checked micro-steps, by
  the worst leaf, measured the same way.
Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone (a layer's unused outputs), and count in neither.

Where float32 itself cannot hold a configuration's first steps (a deep
network whose features grow until its gates saturate), each gap is also
read in float32's own units (``<name>_per_f32``): the program's gap to the
reference in float64 over the float32 reference's gap to the same, on the
same seed. A sound float32 program reads about 1 there, a lower precision
far more.

Serving: the family's numbers of one answer against the reference's
(``answer_numbers``), each the largest over the sampled requests.
"""
from __future__ import annotations

import statistics

import torch

SMALL_GRAD = 1e-3


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, keep: list) -> dict:
    """Each kept leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def kept_leaves(ref: dict) -> list:
    grads = ref["grad"]
    med = statistics.median(grads.values())
    return [k for k, v in grads.items() if v >= SMALL_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}. Besides the worst leaf's gaps, the median
    leaf's (``*_median``), which one noisy leaf does not move."""
    keep = kept_leaves(ref)
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    grad = leaf_gaps(prog["grad"], ref["grad"], keep)
    change = leaf_gaps(prog["change"], ref["change"], keep)
    return {"loss_gap": loss,
            "grad_gap": max(grad.values()), "change_gap": max(change.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values())}


NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median", "change_gap_median")
# a float32 gap under this counts as this, so that a seed on which float32
# and float64 agree to the last bits does not divide by nothing
F32_FLOOR = 1e-7


def per_f32(prog: dict, ref32: dict, ref64: dict) -> dict:
    """``<name>_per_f32`` of each number: gap(program, float64) over
    max(gap(float32 reference, float64), ``F32_FLOOR``)."""
    p, r = train_numbers(prog, ref64), train_numbers(ref32, ref64)
    return {f"{k}_per_f32": p[k] / max(r[k], F32_FLOOR) for k in NUMBERS}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): each number at or under its
    limit; a number that is not finite, or was not read, fails."""
    rows = [[k, numbers.get(k, float("inf")), limits[k]] for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
