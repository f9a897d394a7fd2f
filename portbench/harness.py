"""One run of one cell: the program's set-up and window (``loops``), the
metrics the cell reports, then the reference's check, and the result
line's fields."""
from __future__ import annotations

import subprocess

import torch

from . import compare, loops, spec


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _worst(gaps: dict) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, detail: bool = False) -> dict:
    """The result line's fields, ``checks`` last: each number compared with
    its value and limit. The program runs in the matmul precision the caller
    set; the reference always in full float32. ``detail`` adds every number
    read (a training cell's three worst leaves, a serving cell's counts of
    nodes over several gaps) as ``numbers``."""
    loop = cell.mix["loop"]
    run = getattr(loops, loop)(cell, seed, seconds, traced, device, t_start)
    if traced:
        reading = run["reading"]
        reading.extra = {"config": cell.config, "mix": cell.mix, "family": cell.family}
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(run["memory_peak_bytes"]),
           "power": power_limit() if device.type == "cuda" else "not read"}
    if traced:
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
    # the program's state is freed before the reference runs
    w0 = run.pop("w0")
    loops.set_precision(tf32=False)
    if loop == "train":
        check = run.pop("check")
        loops.release()
        ref = loops.train_reference(cell, seed, w0, device)
        numbers = compare.train_numbers(check, ref)
        if detail or any(k.endswith("_per_f32") for k in cell.limits):
            ref64 = loops.train_reference(cell, seed, w0, device, torch.float64)
            numbers.update(compare.per_f32(check, ref, ref64))
        if detail:
            keep = compare.kept_leaves(ref)
            numbers["worst_grad"] = _worst(compare.leaf_gaps(check["grad"], ref["grad"], keep))
            numbers["worst_change"] = _worst(compare.leaf_gaps(check["change"], ref["change"],
                                                               keep))
    else:
        kept, host = run.pop("kept"), run.pop("host")
        loops.release()
        numbers = loops.serve_reference(cell, kept, host, w0, device, detail)
    correct, rows = compare.judge(numbers, cell.limits)
    result = {"correct": bool(correct), "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = reading.breakdown
    if detail:
        result["numbers"] = numbers
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result
