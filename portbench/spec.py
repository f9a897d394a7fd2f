"""Everything a cell is made of, found by name: ``BENCHMARK.json``'s entry,
``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<cell>.json``,
the family modules the configuration names, and a reader
``metrics/<metric>.py`` for each per-layer metric the cell reports. A later
change adds a cell, a configuration, a mix or a metric by adding files and
entries; nothing here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    family: object          # families/<family>.py
    end_to_end: list        # the end_to_end entries this cell reports
    per_layer: list         # the per_layer entries this cell reports


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, bench: dict = None, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``), its files read
    from ``here`` (this folder)."""
    bench = bench if bench is not None else benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    config = _json(here / "configs" / f"{entry['config']}.json")
    mix = _json(here / "traffic" / f"{entry['traffic']}.json")
    limits = _json(here / "limits" / f"{name}.json")
    family = importlib.import_module(f"portbench.families.{config['family']}")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, entry, config, mix, limits, family, e2e, per_layer)


def reader(metric: str, here: Path = HERE):
    """``read(reading) -> float | None`` of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
