"""The traced run's reading: torch.profiler's Chrome trace of the traced
window, reduced to device intervals by layer, the window's busy share, and
the host's activity in the device's idle gaps.

The harness marks each unit of work (a block of micro-steps, or a request)
with a ``portbench.unit`` range; the window runs from the first unit's start
to the last one's end on the trace's own clock. Kernels are named to layers
by their function names in the program's sources (``egnn_tpu_torch/csrc``);
every other kernel is a library's (cuBLAS, PyTorch's own)."""
from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field

UNIT = "portbench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

# kernel function names of the program's sources, by layer
LAYERS = {
    "knn": re.compile(r"\b(knn_select_block_kernel|grid_knn_kernel)\b"),
    "pair_fwd": re.compile(r"\b(pair_fwd_kernel|pair_fwd_mode_kernel)\b"),
    "pair_bwd": re.compile(r"\b(pair_bwd_kernel|reduce_partials_kernel)\b"),
    # segment_sum.cu's kernels, like all of the program's, sit in an anonymous
    # namespace, which layer_of strips: anchored at the start, so that
    # PyTorch's at::native::reduce_kernel is not taken for one
    "segment": re.compile(r"^(void )?(count_kernel|scan_kernel|place_kernel|hub_max_kernel"
                          r"|reduce_kernel)\b"),
}


def layer_of(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    for layer, pattern in LAYERS.items():
        if pattern.search(name):
            return layer
    return "torch"


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespace of the
    program's sources, template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0] or [len(name)])
    return name[:cut][:80]


def merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(merged: list, s: float, e: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged if b > s and a < e)


@dataclass
class Reading:
    """What a per-layer metric reads: seconds are device time inside the
    window; ``units`` the micro-steps or requests traced, ``counts`` the
    valid work of each, ``extra`` what the loop adds (the cell's
    configuration, mix and family)."""

    window_s: float
    busy_s: float
    units: int
    layer_s: dict
    unit_spans: list                      # (start_s, end_s, busy_s) a unit
    counts: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)


def read(path: str, units: int) -> Reading:
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("name") == UNIT)
    if not spans:
        raise RuntimeError("the trace holds no unit ranges")
    w0, w1 = spans[0][0], spans[-1][1]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    ivals, layer_s, by_name = [], {}, {}
    for e in device:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        ivals.append((s, t))
        if e["cat"] == "kernel":
            layer = layer_of(e["name"])
            layer_s[layer] = layer_s.get(layer, 0.0) + (t - s) / 1e6
            key = short_name(e["name"])
        else:
            key = e["cat"]
        by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e6
    busy = merge(ivals)
    busy_s = sum(b - a for a, b in busy) / 1e6
    unit_spans = [(a / 1e6, b / 1e6, overlap(busy, a, b) / 1e6) for a, b in spans]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") in HOST_CATS and e.get("name") != UNIT)
    gaps, edge, active, nxt = {}, w0, [], 0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid = 0.5 * (a + edge)
            while nxt < len(host) and host[nxt][0] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] >= mid]
            # the innermost host activity at the gap's middle names it
            name = min(active, key=lambda h: h[1] - h[0])[2] if active else "host idle"
            gaps[name] = gaps.get(name, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Reading(window_s=(w1 - w0) / 1e6, busy_s=busy_s, units=units, layer_s=layer_s,
                   unit_spans=unit_spans,
                   breakdown={"device_ops": top(by_name), "idle_gaps": top(gaps)})


def profile_to_reading(prof, units: int) -> Reading:
    """Export ``prof``'s trace to a temporary file (under ``TMPDIR``), read
    it, and delete it."""
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return read(path, units)
