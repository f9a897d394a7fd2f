"""The port's hand-written CUDA kernels: their ctypes wrappers (``knn.py``,
``grid_knn.py``, ``segment.py``, ``pair_messages.py``), the build
(``build.py``) and one launch count per kernel.

``LAUNCH_COUNTS`` holds the launches of each kernel since the last
``reset_launch_counts()``: a wrapper adds one where it launches its kernel
and nowhere else, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

LAUNCH_COUNTS = {
    "knn_select_gather": 0, "knn_select": 0, "segment_sum": 0, "knn_select_tiled": 0,
    "knn_candidates_packed_tiled": 0, "knn_candidates_packed": 0,
    "grid_knn_cells": 0, "knn_select_queries": 0, "knn_select_window": 0,
    "fused_pair_fwd": 0, "fused_pair_bwd": 0, "fused_knn_fwd": 0, "fused_knn_bwd": 0,
    "fused_pair_fwd_bf16": 0, "fused_pair_bwd_bf16": 0,
    "knn_select_gather_rows": 0, "knn_select_rows": 0, "knn_select_tiled_rows": 0,
    "fused_knn_fwd_table": 0, "fused_knn_bwd_table": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def raise_on_launch_error(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
