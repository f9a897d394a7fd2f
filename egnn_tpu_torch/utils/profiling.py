"""Timing, tracing and roofline accounting on the card, the counterpart of
``egnn_tpu/utils/profiling.py``; ``chip_smoke.py`` times with these.

- ``time_fn(fn, ...)``: seconds of one ``fn`` call. On the card each timed
  call sits between two CUDA events, so the host's launch time is included
  (the time a caller sees); with ``graph_reps`` the calls are captured in a
  CUDA graph and each replay is timed, which leaves the device time alone.
  On the CPU (``device="cpu"``) the host clock times each call.
- ``chain_calls(fn, n)``: one call that runs ``fn`` n times, each on the
  last one's output.
- ``measure_op(fn, x, ...)``: seconds per ``fn(x)`` free of a fixed cost a
  call, as the slope between chains of two lengths.
- ``trace(logdir)``: torch.profiler around a block, written as a Chrome
  trace.
- ``annotate(name)``: a named range for the profiler (and an NVTX range
  where CUDA is present).
- ``Roofline``: achieved rates against the card's peaks, and the least time
  the card could take. Its defaults are one NVIDIA H100 SXM's, from NVIDIA's
  data sheet at the full 700 W power limit: HBM3 at 3.35e12 bytes/s and
  67e12 float32 operations/s outside the tensor cores. A card set to a lower
  power limit runs slower under load: write its name and limit
  (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``)
  beside every number.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Callable, Optional

import torch

from .checks import _leaves
from .device import resolve_device

H100_SXM = "NVIDIA H100 SXM, data sheet, 700 W"
H100_SXM_HBM_BYTES_PER_S = 3.35e12
H100_SXM_F32_FLOPS = 67e12
H100_SXM_BF16_TENSOR_FLOPS = 989e12   # dense bf16 on the tensor cores


def _reduce(times: list[float], stat: str) -> float:
    if stat == "min":
        return min(times)
    if stat == "median":
        return statistics.median(times)
    raise ValueError(f"unknown stat {stat!r}")


def _replay_seconds(fn: Callable, args: tuple, graph_reps: int, trials: int,
                    warmup: int, stat: str) -> float:
    """``graph_reps`` calls captured in one CUDA graph (after ``warmup``
    calls on a side stream, which capture needs), replayed once, then each
    of ``trials`` replays timed between two CUDA events; seconds a call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(graph_reps):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / graph_reps / 1e3)
    return _reduce(times, stat)


def time_fn(
    fn: Callable,
    make_args: Optional[Callable[[int], tuple]] = None,
    reps: int = 3,
    warmup: int = 1,
    stat: str = "min",
    graph_reps: Optional[int] = None,
    device=None,
) -> float:
    """Seconds of one ``fn(*make_args(i))`` call (``fn()`` without
    ``make_args``): the ``stat`` ("min" or "median") of ``reps`` timed calls
    after ``warmup`` untimed ones.

    On the card (the default) each call is timed by CUDA events recorded
    on either side of it and waited for; the host's launch time is inside.
    With ``graph_reps`` (card only) ``graph_reps`` calls on ``make_args(0)``
    are captured in a CUDA graph after ``warmup`` calls, and ``reps``
    replays are timed, each divided by ``graph_reps``: device time without
    the host's launch gaps. With ``device="cpu"`` the host clock times each
    call.
    """
    dev = resolve_device(device)
    args_of = (lambda i: ()) if make_args is None else make_args
    if graph_reps is not None:
        if dev.type != "cuda":
            raise ValueError("graph_reps times CUDA graph replays: it needs a CUDA device")
        return _replay_seconds(fn, args_of(0), graph_reps, reps, warmup, stat)
    for i in range(warmup):
        fn(*args_of(-1 - i))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    times = []
    for i in range(reps):
        args = args_of(i)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return _reduce(times, stat)


def chain_calls(fn: Callable, n: int) -> Callable:
    """``x -> x'``: ``fn`` run ``n`` times, each call's input the last one's
    plus 1e-12 times the sum of |outputs|, so that the calls depend on each
    other in order. Divide the time of one call by ``n``."""

    def many(x):
        for _ in range(n):
            y = fn(x)
            bump = sum(t.detach().abs().to(x.dtype).sum() for t in _leaves(y))
            x = x + bump * 1e-12
        return x

    return many


def measure_op(
    fn: Callable,
    x: torch.Tensor,
    reps_lo: int = 200,
    reps_hi: int = 1000,
    reps_outer: int = 4,
    device=None,
) -> float:
    """Seconds per ``fn(x)`` call, free of a fixed cost a timed call: chains
    of ``reps_lo`` and ``reps_hi`` calls are each timed (best of
    ``reps_outer``, by ``time_fn``) and the slope
    (T_hi - T_lo) / (reps_hi - reps_lo) is returned."""
    f_lo, f_hi = chain_calls(fn, reps_lo), chain_calls(fn, reps_hi)
    make = lambda i: (x * (1.0 + 1e-4 * (i + 2)),)  # noqa: E731
    t_lo = time_fn(f_lo, make, reps=reps_outer, device=device)
    t_hi = time_fn(f_hi, make, reps=reps_outer, device=device)
    return max(t_hi - t_lo, 1e-12) / (reps_hi - reps_lo)


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """torch.profiler over the block (the host's activity, and the card's on
    a CUDA device), written to ``logdir/trace.json`` as a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A range named ``name`` in the profiler's trace
    (``torch.profiler.record_function``) and, where CUDA is present, an NVTX
    range for tools that read those."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Achieved against peak rates for one measured op; ``bound_seconds`` is
    the least time the card could take for its work: the larger of its
    bytes over ``peak_bw`` and its operations over ``peak_flops``."""

    name: str
    seconds: float
    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_flops: float = H100_SXM_F32_FLOPS
    peak_bw: float = H100_SXM_HBM_BYTES_PER_S
    card: str = H100_SXM

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds if self.seconds else 0.0

    @property
    def achieved_bw(self) -> float:
        return self.bytes_accessed / self.seconds if self.seconds else 0.0

    @property
    def compute_fraction(self) -> float:
        return self.achieved_flops / self.peak_flops

    @property
    def bandwidth_fraction(self) -> float:
        return self.achieved_bw / self.peak_bw

    @property
    def bound(self) -> str:
        """Which roofline the op is closer to."""
        return "compute" if self.compute_fraction >= self.bandwidth_fraction else "memory"

    @property
    def bytes_seconds(self) -> float:
        return self.bytes_accessed / self.peak_bw

    @property
    def flops_seconds(self) -> float:
        return self.flops / self.peak_flops

    @property
    def bound_seconds(self) -> float:
        return max(self.bytes_seconds, self.flops_seconds)

    def report(self) -> str:
        return (
            f"{self.name}: {self.seconds*1e6:.1f} us | "
            f"{self.achieved_flops/1e12:.2f} TFLOP/s ({self.compute_fraction:.1%} peak) | "
            f"{self.achieved_bw/1e9:.1f} GB/s ({self.bandwidth_fraction:.1%} peak) | "
            f"{self.bound}-bound"
        )
