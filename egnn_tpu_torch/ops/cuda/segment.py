"""Kernel K2 (segment sum) and its plain PyTorch version.

K2 ``segment_sum`` replaces the TPU kernel
``egnn_tpu/ops/pallas/segment.py:segment_sum_pallas`` (``_seg_kernel``): per
graph of a batch, ``out[b, s] = sum of data[b, e]`` over ``ids[b, e] == s``,
ids in any order, an id < 0 or >= S adding nothing. It runs
``csrc/segment_sum.cu``, whose header gives the design (a CSR built with
integer atomics, each segment summed in ascending edge order, so the result
repeats bit for bit) and its bound on the card. A CUDA tensor launches the
kernel or raises; a CPU tensor runs ``segment_sum_plain``, which the tests
hold against the JAX package and ``chip_smoke.py`` holds the kernel against
on the card. Launches count into ``LAUNCH_COUNTS["segment_sum"]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_COUNTS, build, raise_on_launch_error

INT32_MAX = 2**31 - 1

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             _P, _P, _P, _P, _P, _P]
_ENTRIES = {torch.int64: "segment_sum_launch_i64", torch.int32: "segment_sum_launch_i32"}


def segment_sum_plain(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(b, E, D) x (b, E) -> (b, S, D). Out-of-range ids go to a dump row
    past the last segment (``index_add_`` raises on them); on the CPU the
    rows are added in ascending edge order."""
    b, e, d = data.shape
    valid = (ids >= 0) & (ids < num_segments)
    rows = torch.arange(b, device=ids.device)[:, None] * num_segments + ids
    rows = torch.where(valid, rows, b * num_segments).reshape(-1)
    out = torch.zeros(b * num_segments + 1, d, dtype=data.dtype, device=data.device)
    out.index_add_(0, rows, data.reshape(b * e, d))
    return out[:-1].reshape(b, num_segments, d)


def _launch_segment_sum(data, ids, num_segments):
    if data.dim() != 3 or data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous (b, E, D) float32 tensor, "
                         f"got {tuple(data.shape)} {data.dtype}")
    b, e, d = data.shape
    if (ids.shape != (b, e) or ids.dtype not in _ENTRIES or ids.device != data.device
            or not ids.is_contiguous()):
        raise ValueError(f"ids must be a contiguous (b, E) int64 or int32 tensor on the "
                         f"data's device, got {tuple(ids.shape)} {ids.dtype} {ids.device}")
    if not (b >= 1 and d >= 1 and e <= INT32_MAX and 1 <= num_segments <= INT32_MAX):
        raise ValueError(f"kernel supports b >= 1, D >= 1, E < 2^31, 1 <= S < 2^31; "
                         f"got b={b}, D={d}, E={e}, S={num_segments}")
    dev = data.device
    out = torch.empty((b, num_segments, d), dtype=torch.float32, device=dev)
    if e == 0:
        return out.zero_()
    counts = torch.zeros((b, num_segments), dtype=torch.int32, device=dev)
    offsets = torch.empty((b, num_segments + 1), dtype=torch.int32, device=dev)
    perm = torch.empty((b, e), dtype=torch.int32, device=dev)
    ordered = torch.empty((b, e), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        # read here, not cached: autograd runs backward on its own thread
        stream = torch.cuda.current_stream().cuda_stream
        err = build.function("segment_sum", _ENTRIES[ids.dtype], _ARGTYPES)(
            data.data_ptr(), ids.data_ptr(), b, e, num_segments, d, counts.data_ptr(),
            offsets.data_ptr(), perm.data_ptr(), ordered.data_ptr(), out.data_ptr(), stream)
    raise_on_launch_error(err, "segment_sum")
    LAUNCH_COUNTS["segment_sum"] += 1
    return out


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K2: data (b, E, D) float32 and ids (b, E) int64 or int32 ->
    (b, num_segments, D). A CUDA tensor launches the kernel (E = 0 returns
    zeros and launches nothing); a CPU tensor runs ``segment_sum_plain``."""
    if data.is_cuda:
        return _launch_segment_sum(data, ids, num_segments)
    if data.device.type != "cpu":
        raise ValueError(f"no segment-sum kernel for device {data.device}")
    return segment_sum_plain(data, ids, num_segments)
