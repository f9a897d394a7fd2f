"""Kernel K2 (segment sum), its plain PyTorch version and its model.

K2 ``segment_sum`` replaces the TPU kernel
``egnn_tpu/ops/pallas/segment.py:segment_sum_pallas`` (``_seg_kernel``): per
graph of a batch, ``out[b, s] = sum of data[b, e]`` over ``ids[b, e] == s``,
ids in any order, an id < 0 or >= S adding nothing. It runs
``csrc/segment_sum.cu``, whose header gives the design, its error argument,
its scratch and its bound on the card: order-free, bitwise equal to its
model ``segment_sum_fixed_point`` (a CSR built with integer atomics; each
(segment, column) rounded to int64 multiples of one power of two and added
as integers), so the result repeats bit for bit and does not depend on the
order of the edges. A CUDA tensor launches the kernel or raises; a CPU tensor
runs ``segment_sum_plain``, which the tests hold against the JAX package.
``chip_smoke.py`` holds the kernel against the model bit for bit and within a
sequential f32 sum's error of the float64 plain version. Launches count into
``LAUNCH_COUNTS["segment_sum"]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_COUNTS, build, raise_on_launch_error

INT32_MAX = 2**31 - 1

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             _P, _P, _P]
_ENTRIES = {torch.int64: "segment_sum_launch_i64", torch.int32: "segment_sum_launch_i32"}
_SCRATCH_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]


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


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k in float64, exactly, for integer k in [-1022, 1023]."""
    return ((k.long() + 1023) << 52).view(torch.float64)


def segment_sum_fixed_point(data: torch.Tensor, ids: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """The kernel's arithmetic on the CPU (float32 data; int64 and float64
    inside), which K2 equals bit for bit; ``csrc/segment_sum.cu`` gives the
    error argument. Per (segment, column) with deg edges: e_max, the largest
    biased exponent of the finite values (a zero or denormal counts as 1);
    H = 62 - bitlen(deg); each value rounded half to even to an int64
    multiple of u = 2^(e_max - 126 - H); the integers added; their sum
    rounded to float64, times u, rounded to float32. A NaN, or both
    infinities, give NaN; one infinity gives itself. Tests and
    ``chip_smoke.py`` use it; the main path never does."""
    if data.dtype != torch.float32:
        raise ValueError(f"the model takes float32 data, got {data.dtype}")
    data, ids = data.detach().cpu(), ids.cpu().long()
    b, e, d = data.shape
    rows = torch.arange(b)[:, None] * num_segments + ids
    rows = torch.where((ids >= 0) & (ids < num_segments), rows, b * num_segments).reshape(-1)
    x = data.reshape(b * e, d)
    bits = x.view(torch.int32)
    ebits = (bits >> 23) & 0xFF
    finite = ebits != 0xFF
    nseg = b * num_segments + 1
    emax = torch.ones(nseg, d, dtype=torch.int64).scatter_reduce_(
        0, rows[:, None].expand(-1, d), torch.where(finite, ebits, 1).long(), "amax")
    deg = torch.zeros(nseg, dtype=torch.int64).index_add_(0, rows, torch.ones_like(rows))
    h = 62 - torch.frexp(deg.clamp(min=1).double()).exponent.long()
    k = emax - 126 - h[:, None]  # u = 2^k
    q = torch.round(x.double() * _pow2(-k)[rows])
    q = torch.where(finite, q, 0.0).long()
    acc = torch.zeros(nseg, d, dtype=torch.int64).index_add_(0, rows, q)
    # int64 -> float64 rounded once: both halves convert exactly
    total = (acc >> 32).double() * 2.0**32 + (acc & 0xFFFFFFFF).double()
    out = (total * _pow2(k)).float()

    def has(flag):
        return torch.zeros(nseg, d, dtype=torch.int64).index_add_(0, rows, flag.long()) > 0

    nan, pos, neg = has(x.isnan()), has(x == float("inf")), has(x == float("-inf"))
    out = torch.where(pos, float("inf"), out)
    out = torch.where(neg, float("-inf"), out)
    out = torch.where(nan | (pos & neg), float("nan"), out)
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
    nbytes = build.function("segment_sum", "segment_sum_scratch_bytes", _SCRATCH_ARGTYPES,
                            restype=ctypes.c_longlong)(b, e, num_segments, d)
    scratch = torch.empty((nbytes + 7) // 8, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        # read here, not cached: autograd runs backward on its own thread
        stream = torch.cuda.current_stream().cuda_stream
        err = build.function("segment_sum", _ENTRIES[ids.dtype], _ARGTYPES)(
            data.data_ptr(), ids.data_ptr(), b, e, num_segments, d, scratch.data_ptr(),
            out.data_ptr(), stream)
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
