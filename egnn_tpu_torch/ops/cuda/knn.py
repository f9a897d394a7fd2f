"""Kernels K1 (selection + payload gather) and K3 (selection only) and their
plain PyTorch versions. Launches count into ``LAUNCH_COUNTS`` (``ops/cuda``).

- K1 ``knn_select_gather`` replaces the TPU kernel
  ``egnn_tpu/ops/pallas/knn.py:knn_select_gather_pallas``
  (``_knn_gather_kernel``).
- K3 ``knn_select`` replaces ``egnn_tpu/ops/pallas/knn.py:knn_select_pallas``
  (``_knn_kernel``).

Both run ``csrc/knn_select.cu`` (one template, ``kPayload`` on or off); its
header says what bounds it on the card and how the design meets that. A
wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the plain version, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import neighbors as nb
from ..core import gather_nodes
from . import LAUNCH_COUNTS, build
from . import raise_on_launch_error as _raise_on

MAX_K = 128       # the TPU full-band kernels' reach: 1 <= k <= 128, n <= 16384
MAX_N = 16384
MAX_C = 16        # kMaxC in csrc/knn_select.cu


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def knn_select_plain(coors, k, mask=None, adj_mat=None):
    """(vals, idx), each (b, n, k): the k smallest rankings per row."""
    _, rel_dist = nb.pairwise_geometry(coors)
    nbhd = nb.select_neighborhood(nb.knn_ranking(rel_dist, mask, adj_mat), k, math.inf)
    return nbhd.ranking, nbhd.indices


def knn_select_gather_plain(coors, k, table, mask=None, adj_mat=None):
    """(vals, idx, rows): ``knn_select_plain`` plus the (b, n, k, tw) rows of
    ``table`` at the winners."""
    vals, idx = knn_select_plain(coors, k, mask, adj_mat)
    return vals, idx, gather_nodes(table, idx)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "knn_select_gather_launch": [_P, _P, _P, ctypes.c_longlong, _P, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P],
    "knn_select_launch": [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P],
}


def _entry(name: str):
    return build.function("knn_select", name, _ARGTYPES[name])


def _check_inputs(coors, k, mask, adj_mat):
    """Validate what the kernel takes; returns (mask_ptr, adj_ptr,
    adj_batch_stride, the tensors behind the pointers)."""
    if coors.dim() != 3 or coors.dtype != torch.float32 or not coors.is_contiguous():
        raise ValueError(f"coors must be a contiguous (b, n, c) float32 tensor, "
                         f"got {tuple(coors.shape)} {coors.dtype}")
    b, n, c = coors.shape
    if not (1 <= k <= MAX_K and k <= n <= MAX_N and 1 <= c <= MAX_C):
        raise ValueError(f"kernel supports 1 <= k <= {MAX_K}, k <= n <= {MAX_N}, "
                         f"1 <= c <= {MAX_C}; got k={k}, n={n}, c={c}")
    dev = coors.device
    keep = []
    mask_ptr = adj_ptr = None
    adj_bstride = 0
    if mask is not None:
        if mask.shape != (b, n) or mask.dtype != torch.bool or mask.device != dev:
            raise ValueError("mask must be a (b, n) bool tensor on the coors' device")
        mask = mask.contiguous()
        keep.append(mask)
        mask_ptr = mask.data_ptr()
    if adj_mat is not None:
        if (adj_mat.shape != (b, n, n) or adj_mat.dtype != torch.bool
                or adj_mat.device != dev):
            raise ValueError("adj_mat must be a (b, n, n) bool tensor on the coors' device")
        if adj_mat.stride(1) != n or adj_mat.stride(2) != 1:
            adj_mat = adj_mat.contiguous()
        keep.append(adj_mat)
        adj_ptr = adj_mat.data_ptr()
        adj_bstride = adj_mat.stride(0)  # 0 for one (n, n) expanded over b
    return mask_ptr, adj_ptr, adj_bstride, keep


def _launch_knn_select_gather(coors, k, table, mask, adj_mat):
    # `keep` holds any contiguous copies behind the pointers until the launch
    mask_ptr, adj_ptr, adj_bstride, keep = _check_inputs(coors, k, mask, adj_mat)
    b, n, c = coors.shape
    if (table.dim() != 3 or table.shape[:2] != (b, n) or table.dtype != torch.float32
            or table.device != coors.device or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (b, n, tw) float32 tensor "
                         "on the coors' device")
    tw = table.shape[2]
    vals = torch.empty((b, n, k), dtype=torch.float32, device=coors.device)
    idx = torch.empty((b, n, k), dtype=torch.int64, device=coors.device)
    rows = torch.empty((b, n, k, tw), dtype=torch.float32, device=coors.device)
    with torch.cuda.device(coors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("knn_select_gather_launch")(
            coors.data_ptr(), mask_ptr, adj_ptr, adj_bstride, table.data_ptr(),
            b, n, c, k, tw, vals.data_ptr(), idx.data_ptr(), rows.data_ptr(), stream)
    _raise_on(err, "knn_select_gather")
    LAUNCH_COUNTS["knn_select_gather"] += 1
    return vals, idx, rows


def _launch_knn_select(coors, k, mask, adj_mat):
    mask_ptr, adj_ptr, adj_bstride, keep = _check_inputs(coors, k, mask, adj_mat)
    b, n, c = coors.shape
    vals = torch.empty((b, n, k), dtype=torch.float32, device=coors.device)
    idx = torch.empty((b, n, k), dtype=torch.int64, device=coors.device)
    with torch.cuda.device(coors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("knn_select_launch")(
            coors.data_ptr(), mask_ptr, adj_ptr, adj_bstride, b, n, c, k,
            vals.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "knn_select")
    LAUNCH_COUNTS["knn_select"] += 1
    return vals, idx


def knn_select_gather(
    coors: torch.Tensor,
    k: int,
    table: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
):
    """K1: (vals (b, n, k), idx (b, n, k) int64, rows (b, n, k, tw)).

    coors (b, n, c) and table (b, n, tw) float32, mask (b, n) bool, adj_mat
    (b, n, n) bool (an expanded (n, n) is read without a copy). A CUDA tensor
    launches the kernel; a CPU tensor runs ``knn_select_gather_plain``.
    """
    if coors.is_cuda:
        return _launch_knn_select_gather(coors, k, table, mask, adj_mat)
    if coors.device.type != "cpu":
        raise ValueError(f"no kNN kernel for device {coors.device}")
    return knn_select_gather_plain(coors, k, table, mask, adj_mat)


def knn_select(
    coors: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
):
    """K3: (vals, idx), the selection of ``knn_select_gather`` without rows."""
    if coors.is_cuda:
        return _launch_knn_select(coors, k, mask, adj_mat)
    if coors.device.type != "cpu":
        raise ValueError(f"no kNN kernel for device {coors.device}")
    return knn_select_plain(coors, k, mask, adj_mat)
