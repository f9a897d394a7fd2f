"""The host-side graph runtime: C++ through ctypes, compiled at first use.

Datasets arrive as numpy arrays, and building kNN and radius graphs, sorting
edges by receiver and packing variable-size graphs into a batch is host work
(the role of torch-cluster and torch-scatter in the reference's sparse
examples, examples/egnn_test.ipynb cell 4) that should run in native code on
the host's threads while the card steps. The counterpart of
``egnn_tpu/native``, with its own copy of the source,
``graph_builder.cc``.

The library is built at the first call with the host's ``g++``
(``-O3 -std=c++17 -shared -fPIC``, with ``-fopenmp`` where it links, else
without) into ``build/egnn_tpu_torch/native/`` at the root of the checkout
(into ``~/.cache/egnn_tpu_torch/native/`` where the package is installed and
not in a checkout), named by a hash of the source, the flags, the
compiler's version and the platform, so a library built on another host or
by another compiler is never loaded. Each process compiles to a file of its own and
renames it into place, so processes that build at once (test workers, data
workers) never load half a file. Without a compiler, ``is_available()`` is
False, ``build_error()`` says why, and numpy versions of each function give
the same results, slower.

Every function takes and returns numpy arrays and matches
``egnn_tpu_torch.ops.graph``'s builders on the same inputs: squared-distance
ranking, the lower index first among ties, the 1e10 fill of invalid pairs,
padding rows at node 0 (at the owning graph's first node in the batched
layout).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).with_name("graph_builder.cc")
_ROOT = Path(__file__).resolve().parents[2]
_BUILD_DIR = (_ROOT / "build" / "egnn_tpu_torch" / "native"
              if (_ROOT / "pyproject.toml").is_file() and (_ROOT / "egnn_tpu_torch").is_dir()
              else Path.home() / ".cache" / "egnn_tpu_torch" / "native")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _compile() -> Optional[ctypes.CDLL]:
    global _build_error
    try:
        version = subprocess.run(["g++", "--version"], check=True, capture_output=True,
                                 timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        _build_error = f"g++ --version failed: {e}"
        return None
    key = [_SRC.read_bytes(), " ".join(_FLAGS).encode(), version,
           f"{platform.system()} {platform.machine()}".encode()]
    tag = hashlib.sha256(b"\0".join(key)).hexdigest()[:16]
    so_path = _BUILD_DIR / f"graph_builder_{tag}.so"
    if not so_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp_path = so_path.with_suffix(f".tmp{os.getpid()}")
        last_err = ""
        for extra in (["-fopenmp"], []):
            try:
                subprocess.run(["g++", *_FLAGS, *extra, str(_SRC), "-o", str(tmp_path)],
                               check=True, capture_output=True, timeout=120)
            except subprocess.CalledProcessError as e:
                last_err = e.stderr.decode(errors="replace")
            except (FileNotFoundError, subprocess.TimeoutExpired) as e:
                last_err = str(e)
            else:
                os.replace(tmp_path, so_path)
                break
        else:
            _build_error = last_err
            return None
    lib = ctypes.CDLL(str(so_path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c = ctypes
    lib.egnn_knn_graph.restype = c.c_int
    lib.egnn_knn_graph.argtypes = [f64p, c.c_int64, c.c_int, c.c_int,
                                   c.c_void_p, c.c_int, i32p, i32p, u8p]
    lib.egnn_batched_knn_graph.restype = c.c_int
    lib.egnn_batched_knn_graph.argtypes = [f64p, c.c_int64, c.c_int, c.c_int,
                                           c.c_int, c.c_void_p, c.c_int,
                                           i32p, i32p, u8p]
    lib.egnn_radius_graph.restype = c.c_int64
    lib.egnn_radius_graph.argtypes = [f64p, c.c_int64, c.c_int, c.c_double,
                                      c.c_int64, c.c_void_p, c.c_int,
                                      i32p, i32p, u8p]
    lib.egnn_sort_edges_by_receiver.restype = c.c_int
    lib.egnn_sort_edges_by_receiver.argtypes = [i32p, c.c_void_p, c.c_int64,
                                                c.c_int64, i32p]
    lib.egnn_pack_batch.restype = c.c_int
    lib.egnn_pack_batch.argtypes = [i32p, c.c_int64, c.c_int, i32p, u8p]
    lib.egnn_native_num_threads.restype = c.c_int
    lib.egnn_native_num_threads.argtypes = []
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and _build_error is None:
        with _lib_lock:
            if _lib is None and _build_error is None:
                _lib = _compile()
    return _lib


def is_available() -> bool:
    """True when the C++ runtime compiled and loaded."""
    return _get_lib() is not None


def build_error() -> Optional[str]:
    """The compiler's message if the build failed, else None."""
    _get_lib()
    return _build_error


def num_threads() -> int:
    """The OpenMP threads the library runs on (1 without OpenMP or library)."""
    lib = _get_lib()
    return lib.egnn_native_num_threads() if lib is not None else 1


def _mask_ptr(node_mask: Optional[np.ndarray]):
    """(the uint8 copy, its pointer); the caller keeps the copy alive while
    the library reads it."""
    if node_mask is None:
        return None
    m = np.ascontiguousarray(node_mask, dtype=np.uint8)
    return m, m.ctypes.data_as(ctypes.c_void_p)


_BIG = 1e10


def knn_graph_np(coors: np.ndarray, k: int,
                 node_mask: Optional[np.ndarray] = None,
                 loop: bool = False):
    """kNN edge list of (n, c) host coordinates: ``(senders, receivers,
    mask)``, each (n * k,), receiver-major, as ``ops.graph.knn_graph``
    builds it on the same inputs."""
    coors = np.ascontiguousarray(coors, dtype=np.float64)
    n, c = coors.shape
    lib = _get_lib()
    if lib is not None:
        senders = np.empty(n * k, dtype=np.int32)
        receivers = np.empty(n * k, dtype=np.int32)
        mask = np.empty(n * k, dtype=np.uint8)
        held = _mask_ptr(node_mask)
        rc = lib.egnn_knn_graph(coors, n, c, k,
                                None if held is None else held[1],
                                int(loop), senders, receivers, mask)
        if rc == 0:
            return senders, receivers, mask.astype(bool)
    return _knn_graph_numpy(coors, k, node_mask, loop)


def _knn_graph_numpy(coors, k, node_mask, loop):
    n = coors.shape[0]
    rel = coors[:, None, :] - coors[None, :, :]
    dist = np.sum(rel * rel, axis=-1)
    if not loop:
        np.fill_diagonal(dist, _BIG)
    if node_mask is not None:
        m = np.asarray(node_mask, dtype=bool)
        dist = np.where(m[:, None] & m[None, :], dist, _BIG)
    kk = min(k, n)
    idx = np.argsort(dist, axis=1, kind="stable")[:, :kk]  # ties -> lower j
    vals = np.take_along_axis(dist, idx, axis=1)
    valid = vals < _BIG
    if kk < k:  # slots beyond n are invalid, as in the C++ path
        idx = np.pad(idx, ((0, 0), (0, k - kk)))
        valid = np.pad(valid, ((0, 0), (0, k - kk)))
    senders = np.where(valid, idx, 0).astype(np.int32).reshape(-1)
    receivers = np.where(valid, np.arange(n)[:, None], 0).astype(np.int32).reshape(-1)
    return senders, receivers, valid.reshape(-1)


def batched_knn_graph_np(coors: np.ndarray, k: int,
                         node_mask: Optional[np.ndarray] = None,
                         loop: bool = False):
    """kNN within each graph of a packed (g, na, c) batch, ids offset into
    the packed node set: one call builds a molecule batch's edges (the
    layout of examples/molecule_regression.py:76-81 and of
    ``ops.graph.knn_graph(..., graph_size=na)``). Padding rows point at the
    owning graph's first node. Returns (senders, receivers, mask), each
    (g * na * k,)."""
    coors = np.ascontiguousarray(coors, dtype=np.float64)
    g, na, c = coors.shape
    lib = _get_lib()
    if lib is not None:
        senders = np.empty(g * na * k, dtype=np.int32)
        receivers = np.empty(g * na * k, dtype=np.int32)
        mask = np.empty(g * na * k, dtype=np.uint8)
        held = _mask_ptr(node_mask)
        rc = lib.egnn_batched_knn_graph(coors.reshape(g * na, c), g, na, c, k,
                                        None if held is None else held[1],
                                        int(loop), senders, receivers, mask)
        if rc == 0:
            return senders, receivers, mask.astype(bool)
    ss, rr, mm = [], [], []
    for gi in range(g):
        nm = None if node_mask is None else np.asarray(node_mask).reshape(g, na)[gi]
        s, r, m = _knn_graph_numpy(coors[gi], k, nm, loop)
        base = gi * na
        ss.append(np.where(m, s + base, base))
        rr.append(np.where(m, r + base, base))
        mm.append(m)
    return (np.concatenate(ss).astype(np.int32),
            np.concatenate(rr).astype(np.int32), np.concatenate(mm))


def radius_graph_np(coors: np.ndarray, radius: float, max_edges: int,
                    node_mask: Optional[np.ndarray] = None,
                    loop: bool = False):
    """Radius graph of static capacity ``max_edges``; over capacity it keeps
    the globally closest pairs; receiver-major. As ``ops.graph.radius_graph``."""
    coors = np.ascontiguousarray(coors, dtype=np.float64)
    n, c = coors.shape
    lib = _get_lib()
    if lib is not None:
        senders = np.empty(max_edges, dtype=np.int32)
        receivers = np.empty(max_edges, dtype=np.int32)
        mask = np.empty(max_edges, dtype=np.uint8)
        held = _mask_ptr(node_mask)
        ne = lib.egnn_radius_graph(coors, n, c, float(radius), max_edges,
                                   None if held is None else held[1],
                                   int(loop), senders, receivers, mask)
        if ne >= 0:
            return senders, receivers, mask.astype(bool)
    rel = coors[:, None, :] - coors[None, :, :]
    dist = np.sum(rel * rel, axis=-1)
    ok = dist <= radius**2
    if not loop:
        np.fill_diagonal(ok, False)
    if node_mask is not None:
        m = np.asarray(node_mask, dtype=bool)
        ok &= m[:, None] & m[None, :]
    flat = np.where(ok, dist, _BIG).reshape(-1)
    order = np.lexsort((np.arange(n * n), flat))[:max_edges]
    mask = flat[order] < _BIG
    order = np.sort(np.where(mask, order, n * n))
    mask = order < n * n
    order = np.where(mask, order, 0)
    receivers = np.where(mask, order // n, 0).astype(np.int32)
    senders = np.where(mask, order % n, 0).astype(np.int32)
    return senders, receivers, mask


def sort_edges_by_receiver_np(receivers: np.ndarray,
                              mask: Optional[np.ndarray],
                              num_nodes: int) -> np.ndarray:
    """The stable permutation that puts edges in receiver-major order,
    padding last. Apply it to every edge array."""
    receivers = np.ascontiguousarray(receivers, dtype=np.int32)
    e = receivers.shape[0]
    lib = _get_lib()
    if lib is not None:
        perm = np.empty(e, dtype=np.int32)
        held = _mask_ptr(mask)
        rc = lib.egnn_sort_edges_by_receiver(receivers,
                                             None if held is None else held[1],
                                             e, num_nodes, perm)
        if rc == 0:
            return perm
    key = receivers.astype(np.int64)
    if mask is not None:
        key = np.where(np.asarray(mask, dtype=bool), key, num_nodes)
    return np.argsort(key, kind="stable").astype(np.int32)


def pack_batch_np(sizes: np.ndarray, node_capacity: int):
    """Nodes a graph -> (batch_ids, node_mask), both (g * node_capacity,):
    the static-capacity form of PyG's batch vector
    (egnn_pytorch_geometric.py:189). Raises ``ValueError`` for a graph
    larger than ``node_capacity``."""
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    g = sizes.shape[0]
    lib = _get_lib()
    if lib is not None:
        batch_ids = np.empty(g * node_capacity, dtype=np.int32)
        node_mask = np.empty(g * node_capacity, dtype=np.uint8)
        rc = lib.egnn_pack_batch(sizes, g, node_capacity, batch_ids, node_mask)
        if rc == 0:
            return batch_ids, node_mask.astype(bool)
        raise ValueError(f"graph size exceeds node capacity {node_capacity}: "
                         f"{sizes.max()}")
    if sizes.max(initial=0) > node_capacity or sizes.min(initial=0) < 0:
        raise ValueError(f"graph size exceeds node capacity {node_capacity}: "
                         f"{sizes.max()}")
    batch_ids = np.repeat(np.arange(g, dtype=np.int32), node_capacity)
    node_mask = (np.tile(np.arange(node_capacity), g)
                 < np.repeat(sizes, node_capacity))
    return batch_ids, node_mask


__all__ = [
    "is_available",
    "build_error",
    "num_threads",
    "knn_graph_np",
    "batched_knn_graph_np",
    "radius_graph_np",
    "sort_edges_by_receiver_np",
    "pack_batch_np",
]
