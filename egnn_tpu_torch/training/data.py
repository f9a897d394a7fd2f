"""The input pipeline: synthetic chain batches (the denoising workload's
inputs, and the requests ``chip_smoke.py`` serves), packed molecule batches
built on the host, and the loader that builds batches on a worker thread and
copies them to the card.

Counterparts of ``egnn_tpu/training/data.py``:

- ``synthetic_chain_batch``: the same shapes and distributions (random-walk
  'backbone' chains, denoise_sparse.py:48-74), drawn from a numpy
  ``Generator`` instead of a JAX key; the chain adjacency is
  ``ops/graph.py:chain_adjacency``;
- ``MoleculeBatch``, ``random_molecules`` and
  ``synthetic_molecule_batch_np``: random molecules with a Coulomb-like
  target, kNN edges from the native host builder
  (``egnn_tpu_torch.native``), numpy in and out, bit for bit the JAX
  package's from the same ``RandomState``;
- ``to_tensors``: a batch of numpy arrays as tensors on a device;
- ``PrefetchLoader``: the worker thread that overlaps the host's batch
  building and copies with the card's steps; with ``shard=`` (a mesh or a
  process group) it hands each rank its block of every batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..ops.graph import chain_adjacency
from ..parallel.mesh import rank_block_index
from ..utils.device import resolve_device


class DenoiseBatch(NamedTuple):
    tokens: torch.Tensor        # (b, n) int64
    clean_coors: torch.Tensor   # (b, n, 3)
    noised_coors: torch.Tensor  # (b, n, 3)
    mask: torch.Tensor          # (b, n) bool
    adj_mat: torch.Tensor       # (n, n) bool, chain i ~ i±1


def synthetic_chain_batch(
    rng: np.random.Generator,
    batch: int,
    n: int,
    num_tokens: int = 21,
    noise_std: float = 1.0,
    step_std: float = 1.2,
    min_len_frac: float = 0.6,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> DenoiseBatch:
    """Random-walk chains with variable valid lengths: coordinates are
    cumulative Gaussian steps, centred, plus Gaussian noise; the mask keeps
    a random prefix of at least ``min_len_frac * n`` nodes."""
    dev = resolve_device(device)
    tokens = rng.integers(0, num_tokens, size=(batch, n))
    steps = step_std * rng.standard_normal((batch, n, 3))
    clean = np.cumsum(steps, axis=1)
    clean = clean - clean.mean(axis=1, keepdims=True)
    noised = clean + noise_std * rng.standard_normal((batch, n, 3))
    lengths = rng.integers(int(n * min_len_frac), n + 1, size=(batch, 1))
    mask = np.arange(n)[None, :] < lengths
    return DenoiseBatch(
        tokens=torch.as_tensor(tokens, dtype=torch.int64, device=dev),
        clean_coors=torch.as_tensor(clean, dtype=dtype, device=dev),
        noised_coors=torch.as_tensor(noised, dtype=dtype, device=dev),
        mask=torch.as_tensor(mask, device=dev),
        adj_mat=chain_adjacency(n, device=dev),
    )


class MoleculeBatch(NamedTuple):
    """A packed variable-size molecule batch in the sparse path's layout
    (x = [coors | feats], COO edges, batch vector: the PyG convention of the
    reference's sparse stack, egnn_pytorch_geometric.py:182-191). Its fields
    are tensors, or numpy arrays where a host builder made them."""

    x: torch.Tensor           # (G*NA, 3+1) coordinates and a raw type column
    edge_index: torch.Tensor  # (2, G*NA*K) [senders; receivers]
    edge_mask: torch.Tensor   # (G*NA*K,) bool
    batch_ids: torch.Tensor   # (G*NA,) graph ids
    node_mask: torch.Tensor   # (G*NA,) bool
    target: torch.Tensor      # (G,) regression target


def random_molecules(rng: np.random.RandomState, num_graphs: int, node_capacity: int,
                     num_types: int = 5, charges=(-0.8, -0.3, 0.1, 0.5, 1.0)):
    """(types (G, NA), sizes (G,) int32, coors (G, NA, 3), target (G,)):
    random molecules of 8 to ``node_capacity`` atoms (coordinates 2 N(0, 1)
    in float64) and their Coulomb-like invariant energy
    E = sum_{i<j} q_i q_j / r_ij over the valid atoms, drawn from ``rng`` in
    the JAX package's order."""
    G, NA = num_graphs, node_capacity
    types = rng.randint(0, num_types, size=(G, NA))
    sizes = rng.randint(min(8, NA), NA + 1, size=G).astype(np.int32)
    coors = 2.0 * rng.randn(G, NA, 3)
    q = np.asarray(charges)[types]
    nm2 = np.arange(NA)[None, :] < sizes[:, None]
    pm = nm2[:, :, None] & nm2[:, None, :]
    pm &= ~np.eye(NA, dtype=bool)[None]
    rel = coors[:, :, None, :] - coors[:, None, :, :]
    r = np.sqrt(np.clip(np.sum(rel**2, -1), 1e-2, None))
    e_pair = q[:, :, None] * q[:, None, :] / r
    target = 0.5 * np.where(pm, e_pair, 0.0).sum(axis=(1, 2))
    return types, sizes, coors, target


def synthetic_molecule_batch_np(
    rng: np.random.RandomState,
    num_graphs: int,
    node_capacity: int,
    k: int,
    num_types: int = 5,
    charges=(-0.8, -0.3, 0.1, 0.5, 1.0),
) -> MoleculeBatch:
    """A molecule batch built on the host (numpy and the native graph
    builder): ``random_molecules``, packed by ``native.pack_batch_np``, kNN
    edges from ``native.batched_knn_graph_np``. This is the input path of a
    real dataset: the graphs are built on host threads while the card steps
    (``PrefetchLoader``), as the reference's sparse examples feed PyG graphs
    built by torch-cluster (examples/egnn_test.ipynb cell 4). numpy arrays
    out (float64 coordinates and target, int32 ids)."""
    from .. import native as nat

    G, NA = num_graphs, node_capacity
    types, sizes, coors, target = random_molecules(rng, G, NA, num_types, charges)
    batch_ids, node_mask = nat.pack_batch_np(sizes, NA)
    senders, receivers, edge_mask = nat.batched_knn_graph_np(
        coors, k, node_mask=node_mask.reshape(G, NA))
    x = np.concatenate(
        [coors.reshape(G * NA, 3), types.reshape(G * NA, 1).astype(np.float64)], axis=-1)
    return MoleculeBatch(
        x=x,
        edge_index=np.stack([senders, receivers]),
        edge_mask=edge_mask,
        batch_ids=batch_ids,
        node_mask=node_mask,
        target=target,
    )


def _tensor(a, device, pin: bool) -> torch.Tensor:
    t = torch.as_tensor(a)
    if t.is_floating_point():
        t = t.to(torch.float32)
    elif t.dtype != torch.bool:
        t = t.to(torch.int64)
    if pin:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _map_arrays(batch, fn):
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return fn(batch)
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_map_arrays(v, fn) for v in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_arrays(v, fn) for v in batch)
    if isinstance(batch, dict):
        return {k: _map_arrays(v, fn) for k, v in batch.items()}
    return batch


# the fields of a batch that every rank takes whole: the dense batch's
# (n, n) adjacency, which no rank's block of the batch cuts
_WHOLE_FIELDS = ("adj_mat",)


def _rank_block(batch, index: int, count: int):
    """Block ``index`` of ``count`` of every array's leading dimension, the
    fields (of a named tuple or dict) named in ``_WHOLE_FIELDS`` left
    whole."""
    def cut(a):
        if a.shape[0] % count:
            raise ValueError(f"a leading dimension of {a.shape[0]} does not split into "
                             f"{count} blocks")
        rows = a.shape[0] // count
        return a[index * rows:(index + 1) * rows]

    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(v if f in _WHOLE_FIELDS else _map_arrays(v, cut)
                             for f, v in zip(batch._fields, batch)))
    if isinstance(batch, dict):
        return {k: v if k in _WHOLE_FIELDS else _map_arrays(v, cut) for k, v in batch.items()}
    return _map_arrays(batch, cut)


def to_tensors(batch, device=None):
    """A batch (an array, or a named tuple, tuple, list or dict of them) as
    tensors on ``device`` (the card unless the caller passes
    ``device="cpu"``): floating arrays become float32 (as JAX's
    ``device_put`` stores them without x64), integer arrays int64 (torch's
    index type), bools stay. Anything else passes through."""
    dev = resolve_device(device)
    return _map_arrays(batch, lambda a: _tensor(a, dev, pin=False))


class PrefetchLoader:
    """Batches built on a worker thread and copied to the card ahead of the
    step that uses them, the counterpart of
    ``egnn_tpu/training/data.py:PrefetchLoader``.

    The worker calls ``make_batch()`` (numpy arrays, e.g.
    ``synthetic_molecule_batch_np`` with the native graph builder), copies
    each array into pinned host memory and from there to the card with
    ``non_blocking=True`` on a side CUDA stream, records an event there, and
    queues the batch, keeping up to ``depth`` ready. ``__next__`` makes the
    caller's current stream wait on that event before it returns the batch
    (and marks the tensors as used on that stream, so that the allocator
    keeps them until its work is done): the host builds and copies batch
    i + 1 while the card runs step i. Conversions are ``to_tensors``'s.
    With ``device="cpu"`` the worker only converts to tensors.

    The worker's exception comes out of ``__next__`` as a ``RuntimeError``
    chained to it; it is never swallowed. Iteration stops after
    ``num_batches``. ``close()`` stops the worker, drains the queue and
    joins the thread.

    ``shard`` (a ``DeviceMesh`` or a process group; the counterpart of the
    JAX loader's ``sharding=``): every rank runs its own loader over the
    same stream of batches, and the worker cuts this rank's block of each
    array's leading dimension (over the mesh's flattened axes, as
    ``parallel.sparse_node_block`` does) before the pinned copy, so that a
    rank copies its own rows only. A field named ``adj_mat`` (of a named
    tuple or a dict: the dense batch's adjacency) goes to every rank whole.
    """

    def __init__(
        self,
        make_batch: Callable[[], object],
        depth: int = 2,
        num_batches: Optional[int] = None,
        device=None,
        shard=None,
    ):
        self._make = make_batch
        self._block = None if shard is None else rank_block_index(shard)
        self._n = num_batches
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device) if self._device.type == "cuda"
                        else None)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._done = object()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, batch):
        if self._stream is None:
            return to_tensors(batch, self._device), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            out = _map_arrays(batch, lambda a: _tensor(a, self._device, pin=True))
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self):
        produced = 0
        try:
            while not self._stop.is_set():
                if self._n is not None and produced >= self._n:
                    self._put(self._done)
                    return
                batch = self._make()
                if self._block is not None:
                    batch = _rank_block(batch, *self._block)
                self._put(self._to_device(batch))
                produced += 1
        except BaseException as e:  # raised again in __next__, never swallowed
            self._error = e

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    if self._error is not None:
                        raise RuntimeError("PrefetchLoader worker failed") from self._error
                    raise StopIteration
        if item is self._done:
            raise StopIteration
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            _map_arrays(batch, lambda t: t.record_stream(stream))
        return batch

    def close(self) -> None:
        self._stop.set()
        try:  # drain, so that a worker blocked on a full queue sees the stop
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
