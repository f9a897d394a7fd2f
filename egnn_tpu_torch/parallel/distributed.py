"""The process runtime: process-group set-up, coordinator-only logging and
metrics, barriers. The counterpart of ``egnn_tpu/parallel/distributed.py``,
where the JAX runtime is the communication backend; here it is
``torch.distributed`` with NCCL on the card and gloo on the CPU.

- ``initialize()``: ``init_process_group`` from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) or explicit
  arguments; idempotent, and a no-op where nothing is configured. On the
  card the process is bound to ``cuda:LOCAL_RANK % device_count``.
- ``is_coordinator()``: global rank 0 (or no process group at all).
- ``log0()``: print on the coordinator only.
- ``MetricLogger``: structured JSONL metrics, coordinator-only.
- ``sync_global_devices()``: a barrier over every process.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> Optional[torch.device]:
    """Bring up the default process group (idempotent); returns this
    process's device, or ``None`` where nothing is configured.

    ``world_size`` and ``rank`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK``, the local rank to ``LOCAL_RANK`` (else the rank),
    ``init_method`` to ``"env://"`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); a ``"file://..."`` method holds the group's store in a
    file. Without an ``init_method``, a ``WORLD_SIZE`` or a ``world_size``,
    nothing is configured and the call does nothing. ``backend=None`` takes
    NCCL for the card (``device``, the card unless ``"cpu"``) and gloo for
    the CPU; on the card the process is bound to ``cuda:(local rank) %
    device_count`` before the group comes up.
    """
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and world_size is None:
        return None
    dev = resolve_device(device)
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method or "env://",
                                world_size=world_size or 1, rank=rank)
    return dev


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def log0(*args, **kwargs) -> None:
    """``print`` on the coordinator only."""
    if is_coordinator():
        print(*args, **kwargs)


def sync_global_devices(tag: str = "barrier") -> None:
    """A barrier over every process (e.g. around checkpoint writes); nothing
    without a group of more than one. ``tag`` names it, as in the JAX
    package, and is not used."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class MetricLogger:
    """Append-only JSONL metrics, written by the coordinator only.

    Host scalars are written and flushed at once, so a killed run keeps its
    history. A 0-d tensor is not read per call (``float(t)`` on a card
    tensor would stall the step loop on every step): records holding one
    are buffered and read with one batched copy every ``flush_every``
    records, and on ``flush()`` / ``close()``, the design of the JAX
    package's logger. Each record carries its step and the seconds since
    the logger was made.
    """

    def __init__(self, path: Optional[str] = None, flush_every: int = 32):
        self._f = None
        self._t0 = time.time()
        self._flush_every = max(1, int(flush_every))
        self._pending: list = []
        if path is not None and is_coordinator():
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, step: int, **metrics: Any) -> Mapping[str, Any]:
        rec: dict = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        deferred = False
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.dim() == 0:
                rec[k] = v.detach()
                deferred = True
            else:
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    rec[k] = v
        if deferred:
            self._pending.append(rec)
            if len(self._pending) >= self._flush_every:
                self.flush()
        elif self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
        return rec

    def flush(self) -> None:
        """Read the buffered tensors (one copy) and write their records."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        slots = [(rec, k) for rec in pending for k, v in rec.items()
                 if isinstance(v, torch.Tensor)]
        dev = slots[0][0][slots[0][1]].device
        values = torch.stack([rec[k].to(device=dev, dtype=torch.float64)
                              for rec, k in slots]).tolist()
        for (rec, k), v in zip(slots, values):
            rec[k] = v
        if self._f is not None:
            for rec in pending:
                self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self.flush()
        if self._f is not None:
            self._f.close()
            self._f = None
