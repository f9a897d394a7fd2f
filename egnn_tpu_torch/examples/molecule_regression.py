"""Molecular property regression on the sparse path (anchor 5): batched
variable-size molecules packed into one node set, kNN edges, an
``EGNNSparseNetwork`` trunk and an invariant masked-mean readout. The
counterpart of ``examples/molecule_regression.py``.

The molecules are random (QM9 itself is a download): 8 to NA atoms of five
types with per-type charges, and a Coulomb-like target
E = sum_{i<j} q_i q_j / r_ij, invariant under rotations and translations.
Every shape is static: NA atom slots a molecule, K edges a node, masks for
the padding.

Three ways to feed it:
- by default each step draws its molecules on the host and builds their kNN
  edges on the card (``ops.graph.knn_graph``, one K3 launch a batch). The
  steps run in blocks of ``--block`` (10), as the JAX example runs a block
  as one jitted ``lax.scan``: a block's molecules are drawn on the host and
  copied to the card at once, the edge build and the step are captured
  together as one CUDA graph (``training.capture_step``) replayed for each
  step, and the block's losses are read back once (``--block 0``: eager
  calls; on the CPU the steps always run as calls);
- ``--qm9 FILE`` (``--make-qm9 FILE`` writes a synthetic one first): a
  QM9-format file through ``QM9Dataset``, edges built on the card;
- ``--host-graphs``: ``synthetic_molecule_batch_np`` builds whole batches,
  edges included, with the native host builder on a ``PrefetchLoader``
  worker, which copies them to the card while it steps.

``--qm9`` and ``--host-graphs`` step by calls and ignore ``--block``, as the
JAX example does. The batch of step i comes from a ``RandomState`` seeded by (``SEED``, i),
the weights from ``SEED``.

Run: python -m egnn_tpu_torch.examples.molecule_regression --steps 200
     [--device cpu] [--block 10] [--host-graphs | --qm9 FILE | --make-qm9 FILE]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from egnn_tpu_torch import EGNNSparseNetwork
from egnn_tpu_torch.models.init import ParamFactory, xavier_normal_init, zeros_init
from egnn_tpu_torch.ops.graph import knn_graph
from egnn_tpu_torch.ops.segment import segment_mean
from egnn_tpu_torch.training import (
    PrefetchLoader,
    TrainState,
    capture_step,
    make_adam,
    synthetic_molecule_batch_np,
    to_tensors,
)
from egnn_tpu_torch.training.data import MoleculeBatch, random_molecules
from egnn_tpu_torch.training.datasets import QM9Dataset, make_synthetic_qm9_file
from egnn_tpu_torch.utils.device import resolve_device

CHARGES = (-0.8, -0.3, 0.1, 0.5, 1.0)
SEED = 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--graphs", type=int, default=32, help="molecules a batch")
    ap.add_argument("--na", type=int, default=32, help="atom slots a molecule")
    ap.add_argument("--knn", type=int, default=8)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--block", type=int, default=10,
                    help="steps a block on the default path: on the card the edge build and "
                    "step's CUDA graph replayed, the losses read once a block; 0 calls the "
                    "step eagerly")
    ap.add_argument("--host-graphs", action="store_true",
                    help="build batches on the host (native kNN, a prefetch thread)")
    ap.add_argument("--qm9", default=None, help="a QM9-format npz file")
    ap.add_argument("--make-qm9", default=None,
                    help="write a synthetic QM9-format npz here first, and train on it")
    ap.add_argument("--qm9-target", default=None,
                    help="the target's key in the file (default: the first of y/U0/targets/T)")
    return ap.parse_args(argv)


class Regressor(nn.Module):
    """``EGNNSparseNetwork`` trunk (one embedded type column of ``dim``,
    fourier 4, both norms, ``aggr="add"``, ``uniform_degree=K``,
    ``uniform_graph_size=NA``) and an invariant readout: the masked
    ``segment_mean`` of each molecule's features, then
    silu(pooled @ w1 + b1) @ w2 + b2."""

    def __init__(self, layers: int, dim: int, num_types: int, num_graphs: int,
                 node_capacity: int, k: int, device=None, generator=None):
        super().__init__()
        self.num_graphs = num_graphs
        self.trunk = EGNNSparseNetwork(
            n_layers=layers, feats_dim=1, embedding_nums=[num_types], embedding_dims=[dim],
            fourier_features=4, norm_feats=True, norm_coors=True, aggr="add",
            uniform_degree=k, uniform_graph_size=node_capacity,
            device=device, generator=generator)
        param = ParamFactory(self, device, torch.float32, generator)
        param("head_w1", xavier_normal_init, (dim, dim))
        param("head_b1", zeros_init, (dim,))
        param("head_w2", xavier_normal_init, (dim, 1))
        param("head_b2", zeros_init, (1,))

    def forward(self, x, edge_index, edge_mask, batch_ids, node_mask):
        out = self.trunk(x, edge_index, batch=batch_ids,
                         edge_mask=edge_mask & node_mask[edge_index[1]],
                         num_graphs=self.num_graphs, node_mask=node_mask)
        feats = torch.where(node_mask[:, None], out[:, 3:], 0.0)
        pooled = segment_mean(feats, batch_ids, self.num_graphs, mask=node_mask)
        h = F.silu(pooled @ self.head_w1 + self.head_b1)
        return (h @ self.head_w2 + self.head_b2)[:, 0]


def make_train_step(model: Regressor, optimizer: torch.optim.Optimizer):
    """``step(batch) -> (mse, mae)``: zero-grad, forward, the MSE against
    ``batch.target``, backward, optimizer step (its ``TrainState`` is
    ``step.state``). Nothing is read back."""
    state = TrainState(model, optimizer)

    def step(batch: MoleculeBatch):
        optimizer.zero_grad(set_to_none=True)
        pred = model(batch.x, batch.edge_index, batch.edge_mask, batch.batch_ids,
                     batch.node_mask)
        err = pred - batch.target
        loss = (err ** 2).mean()
        loss.backward()
        state.apply_gradients()
        return loss.detach(), err.detach().abs().mean()

    step.state = state
    return step


def pack_on_device(coors, types, node_mask, target, k: int) -> MoleculeBatch:
    """(G, NA) padded molecules (tensors on one device) -> the packed
    (G * NA,) layout, each molecule's kNN edges built on that device by
    ``knn_graph(graph_size=NA)`` (K3 on the card)."""
    g, na = types.shape
    n = g * na
    nm = node_mask.reshape(n)
    es = knn_graph(coors.reshape(n, 3), k, node_mask=nm, graph_size=na)
    x = torch.cat([coors.reshape(n, 3), types.reshape(n, 1).to(coors.dtype)], dim=-1)
    batch_ids = torch.arange(g, device=coors.device).repeat_interleave(na)
    return MoleculeBatch(x=x, edge_index=es.edge_index, edge_mask=es.mask,
                         batch_ids=batch_ids, node_mask=nm, target=target)


def raw_molecules(step: int, G: int, NA: int) -> tuple:
    """Step ``step``'s ``random_molecules``, drawn on the host from
    RandomState((SEED, step)): (coors, types, node_mask, target) arrays."""
    types, sizes, coors, target = random_molecules(np.random.RandomState([SEED, step]), G, NA,
                                                   len(CHARGES), CHARGES)
    return coors, types, np.arange(NA)[None, :] < sizes[:, None], target


def device_batch(step: int, G: int, NA: int, k: int, device) -> MoleculeBatch:
    """Step ``step``'s molecules, packed with edges built on ``device``."""
    return pack_on_device(*to_tensors(raw_molecules(step, G, NA), device), k)


def device_blocks(steps: range, block: int, G: int, NA: int, device):
    """The raw molecules of ``steps`` in blocks of ``block`` steps: each
    block's arrays stacked on the host and copied to ``device`` at once;
    yields one list of (coors, types, node_mask, target) tensors a block."""
    for first in range(steps.start, steps.stop, block):
        host = [raw_molecules(i, G, NA) for i in range(first, min(first + block, steps.stop))]
        fields = to_tensors([np.stack(f) for f in zip(*host)], device)
        yield [tuple(f[j] for f in fields) for j in range(len(host))]


def host_batch(step: int, G: int, NA: int, k: int) -> MoleculeBatch:
    """Step ``step``'s batch built on the host, native kNN edges included
    (numpy arrays): the same molecules as ``device_batch``'s."""
    return synthetic_molecule_batch_np(np.random.RandomState([SEED, step]), G, NA, k)


def main(argv=None) -> dict:
    """Train; returns a summary (also printed as the last line, ``SUMMARY``
    and a JSON object)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    G, NA, K = args.graphs, args.na, args.knn
    qm9 = None
    if args.make_qm9:
        make_synthetic_qm9_file(args.make_qm9, max_atoms=min(NA, 29), seed=SEED)
        args.qm9 = args.qm9 or args.make_qm9
        print(f"wrote a synthetic QM9-format file: {args.make_qm9}")
    if args.qm9:
        qm9 = QM9Dataset.load(args.qm9, target_key=args.qm9_target)
        qm9_y, qm9_mu, qm9_sd = qm9.normalized_targets()
        print(f"QM9 file: {qm9.num_molecules} molecules, at most {qm9.max_atoms} atoms; "
              f"target mean {qm9_mu:.3f}, sd {qm9_sd:.3f}")
    num_types = len(QM9Dataset.ATOMIC_NUMBERS) + 1 if qm9 is not None else len(CHARGES)
    model = Regressor(args.layers, args.dim, num_types, G, NA, K, device=device,
                      generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(model, make_adam(model.parameters(), args.lr))
    blocks = qm9 is None and not args.host_graphs
    print(f"device {device}; params: {sum(p.numel() for p in model.parameters()):,}")

    loader = None
    if qm9 is not None:
        def batches():
            for i in range(args.steps):
                coors, types, nmask, y = qm9.batch(np.random.RandomState([SEED, i]), G, NA,
                                                   targets=qm9_y)
                yield pack_on_device(*to_tensors((coors, types, nmask, y), device), K)
        source = batches()
    elif args.host_graphs:
        from egnn_tpu_torch import native

        print(f"host graph builder: native={native.is_available()} "
              f"threads={native.num_threads()}")
        upcoming = iter(range(args.steps))
        loader = PrefetchLoader(lambda: host_batch(next(upcoming), G, NA, K),
                                depth=2, num_batches=args.steps, device=device)
        source = loader
    else:
        def packed_step(coors, types, node_mask, target):
            return step(pack_on_device(coors, types, node_mask, target, K))

        run_step = packed_step if args.block == 0 else capture_step(packed_step, step.state)
        source = ([run_step(*raw) for raw in block]
                  for block in device_blocks(range(args.steps), max(1, args.block), G, NA,
                                             device))

    every = max(1, args.steps // 10)
    losses, maes, pending = [], [], []
    first_block = (0.0, 0)   # (seconds, steps) of the first block: a capture's cost
    t0 = time.perf_counter()
    groups = iter(source if blocks else ([step(batch)] for batch in source))
    try:
        following = next(groups, None)
        while following is not None:
            # the next block is queued on the card before this one is read
            outs, following = following, next(groups, None)
            pending += outs
            last = len(losses) + len(pending) - 1
            if not (blocks or last % every == 0 or last == args.steps - 1):
                continue
            # a block's (or, by calls, a printed step's) one read
            values = torch.stack([torch.stack(o) for o in pending]).tolist()
            pending = []
            if not losses:
                first_block = (time.perf_counter() - t0, len(values))
            for i, (loss, mae) in enumerate(values, start=len(losses)):
                losses.append(loss)
                maes.append(mae)
                if i % every == 0 or i == args.steps - 1:
                    print(f"step {i:5d}  mse {loss:9.4f}  mae {mae:8.4f}")
    finally:
        if loader is not None:
            loader.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    eps = args.steps * G * NA * K * args.layers / seconds
    print(f"{args.steps} steps in {seconds:.2f} s ({eps / 1e6:.3f} M edges/s, the graph "
          f"build included)")
    summary = {"device": str(device), "steps": args.steps,
               "block": args.block if blocks else None, "seconds": seconds,
               "edges_per_s": eps, "first_block_seconds": first_block[0],
               "first_block_steps": first_block[1], "losses": losses, "maes": maes}
    print("SUMMARY " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
