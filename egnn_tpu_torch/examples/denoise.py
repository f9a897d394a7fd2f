"""Coordinate-denoising trainer: the reference's denoise_sparse.py workload
(denoise_sparse.py:23-78) on the port, the counterpart of
``examples/denoise.py``.

``EGNNNetwork`` depth 5, dim 32, 21 tokens, ``num_positions = n``, kNN 16,
fourier 2, ``norm_coors``, clamp 2.0, chain adjacency; Adam 1e-3 over 16
accumulated micro-steps; masked MSE; a micro-step whose new state or loss is
not finite is skipped (``utils.finite_or_skip_step``, on the device). Each
call of the step is one micro-step, and the batch of micro-step i comes
from a ``RandomState`` seeded by (``SEED``, i), so a resumed run sees the
batches an uninterrupted one would; the weights come from ``SEED`` too.

The micro-steps run in blocks of ``--block`` (10), as the JAX example runs
a block as one jitted ``lax.scan``: on the card the step is captured once
as a CUDA graph (``training.capture_step``) and replayed for each
micro-step, and the block's losses are read back once. A block's synthetic
batches are made on the host and copied to the card at once; a file's come
through ``PrefetchLoader`` and are copied into the graph's inputs. A block
never crosses a checkpoint or the end, so a run killed and resumed goes on
bitwise as if never stopped. ``--block 0`` calls the step eagerly, one
micro-step a block; on the CPU every block's step runs as calls.

Data: a backbone dataset file (``--data``, or ``--make-data`` to write a
synthetic one first, or ``--from-sidechainnet`` to export real CASP
backbones first, which needs the optional ``sidechainnet`` package and its
download) read through ``BackboneDataset`` and ``PrefetchLoader``; without
one, ``synthetic_chain_batch`` chains. Checkpoints: ``--ckpt-dir`` every
``--ckpt-every`` micro-steps and at the end (``CheckpointManager``),
``--resume`` from the latest. Metrics: ``--metrics F`` appends one JSON line
a micro-step (its loss and the edges/s so far) through
``parallel.MetricLogger``.

Run: python -m egnn_tpu_torch.examples.denoise --steps 64 [--device cpu]
     [--block 10] [--make-data bb.npz] [--ckpt-dir DIR [--resume]]
     [--metrics m.jsonl]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from egnn_tpu_torch import EGNNNetwork
from egnn_tpu_torch.parallel import MetricLogger
from egnn_tpu_torch.training import (
    CheckpointManager,
    PrefetchLoader,
    capture_step,
    make_adam,
    make_denoise_train_step,
    masked_mse,
    synthetic_chain_batch,
    to_tensors,
)
from egnn_tpu_torch.training.data import DenoiseBatch
from egnn_tpu_torch.training.datasets import (
    BackboneDataset,
    export_sidechainnet,
    make_synthetic_backbone_dataset,
)
from egnn_tpu_torch.utils import finite_or_skip_step
from egnn_tpu_torch.utils.device import resolve_device

SEED = 0
LOG_EVERY = 10


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50, help="micro-steps in all")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--nodes", type=int, default=384)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--knn", type=int, default=16)
    ap.add_argument("--grad-accum", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--block", type=int, default=10,
                    help="micro-steps a block: on the card the step's CUDA graph replayed, "
                    "the losses read once a block; 0 calls the step eagerly")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default=None,
                    help="backbone dataset file (npz, or h5 where h5py imports)")
    ap.add_argument("--make-data", default=None,
                    help="write a synthetic backbone dataset here first, and train on it")
    ap.add_argument("--data-proteins", type=int, default=64)
    ap.add_argument("--from-sidechainnet", default=None, metavar="PATH",
                    help="export CASP backbones to a dataset file at PATH first and train on "
                    "it (needs the optional sidechainnet package and its download)")
    ap.add_argument("--casp-version", type=int, default=12)
    ap.add_argument("--casp-thinning", type=int, default=30)
    ap.add_argument("--noise", type=float, default=1.0)
    ap.add_argument("--metrics", default=None, help="JSONL metrics path (MetricLogger)")
    return ap.parse_args(argv)


def build(args, device: torch.device):
    """(network, optimizer, the guarded train step) of the example's
    configuration, the weights drawn from ``SEED``."""
    net = EGNNNetwork(
        depth=args.depth, dim=args.dim, num_tokens=21, num_positions=args.nodes,
        layer_kwargs=dict(num_nearest_neighbors=args.knn, fourier_features=2, norm_coors=True,
                          coor_weights_clamp_value=2.0),
        device=device, generator=torch.Generator().manual_seed(SEED))
    optimizer = make_adam(net.parameters(), args.lr, grad_accum=args.grad_accum)
    return net, optimizer, finite_or_skip_step(make_denoise_train_step(net, optimizer))


def main(argv=None, on_checkpoint: Optional[Callable[[int], None]] = None) -> dict:
    """Train; returns a summary (also printed as the last line, ``SUMMARY``
    and a JSON object). ``on_checkpoint(step)`` runs after each checkpoint
    has landed on disk (a test injects its faults there)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dataset = None
    if args.from_sidechainnet:
        export_sidechainnet(args.from_sidechainnet, casp_version=args.casp_version,
                            thinning=args.casp_thinning, max_len=args.nodes // 3)
        args.data = args.from_sidechainnet
        print(f"exported sidechainnet CASP{args.casp_version}@{args.casp_thinning} to "
              f"{args.data}")
    if args.make_data:
        make_synthetic_backbone_dataset(args.make_data, num_proteins=args.data_proteins,
                                        seq_len=args.nodes // 3, seed=SEED)
        args.data = args.make_data
        print(f"wrote a synthetic backbone dataset to {args.data}")
    if args.data:
        dataset = BackboneDataset.load(args.data)
        args.nodes = 3 * dataset.seq_len
        print(f"dataset: {dataset.num_proteins} proteins x {dataset.seq_len} residues -> "
              f"n={args.nodes} atoms")
    net, optimizer, step_fn = build(args, device)
    print(f"device {device}; params: {sum(p.numel() for p in net.parameters()):,}")

    mgr, start = None, 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            start = mgr.restore(net, optimizer)["step"]
            step_fn.state.step = start
            print(f"RESUMED from step {start}")

    # the learning check of the reference demo (egnn_test.ipynb:925, 950):
    # the noised input's MSE against the denoised output's on one held-out
    # batch, before and after training
    if dataset is not None:
        eb = to_tensors(dataset.denoise_batch(np.random.RandomState(12345), max(4, args.batch),
                                              noise_std=args.noise), device)
    else:
        eb = synthetic_chain_batch(np.random.default_rng(999), max(4, args.batch), args.nodes,
                                   noise_std=args.noise, device=device)

    def eval_mse() -> float:
        mode = net.training
        net.eval()
        with torch.no_grad():
            _, denoised = net(eb.tokens, eb.noised_coors, adj_mat=eb.adj_mat, mask=eb.mask)
        net.train(mode)
        return masked_mse(denoised, eb.clean_coors, eb.mask).item()

    base_mse = masked_mse(eb.noised_coors, eb.clean_coors, eb.mask).item()
    start_mse = eval_mse()

    step = step_fn if args.block == 0 else capture_step(step_fn, step_fn.state)
    block = max(1, args.block)
    run = len(range(start, args.steps))
    loader = None
    if dataset is not None:
        upcoming = iter(range(start, args.steps))
        loader = PrefetchLoader(
            lambda: dataset.denoise_batch(np.random.RandomState([SEED, next(upcoming)]),
                                          args.batch, noise_std=args.noise),
            depth=2, num_batches=run, device=device)

    def staged(first: int, length: int) -> list:
        """The batches of micro-steps [first, first + length) on the device:
        the loader's, or synthetic ones made on the host and copied at once."""
        if loader is not None:
            return [next(loader) for _ in range(length)]
        host = [synthetic_chain_batch(np.random.default_rng([SEED, i]), args.batch, args.nodes,
                                      noise_std=args.noise, device="cpu")
                for i in range(first, first + length)]
        fields = [torch.stack(f).to(device) for f in zip(*host)]
        return [DenoiseBatch(*(f[j] for f in fields)) for j in range(length)]

    def block_at(first: int) -> list:
        """The batches of the block that starts at micro-step ``first``: it
        ends at a checkpoint, at the end, or after ``block`` micro-steps."""
        length = min(block, args.steps - first)
        if mgr is not None:
            length = min(length, args.ckpt_every - first % args.ckpt_every)
        return staged(first, length)

    edges = args.batch * args.nodes * args.knn * args.depth
    metrics = MetricLogger(args.metrics)
    losses = []
    done = start
    first_block = (0.0, 0)   # (seconds, micro-steps) of the first block: a capture's cost
    t0 = time.perf_counter()
    try:
        ahead = block_at(done) if done < args.steps else []
        while done < args.steps:
            length = len(ahead)
            block_losses = [step(b.tokens, b.noised_coors, b.clean_coors, b.adj_mat, b.mask)
                            for b in ahead]
            # the next block's batches are made while the card runs this one
            ahead = block_at(done + length) if done + length < args.steps else []
            values = torch.stack(block_losses).tolist()   # the block's one read
            if not losses:
                first_block = (time.perf_counter() - t0, length)
            losses += values
            rate = (done + length - start) * edges / (time.perf_counter() - t0)
            for i, value in enumerate(values, start=done):
                metrics.log(i, loss=value, edges_per_s=rate)
                if (i + 1) % LOG_EVERY == 0 or i + 1 == args.steps:
                    print(f"step {i:5d}  loss {value:.6f}")
            done += length
            if mgr is not None and done % args.ckpt_every == 0 and done < args.steps:
                mgr.save(done, net, optimizer)
                if on_checkpoint is not None:
                    mgr.wait()
                    on_checkpoint(done)
    finally:
        if loader is not None:
            loader.close()
        metrics.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    print(f"{run} steps in {seconds:.3f} s ({run / seconds:.3f} steps/s, "
          f"{run * edges / seconds:.4e} edges/s, "
          f"{'calls' if step is step_fn else f'blocks of {block} replays'})")

    model_mse = eval_mse()
    print(f"eval MSE: noised baseline {base_mse:.6f}; denoised {start_mse:.6f} at step "
          f"{start}, {model_mse:.6f} at step {args.steps}")

    if mgr is not None:
        mgr.save(args.steps, net, optimizer)
        mgr.close()
        print(f"checkpointed at step {args.steps}")
    summary = {
        "device": str(device), "start": start, "steps": args.steps,
        "block": args.block, "losses": losses,
        "seconds": seconds, "steps_per_s": run / seconds if run else 0.0,
        "edges_per_s": run * edges / seconds if run else 0.0,
        "first_block_seconds": first_block[0], "first_block_steps": first_block[1],
        "eval_mse_start": start_mse, "eval_mse": model_mse, "baseline_mse": base_mse,
    }
    print("SUMMARY " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
