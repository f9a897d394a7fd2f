"""Carry a trained reference (egnn-pytorch) ``EGNN_Network`` into the port,
the counterpart of ``examples/migrate_from_torch.py``.

The path for users of the reference package: convert the network's weights
(``utils.egnn_network_params_from_torch``, the reference's (out, in)
``Linear`` weights transposed onto the port's names), load them into the
port's ``EGNNNetwork`` (``utils.load_flax_params``), check that both give
the same outputs in float64, and save a port checkpoint
(``training.CheckpointManager``, with a fresh Adam) that training and
serving resume from. The float64 check runs on the CPU, as the JAX
example's does (the card's kernels select in float32); the checkpoint is
restored onto ``--device`` (the card unless ``cpu``) and compared there.

Needs the reference package importable (``--reference DIR`` adds DIR to the
path); without it the example says so and exits cleanly, as the JAX example
does.

Run: python -m egnn_tpu_torch.examples.migrate_from_torch [--out DIR]
     [--reference DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from egnn_tpu_torch import EGNNNetwork
from egnn_tpu_torch.training import CheckpointManager, make_adam
from egnn_tpu_torch.utils import egnn_network_params_from_torch, load_flax_params
from egnn_tpu_torch.utils.device import resolve_device

# the reference's denoise example configuration (denoise_sparse.py:23-32)
CONFIG = dict(depth=3, dim=16, num_tokens=21, num_positions=64, num_nearest_neighbors=8,
              norm_coors=True, coor_weights_clamp_value=2.0)
TOL = 1e-8
NODES = 48     # the float64 check's node count


def port_network(cfg: dict, device) -> EGNNNetwork:
    """The port's float64 ``EGNNNetwork`` of a reference configuration."""
    layer = {k: cfg[k] for k in ("num_nearest_neighbors", "norm_coors",
                                 "coor_weights_clamp_value")}
    return EGNNNetwork(depth=cfg["depth"], dim=cfg["dim"], num_tokens=cfg["num_tokens"],
                       num_positions=cfg["num_positions"], layer_kwargs=layer, device=device,
                       dtype=torch.float64)


def migrate(reference, cfg: dict, out_dir: str, device=None) -> dict:
    """Convert ``reference`` (an ``EGNN_Network`` of configuration ``cfg``, or
    anything with its attribute layout and call signature), check the port
    against it in float64 on ``NODES`` nodes (each output's largest error at most
    ``TOL`` times its largest magnitude where that exceeds 1), save the
    checkpoint to ``out_dir`` and restore it onto ``device``. Raises where
    the outputs differ by more or the restored parameters are not the saved
    ones."""
    params = egnn_network_params_from_torch(reference)
    net = port_network(cfg, "cpu")
    load_flax_params(net, params)

    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, cfg["num_tokens"], size=(1, NODES)))
    coors = torch.from_numpy(rng.randn(1, NODES, 3))
    mask = torch.ones((1, NODES), dtype=torch.bool)
    with torch.no_grad():
        ref_f, ref_c = reference(tokens, coors, mask=mask)
        f, c = net(tokens, coors, mask=mask)
    # each error relative to the reference's largest magnitude where it exceeds 1
    err_f = ((f - ref_f).abs().max() / ref_f.abs().max().clamp(min=1.0)).item()
    err_c = ((c - ref_c).abs().max() / ref_c.abs().max().clamp(min=1.0)).item()
    print(f"agreement in float64: feats {err_f:.2e}, coors {err_c:.2e} of their largest "
          f"magnitudes past 1 (tolerance {TOL})")
    if not (err_f < TOL and err_c < TOL):
        raise AssertionError("the converted network does not reproduce the reference")

    mgr = CheckpointManager(out_dir, async_save=False)
    mgr.save(0, net, make_adam(net.parameters(), 1e-3))
    dev = resolve_device(device)
    restored = port_network(cfg, dev)
    mgr.restore(restored, make_adam(restored.parameters(), 1e-3))
    mgr.close()
    exact = all(torch.equal(p.cpu(), q) for p, q in zip(restored.parameters(), net.parameters()))
    if not exact:
        raise AssertionError("the restored checkpoint differs from the saved parameters")
    print(f"migrated checkpoint written to {out_dir} (step 0); restored on {dev} exactly")
    return {"err_feats": err_f, "err_coors": err_c, "out": out_dir, "device": str(dev)}


def main(argv=None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--reference", default=None,
                    help="a directory holding the egnn_pytorch package, added to the path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.reference:
        sys.path.insert(0, args.reference)
    try:
        from egnn_pytorch.egnn_pytorch import EGNN_Network
    except ImportError as e:
        print(f"the reference package is not importable ({e}); nothing to migrate")
        return None
    torch.manual_seed(0)
    reference = EGNN_Network(**CONFIG).double()
    summary = migrate(reference, CONFIG, args.out or tempfile.mkdtemp(), args.device)
    print("SUMMARY " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
