"""Serving export: the anchor-3 forward as a ``torch.export`` program saved to
a ``.pt2`` file, the counterpart of ``examples/export_serving.py`` (which
writes a StableHLO artifact with ``jax.export``). A server loads the file
with ``torch.export.load`` and calls ``.module()``: no model code is needed
at load time, only this package's operators, which importing
``egnn_tpu_torch`` registers.

``EGNNNetwork`` depth 3, dim 32, 21 tokens, kNN 8, ``norm_coors``, clamp
2.0, ``num_positions = n``; random weights from ``SEED``. The kNN selection
runs K1 through the operator ``egnn_tpu_torch::knn_select_gather``
(``ops/cuda/knn.py``), which the exported graph calls once a layer: the
kernel on the card, its plain version on the CPU. The forward is exported,
saved, loaded again, and its outputs held against the in-process forward's,
bit for bit.

Only the full-band route exports (n up to ``FULL_BAND_MAX_N``, and below the
grid route's reach, as there is no adjacency): the large-n routes read a
coverage certificate on the host, which a traced graph cannot hold.

Run: python -m egnn_tpu_torch.examples.export_serving [--out F.pt2]
     [--nodes 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
from torch import nn

from egnn_tpu_torch import EGNNNetwork
from egnn_tpu_torch.ops import neighbors as nb
from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
from egnn_tpu_torch.ops.cuda import grid_knn as grid_kernels
from egnn_tpu_torch.ops.cuda import knn as knn_kernels
from egnn_tpu_torch.utils.device import resolve_device

SEED = 0
KNN = 8


class Forward(nn.Module):
    """(tokens, coors) -> (feats, coors): the network's serving call."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, tokens, coors):
        return self.net(tokens, coors)


def exportable(n: int, k: int = KNN) -> bool:
    """Whether a forward without adjacency at n nodes takes the full-band
    route (K1), which exports; the packed and grid routes do not."""
    grid = nb.GRID_AUTO and grid_kernels.supports_grid_knn(n, k)
    return knn_kernels.supports_knn_shapes(n) and not grid


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="the .pt2 file (default: a temporary one)")
    ap.add_argument("--nodes", type=int, default=256)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Export, save, load and check; returns a summary (also printed as the
    last line, ``SUMMARY`` and a JSON object)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    n = args.nodes
    if not exportable(n):
        raise SystemExit(f"n={n} takes a large-n selection route, which reads a certificate on "
                         f"the host and cannot be exported; export at most "
                         f"{knn_kernels.FULL_BAND_MAX_N} nodes below the grid route's reach")
    gen = torch.Generator().manual_seed(SEED)
    net = EGNNNetwork(depth=3, dim=args.dim, num_tokens=21, num_positions=n,
                      layer_kwargs=dict(num_nearest_neighbors=KNN, norm_coors=True,
                                        coor_weights_clamp_value=2.0),
                      device=device, generator=gen).eval()
    tokens = torch.randint(0, 21, (1, n), generator=gen).to(device)
    coors = torch.randn(1, n, 3, generator=gen, dtype=torch.float32).to(device)
    model = Forward(net).eval()

    with torch.no_grad():
        program = torch.export.export(model, (tokens, coors))
    out = args.out or os.path.join(tempfile.mkdtemp(), "egnn_fwd.pt2")
    torch.export.save(program, out)
    size = os.path.getsize(out)
    loaded = torch.export.load(out).module()
    with torch.no_grad():
        f_ref, c_ref = model(tokens, coors)
        reset_launch_counts()
        f, c = loaded(tokens, coors)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = LAUNCH_COUNTS["knn_select_gather"]
    bitwise = torch.equal(f, f_ref) and torch.equal(c, c_ref)
    op_calls = sum(str(node.target) == "egnn_tpu_torch.knn_select_gather.default"
                   for node in program.graph.nodes)
    print(f"exported {size:,} bytes to {out} ({op_calls} calls of the operator "
          f"egnn_tpu_torch::knn_select_gather); the reloaded program on {device}: outputs "
          f"bitwise equal to the in-process forward: {bitwise}; K1 launches {launches}")
    summary = {"device": str(device), "nodes": n, "bytes": size, "path": out,
               "bitwise": bitwise, "op_calls": op_calls, "k1_launches": launches}
    print("SUMMARY " + json.dumps(summary))
    if not bitwise:
        raise SystemExit("the reloaded program does not reproduce the in-process forward")
    return summary


if __name__ == "__main__":
    main()
