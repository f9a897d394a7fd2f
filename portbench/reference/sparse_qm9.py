"""Plain reference of the molecule regressor at the EGNN paper's QM9 widths:
``EGNN_Sparse_Network`` (lucidrains/egnn-pytorch, egnn_pytorch_geometric.py)
with soft edges and no coordinate update, over every other atom of each
molecule, then a masked mean readout of the node features and a two-layer
head; its MSE and Adam steps.

Molecules are (G, NA) padded slots. Each valid atom receives an edge from
each of its k nearest valid atoms of the same molecule (``torch.topk`` of the
squared distances, 1e5 where either end is padding, itself left out; at k =
NA - 1 every other atom); a pair at the 1e5 fill is no edge. A layer runs
the edge MLP on [f_i, f_j, |x_i - x_j|^2], gates each message by the sigmoid
of a linear map of it (the paper's edge inference), sums an atom's gated
messages and adds the node MLP of [f_i, sum] to its features. Coordinates
stay as they are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import mlp2, sum_sq, train_steps

MASK_FILL = 1e5


def widths(cfg: dict) -> dict:
    m = cfg["model"]
    d, dd = m["dim"], 2 * m["fourier_features"] + 1
    ein = 2 * d + dd
    return dict(d=d, dd=dd, ein=ein, h=2 * ein, m=m["m_dim"])


def _xavier(fan_in, fan_out):
    return ("normal", (2.0 / (fan_in + fan_out)) ** 0.5)


def _check(cfg: dict) -> None:
    m = cfg["model"]
    want = dict(fourier_features=0, soft_edge=1, update_coors=False, norm_feats=False,
                norm_coors=False, aggr="add")
    got = {k: m[k] for k in want}
    if got != want:
        raise ValueError(f"this reference computes {want}, not {got}")


def param_shapes(cfg: dict) -> list:
    """(name, shape, draw) in the program's names: weights xavier-normal,
    biases zero, the atom-type embedding N(0, 1) (the module's own initial
    distributions)."""
    _check(cfg)
    m, w = cfg["model"], widths(cfg)
    d, h, md = w["d"], w["h"], w["m"]

    def linear(name, fan_in, fan_out):
        return [(f"{name}_w", (fan_in, fan_out), _xavier(fan_in, fan_out)),
                (f"{name}_b", (fan_out,), ("const", 0.0))]

    out = [("trunk.emb_0", (m["num_types"], d), ("normal", 1.0))]
    for i in range(m["layers"]):
        layer = (linear("edge_mlp_0", w["ein"], h) + linear("edge_mlp_1", h, md)
                 + linear("edge_weight", md, 1)
                 + linear("node_mlp_0", d + md, 2 * d) + linear("node_mlp_1", 2 * d, d))
        out += [(f"trunk.mpnn_{i}.{n}", s, k) for n, s, k in layer]
    return out + [("head_w1", (d, d), _xavier(d, d)), ("head_b1", (d,), ("const", 0.0)),
                  ("head_w2", (d, 1), _xavier(d, 1)), ("head_b2", (1,), ("const", 0.0))]


def edges(coors, mask, k):
    """(senders (G, NA, k) slot ids within the molecule, valid (G, NA, k))."""
    na = coors.shape[1]
    with torch.no_grad():
        dist = sum_sq(coors[:, :, None, :] - coors[:, None, :, :])
        ranking = torch.where(mask[:, :, None] & mask[:, None, :], dist, MASK_FILL)
        eye = torch.eye(na, dtype=torch.bool, device=coors.device)
        ranking = torch.where(eye, float("inf"), ranking)
        vals, idx = torch.topk(ranking, k, dim=-1, largest=False)
        return idx, (vals < MASK_FILL) & mask[:, :, None]


def gather(x, idx):
    """x (G, NA, c), idx (G, NA, k) -> (G, NA, k, c)."""
    g, na, k = idx.shape
    flat = idx.reshape(g, na * k, 1).expand(g, na * k, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(g, na, k, x.shape[-1])


def layer(p: dict, cfg: dict, feats, coors, idx, valid):
    d = widths(cfg)["d"]
    feats_j = gather(feats, idx)
    dist = sum_sq(gather(coors, idx) - coors[:, :, None, :])[..., None]
    w1 = p["edge_mlp_0_w"]
    h1 = ((feats @ w1[:d])[:, :, None, :] + feats_j @ w1[d:2 * d]
          + dist @ w1[2 * d:] + p["edge_mlp_0_b"])
    msg = F.silu(F.silu(h1) @ p["edge_mlp_1_w"] + p["edge_mlp_1_b"])
    msg = msg * torch.sigmoid(msg @ p["edge_weight_w"] + p["edge_weight_b"])
    m_i = torch.where(valid[..., None], msg, 0.0).sum(dim=2)
    return feats + mlp2(torch.cat([feats, m_i], dim=-1), p, "node_mlp")


def forward(p: dict, cfg: dict, coors, types, mask):
    """(G,) predictions of padded molecules: coors (G, NA, 3), types (G, NA)
    ids, mask (G, NA)."""
    m = cfg["model"]
    idx, valid = edges(coors, mask, m["knn"])
    feats = p["trunk.emb_0"][types]
    for i in range(m["layers"]):
        pre = f"trunk.mpnn_{i}."
        lp = {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
        feats = layer(lp, cfg, feats, coors, idx, valid)
    mm = mask[:, :, None].to(feats.dtype)
    pooled = (feats * mm).sum(dim=1) / mm.sum(dim=1).clamp(min=1.0)
    h = F.silu(pooled @ p["head_w1"] + p["head_b1"])
    return (h @ p["head_w2"] + p["head_b2"])[:, 0]


def mse_loss(p: dict, cfg: dict, batch) -> torch.Tensor:
    coors, types, mask, target = batch
    return ((forward(p, cfg, coors, types, mask) - target) ** 2).mean()


def train(p: dict, cfg: dict, batches, lr: float, accum: int):
    """(losses, first gradients, parameters after) of Adam steps on the MSE
    over ``batches`` (coors, types, mask, target)."""
    return train_steps(p, lambda q, bt: mse_loss(q, cfg, bt), batches, lr, accum)
