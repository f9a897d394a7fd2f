"""Plain reference of the dense kNN EGNN network (lucidrains/egnn-pytorch,
egnn_pytorch.py: ``EGNN`` and ``EGNN_Network``), the denoising loss and its
Adam steps.

A layer selects each node's k smallest rankings with ``torch.topk``: the
squared distance, 1e5 where either end is masked, then -1 on the diagonal and
0 on the adjacency. It gathers the neighbours, runs the edge MLP on
[f_i, f_j, d_ij], pools the masked messages by sum into the node MLP (after a
LayerNorm), and moves each node by the clamped coordinate weights times the
CoorsNorm of x_i - x_j.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import coors_norm, fourier, layer_norm, mlp2, sum_sq, train_steps

MASK_FILL = 1e5


def widths(cfg: dict) -> dict:
    m = cfg["model"]
    d, dd = m["dim"], 2 * m["fourier_features"] + 1
    ein = 2 * d + dd
    return dict(d=d, dd=dd, ein=ein, h=2 * ein, m=m["m_dim"])


def param_shapes(cfg: dict) -> list:
    """(name, shape, draw) in the program's parameter names; ``draw`` is
    ("normal", std), ("uniform", bound) or ("const", value): the module's own
    initial distributions (linear weights N(0, init_eps), biases
    torch.nn.Linear's U(+-1/sqrt(fan_in)), embeddings N(0, 1))."""
    m, w = cfg["model"], widths(cfg)
    d, h, md, eps = w["d"], w["h"], w["m"], m["init_eps"]
    out = [("token_emb", (m["num_tokens"], d), ("normal", 1.0)),
           ("pos_emb", (m["num_positions"], d), ("normal", 1.0))]

    def linear(name, fan_in, fan_out):
        return [(f"{name}_w", (fan_in, fan_out), ("normal", eps)),
                (f"{name}_b", (fan_out,), ("uniform", fan_in ** -0.5))]

    for i in range(m["depth"]):
        p = f"egnn_{i}."
        layer = (linear("edge_mlp_0", w["ein"], h) + linear("edge_mlp_1", h, md)
                 + [("node_norm_gamma", (d,), ("const", 1.0)),
                    ("node_norm_beta", (d,), ("const", 0.0))]
                 + ([("coors_norm_scale", (1,), ("const", 1e-2))] if m["norm_coors"] else [])
                 + linear("node_mlp_0", d + md, 2 * d) + linear("node_mlp_1", 2 * d, d)
                 + linear("coors_mlp_0", md, 4 * md) + linear("coors_mlp_1", 4 * md, 1))
        out += [(p + n, s, k) for n, s, k in layer]
    return out


def chain_adjacency(n: int, device) -> torch.Tensor:
    ar = torch.arange(n, device=device)
    return (ar[:, None] - ar[None, :]).abs() == 1


def select(coors, mask, adj, k):
    """(indices (b, n, k)) of each row's k smallest rankings."""
    b, n, _ = coors.shape
    with torch.no_grad():
        dist = sum_sq(coors[:, :, None, :] - coors[:, None, :, :])
        ranking = torch.where(mask[:, :, None] & mask[:, None, :], dist, MASK_FILL)
        eye = torch.eye(n, dtype=torch.bool, device=coors.device)
        ranking = torch.where(eye, -1.0, ranking)
        ranking = torch.where(adj & ~eye, 0.0, ranking)
        return torch.topk(ranking, k, dim=-1, largest=False).indices


def gather(x, idx):
    """x (b, n, c), idx (b, n, k) -> (b, n, k, c)."""
    b, n, k = idx.shape
    flat = idx.reshape(b, n * k, 1).expand(b, n * k, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(b, n, k, x.shape[-1])


def layer(p: dict, cfg: dict, feats, coors, mask, adj):
    m, w = cfg["model"], widths(cfg)
    d = w["d"]
    idx = select(coors, mask, adj, m["num_nearest_neighbors"])
    coors_j, feats_j = gather(coors, idx), gather(feats, idx)
    mask_j = gather(mask[..., None].float(), idx)[..., 0] > 0.5
    rel = coors[:, :, None, :] - coors_j
    distf = fourier(sum_sq(rel), m["fourier_features"])
    w1 = p["edge_mlp_0_w"]
    h1 = ((feats @ w1[:d])[:, :, None, :] + feats_j @ w1[d:2 * d]
          + distf @ w1[2 * d:2 * d + w["dd"]] + p["edge_mlp_0_b"])
    msg = F.silu(F.silu(h1) @ p["edge_mlp_1_w"] + p["edge_mlp_1_b"])
    pair = (mask[:, :, None] & mask_j)[..., None]
    cw = torch.where(pair, mlp2(msg, p, "coors_mlp"), 0.0)
    clamp = m["coor_weights_clamp_value"]
    if clamp is not None:
        cw = cw.clamp(-clamp, clamp)
    rel_n = coors_norm(rel, p["coors_norm_scale"]) if m["norm_coors"] else rel
    coors_out = coors + (cw * rel_n).sum(dim=-2)
    m_i = torch.where(pair, msg, 0.0).sum(dim=-2)
    normed = layer_norm(feats, p["node_norm_gamma"], p["node_norm_beta"])
    feats_out = feats + mlp2(torch.cat([normed, m_i], dim=-1), p, "node_mlp")
    return feats_out, coors_out


def forward(p: dict, cfg: dict, tokens, coors, mask):
    """(feats, coors) of the network; the chain adjacency of n nodes."""
    b, n = tokens.shape
    adj = chain_adjacency(n, coors.device)
    feats = p["token_emb"][tokens] + p["pos_emb"][None, :n]
    for i in range(cfg["model"]["depth"]):
        lp = {k[len(f"egnn_{i}."):]: v for k, v in p.items() if k.startswith(f"egnn_{i}.")}
        feats, coors = layer(lp, cfg, feats, coors, mask, adj)
    return feats, coors


def denoise_loss(p: dict, cfg: dict, batch) -> torch.Tensor:
    """The masked MSE of the denoised coordinates against the clean ones:
    sum over valid nodes and axes / (valid nodes * 3)."""
    tokens, clean, noised, mask = batch
    _, out = forward(p, cfg, tokens, noised, mask)
    err = ((out - clean) ** 2) * mask[..., None]
    return err.sum() / (mask.sum() * out.shape[-1]).clamp(min=1)


def train(p: dict, cfg: dict, batches, lr: float, accum: int):
    """(losses, first gradients, parameters after) of Adam steps on the
    denoising loss over ``batches`` (tokens, clean, noised, mask)."""
    return train_steps(p, lambda q, bt: denoise_loss(q, cfg, bt), batches, lr, accum)


def serve(p: dict, cfg: dict, request):
    """The served answer of a request (tokens, noised, mask): the denoised
    coordinates."""
    tokens, noised, mask = request
    with torch.no_grad():
        return forward(p, cfg, tokens, noised, mask)[1]
