"""The port's dense network (``egnn_tpu_torch.EGNNNetwork``) as the denoising
example trains it (``make_denoise_train_step`` under ``finite_or_skip_step``,
``make_adam`` with accumulation) and as a caller serves it (an eager forward
in eval mode), over random-walk chains with the chain adjacency."""
from __future__ import annotations

import numpy as np
import torch

from egnn_tpu_torch import EGNNNetwork
from egnn_tpu_torch.ops.graph import chain_adjacency
from egnn_tpu_torch.training import make_adam, make_denoise_train_step
from egnn_tpu_torch.utils import finite_or_skip_step

from .. import counts, data
from ..reference import dense_knn as REFERENCE


def _model(cfg: dict, weights: dict, device) -> EGNNNetwork:
    m = cfg["model"]
    net = EGNNNetwork(
        depth=m["depth"], dim=m["dim"], num_tokens=m["num_tokens"],
        num_positions=m["num_positions"],
        layer_kwargs=dict(num_nearest_neighbors=m["num_nearest_neighbors"],
                          fourier_features=m["fourier_features"], m_dim=m["m_dim"],
                          init_eps=m["init_eps"], norm_coors=m["norm_coors"],
                          coor_weights_clamp_value=m["coor_weights_clamp_value"],
                          **cfg["options"]),
        device=device)
    net.load_state_dict(weights, strict=True)
    return net


class Train:
    """The denoising example's guarded step, called once a micro-step."""

    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        self.model = _model(cfg, weights, device)
        opt = mix["optimizer"]
        self.optimizer = make_adam(self.model.parameters(), opt["lr"],
                                   grad_accum=opt["grad_accum"])
        step = finite_or_skip_step(make_denoise_train_step(self.model, self.optimizer))
        self.call, self.state = step, step.state


def train_batch(cfg: dict, mix: dict, seed: int, i: int) -> tuple:
    m, d = cfg["model"], mix["data"]
    return data.chains(data.rng(seed, data.TRAIN, i), mix["batch"], m["num_positions"],
                       m["num_tokens"], d["noise_std"], d["step_std"], d["min_len_frac"])


def constants(cfg: dict, mix: dict, device) -> dict:
    return {"adj": chain_adjacency(cfg["model"]["num_positions"], device=device)}


def train_args(cfg: dict, tensors: tuple, const: dict) -> tuple:
    tokens, clean, noised, mask = tensors
    return tokens, noised, clean, const["adj"], mask


class Serve:
    """A request: its chains copied to the card, the network's forward as an
    eager call (K1 and K10f inside), the denoised coordinates to the host."""

    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        self.model = _model(cfg, weights, device).eval()
        self.adj = constants(cfg, mix, device)["adj"]
        self.device = device

    @torch.no_grad()
    def answer(self, tensors: tuple) -> np.ndarray:
        tokens, noised, mask = (t.to(self.device, non_blocking=True) for t in tensors)
        _, coors = self.model(tokens, noised, adj_mat=self.adj, mask=mask)
        return coors.cpu().numpy()


def serve_request(cfg: dict, mix: dict, seed: int, r: int) -> tuple:
    m, d = cfg["model"], mix["data"]
    tokens, _, noised, mask = data.chains(data.rng(seed, data.SERVE, r), mix["batch"],
                                          m["num_positions"], m["num_tokens"], d["noise_std"],
                                          d["step_std"], d["min_len_frac"])
    return tokens, noised, mask


def valid_counts(cfg: dict, arrays: tuple) -> tuple:
    """(valid nodes, valid pairs, chains): a valid node pairs with k
    neighbours, less the one masked chain neighbour of a chain's last valid
    node, which the adjacency ranks first."""
    mask = arrays[-1]
    lengths = mask.sum(axis=1)
    n, k = mask.shape[1], cfg["model"]["num_nearest_neighbors"]
    pairs = lengths * k - (lengths < n)
    return int(lengths.sum()), int(pairs.sum()), int(mask.shape[0])


def slots(cfg: dict, mix: dict) -> int:
    m = cfg["model"]
    return mix["batch"] * m["num_positions"] * m["num_nearest_neighbors"] * m["depth"]


DETAIL_GAPS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)


def node_gaps(out: np.ndarray, ref: np.ndarray, arrays: tuple) -> np.ndarray:
    """Each valid node's |move(program) - move(reference)| over its chain's
    RMS move (move = answer - noised input), chain by chain."""
    noised, mask = arrays[1].astype(np.float64), arrays[2]
    move_p, move_r = out.astype(np.float64) - noised, ref.astype(np.float64) - noised
    gap = np.linalg.norm(move_p - move_r, axis=-1)
    rms = np.sqrt(np.sum(np.sum(move_r ** 2, axis=-1) * mask, axis=1)
                  / np.maximum(mask.sum(axis=1), 1))
    return (gap / np.maximum(rms, 1e-30)[:, None])[mask]


def answer_numbers(out: np.ndarray, ref: np.ndarray, arrays: tuple,
                   detail: bool = False) -> dict:
    """``node_gap``: the widest gap (``node_gaps``) over the request's valid
    nodes, every node held. A node whose neighbour set parted from the
    reference's at a rounding-level tie would read about its move; sound
    runs have read none (PERF.md). ``detail`` adds the count of nodes over
    each of ``DETAIL_GAPS``."""
    gaps = node_gaps(out, ref, arrays)
    numbers = {"node_gap": float(gaps.max()) if gaps.size else 0.0}
    if detail:
        numbers.update({f"nodes_over_{t:g}": int(np.sum(gaps > t)) for t in DETAIL_GAPS})
    return numbers


def forward_flops(cfg: dict, valid: tuple) -> int:
    """The network's forward operations on (nodes, pairs, chains)."""
    nodes, pairs, _ = valid
    m, w = cfg["model"], REFERENCE.widths(cfg)
    return counts.model_forward_flops(m["depth"], nodes, pairs, w["d"], w["h"], w["m"],
                                      m["fourier_features"])


def pair_launches(cfg: dict, mix: dict, valid: tuple) -> list:
    """The K10 launches of a micro-step or request, one a layer, as
    ``counts.pair_forward`` / ``pair_backward`` take them."""
    m, w = cfg["model"], REFERENCE.widths(cfg)
    launch = dict(pairs=valid[1], nodes=mix["batch"] * m["num_positions"], c=3, d=w["d"],
                  h=w["h"], m=w["m"], fourier=m["fourier_features"])
    return [launch] * m["depth"]
