"""The port's molecule regressor (``egnn_tpu_torch/examples/
molecule_regression.py``: ``Regressor``, ``make_train_step``,
``pack_on_device``) with its trunk at the configuration's widths and
options (``EGNNSparseNetwork``), trained as the example's ``--block`` path
runs it: each molecule's edges built on the card inside the timed call
(``knn_graph(graph_size=NA)``, K3), the trunk's layers in the uniform layout.
Where K10's tile cannot take the widths, or a layer does not move its
coordinates, the layer takes the program's per-edge path (plain torch, K2
in every gather's backward)."""
from __future__ import annotations

import numpy as np

from egnn_tpu_torch import EGNNSparseNetwork
from egnn_tpu_torch.examples.molecule_regression import (
    Regressor,
    make_train_step,
    pack_on_device,
)
from egnn_tpu_torch.training import make_adam

from .. import counts, data
from ..reference import sparse_qm9 as REFERENCE


def _model(cfg: dict, mix: dict, weights: dict, device) -> Regressor:
    m = cfg["model"]
    model = Regressor(m["layers"], m["dim"], m["num_types"], mix["batch"], m["slots"],
                      m["knn"], device=device)
    model.trunk = EGNNSparseNetwork(
        n_layers=m["layers"], feats_dim=1, embedding_nums=[m["num_types"]],
        embedding_dims=[m["dim"]], m_dim=m["m_dim"], fourier_features=m["fourier_features"],
        soft_edge=m["soft_edge"], update_coors=m["update_coors"], norm_feats=m["norm_feats"],
        norm_coors=m["norm_coors"], aggr=m["aggr"], device=device, **cfg["options"])
    model.load_state_dict(weights, strict=True)
    return model


class Train:
    """The example's training step: ``pack_on_device`` (the edge build) and
    ``make_train_step``'s step, called as one function, as the example's
    ``--block`` path captures it."""

    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        self.model = _model(cfg, mix, weights, device)
        opt = mix["optimizer"]
        self.optimizer = make_adam(self.model.parameters(), opt["lr"],
                                   grad_accum=opt["grad_accum"])
        step = make_train_step(self.model, self.optimizer)
        knn = cfg["model"]["knn"]

        def call(coors, types, node_mask, target):
            return step(pack_on_device(coors, types, node_mask, target, knn))[0]

        self.call, self.state = call, step.state


def train_batch(cfg: dict, mix: dict, seed: int, i: int) -> tuple:
    m, d = cfg["model"], mix["data"]
    return data.molecules(data.rng(seed, data.TRAIN, i), mix["batch"], m["slots"],
                          d["min_atoms"], d["charges"])


def train_args(cfg: dict, tensors: tuple, const: dict) -> tuple:
    return tensors   # (coors, types, mask, target): the example's packed step


def constants(cfg: dict, mix: dict, device) -> dict:
    return {}


def valid_counts(cfg: dict, arrays: tuple) -> tuple:
    """(valid atoms, valid edges, molecules): an atom of a molecule of s
    atoms receives min(k, s - 1) edges."""
    mask = arrays[2]
    sizes = mask.sum(axis=1)
    k = cfg["model"]["knn"]
    return int(sizes.sum()), int((sizes * np.minimum(k, sizes - 1)).sum()), int(mask.shape[0])


def slots(cfg: dict, mix: dict) -> int:
    m = cfg["model"]
    return mix["batch"] * m["slots"] * m["knn"] * m["layers"]


def forward_flops(cfg: dict, valid: tuple) -> int:
    """The regressor's forward operations on (atoms, edges, molecules)."""
    nodes, pairs, graphs = valid
    m, w = cfg["model"], REFERENCE.widths(cfg)
    return counts.model_forward_flops(m["layers"], nodes, pairs, w["d"], w["h"], w["m"],
                                      m["fourier_features"], graphs, head=True,
                                      soft=bool(m["soft_edge"]), coors=m["update_coors"])
