"""Helpers around the models: device choice, weight carrying, rotations,
numerical sanitizers and timing (the counterparts of ``egnn_tpu.utils``)."""
from .checks import (
    assert_in_bounds,
    checked,
    finite_or_skip_step,
    guard_finite,
    tree_all_finite,
)
from .port_weights import (
    egnn_network_params_from_torch,
    egnn_params_from_torch,
    egnn_sparse_network_params_from_torch,
    egnn_sparse_params_from_torch,
    load_flax_params,
)
from .profiling import Roofline, annotate, chain_calls, measure_op, time_fn, trace
from .rotations import rot, rot_y, rot_z

__all__ = [
    "rot",
    "rot_y",
    "rot_z",
    "egnn_params_from_torch",
    "egnn_network_params_from_torch",
    "egnn_sparse_network_params_from_torch",
    "egnn_sparse_params_from_torch",
    "load_flax_params",
    "Roofline",
    "annotate",
    "chain_calls",
    "measure_op",
    "time_fn",
    "trace",
    "assert_in_bounds",
    "checked",
    "finite_or_skip_step",
    "guard_finite",
    "tree_all_finite",
]
