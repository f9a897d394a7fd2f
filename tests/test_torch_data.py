"""The port's input pipeline (``egnn_tpu_torch/training/data.py``):
``synthetic_molecule_batch_np`` bit for bit against ``egnn_tpu``'s from one
``RandomState``; ``PrefetchLoader`` on the CPU delivers what the builder
gives when called directly, raises its worker's error in ``__next__`` and
closes promptly (as ``tests/test_utils_subsystems.py`` and
``tests/test_datasets.py`` hold the JAX loader)."""
import threading
import time

import numpy as np
import pytest
import torch

from egnn_tpu.training.data import synthetic_molecule_batch_np as jax_molecules
from egnn_tpu_torch.training.data import (
    MoleculeBatch,
    PrefetchLoader,
    synthetic_molecule_batch_np,
    to_tensors,
)


@pytest.mark.parametrize("G,NA,k", [(4, 16, 4), (3, 32, 8), (2, 6, 8)])
def test_molecule_batch_matches_jax(G, NA, k):
    got = synthetic_molecule_batch_np(np.random.RandomState(G * NA + k), G, NA, k)
    ref = jax_molecules(np.random.RandomState(G * NA + k), G, NA, k)
    assert isinstance(got, MoleculeBatch) and got._fields == ref._fields
    for name in got._fields:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_to_tensors_types():
    b = synthetic_molecule_batch_np(np.random.RandomState(0), 2, 8, 3)
    t = to_tensors(b, device="cpu")
    assert t.x.dtype == torch.float32 and t.target.dtype == torch.float32
    assert t.edge_index.dtype == torch.int64 and t.batch_ids.dtype == torch.int64
    assert t.edge_mask.dtype == torch.bool and t.node_mask.dtype == torch.bool
    np.testing.assert_array_equal(t.x.numpy(), b.x.astype(np.float32))
    d = to_tensors({"a": np.ones(2), "s": "name"}, device="cpu")
    assert d["a"].dtype == torch.float32 and d["s"] == "name"


def test_prefetch_delivers_the_builders_batches():
    rng = np.random.RandomState(3)
    loader = PrefetchLoader(lambda: synthetic_molecule_batch_np(rng, 3, 12, 4), depth=2,
                            num_batches=4, device="cpu")
    batches = list(loader)
    loader.close()
    assert len(batches) == 4
    direct = np.random.RandomState(3)
    for b in batches:
        want = to_tensors(synthetic_molecule_batch_np(direct, 3, 12, 4), device="cpu")
        for name in b._fields:
            assert torch.equal(getattr(b, name), getattr(want, name)), name


def test_prefetch_worker_error_surfaces():
    def boom():
        raise ValueError("bad batch")

    loader = PrefetchLoader(boom, num_batches=2, device="cpu")
    with pytest.raises(RuntimeError, match="worker failed") as info:
        next(iter(loader))
    assert isinstance(info.value.__cause__, ValueError)
    loader.close()


def test_prefetch_close_returns_promptly_with_a_full_queue():
    made = threading.Event()

    def make():
        made.set()
        return np.zeros(4)

    loader = PrefetchLoader(make, depth=1, device="cpu")   # endless, queue full
    assert made.wait(5)
    t0 = time.perf_counter()
    loader.close()
    assert time.perf_counter() - t0 < 5
    assert not loader._thread.is_alive()
