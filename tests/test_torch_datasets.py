"""The port's dataset files (``egnn_tpu_torch/training/datasets.py``)
against ``egnn_tpu.training.datasets`` on files the tests write: the
written files and the batches from one ``RandomState`` bit for bit, and the
checks of ``tests/test_datasets.py`` (the x3 atom expansion, chain
adjacency, masking, crop and pad, the QM9 layouts)."""
import sys

import numpy as np
import pytest
import torch

from egnn_tpu.training import datasets as jd
from egnn_tpu_torch.training import PrefetchLoader
from egnn_tpu_torch.training import datasets as td


def _same_fields(a, b):
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_backbone_file_and_batches_match_jax(tmp_path):
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    td.make_synthetic_backbone_dataset(pt, num_proteins=8, seq_len=40, seed=3)
    jd.make_synthetic_backbone_dataset(pj, num_proteins=8, seq_len=40, seed=3)
    ds, dj = td.BackboneDataset.load(pt), jd.BackboneDataset.load(pj)
    for name in ("tokens", "coords", "masks"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(dj, name))
    for kw in (dict(batch=2, noise_std=0.5), dict(batch=1, num_residues=16),
               dict(batch=3, num_residues=50)):
        _same_fields(ds.denoise_batch(np.random.RandomState(0), **kw),
                     dj.denoise_batch(np.random.RandomState(0), **kw))


def test_batch_transform(tmp_path):
    path = str(tmp_path / "bb.npz")
    td.make_synthetic_backbone_dataset(path, num_proteins=8, seq_len=40, seed=3)
    ds = td.BackboneDataset.load(path)
    b = ds.denoise_batch(np.random.RandomState(0), batch=2, noise_std=0.5)
    n = 3 * 40
    assert b.tokens.shape == (2, n) and b.clean_coors.shape == (2, n, 3)
    assert b.mask.shape == (2, n) and b.adj_mat.shape == (n, n)
    t = b.tokens.reshape(2, 40, 3)
    assert (t == t[:, :, :1]).all()
    assert np.abs(b.noised_coors - b.clean_coors)[b.mask].mean() > 0.1
    if (~b.mask).any():
        assert np.abs(b.clean_coors[~b.mask]).max() == 0.0
    ca = b.clean_coors.reshape(2, 40, 3, 3)[0, :, 1]
    steps = np.linalg.norm(np.diff(ca, axis=0), axis=-1)
    valid = b.mask.reshape(2, 40, 3)[0, 1:, 0]
    assert np.allclose(steps[valid], 3.8, atol=0.2)
    b_pad = ds.denoise_batch(np.random.RandomState(1), 1, num_residues=50)
    assert b_pad.tokens.shape == (1, 150) and not b_pad.mask[0, 120:].any()


def test_prefetch_delivery_as_tensors(tmp_path):
    path = str(tmp_path / "bb3.npz")
    td.make_synthetic_backbone_dataset(path, num_proteins=4, seq_len=20, seed=2)
    ds = td.BackboneDataset.load(path)
    rng = np.random.RandomState(2)
    loader = PrefetchLoader(lambda: ds.denoise_batch(rng, 2), depth=2, num_batches=3,
                            device="cpu")
    batches = list(loader)
    loader.close()
    assert len(batches) == 3
    b = batches[0]
    assert isinstance(b.clean_coors, torch.Tensor) and b.clean_coors.dtype == torch.float32
    assert b.tokens.dtype == torch.int64 and b.adj_mat.dtype == torch.bool


def test_qm9_layouts_and_batches_match_jax(tmp_path):
    pt, pj = str(tmp_path / "qt.npz"), str(tmp_path / "qj.npz")
    td.make_synthetic_qm9_file(pt, num_molecules=16, max_atoms=18, seed=3)
    jd.make_synthetic_qm9_file(pj, num_molecules=16, max_atoms=18, seed=3)
    ds, dj = td.QM9Dataset.load(pt), jd.QM9Dataset.load(pj)
    for name in ("positions", "tokens", "n_atoms", "targets"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(dj, name))
    assert ds.num_molecules == 16 and ds.max_atoms == 18
    assert ds.tokens.max() <= 5 and ds.tokens.min() >= 0
    # the flat layout round-trips to the same arrays
    N = ds.n_atoms
    zmap = np.asarray(td.QM9Dataset.ATOMIC_NUMBERS + (0,))
    flat = str(tmp_path / "flat.npz")
    np.savez(flat, R=np.concatenate([ds.positions[i, :N[i]] for i in range(16)]),
             Z=np.concatenate([zmap[ds.tokens[i, :N[i]]] for i in range(16)]), N=N,
             U0=ds.targets)
    d2, j2 = td.QM9Dataset.load(flat), jd.QM9Dataset.load(flat)
    A2 = d2.max_atoms
    np.testing.assert_array_equal(d2.positions, ds.positions[:, :A2])
    np.testing.assert_array_equal(d2.tokens, ds.tokens[:, :A2])
    np.testing.assert_array_equal(d2.targets, j2.targets)
    yt, mt, st = ds.normalized_targets()
    yj, mj, sj = dj.normalized_targets()
    np.testing.assert_array_equal(yt, yj)
    assert (mt, st) == (mj, sj)
    bt = ds.batch(np.random.RandomState(0), 4, node_capacity=20, targets=yt)
    bj = dj.batch(np.random.RandomState(0), 4, node_capacity=20, targets=yj)
    for x, y in zip(bt, bj):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    coors, tok, mask, y = bt
    assert coors.shape == (4, 20, 3) and (tok[~mask] == 5).all() and (mask.sum(1) > 0).all()


def test_qm9_missing_target_and_flat_without_counts_raise(tmp_path):
    p = str(tmp_path / "bad.npz")
    np.savez(p, R=np.zeros((2, 3, 3)), Z=np.ones((2, 3)))
    with pytest.raises(ValueError, match="no target"):
        td.QM9Dataset.load(p)
    np.savez(p, R=np.zeros((6, 3)), Z=np.ones(6), y=np.zeros(2))
    with pytest.raises(ValueError, match="needs N"):
        td.QM9Dataset.load(p)


def test_hdf5_without_h5py_raises_the_jax_message(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)   # an import of h5py fails
    path = str(tmp_path / "bb.h5")
    with pytest.raises(ImportError) as got:
        td.BackboneDataset.load(path)
    with pytest.raises(ImportError) as ref:
        jd.BackboneDataset.load(path)
    assert str(got.value) == str(ref.value) and "h5py" in str(got.value)
