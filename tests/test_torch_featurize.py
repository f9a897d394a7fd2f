"""The port's protein featurization (``egnn_tpu_torch/ops/featurize.py``)
against ``egnn_tpu.ops.featurize`` on the same inputs, as
``tests/test_featurize.py`` holds the JAX package: integers, masks, edges and
strings exactly; the float32 sin/cos encodings at 1e-6 (XLA's and torch's
CPU sin/cos may round the last bit apart)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import featurize as jf
from egnn_tpu_torch import EGNNSparseNetwork
from egnn_tpu_torch.ops import featurize as tf

SIN_COS_TOL = 1e-6
SEQS = ["GAW", "GAP", "MAGICW", "ACDEFGHIKLMNPQRSTVWY"]


def test_tables_and_cloud_masks_match():
    assert tf.AA_ORDER == jf.AA_ORDER and tf.AAS2NUM == jf.AAS2NUM
    assert tf.NUM_COORDS_PER_RES == jf.NUM_COORDS_PER_RES == 14
    for aa in tf.AA_ORDER:
        assert tf.atoms_per_residue(aa) == jf.atoms_per_residue(aa)
    assert (tf.atoms_per_residue("G"), tf.atoms_per_residue("A"),
            tf.atoms_per_residue("W")) == (4, 5, 14)
    for seq in SEQS:
        np.testing.assert_array_equal(tf.scn_cloud_mask(seq), jf.scn_cloud_mask(seq))
        np.testing.assert_array_equal(tf.aa_ids(seq), jf.aa_ids(seq))


@pytest.mark.parametrize("include_self", [True, False])
def test_encode_dist_matches(include_self):
    x = np.random.RandomState(0).rand(7, 3).astype(np.float32) * 50
    scales = [1, 2, 4, 8]
    got = tf.encode_dist(torch.from_numpy(x), scales, include_self=include_self)
    ref = np.asarray(jf.encode_dist(jnp.asarray(x), scales, include_self=include_self))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SIN_COS_TOL)
    # the values the JAX test pins
    e = tf.encode_dist(torch.tensor([0.0, 1.0, 2.0]), [1, 2])
    np.testing.assert_allclose(e[1].numpy(), [np.sin(1), np.sin(0.5), np.cos(1),
                                              np.cos(0.5), 1.0], rtol=1e-6)


def test_encode_dist_and_chain2atoms_make_tensors_on_the_device_asked():
    e = tf.encode_dist(np.arange(3, dtype=np.float32), [2], device="cpu")
    assert isinstance(e, torch.Tensor) and e.device.type == "cpu" and e.shape == (3, 3)
    x = torch.arange(3.0)
    out = tf.chain2atoms(x)
    assert out.shape == (3, tf.NUM_COORDS_PER_RES) and bool((out[1] == 1.0).all())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jf.chain2atoms(jnp.arange(3.0))))
    two = tf.chain2atoms(np.ones((4, 2)), num_atoms=5, device="cpu")
    assert two.shape == (4, 5, 2)


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_covalent_bonds_match(seq, degree):
    idx_t, attr_t = tf.prot_covalent_bond(seq, adj_degree=degree)
    idx_j, attr_j = jf.prot_covalent_bond(seq, adj_degree=degree)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(attr_t, attr_j)
    assert idx_t.dtype == np.int32 and attr_t.dtype == np.float32


def test_covalent_bond_chemistry():
    idx, attr = tf.prot_covalent_bond("GAP", adj_degree=1)
    pairs = set(zip(idx[0].tolist(), idx[1].tolist()))
    assert all((b, a) in pairs for a, b in pairs)
    assert (attr == 1.0).all()
    assert {(0, 1), (1, 2), (2, 3), (2, 4), (5, 8), (15, 9)} <= pairs
    assert (3, 0) not in pairs


def test_encode_whole_protein_matches_and_feeds_the_network():
    seq = "MAGICW"
    coords = np.random.RandomState(0).randn(len(seq) * 14, 3).astype(np.float32)
    xt, eit, eat, info_t = tf.encode_whole_protein(seq, coords, aa_pos_scales=[2, 4],
                                                   adj_degree=2)
    xj, eij, eaj, info_j = jf.encode_whole_protein(seq, coords, aa_pos_scales=[2, 4],
                                                   adj_degree=2)
    assert info_t == info_j and xt.shape == xj.shape and xt.dtype == np.float32
    np.testing.assert_array_equal(eit, eij)
    np.testing.assert_array_equal(eat, eaj)
    np.testing.assert_array_equal(xt[:, :3], xj[:, :3])        # coordinates
    np.testing.assert_array_equal(xt[:, -2:], xj[:, -2:])      # the id columns
    np.testing.assert_allclose(xt[:, 3:-2], xj[:, 3:-2], rtol=0, atol=SIN_COS_TOL)
    x2, *_ = tf.encode_whole_protein(seq + "GG", coords, padding_seq=2, aa_pos_scales=[2, 4])
    assert x2.shape[0] == info_t["num_atoms"]

    net = EGNNSparseNetwork(n_layers=2, feats_dim=2, pos_dim=3, edge_attr_dim=1, m_dim=8,
                            fourier_features=2, embedding_nums=[14, 20], embedding_dims=[4, 4],
                            norm_feats=True, device="cpu")
    x_in = torch.from_numpy(np.concatenate([xt[:, :3], xt[:, -2:]], axis=-1))
    out = net(x_in, torch.from_numpy(eit).long(), edge_attr=torch.from_numpy(eat)[:, None])
    assert out.shape[0] == info_t["num_atoms"] and bool(torch.isfinite(out).all())
