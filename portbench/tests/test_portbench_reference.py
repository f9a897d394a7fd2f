"""The plain reference against the program (``egnn_tpu_torch``) at tiny
sizes on the CPU, on the same seeded weights and inputs."""
import statistics

import numpy as np
import pytest
import torch

from portbench import compare, loops, weights

from ._tiny import CPU, tiny_cell


def _weights(cell, seed=5):
    return weights.make(cell.family.REFERENCE.param_shapes(cell.config), seed, CPU,
                        cell.mix["weights"])


@pytest.mark.parametrize("name", ["dense_knn_readme.serve_b64"])
def test_forward_matches(name):
    cell = tiny_cell(name)
    fam, cfg, mix = cell.family, cell.config, cell.mix
    w0 = _weights(cell)
    prog = fam.Serve(cfg, mix, w0, CPU)
    for r in range(2):
        arrays = fam.serve_request(cfg, mix, 9, r)
        out = prog.answer([torch.from_numpy(a) for a in arrays])
        ref = fam.REFERENCE.serve(w0, cfg, tuple(torch.from_numpy(a) for a in arrays)).numpy()
        assert out.shape == ref.shape
        assert fam.answer_numbers(out, ref, arrays)["node_gap"] < 1e-4
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


# the QM9 mix's Adam steps (lr 1e-3) swing the loss several-fold and carry
# the first step's rounding on further than the dense mix's
@pytest.mark.parametrize("name,rtol", [("sparse_qm9.train_g96", 1e-4),
                                       ("dense_knn_readme.train_b8", 1e-5)])
def test_training_matches(name, rtol):
    cell = tiny_cell(name)
    fam, cfg, mix = cell.family, cell.config, cell.mix
    mix["check_steps"] = 3
    mix["optimizer"] = {**mix["optimizer"], "grad_accum": min(2, mix["optimizer"]["grad_accum"])}
    w0 = _weights(cell)
    prog = fam.Train(cfg, mix, w0, CPU)
    const = fam.constants(cfg, mix, CPU)
    losses, grad = [], None
    for i in range(3):
        arrays = fam.train_batch(cfg, mix, 4, i)
        losses.append(float(prog.call(*fam.train_args(
            cfg, tuple(torch.from_numpy(a) for a in arrays), const))))
        grad = grad or loops._first_grads(prog.model, prog.optimizer)
    ref = loops.train_reference(cell, 4, w0, CPU)
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-6)
    np.testing.assert_allclose(losses, ref["losses"], rtol=rtol)
    # by the median leaf: the dense network's zero-length self pair leaves
    # its +-1e6 CoorsNorm terms' rounding in a few leaves (PERF.md)
    gaps = compare.leaf_gaps(grad, ref["grad"], compare.kept_leaves(ref))
    assert statistics.median(gaps.values()) < 1e-6, gaps
    after = dict(prog.model.named_parameters())
    change = compare.leaf_norms({k: after[k].detach() - w0[k] for k in w0})
    for k in w0:
        assert change[k] == pytest.approx(ref["change"][k], rel=1e-3, abs=1e-9), k


def test_weights_follow_the_seed():
    cell = tiny_cell("dense_knn_readme.train_b8")
    a, b, c = _weights(cell, 2 ** 31 + 3), _weights(cell, 2 ** 31 + 3), _weights(cell, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
