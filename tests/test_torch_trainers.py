"""The port's trainers (``egnn_tpu_torch/examples``) on the CPU at a small
size: the denoise trainer on synthetic chains and on a backbone file (its
held-out MSE falls), and the molecule trainer in each of its three modes
(edges built on the device, a QM9-format file, the host builder through
``PrefetchLoader``): finite losses whose mean over the last ten steps is
below the first ten's. The host-built and device-built batches of one step
are the same molecules."""
import math

import numpy as np
import pytest
import torch

from egnn_tpu_torch.examples import denoise, molecule_regression as mr
from egnn_tpu_torch.training import to_tensors

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's default of one thread a core oversubscribes them
    many times over (these tests then ran some 20x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL_DENOISE = ["--device", "cpu", "--steps", "16", "--nodes", "96", "--depth", "2",
                 "--grad-accum", "1", "--lr", "3e-3"]


@pytest.mark.parametrize("data", [False, True], ids=["synthetic", "file"])
def test_denoise_trainer_learns(tmp_path, data):
    argv = SMALL_DENOISE + (["--make-data", str(tmp_path / "bb.npz"), "--data-proteins", "8"]
                            if data else [])
    s = denoise.main(argv + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "8"])
    assert len(s["losses"]) == 16 and all(math.isfinite(v) for v in s["losses"])
    assert s["eval_mse"] < s["eval_mse_start"]
    assert sorted(p.name for p in (tmp_path / "ck").glob("ckpt_*.pt")) == [
        "ckpt_000000008.pt", "ckpt_000000016.pt"]
    # a resumed run at its end has nothing left to do and keeps the weights
    again = denoise.main(argv + ["--ckpt-dir", str(tmp_path / "ck"), "--resume"])
    assert again["start"] == 16 and again["losses"] == []
    assert again["eval_mse"] == s["eval_mse"]


@pytest.mark.parametrize("mode", ["device", "qm9", "host"])
def test_molecule_trainer_learns(tmp_path, mode):
    extra = {"device": [], "qm9": ["--make-qm9", str(tmp_path / "q.npz")],
             "host": ["--host-graphs"]}[mode]
    s = mr.main(["--device", "cpu", "--steps", "40", "--graphs", "4", "--lr", "3e-3"] + extra)
    losses = np.asarray(s["losses"])
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()


def test_host_and_device_batches_are_the_same_molecules():
    host = to_tensors(mr.host_batch(3, 4, 16, 8), device="cpu")
    dev = mr.device_batch(3, 4, 16, 8, "cpu")
    for name in ("x", "batch_ids", "node_mask", "target", "edge_mask"):
        assert torch.equal(getattr(host, name), getattr(dev, name)), name
    m = host.edge_mask
    assert torch.equal(host.edge_index[:, m], dev.edge_index[:, m])
