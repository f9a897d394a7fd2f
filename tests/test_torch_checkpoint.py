"""Checkpoints of the port (``egnn_tpu_torch/training/checkpoint.py``), as
``tests/test_checkpoint.py`` holds the JAX package's: a save and restore
round trip of the module and its optimizer, bit for bit, synchronous and in
the background; ``max_to_keep``; the latest step; and the optimizers' whole
state through ``state_dict()`` / ``load_state_dict()`` inside an
accumulation window (the next updates bitwise equal)."""
import copy
import io

import numpy as np
import pytest
import torch

from egnn_tpu_torch import EGNN
from egnn_tpu_torch.training import CheckpointManager, make_adam, make_fused_adam

OPTIMIZERS = {
    "adam_accum": lambda ps: make_adam(ps, 1e-2, grad_accum=4),
    "adam_clip": lambda ps: make_adam(ps, 1e-2, clip_norm=0.5),
    "fused_adam": lambda ps: make_fused_adam(ps, 1e-2),
}


def _layer(seed=0):
    return EGNN(dim=8, num_nearest_neighbors=4, device="cpu",
                generator=torch.Generator().manual_seed(seed))


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, 10, 8, generator=g, dtype=torch.float32),
            torch.randn(1, 10, 3, generator=g, dtype=torch.float32))


def _step(layer, opt, seed):
    opt.zero_grad(set_to_none=True)
    feats, coors = _inputs(seed)
    f, c = layer(feats, coors)
    ((f ** 2).mean() + (c ** 2).mean()).backward()
    opt.step()


def _opt_tensors(opt):
    return [(k, name, v) for k, st in opt.state_dict()["state"].items()
            for name, v in sorted(st.items())]


def _assert_same(layer_a, opt_a, layer_b, opt_b):
    for (na, a), (nb, b) in zip(layer_a.named_parameters(), layer_b.named_parameters()):
        assert na == nb and torch.equal(a, b), na
    ta, tb = _opt_tensors(opt_a), _opt_tensors(opt_b)
    assert len(ta) == len(tb)
    for (ka, na, a), (kb, nb, b) in zip(ta, tb):
        assert (ka, na) == (kb, nb) and a.dtype == b.dtype and torch.equal(a, b), (ka, na)
    assert getattr(opt_a, "mini_step", None) == getattr(opt_b, "mini_step", None)


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_state_dict_round_trip_inside_an_accumulation_window(opt_name):
    make = OPTIMIZERS[opt_name]
    layer = _layer()
    opt = make(layer.parameters())
    for s in range(6):            # 6 micro-steps: inside the second window of 4
        _step(layer, opt, s)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    twin = copy.deepcopy(layer)
    twin_opt = make(twin.parameters())
    twin_opt.load_state_dict(torch.load(buf, weights_only=True))
    _assert_same(layer, opt, twin, twin_opt)
    for s in range(6, 11):        # across the window's end and into the next
        _step(layer, opt, s)
        _step(twin, twin_opt, s)
        _assert_same(layer, opt, twin, twin_opt)


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_save_restore_round_trip(tmp_path, async_save):
    layer = _layer()
    opt = make_adam(layer.parameters(), 1e-3, grad_accum=2)
    for s in range(3):
        _step(layer, opt, s)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=async_save)
    mgr.save(3, layer, opt, extra={"seed": 7})
    mgr.wait()
    assert mgr.latest_step() == 3
    snapshot = (copy.deepcopy(layer), copy.deepcopy(opt.state_dict()))
    _step(layer, opt, 99)                       # moves on after the save
    fresh = _layer(seed=1)
    fresh_opt = make_adam(fresh.parameters(), 1e-3, grad_accum=2)
    info = mgr.restore(fresh, fresh_opt)
    mgr.close()
    assert info == {"step": 3, "extra": {"seed": 7}}
    ref_opt = make_adam(snapshot[0].parameters(), 1e-3, grad_accum=2)
    ref_opt.load_state_dict(snapshot[1])
    _assert_same(snapshot[0], ref_opt, fresh, fresh_opt)


def test_max_to_keep_latest_and_missing(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=2, async_save=True)
    layer = _layer()
    with pytest.raises(FileNotFoundError):
        mgr.restore(layer)
    assert mgr.latest_step() is None
    for step in (1, 5, 12):
        mgr.save(step, layer)
    mgr.wait()
    assert mgr.steps() == [5, 12] and mgr.latest_step() == 12
    with pytest.raises(FileNotFoundError):
        mgr.restore(layer, step=1)
    assert mgr.restore(layer, step=5)["step"] == 5
    assert not list((tmp_path / "c").glob("*.tmp"))
    mgr.close()


def test_a_failed_background_save_raises_in_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "c"))

    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    mgr.save(1, _layer())
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()
    assert mgr.latest_step() is None
    np.testing.assert_equal(list((tmp_path / "c").iterdir()), [])
