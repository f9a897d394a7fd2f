"""The port stands alone: it imports nothing of JAX or of the JAX package,
its entry points refuse to fall back to the CPU quietly, the CPU path
never builds a kernel, and ``chip_smoke.py`` fails without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import egnn_tpu_torch
from egnn_tpu_torch.ops.cuda import build

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "egnn_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((REPO / "egnn_tpu_torch").rglob("*.py"))
                         + [REPO / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        egnn_tpu_torch.EGNNNetwork(depth=1, dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        egnn_tpu_torch.EGNN(dim=8)


def test_cpu_path_never_builds_a_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not invoke nvcc")

    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "library", refuse)
    from egnn_tpu_torch.training.data import synthetic_chain_batch

    net = egnn_tpu_torch.EGNN_Network(depth=2, dim=8, num_tokens=21, num_positions=32,
                                      num_nearest_neighbors=4, norm_coors=True,
                                      device="cpu")
    batch = synthetic_chain_batch(np.random.default_rng(0), 2, 32, device="cpu")
    feats, coors = net(batch.tokens, batch.noised_coors, adj_mat=batch.adj_mat,
                       mask=batch.mask)
    assert torch.isfinite(feats).all() and torch.isfinite(coors).all()
    # the grid route: K7's, K8's and K9's plain versions
    from egnn_tpu_torch.ops import neighbors
    from egnn_tpu_torch.ops.cuda import grid_knn

    monkeypatch.setattr(grid_knn, "_MIN_N", 1024)
    monkeypatch.setattr(neighbors, "_WINDOW_REPAIR_MIN_N", 0)
    coors = torch.from_numpy(np.random.RandomState(0).randn(1, 4096, 3).astype(np.float32))
    nbhd = neighbors.knn_select(coors * 10.0, 5, float("inf"))
    assert nbhd.indices.shape == (1, 4096, 5) and nbhd.winner is None


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """With no visible GPU, and alone in a directory without the package,
    the script must exit non-zero and print no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
