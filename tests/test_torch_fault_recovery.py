"""Fault injection and recovery of the port's denoise trainer, the
counterpart of ``tests/test_fault_recovery.py``: a trainer SIGKILLs itself
right after the checkpoint of micro-step 2 lands, inside a window of 4
accumulated micro-steps; a second run resumes from that checkpoint and
finishes; its final parameters and optimizer state equal an uninterrupted
run's bit for bit (the batches are keyed by micro-step, so any difference
means the checkpoint missed state).

This file is also the trainer that the test starts:
``python tests/test_torch_fault_recovery.py --ckpt-dir D --steps 6
[--kill-at 2] [--resume]`` runs ``egnn_tpu_torch.examples.denoise`` on the
CPU at a small size, checkpointing every micro-step, and with ``--kill-at``
SIGKILLs itself right after the checkpoint of that micro-step lands. Any
other argument goes to the trainer and overrides the small size
(``chip_smoke.py`` kills the example's full-size run on the card so).
"""
import argparse
import os
import signal
import subprocess
import sys
from pathlib import Path

import torch

STEPS, KILL_AT, GRAD_ACCUM = 6, 2, 4
SMALL_CPU = ["--device", "cpu", "--steps", str(STEPS), "--nodes", "48", "--depth", "2",
             "--dim", "8", "--knn", "4", "--grad-accum", str(GRAD_ACCUM), "--lr", "1e-2",
             "--ckpt-every", "1"]


def _run(ckpt_dir, kill_at=None, timeout=300):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--ckpt-dir", str(ckpt_dir),
           "--resume"]
    if kill_at is not None:
        cmd += ["--kill-at", str(kill_at)]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          cwd=Path(__file__).resolve().parent.parent)


def _final(ckpt_dir):
    return torch.load(Path(ckpt_dir) / f"ckpt_{STEPS:09d}.pt", weights_only=True)


def _assert_bitwise(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_bitwise(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_kill_and_resume_is_bit_exact(tmp_path):
    crashed, clean = tmp_path / "crashed", tmp_path / "clean"
    r1 = _run(crashed, kill_at=KILL_AT)
    assert r1.returncode == -signal.SIGKILL, (r1.returncode, r1.stdout, r1.stderr)
    assert f"KILLING at step {KILL_AT}" in r1.stdout and "SUMMARY" not in r1.stdout
    r2 = _run(crashed)
    assert r2.returncode == 0, (r2.stdout, r2.stderr)
    assert f"RESUMED from step {KILL_AT}" in r2.stdout, r2.stdout
    r3 = _run(clean)
    assert r3.returncode == 0, (r3.stdout, r3.stderr)
    assert "RESUMED" not in r3.stdout
    resumed, uninterrupted = _final(crashed), _final(clean)
    assert resumed["optimizer"]["mini_step"] == STEPS % GRAD_ACCUM
    _assert_bitwise(resumed, uninterrupted)


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from egnn_tpu_torch.examples import denoise

    ap = argparse.ArgumentParser()
    ap.add_argument("--kill-at", type=int, default=None)
    args, trainer_args = ap.parse_known_args()

    def on_checkpoint(step):
        if step == args.kill_at:
            print(f"KILLING at step {step}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    denoise.main(SMALL_CPU + trainer_args, on_checkpoint=on_checkpoint)


if __name__ == "__main__":
    main()
