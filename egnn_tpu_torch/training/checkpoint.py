"""Checkpoints of a module and its optimizer, saved and restored by step:
the counterpart of ``egnn_tpu/training/checkpoint.py`` (orbax there).

A checkpoint is one ``torch.save`` file, ``ckpt_<step>.pt``, holding
``{"step", "model", "optimizer", "extra"}``: the module's ``state_dict``,
the optimizer's (the port's optimizers carry all their state in it, the
gradient-accumulation counter included) and a small dict of the caller's
own (plain Python values and tensors). Every write goes to a temporary file
of its own that is renamed into place, so a process killed in the middle of
a save leaves the last complete checkpoint, and nothing half written, as
the latest.
"""
from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Any, Optional

import torch
from torch import nn

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to host memory (a
    device-to-host copy that waits for the device, or a clone of a CPU
    tensor), so that training may go on changing the originals."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Save and restore (module, optimizer, extra) by step in ``directory``.

    ``max_to_keep`` newest checkpoints are kept. With ``async_save`` a save
    copies every tensor to the host on the caller's thread and writes the
    file on one background thread; ``wait()`` joins it (and raises its
    error), and a new save waits for the one before it.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step:09d}.pt"

    def steps(self) -> list[int]:
        """The steps on disk, ascending."""
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        """The newest step on disk, or None. A save still being written is
        not on disk yet: ``wait()`` first."""
        steps = self.steps()
        return steps[-1] if steps else None

    def _write(self, step: int, state: dict) -> None:
        path = self._path(step)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def _write_in_background(self, step: int, state: dict) -> None:
        try:
            self._write(step, state)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def save(self, step: int, module: nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             extra: Optional[dict] = None) -> None:
        """Checkpoint ``module`` (and ``optimizer``, ``extra``) as ``step``."""
        self.wait()
        state = _to_host({
            "step": int(step),
            "model": module.state_dict(),
            "optimizer": None if optimizer is None else optimizer.state_dict(),
            "extra": extra,
        })
        if not self.async_save:
            self._write(step, state)
            return
        self._thread = threading.Thread(target=self._write_in_background,
                                        args=(step, state), daemon=True)
        self._thread.start()

    def restore(self, module: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                step: Optional[int] = None) -> dict:
        """Fill ``module`` and ``optimizer`` in place from the checkpoint of
        ``step`` (the latest by default); returns ``{"step", "extra"}``.
        Raises ``FileNotFoundError`` when there is none."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None or not self._path(step).exists():
            raise FileNotFoundError(f"no checkpoint{'' if step is None else f' {step}'} in "
                                    f"{self.directory}")
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        module.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        return {"step": state["step"], "extra": state["extra"]}

    def wait(self) -> None:
        """Join a background save; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def close(self) -> None:
        self.wait()
