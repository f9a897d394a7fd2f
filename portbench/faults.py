"""Faults planted under a cell's timed path, and the lower precisions, for
reading the check's limits and proving that the check fails them. The
benchmark's own runs never import this module.

Each is a context manager that patches the program (or the family module's
reference to it) and restores it on exit:
- ``unchanged``: the optimizer step leaves the training state as it was;
- ``half_batch``: the training loss is taken over the first half of the
  batch; a served answer keeps only the first half of the batch's answers
  and zeros the rest;
- ``answer_altered``: the first row of a served answer moves by 1% of the
  answer's RMS;
- ``tail_nodes``, ``one_tile``: a wrong tile near the end of the rows (at
  k = 8 a 32-row tile of the pair kernels holds 4 nodes): the last 4 valid
  nodes of every chain, or of the first chain alone, move by 1% of their
  chain's RMS move (answer - noised input);
- ``high``, ``medium``: the program under ``torch.set_float32_matmul_
  precision`` "high" (TF32 products in cuBLAS) or "medium" (bfloat16, and
  K10's tensor-core mode).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from egnn_tpu_torch.training import masked_mse
from egnn_tpu_torch.training.state import TrainState

FAULTS = ("unchanged", "half_batch", "answer_altered", "tail_nodes", "one_tile")
PRECISIONS = ("high", "medium")


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _half_molecule_step(model, optimizer):
    state = TrainState(model, optimizer)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        pred = model(batch.x, batch.edge_index, batch.edge_mask, batch.batch_ids,
                     batch.node_mask)
        err = (pred - batch.target)[: pred.shape[0] // 2]
        loss = (err ** 2).mean()
        loss.backward()
        state.apply_gradients()
        return loss.detach(), err.detach().abs().mean()

    step.state = state
    return step


def _half_mse(pred, target, mask):
    half = pred.shape[0] // 2
    return masked_mse(pred[:half], target[:half], mask[:half])


@contextlib.contextmanager
def planted(fault: str, family):
    """``fault`` planted under ``family``'s timed path (see the module's
    docstring)."""
    if fault == "unchanged":
        with _patched(TrainState, "apply_gradients", lambda self, loss=None: loss):
            yield
    elif fault == "half_batch":
        answer = getattr(getattr(family, "Serve", None), "answer", None)

        def half_answer(self, tensors):
            out = answer(self, tensors)
            out[out.shape[0] // 2:] = 0
            return out

        if hasattr(family, "make_train_step"):
            train = _patched(family, "make_train_step", _half_molecule_step)
        else:
            make = family.make_denoise_train_step
            train = _patched(family, "make_denoise_train_step",
                             lambda net, opt: make(net, opt, loss_fn=_half_mse))
        serve = _patched(family.Serve, "answer", half_answer) if hasattr(family, "Serve") \
            else contextlib.nullcontext()
        with train, serve:
            yield
    elif fault == "answer_altered":
        answer = family.Serve.answer

        def altered(self, tensors):
            out = answer(self, tensors)
            out[0] += 0.01 * float(np.sqrt(np.mean(out.astype(np.float64) ** 2)))
            return out

        with _patched(family.Serve, "answer", altered):
            yield
    elif fault in ("tail_nodes", "one_tile"):
        answer = family.Serve.answer
        chains = None if fault == "tail_nodes" else 1

        def tail(self, tensors):
            out = answer(self, tensors)
            noised, mask = tensors[1].numpy().astype(np.float64), tensors[-1].numpy()
            for c in range(out.shape[0])[:chains]:
                valid = np.flatnonzero(mask[c])
                move = out[c][valid] - noised[c][valid]
                rms = float(np.sqrt(np.mean(np.sum(move ** 2, axis=-1))))
                out[c, valid[-4:], 0] += 0.01 * rms
            return out

        with _patched(family.Serve, "answer", tail):
            yield
    elif fault in PRECISIONS:
        old = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(fault)
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(old)
    else:
        raise ValueError(f"unknown fault {fault!r}")
