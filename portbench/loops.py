"""The two traffic loops every mix runs through, and their reference runs.

``train``: set-up builds the family's training step once, captures it as the
example trainers' ``--block`` path does (``capture_step``: a CUDA graph
replayed a micro-step), and drives it through the mix's first
``check_steps`` micro-steps through the same call and feed the window uses;
what the optimizer holds after the first and the parameters after the last
are kept for the check. The window's batches come from ``pool_blocks``
blocks of ``block`` micro-steps drawn in set-up (a data set held in pinned
host memory, taken in turn as epochs); the window runs block after block: a
block's replays are queued, the next block's batches are copied to the card
while it runs them, and the block's losses are read once. It ends at the
read after the last whole block at or past ``seconds``.

``serve``: set-up draws a pool of ``pool`` requests and serves ``warmup``
of them. The window's load is a backlog offered all at once, above what the
server completes: one server answers request after request (request i is
pool entry i % pool), each as soon as the one before it is on the host,
until ``seconds`` have passed. The rate is the graphs of every request
answered over the whole window, which ends at the last answer. A sample of
``sample`` answered requests, drawn from the seed as they come (a
reservoir), keeps its answers for the check.

A traced run (``trace``) profiles ``trace_blocks`` blocks or
``trace_requests`` requests in place of the timed window, each inside a
``portbench.unit`` range.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from egnn_tpu_torch.training import capture_step

from . import compare, data, trace
from . import weights as W

def set_precision(tf32: bool) -> None:
    """float32 products in full float32 (the configurations' precision), or
    in TF32 (the control's)."""
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_tensors(arrays, device) -> list:
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [t.pin_memory() for t in ts] if device.type == "cuda" else ts


def _block(batches: list, device) -> list:
    """A block's host batches stacked field by field (pinned on a card)."""
    return host_tensors([np.stack(f) for f in zip(*batches)], device)


def _stage(block: list, device) -> list:
    """A block copied to the device at once, a copy a field; one tuple of
    device tensors a micro-step."""
    fields = [t.to(device, non_blocking=True) for t in block]
    return [tuple(f[j] for f in fields) for j in range(fields[0].shape[0])]


def _profiler(traced: bool, device):
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def _unit(traced: bool):
    return torch.profiler.record_function(trace.UNIT) if traced else contextlib.nullcontext()


def _first_grads(model, optimizer) -> dict:
    """The first gradient as the optimizer holds it after one micro-step:
    the accumulated mean (one micro-step's gradient) under accumulation,
    else Adam's first moment over (1 - b1)."""
    b1 = optimizer.param_groups[0]["b1"]
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        out[name] = st["acc"] if optimizer.grad_accum > 1 else st["m"] / (1.0 - b1)
    return compare.leaf_norms(out)


def _memory(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def train(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    fam, cfg, mix = cell.family, cell.config, cell.mix
    w0 = W.make(fam.REFERENCE.param_shapes(cfg), seed, device, mix["weights"])
    prog = fam.Train(cfg, mix, w0, device)
    const = fam.constants(cfg, mix, device)
    step = capture_step(prog.call, prog.state)
    block, checks = mix["block"], mix["check_steps"]

    staged = _stage(_block([fam.train_batch(cfg, mix, seed, i) for i in range(checks)],
                           device), device)
    losses = [step(*fam.train_args(cfg, staged[0], const))]
    grad = _first_grads(prog.model, prog.optimizer)
    losses += [step(*fam.train_args(cfg, b, const)) for b in staged[1:]]
    params = dict(prog.model.named_parameters())
    check = {"losses": torch.stack(losses).tolist(), "grad": grad,
             "change": compare.leaf_norms({k: params[k].detach() - w0[k] for k in w0})}

    pool = []
    for j in range(mix["pool_blocks"]):
        first = checks + j * block
        host = [fam.train_batch(cfg, mix, seed, i) for i in range(first, first + block)]
        pool.append((_block(host, device), [fam.valid_counts(cfg, h) for h in host]))

    def ahead(j):
        return _stage(pool[j % len(pool)][0], device), pool[j % len(pool)][1]

    nxt, nxt_counts = ahead(0)
    _sync(device)
    setup_peak = _memory(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    done, failed, blocks, counts = 0, 0, 0, []
    prof = _profiler(traced, device)
    t0 = time.perf_counter()
    with prof:
        while True:
            with _unit(traced):
                outs = [step(*fam.train_args(cfg, b, const)) for b in nxt]
                counts += nxt_counts
                nxt, nxt_counts = ahead(blocks + 1)
                values = torch.stack(outs).tolist()     # the block's one read
            done += len(values)
            failed += sum(not math.isfinite(v) for v in values)
            blocks += 1
            t1 = time.perf_counter()
            if (blocks >= mix["trace_blocks"]) if traced else (t1 - t0 >= seconds):
                break
    window_peak = _memory(device)
    out = {"check": check, "w0": w0, "attempted": done, "failed": failed,
           "memory_peak_bytes": max(setup_peak, window_peak),
           "e2e": {"setup_s": setup_s, "peak_mem_gib": window_peak / 2 ** 30,
                   "train_edges_per_s": done * fam.slots(cfg, mix) / (t1 - t0)}}
    if traced:
        out["reading"] = trace.profile_to_reading(prof, done)
        out["reading"].counts = counts
    return out


def train_reference(cell, seed: int, w0: dict, device, dtype=torch.float32) -> dict:
    """The reference's readings over the same weights and check batches, in
    ``dtype`` (float64: the exact arithmetic the float32 sides are measured
    against)."""
    fam, cfg, mix = cell.family, cell.config, cell.mix

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    batches = [tuple(cast(torch.from_numpy(a).to(device))
                     for a in fam.train_batch(cfg, mix, seed, i))
               for i in range(mix["check_steps"])]
    opt = mix["optimizer"]
    w0 = {k: cast(v) for k, v in w0.items()}
    losses, first, after = fam.REFERENCE.train(w0, cfg, batches, opt["lr"], opt["grad_accum"])
    return {"losses": losses, "grad": compare.leaf_norms(first),
            "change": compare.leaf_norms({k: after[k] - w0[k] for k in w0})}


def backlog(answer, pool: list, seconds: float, count, traced: bool, device, sample: int,
            g: np.random.Generator) -> tuple:
    """Requests answered back to back by ``answer(pool[i % len(pool)])``
    until ``seconds`` have passed, or ``count`` requests where it is given:
    (requests answered, seconds from the first request to the last answer,
    {i: answer} of a uniform sample of ``sample`` of them drawn by ``g``,
    the profiler or None)."""
    kept, done = [], 0
    prof = _profiler(traced, device)
    t0 = time.perf_counter()
    with prof:
        while True:
            with _unit(traced):
                out = answer(pool[done % len(pool)])
            if done < sample:
                kept.append((done, out))
            else:
                j = int(g.integers(done + 1))
                if j < sample:
                    kept[j] = (done, out)
            done += 1
            t1 = time.perf_counter()
            if (done >= count) if count else (t1 - t0 >= seconds):
                break
    return done, t1 - t0, dict(kept), prof if traced else None


def serve(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    fam, cfg, mix = cell.family, cell.config, cell.mix
    w0 = W.make(fam.REFERENCE.param_shapes(cfg), seed, device, mix["weights"])
    prog = fam.Serve(cfg, mix, w0, device)
    host = [fam.serve_request(cfg, mix, seed, r) for r in range(mix["pool"])]
    pool = [host_tensors(h, device) for h in host]
    for r in range(mix["warmup"]):
        prog.answer(pool[r % len(pool)])
    _sync(device)
    setup_peak = _memory(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    done, elapsed, kept, prof = backlog(
        prog.answer, pool, seconds, mix["trace_requests"] if traced else None, traced, device,
        mix["sample"], data.rng(seed, data.SAMPLE, 0))
    window_peak = _memory(device)
    out = {"kept": kept, "host": host, "w0": w0, "attempted": done, "failed": 0,
           "memory_peak_bytes": max(setup_peak, window_peak),
           "e2e": {"setup_s": setup_s, "peak_mem_gib": window_peak / 2 ** 30,
                   "serve_graphs_per_s": done * mix["batch"] / elapsed}}
    if traced:
        out["reading"] = trace.profile_to_reading(prof, done)
        counts = [fam.valid_counts(cfg, h) for h in host]
        out["reading"].counts = [counts[i % len(counts)] for i in range(done)]
    return out


def serve_reference(cell, kept: dict, host: list, w0: dict, device,
                    detail: bool = False) -> dict:
    """The family's numbers of each sampled answer against the reference's
    answer to the same request (``answer_numbers``), each the largest over
    the sample."""
    fam, cfg = cell.family, cell.config
    numbers = {}
    for i, answer in sorted(kept.items()):
        arrays = host[i % len(host)]
        ref = fam.REFERENCE.serve(w0, cfg, tuple(torch.from_numpy(a).to(device)
                                                 for a in arrays))
        for k, v in fam.answer_numbers(answer, ref.cpu().numpy(), arrays, detail).items():
            numbers[k] = max(numbers.get(k, v), v)
    return numbers


def release() -> None:
    """Free what the program's run left on the card before the reference."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
