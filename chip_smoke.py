"""Smoke run of egnn_tpu_torch on one NVIDIA GPU: builds the CUDA kernels from
the checkout, holds each against its plain PyTorch version, serves the
anchor-3 EGNN_Network forward, trains it, checks the outputs, and times the
kernels and the train step.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):
1. the card's name and power limit; the kernels' build time;
2. kernels: K1 (kNN selection + payload gather) and K3 (selection only) on
   the card against their plain versions, bitwise, over the cases below;
3. serving: EGNNNetwork at anchor-3 width (depth 3, dim 32, 21 tokens, 1024
   positions and nodes, kNN 8, node mask, chain adjacency, norm_coors, clamp
   2.0; random weights from a seed) answers requests at b=1 and b=8; the
   outputs are finite, agree with the same module on the CPU, are
   E(3)-equivariant, and K1 ran depth times per forward;
4. selection: the neighbour-list entry point ``knn_select`` answers the same
   requests through K3;
5. timing: forward latency (CUDA events around the call), its device time
   (a CUDA graph replay) and kernel time by name (torch.profiler); each
   kernel beside its plain version and its bound;
6. K2 (segment sum) on the card against its plain version over the cases
   below: three launches bitwise equal, and within the worst-case error of
   a sequential f32 sum of the float64 result;
7. K1's backward: the table's gradient through K1 + K2 on the card against
   a plain CPU gather's autograd, and one K2 launch per backward;
8. training: the anchor-3 denoising train step (masked MSE, flat-buffer
   Adam, lr 1e-3) at b=1 and b=8: finite losses, K1 and K2 launched depth
   times a step, and the loss falling over 50 steps on one batch;
9. one step on the card against the same step on the CPU: loss and every
   parameter's gradient;
10. timing of the train step (latency, edges/s, profile, CUDA graph replay)
   and of K2 beside its plain version, its bound and ``index_add_``.

The last lines: a JSON line of the kernels, the card's ``nvidia-smi`` line,
then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# anchor configuration 3 (bench.py:23-24, examples/export_serving.py:34-38)
DEPTH, DIM, N, KNN, NUM_TOKENS = 3, 32, 1024, 8, 21
LAYER_KWARGS = dict(num_nearest_neighbors=KNN, norm_coors=True, coor_weights_clamp_value=2.0)
SEED = 0

# f32 on the card against f32 on the CPU (cuBLAS vs CPU matmul rounding,
# ~1e-7 relative per op, through 3 layers of coordinates up to |x| ~ 40).
GPU_VS_CPU_ATOL = 1e-4
# rotated inputs: f32 rounding of the rotated coordinates, same scale
EQUIVARIANCE_ATOL = 1e-4

# one train step on the card against the CPU: the loss at this rtol, and
# each parameter's gradient by ||g_gpu - g_cpu|| <= tol * ||g_cpu|| + 1e-12
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-5  # measured: 3.6e-7 at most (H100, PERF.md)
TRAIN_STEPS, FALL_STEPS, LR = 10, 50, 1e-3

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def knn_inputs(torch, b, n, k, with_mask, with_adj, ties, seed):
    """coors, mask, adj (b, n, n; an expanded chain when b == 1, else a chain
    plus random edges per graph) and the [coors | mask | feats] table."""
    g = torch.Generator().manual_seed(seed)
    if ties:  # integer grid: every distance ties many times over
        coors = torch.randint(-2, 3, (b, n, 3), generator=g).float()
    else:
        coors = 3.0 * torch.randn(b, n, 3, generator=g)
    feats = torch.randn(b, n, DIM, generator=g)
    mask = adj = None
    parts = [coors]
    if with_mask:
        lengths = torch.randint(int(0.6 * n), n + 1, (b, 1), generator=g)
        mask = torch.arange(n)[None, :] < lengths
        parts.append(mask[..., None].float())
    parts.append(feats)
    if with_adj:
        ar = torch.arange(n)
        chain = (ar[:, None] - ar[None, :]).abs() == 1
        if b == 1:
            adj = chain.expand(b, n, n)
        else:
            extra = torch.rand(b, n, n, generator=g) < 0.01
            adj = chain | extra | extra.transpose(1, 2)
    cuda = lambda t: None if t is None else t.cuda()  # noqa: E731
    return cuda(coors), cuda(mask), cuda(adj), cuda(torch.cat(parts, dim=-1))


def same_bits(torch, a, b) -> bool:
    a, b = a.contiguous(), b.contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def device_ms(torch, fn, reps=20, trials=7) -> float:
    """Median device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph, replayed between two CUDA events (no host launch gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(torch, fn, iters=30, warmup=5) -> float:
    """Median time of one ``fn()`` call as a caller sees it: CUDA events
    recorded on either side of the call, host launch time included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_forward(torch, fn, iters=10, label="b=1 forwards", unit="forward") -> float:
    """Device time by kernel over ``iters`` calls (torch.profiler); returns
    the kernel time of one call in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # kernels only: an aten op's entry repeats the time of the kernels it
    # launched, and a user annotation (the optimizer's step) spans kernels
    # and the host's gaps between them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events)
    print(f"profile of {iters} {label}: kernel time {total / iters / 1e3:.4f} ms "
          f"per {unit} over {len(events)} kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / iters / 1e3:.5f} ms/{unit} "
              f"{e.count // iters:4d} calls  {e.key[:90]}")
    return total / iters / 1e3


def knn_bound(b, n, c, k, tw, with_mask, adj_bytes):
    """(bound_ms, bound_by) of K1 (tw > 0) or K3 (tw == 0): each input read
    once and each output written once over the HBM rate, against the f32
    operations over the f32 peak: per pair 3c for the distance, one fill
    select and two compares with the running k-th."""
    nbytes = (4 * b * n * c + (b * n if with_mask else 0) + adj_bytes
              + 4 * b * n * tw                      # table
              + b * n * k * (4 + 8)                 # vals f32, idx i64
              + 4 * b * n * k * tw)                 # rows
    ops = b * n * n * (3 * c + 3)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def segment_bound(b, e, s, d):
    """(bound_ms, bound_by) of K2: data, int64 ids and output over the HBM
    rate, against one f32 add per data element over the f32 peak."""
    nbytes = b * (4 * e * d + 8 * e + 4 * s * d)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, b * e * d / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def segment_reference(torch, plain, data, ids, s):
    """The float64 plain segment sum cast to float32, and the allowed error
    of each element: deg_s * 2^-23 * sum |data_e| over the segment, the worst
    case of a sequential f32 sum (on the CPU, in float64)."""
    d64, ids = data.detach().cpu().double(), ids.cpu()
    ref = plain(d64, ids, s).float().double()
    deg = plain(torch.ones_like(d64[..., :1]), ids, s)
    return ref, deg * 2.0**-23 * plain(d64.abs(), ids, s)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from egnn_tpu_torch import EGNNNetwork
    from egnn_tpu_torch.ops import core
    from egnn_tpu_torch.ops import neighbors as nb
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, build, reset_launch_counts
    from egnn_tpu_torch.ops.cuda import knn as K
    from egnn_tpu_torch.ops.cuda import segment as SK
    from egnn_tpu_torch.training import make_denoise_train_step, make_fused_adam
    from egnn_tpu_torch.training.data import synthetic_chain_batch

    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, {build.BUILD_DIR.name})")

    # ---- 2. kernels against their plain versions, bitwise ----
    cases = [  # name, b, n, k, mask, adj, ties
        ("anchor", 1, N, KNN, True, True, False),
        ("b4", 4, N, KNN, True, True, False),
        ("ragged_n1000", 1, 1000, KNN, True, True, False),
        ("no_mask_no_adj", 1, N, KNN, False, False, False),
        ("tie_pileup", 1, N, KNN, True, True, True),
        ("k1", 1, N, 1, True, True, False),
        ("k128", 1, N, 128, True, True, False),
    ]
    max_err = {"knn_select_gather": 0.0, "knn_select": 0.0}
    for i, (name, b, n, k, wm, wa, ties) in enumerate(cases):
        coors, mask, adj, table = knn_inputs(torch, b, n, k, wm, wa, ties, SEED + i)
        v1, i1, r1 = K.knn_select_gather(coors, k, table, mask, adj)
        v3, i3 = K.knn_select(coors, k, mask, adj)
        pv, pi, pr = K.knn_select_gather_plain(coors, k, table, mask, adj)
        torch.cuda.synchronize()
        ok1 = same_bits(torch, v1, pv) and torch.equal(i1, pi) and same_bits(torch, r1, pr)
        ok3 = same_bits(torch, v3, pv) and torch.equal(i3, pi)
        e1 = max((v1 - pv).abs().max().item(), (r1 - pr).abs().max().item())
        e3 = (v3 - pv).abs().max().item()
        max_err["knn_select_gather"] = max(max_err["knn_select_gather"], e1)
        max_err["knn_select"] = max(max_err["knn_select"], e3)
        print(f"kernel case {name}: b={b} n={n} k={k} tw={table.shape[-1]} "
              f"mask={wm} adj={wa} ties={ties}: K1 bitwise={ok1} (max err {e1}), "
              f"K3 bitwise={ok3} (max err {e3})")
        if not (ok1 and ok3):
            raise AssertionError(f"kernel case {name}: kernel and plain version differ")

    # ---- 3. serving the anchor-3 forward ----
    net = EGNNNetwork(
        depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
        layer_kwargs=LAYER_KWARGS, device="cuda",
        generator=torch.Generator().manual_seed(SEED)).eval()
    rng = np.random.default_rng(SEED)
    requests = ([synthetic_chain_batch(rng, 1, N, device="cuda") for _ in range(8)]
                + [synthetic_chain_batch(rng, 8, N, device="cuda") for _ in range(2)])
    n_requests = sum(rq.tokens.shape[0] for rq in requests)

    def serve(rq, model=net):
        return model(rq.tokens, rq.noised_coors, adj_mat=rq.adj_mat, mask=rq.mask)

    reset_launch_counts()
    with torch.inference_mode():
        outs = [serve(rq) for rq in requests]
    torch.cuda.synchronize()
    serving_counts = dict(LAUNCH_COUNTS)
    print(f"serving: {len(requests)} forwards, {n_requests} requests; launches {serving_counts}")
    if serving_counts["knn_select_gather"] != DEPTH * len(requests):
        raise AssertionError(f"K1 launched {serving_counts['knn_select_gather']} times, "
                             f"expected depth x forwards = {DEPTH * len(requests)}")
    for (f, c), rq in zip(outs, requests):
        b = rq.tokens.shape[0]
        if f.shape != (b, N, DIM) or c.shape != (b, N, 3):
            raise AssertionError(f"output shapes {tuple(f.shape)}, {tuple(c.shape)}")
        if not (torch.isfinite(f).all() and torch.isfinite(c).all()):
            raise AssertionError("non-finite serving output")

    net_cpu = copy.deepcopy(net).to("cpu")
    for idx in (0, len(requests) - 1):  # one b=1 and one b=8 forward
        rq = requests[idx]
        rq_cpu = type(rq)(*(t.cpu() for t in rq))
        with torch.inference_mode():
            f_cpu, c_cpu = serve(rq_cpu, net_cpu)
        f, c = outs[idx]
        ef = (f.cpu() - f_cpu).abs().max().item()
        ec = (c.cpu() - c_cpu).abs().max().item()
        print(f"gpu vs cpu, b={rq.tokens.shape[0]}: feats max err {ef:.3e}, "
              f"coors max err {ec:.3e} (atol {GPU_VS_CPU_ATOL})")
        if not (ef <= GPU_VS_CPU_ATOL and ec <= GPU_VS_CPU_ATOL):
            raise AssertionError("card and CPU forwards disagree")

    g = torch.Generator().manual_seed(SEED + 1)
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=g, dtype=torch.float64))
    q = q * torch.sign(torch.linalg.det(q))  # a rotation (det +1)
    shift = torch.randn(3, generator=g, dtype=torch.float64)
    rq = requests[0]
    rot = q.float().cuda()
    moved = rq._replace(noised_coors=rq.noised_coors @ rot + shift.float().cuda())
    with torch.inference_mode():
        f0, c0 = outs[0]
        f1, c1 = serve(moved)
    ef = (f1 - f0).abs().max().item()
    ec = (c1 - (c0 @ rot + shift.float().cuda())).abs().max().item()
    print(f"equivariance: feats invariance err {ef:.3e}, coors equivariance err {ec:.3e} "
          f"(atol {EQUIVARIANCE_ATOL})")
    if not (ef <= EQUIVARIANCE_ATOL and ec <= EQUIVARIANCE_ATOL):
        raise AssertionError("serving forward is not equivariant")

    # ---- 4. the neighbour-list entry point, through K3 ----
    reset_launch_counts()
    with torch.inference_mode():
        lists = [nb.knn_select(rq.noised_coors, KNN, math.inf, mask=rq.mask,
                               adj_mat=rq.adj_mat.expand(rq.tokens.shape[0], N, N))
                 for rq in requests]
    torch.cuda.synchronize()
    selection_counts = dict(LAUNCH_COUNTS)
    print(f"selection: {len(requests)} calls; launches {selection_counts}")
    if selection_counts["knn_select"] != len(requests):
        raise AssertionError("K3 did not run once per knn_select call")
    for nbhd, rq in zip(lists, requests):
        if nbhd.indices.shape != (rq.tokens.shape[0], N, KNN) or not (
                (nbhd.indices >= 0) & (nbhd.indices < N)).all():
            raise AssertionError("knn_select returned bad neighbour lists")

    # ---- 5. timing ----
    with torch.inference_mode():
        for rq in (requests[0], requests[-1]):
            b = rq.tokens.shape[0]
            ms = call_ms(torch, lambda: serve(rq))
            dev = device_ms(torch, lambda: serve(rq), reps=5)
            print(f"forward latency b={b}: median {ms:.4f} ms per forward, "
                  f"{ms / b:.4f} ms per request; device time {dev:.4f} ms "
                  f"(CUDA graph replay), device busy {dev / ms:.3f} of the call")
        profile_forward(torch, lambda: serve(requests[0]))

        coors, mask, adj, table = knn_inputs(torch, 1, N, KNN, True, True, False, SEED)
        b, n, c = coors.shape
        tw = table.shape[-1]
        adj_bytes = n * n  # one (n, n) bool chain, expanded over the batch
        kernels = []
        for name, fn, plain, width, replaces in (
            ("knn_select_gather",
             lambda: K.knn_select_gather(coors, KNN, table, mask, adj),
             lambda: K.knn_select_gather_plain(coors, KNN, table, mask, adj),
             tw, "egnn_tpu/ops/pallas/knn.py:466"),
            ("knn_select",
             lambda: K.knn_select(coors, KNN, mask, adj),
             lambda: K.knn_select_plain(coors, KNN, mask, adj),
             0, "egnn_tpu/ops/pallas/knn.py:203"),
        ):
            ms_plain_a = device_ms(torch, plain)
            ms_a = device_ms(torch, fn)
            ms_b = device_ms(torch, fn)
            ms_plain_b = device_ms(torch, plain)
            bound_ms, bound_by = knn_bound(b, n, c, KNN, width, True, adj_bytes)
            launches = (serving_counts if name == "knn_select_gather"
                        else selection_counts)[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "egnn_tpu_torch/csrc/knn_select.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_err[name],
                "ms": min(ms_a, ms_b), "plain_ms": min(ms_plain_a, ms_plain_b),
                "bound_ms": bound_ms, "bound_by": bound_by,
                # no single PyTorch call computes masked kNN with these fills
                # and this tie order
                "library_ms": None,
            })
            print(f"timing {name} at b={b} n={n} k={KNN} tw={width}: kernel "
                  f"{ms_a:.5f}/{ms_b:.5f} ms, plain {ms_plain_a:.5f}/{ms_plain_b:.5f} ms, "
                  f"bound {bound_ms:.6f} ms ({bound_by}); no library call computes it")

    # ---- 6. K2 against its plain version: repeatable, within its error ----
    g = torch.Generator().manual_seed(SEED + 20)

    def rand(*shape):
        return torch.randn(*shape, generator=g).cuda()

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g).cuda()

    def k1_ids(b, seed):
        coors, mask, adj, table = knn_inputs(torch, b, N, KNN, True, True, False, seed)
        return K.knn_select_gather(coors, KNN, table, mask, adj)[1].reshape(b, N * KNN)

    ids1, ids8 = k1_ids(1, SEED), k1_ids(8, SEED + 1)
    padded = randint(-1, N + 64, 2, N * KNN)
    padded[:, ::7] = -1
    tw = 3 + 1 + DIM  # [coors | mask | feats], the K1 table's width
    seg_cases = [  # name, data, ids, num_segments
        ("anchor_k1_idx", rand(1, N * KNN, tw), ids1, N),
        ("b8_k1_idx", rand(8, N * KNN, tw), ids8, N),
        ("unsorted_pad_oob", rand(2, N * KNN, tw), padded, N),
        ("empty_segments", rand(1, N * KNN, tw), randint(0, N // 8, 1, N * KNN), N),
        ("hub", rand(1, N * KNN, tw), torch.zeros(1, N * KNN, dtype=torch.int64).cuda(), N),
        ("s16384_e131072", rand(1, 16 * N * KNN, tw), randint(0, 16 * N, 1, 16 * N * KNN),
         16 * N),
        ("d1", rand(1, N * KNN, 1), ids1, N),
        ("d128", rand(1, N * KNN, 128), ids1, N),
        ("int32_ids", rand(1, N * KNN, tw), ids1.int(), N),
    ]
    max_err["segment_sum"] = 0.0
    for name, data, ids, s in seg_cases:
        outs = [SK.segment_sum(data, ids, s) for _ in range(3)]
        torch.cuda.synchronize()
        repeat = all(same_bits(torch, o, outs[0]) for o in outs[1:])
        ref, limit = segment_reference(torch, SK.segment_sum_plain, data, ids, s)
        err = (outs[0].cpu().double() - ref).abs()
        within = bool((err <= limit).all())
        cpu_bits = same_bits(torch, outs[0].cpu(),
                             SK.segment_sum_plain(data.cpu(), ids.cpu(), s))
        max_err["segment_sum"] = max(max_err["segment_sum"], err.max().item())
        print(f"K2 case {name}: b={data.shape[0]} E={data.shape[1]} S={s} D={data.shape[2]} "
              f"ids {ids.dtype}: 3 launches bitwise={repeat}; max err vs f64 "
              f"{err.max().item():.3e}, within deg*2^-23*sum|x|={within} (max limit "
              f"{limit.max().item():.3e}); equals the CPU plain f32 bitwise={cpu_bits}")
        if not (repeat and within):
            raise AssertionError(f"K2 case {name}: not repeatable or outside its error")

    # ---- 7. K1's backward (K2) on the card against a plain CPU gather ----
    coors, mask, adj, table = knn_inputs(torch, 1, N, KNN, True, True, False, SEED)
    feats = table[..., 4:].contiguous()
    w = rand(1, N, KNN, tw)

    def table_grads(c, f, m, a):
        c, f = c.clone().requires_grad_(), f.clone().requires_grad_()
        _, rows = nb.knn_select_gather(c, KNN, math.inf, mask=m, adj_mat=a, payload=f)
        (rows * w).sum().backward()
        return torch.cat([c.grad, f.grad], dim=-1)

    reset_launch_counts()
    d_card = [table_grads(coors, feats, mask, adj) for _ in range(2)]
    torch.cuda.synchronize()
    bwd_counts = dict(LAUNCH_COUNTS)
    c_cpu, f_cpu = coors.cpu().requires_grad_(), feats.cpu().requires_grad_()
    idx_cpu = K.knn_select_plain(c_cpu.detach(), KNN, mask.cpu(), adj.cpu())[1]
    t_cpu = torch.cat([c_cpu, mask.cpu()[..., None].float(), f_cpu], dim=-1)
    (core.batched_index_select(t_cpu, idx_cpu, axis=1) * w.cpu()).sum().backward()
    d_cpu = torch.cat([c_cpu.grad, f_cpu.grad], dim=-1)
    _, limit = segment_reference(torch, SK.segment_sum_plain, w.reshape(1, N * KNN, tw),
                                 idx_cpu.reshape(1, N * KNN), N)
    # both sides are f32 sums of the same terms, each within half this limit
    limit = torch.cat([limit[..., :3], limit[..., 4:]], dim=-1)
    err = (d_card[0].cpu().double() - d_cpu.double()).abs()
    print(f"K1 backward at b=1 n={N} k={KNN} tw={tw}: d_table max err vs the CPU plain "
          f"gather's autograd {err.max().item():.3e} (limit deg*2^-23*sum|w|, max "
          f"{limit.max().item():.3e}); two card runs bitwise="
          f"{same_bits(torch, d_card[0], d_card[1])}; launches {bwd_counts}")
    if not bool((err <= limit).all()):
        raise AssertionError("K1's backward on the card disagrees with the CPU")
    if bwd_counts["segment_sum"] != 2 or bwd_counts["knn_select_gather"] != 2:
        raise AssertionError("K2 did not run once per K1 backward")

    # ---- 8. training the anchor-3 denoiser ----
    def make_trainer(seed=SEED):
        net = EGNNNetwork(
            depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
            layer_kwargs=LAYER_KWARGS, device="cuda",
            generator=torch.Generator().manual_seed(seed))
        return net, make_denoise_train_step(net, make_fused_adam(net.parameters(), LR))

    def batch_args(rq):
        return rq.tokens, rq.noised_coors, rq.clean_coors, rq.adj_mat, rq.mask

    train_counts = {}
    fixed = {}
    for b in (1, 8):
        _, step = make_trainer()
        batches = [synthetic_chain_batch(rng, b, N, device="cuda") for _ in range(TRAIN_STEPS)]
        fixed[b] = batches[0]
        reset_launch_counts()
        losses = [step(*batch_args(rq)) for rq in batches]
        torch.cuda.synchronize()
        train_counts[b] = dict(LAUNCH_COUNTS)
        losses = torch.stack(losses).cpu()
        print(f"training b={b}: {TRAIN_STEPS} steps, losses {losses.tolist()}; "
              f"launches {train_counts[b]}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("non-finite training loss")
        for name in ("knn_select_gather", "segment_sum"):
            if train_counts[b][name] != DEPTH * TRAIN_STEPS:
                raise AssertionError(f"{name} launched {train_counts[b][name]} times in "
                                     f"{TRAIN_STEPS} steps, expected {DEPTH * TRAIN_STEPS}")
        _, step = make_trainer()
        falling = torch.stack([step(*batch_args(fixed[b])) for _ in range(FALL_STEPS)]).cpu()
        print(f"training b={b} on one batch: loss {falling[0].item():.6f} -> "
              f"{falling[-1].item():.6f} over {FALL_STEPS} steps (min {falling.min().item():.6f})")
        if not falling[-1] < falling[0]:
            raise AssertionError("the loss did not fall on a fixed batch")

    runs = []
    for _run in range(2):
        net, step = make_trainer()
        for _step in range(5):
            step(*batch_args(fixed[1]))
        runs.append([p.detach().clone() for p in net.parameters()])
    torch.cuda.synchronize()
    print("two 5-step runs from one seed equal bitwise: "
          f"{all(same_bits(torch, a, b) for a, b in zip(*runs))} (information)")

    # ---- 9. one step on the card against the CPU ----
    for b in (1, 8):
        net, step = make_trainer(SEED + 3)
        net_cpu = copy.deepcopy(net).to("cpu")
        step_cpu = make_denoise_train_step(net_cpu, make_fused_adam(net_cpu.parameters(), LR))
        rq = fixed[b]
        loss = step(*batch_args(rq)).item()
        loss_cpu = step_cpu(*(t.cpu() for t in batch_args(rq))).item()
        errs = []  # (relative error, name); a parameter off the loss's path has no grad
        for (name, p), q in zip(net.named_parameters(), net_cpu.parameters()):
            if (p.grad is None) != (q.grad is None):
                raise AssertionError(f"{name} has a gradient on one device only")
            if p.grad is None:
                continue
            gp, gq = p.grad.cpu().double(), q.grad.double()
            diff, norm = (torch.linalg.vector_norm(x).item() for x in (gp - gq, gq))
            errs.append((diff / max(norm, 1e-300), name))
            if diff > TRAIN_GRAD_TOL * norm + 1e-12:
                raise AssertionError(f"card and CPU gradients of {name} disagree: "
                                     f"{diff:.3e} against norm {norm:.3e}")
        print(f"one step b={b}, card vs CPU: loss {loss:.8f} vs {loss_cpu:.8f} (rtol "
              f"{TRAIN_LOSS_RTOL}); gradient error ||g_gpu - g_cpu|| / ||g_cpu|| largest "
              f"{max(errs)[0]:.3e} ({max(errs)[1]}), median "
              f"{statistics.median(e for e, _ in errs):.3e} over {len(errs)} parameters "
              f"(tol {TRAIN_GRAD_TOL})")
        if abs(loss - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu):
            raise AssertionError("card and CPU losses disagree")

    # ---- 10. timing: the train step and K2 ----
    for b in (1, 8):
        _, step = make_trainer()
        args = batch_args(fixed[b])
        ms = call_ms(torch, lambda: step(*args))
        edges = b * N * KNN * DEPTH
        kernel_ms = profile_forward(torch, lambda: step(*args), label=f"b={b} train steps",
                                    unit="step")
        dev = device_ms(torch, lambda: step(*args), reps=5)
        print(f"train step b={b}: median {ms:.4f} ms per step, {edges / (ms / 1e3):.6e} "
              f"edges/s ({edges} edges a step); kernel time {kernel_ms:.4f} ms a step, busy "
              f"{kernel_ms / ms:.3f}; CUDA graph replay {dev:.4f} ms a step "
              f"({edges / (dev / 1e3):.6e} edges/s)")

    data, ids = seg_cases[0][1], seg_cases[0][2]
    e, d = data.shape[1], data.shape[2]
    ms_plain_a = device_ms(torch, lambda: SK.segment_sum_plain(data, ids, N))
    ms_a = device_ms(torch, lambda: SK.segment_sum(data, ids, N))
    ms_b = device_ms(torch, lambda: SK.segment_sum(data, ids, N))
    ms_plain_b = device_ms(torch, lambda: SK.segment_sum_plain(data, ids, N))
    flat_ids, flat_data = ids.reshape(-1), data.reshape(e, d)
    ms_lib = device_ms(torch, lambda: torch.zeros(N, d, device="cuda").index_add_(
        0, flat_ids, flat_data))
    bound_ms, bound_by = segment_bound(1, e, N, d)
    big = seg_cases[5]
    ms_big = device_ms(torch, lambda: SK.segment_sum(big[1], big[2], big[3]), reps=5)
    uniform = randint(0, N, 1, e)  # the same shape without K1's hub segments
    ms_uniform = device_ms(torch, lambda: SK.segment_sum(data, uniform, N))
    hubs = torch.bincount(ids.reshape(-1), minlength=N)
    print(f"timing segment_sum at b=1 E={e} S={N} D={d}: kernel {ms_a:.5f}/{ms_b:.5f} ms, "
          f"plain {ms_plain_a:.5f}/{ms_plain_b:.5f} ms, index_add_ {ms_lib:.5f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}); K1's ids have in-degree up to "
          f"{hubs.max().item()} (mean {e / N:.1f}); kernel on uniform random ids "
          f"{ms_uniform:.5f} ms; at S={big[3]} E={big[1].shape[1]} (uniform): kernel "
          f"{ms_big:.5f} ms; {train_counts[1]['segment_sum'] // TRAIN_STEPS} launches a b=1 step")
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "egnn_tpu_torch/csrc/segment_sum.cu",
        "replaces": "egnn_tpu/ops/pallas/segment.py:115",
        "launches": train_counts[1]["segment_sum"],
        "max_abs_err": max_err["segment_sum"],
        "ms": min(ms_a, ms_b), "plain_ms": min(ms_plain_a, ms_plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # torch.zeros(S, D).index_add_(0, ids, data): the same sum, with atomics
        "library_ms": ms_lib,
    })

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
