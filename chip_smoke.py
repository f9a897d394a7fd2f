"""Smoke run of egnn_tpu_torch on one NVIDIA GPU: builds the CUDA kernels from
the checkout, holds each against its plain PyTorch version, serves the
anchor-3 EGNN_Network forward, trains it, then does the same beyond the
full-band reach (n > 16384: the net65k network at 65 536 nodes, through the
packed-key candidates and through the spatial grid, and the anchor-3 family
at 32 768), then serves and trains both through the fused pair pipeline
(``fused_pairs``, ``fused_knn``), then serves and trains the sparse family
at anchor 5 (``EGNNSparseNetwork`` over kNN-built molecule graphs, four
arms), then the dense family's last options (global attention, bf16,
dropout in training mode, the streamed all-pairs layer at 8192 nodes,
anchors 1 and 2), then the host runtime and the trainers (the native graph
builder, the molecule trainer through ``PrefetchLoader``, k-hop lists, the
denoise trainer killed and resumed from its checkpoint), then multi-process
training (the data-parallel dense step and the edge-partitioned sparse step
on a one-rank NCCL group and on two ranks sharing the card) and the last two
examples (``export_serving``, ``denoise --metrics``), then model parallelism
(the ring, tensor parallelism and the pipeline, on the same two set-ups),
then the fused pair kernel's tensor-core mode (``mxu_bf16``, under
``torch.set_float32_matmul_precision("medium")``), then the dense step
sharded over nodes, then anchor 4 and the sharded dropout, then the trainers'
blocks of CUDA-graph replays, checks the outputs,
and times the kernels, the forwards and the train steps (with
``egnn_tpu_torch/utils/profiling.py``'s timers and the H100 peaks of its
``Roofline``).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):
1. the card's name and power limit; the kernels' build time;
2. kernels: K1 (kNN selection + payload gather) and K3 (selection only) on
   the card against their plain versions and their CPU model
   (``knn_select_block_model`` with stripes and K1's payload) at the plan
   the source makes, bitwise, over the cases below (among them c = 5 and
   NaN rankings, whose values meet the CPU model's as NaN: the card writes
   the canonical NaN);
3. serving: EGNNNetwork at anchor-3 width (depth 3, dim 32, 21 tokens, 1024
   positions and nodes, kNN 8, node mask, chain adjacency, norm_coors, clamp
   2.0; random weights from a seed) answers requests at b=1 and b=8; the
   outputs are finite, agree with the same module on the CPU, are
   E(3)-equivariant, and K1 ran depth times per forward;
4. selection: the neighbour-list entry point ``knn_select`` answers the same
   requests through K3;
5. timing: forward latency (CUDA events around the call), its device time
   (a CUDA graph replay) and kernel time by name (torch.profiler); K1 and K3
   at b=1 and K1 at b=8, each beside its plain version, its bound and its
   plan (rows a warp, warps a row);
6. K2 (segment sum) on the card over the cases below (K1's ids at b=1 and
   b=8, padding, hubs up to 2^17 edges, magnitudes 1e-30 to 1e30 that
   cancel, denormal inputs and sums, NaN and infinities): three launches
   bitwise equal, bitwise equal to its model ``segment_sum_fixed_point`` and
   to itself on the edges permuted, and within the worst-case error of a
   sequential f32 sum of the float64 result (non-finite elements: the
   float64 sum's NaN or infinity);
7. K1's backward: the table's gradient through K1 + K2 on the card against
   a plain CPU gather's autograd, and one K2 launch per backward;
8. training: the anchor-3 denoising train step (masked MSE, flat-buffer
   Adam, lr 1e-3) at b=1 and b=8: finite losses, K1 and K2 launched depth
   times a step, and the loss falling over 50 steps on one batch;
9. one step on the card against the same step on the CPU (its segment sums
   in K2's arithmetic, the model): loss and every parameter's gradient;
10. timing of the train step (latency, edges/s, profile, CUDA graph replay)
   and of K2 beside its plain version, its bound and ``index_add_``;
11. large-n kernels: K4 (exact selection at any n), K5 and K6 (packed-key
   candidates) on the card against their row-chunked plain versions,
   bitwise, over the cases below, among them the edges of their blocks
   (n = 32m + 1 rows, a last tile of one column, rows of n % 4 != 0 bytes,
   masked and unmasked rows in one warp); every instantiation (list slots,
   rows a warp) is reached, and the source ranks as many columns a lane
   as the CPU model ``ops/cuda/knn.py:knn_select_block_model``;
12. the dispatcher on the card: ``backend="packed_tiled"``, ``"packed"``,
   ``"tiled"``, ``"grid"`` and ``"auto"`` (with the grid, and with
   ``GRID_AUTO`` off as before the grid) give K4's selection, compact and
   wide, and a tie pile-up takes the certificate's exact fallback (K4);
   ``"pallas"`` and ``"fused"`` launch K1 with a payload, K3 without;
13. path A, the net65k network (depth 3, dim 32, kNN 16, 65 536 nodes, no
   mask or adjacency) with ``GRID_AUTO`` off: forwards through K5 and the
   kc-wide layer path, equivariance, the fwd+bwd ``benchmarks/net65k.py``
   times, and denoising train steps (K5 forward, K2 backward at E = n * kc);
14. path B, the anchor-3 family at 32 768 nodes with node mask and chain
   adjacency: forwards and train steps through K4;
15. both families at n = 16 896, depth 1, on the card against the CPU (the
   net65k family through the grid and through K5);
16. timing of K4, K5, K6 beside their plain versions and bounds, with their
   rows a warp and columns a lane (K2 on the
   large paths' own ids, in phases 13, 14, 19 and 23: the gates of phase 6,
   then timed beside its plain version, its bound and ``index_add_``);
17. the grid route's kernels: K7 (grid-blocked selection), K8 (query rows
   against all points) and K9 (query rows against a window of the x-sorted
   points) against their plain versions, bitwise, over the cases below
   (among them K7 on hand-made cells of 1, 61, 128, 129 and more nodes at
   one to four list slots, K8 at R = 1 and 5, with stripes of unequal
   length, k = 48 and 128, K9 with windows that start on any column); K7,
   K8 and K9 against their CPU models (``grid_knn_cells_model``,
   ``knn_select_block_model``) at the plan the source makes, which ranks as
   many candidates a lane and merges as many values as the models;
18. the grid route on the card: ``"grid"`` and ``"auto"`` give K4's
   selection through every arm of the repair ladder, shown by the launches:
   certified whole (K7), direct repair (K7, K8), the window tier (K7, K9,
   K8), the n/4 bucket (K7, K8), the whole-call fallback (no K7; K5), and
   the plain-torch grid below the kernel's gate (K8);
19. path C, net65k as ``auto`` routes it: forwards through K7 on a uniform,
   a Gaussian (K8) and a heavier-tailed cloud (K9), k slots a layer,
   equivariance, the fwd+bwd and denoising train steps;
20. timing of K7, K8, K9 beside their plain versions and bounds, K7 at
   k = 128, K8 at R = n/4 and on the rows K9 leaves on the heavy cloud too;
   ptxas's registers and spills of K7's instantiations and of those of
   ``knn_select_block_kernel`` that K1, K3, K8 and K9 launch;
21. the fused pair pipeline's kernels: K10f and K10b (pre-gathered rows), K11f
   and K11b (gathering inside) against their plain versions in float64 over
   the cases below (among them the backward's register blocks at their
   edges: rows, columns and weight-gradient blocks cut short, a partial
   last tile, and weight gradients past the register slots; and the
   forward's tile loop at its edges: tiles below and at 64 rows, a partial
   last tile, blocks with unequal tile counts, a block's tiles in two batch
   elements, three nodes of kc = 20 a tile, h = 134 on small and 64-row
   tiles, repeated ids, each shown reached), each error held to a
   multiple of the float32 plain version's own; three forward and backward
   launches bitwise equal;
22. anchor 3 with ``fused_pairs=True`` (K1 -> K10f; backward K10b -> K2) and
   with ``fused_knn=True`` (K3 -> K11f; backward K11b and K2): serving at b=1
   and b=8 against the unfused network and against the CPU, equivariance,
   train steps with their launch counts, the loss falling on one batch, one
   step against the CPU; latencies beside the unfused network's;
23. net65k with ``fused_pairs=True``: path C (forwards on the uniform, the
   Gaussian (K8) and the heavier-tailed cloud (K9), fwd+bwd, train steps,
   peak memory) and path A (kc = 20 slots under the winner mask: a forward
   and a train step), each beside the unfused path's numbers of this run;
   the fwd+bwd's coordinate gradient (also without ``norm_coors``) and one
   step's parameter gradients against the unfused network's;
24. K10f, K10b, K11f, K11b on anchor 3's and path C's own neighbourhoods and
   K10f, K10b on path A's (n = 65 536): against their plain versions in
   float64 as in phase 21, then timed beside their plain versions, their
   bounds and the unfused pipeline of torch operators on the same pairs;
   each kernel's tile, grid and blocks an SM beside its time;
25. K10f and K10b at anchor 5's widths (dim 64, fourier 4, h = 274, the
   sparse gate semantics ``gate_feats_only``), soft edge off and on, which
   the gate must take: against the float64 plain version as in phase 21,
   three launches bitwise equal;
26. ``knn_graph`` on the card against the CPU, bitwise, per molecule, over
   a packed batch (``graph_size``) and over a ragged ``batch``, on Gaussian
   and on lattice coordinates (ties): K3 once a call;
27. serving anchor 5 (``EGNNSparseNetwork``: 4 layers, dim-64 embeddings of
   5 atom types, fourier 4, both norms; G = 32 molecules of up to 32 atoms,
   kNN 8) in four arms: (a) the general segment path, (b)
   ``uniform_degree=8, uniform_graph_size=32``, (c) (b) with
   ``fused_uniform=True``, (d) (a) with global attention every second
   layer; each request builds its edges (K3) and runs the network: finite
   outputs, card against CPU, equivariance, (c) against (b), and the K2,
   K3 and K10f launches the path implies;
28. training anchor 5 in every arm: the fwd+bwd of bench_all.py's
   ``(o[:, 3:]**2).mean()`` wrt x and one denoising step's parameter
   gradients against the CPU (its segment sums in K2's arithmetic), five
   steps of the denoising objective with ``make_adam`` (the loss falls;
   K10f and K10b once a layer a step in (c)), (c)'s gradients against (b)'s;
29. timing at G = 32 and G = 512: forward, fwd+bwd and train step of each
   arm as a call (CUDA events) and as a CUDA graph replay, a step's kernel
   time by name and busy share; K3, K2, K10f and K10b at anchor 5's shapes
   beside their bounds, plain versions and ``index_add_`` or the unfused
   pipeline; K10b's tile (32 rows), grid and blocks an SM (one), and the
   registers and spills of its one-block instances (none may spill);
   K10b beside a parent checkout's source and wrapper with
   ``--parent-source PATH``;
30. anchor 3 with global attention every second layer (8 heads of 64, 4
   global tokens): served at b=1 and b=8 (K1 depth times a forward, card
   against CPU, equivariance), trained (K1 and K2 depth times a step, the
   loss falling, one step against the CPU with and without ``norm_coors``),
   served in bf16 (against the card's f32 and the CPU's bf16), and timed
   as calls and replays beside plain anchor 3;
31. anchor 3 at layer dropout 0.1 in training mode, unfused and with
   ``fused_pairs``: one generator state gives the same bits twice and
   another state other outputs; no K10 in training mode, K10f depth times in
   eval mode; the train step equal to dropout 0's, bitwise;
32. one streamed all-pairs layer (``stream_ab``: dim 64, norm_coors, b=1,
   n = 8192, chunk from ``_auto_chunk``) in f32 and bf16: finite,
   equivariant, forward and fwd+bwd timed with their launches, pairs/s and
   the fwd+bwd's peak memory; at n = 2048 against the CPU (with and
   without ``norm_coors``), at n = 1024 against the materialised layer;
   dropout 0.1 at n = 2048: a generator state's bits twice, and the
   materialised layer under the recorded masks within 1e-5;
33. anchors 1 and 2 (one ``EGNN(dim=512)`` layer, n = 16, edge_dim 0 and
   4): card against CPU, forward and every gradient, fwd+bwd timed;
34. the native host graph builder (built with g++; no numpy fallback
   here): its batched kNN at anchor 5's G = 512 on lattice coordinates
   (ties) against ``knn_graph`` on the card (K3), bitwise; the molecule
   trainer (``egnn_tpu_torch.examples.molecule_regression``, the example's
   G, NA, k, width and lr) in its host-loader mode, 20 steps through
   ``PrefetchLoader(depth=2)`` against the same 20 batches fed directly,
   losses and parameters bitwise, the loss falling, the first loss against
   the CPU's; the host build a batch, the step as a call, its busy share,
   and the step with the loader against the step with the batches on the
   card;
35. ``khop_neighbor_lists`` on the card against the CPU, bitwise: on
   net65k's uniform cloud (n = 65 536, k = 16 lists from one K7 launch),
   D = 2, and on anchor 3's lists (n = 1024, k = 8, mask and adjacency),
   D = 3; times and peak memory;
36. the denoise trainer (``egnn_tpu_torch.examples.denoise``: depth 5, dim
   32, kNN 16, grad_accum 16) on a synthetic backbone file of 64 proteins x
   128 residues (n = 384), 64 micro-steps: one run uninterrupted in this
   process, one in a subprocess (the CPU fault test's runner) that SIGKILLs
   itself right after the checkpoint of micro-step 24 (inside an
   accumulation window), and one in this process that resumes it, all
   under the default ``--block`` (blocks of CUDA-graph replays, each ended
   at a checkpoint); the final parameters and optimizer state bitwise
   equal, the held-out loss falling; micro-steps/s and edges/s; a
   micro-step as an eager call, with and without the guard;
37. a one-rank NCCL group in this process (``parallel.initialize`` over a
   ``file://`` store): the data-parallel anchor-3 step
   (``make_sharded_denoise_train_step``, b = 8) bitwise against
   ``make_denoise_train_step`` over 3 steps (losses, the first step's
   gradients, the parameters), K1 and K2 depth times a step; the
   partitioned anchor-5 step (``make_partitioned_sparse_train_step`` at
   S = 1, G = 32) in arms (b) less ``uniform_graph_size``
   (``partition_uniform_edges``), (c) fused (K10) and (d) attention
   (``partition_edges``) against the unsharded step, K3, K2 (and K10f, K10b)
   launched; both steps timed as calls beside their references;
38. two spawned ranks on the one card under gloo (NCCL refuses two ranks on
   one device; the collectives copy through host memory): the dense step
   (4 rows a rank) and the partitioned step at S = 2 in arms (b), (c), (d)
   against one process on the card (loss rtol 1e-4, gradients 1e-5 of their
   largest value, 5e-3 for anchor 3's self pairs), both ranks' parameters
   bitwise equal after 3 steps, every path's kernels launched on each rank;
   a hung rank fails the phase after 420 s;
39. ``examples/export_serving.py`` on the card (the anchor-3 forward at
   n = 256 through ``torch.export``, saved, reloaded: bitwise equal to the
   in-process forward, K1 once a layer), and the denoise trainer with
   ``--metrics`` for 16 micro-steps: one finite JSONL line a micro-step;
40. the ring (``EGNN(ring_axis=group)``, ``make_ring_denoise_train_step``):
   the all-pairs denoiser (depth 2, dim 64, no kNN, b = 1, n = 1024, with
   and without ``norm_coors``), 3 steps at one NCCL rank (g = 1) and on two
   gloo ranks sharing the card (g = 2, 512 nodes a rank) against the
   one-process streamed step (loss rtol 1e-4; gradients 1e-5 of their
   largest value, 5e-2 under ``norm_coors`` as phase 32's all-pairs layer);
   both ranks' parameters bitwise; the ring layer served against the
   streamed layer; timed beside it (the all-pairs path launches no kernel);
41. tensor parallelism at model = 2 on the two ranks (``tp_shard_module``):
   anchor 1's layer (``EGNN(dim=512)``, n = 16), forward and every
   gradient against the replicated layer in one process; anchor 3's step
   (b = 8) through ``make_sharded_denoise_train_step`` on a (1, 2) mesh
   against the replicated step (5e-3 for the self pairs), K1 and K2 depth
   times a step on each rank; both timed beside their references; anchor
   5's arms (b) and (c) (phase 44's list, gradients at 1e-4);
42. the pipeline (anchor 3's layer settings, depth 4, n = 1024, b = 8 in
   M = 4 microbatches): at S = 1 (one NCCL rank) ``pipeline_loss``, its
   gradients and ``pipeline_apply`` bitwise equal to the sequential stack
   over the same microbatches, K1 16 and K2 12 a loss call; at S = 2 (the
   two ranks) against the sequential stack in one process, each stage K1 8
   a call and K2 4 (stage 0, whose first layer's inputs need no gradient)
   or 8 (stage 1); timed beside the sequential stack. NCCL refuses two
   ranks on one card, so its point-to-point branch (g, S > 1) needs two
   cards and is not run here;
43. K10 in its tensor-core mode (``mxu_bf16``: the forward's wide products
   on bf16 ``mma.sync``; the backward's recomputation and data-gradient
   products too, its weight gradients on the FMAs, its operands rounded as
   JAX's ``dG`` rounds them), reached by
   ``torch.set_float32_matmul_precision("medium")`` (restored in a
   ``finally``): the mode's backward tile (anchor 5: 32 rows at one block
   an SM, where f32 takes 8; its layout against the source's, its blocks an
   SM against the occupancy calculator); K10f and K10b in the mode at
   anchor 3's, anchor 5's (G = 32, 512) and path C's shapes against their plain
   versions in the mode in float64 by phase 21's rule on each tensor's
   norm (8x the f32 plain version's error plus 1e-5; the roundings part at
   bf16 ties), every element within 1.25e-2 of its largest value; the f32
   kernel outside that rule, forward and backward; launches bitwise
   repeatable); K10f in the mode and the f32 K10f and K10b on those cases
   bitwise their kept hashes (``MODE_KEPT_BITS``); the same rule over phase
   21's cases and three narrow ones (d = 4, m = 4), each passing outright or
   on its tie-free rerun (the pairs whose bf16 roundings or clamp may part
   between two summation orders given pv = 0, at most ``TIE_SHARE_MAX`` of
   them, while three controls with as many other pairs out still miss;
   each case's tie counts printed, the f32 kernel outside the rule there
   too); the anchor-3 ``fused_pairs`` network and
   anchor 5's arm (c) served under "highest" and "medium" (K10f's launches
   by mode; outputs within 5e-2 of each other and not equal; equivariance
   under "medium") and trained 5 steps under "medium" (the mode's K10f and
   K10b once a layer a step, no f32 K10; the loss falls); the mode's
   kernels timed beside the f32 ones, the plain versions and the unfused
   pipeline under "medium" (and K10f beside a parent checkout's source with
   ``--parent-source PATH``, the path of its ``pair_messages.cu``);
44. the dense step sharded over nodes (the mesh's ``graph`` axis). 44a, one
   process: K1, K3 and K4 in their row-block mode (the rows r0 .. r0 + R -
   1 of the points against all n columns) bitwise against the whole
   launch's rows and their plain versions' blocks: K1 and K3 at anchor 3's
   shape (b = 8, a mask, a chain with random extra edges per graph) and on
   an integer lattice (ties) for g = 2 and 4 blocks, K4 at n = 20 000 with
   an (n, n) adjacency (400 MB) for g = 2; the row-block K1 at R = 512
   timed (CUDA-graph replays) beside its plain version and its bound; K11
   in its j-table form (the rows 512 .. 1023 of b = 8 clouds against the
   whole cloud) against its float64 plain versions by phase 21's rule,
   three launches bitwise, timed. 44b, two ranks sharing the card under
   gloo (as phase 38): anchor 3's step at b = 8 on a (data, graph) = (1, 2)
   mesh, unfused, with ``fused_pairs`` and with ``fused_knn``, 5 steps,
   against one process on the card (loss rtol 1e-4, gradients 5e-3 of
   their largest value: the self pairs), the first layer's selected
   indices bitwise the one-process selection's rows, both ranks'
   parameters bitwise equal, each rank launching exactly, depth times a
   step: the row-block K1 and K2 (unfused), and K10f, K10b
   (``fused_pairs``), or the row-block K3, K11f and K11b in their j-table
   form and K2 (``fused_knn``); each step timed as a call beside the
   one-process step. Phase 41 also trains
   anchor 5's arms (b) and (c) (G = 32) at model = 2 against one process
   (loss rtol 1e-4, gradients 1e-4: a layer's one-element coors_norm_scale
   gradient sums every edge), K2 and (arm (c)) K10f, K10b launched.
45. the last options. 45a: anchor 4 (``benchmarks/bench_all.py:106-124``:
   depth 2, dim 32, 21 tokens, 3 adjacency degrees, adj_dim 8,
   ``only_sparse_neighbors``, n = 512, b = 1, a chain) served and
   differentiated (fwd+bwd of (coors_out^2).mean() wrt the coordinates)
   against the CPU (forward 1e-4, loss rtol 1e-4, gradient 1e-5), its
   equivariance, K1 depth times a forward and K2 depth times a fwd+bwd,
   both timed as calls and as CUDA-graph replays (``max_degree``'s host
   read hoisted out of the capture); one train step at the step's k = 7
   (the given ``num_nearest_neighbors``, as the JAX package's jitted step)
   against the CPU (loss rtol 1e-4, gradients by phase 9's rule). 45b: its all-pairs variant, the
   degrees' dense (1, 512, 512, 8) edges in both layers, against the CPU
   (forward 1e-4 of its largest value); then both trained 3 steps on a
   (data, graph) = (1, 2) mesh of two gloo ranks sharing the card against
   one process (loss rtol 1e-4, gradients 1e-5, the all-pairs variant
   1e-4), the ranks' parameters bitwise equal, the row-block K1 and K2
   depth times a step. 45c, on the same two ranks: dropout 0.1 in
   training mode, anchor 3's network at b = 8 on the (1, 2) graph mesh,
   phase 40's all-pairs denoiser on the ring at g = 2 against the streamed
   layer at pairwise_chunk = n / 2, anchor 1's layer and anchor 5's arm (b)
   at model = 2, each against one process with the generator on cuda:0
   seeded alike: every rank's masks bitwise its part of the one-process
   masks, then the loss (rtol 1e-4) and the gradients (5e-3 self pairs,
   1e-5, 1e-5, 1e-4); then the whole-mask draw timed beside the part's own
   draw.
46. the trainers' blocks (``--block``: the step captured once by
   ``training.capture_step`` and replayed a micro-step, the losses read
   once a block): the denoise trainer at phase 36's configuration (its
   file, 64 micro-steps, checkpoints every 8) in blocks of 8, and on
   synthetic chains in blocks of 10, each against blocks of 1: losses and
   the final parameters and optimizer state bitwise; K2 launched only by
   the warm-up and the capture (depth times each) where eager calls launch
   it depth times a micro-step; micro-steps/s and edges/s after the first
   block beside eager calls (``--block 0``) and phase 36's micro-step as a
   call; one block of 8 replays timed, its kernel time, busy share and
   launches (torch.profiler); the molecule trainer's default path (G = 32,
   NA = 32, k = 8, dim 64, 4 layers; the edge build and the step captured
   together), 40 steps in blocks of 10 against blocks of 1: losses and
   MAEs bitwise, K3 only at the warm-up and the capture, the loss falling;
   steps/s beside eager calls.
47. anchor 3's network at dim 64 with 4 Fourier encodings (h = 274, the
   widths at which K10b takes its one-block tile) trained with
   ``fused_pairs`` beside the unfused network at b = 1 and b = 8: one step
   each against the other (loss rtol 1e-4, gradients 5e-3), K10f and K10b
   depth times a step; both steps timed as CUDA-graph replays, with their
   kernel time and K10b's share of it.

The last lines: a JSON line of the kernels, the card's ``nvidia-smi`` line,
then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import math
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

# anchor configuration 3 (bench.py:23-24, examples/export_serving.py:34-38)
DEPTH, DIM, N, KNN, NUM_TOKENS = 3, 32, 1024, 8, 21
DIM64 = 64   # phase 47: anchor 3 at dim 64 with 4 Fourier encodings (h = 274)
LAYER_KWARGS = dict(num_nearest_neighbors=KNN, norm_coors=True, coor_weights_clamp_value=2.0)
SEED = 0

# f32 on the card against f32 on the CPU (cuBLAS vs CPU matmul rounding,
# ~1e-7 relative per op, through 3 layers of coordinates up to |x| ~ 40).
GPU_VS_CPU_ATOL = 1e-4
# rotated inputs: f32 rounding of the rotated coordinates, same scale
EQUIVARIANCE_ATOL = 1e-4
# beyond the full-band reach: the share of nodes that may exceed it because
# the motion swapped a neighbour at the k-th place (check_equivariance)
SWAP_SHARE = 0.005

# one train step on the card against the CPU: the loss at this rtol, and
# each parameter's gradient by ||g_gpu - g_cpu|| <= tol * ||g_cpu|| + 1e-12
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-5  # measured: 3.6e-7 at most (H100, PERF.md)
TRAIN_STEPS, FALL_STEPS, LR = 10, 50, 1e-3
# a fused step's parameter gradients against the unfused network's, both
# float32 on the card. Every kNN row holds its own node, and under
# norm_coors that pair's term +-(scale / eps) * w * g, 1e6 times the
# coordinate weight's share, stands in the i-side sum and in the j-side
# scatter and cancels only to f32 rounding, in another order on the two
# paths; the rest reaches the earlier layers' weights through the
# coordinates. The same fused module on the CPU differs from the card only
# in the order of the sums over the b * n * k pairs (the kernel adds a weight
# gradient row after row, tile after tile, block after block; the CPU as its
# matrix product blocks it), the self pairs' terms among them.
FUSED_VS_UNFUSED_GRAD_TOL = 5e-3   # measured: 1.5e-3 at most (H100, PERF.md)
FUSED_CARD_VS_CPU_GRAD_TOL = 1e-3  # measured: 1.1e-4 at most
# net65k's fwd+bwd: the gradient with respect to the coordinates, fused
# against unfused, ||g - g_u|| <= tol * ||g_u||. Under norm_coors the self
# pairs' terms, some 1e6 times the entries that remain, stand in the compared
# tensor itself (in d_ci and in the scattered d_cj) and leave their float32
# rounding there on either path. Without norm_coors there is no such term
# and the two paths differ by the order of their sums alone.
FUSED_VS_UNFUSED_COORS_GRAD_TOL = 2e-2        # measured: 5.6e-3 (H100, PERF.md)
FUSED_VS_UNFUSED_COORS_GRAD_TOL_BARE = 1e-5   # norm_coors=False; measured: 3.6e-7

# the large-n paths: net65k (benchmarks/net65k.py:12-22) and the anchor-3
# family at 32x the chain length
N_A, KNN_A = 65536, 16
N_B = 32768
LAYER_KWARGS_A = dict(num_nearest_neighbors=KNN_A, norm_coors=True,
                      coor_weights_clamp_value=2.0)
N_CPU = 16896       # 33 * 512: the smallest n beyond 16 384 that K5's gate takes
STEPS_A, STEPS_B = 5, 4



def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def bound_parts_ms(nbytes, ops):
    """(bytes_ms, operations_ms): ``nbytes`` over the card's HBM rate and
    ``ops`` f32 operations over its f32 peak outside the tensor cores, the
    H100 SXM data sheet's peaks that ``utils/profiling.py:Roofline`` holds."""
    from egnn_tpu_torch.utils.profiling import Roofline

    r = Roofline("bound", 0.0, flops=ops, bytes_accessed=nbytes)
    return r.bytes_seconds * 1e3, r.flops_seconds * 1e3


def ptxas_kernels(build, source, keep):
    """(kernel, registers, spill stores, spill loads) of the kernels of
    ``csrc/<source>.cu`` whose mangled names match ``keep``, from what ptxas
    reported at the build (names demangled by cu++filt where it exists)."""
    rows, cur = [], None
    for line in build.ptxas_report(source).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [m.group(1), None, None, None]
            rows.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur[2], cur[3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur[1] = int(m.group(1))
    rows = [r for r in rows if re.search(keep, r[0])]
    filt = Path("/usr/local/cuda/bin/cu++filt")
    if filt.exists() and rows:
        names = subprocess.run([str(filt)], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        for r, name in zip(rows, names):
            r[0] = name.replace("<unnamed>::", "").split("(const")[0]
    return [tuple(r) for r in rows]


def knn_inputs(torch, b, n, k, with_mask, with_adj, ties, seed, c=3):
    """coors (b, n, c), mask, adj (b, n, n; an expanded chain when b == 1,
    else a chain plus random edges per graph) and the [coors | mask | feats]
    table."""
    g = torch.Generator().manual_seed(seed)
    if ties:  # integer grid: every distance ties many times over
        coors = torch.randint(-2, 3, (b, n, c), generator=g).float()
    else:
        coors = 3.0 * torch.randn(b, n, c, generator=g)
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


def finite_err(torch, a, b) -> float:
    """The largest |a - b| over the entries where it is finite (NaN rankings
    are held by their bits alone)."""
    d = (a - b).abs()
    d = d[torch.isfinite(d)]
    return d.max().item() if d.numel() else 0.0


def same_bits_or_nan(torch, a, b) -> bool:
    """``same_bits`` with a NaN equal to any NaN: the card writes the
    canonical NaN where the CPU keeps another payload."""
    if a.shape != b.shape or not torch.equal(torch.isnan(a), torch.isnan(b)):
        return False
    return same_bits(torch, torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def same_bits(torch, a, b) -> bool:
    a, b = a.contiguous(), b.contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def device_ms(torch, fn, reps=20, trials=7) -> float:
    """Median device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph (after two calls on a side stream), replayed between two CUDA
    events ``trials`` times (no host launch gaps):
    ``utils/profiling.py:time_fn`` with ``graph_reps``."""
    from egnn_tpu_torch.utils.profiling import time_fn

    return time_fn(fn, reps=trials, warmup=2, stat="median", graph_reps=reps) * 1e3


def call_ms(torch, fn, iters=30, warmup=5) -> float:
    """Median time of one ``fn()`` call as a caller sees it: CUDA events
    recorded on either side of the call, host launch time included, after
    ``warmup`` calls (``utils/profiling.py:time_fn``)."""
    from egnn_tpu_torch.utils.profiling import time_fn

    return time_fn(fn, reps=iters, warmup=warmup, stat="median") * 1e3


def profile_forward(torch, fn, iters=10, label="b=1 forwards", unit="forward", by_name=None):
    """Device time by kernel over ``iters`` calls (torch.profiler); returns
    (kernel time of one call in ms, kernel launches of one call). A dict
    ``by_name`` receives each kernel's ms a call by its name."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # one warm-up step inside the profiler, left out of the sums: without it
    # the window's first launch goes unrecorded when it is a kernel of this
    # package and not a torch operator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters, repeat=1)) as prof:
        for _ in range(iters + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # kernels only: an aten op's entry repeats the time of the kernels it
    # launched, and a user annotation (the optimizer's step) spans kernels
    # and the host's gaps between them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events)
    if by_name is not None:
        by_name.update({e.key: e.self_device_time_total / iters / 1e3 for e in events})
    print(f"profile of {iters} {label}: kernel time {total / iters / 1e3:.4f} ms "
          f"per {unit} over {len(events)} kernels, "
          f"{sum(e.count for e in events) / iters:.1f} launches per {unit}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / iters / 1e3:.5f} ms/{unit} "
              f"{e.count / iters:7.2f} calls  {e.key[:90]}")
    return total / iters / 1e3, sum(e.count for e in events) / iters


def knn_bound_parts(b, n, c, k, tw, with_mask, adj_bytes):
    """(bytes_ms, operations_ms) of a selection kernel: each input read once
    (``adj_bytes`` is what the adjacency holds: n * n for one shared chain)
    and each output written once over the HBM rate; the f32 operations over
    the f32 peak: per pair 3c for the distance, one fill select and two
    compares with the running k-th. K1 has a table (tw > 0); K3 and K4 write
    vals f32 and idx i64, K5 and K6 keys i32 and cols i64, 12 bytes a slot."""
    nbytes = (4 * b * n * c + (b * n if with_mask else 0) + adj_bytes
              + 4 * b * n * tw                      # table
              + b * n * k * (4 + 8)                 # vals f32 | keys i32, idx i64
              + 4 * b * n * k * tw)                 # rows
    return bound_parts_ms(nbytes, b * n * n * (3 * c + 3))


def knn_bound(b, n, c, k, tw, with_mask, adj_bytes):
    """(bound_ms, bound_by): the larger of ``knn_bound_parts``."""
    t_bytes, t_ops = knn_bound_parts(b, n, c, k, tw, with_mask, adj_bytes)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cloud(torch, n, c, kind, seed):
    """(1, n, c) float32 coordinates on the card: ``uniform`` * 40,
    ``gaussian`` * 10 (benchmarks/net65k.py's clouds); ``heavy`` and
    ``tail``: a Gaussian with its tails drawn out, 10 sign(z) |z|^p with
    p = 1.08 and 1.3, whose wide outer cells fail the grid's certificate in
    about 5.8% and 13% of the rows at n = 65 536, k = 16 (Gaussian: 4.2%);
    ``diagonal``: points along a line, which overflow a grid cell whatever
    the edges; ``lattice``: the integer lattice of side n^(1/3); ``ties``:
    64 integer points repeated, so that every distance ties n / 64 times
    over and no candidate list covers a tie group."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "ties":
        base = torch.randint(-2, 3, (1, 64, c), generator=g, device="cuda").float()
        return base.repeat(1, n // 64, 1).contiguous()
    if kind == "diagonal":
        return (1e-3 * torch.arange(n, device="cuda", dtype=torch.float32))[None, :, None].expand(
            1, n, c).contiguous()
    if kind == "lattice":
        side = round(n ** (1 / 3))
        ax = torch.arange(side, device="cuda", dtype=torch.float32)
        return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(1, side ** 3, 3)
    if kind in ("gaussian", "heavy", "tail"):
        z = torch.randn(1, n, c, generator=g, device="cuda")
        power = {"gaussian": 1.0, "heavy": 1.08, "tail": 1.3}[kind]
        return 10.0 * z if power == 1.0 else 10.0 * z.sign() * z.abs() ** power
    return 40.0 * torch.rand(1, n, c, generator=g, device="cuda")


def prefix_mask(torch, n, frac=0.7):
    return (torch.arange(n, device="cuda") < int(frac * n))[None, :]


def chain_adj(torch, n):
    """One (n, n) bool chain i ~ i +- 1 on the card, expanded over b = 1."""
    ar = torch.arange(n, dtype=torch.int32, device="cuda")
    return ((ar[:, None] - ar[None, :]).abs() == 1).expand(1, n, n)


def pairs_bound(nbytes, pairs, c=3):
    """(bound_ms, bound_by, bytes_ms, operations_ms) of a kernel that ranks
    ``pairs`` (row, candidate) pairs: ``nbytes`` moved once over the HBM
    rate against 3c + 3 f32 operations a pair (the distance, one fill
    select, two compares with the running k-th) over the f32 peak."""
    t_bytes, t_ops = bound_parts_ms(nbytes, pairs * (3 * c + 3))
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def check_outputs(torch, outs, shapes, what):
    for out, shape in zip(outs, shapes):
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what}: output of shape {tuple(out.shape)} (expected "
                                 f"{shape}) or non-finite values")


@contextlib.contextmanager
def matmul_precision(torch, precision):
    """``torch.set_float32_matmul_precision(precision)`` for the block,
    the caller's setting restored in a ``finally``."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def check_equivariance(torch, forward, coors, what, select=None, swap_share=0.0,
                       atol=EQUIVARIANCE_ATOL, feats_atol=None):
    """forward(coors) -> (feats, coors_out); a rotation and a shift of the
    input leave feats and move coors_out the same way, within ``atol``
    (EQUIVARIANCE_ATOL; ``feats_atol`` for feats where given) at every node;
    returns the two largest errors. Beyond the full-band reach
    ``swap_share`` of the nodes may differ by more: the moved coordinates
    round the distances anew, so a row whose k-th and (k+1)-th neighbours
    lie within that rounding selects the other one (with tens of thousands
    of rows a few always do), and its output moves by one neighbour's
    message. ``select(coors)`` -> (b, n, k) sorted neighbour ids counts
    those rows in the first layer."""
    g = torch.Generator().manual_seed(SEED + 1)
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=g, dtype=torch.float64))
    rot = (q * torch.sign(torch.linalg.det(q))).float().cuda()
    shift = torch.randn(3, generator=g, dtype=torch.float64).float().cuda()
    with matmul_precision(torch, "highest"):   # the motion itself in exact f32
        moved = coors @ rot + shift
    with torch.inference_mode():
        f0, c0 = forward(coors)
        f1, c1 = forward(moved)
        ef = (f1 - f0).abs().amax(dim=-1)
        with matmul_precision(torch, "highest"):
            ec = (c1 - (c0 @ rot + shift)).abs().amax(dim=-1)
        feats_atol = atol if feats_atol is None else feats_atol
        over = ((ef > feats_atol) | (ec > atol)).float().mean().item()
        swapped = "" if select is None else (
            f"; rows whose first-layer neighbours differ after the motion: "
            f"{int((select(coors) != select(moved)).any(dim=-1).sum().item())}")
    print(f"equivariance {what}: feats invariance err {ef.max().item():.3e}, coors "
          f"equivariance err {ec.max().item():.3e}; share of nodes beyond atol "
          f"{feats_atol}, {atol}: {over:.6f} (allowed {swap_share}){swapped}")
    if over > swap_share:
        raise AssertionError(f"{what}: the forward is not equivariant")
    return ef.max().item(), ec.max().item()


def segment_bound(b, e, s, d):
    """(bound_ms, bound_by) of K2: data, int64 ids and output over the HBM
    rate, against one f32 add per data element over the f32 peak."""
    nbytes = b * (4 * e * d + 8 * e + 4 * s * d)
    t_bytes, t_ops = bound_parts_ms(nbytes, b * e * d)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def segment_reference(torch, plain, data, ids, s):
    """The float64 plain segment sum cast to float32, and the allowed error
    of each element: deg_s * 2^-23 * sum |data_e| over the segment, the worst
    case of a sequential f32 sum (on the CPU, in float64)."""
    d64, ids = data.detach().cpu().double(), ids.cpu()
    ref = plain(d64, ids, s).float().double()
    deg = plain(torch.ones_like(d64[..., :1]), ids, s)
    return ref, deg * 2.0**-23 * plain(d64.abs(), ids, s)


def check_segment_sum(torch, SK, name, data, ids, s, gen):
    """K2's gates on one case: three launches bitwise equal; bitwise equal to
    its model ``segment_sum_fixed_point`` (CPU) and to itself on the edges
    permuted by ``gen``; every finite element within deg * 2^-23 * sum|x| of
    the float64 sum, every other one the float64 sum's NaN or infinity.
    Raises on a failure; returns the largest error over the finite elements."""
    outs = [SK.segment_sum(data, ids, s) for _ in range(3)]
    perm = torch.randperm(ids.shape[1], generator=gen).to(ids.device)
    permuted = SK.segment_sum(data[:, perm].contiguous(), ids[:, perm].contiguous(), s)
    torch.cuda.synchronize()
    repeat = all(same_bits(torch, o, outs[0]) for o in outs[1:])
    order_free = same_bits(torch, permuted, outs[0])
    out = outs[0].cpu()
    model = same_bits(torch, out, SK.segment_sum_fixed_point(data, ids, s))
    ref, limit = segment_reference(torch, SK.segment_sum_plain, data, ids, s)
    finite = torch.isfinite(ref)
    err = (out.double() - ref).abs()[finite]
    within = bool((err <= limit[finite]).all())
    special = out[~finite].double()
    same_special = bool(((special == ref[~finite]) | (special.isnan() & ref[~finite].isnan()))
                        .all())
    cpu_bits = same_bits(torch, out, SK.segment_sum_plain(data.cpu(), ids.cpu(), s))
    max_err = err.max().item() if err.numel() else 0.0
    print(f"K2 case {name}: b={data.shape[0]} E={data.shape[1]} S={s} D={data.shape[2]} "
          f"ids {ids.dtype}: 3 launches bitwise={repeat}; bitwise equal to the model="
          f"{model}, to itself on permuted edges={order_free}; max err vs f64 {max_err:.3e}, "
          f"within deg*2^-23*sum|x|={within} (max limit {limit[finite].max().item():.3e}); "
          f"{int((~finite).sum())} non-finite elements as in f64={same_special}; equals the "
          f"CPU plain f32 bitwise={cpu_bits}")
    if not (repeat and model and order_free and within and same_special):
        raise AssertionError(f"K2 case {name}: not repeatable, not its model's bits, not "
                             f"order-free or outside its error")
    return max_err


# K10 and K11 against the float64 plain version: the kernel's largest error
# on a tensor may be PAIR_ERR_FACTOR times the float32 plain version's own,
# plus PAIR_ERR_FLOOR of the tensor's largest magnitude (both sum the same
# f32 terms, in other orders: the kernel row after row within a tile, tile
# after tile, block after block; the plain version as cuBLAS blocks them)
PAIR_ERR_FACTOR, PAIR_ERR_FLOOR = 8.0, 1e-5
# K10's tensor-core mode (phase 43) rounds values that the kernel computed
# itself (s1, m0, silu(cz1), d_z2, d_h1, ...). Two summation orders (the
# kernel's, cuBLAS's in the f32 plain version, float64's) round such a value
# one bf16 step apart where it lies within their difference of a bf16 tie, and
# what depends on it moves by that step: under 1% of a tensor's elements, up
# to 6.3e-3 of its largest value for the f32 plain version against float64
# (H100, PERF.md). A largest error then measures ties, and 8x it would admit
# the f32 kernel; in the mode the rule above holds each tensor's norm, where
# ties weigh as the few elements they are, and every element stays within
# PAIR_MODE_REACH of the tensor's largest value (measured: 6.3e-3 at most
# against float64, the norms at 0.31 of their limits at most, the f32 kernel
# at 18x or more; H100, PERF.md).
PAIR_MODE_REACH = 1.25e-2
PAIR_WEIGHT_NAMES = ("wj", "wd", "w2", "b2", "gw", "gb", "cw1", "cb1", "cw2", "cb2", "scale")


def pair_case(torch, seed, b, n, k, d=DIM, fourier=0, soft=False, norm=True, clamp=2.0,
              gfo=False, masked=True, m=16, c=3, self_pairs=False, spread=3.0, id_pool=None):
    """Inputs of K10 and K11 on one random neighbourhood, float32 on the
    card: coordinates, features, neighbour ids (the node itself in slot 0
    when ``self_pairs``; drawn from the first ``id_pool`` nodes, so that
    rows repeat ids and share them, when given), pair validity (a quarter of
    the slots 0 when ``masked``), upstream gradients and the eleven
    weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device="cuda")

    h, dd = 2 * (2 * d + 2 * fourier + 1), 2 * fourier + 1
    ar = torch.arange(n, device="cuda")[None, :, None]
    idx = (ar + torch.randint(1, n, (b, n, k), generator=g, device="cuda")) % n
    if id_pool is not None:
        idx = torch.randint(0, id_pool, (b, n, k), generator=g, device="cuda")
    if self_pairs:
        idx[..., 0] = ar[..., 0]
    pv = torch.rand(b, n, k, generator=g, device="cuda") > (0.25 if masked else -1.0)
    weights = (rand(d, h, scale=0.3), rand(dd, h, scale=0.3), rand(h, m, scale=0.3),
               rand(m, scale=0.3), rand(m, 1, scale=0.3), rand(1, scale=0.3),
               rand(m, 4 * m, scale=0.3), rand(4 * m, scale=0.3), rand(4 * m, 1, scale=0.3),
               rand(1, scale=0.3), 0.5 + torch.rand(1, generator=g, device="cuda"))
    return dict(
        coors=rand(b, n, c, scale=spread), feats=rand(b, n, d, scale=0.5), idx=idx, pv=pv,
        proj_i=rand(b, n, h, scale=0.3), weights=weights, g_mi=rand(b, n, m), g_cd=rand(b, n, c),
        opts=dict(fourier=fourier, soft_edges=soft, norm_coors=norm, clamp=clamp, eps=1e-8,
                  gate_feats_only=gfo))


def pair_cases():
    """Phase 21's cases of K10 and K11 (name, arguments of ``pair_case``),
    also held in the tensor-core mode by phase 43 with the same seeds."""
    from egnn_tpu_torch.ops.neighbors import CANDIDATE_SLACK

    return [  # name, arguments of pair_case
        ("anchor", dict(b=1, n=N, k=KNN)),
        ("anchor_self_pairs_b8", dict(b=8, n=N, k=KNN, self_pairs=True)),
        ("net65k_k16", dict(b=1, n=8190, k=KNN_A, masked=False, spread=10.0)),
        ("net65k_kc20_winners", dict(b=1, n=3001, k=KNN_A + CANDIDATE_SLACK)),
        ("k12_soft_fourier2", dict(b=2, n=1000, k=12, d=16, fourier=2, soft=True, norm=False,
                                   clamp=None)),
        ("gate_feats_only_fourier4", dict(b=2, n=777, k=8, d=8, fourier=4, soft=True, clamp=1.0,
                                          gfo=True)),
        ("bare_k5_b3", dict(b=3, n=500, k=5, d=16, norm=False, clamp=None, masked=False)),
        ("c5_m8_k7", dict(b=1, n=600, k=7, d=12, m=8, c=5)),
        ("dim64_tile_of_8", dict(b=1, n=512, k=8, d=64)),    # wider weights: K10b's one-block tile
        ("k64", dict(b=1, n=300, k=64, d=16)),               # one node a tile
        # the backward's blocks at their edges at once: 30 rows of a 32-row
        # tile (not a multiple of the 4-row group), the last tile of each
        # graph 3 nodes of 6, odd dd; d + dd = 17 and 4m = 48 weight-gradient
        # rows and columns (h = 54 takes one-column products)
        ("k5_fourier3_soft_b2_partial", dict(b=2, n=333, k=5, d=10, fourier=3, soft=True, m=12)),
        # the same edges under the five-column products: h = 134, not a
        # multiple of five, d + dd = 35
        ("k5_h134_fourier1_soft_b2_partial", dict(b=2, n=333, k=5, d=32, fourier=1, soft=True)),
        # more encodings than the distance backward's eight lanes a row, and
        # a lane a coordinate on all eight
        ("fourier12_c8_k6", dict(b=2, n=301, k=6, d=8, fourier=12, c=8, soft=True)),
        # the forward's tile loop: 64-row tiles, 519 of them on 264 blocks
        # (unequal counts; a block's last tile stages nothing after it), the
        # loop crossing batch elements, a last tile of 2 nodes of 4
        ("k16_b3_cross_batch_partial", dict(b=3, n=690, k=16)),
        # K11 gathering repeated ids (every row's 16 neighbours among 4 nodes)
        # on 64-row tiles at h = 134, the h1 product's last column block cut
        # short in its second round of items
        ("k16_h134_repeated_ids_b2", dict(b=2, n=513, k=16, d=32, fourier=1, soft=True,
                                          id_pool=4)),
    ]


def pair_args(torch, PM, case, gather, dtype):
    """The case as the wrappers' positional tensors (K10: coors, cj, fj,
    proj_i, pv; K11: coors, proj_i, proj_j, idx, pv) and weights, in
    ``dtype``, and its PairOptions."""
    cast = lambda t: t.to(dtype)  # noqa: E731
    b, n, k = case["idx"].shape
    weights = tuple(cast(w) for w in case["weights"])
    opts = PM.PairOptions(**case["opts"])
    coors, feats = cast(case["coors"]), cast(case["feats"])
    if gather:
        return (coors, cast(case["proj_i"]), feats @ weights[0], case["idx"], case["pv"]), \
            weights[1:], opts._replace(gate_feats_only=False)
    rows = lambda x: PM._gather_rows(x, case["idx"]).reshape(b, n * k, -1)  # noqa: E731
    return (coors, rows(coors), rows(feats), cast(case["proj_i"]),
            cast(case["pv"].reshape(b, n * k, 1))), weights, opts


def check_pair_kernels(torch, PM, name, case, gather, repeats=3, mxu_bf16=False, report=None):
    """One of K10 (``gather`` False) or K11 on ``case``, K10 in its
    tensor-core mode where ``mxu_bf16``: forward and backward on the card
    against the plain versions (in the same mode) in float64, within the
    stated multiple of the float32 plain version's own error; ``repeats``
    launches bitwise equal. The errors are each tensor's largest, in the mode
    its norm and every element within PAIR_MODE_REACH; there the f32 kernel
    must miss the limit in a forward and in a backward tensor. Returns the
    largest absolute errors (forward, backward). With a ``report`` dict it
    raises nothing: the dict receives what failed (``failed``, empty on a
    pass), the tensor nearest its limit and its ratio, the f32 kernel's
    ratios, and the kernel's outputs beside the float64 plain version's."""
    kname = "K11" if gather else ("K10 (mxu_bf16)" if mxu_bf16 else "K10")
    plain_f = PM.fused_knn_messages_plain if gather else PM.fused_pair_messages_plain
    plain_b = (PM.fused_knn_messages_backward_plain if gather
               else PM.fused_pair_messages_backward_plain)
    fused = PM.fused_knn_messages if gather else PM.fused_pair_messages
    diff = (0, 1, 2) if gather else (0, 1, 2, 3)   # the tensors with a gradient

    def flat(out):
        """(d_inputs..., weight gradients) -> one list."""
        return list(out[:-1]) + list(out[-1])

    results = {}
    for dtype in (torch.float64, torch.float32):
        args, weights, opts = pair_args(torch, PM, case, gather, dtype)
        opts = opts._replace(mxu_bf16=mxu_bf16)
        g = (case["g_mi"].to(dtype), case["g_cd"].to(dtype))
        results[dtype] = (plain_f(*args, weights, opts),
                          flat(plain_b(*args, weights, *g, opts)))
    args, weights, opts = pair_args(torch, PM, case, gather, torch.float32)
    o = case["opts"]
    static = (o["fourier"], o["soft_edges"], o["norm_coors"], o["clamp"], o["eps"])

    def launch(mode):
        leaves = [a.clone().requires_grad_() if i in diff else a for i, a in enumerate(args)]
        ws = [w.clone().requires_grad_() for w in weights]
        out = fused(*leaves, *static, *(() if gather else (mode, o["gate_feats_only"])), *ws)
        grads = torch.autograd.grad(out, [leaves[i] for i in diff] + ws,
                                    (case["g_mi"], case["g_cd"]))
        return [t.detach() for t in out], list(grads)

    runs = [launch(mxu_bf16) for _ in range(repeats)]
    control = launch(False) if mxu_bf16 else None   # the f32 kernel
    torch.cuda.synchronize()
    repeatable = all(same_bits(torch, a, b) for run in runs[1:]
                     for a, b in zip(run[0] + run[1], runs[0][0] + runs[0][1]))
    names_f = ("m_i", "coors_delta")
    names_b = (("d_coors", "d_proj_i", "d_proj_j") if gather
               else ("d_coors", "d_cj", "d_fj", "d_proj_i")) + tuple(
        "d_" + w for w in PAIR_WEIGHT_NAMES[1 if gather else 0:])
    size = ((lambda t: torch.linalg.vector_norm(t).item()) if mxu_bf16
            else (lambda t: t.abs().max().item()))

    def against(ker, p32, ref):
        """(kernel's error, the f32 plain version's, the limit)"""
        e_p = size(p32.double() - ref)
        return size(ker.double() - ref), e_p, PAIR_ERR_FACTOR * e_p + PAIR_ERR_FLOOR * max(
            size(ref), 1e-30)

    worst, failed = [], []
    errs, reach, miss = [0.0, 0.0], 0.0, [0.0, 0.0]
    for part, names in ((0, names_f), (1, names_b)):
        for i, (tname, ker, p32, ref) in enumerate(zip(
                names, runs[0][part], results[torch.float32][part], results[torch.float64][part])):
            e_k, e_p, limit = against(ker, p32, ref)
            errs[part] = max(errs[part], (ker.double() - ref).abs().max().item())
            worst.append((e_k / limit, tname, e_k, e_p))
            if not (e_k <= limit) or not bool(torch.isfinite(ker).all()):
                failed.append(f"{tname} differs from the float64 plain version by {e_k:.3e}, the "
                              f"float32 plain version by {e_p:.3e} (limit {limit:.3e})")
            if mxu_bf16 and ref.abs().max().item() > 0.0:
                r = ((ker.double() - ref).abs().max() / ref.abs().max()).item()
                reach = max(reach, r)
                if not r <= PAIR_MODE_REACH:
                    failed.append(f"{tname} is {r:.3e} of its largest value from the float64 "
                                  f"plain version at an element (limit {PAIR_MODE_REACH})")
                e_c, _, limit_c = against(control[part][i], p32, ref)
                miss[part] = max(miss[part], e_c / limit_c)
    ratio, tname, e_k, e_p = max(worst)
    b, n, k = case["idx"].shape
    mode = ""
    if mxu_bf16:
        mode = (f"; as a norm; every element within {reach:.3e} of its largest value; the f32 "
                f"kernel at {miss[0]:.2f} (forward) and {miss[1]:.2f} (backward) of the limit")
        if not (miss[0] > 1.0 and miss[1] > 1.0):
            failed.append("the f32 kernel passes the mode's check")
    print(f"{kname} case {name}: b={b} n={n} k={k} d={case['feats'].shape[-1]} {o}: forward max "
          f"err {errs[0]:.3e}, backward max err {errs[1]:.3e} against float64; nearest its limit "
          f"{tname} ({e_k:.3e}, plain f32 {e_p:.3e}, {ratio:.3f} of the limit){mode}; {repeats} "
          f"forward and backward launches bitwise={repeatable}")
    if not repeatable:
        failed.append("launches are not bitwise repeatable")
    if report is not None:
        report.update(failed=failed, ratio=ratio, tensor=tname, miss=tuple(miss), reach=reach,
                      names=names_f + names_b, kernel=runs[0][0] + runs[0][1],
                      ref=list(results[torch.float64][0]) + results[torch.float64][1])
    elif failed:
        raise AssertionError(f"{kname} case {name}: {'; '.join(failed)}")
    return errs


def pair_bound(b, n, k, c, d, h, m, fourier, soft, gather, backward):
    """(bound_ms, bound_by, bytes_ms, operations_ms) of K10 or K11. Bytes:
    every input read once and every output written once (K10: the gathered
    rows, a float32 validity and Wj; K11: proj_j, int64 ids and a bool
    validity). Operations: 2 for each multiply-add of the products a pair,
    d*h (K10 alone: K11 reads proj_j[idx] where K10 computes fj @ Wj) + dd*h
    + h*m (+ m with a soft gate) + m*4m + 4m, once forward, three times
    backward (the recomputation, the input gradients and the weight
    gradients), over the f32 peak outside the tensor cores."""
    dd, pairs, nodes = 2 * fourier + 1, b * n * k, b * n
    wj = 0 if gather else d * h
    weights = wj + dd * h + h * m + m + (m + 1 if soft else 0) + m * 4 * m + 4 * m + 4 * m + 2
    j_side = pairs * 9 + nodes * h * 4 if gather else pairs * (c + d + 1) * 4
    nbytes = nodes * (c + h) * 4 + j_side + weights * 4 + nodes * (m + c) * 4
    if backward:
        # the same inputs and the upstream gradients in; every gradient out
        nbytes += nodes * (c + h) * 4 + weights * 4 + (
            nodes * h * 4 if gather else pairs * (c + d) * 4)
    macs = wj + dd * h + h * m + (m if soft else 0) + m * 4 * m + 4 * m
    ops = 2 * macs * pairs * (3 if backward else 1)
    t_bytes, t_ops = bound_parts_ms(nbytes, ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def unfused_pipeline(torch, core, coors, cj, fj, proj_i, pv, weights, opts):
    """What the unfused EGNN layer runs on the same pairs, in torch
    operators as ``models/egnn.py`` has them (fused silu, ``where`` for the
    mask, ``coors_norm``): (m_i, coors_delta) from K10's arguments."""
    F = torch.nn.functional
    wj, wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2, scale = weights
    b, n, c = coors.shape
    pair_mask = pv.reshape(b, n, -1, 1) > 0.5
    rel = coors[:, :, None, :] - cj.reshape(b, n, -1, c)
    dist = (rel ** 2).sum(dim=-1)
    distf = core.fourier_encode_dist(dist, num_encodings=opts.fourier) if opts.fourier \
        else dist[..., None]
    m_ij = F.silu(proj_i[:, :, None, :] + fj.reshape(b, n, -1, fj.shape[-1]) @ wj + distf @ wd)
    m_ij = F.silu(m_ij @ w2 + b2)
    if opts.soft_edges:
        m_ij = m_ij * torch.sigmoid(m_ij @ gw + gb)
    w = F.silu(m_ij @ cw1 + cb1) @ cw2 + cb2
    rel_n = core.coors_norm(rel, scale) if opts.norm_coors else rel
    w = torch.where(pair_mask, w, 0.0)
    if opts.clamp is not None:
        w = w.clamp(-opts.clamp, opts.clamp)
    return torch.where(pair_mask, m_ij, 0.0).sum(dim=-2), (w * rel_n).sum(dim=-2)


# anchor configuration 5 (examples/molecule_regression.py:133-149,
# benchmarks/bench_all.py:127-171): EGNNSparseNetwork over packed molecules
SP_G, SP_G_LARGE, SP_NA, SP_K, SP_LAYERS, SP_DIM = 32, 512, 32, 8, 4, 64
SP_NET = dict(n_layers=SP_LAYERS, feats_dim=1, embedding_nums=[5], embedding_dims=[SP_DIM],
              fourier_features=4, norm_feats=True, norm_coors=True, aggr="add")
SP_HIDDEN = 2 * (2 * SP_DIM + 2 * 4 + 1)   # 274
# the arms of bench_all.py:152-160 without its bfloat16 ones: (a) the general
# segment path, (b) the example's uniform layout, (c) (b) through K10, (d) (a)
# with global attention every second layer
SP_ARMS = {
    "a": {},
    "b": dict(uniform_degree=SP_K, uniform_graph_size=SP_NA),
    "c": dict(uniform_degree=SP_K, uniform_graph_size=SP_NA, fused_uniform=True),
    "d": dict(global_linear_attn_every=2),
}
SP_STEPS = 5
SP_GRAD_TOL = 1e-5   # card against CPU, relative, as the dense path's TRAIN_GRAD_TOL
# a step's parameter gradients, arm (c) against arm (b) on the card: the
# dense path's 5e-3 (FUSED_VS_UNFUSED_GRAD_TOL) covers the self pairs'
# +-scale/eps terms under norm_coors; kNN edges of the sparse path hold no
# self pair, and the two arms differ by the order of their f32 sums alone
# (measured 5.2e-7, H100, PERF.md)
SP_FUSED_GRAD_TOL = 1e-5
CHARGES = (-0.8, -0.3, 0.1, 0.5, 1.0)   # molecule_regression.py's per-type charges


def molecule_batch(torch, knn_graph, G, seed, lattice=False):
    """(MoleculeBatch, clean coordinates): G packed molecules as
    molecule_regression.py:94-124 builds them: SP_NA atom slots, 8 to SP_NA
    of them valid, coordinates 2 N(0, 1) (or an integer lattice: ties), a
    type column in [0, 5), the Coulomb-like target; here x holds the
    coordinates plus N(0, 1) noise, the denoising objective's input
    (denoise_sparse.py:68-74). Each molecule's kNN edges, offset into the
    packed node set, come from ``knn_graph(graph_size=SP_NA)`` on the card:
    one K3 launch with b = G. Drawn on the CPU from ``seed``."""
    from egnn_tpu_torch.training.data import MoleculeBatch

    g = torch.Generator().manual_seed(seed)
    n = G * SP_NA
    types = torch.randint(0, 5, (G, SP_NA), generator=g)
    lengths = torch.randint(8, SP_NA + 1, (G, 1), generator=g)
    mask = torch.arange(SP_NA)[None, :] < lengths
    coors = (torch.randint(0, 4, (G, SP_NA, 3), generator=g).float() if lattice
             else 2.0 * torch.randn(G, SP_NA, 3, generator=g))
    noised = coors + torch.randn(G, SP_NA, 3, generator=g)
    q = torch.tensor(CHARGES)[types]
    pm = mask[:, :, None] & mask[:, None, :] & ~torch.eye(SP_NA, dtype=torch.bool)
    r = ((coors[:, :, None] - coors[:, None]) ** 2).sum(-1).clamp(min=1e-2).sqrt()
    target = 0.5 * torch.where(pm, q[:, :, None] * q[:, None, :] / r, 0.0).sum(dim=(1, 2))
    x = torch.cat([noised.reshape(n, 3), types.reshape(n, 1).float()], dim=-1).cuda()
    node_mask = mask.reshape(n).cuda()
    es = knn_graph(x[:, :3], SP_K, node_mask=node_mask, graph_size=SP_NA)
    batch = torch.arange(G, device="cuda").repeat_interleave(SP_NA)
    return (MoleculeBatch(x=x, edge_index=es.edge_index, edge_mask=es.mask, batch_ids=batch,
                          node_mask=node_mask, target=target.cuda()),
            coors.reshape(n, 3).cuda())


def sparse_phases(torch, parent=None):
    """Phases 25-29: anchor 5, the sparse family, on the card; each kernel's
    time at the sparse shapes is printed (the kernels line keeps anchor 3's
    rows), the f32 K10b's beside a ``parent`` checkout's (the path of its
    ``csrc/pair_messages.cu``), where given. Raises on a failure."""
    from egnn_tpu_torch import EGNNSparseNetwork
    from egnn_tpu_torch.ops import core
    from egnn_tpu_torch.ops import graph as GR
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.ops.cuda import knn as K
    from egnn_tpu_torch.ops.cuda import pair_messages as PM
    from egnn_tpu_torch.ops.cuda import segment as SK
    from egnn_tpu_torch.training import make_adam, masked_mse

    t_start = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # ---- 25. K10f and K10b at anchor 5's widths (the F5 gate) ----
    if not PM.supports_fused_pair_messages(SP_K, SP_HIDDEN, 16, SP_DIM, fourier=4):
        raise AssertionError("the fused gate refuses anchor 5's widths (F5)")
    sp_err = {"fused_pair_fwd": 0.0, "fused_pair_bwd": 0.0}
    for i, soft in enumerate((False, True)):
        case = pair_case(torch, SEED + 500 + i, b=1, n=SP_G * SP_NA, k=SP_K, d=SP_DIM,
                         fourier=4, soft=soft, clamp=None, gfo=True)
        rows_f = PM._fwd_tile_rows(1, SP_G * SP_NA, SP_K, 3, SP_DIM, SP_HIDDEN, 16, 64, 4, soft,
                                   sms)
        rows_b = PM._bwd_tile_rows(SP_K, 3, SP_DIM, SP_HIDDEN, 16, 64, 4, soft)
        print(f"K10 at anchor 5's widths (d={SP_DIM}, fourier 4, h={SP_HIDDEN}, "
              f"gate_feats_only, soft={soft}): forward tile {rows_f} rows, backward tile "
              f"{rows_b} rows")
        e_f, e_b = check_pair_kernels(torch, PM, f"anchor5_soft{int(soft)}", case, False)
        sp_err["fused_pair_fwd"] = max(sp_err["fused_pair_fwd"], e_f)
        sp_err["fused_pair_bwd"] = max(sp_err["fused_pair_bwd"], e_b)
        del case

    print(f"(phases 25-29 so far: {time.perf_counter() - t_start:.1f} s)")
    # ---- 26. knn_graph on the card against the CPU, bitwise, every route ----
    def same_edges(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

    for lattice in (False, True):
        mb, _ = molecule_batch(torch, GR.knn_graph, SP_G, SEED + 600 + lattice, lattice)
        coors, nm = mb.x[:, :3].contiguous(), mb.node_mask
        # SP_G graphs of random sizes over the same nodes
        n = coors.shape[0]
        cuts = torch.randperm(n - 1, generator=torch.Generator().manual_seed(
            SEED + 610 + lattice))[:SP_G - 1].sort().values + 1
        sizes = torch.diff(torch.cat([torch.zeros(1, dtype=cuts.dtype), cuts,
                                      torch.tensor([n])]))
        ragged = torch.arange(SP_G).repeat_interleave(sizes).cuda()
        routes = {
            "per_molecule": lambda c, m: [GR.knn_graph(c[g * SP_NA:(g + 1) * SP_NA], SP_K,
                                                       node_mask=m[g * SP_NA:(g + 1) * SP_NA])
                                          for g in range(SP_G)],
            "graph_size": lambda c, m: [GR.knn_graph(c, SP_K, node_mask=m, graph_size=SP_NA)],
            "ragged_batch": lambda c, m: [GR.knn_graph(c, SP_K, node_mask=m,
                                                       batch=ragged.to(c.device))],
        }
        for route, build_edges in routes.items():
            reset_launch_counts()
            card = build_edges(coors, nm)
            torch.cuda.synchronize()
            k3 = LAUNCH_COUNTS["knn_select"]
            cpu_edges = build_edges(coors.cpu(), nm.cpu())
            ok = all(same_edges(a, b) for a, b in zip(card, cpu_edges))
            print(f"knn_graph {route} ({'lattice ties' if lattice else 'Gaussian'}): "
                  f"{sum(int(e.mask.sum()) for e in card)} live edges, card against CPU "
                  f"bitwise={ok}; K3 launches {k3}")
            if not ok or k3 != len(card):
                raise AssertionError(f"knn_graph {route}: card and CPU edges differ or K3 did "
                                     f"not launch once a call")
            if route == "per_molecule":
                # the same live edges as one graph_size call, offset per molecule
                whole = GR.knn_graph(coors, SP_K, node_mask=nm, graph_size=SP_NA)
                off = [e.senders + g * SP_NA for g, e in enumerate(card)]
                live = torch.cat([e.mask for e in card])
                if not (torch.equal(live, whole.mask)
                        and torch.equal(torch.cat(off)[live], whole.senders[live])):
                    raise AssertionError("per-molecule and graph_size edges differ")

    print(f"(phases 25-29 so far: {time.perf_counter() - t_start:.1f} s)")
    # ---- 27. serving anchor 5 in arms (a)-(d) ----
    def make_net(arm, seed=SEED, device="cuda"):
        return EGNNSparseNetwork(**SP_NET, **SP_ARMS[arm], device=device,
                                 generator=torch.Generator().manual_seed(seed))

    def forward(net, mb, x=None):
        return net(mb.x if x is None else x, mb.edge_index, batch=mb.batch_ids,
                   edge_mask=mb.edge_mask, num_graphs=mb.target.shape[0],
                   node_mask=mb.node_mask)

    def serve(net, mb):
        """The serving path: the molecules' kNN edges (K3), then the network."""
        es = GR.knn_graph(mb.x[:, :3], SP_K, node_mask=mb.node_mask, graph_size=SP_NA)
        return forward(net, mb._replace(edge_index=es.edge_index, edge_mask=es.mask))

    def cpu_batch(mb):
        return type(mb)(*(t.cpu() for t in mb))

    def expected_launches(arm, forwards):
        """K2 and K10f launches of ``forwards`` forwards: the general path's
        five segment sums a layer (two aggregations, the graph LayerNorm's
        count and two sums), eight a global-attention block (two LayerNorms,
        the softmax's denominator, the induced tokens); K10f one a layer in
        (c)."""
        seg = 0 if SP_ARMS[arm].get("uniform_degree") else 5 * SP_LAYERS
        every = SP_ARMS[arm].get("global_linear_attn_every", 0)
        seg += 8 * len(range(0, SP_LAYERS, every)) if every else 0
        return {"segment_sum": seg * forwards,
                "fused_pair_fwd": SP_LAYERS * forwards if arm == "c" else 0}

    requests = [molecule_batch(torch, GR.knn_graph, SP_G, SEED + 700 + i)[0] for i in range(4)]
    outs, sparse_counts = {}, {}
    for arm in SP_ARMS:
        net = make_net(arm).eval()
        reset_launch_counts()
        with torch.inference_mode():
            outs[arm] = [serve(net, mb) for mb in requests]
        torch.cuda.synchronize()
        counts = sparse_counts[arm] = dict(LAUNCH_COUNTS)
        expect = dict(expected_launches(arm, len(requests)), knn_select=len(requests))
        print(f"anchor-5 arm ({arm}) {SP_ARMS[arm]} serving: {len(requests)} batches of {SP_G} "
              f"molecules; launches { {k: v for k, v in counts.items() if v} } (expected "
              f"{expect})")
        if any(counts[k] != v for k, v in expect.items()) or sum(counts.values()) != sum(
                expect.values()):
            raise AssertionError(f"arm ({arm}): the launches are not what the path implies")
        for o in outs[arm]:
            check_outputs(torch, (o,), ((SP_G * SP_NA, 3 + SP_DIM),), f"arm ({arm})")
        net_cpu = copy.deepcopy(net).to("cpu")
        with torch.inference_mode():
            o_cpu = serve(net_cpu, cpu_batch(requests[0]))
        err = (outs[arm][0].cpu() - o_cpu).abs().max().item()
        print(f"anchor-5 arm ({arm}): card against CPU max err {err:.3e} (atol {GPU_VS_CPU_ATOL})")
        if not err <= GPU_VS_CPU_ATOL:
            raise AssertionError(f"arm ({arm}): card and CPU forwards disagree")
        mb0 = requests[0]

        def moved(c, net=net, mb0=mb0):
            o = serve(net, mb0._replace(x=torch.cat([c, mb0.x[:, 3:]], dim=-1)))
            return o[:, 3:], o[:, :3]

        check_equivariance(torch, moved, mb0.x[:, :3].contiguous(), f"anchor-5 arm ({arm})")
        del net, net_cpu
    err_cb = max((c - b).abs().max().item() for c, b in zip(outs["c"], outs["b"]))
    print(f"anchor-5 arm (c) against arm (b) on the card: max err {err_cb:.3e} "
          f"(atol {GPU_VS_CPU_ATOL})")
    if not err_cb <= GPU_VS_CPU_ATOL:
        raise AssertionError("the fused arm (c) and the per-edge arm (b) disagree")
    del outs

    print(f"(phases 25-29 so far: {time.perf_counter() - t_start:.1f} s)")
    # ---- 28. training: fwd+bwd and the denoising objective in every arm ----
    def fwd_bwd(net, mb):
        """bench_all.py:162-165's objective: (o[:, 3:]**2).mean(), its gradient wrt x."""
        x = mb.x.detach().requires_grad_()
        return torch.autograd.grad((forward(net, mb, x)[:, 3:] ** 2).mean(), x)[0]

    def make_step(net):
        opt = make_adam(net.parameters(), LR)

        def step(mb, clean):
            opt.zero_grad(set_to_none=True)
            loss = masked_mse(forward(net, mb)[:, :3], clean, mb.node_mask)
            loss.backward()
            opt.step()
            return loss.detach()
        return step

    def step_grads(model, batch, target):
        model.zero_grad(set_to_none=True)
        masked_mse(forward(model, batch)[:, :3], target, batch.node_mask).backward()

    mb, clean = molecule_batch(torch, GR.knn_graph, SP_G, SEED + 800)
    grads, step_counts = {}, {}
    for arm in SP_ARMS:
        net = make_net(arm, SEED + 3)
        net_cpu = copy.deepcopy(net).to("cpu")
        g_x = fwd_bwd(net, mb)
        g_x_cpu = with_k2_sums(fwd_bwd, net_cpu, cpu_batch(mb))
        ex = (torch.linalg.vector_norm(g_x.cpu().double() - g_x_cpu.double())
              / torch.linalg.vector_norm(g_x_cpu.double())).item()
        # one step's parameter gradients, card against CPU
        step_grads(net, mb, clean)
        with_k2_sums(step_grads, net_cpu, cpu_batch(mb), clean.cpu())
        grads[arm] = {name: p.grad.detach().clone() for name, p in net.named_parameters()
                      if p.grad is not None}
        errs = []
        for (name, p), q in zip(net.named_parameters(), net_cpu.parameters()):
            if (p.grad is None) != (q.grad is None):
                raise AssertionError(f"arm ({arm}): {name} has a gradient on one device only")
            if p.grad is not None:
                diff = torch.linalg.vector_norm(p.grad.cpu().double() - q.grad.double()).item()
                norm = torch.linalg.vector_norm(q.grad.double()).item()
                errs.append((diff / max(norm, 1e-300), name))
        worst = max(errs)
        print(f"anchor-5 arm ({arm}) fwd+bwd: d x card against CPU ||g - g_cpu|| / ||g_cpu|| "
              f"{ex:.3e}; one step's parameter gradients: largest {worst[0]:.3e} ({worst[1]}), "
              f"median {statistics.median(e for e, _ in errs):.3e} over {len(errs)} "
              f"(tol {SP_GRAD_TOL})")
        if not (ex <= SP_GRAD_TOL and worst[0] <= SP_GRAD_TOL):
            raise AssertionError(f"arm ({arm}): card and CPU gradients disagree")
        step = make_step(make_net(arm, SEED + 4))
        reset_launch_counts()
        losses = torch.stack([step(mb, clean) for _ in range(SP_STEPS)]).cpu()
        torch.cuda.synchronize()
        counts = step_counts[arm] = dict(LAUNCH_COUNTS)
        print(f"anchor-5 arm ({arm}) denoising, make_adam lr {LR}: {SP_STEPS} steps on one "
              f"batch, losses {losses.tolist()}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if not (bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]):
            raise AssertionError(f"arm ({arm}): the loss did not fall")
        fused = SP_LAYERS * SP_STEPS if arm == "c" else 0
        if counts["fused_pair_fwd"] != fused or counts["fused_pair_bwd"] != fused:
            raise AssertionError(f"arm ({arm}): K10f/K10b did not run once a layer a step")
        del net, net_cpu, step
    errs = [((torch.linalg.vector_norm((grads["c"][name] - g).double())
              / torch.linalg.vector_norm(g.double())).item(), name)
            for name, g in grads["b"].items()]
    print(f"anchor-5 arm (c) against arm (b), one step's parameter gradients on the card: "
          f"largest {max(errs)[0]:.3e} ({max(errs)[1]}) (tol {SP_FUSED_GRAD_TOL})")
    if max(errs)[0] > SP_FUSED_GRAD_TOL:
        raise AssertionError("the fused arm's gradients disagree with the per-edge arm's")

    print(f"(phases 25-29 so far: {time.perf_counter() - t_start:.1f} s)")
    # ---- 29. timing at G = 32 and G = 512 ----
    for G in (SP_G, SP_G_LARGE):
        mb, clean = molecule_batch(torch, GR.knn_graph, G, SEED + 900 + G)
        n, e = G * SP_NA, G * SP_NA * SP_K
        reps, trials = (5, 5) if G == SP_G else (2, 5)
        for arm in SP_ARMS:
            net = make_net(arm).eval()
            with torch.inference_mode():
                f_call = call_ms(torch, lambda: forward(net, mb), iters=10, warmup=3)
                f_dev = device_ms(torch, lambda: forward(net, mb), reps=reps, trials=trials)
            fb_call = call_ms(torch, lambda: fwd_bwd(net, mb), iters=10, warmup=3)
            fb_dev = device_ms(torch, lambda: fwd_bwd(net, mb), reps=reps, trials=trials)
            step = make_step(make_net(arm).train())
            s_call = call_ms(torch, lambda: step(mb, clean), iters=10, warmup=3)
            s_dev = device_ms(torch, lambda: step(mb, clean), reps=reps, trials=trials)
            s_kernel, s_launches = profile_forward(
                torch, lambda: step(mb, clean), iters=2,
                label=f"anchor-5 arm ({arm}) G={G} train steps", unit="step")
            print(f"anchor-5 arm ({arm}) G={G} ({n} nodes, {e} edges, {SP_LAYERS} layers): "
                  f"forward {f_call:.4f} ms a call, {f_dev:.4f} ms replayed; fwd+bwd "
                  f"{fb_call:.4f} ms a call, {fb_dev:.4f} ms replayed "
                  f"({e * SP_LAYERS / (fb_call / 1e3):.6e} edges/s); train step {s_call:.4f} ms "
                  f"a call, {s_dev:.4f} ms replayed, kernel time {s_kernel:.4f} ms, busy "
                  f"{s_kernel / s_call:.3f}, {s_launches:.1f} launches")
            del net, step
        sparse_kernel_timing(torch, K, SK, PM, core, mb, G, sms, sp_err, sparse_counts,
                             step_counts, parent)
    print(f"phases 25-29 (anchor 5): {time.perf_counter() - t_start:.1f} s")


# the dense family's last options (phases 30-33): anchor 3 with global
# attention every second layer, the JAX defaults of 8 heads of 64 and 4
# global tokens (egnn_tpu/models/egnn.py:591-594)
ATTN_EVERY = 2
# bf16 against f32, tests/test_mixed_precision.py:19-33; the card's bf16
# against the CPU's bf16 is held to the same bound (each rounds the message
# products to bf16 in its own order)
BF16_ATOL = 0.05
# one attention step's parameter gradients, card against CPU. Under
# norm_coors the self pairs' +-(scale / 1e-8) terms in the coordinate
# gradients cancel only to f32 rounding (see STREAM_NORM_COORS_GRAD_TOL)
# and reach every weight through the later layers: plain anchor 3 meets
# TRAIN_GRAD_TOL only because the card and the CPU round its sums in one
# order. Attention's products are rounded in other orders on each: on the
# CPU, this step's f32 gradients are up to 1.1e-3 from float64 (pos_emb;
# 1.6e-3 without attention), within 1.8e-6 without norm_coors, where the
# step is held to TRAIN_GRAD_TOL. Measured: 2.9e-4 (H100, PERF.md)
ATTN_NORM_COORS_GRAD_TOL = 2e-3
DROPOUT = 0.1
# benchmarks/round2_measurements.py:48-70 (stream_ab): one streamed layer,
# dim 64, norm_coors, b = 1; against the CPU at benchmarks/kbench.py:80's n
N_STREAM, DIM_STREAM, N_STREAM_CPU, N_STREAM_MAT = 8192, 64, 2048, 1024
STREAM_GRAD_TOL = 1e-5   # relative, as TRAIN_GRAD_TOL
# The coordinate gradient under norm_coors: each node's self pair (rel = 0,
# its norm clamped to 1e-8) puts +-(scale / 1e-8) w_ii g_i into the i-side
# and the j-side sums of d coors, which cancel only to f32 rounding, in
# another order on each device. On the CPU the f32 gradient is 1.57e-2 from
# the float64 one at this layer (n = 2048; every other gradient within
# 4.5e-7, and the coordinate gradient within 9.3e-7 without norm_coors):
# two f32 results may differ by twice that. Measured: 2.4e-3 (H100, PERF.md)
STREAM_NORM_COORS_GRAD_TOL = 5e-2
# anchors 1 and 2 (benchmarks/bench_all.py:28-49): one layer, dim 512, n = 16
N_ANCHOR12, DIM_ANCHOR12 = 16, 512


def rel_err(torch, a, b) -> float:
    """||a - b|| / ||b|| in float64 on the CPU (0 for two zero tensors)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    norm = torch.linalg.vector_norm(b).item()
    return torch.linalg.vector_norm(a - b).item() / max(norm, 1e-300)


def device_launches(torch, fn):
    """(kernel time in ms, device launches, seconds taken) of one ``fn()``
    under torch.profiler with the device's activity alone, its events
    counted raw: a streamed layer's call holds some 10^5 launches, which
    ``key_averages`` (as ``profile_forward`` uses it) takes half a minute
    to sort."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    return (sum(e.duration_ns() for e in events) / 1e6, len(events),
            time.perf_counter() - t0)


def with_k2_sums(fn, *args):
    """``fn`` on the CPU with its segment sums in K2's arithmetic (the model,
    bitwise K2's): the card and the CPU then sum the same terms to the same
    bits, and what is left between them is the matmuls' rounding. The plain
    version adds in edge order, and that order alone moves a step's
    gradients far more (phase 9 prints it, on the CPU)."""
    from egnn_tpu_torch.ops.cuda import segment as SK

    plain = SK.segment_sum_plain
    SK.segment_sum_plain = SK.segment_sum_fixed_point
    try:
        return fn(*args)
    finally:
        SK.segment_sum_plain = plain


def dense_option_phases(torch):
    """Phases 30-33: the dense family's last options on the card: anchor
    3 with global attention (f32 and bf16), dropout in training mode, the
    streamed all-pairs layer at n = 8192, anchors 1 and 2. Raises on a
    failure."""
    import numpy as np

    from egnn_tpu_torch import EGNN, EGNNNetwork
    from egnn_tpu_torch.models import egnn as egnn_mod
    from egnn_tpu_torch.ops import pairwise_stream as PS
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.training import make_denoise_train_step, make_fused_adam
    from egnn_tpu_torch.training.data import synthetic_chain_batch

    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 30)

    def anchor3(seed=SEED, every=ATTN_EVERY, **layer):
        return EGNNNetwork(
            depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
            global_linear_attn_every=every, layer_kwargs={**LAYER_KWARGS, **layer},
            device="cuda", generator=torch.Generator().manual_seed(seed))

    def trainer(seed=SEED, every=ATTN_EVERY, **layer):
        net = anchor3(seed, every, **layer)
        return net, make_denoise_train_step(net, make_fused_adam(net.parameters(), LR))

    def serve(net, rq, **kw):
        return net(rq.tokens, rq.noised_coors, adj_mat=rq.adj_mat, mask=rq.mask, **kw)

    def to_cpu(rq):
        return type(rq)(*(t.cpu() for t in rq))

    def batch_args(rq):
        return rq.tokens, rq.noised_coors, rq.clean_coors, rq.adj_mat, rq.mask

    # ---- 30. anchor 3 with global attention: serving, training, bf16, timing ----
    net = anchor3().eval()
    requests = ([synthetic_chain_batch(rng, 1, N, device="cuda") for _ in range(4)]
                + [synthetic_chain_batch(rng, 8, N, device="cuda")])
    reset_launch_counts()
    with torch.inference_mode():
        outs = [serve(net, rq) for rq in requests]
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    print(f"anchor 3 with global attention (every {ATTN_EVERY}, 8 heads of 64, 4 tokens): "
          f"{len(requests)} forwards; launches {counts}")
    if counts["knn_select_gather"] != DEPTH * len(requests):
        raise AssertionError("K1 did not run depth times a forward with global attention")
    for (f, c), rq in zip(outs, requests):
        b = rq.tokens.shape[0]
        check_outputs(torch, (f, c), ((b, N, DIM), (b, N, 3)), "anchor 3 with attention")
    net_cpu = copy.deepcopy(net).to("cpu")
    for idx in (0, len(requests) - 1):
        rq = requests[idx]
        with torch.inference_mode():
            f_cpu, c_cpu = serve(net_cpu, to_cpu(rq))
        ef = (outs[idx][0].cpu() - f_cpu).abs().max().item()
        ec = (outs[idx][1].cpu() - c_cpu).abs().max().item()
        print(f"attention gpu vs cpu, b={rq.tokens.shape[0]}: feats max err {ef:.3e}, coors "
              f"max err {ec:.3e} (atol {GPU_VS_CPU_ATOL})")
        if not (ef <= GPU_VS_CPU_ATOL and ec <= GPU_VS_CPU_ATOL):
            raise AssertionError("card and CPU forwards disagree with global attention")
    rq = requests[0]
    check_equivariance(torch, lambda c: serve(net, rq._replace(noised_coors=c)),
                       rq.noised_coors, "anchor-3 with global attention b=1")

    fixed = {}
    for b in (1, 8):
        _, step = trainer()
        batches = [synthetic_chain_batch(rng, b, N, device="cuda") for _ in range(TRAIN_STEPS)]
        fixed[b] = batches[0]
        reset_launch_counts()
        losses = torch.stack([step(*batch_args(rq)) for rq in batches]).cpu()
        counts = dict(LAUNCH_COUNTS)
        _, step = trainer()
        falling = torch.stack([step(*batch_args(fixed[b])) for _ in range(FALL_STEPS)]).cpu()
        print(f"attention training b={b}: {TRAIN_STEPS} steps, losses {losses.tolist()}; "
              f"launches {counts}; on one batch {falling[0].item():.6f} -> "
              f"{falling[-1].item():.6f} over {FALL_STEPS} steps")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("non-finite training loss with global attention")
        for name in ("knn_select_gather", "segment_sum"):
            if counts[name] != DEPTH * TRAIN_STEPS:
                raise AssertionError(f"{name} launched {counts[name]} times in {TRAIN_STEPS} "
                                     f"attention steps, expected {DEPTH * TRAIN_STEPS}")
        if not falling[-1] < falling[0]:
            raise AssertionError("the loss did not fall on a fixed batch with global attention")
        for norm in (True, False):
            net_s, step = trainer(SEED + 3, norm_coors=norm)
            net_c = copy.deepcopy(net_s).to("cpu")
            step_c = make_denoise_train_step(net_c, make_fused_adam(net_c.parameters(), LR))
            loss = step(*batch_args(fixed[b])).item()
            loss_c = with_k2_sums(step_c, *batch_args(to_cpu(fixed[b]))).item()
            errs = sorted((rel_err(torch, p.grad, q.grad), name) for (name, p), q in zip(
                net_s.named_parameters(), net_c.parameters()) if q.grad is not None)
            tol = ATTN_NORM_COORS_GRAD_TOL if norm else TRAIN_GRAD_TOL
            print(f"attention one step b={b} norm_coors={norm}, card vs CPU: loss {loss:.8f} "
                  f"vs {loss_c:.8f} (rtol {TRAIN_LOSS_RTOL}); gradient error largest "
                  f"{errs[-1][0]:.3e} ({errs[-1][1]}), median {errs[len(errs) // 2][0]:.3e} "
                  f"over {len(errs)} parameters (tol {tol})")
            if abs(loss - loss_c) > TRAIN_LOSS_RTOL * abs(loss_c) or errs[-1][0] > tol:
                raise AssertionError("card and CPU steps disagree with global attention")

    net_bf = anchor3(compute_dtype=torch.bfloat16).eval()   # the same weights
    rq = requests[0]
    with torch.inference_mode():
        f_bf, c_bf = serve(net_bf, rq)
        f_bc, c_bc = serve(copy.deepcopy(net_bf).to("cpu"), to_cpu(rq))
    check_outputs(torch, (f_bf, c_bf), ((1, N, DIM), (1, N, 3)), "anchor 3 with attention, bf16")
    e32 = max((f_bf - outs[0][0]).abs().max().item(), (c_bf - outs[0][1]).abs().max().item())
    ecpu = max((f_bf.cpu() - f_bc).abs().max().item(), (c_bf.cpu() - c_bc).abs().max().item())
    print(f"attention bf16 b=1: against the card's f32 max err {e32:.3e}, against the CPU's "
          f"bf16 {ecpu:.3e} (atol {BF16_ATOL} each)")
    if e32 > BF16_ATOL or ecpu > BF16_ATOL:
        raise AssertionError("the bf16 network strays from f32 or from the CPU")

    plain = anchor3(every=0).eval()
    for model, what in ((plain, "anchor 3"), (net, "anchor 3 + attention"),
                        (net_bf, "anchor 3 + attention, bf16")):
        for rq in (requests[0], requests[-1])[:1 if model is net_bf else 2]:
            b = rq.tokens.shape[0]
            with torch.inference_mode():
                ms = call_ms(torch, lambda: serve(model, rq), iters=10, warmup=3)
                dev = device_ms(torch, lambda: serve(model, rq), reps=5)
            print(f"timing {what} forward b={b}: {ms:.4f} ms a call, {dev:.4f} ms replayed")
    for every, what in ((0, "anchor 3"), (ATTN_EVERY, "anchor 3 + attention")):
        for b in (1, 8):
            _, step = trainer(every=every)
            args = batch_args(fixed[b])
            ms = call_ms(torch, lambda: step(*args), iters=10, warmup=3)
            dev = device_ms(torch, lambda: step(*args), reps=5)
            print(f"timing {what} train step b={b}: {ms:.4f} ms a call, {dev:.4f} ms replayed")
    del net, net_cpu, net_bf, plain, outs
    print(f"phase 30: {time.perf_counter() - t_start:.1f} s")

    # ---- 31. dropout in training mode ----
    t31 = time.perf_counter()
    rq = requests[0]
    for fused in (False, True):
        net = anchor3(every=0, dropout=DROPOUT, fused_pairs=fused)   # training mode

        def run(seed):
            with torch.no_grad():
                return serve(net, rq, generator=torch.Generator(device="cuda").manual_seed(seed))

        reset_launch_counts()
        first, again, other = run(7), run(7), run(8)
        torch.cuda.synchronize()
        counts = dict(LAUNCH_COUNTS)
        same = all(same_bits(torch, x, y) for x, y in zip(first, again))
        differs = not torch.equal(first[0], other[0])
        net.eval()
        reset_launch_counts()
        with torch.inference_mode():
            serve(net, rq)
        torch.cuda.synchronize()
        eval_counts = dict(LAUNCH_COUNTS)
        print(f"dropout {DROPOUT} fused_pairs={fused}, training mode: one generator state twice "
              f"bitwise={same}, another state differs={differs}; launches in 3 forwards "
              f"{counts}; eval mode, one forward {eval_counts}")
        if not (same and differs):
            raise AssertionError("dropout masks are not fixed by the generator")
        if counts["fused_pair_fwd"] != 0 or counts["knn_select_gather"] != 3 * DEPTH:
            raise AssertionError("training mode with dropout must take the unfused layer (K1)")
        if eval_counts["fused_pair_fwd"] != (DEPTH if fused else 0):
            raise AssertionError("eval mode must take the fused layer where asked")
        nets = [anchor3(every=0, dropout=p, fused_pairs=fused) for p in (DROPOUT, 0.0)]
        losses = [make_denoise_train_step(m, make_fused_adam(m.parameters(), LR))(
            *batch_args(fixed[1])) for m in nets]
        bitwise = same_bits(torch, *losses) and all(
            (p.grad is None and q.grad is None) or same_bits(torch, p.grad, q.grad)
            for p, q in zip(nets[0].parameters(), nets[1].parameters()))
        print(f"dropout {DROPOUT} fused_pairs={fused}: a train step's loss and gradients "
              f"against dropout 0 bitwise={bitwise} (loss {losses[0].item():.8f}); the module "
              f"stays in training mode: {nets[0].training}")
        if not (bitwise and nets[0].training):
            raise AssertionError("the train step applied dropout or changed the module's mode")
    del net, nets
    print(f"phase 31: {time.perf_counter() - t31:.1f} s")

    # ---- 32. the streamed all-pairs layer ----
    t32 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    feats = torch.randn(1, N_STREAM, DIM_STREAM, generator=g, device="cuda")
    coors = torch.randn(1, N_STREAM, 3, generator=g, device="cuda")
    hidden = 2 * (2 * DIM_STREAM + 1)
    cj = PS._auto_chunk(1, N_STREAM, hidden)
    print(f"streamed layer: n={N_STREAM} dim={DIM_STREAM} hidden={hidden}, chunk {cj} "
          f"({N_STREAM // cj} chunks); the materialised (1, n, n, hidden) f32 tensor would be "
          f"{N_STREAM * N_STREAM * hidden * 4 / 1e9:.1f} GB")

    def stream_layer(norm_coors=True, **kw):
        return EGNN(dim=DIM_STREAM, stream_pairwise=True, norm_coors=norm_coors, device="cuda",
                    generator=torch.Generator().manual_seed(SEED), **kw)

    def fwd_bwd(layer, f, c, **kw):
        """(feats, coors, d loss / d coors, d loss / d weights...) of
        stream_ab's loss (f^2).mean() + (co^2).mean()."""
        c = c.detach().requires_grad_()
        fo, co = layer(f, c, **kw)
        grads = torch.autograd.grad((fo ** 2).mean() + (co ** 2).mean(),
                                    [c] + list(layer.parameters()))
        return [fo.detach(), co.detach()] + list(grads)

    ms_fb = {}
    for what, cd in (("f32", None), ("bf16", torch.bfloat16)):
        layer = stream_layer(compute_dtype=cd).eval()
        with torch.no_grad():
            fo, co = layer(feats, coors)
        check_outputs(torch, (fo, co), ((1, N_STREAM, DIM_STREAM), (1, N_STREAM, 3)),
                      f"streamed {what}")
        if cd is None:
            check_equivariance(torch, lambda c: layer(feats, c), coors, f"streamed n={N_STREAM}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fwd_bwd(layer, feats, coors)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check_outputs(torch, out[2:3], ((1, N_STREAM, 3),), f"streamed {what} coordinate grad")
        del out

        def forward():
            with torch.no_grad():
                return layer(feats, coors)

        # calls of seconds, warm after the checks above: two of each
        f_ms = call_ms(torch, forward, iters=2, warmup=0)
        fb_ms = call_ms(torch, lambda: fwd_bwd(layer, feats, coors), iters=2, warmup=0)
        ms_fb[what] = fb_ms
        f_kernel, f_launches, f_s = device_launches(torch, forward)
        fb_kernel, fb_launches, fb_s = device_launches(torch, lambda: fwd_bwd(layer, feats, coors))
        pairs = N_STREAM * N_STREAM
        print(f"streamed {what} n={N_STREAM}: forward {f_ms:.3f} ms a call "
              f"({pairs / (f_ms / 1e3):.4e} pairs/s; kernel time {f_kernel:.3f} ms, busy "
              f"{f_kernel / f_ms:.3f}, {f_launches} launches), fwd+bwd {fb_ms:.3f} ms "
              f"({pairs / (fb_ms / 1e3):.4e} pairs/s; kernel time {fb_kernel:.3f} ms, busy "
              f"{fb_kernel / fb_ms:.3f}, {fb_launches} launches); peak memory of the fwd+bwd "
              f"above its inputs {peak / 2**30:.3f} GiB; the profiles took {f_s:.1f} and "
              f"{fb_s:.1f} s")
        del layer
    print(f"streamed fwd+bwd f32 / bf16: {ms_fb['f32'] / ms_fb['bf16']:.3f}x")

    # against the CPU at n = 2048 (kbench's layer) and, without norm_coors,
    # at 1024; against the materialised layer at 1024
    f2, c2 = feats[:, :N_STREAM_CPU].contiguous(), coors[:, :N_STREAM_CPU].contiguous()
    for norm, n_cpu in ((True, N_STREAM_CPU), (False, N_STREAM_MAT)):
        layer = stream_layer(norm_coors=norm).eval()
        f_n, c_n = f2[:, :n_cpu], c2[:, :n_cpu]
        card = fwd_bwd(layer, f_n, c_n)
        t_cpu = time.perf_counter()
        host = fwd_bwd(copy.deepcopy(layer).to("cpu"), f_n.cpu(), c_n.cpu())
        ef = max((a.cpu() - b_).abs().max().item() for a, b_ in zip(card[:2], host[:2]))
        eg = rel_err(torch, card[2], host[2])
        ew = max(rel_err(torch, a, b_) for a, b_ in zip(card[3:], host[3:]))
        tol = STREAM_NORM_COORS_GRAD_TOL if norm else STREAM_GRAD_TOL
        print(f"streamed n={n_cpu} norm_coors={norm} card vs CPU: forward max err "
              f"{ef:.3e} (atol {GPU_VS_CPU_ATOL}), coordinate gradient {eg:.3e} relative (tol "
              f"{tol}), weights' gradients up to {ew:.3e} (tol {STREAM_GRAD_TOL}); the CPU's "
              f"fwd+bwd {time.perf_counter() - t_cpu:.1f} s")
        if ef > GPU_VS_CPU_ATOL or eg > tol or ew > STREAM_GRAD_TOL:
            raise AssertionError("the streamed layer on the card disagrees with the CPU")
    layer = stream_layer().eval()
    f1, c1 = feats[:, :N_STREAM_MAT], coors[:, :N_STREAM_MAT]
    materialised = copy.deepcopy(layer)
    materialised.stream_pairwise = False
    with torch.no_grad():
        em = max((a - b_).abs().max().item()
                 for a, b_ in zip(layer(f1, c1), materialised(f1, c1)))
    print(f"streamed vs materialised n={N_STREAM_MAT} on the card: forward max err {em:.3e} "
          f"(atol {GPU_VS_CPU_ATOL})")
    if em > GPU_VS_CPU_ATOL:
        raise AssertionError("the streamed and the materialised layer disagree")

    # dropout in training mode: masks fixed by the generator, through the
    # recompute, equal to the materialised path's under the same masks
    # (without norm_coors, whose self pairs leave the coordinate gradient
    # to f32 rounding: STREAM_NORM_COORS_GRAD_TOL)
    dropping = stream_layer(norm_coors=False, dropout=DROPOUT)

    def drop_run(model):
        return fwd_bwd(model, f2, c2, generator=torch.Generator(device="cuda").manual_seed(9))

    first, again = drop_run(dropping), drop_run(dropping)
    same = all(same_bits(torch, a, b_) for a, b_ in zip(first, again))
    real = PS.dropout
    keeps = []

    def recording(x, rate, generator):
        """``ops/core.py:dropout`` with its mask kept (the run's bits are
        held to the first run's below)."""
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) < 1.0 - rate
        keeps.append(keep)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))

    num_chunks = -(-N_STREAM_CPU // PS._auto_chunk(1, N_STREAM_CPU, hidden))
    PS.dropout = egnn_mod.dropout = recording
    try:
        recorded = drop_run(dropping)
    finally:
        PS.dropout = egnn_mod.dropout = real
    keeps = keeps[:2 * num_chunks + 1]   # the forward's draws; then the recompute's
    masks = [torch.cat(keeps[0:-1:2], dim=2)[:, :, :N_STREAM_CPU],
             torch.cat(keeps[1:-1:2], dim=2)[:, :, :N_STREAM_CPU], keeps[-1]]
    del keeps

    def replay(x, rate, generator):
        keep = masks.pop(0)
        if keep.shape != x.shape:
            raise AssertionError(f"replayed mask {tuple(keep.shape)} for {tuple(x.shape)}")
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))

    materialised = copy.deepcopy(dropping)
    materialised.stream_pairwise = False
    egnn_mod.dropout = replay
    try:
        mat = drop_run(materialised)
    finally:
        egnn_mod.dropout = real
    errs = [rel_err(torch, a, b_) for a, b_ in zip(recorded, mat)]
    same_recorded = all(same_bits(torch, a, b_) for a, b_ in zip(first, recorded))
    print(f"streamed dropout {DROPOUT} n={N_STREAM_CPU}: one generator state twice bitwise="
          f"{same} (outputs and every gradient), the recording run too={same_recorded}; "
          f"against the materialised layer under the same masks: outputs "
          f"{max(errs[:2]):.3e}, coordinate gradient {errs[2]:.3e}, weights' gradients up to "
          f"{max(errs[3:]):.3e} relative (tol {STREAM_GRAD_TOL})")
    if not (same and same_recorded) or masks or max(errs) > STREAM_GRAD_TOL:
        raise AssertionError("the streamed dropout path disagrees with itself or with the "
                             "materialised path under its masks")
    del first, again, recorded, mat, materialised, dropping, layer
    torch.cuda.empty_cache()
    print(f"phase 32: {time.perf_counter() - t32:.1f} s")

    # ---- 33. anchors 1 and 2: one dim-512 layer over all pairs, n = 16 ----
    t33 = time.perf_counter()
    for edge_dim in (0, 4):
        gc = torch.Generator().manual_seed(SEED + 33 + edge_dim)
        feats = torch.randn(1, N_ANCHOR12, DIM_ANCHOR12, generator=gc)
        coors = torch.randn(1, N_ANCHOR12, 3, generator=gc)
        edges = torch.randn(1, N_ANCHOR12, N_ANCHOR12, edge_dim, generator=gc) \
            if edge_dim else None
        layer = EGNN(dim=DIM_ANCHOR12, edge_dim=edge_dim, device="cuda",
                     generator=torch.Generator().manual_seed(SEED))

        def fb(model, f, c, e):
            f = f.detach().requires_grad_()
            fo, co = model(f, c, e)
            grads = torch.autograd.grad((fo ** 2).mean() + (co ** 2).mean(),
                                        [f] + list(model.parameters()))
            return [fo.detach(), co.detach()] + list(grads)

        cuda = (feats.cuda(), coors.cuda(), None if edges is None else edges.cuda())
        card = fb(layer, *cuda)
        host = fb(copy.deepcopy(layer).to("cpu"), feats, coors, edges)
        ef = max((a.cpu() - b_).abs().max().item() for a, b_ in zip(card[:2], host[:2]))
        eg = max(rel_err(torch, a, b_) for a, b_ in zip(card[2:], host[2:]))
        ms = call_ms(torch, lambda: fb(layer, *cuda))
        dev = device_ms(torch, lambda: fb(layer, *cuda))
        pairs = N_ANCHOR12 * N_ANCHOR12
        print(f"anchor {2 if edge_dim else 1} (dim {DIM_ANCHOR12}, n={N_ANCHOR12}, edge_dim "
              f"{edge_dim}): card vs CPU forward max err {ef:.3e} (atol {GPU_VS_CPU_ATOL}), "
              f"gradients up to {eg:.3e} relative (tol {TRAIN_GRAD_TOL}); fwd+bwd {ms:.4f} ms a "
              f"call ({pairs / (ms / 1e3):.4e} pairs/s), {dev:.4f} ms replayed")
        if ef > GPU_VS_CPU_ATOL or eg > TRAIN_GRAD_TOL:
            raise AssertionError(f"anchor {2 if edge_dim else 1}: card and CPU disagree")
    print(f"phase 33: {time.perf_counter() - t33:.1f} s")
    print(f"phases 30-33 (the dense family's options): {time.perf_counter() - t_start:.1f} s")


# phases 34-36: the host runtime and the trainers
HOST_STEPS = 20          # phase 34's molecule trainer steps, loader-fed and direct
LOADER_DEPTH = 2
DENOISE_STEPS, DENOISE_KILL_AT, DENOISE_CKPT_EVERY = 64, 24, 8
DENOISE_PROTEINS, DENOISE_RESIDUES = 64, 128     # n = 3 * 128 = 384 atoms
KHOP_DEGREES_NET65K, KHOP_DEGREES_ANCHOR3 = 2, 3
# the killed run: tests/test_torch_fault_recovery.py, the runner the CPU
# fault test starts too, SIGKILLs the trainer right after the checkpoint of
# micro-step DENOISE_KILL_AT has landed
FAULT_RUNNER = Path("tests") / "test_torch_fault_recovery.py"


def host_runtime_phases(torch, smi):
    """Phases 34-36: the native host graph builder and the molecule trainer
    fed through ``PrefetchLoader``, k-hop lists on the card, and the denoise
    trainer killed and resumed from its checkpoint. Raises on a failure;
    returns the trainers' steps timed as calls (phase 46 prints them)."""
    import shutil

    import numpy as np

    from egnn_tpu_torch import native
    from egnn_tpu_torch.examples import molecule_regression as mr
    from egnn_tpu_torch.ops import graph as GR
    from egnn_tpu_torch.ops import khop_neighbor_lists
    from egnn_tpu_torch.ops import neighbors as nb
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.training import PrefetchLoader, make_adam, synthetic_chain_batch, to_tensors
    from egnn_tpu_torch.utils.profiling import time_fn

    # ---- 34. the native host graph builder and the molecule trainer ----
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    available = native.is_available()
    print(f"native graph builder: is_available {available}, {native.num_threads()} threads, "
          f"g++ build and load {time.perf_counter() - t0:.3f} s")
    if not available:
        raise AssertionError(f"the native graph builder did not build:\n{native.build_error()}")
    mb, lattice = molecule_batch(torch, GR.knn_graph, SP_G_LARGE, SEED + 340, lattice=True)
    node_mask = mb.node_mask
    t0 = time.perf_counter()
    s_n, r_n, m_n = native.batched_knn_graph_np(
        lattice.reshape(SP_G_LARGE, SP_NA, 3).cpu().numpy(), SP_K,
        node_mask=node_mask.reshape(SP_G_LARGE, SP_NA).cpu().numpy())
    native_ms = (time.perf_counter() - t0) * 1e3
    reset_launch_counts()
    es = GR.knn_graph(lattice, SP_K, node_mask=node_mask, graph_size=SP_NA)
    torch.cuda.synchronize()
    k3 = LAUNCH_COUNTS["knn_select"]
    mask_ok = np.array_equal(m_n, es.mask.cpu().numpy())
    # padding rows: the native builder points them at the graph's first
    # node, knn_graph at node 0; both are masked out
    ids_ok = (np.array_equal(np.where(m_n, s_n, 0), es.senders.cpu().numpy())
              and np.array_equal(np.where(m_n, r_n, 0), es.receivers.cpu().numpy()))
    print(f"native batched kNN against knn_graph on the card (K3 {k3} launch) at G={SP_G_LARGE} "
          f"molecules of {SP_NA} slots, k={SP_K}, lattice coordinates (ties), "
          f"{int(m_n.sum())} valid of {m_n.size} edges: mask bitwise={mask_ok}, senders and "
          f"receivers bitwise={ids_ok}; the host build {native_ms:.3f} ms")
    if not (mask_ok and ids_ok and k3 == 1):
        raise AssertionError("the native graph differs from knn_graph's on the card, or K3 did "
                             "not run once")

    args = mr.parse_args(["--device", "cuda"])
    G, NA, K = args.graphs, args.na, args.knn

    def fresh():
        model = mr.Regressor(args.layers, args.dim, len(mr.CHARGES), G, NA, K, device="cuda",
                             generator=torch.Generator().manual_seed(mr.SEED))
        return model, mr.make_train_step(model, make_adam(model.parameters(), args.lr))

    t0 = time.perf_counter()
    host = [mr.host_batch(i, G, NA, K) for i in range(HOST_STEPS)]
    build_ms = (time.perf_counter() - t0) * 1e3 / HOST_STEPS
    direct = [to_tensors(b, "cuda") for b in host]
    model_d, step_d = fresh()
    model_cpu = copy.deepcopy(model_d).to("cpu")
    reset_launch_counts()
    losses_d = torch.stack([step_d(b)[0] for b in direct])
    torch.cuda.synchronize()
    counts = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
    with torch.no_grad():
        b0 = to_tensors(host[0], "cpu")
        pred = model_cpu(b0.x, b0.edge_index, b0.edge_mask, b0.batch_ids, b0.node_mask)
        loss_cpu = ((pred - b0.target) ** 2).mean().item()

    model_l, step_l = fresh()
    upcoming = iter(range(HOST_STEPS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loader = PrefetchLoader(lambda: mr.host_batch(next(upcoming), G, NA, K),
                            depth=LOADER_DEPTH, num_batches=HOST_STEPS, device="cuda")
    try:
        losses_l = torch.stack([step_l(b)[0] for b in loader])
        torch.cuda.synchronize()
    finally:
        loader.close()
    loader_ms = (time.perf_counter() - t0) * 1e3 / HOST_STEPS
    model_t, step_t = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in direct:
        step_t(b)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) * 1e3 / HOST_STEPS
    step_ms = time_fn(lambda: step_t(direct[0]), reps=20, warmup=3, stat="median") * 1e3
    kernel_ms, step_launches = profile_forward(torch, lambda: step_t(direct[0]), iters=10,
                                               label="molecule trainer steps", unit="step")
    same = same_bits(torch, losses_d, losses_l) and all(
        same_bits(torch, a, b) for a, b in zip(model_d.parameters(), model_l.parameters()))
    first, last = losses_d[:5].mean().item(), losses_d[-5:].mean().item()
    card_first = losses_d[0].item()
    cpu_ok = abs(card_first - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)
    edges = G * NA * K * args.layers
    print(f"molecule trainer, host-loader mode (G={G} molecules of {NA} slots, k={K}, "
          f"{args.layers} layers, dim {args.dim}, lr {args.lr}), {HOST_STEPS} steps: launches "
          f"{counts}; losses through PrefetchLoader(depth={LOADER_DEPTH}) and fed directly "
          f"bitwise={same} (parameters too); mean loss of the first five steps {first:.6f}, of "
          f"the last five {last:.6f}; first loss card {card_first:.8f} against CPU "
          f"{loss_cpu:.8f} (rtol {TRAIN_LOSS_RTOL})")
    print(f"timing of the molecule trainer on {smi}: host build {build_ms:.3f} ms a batch "
          f"(native kNN and numpy, one thread of the caller); step {step_ms:.4f} ms as a call "
          f"({edges / (step_ms / 1e3):.4e} edges/s), kernel time {kernel_ms:.4f} ms, busy "
          f"{kernel_ms / step_ms:.3f}, {step_launches:.1f} launches a step; a step with the "
          f"loader {loader_ms:.4f} ms, with the batches already on the card {direct_ms:.4f} ms: "
          f"the loader {'hides' if loader_ms <= 1.1 * direct_ms else 'does not hide'} the build "
          f"({loader_ms / direct_ms:.3f}x)")
    if not (same and last < first and cpu_ok and counts.get("segment_sum", 0) > 0):
        raise AssertionError("molecule trainer: the loader-fed losses differ from the direct "
                             "ones, the loss did not fall, the card's first loss is off the "
                             "CPU's, or K2 did not run")
    del model_d, model_l, model_t, model_cpu, direct, host
    torch.cuda.empty_cache()
    print(f"phase 34: {time.perf_counter() - t_phase:.1f} s")

    # ---- 35. k-hop lists on the card ----
    t_phase = time.perf_counter()
    coors = cloud(torch, N_A, 3, "uniform", SEED + 350)
    reset_launch_counts()
    with torch.no_grad():
        nbr = nb.knn_select(coors, KNN_A, math.inf).indices[0]
    torch.cuda.synchronize()
    grid_launches = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
    rq = synthetic_chain_batch(np.random.default_rng(SEED + 351), 1, N, device="cuda")
    with torch.no_grad():
        nbr3 = nb.knn_select(rq.noised_coors, KNN, math.inf, mask=rq.mask,
                             adj_mat=rq.adj_mat.expand(1, N, N)).indices[0]
    mask3 = rq.mask[0][:, None] & rq.mask[0][nbr3]
    for what, lists, lmask, degrees in (
            (f"net65k's uniform cloud (n={N_A}, k={KNN_A}, grid route {grid_launches})", nbr,
             None, KHOP_DEGREES_NET65K),
            (f"anchor 3's lists (n={N}, k={KNN}, mask and chain adjacency)", nbr3, mask3,
             KHOP_DEGREES_ANCHOR3)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = khop_neighbor_lists(lists, lmask, degrees)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        ref = khop_neighbor_lists(lists.cpu(), None if lmask is None else lmask.cpu(), degrees)
        ok = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        ms = time_fn(lambda: khop_neighbor_lists(lists, lmask, degrees), reps=5, warmup=1,
                     stat="median") * 1e3
        print(f"khop_neighbor_lists on {what}, D={degrees}: cap_out {got[0].shape[1]}, "
              f"{int(got[2].sum())} ids; card against CPU bitwise={ok}; {ms:.4f} ms a call on "
              f"{smi}, peak memory {peak:.1f} MiB above the inputs")
        if not ok:
            raise AssertionError(f"khop_neighbor_lists: the card differs from the CPU on {what}")
    if grid_launches.get("grid_knn_cells", 0) != 1:
        raise AssertionError(f"net65k's lists did not come from one K7 launch: {grid_launches}")
    del coors, nbr, nbr3, got, ref
    torch.cuda.empty_cache()
    print(f"phase 35: {time.perf_counter() - t_phase:.1f} s")

    # ---- 36. the denoise trainer, killed and resumed on the card ----
    t_phase = time.perf_counter()
    from egnn_tpu_torch.training.datasets import make_synthetic_backbone_dataset

    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_denoise"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = make_synthetic_backbone_dataset(str(work / "backbone.npz"),
                                           num_proteins=DENOISE_PROTEINS,
                                           seq_len=DENOISE_RESIDUES, seed=SEED)
    # the example's configuration, spelled out: the runner's own defaults
    # are the CPU test's small size
    common = ["--device", "cuda", "--steps", str(DENOISE_STEPS), "--data", data,
              "--depth", "5", "--dim", "32", "--knn", "16", "--grad-accum", "16",
              "--lr", "1e-3", "--ckpt-every", str(DENOISE_CKPT_EVERY)]
    from egnn_tpu_torch.examples import denoise

    def show(what, seconds, out):
        print(f"denoise trainer {what} ({seconds:.1f} s): " + " | ".join(
            line for line in out.splitlines() if not line.startswith("SUMMARY"))[-1500:])

    def trainer(ckpt, *extra):
        """The trainer in this process; its summary and its printed lines."""
        t0, out = time.perf_counter(), io.StringIO()
        with contextlib.redirect_stdout(out):
            summary = denoise.main(common + ["--ckpt-dir", str(work / ckpt), *extra])
        show(ckpt, time.perf_counter() - t0, out.getvalue())
        return out.getvalue(), summary

    whole, s_whole = trainer("whole")
    t0 = time.perf_counter()
    killed = subprocess.run([sys.executable, str(root / FAULT_RUNNER),
                             "--kill-at", str(DENOISE_KILL_AT), *common,
                             "--ckpt-dir", str(work / "resumed")],
                            cwd=root, capture_output=True, text=True, timeout=600)
    show(f"killed (exit {killed.returncode})", time.perf_counter() - t0, killed.stdout)
    if killed.returncode != -signal.SIGKILL:
        raise AssertionError(f"the killed denoise trainer exited {killed.returncode}:\n"
                             f"{killed.stdout[-3000:]}\n{killed.stderr[-3000:]}")
    resumed, s_res = trainer("resumed", "--resume")
    if (f"KILLING at step {DENOISE_KILL_AT}" not in killed.stdout
            or f"RESUMED from step {DENOISE_KILL_AT}" not in resumed):
        raise AssertionError("the killed run did not stop at its checkpoint, or the resumed run "
                             "did not start there")
    final = f"ckpt_{DENOISE_STEPS:09d}.pt"
    a = torch.load(work / "whole" / final, weights_only=True)
    b = torch.load(work / "resumed" / final, weights_only=True)
    diffs, worst = [], 0.0
    pairs = ([(f"model.{k}", a["model"][k], b["model"][k]) for k in a["model"]]
             + [(f"optimizer.{k}.{n}", t, b["optimizer"]["state"][k][n])
                for k, st in a["optimizer"]["state"].items() for n, t in st.items()])
    for name, x, y in pairs:
        if not same_bits(torch, x, y):
            diffs.append(name)
            if x.is_floating_point():
                worst = max(worst, rel_err(torch, y, x))
    mini = (a["optimizer"]["mini_step"], b["optimizer"]["mini_step"])
    n_atoms = 3 * DENOISE_RESIDUES
    print(f"denoise trainer (depth 5, dim 32, kNN 16, n={n_atoms}, b=1, grad_accum 16, "
          f"{DENOISE_STEPS} micro-steps, checkpoints every {DENOISE_CKPT_EVERY}, killed after "
          f"{DENOISE_KILL_AT}): {len(pairs)} tensors of the resumed run's final state against "
          f"the uninterrupted run's, {len(pairs) - len(diffs)} bitwise equal"
          + (f", differing: {diffs[:8]} (largest relative difference {worst:.3e})" if diffs
             else "") + f"; mini_step {mini}; held-out MSE {s_whole['eval_mse_start']:.6f} at "
          f"step 0, {s_whole['eval_mse']:.6f} at step {DENOISE_STEPS} (noised baseline "
          f"{s_whole['baseline_mse']:.6f})")
    print(f"timing of the denoise trainer on {smi}: uninterrupted {s_whole['steps_per_s']:.3f} "
          f"micro-steps/s, {s_whole['edges_per_s']:.4e} edges/s (b*n*k*depth = "
          f"{n_atoms * 16 * 5} a step over the step's latency as calls, the loader and the "
          f"finite-step guard included); resumed {s_res['steps_per_s']:.3f} micro-steps/s")
    # where a micro-step's time goes, in this process, on one batch already
    # on the card: the guarded step, the step without the guard, kernels
    from egnn_tpu_torch.training.datasets import BackboneDataset

    dargs = denoise.parse_args(common)
    dargs.nodes = n_atoms
    net, _, guarded = denoise.build(dargs, torch.device("cuda"))
    db = to_tensors(BackboneDataset.load(data).denoise_batch(
        np.random.RandomState([denoise.SEED, 0]), 1), "cuda")
    step_args = (db.tokens, db.noised_coors, db.clean_coors, db.adj_mat, db.mask)
    guarded_ms = time_fn(lambda: guarded(*step_args), reps=32, warmup=3, stat="median") * 1e3
    inner_ms = time_fn(lambda: guarded.__wrapped__(*step_args), reps=32, warmup=3,
                       stat="median") * 1e3
    kernel_ms, launches = profile_forward(torch, lambda: guarded(*step_args), iters=16,
                                          label="denoise micro-steps", unit="micro-step")
    print(f"a denoise micro-step on {smi}, one batch on the card: {guarded_ms:.4f} ms as a call "
          f"with the finite-step guard, {inner_ms:.4f} ms without it; kernel time "
          f"{kernel_ms:.4f} ms, busy {kernel_ms / guarded_ms:.3f}, {launches:.1f} launches; the "
          f"trainer's loop took {1e3 / s_whole['steps_per_s']:.4f} ms a micro-step")
    del net, guarded
    if diffs or mini[0] != mini[1]:
        raise AssertionError("the resumed run's final state is not bitwise the uninterrupted "
                             "run's")
    if not s_whole["eval_mse"] < s_whole["eval_mse_start"]:
        raise AssertionError("denoise trainer: the held-out loss did not fall")
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 36: {time.perf_counter() - t_phase:.1f} s")
    return {"denoise_call_ms": guarded_ms, "denoise_kernel_ms": kernel_ms,
            "denoise_launches": launches, "molecule_call_ms": step_ms}


# phase 46: the trainers' blocks. The denoise trainer at phase 36's
# configuration (its file, 64 micro-steps, checkpoints every 8) in blocks of
# 8 against blocks of 1, and on synthetic chains in blocks of 10 against 1;
# the molecule trainer's default path at its example's width, 40 steps in
# blocks of 10 against 1. Block 0 (eager calls) runs beside them for the
# times
BLOCK_DATA, BLOCK_SYNTH, BLOCK_MOLECULE, MOLECULE_STEPS = 8, 10, 10, 40
BLOCK_PROFILE_ITERS = 4


def final_state_diffs(torch, a, b):
    """The names of the tensors (and ``mini_step``) of two trainer
    checkpoints that are not bitwise equal."""
    pairs = ([(f"model.{k}", a["model"][k], b["model"][k]) for k in a["model"]]
             + [(f"optimizer.{k}.{n}", t, b["optimizer"]["state"][k][n])
                for k, st in a["optimizer"]["state"].items() for n, t in st.items()])
    diffs = [name for name, x, y in pairs if not same_bits(torch, x, y)]
    if a["optimizer"]["mini_step"] != b["optimizer"]["mini_step"]:
        diffs.append("mini_step")
    return len(pairs), diffs


def trainer_block_phase(torch, smi, eager):
    """Phase 46: the trainers' ``--block`` as CUDA-graph replays of the
    captured step (``training.capture_step``): each trainer in blocks
    against blocks of one, bitwise, beside eager calls (``--block 0``) and
    phase 36's step as a call (``eager``, host_runtime_phases' numbers);
    one block's kernels profiled. Raises on a failure."""
    import shutil

    import numpy as np

    from egnn_tpu_torch.examples import denoise
    from egnn_tpu_torch.examples import molecule_regression as mr
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.training import capture_step, to_tensors
    from egnn_tpu_torch.training.datasets import BackboneDataset, make_synthetic_backbone_dataset

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_blocks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = make_synthetic_backbone_dataset(str(work / "backbone.npz"),
                                           num_proteins=DENOISE_PROTEINS,
                                           seq_len=DENOISE_RESIDUES, seed=SEED)
    n_atoms, depth = 3 * DENOISE_RESIDUES, 5
    example = ["--device", "cuda", "--steps", str(DENOISE_STEPS), "--depth", str(depth),
               "--dim", "32", "--knn", "16", "--grad-accum", "16", "--lr", "1e-3"]
    edges = n_atoms * 16 * depth

    def steady(s):
        """Micro-steps a second after the first block (its capture)."""
        left = len(s["losses"]) - s["first_block_steps"]
        return left / (s["seconds"] - s["first_block_seconds"]) if left else float("nan")

    def denoise_runs(what, extra, blocks):
        runs = {}
        for block in blocks:
            ckpt = work / f"{what}_{block}"
            reset_launch_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                s = denoise.main(example + extra + ["--block", str(block), "--ckpt-dir",
                                                    str(ckpt)])
            torch.cuda.synchronize()
            s["launches"] = {k: v for k, v in LAUNCH_COUNTS.items() if v}
            s["final"] = torch.load(ckpt / f"ckpt_{DENOISE_STEPS:09d}.pt", weights_only=True)
            runs[block] = s
            print(f"phase 46 denoise trainer, {what}, --block {block}: "
                  f"{s['steps_per_s']:.3f} micro-steps/s over the run "
                  f"({s['edges_per_s']:.4e} edges/s), {steady(s):.3f} after the first block "
                  f"({s['first_block_steps']} micro-steps in {s['first_block_seconds']:.3f} s"
                  f"{', the capture included' if block else ''}), {steady(s) * edges:.4e} "
                  f"edges/s; launches counted {s['launches']}")
        return runs

    # ---- 46a. the denoise trainer in blocks ----
    file_args = ["--data", data, "--ckpt-every", str(DENOISE_CKPT_EVERY)]
    by_file = denoise_runs("phase 36's file", file_args, (BLOCK_DATA, 1, 0))
    synth = denoise_runs("synthetic chains", [], (BLOCK_SYNTH, 1, 0))
    failures = []
    for what, runs, block in (("phase 36's file", by_file, BLOCK_DATA),
                              ("synthetic chains", synth, BLOCK_SYNTH)):
        count, diffs = final_state_diffs(torch, runs[block]["final"], runs[1]["final"])
        _, eager_diffs = final_state_diffs(torch, runs[block]["final"], runs[0]["final"])
        same_losses = runs[block]["losses"] == runs[1]["losses"]
        # each block run launched the step twice (the warm-up and the
        # capture) and replayed it for every micro-step; two held-out
        # forwards launch K1 depth times each
        k2 = {b: runs[b]["launches"].get("segment_sum", 0) for b in (block, 1, 0)}
        replayed = k2[block] == k2[1] == 2 * depth and k2[0] == DENOISE_STEPS * depth
        finite = all(math.isfinite(v) for v in runs[block]["losses"])
        print(f"phase 46a denoise trainer on {what} (depth {depth}, dim 32, kNN 16, n = "
              f"{n_atoms}, grad_accum 16, {DENOISE_STEPS} micro-steps): --block {block} against "
              f"--block 1, losses bitwise={same_losses}, final state {count - len(diffs)} of "
              f"{count} tensors bitwise (differing: {diffs[:8]}), mini_step "
              f"{runs[block]['final']['optimizer']['mini_step']}; against eager calls (--block "
              f"0): losses bitwise={runs[block]['losses'] == runs[0]['losses']}, final state "
              f"{count - len(eager_diffs)} of {count} bitwise (not gated); K2 launches counted "
              f"{k2} (a block run: the warm-up and the capture, {2 * depth}; eager: "
              f"{DENOISE_STEPS * depth}); the losses finite={finite}")
        if not (same_losses and not diffs and replayed and finite):
            failures.append(f"denoise on {what}")

    # one block of the captured guarded step on phase 36's first batches,
    # already on the card: its wall time, kernel time and launches
    dargs = denoise.parse_args(example)
    dargs.nodes = n_atoms
    net, _, guarded = denoise.build(dargs, torch.device("cuda"))
    dataset = BackboneDataset.load(data)
    batches = [to_tensors(dataset.denoise_batch(np.random.RandomState([denoise.SEED, i]), 1),
                          "cuda") for i in range(BLOCK_DATA)]
    captured = capture_step(guarded, guarded.state)

    def one_block():
        losses = [captured(b.tokens, b.noised_coors, b.clean_coors, b.adj_mat, b.mask)
                  for b in batches]
        return torch.stack(losses).tolist()

    one_block()
    block_ms = call_ms(torch, one_block, iters=10, warmup=2)
    kernel_ms, launches = profile_forward(torch, one_block, iters=BLOCK_PROFILE_ITERS,
                                          label=f"denoise blocks of {BLOCK_DATA} replays",
                                          unit="block")
    print(f"timing on {smi}: a block of {BLOCK_DATA} denoise micro-steps replayed (the batches "
          f"on the card, copied into the graph's inputs; the losses read once) "
          f"{block_ms:.4f} ms, {block_ms / BLOCK_DATA:.4f} ms a micro-step "
          f"({BLOCK_DATA / block_ms * 1e3:.3f} micro-steps/s, "
          f"{BLOCK_DATA * edges / block_ms * 1e3:.4e} edges/s); kernel time {kernel_ms:.4f} ms, "
          f"busy {kernel_ms / block_ms:.3f}, {launches:.1f} launches a block "
          f"({launches / BLOCK_DATA:.1f} a micro-step); phase 36's micro-step as a call "
          f"{eager['denoise_call_ms']:.4f} ms, kernel time {eager['denoise_kernel_ms']:.4f} ms, "
          f"{eager['denoise_launches']:.1f} launches")
    del net, guarded, captured, batches

    # ---- 46b. the molecule trainer's default path in blocks ----
    mol = {}
    for block in (BLOCK_MOLECULE, 1, 0):
        reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            s = mr.main(["--device", "cuda", "--steps", str(MOLECULE_STEPS), "--block",
                         str(block)])
        torch.cuda.synchronize()
        s["launches"] = {k: v for k, v in LAUNCH_COUNTS.items() if v}
        mol[block] = s
        print(f"phase 46b molecule trainer --block {block}: {MOLECULE_STEPS / s['seconds']:.3f} "
              f"steps/s over the run ({s['edges_per_s']:.4e} edges/s, the graph build "
              f"included), {steady(s):.3f} after the first block ({s['first_block_steps']} "
              f"steps in {s['first_block_seconds']:.3f} s); launches counted {s['launches']}")
    args = mr.parse_args([])
    same = (mol[BLOCK_MOLECULE]["losses"] == mol[1]["losses"]
            and mol[BLOCK_MOLECULE]["maes"] == mol[1]["maes"])
    k3 = {b: mol[b]["launches"].get("knn_select", 0) for b in mol}
    replayed = k3[BLOCK_MOLECULE] == k3[1] == 2 and k3[0] == MOLECULE_STEPS
    falling = (np.mean(mol[BLOCK_MOLECULE]["losses"][-10:])
               < np.mean(mol[BLOCK_MOLECULE]["losses"][:10]))
    print(f"phase 46b molecule trainer (G = {args.graphs} molecules of {args.na} slots, k = "
          f"{args.knn}, {args.layers} layers, dim {args.dim}, {MOLECULE_STEPS} steps): --block "
          f"{BLOCK_MOLECULE} against --block 1, losses and MAEs bitwise={same}; against eager "
          f"calls: {mol[BLOCK_MOLECULE]['losses'] == mol[0]['losses']} (not gated); K3 launches "
          f"counted {k3} (a block run: the warm-up and the capture; eager: one a step); the "
          f"loss falling={falling}; on {smi}: {steady(mol[BLOCK_MOLECULE]) :.3f} steps/s in "
          f"blocks after the first, {steady(mol[0]):.3f} as eager calls; phase 34's step as a "
          f"call {eager['molecule_call_ms']:.4f} ms")
    if not (same and replayed and falling):
        failures.append("molecule")
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 46: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase 46: blocks differ from blocks of one, or did not replay: "
                             f"{failures}")


# phases 37-39: multi-process training and the last two examples
# the sparse arms under shard_axis, at anchor 5's width: arm (b)'s layout less
# uniform_graph_size (ignored under a group, as in the JAX package), arm (c)
# (K10 on each rank's own nodes) and arm (d), the general layout with global
# attention; the unsharded references are built the same way
PAR_ARMS = {
    "b": dict(uniform_degree=SP_K),
    "c": dict(uniform_degree=SP_K, fused_uniform=True),
    "d": dict(global_linear_attn_every=2),
}
PAR_STEPS, DP_BATCH = 3, 8
# two ranks against one process on the card (phase 38): the loss at this rtol;
# each gradient by its largest error over its largest value, 1e-5, or 5e-3
# where norm_coors's self pairs' +-scale/eps terms cancel only to f32 rounding
# in another order (the dense kNN rows hold their own node; the sparse kNN
# edges hold none): the gates of phase 9 and of fused against unfused
PAR_LOSS_RTOL, PAR_GRAD_TOL, PAR_GRAD_TOL_SELF_PAIRS = 1e-4, 1e-5, 5e-3
# anchor 5 at model = 2 against the replicated network (phase 41): the
# row-parallel products sum in another order in every layer, and what the
# node update rounds reaches the next layers; the one-element gradient of
# each layer's coors_norm_scale, a sum over every edge of terms of both
# signs, moves by up to 1.5e-5 of itself (arm (c), H100, PERF.md)
TP_SPARSE_GRAD_TOL = 1e-4
# one rank against one process (phase 37): the sparse gradients, where the
# collectives' backward nodes change the order in which autograd adds the
# gradients that meet at a tensor. Parameters after PAR_STEPS Adam steps are
# printed, not gated: Adam's first steps move a weight by about lr * sign(g),
# and a gradient entry below the rounding of its tensor may take either sign
PAR_ONE_RANK_TOL = 1e-5
TWO_RANK_TIMEOUT = 420     # seconds for both ranks of phase 38 to report


def dense_dim64_phase(torch, smi):
    """Phase 47: anchor 3's network at dim 64 with ``fourier_features=4``
    (h = 274, the widths at which K10b takes its one-block tile), trained
    with ``fused_pairs`` beside the unfused network at b = 1 and b = 8: one
    step each from the same weights on the same batch (loss rtol
    TRAIN_LOSS_RTOL, gradients FUSED_VS_UNFUSED_GRAD_TOL), K10f and K10b
    depth times a fused step; then both steps timed as CUDA-graph replays
    (unfused, fused, fused, unfused), each step's kernel time and K10b's
    share of it (torch.profiler). Raises on a failure."""
    import numpy as np

    from egnn_tpu_torch import EGNNNetwork
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.training import make_denoise_train_step, make_fused_adam
    from egnn_tpu_torch.training.data import synthetic_chain_batch

    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 47)

    def trainer(**extra):   # one seed: the same weights fused and unfused
        net = EGNNNetwork(depth=DEPTH, dim=DIM64, num_tokens=NUM_TOKENS, num_positions=N,
                          layer_kwargs={**LAYER_KWARGS, "fourier_features": 4, **extra},
                          device="cuda", generator=torch.Generator().manual_seed(SEED + 47))
        return net, make_denoise_train_step(net, make_fused_adam(net.parameters(), LR))

    for b in (1, 8):
        rq = synthetic_chain_batch(rng, b, N, device="cuda")
        args = (rq.tokens, rq.noised_coors, rq.clean_coors, rq.adj_mat, rq.mask)
        (net_f, step_f), (net_u, step_u) = trainer(fused_pairs=True), trainer()
        if net_f.egnn_0.hidden != 274:
            raise AssertionError(f"phase 47: h = {net_f.egnn_0.hidden}, not 274")
        reset_launch_counts()
        loss_f = step_f(*args).item()
        counts = dict(LAUNCH_COUNTS)
        loss_u = step_u(*args).item()
        if counts["fused_pair_fwd"] != DEPTH or counts["fused_pair_bwd"] != DEPTH:
            raise AssertionError(f"phase 47 b={b}: K10f/K10b did not run depth times a step: "
                                 f"{counts}")
        errs = []
        for (name, p), u in zip(net_f.named_parameters(), net_u.parameters()):
            if (p.grad is None) != (u.grad is None):
                raise AssertionError(f"phase 47: {name} has a gradient on one path only")
            if p.grad is not None:
                errs.append((rel_err(torch, p.grad, u.grad), name))
        worst = max(errs)
        print(f"phase 47 dim {DIM64}, fourier 4 (h = 274), b={b}: one step fused loss "
              f"{loss_f:.8f}, unfused {loss_u:.8f} (rtol {TRAIN_LOSS_RTOL}); gradients "
              f"||g - g_unfused|| / ||g_unfused|| largest {worst[0]:.3e} ({worst[1]}) (tol "
              f"{FUSED_VS_UNFUSED_GRAD_TOL}); launches { {k: v for k, v in counts.items() if v} }")
        if abs(loss_f - loss_u) > TRAIN_LOSS_RTOL * abs(loss_u) or \
                worst[0] > FUSED_VS_UNFUSED_GRAD_TOL:
            raise AssertionError(f"phase 47 b={b}: the fused and unfused steps disagree")
        (_, step_f), (_, step_u) = trainer(fused_pairs=True), trainer()
        u_a, f_a = (device_ms(torch, lambda s=s: s(*args), reps=5) for s in (step_u, step_f))
        f_b, u_b = (device_ms(torch, lambda s=s: s(*args), reps=5) for s in (step_f, step_u))
        kernels = {}
        for kind, step in (("unfused", step_u), ("fused", step_f)):
            names = {}
            total, launches = profile_forward(
                torch, lambda: step(*args), iters=5, unit="step", by_name=names,
                label=f"phase 47 dim {DIM64} {kind} b={b} train steps")
            k10b = sum(ms for key, ms in names.items() if "pair_bwd_kernel" in key)
            kernels[kind] = (total, launches, k10b)
        (ku, lu, _), (kf, lf, kb) = kernels["unfused"], kernels["fused"]
        print(f"phase 47 dim {DIM64} b={b} train step (CUDA graph replays, one card: {smi}): "
              f"fused_pairs {f_a:.4f}/{f_b:.4f} ms beside unfused {u_a:.4f}/{u_b:.4f} ms; "
              f"kernel time fused {kf:.4f} ms ({lf:.1f} launches), of which K10b {kb:.4f} ms "
              f"({kb / kf:.3f}), unfused {ku:.4f} ms ({lu:.1f} launches)")
        del net_f, net_u, step_f, step_u
        torch.cuda.empty_cache()
    print(f"phase 47 (the dense layer at dim {DIM64}): {time.perf_counter() - t_start:.1f} s")


def host_ops(torch, fn, iters, label):
    """The host's time by operator over ``iters`` calls (torch.profiler, CPU
    activity): the total of the top-level operators' self times a call and
    the eight largest."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in events) / iters / 1e3
    print(f"host profile of {iters} {label}: {total:.4f} ms of operators' self time a call; "
          + "; ".join(f"{e.key[:48]} {e.self_cpu_time_total / iters / 1e3:.4f} ms "
                      f"({e.count / iters:.1f} calls)" for e in events[:8]))


def grad_err(torch, a, b) -> float:
    """max |a - b| over max |b| (0 for two zero tensors)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)


def dense_dp_run(torch, net_seed, batch, mesh=None):
    """PAR_STEPS anchor-3 steps on ``batch`` (this rank's block where
    ``mesh`` is given: ``make_sharded_denoise_train_step``; else
    ``make_denoise_train_step``), flat-buffer Adam: the losses, the first
    step's gradients (zeros where a parameter has none, as the sharded
    step's reduction leaves them), the final parameters, the step and the
    K1 / K2 launches a step. On a (data, model) mesh the network is sharded
    first (``tp_shard_module``), and its gradients and parameters come back
    whole."""
    from egnn_tpu_torch import EGNNNetwork, parallel
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.training import (make_denoise_train_step, make_fused_adam,
                                         make_sharded_denoise_train_step)

    net = EGNNNetwork(depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
                      layer_kwargs=LAYER_KWARGS, device="cuda",
                      generator=torch.Generator().manual_seed(net_seed))
    tp = mesh is not None and "model" in mesh.mesh_dim_names
    if tp:
        placements = parallel.tp_param_sharding(net, mesh)
        parallel.tp_shard_module(net, mesh)
    opt = make_fused_adam(net.parameters(), LR)
    step = (make_denoise_train_step(net, opt) if mesh is None
            else make_sharded_denoise_train_step(net, opt, mesh))
    losses, grads = [], None
    reset_launch_counts()
    for i in range(PAR_STEPS):
        losses.append(step(*batch))
        if i == 0:
            grads = {name: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for name, p in net.named_parameters()}
    torch.cuda.synchronize()
    launches = {k: v / PAR_STEPS for k, v in LAUNCH_COUNTS.items() if v}
    params = {name: p.detach().clone() for name, p in net.named_parameters()}
    if tp:
        grads = whole_tensors(torch, grads, placements, mesh.get_group("model"))
        params = whole_tensors(torch, params, placements, mesh.get_group("model"))
    return dict(losses=torch.stack(losses), grads=grads, launches=launches, step=step,
                params=params)


def sparse_par_run(torch, arm, mb, clean, mesh=None):
    """PAR_STEPS anchor-5 denoising steps (``make_adam``) on ``mb``'s global
    batch: the kNN graph (K3) built on the card, then with ``mesh`` the
    partition (``partition_uniform_edges`` for the uniform arms,
    ``partition_edges`` for (d)), this rank's blocks and
    ``make_partitioned_sparse_train_step``; without it the unsharded network
    under the same objective. The losses, the first step's gradients, the
    final parameters, the step and the launches a step."""
    from egnn_tpu_torch import EGNNSparseNetwork, parallel
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.ops.graph import knn_graph
    from egnn_tpu_torch.training import make_adam, make_partitioned_sparse_train_step

    G = mb.target.shape[0]
    n = mb.x.shape[0]
    group = None if mesh is None else mesh.get_group("graph")
    net = EGNNSparseNetwork(**SP_NET, **PAR_ARMS[arm], shard_axis=group, device="cuda",
                            generator=torch.Generator().manual_seed(SEED + 37))
    opt = make_adam(net.parameters(), LR)
    reset_launch_counts()
    es = knn_graph(mb.x[:, :3], SP_K, node_mask=mb.node_mask, graph_size=SP_NA)
    if mesh is None:
        def step(x, ei, emask, batch, clean_, nmask):
            opt.zero_grad(set_to_none=True)
            out = net(x, ei, batch=batch, edge_mask=emask, num_graphs=G, node_mask=nmask)
            err = (out[:, :3] - clean_) ** 2 * nmask[:, None].to(out.dtype)
            loss = err.sum() / (nmask.sum().to(err.dtype) * 3).clamp(min=1.0)
            loss.backward()
            opt.step()
            return loss.detach()

        args = (mb.x, es.edge_index, es.mask, mb.batch_ids, clean, mb.node_mask)
    else:
        shards = mesh.size()
        pe = (parallel.partition_uniform_edges(es.senders, n, shards, SP_K, edge_mask=es.mask)
              if "uniform_degree" in PAR_ARMS[arm] else
              parallel.partition_edges(es.senders, es.receivers, n, shards, edge_mask=es.mask))

        def blk(t):
            return parallel.sparse_node_block(mesh, t)

        step = make_partitioned_sparse_train_step(net, opt, mesh, num_graphs=G)
        args = (blk(mb.x), blk(pe.senders), blk(pe.receivers), blk(pe.mask), None,
                blk(mb.batch_ids), blk(clean), blk(mb.node_mask))
    losses, grads = [], None
    for i in range(PAR_STEPS):
        losses.append(step(*args))
        if i == 0:
            grads = {name: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for name, p in net.named_parameters()}
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCH_COUNTS.items() if v}
    return dict(losses=torch.stack(losses), grads=grads, launches=launches,
                call=lambda: step(*args),
                params={name: p.detach().clone() for name, p in net.named_parameters()})


def two_rank_main(rank, world, init_method, payload, queue):
    """Phase 38's rank: gloo (NCCL refuses two ranks on one card) on cuda:0,
    the dense data-parallel step on this rank's rows of the batch and the
    partitioned sparse step on its node block, every arm; results to the
    parent as CPU tensors."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from egnn_tpu_torch import parallel
        from egnn_tpu_torch.ops.cuda import build
        from egnn_tpu_torch.utils.profiling import time_fn

        build.build_all()      # built by the parent: loads the libraries
        parallel.initialize(backend="gloo", init_method=init_method, world_size=world,
                            rank=rank, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        out = {}
        mesh = parallel.make_mesh(world, 1)
        batch = [t.cuda() for t in payload["dense"]]
        b = [parallel.dense_batch_block(mesh, t) for t in batch[:3]] + [
            batch[3], parallel.dense_batch_block(mesh, batch[4])]
        res = dense_dp_run(torch, SEED + 38, b, mesh)
        res["ms"] = time_fn(lambda: res["step"](*b), reps=10, warmup=2, stat="median") * 1e3
        out["dense"] = res
        mb = type(payload["mb"])(*(t.cuda() for t in payload["mb"]))
        clean = payload["clean"].cuda()
        smesh = parallel.make_mesh(1, world)
        for arm in PAR_ARMS:
            res = sparse_par_run(torch, arm, mb, clean, smesh)
            res["ms"] = time_fn(res["call"], reps=5, warmup=1, stat="median") * 1e3
            out[arm] = res
        for res in out.values():
            res.pop("step", None)
            res.pop("call", None)
        # numpy: a tensor sent through a queue is shared through a file
        # descriptor that dies with this process
        queue.put((rank, True, to_numpy(torch, out)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_two_ranks(torch, payload, workdir, target=None, what="phase 38",
                  timeout=TWO_RANK_TIMEOUT):
    """Two processes running ``target`` (phase 38's ``two_rank_main`` by
    default), both on cuda:0; fails if either raises or does not report
    within ``timeout`` seconds, and leaves none running. The results come
    back with their numpy arrays as tensors on the CPU."""
    import multiprocessing as mp
    import queue as queues

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{workdir / f'two_rank_store_{time.monotonic_ns()}'}"
    procs = [ctx.Process(target=target or two_rank_main, args=(r, 2, init, payload, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + timeout
        while len(results) < 2:
            try:
                rank, ok, value = queue.get(timeout=max(0.1, deadline - time.monotonic()))
            except queues.Empty as e:
                raise AssertionError(f"{what}: ranks {sorted({0, 1} - set(results))} did not "
                                     f"report within {timeout} s") from e
            if not ok:
                raise AssertionError(f"{what}: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return [from_numpy(torch, results[0]), from_numpy(torch, results[1])]


def compare_runs(torch, what, got, ref, grad_tol, loss_rtol=PAR_LOSS_RTOL, bitwise=False,
                 steps=PAR_STEPS):
    """Print and gate a run against its reference: the losses (bitwise or at
    ``loss_rtol``), the first step's gradients at ``grad_tol`` (``grad_err``)
    and the final parameters after ``steps`` steps (their largest
    ``grad_err``)."""
    loss_err = grad_err(torch, got["losses"], ref["losses"])
    same_loss = same_bits(torch, got["losses"].cpu(), ref["losses"].cpu())
    if set(got["grads"]) != set(ref["grads"]):
        raise AssertionError(f"{what}: gradients of other parameters")
    g_errs = {k: grad_err(torch, got["grads"][k], ref["grads"][k]) for k in ref["grads"]}
    p_errs = {k: grad_err(torch, got["params"][k], ref["params"][k]) for k in ref["params"]}
    g_worst = max(g_errs.items(), key=lambda kv: kv[1])
    p_worst = max(p_errs.items(), key=lambda kv: kv[1])
    g_same = all(same_bits(torch, got["grads"][k].cpu(), ref["grads"][k].cpu()) for k in g_errs)
    p_same = all(same_bits(torch, got["params"][k].cpu(), ref["params"][k].cpu())
                 for k in p_errs)
    print(f"{what}: losses {[round(v, 6) for v in ref['losses'].tolist()]}, bitwise={same_loss} "
          f"(largest error {loss_err:.3e}, rtol {loss_rtol}); the first step's gradients "
          f"bitwise={g_same}, largest error {g_worst[1]:.3e} of the largest value "
          f"({g_worst[0]}; tol {grad_tol}); parameters after {steps} steps bitwise={p_same}, "
          f"largest error {p_worst[1]:.3e} ({p_worst[0]})")
    if bitwise and not (same_loss and g_same and p_same):
        raise AssertionError(f"{what}: not bitwise equal")
    if not (loss_err <= loss_rtol and g_worst[1] <= grad_tol):
        raise AssertionError(f"{what}: the loss or a gradient is out of tolerance")
    return g_worst[1]


def parallel_phases(torch, smi):
    """Phases 37-39: the process runtime on the card (a one-rank NCCL group;
    two ranks sharing the card under gloo) through the data-parallel dense
    step and the edge-partitioned sparse step, then the examples
    ``export_serving`` and ``denoise --metrics``. Raises on a failure."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from egnn_tpu_torch import parallel
    from egnn_tpu_torch.ops import graph as GR
    from egnn_tpu_torch.training import synthetic_chain_batch
    from egnn_tpu_torch.utils.profiling import time_fn

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=root / "build"))
    rq = synthetic_chain_batch(np.random.default_rng(SEED + 370), DP_BATCH, N, device="cuda")
    dense_batch = (rq.tokens, rq.noised_coors, rq.clean_coors, rq.adj_mat, rq.mask)
    mb, clean = molecule_batch(torch, GR.knn_graph, SP_G, SEED + 371)

    # ---- 37. a one-rank NCCL group in this process ----
    t_phase = time.perf_counter()
    dev = parallel.initialize(backend="nccl", init_method=f"file://{work / 'nccl_store'}",
                              world_size=1, rank=0)
    mesh = parallel.make_mesh(1, 1)
    print(f"one-rank group: backend {dist.get_backend()}, device {dev}, mesh "
          f"{mesh.mesh.tolist()} {mesh.mesh_dim_names}")
    plain = dense_dp_run(torch, SEED + 38, dense_batch)
    dp = dense_dp_run(torch, SEED + 38, dense_batch, mesh)
    compare_runs(torch, f"phase 37, the data-parallel anchor-3 step at one NCCL rank (b = "
                 f"{DP_BATCH}) against make_denoise_train_step", dp, plain, 0.0, 0.0, bitwise=True)
    print(f"phase 37 launches a step: data-parallel {dp['launches']}, plain {plain['launches']}")
    if not (dp["launches"].get("knn_select_gather") == DEPTH
            and dp["launches"].get("segment_sum") == DEPTH):
        raise AssertionError("phase 37: the data-parallel step did not launch K1 and K2 depth "
                             "times a step")
    timed = {}
    for key, fn in (("plain", lambda: plain["step"](*dense_batch)),
                    ("dp", lambda: dp["step"](*dense_batch))):
        timed[key] = [call_ms(torch, fn)]
    for key, fn in (("dp", lambda: dp["step"](*dense_batch)),
                    ("plain", lambda: plain["step"](*dense_batch))):
        timed[key].append(call_ms(torch, fn))
    print(f"timing on {smi}: anchor-3 step at b = {DP_BATCH} as a call (median of 30 after 5, "
          f"CUDA events), make_denoise_train_step {timed['plain'][0]:.4f}/{timed['plain'][1]:.4f} "
          f"ms, the data-parallel step at one NCCL rank {timed['dp'][0]:.4f}/"
          f"{timed['dp'][1]:.4f} ms: the reductions' and the flat gradient buffer's cost "
          f"{min(timed['dp']) - min(timed['plain']):.4f} ms")
    for key, label in (("plain", "make_denoise_train_step steps"),
                       ("dp", "data-parallel steps at one NCCL rank")):
        step = plain["step"] if key == "plain" else dp["step"]
        profile_forward(torch, lambda: step(*dense_batch), iters=10, label=label, unit="step")
    # one collective alone: the host's time a call over 100 calls without a
    # wait, and the card's (CUDA events around the 100 and a synchronize);
    # then one call behind some 20 ms of queued matrix products, whose host
    # time shows whether the call waits for the work queued before it
    from egnn_tpu_torch.parallel.collectives import all_reduce_

    group = mesh.get_group("data")
    flat = torch.zeros(sum(v.numel() for v in dp["params"].values()), device="cuda")
    big = torch.randn(4096, 4096, device="cuda") / 64
    for what, t in (("a 0-d tensor", torch.zeros((), device="cuda")),
                    (f"the flat gradient buffer ({flat.numel()} floats)", flat)):
        for _ in range(5):
            all_reduce_(t, group)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        for _ in range(100):
            all_reduce_(t, group)
        host_ms = (time.perf_counter() - t0) * 10
        ev[1].record()
        torch.cuda.synchronize()
        queued = big
        for _ in range(8):
            queued = queued @ big
        t0 = time.perf_counter()
        all_reduce_(t, group)
        behind_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t_all = (time.perf_counter() - t0) * 1e3
        print(f"one NCCL all_reduce of {what} on the one-rank group: {host_ms:.4f} ms of host "
              f"time a call, {ev[0].elapsed_time(ev[1]) / 100:.4f} ms a call between CUDA events "
              f"over 100 calls; behind eight queued 4096^2 products (their end "
              f"{t_all:.4f} ms after the call began) the call took {behind_ms:.4f} ms of host "
              f"time, on {smi}")
    del plain, dp
    sparse_ref = {}
    for arm in PAR_ARMS:
        ref = sparse_ref[arm] = sparse_par_run(torch, arm, mb, clean)
        got = sparse_par_run(torch, arm, mb, clean, mesh)
        compare_runs(torch, f"phase 37, the partitioned anchor-5 step at S = 1, arm ({arm}) "
                     f"{PAR_ARMS[arm]}, against the unsharded step", got, ref, PAR_ONE_RANK_TOL)
        print(f"phase 37 arm ({arm}) launches over {PAR_STEPS} steps: partitioned "
              f"{got['launches']}, unsharded {ref['launches']}")
        need = ["knn_select", "segment_sum"] + (["fused_pair_fwd", "fused_pair_bwd"]
                                                if arm == "c" else [])
        if any(not got["launches"].get(k) for k in need):
            raise AssertionError(f"phase 37 arm ({arm}): a kernel of the path did not launch "
                                 f"({need})")
        if arm == "b":
            ms = {"unsharded": [call_ms(torch, ref["call"])],
                  "partitioned": [call_ms(torch, got["call"])]}
            ms["partitioned"].append(call_ms(torch, got["call"]))
            ms["unsharded"].append(call_ms(torch, ref["call"]))
            print(f"timing on {smi}: anchor-5 arm (b) step at G = {SP_G} as a call (median of 30 "
                  f"after 5), unsharded {ms['unsharded'][0]:.4f}/{ms['unsharded'][1]:.4f} ms, "
                  f"partitioned at S = 1 {ms['partitioned'][0]:.4f}/{ms['partitioned'][1]:.4f} "
                  f"ms: the collectives' cost {min(ms['partitioned']) - min(ms['unsharded']):.4f} "
                  f"ms")
            host_ops(torch, ref["call"], 5, "unsharded arm (b) steps")
            host_ops(torch, got["call"], 5, "partitioned arm (b) steps at S = 1")
        del got
    dist.destroy_process_group()
    print(f"phase 37: {time.perf_counter() - t_phase:.1f} s")

    # ---- 38. two ranks sharing the one card, gloo ----
    t_phase = time.perf_counter()
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    ranks = run_two_ranks(torch, dict(dense=tuple(cpu(t) for t in dense_batch),
                                      mb=type(mb)(*(cpu(t) for t in mb)), clean=cpu(clean)),
                          work)
    plain = dense_dp_run(torch, SEED + 38, dense_batch)
    for key in ["dense", *PAR_ARMS]:
        ref = plain if key == "dense" else sparse_ref[key]
        tol = PAR_GRAD_TOL_SELF_PAIRS if key == "dense" else PAR_GRAD_TOL
        what = ("the data-parallel anchor-3 step, b = 8 as 4 rows a rank" if key == "dense" else
                f"the partitioned anchor-5 step at S = 2, arm ({key}) {PAR_ARMS[key]}")
        for r, res in enumerate(ranks):
            compare_runs(torch, f"phase 38 rank {r}, {what}, against one process on the card",
                         res[key], ref, tol)
        a, b = ranks[0][key], ranks[1][key]
        same = all(same_bits(torch, a["params"][k], b["params"][k]) for k in a["params"])
        print(f"phase 38 {what}: the two ranks' parameters after {PAR_STEPS} steps bitwise "
              f"equal={same}; launches on rank 0 {a['launches']}, rank 1 {b['launches']}; a step "
              f"{a['ms']:.4f} / {b['ms']:.4f} ms as a call on each rank (two ranks sharing one "
              f"card, gloo through host memory: not a scaling number) on {smi}")
        need = (["knn_select_gather", "segment_sum"] if key == "dense" else
                ["knn_select", "segment_sum"] + (["fused_pair_fwd", "fused_pair_bwd"]
                                                 if key == "c" else []))
        if not same or any(not res[key]["launches"].get(k) for res in ranks for k in need):
            raise AssertionError(f"phase 38 {what}: the ranks' parameters differ or a kernel of "
                                 f"the path ({need}) did not launch")
    del plain, sparse_ref, ranks
    torch.cuda.empty_cache()
    print(f"phase 38: {time.perf_counter() - t_phase:.1f} s")

    # ---- 39. the examples on the card ----
    t_phase = time.perf_counter()
    from egnn_tpu_torch.examples import denoise, export_serving

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = export_serving.main(["--device", "cuda", "--out", str(work / "fwd.pt2")])
    print(out.getvalue().strip().splitlines()[0])
    if not (summary["bitwise"] and summary["k1_launches"] == 3 and summary["op_calls"] == 3):
        raise AssertionError(f"export_serving: {summary}")
    metrics = work / "metrics.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        s_den = denoise.main(["--device", "cuda", "--steps", "16", "--metrics", str(metrics)])
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    ok = ([r["step"] for r in recs] == list(range(16))
          and all(math.isfinite(r["loss"]) for r in recs)
          and [r["loss"] for r in recs] == s_den["losses"])
    print(f"denoise trainer with --metrics, 16 micro-steps on the card: {len(recs)} JSONL lines, "
          f"losses finite and the summary's: {ok}; first {recs[0]}, last {recs[-1]}")
    if not ok:
        raise AssertionError("denoise --metrics: the metrics file is not one finite line a step")
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 39: {time.perf_counter() - t_phase:.1f} s")


# phases 40-42: model parallelism. The ring: the all-pairs denoiser at the
# streamed layer's width (phase 32: dim 64, norm_coors and not), depth cut
# to 2, n = 1024; tensor parallelism: anchor 1's layer and anchor 3's step
# at model = 2; the pipeline: anchor 3's layer settings at n = 1024, b = 8,
# in 4 microbatches over a stack of depth 4
RING_DEPTH, RING_DIM = 2, 64
PIPE_DEPTH, PIPE_M = 4, 4
MP_TIMEOUT = 300     # seconds for both ranks of phases 40-42 to report


def pipe_mb_loss(feats, coors, target, mask):
    """The pipeline's microbatch loss: anchor 3's masked MSE."""
    from egnn_tpu_torch.training import masked_mse

    return masked_mse(coors, target, mask)


def launches_now(torch):
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS

    torch.cuda.synchronize()
    return {k: v for k, v in LAUNCH_COUNTS.items() if v}


def ring_run(torch, norm, batch, mesh=None):
    """PAR_STEPS steps (flat-buffer Adam) of the all-pairs denoiser
    (``EGNNNetwork`` depth 2, dim 64, no kNN) on ``batch`` = (tokens, noised,
    clean, mask): with ``mesh`` this rank's node block through
    ``make_ring_denoise_train_step`` (the layers' ring on the mesh's graph
    group), else the whole batch through ``make_denoise_train_step`` (the
    one-process streamed layer). The losses, the first step's gradients,
    the final parameters, the launches and the step."""
    from egnn_tpu_torch import EGNNNetwork
    from egnn_tpu_torch.ops.cuda import reset_launch_counts
    from egnn_tpu_torch.training import (make_denoise_train_step, make_fused_adam,
                                         make_ring_denoise_train_step)

    kw = dict(norm_coors=norm)
    if mesh is not None:
        kw["ring_axis"] = mesh.get_group("graph")
    net = EGNNNetwork(depth=RING_DEPTH, dim=RING_DIM, num_tokens=NUM_TOKENS, layer_kwargs=kw,
                      device="cuda", generator=torch.Generator().manual_seed(SEED + 40))
    opt = make_fused_adam(net.parameters(), LR)
    if mesh is None:
        plain = make_denoise_train_step(net, opt)

        def step(tokens, noised, clean, mask):
            return plain(tokens, noised, clean, None, mask)
    else:
        step = make_ring_denoise_train_step(net, opt, mesh)
    reset_launch_counts()
    losses, grads = [], None
    for i in range(PAR_STEPS):
        losses.append(step(*batch))
        if i == 0:
            grads = {name: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for name, p in net.named_parameters()}
    return dict(losses=torch.stack(losses), grads=grads, launches=launches_now(torch),
                params={name: p.detach().clone() for name, p in net.named_parameters()},
                call=lambda: step(*batch))


def ring_layer_forward(torch, feats, coors, mask, group=None):
    """One all-pairs layer (dim 64, norm_coors) served: the ring over
    ``group`` on this rank's node block, else the streamed layer."""
    from egnn_tpu_torch import EGNN

    layer = EGNN(dim=RING_DIM, norm_coors=True, ring_axis=group, device="cuda",
                 generator=torch.Generator().manual_seed(SEED + 401)).eval()

    def call():
        with torch.no_grad():
            return layer(feats, coors, mask=mask)

    return call


def whole_tensors(torch, tensors, placements, group):
    """Tensors by parameter name, each sharded one gathered whole over the
    model group (``placements``: ``tp_param_sharding``'s)."""
    from torch.distributed.tensor import Shard

    from egnn_tpu_torch.parallel.collectives import gather_from_group

    with torch.no_grad():
        return {k: gather_from_group(v, group, placements[k].dim)
                if isinstance(placements[k], Shard) else v.clone()
                for k, v in tensors.items()}


def tp_layer_run(torch, feats, coors, mesh=None):
    """Anchor 1's layer (``EGNN(dim=512)``, n = 16), sharded over the
    mesh's model group where ``mesh`` is given: the output and the
    gradients of (fo**2).mean() + (co**2).mean() with respect to the
    features and every parameter (whole), and the call."""
    from egnn_tpu_torch import EGNN, parallel

    layer = EGNN(dim=DIM_ANCHOR12, device="cuda",
                 generator=torch.Generator().manual_seed(SEED + 41))
    placements = group = None
    if mesh is not None:
        placements = parallel.tp_param_sharding(layer, mesh)
        group = mesh.get_group("model")
        parallel.tp_shard_module(layer, mesh)
    names = [k for k, _ in layer.named_parameters()]

    def fb():
        f = feats.detach().requires_grad_()
        fo, co = layer(f, coors)
        grads = torch.autograd.grad((fo ** 2).mean() + (co ** 2).mean(),
                                    [f] + list(layer.parameters()))
        return fo.detach(), co.detach(), grads

    fo, co, grads = fb()
    named = dict(zip(names, grads[1:]))
    if mesh is not None:
        named = whole_tensors(torch, named, placements, group)
    return dict(out=(fo, co), feats_grad=grads[0], grads=named, call=fb,
                sharded=sorted(layer.tp_sharded))


def sparse_tp_run(torch, arm, mb, clean, mesh=None):
    """PAR_STEPS anchor-5 denoising steps (``make_adam``) of arm ``arm``
    (``SP_ARMS``) on ``mb``'s molecules, sharded over the mesh's model group
    where ``mesh`` is given (``tp_shard_module``): the losses, the first
    step's gradients and the final parameters (whole), the launches over
    the steps and the step."""
    from egnn_tpu_torch import EGNNSparseNetwork, parallel
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.training import make_adam

    G = mb.target.shape[0]
    net = EGNNSparseNetwork(**SP_NET, **SP_ARMS[arm], device="cuda",
                            generator=torch.Generator().manual_seed(SEED + 413))
    placements = None
    if mesh is not None:
        placements = parallel.tp_param_sharding(net, mesh)
        parallel.tp_shard_module(net, mesh)
    opt = make_adam(net.parameters(), LR)

    def step():
        opt.zero_grad(set_to_none=True)
        out = net(mb.x, mb.edge_index, batch=mb.batch_ids, edge_mask=mb.edge_mask,
                  num_graphs=G, node_mask=mb.node_mask)
        err = (out[:, :3] - clean) ** 2 * mb.node_mask[:, None].to(out.dtype)
        loss = err.sum() / (mb.node_mask.sum().to(err.dtype) * 3).clamp(min=1.0)
        loss.backward()
        opt.step()
        return loss.detach()

    reset_launch_counts()
    losses, grads = [], None
    for i in range(PAR_STEPS):
        losses.append(step())
        if i == 0:
            grads = {name: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for name, p in net.named_parameters()}
    launches = launches_now(torch)
    params = {name: p.detach().clone() for name, p in net.named_parameters()}
    if mesh is not None:
        grads = whole_tensors(torch, grads, placements, mesh.get_group("model"))
        params = whole_tensors(torch, params, placements, mesh.get_group("model"))
    return dict(losses=torch.stack(losses), grads=grads, launches=launches, call=step,
                params=params, sharded=sorted(net.mpnn_0.tp_sharded) if mesh else [])


def pipe_batch(torch, seed):
    """Anchor 3's inputs at b = 8 for the pipeline: random features of the
    layer's width, the noised chain, its clean coordinates, mask and chain
    adjacency."""
    import numpy as np

    from egnn_tpu_torch.training import synthetic_chain_batch

    rq = synthetic_chain_batch(np.random.default_rng(seed), DP_BATCH, N, device="cuda")
    feats = torch.randn(DP_BATCH, N, DIM, generator=torch.Generator().manual_seed(seed))
    return feats.cuda(), rq.noised_coors, rq.clean_coors, rq.mask, rq.adj_mat


def pipe_stack(torch):
    """The stack's layers (anchor 3's settings, depth 4, seeds fixed) and
    their stacked parameters."""
    from egnn_tpu_torch import EGNN, parallel

    layers = [EGNN(dim=DIM, **LAYER_KWARGS, device="cuda",
                   generator=torch.Generator().manual_seed(SEED + 420 + i))
              for i in range(PIPE_DEPTH)]
    return layers[0], parallel.stack_layer_params(layers)


def pipe_run(torch, batch, group):
    """``make_pipelined_loss`` and ``make_pipelined_apply`` over ``group``:
    the loss, this stage's rows of the stacked parameters' gradients, the
    outputs, the launches of one loss call (forward and backward) and of one
    apply, and the two calls."""
    from egnn_tpu_torch import parallel
    from egnn_tpu_torch.ops.cuda import reset_launch_counts

    feats, noised, clean, mask, adj = batch
    layer, stacked = pipe_stack(torch)
    S, r = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    block = parallel.stage_block(parallel.to_stages(stacked, S), group)
    loss_fn = parallel.make_pipelined_loss(layer, group, PIPE_M, pipe_mb_loss)
    apply = parallel.make_pipelined_apply(layer, group, PIPE_M)

    def loss_call():
        for v in stacked.values():
            v.grad = None
        loss = loss_fn(block, feats, noised, clean, mask=mask, adj_mat=adj)
        loss.backward()
        return loss.detach()

    def apply_call():
        with torch.no_grad():
            return apply(block, feats, noised, mask=mask, adj_mat=adj)

    reset_launch_counts()
    loss = loss_call()
    loss_launches = launches_now(torch)
    L = PIPE_DEPTH // S
    grads = {k: v.grad[r * L:(r + 1) * L].detach().clone() for k, v in stacked.items()}
    reset_launch_counts()
    out = apply_call()
    return dict(loss=loss, grads=grads, out=out, loss_launches=loss_launches,
                apply_launches=launches_now(torch), loss_call=loss_call, apply_call=apply_call)


def pipe_sequential(torch, batch):
    """The sequential stack over the same microbatches in one process: the
    microbatch-mean loss, the stacked parameters' gradients, the outputs,
    and the two calls."""
    from torch.func import functional_call

    feats, noised, clean, mask, adj = batch
    layer, stacked = pipe_stack(torch)
    mb = DP_BATCH // PIPE_M

    def run(grad):
        losses, outs = [], []
        with torch.set_grad_enabled(grad):
            for i in range(PIPE_M):
                sl = slice(i * mb, (i + 1) * mb)
                f, c = feats[sl], noised[sl]
                for li in range(PIPE_DEPTH):
                    f, c = functional_call(layer, {k: v[li] for k, v in stacked.items()},
                                           (f, c), dict(mask=mask[sl], adj_mat=adj))
                outs.append((f, c))
                losses.append(pipe_mb_loss(f, c, clean[sl], mask[sl]))
        return torch.stack(losses).sum() / PIPE_M, outs

    def loss_call():
        for v in stacked.values():
            v.grad = None
        loss, _ = run(True)
        loss.backward()
        return loss.detach()

    def apply_call():
        _, outs = run(False)
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    loss = loss_call()
    return dict(loss=loss, grads={k: v.grad.detach().clone() for k, v in stacked.items()},
                out=apply_call(), loss_call=loss_call, apply_call=apply_call)


def model_parallel_rank_main(rank, world, init_method, payload, queue):
    """Phases 40-42's rank: gloo on cuda:0 (two ranks share the card), the
    ring (its node block of the batch, the layer's forward), tensor
    parallelism at model = 2 (anchor 1's layer, anchor 3's step) and the
    pipeline at S = 2; each path timed as a call. Results to the parent as
    numpy arrays."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from egnn_tpu_torch import parallel
        from egnn_tpu_torch.ops.cuda import build
        from egnn_tpu_torch.utils.profiling import time_fn

        build.build_all()      # built by the parent: loads the libraries
        parallel.initialize(backend="gloo", init_method=init_method, world_size=world,
                            rank=rank, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda = lambda ts: tuple(t.cuda() for t in ts)  # noqa: E731
        out = {}
        mesh = parallel.make_mesh(1, world)
        ring_batch = tuple(parallel.dense_batch_block(mesh, t) for t in cuda(payload["ring"]))
        for norm in (True, False):
            res = ring_run(torch, norm, ring_batch, mesh)
            res["ms"] = time_fn(res.pop("call"), reps=5, warmup=1, stat="median") * 1e3
            out[f"ring_{norm}"] = res
        feats, coors, mask = (parallel.dense_batch_block(mesh, t)
                              for t in cuda(payload["ring_layer"]))
        call = ring_layer_forward(torch, feats, coors, mask, mesh.get_group("graph"))
        out["ring_layer"] = dict(out=call(), ms=time_fn(call, reps=5, warmup=1,
                                                       stat="median") * 1e3)
        tp_mesh = parallel.make_tp_mesh(1, world)
        res = tp_layer_run(torch, *cuda(payload["anchor1"]), tp_mesh)
        res["ms"] = time_fn(res.pop("call"), reps=30, warmup=5, stat="median") * 1e3
        out["tp_layer"] = res
        batch = cuda(payload["dense"])
        res = dense_dp_run(torch, SEED + 41, batch, tp_mesh)
        step = res.pop("step")
        res["ms"] = time_fn(lambda: step(*batch), reps=10, warmup=2, stat="median") * 1e3
        out["tp_step"] = res
        mb = type(payload["mb"])(*(t.cuda() for t in payload["mb"]))
        for arm in ("b", "c"):
            res = sparse_tp_run(torch, arm, mb, payload["clean"].cuda(), tp_mesh)
            res["ms"] = time_fn(res.pop("call"), reps=5, warmup=1, stat="median") * 1e3
            out[f"tp_sparse_{arm}"] = res
        res = pipe_run(torch, cuda(payload["pipe"]), dist.group.WORLD)
        res["loss_ms"] = time_fn(res.pop("loss_call"), reps=5, warmup=1, stat="median") * 1e3
        res["apply_ms"] = time_fn(res.pop("apply_call"), reps=5, warmup=1, stat="median") * 1e3
        out["pipe"] = res
        # numpy: a tensor sent through a queue is shared through a file
        # descriptor that dies with this process
        queue.put((rank, True, to_numpy(torch, out)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def to_numpy(torch, obj):
    """Every tensor in nested dicts, lists and tuples as a numpy array on
    the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(torch, v) for v in obj)
    return obj


def from_numpy(torch, obj):
    """``to_numpy``'s inverse, on the host."""
    import numpy as np

    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: from_numpy(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_numpy(torch, v) for v in obj)
    return obj


def model_parallel_phases(torch, smi):
    """Phases 40-42: the ring, tensor parallelism and the pipeline on the
    card: a one-rank NCCL group in this process (g = 1, S = 1: nothing is
    permuted; NCCL refuses two ranks on one card), then two spawned ranks
    sharing the card under gloo, each path against its one-process
    reference and timed beside it. Raises on a failure."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from egnn_tpu_torch import parallel
    from egnn_tpu_torch.ops import graph as GR
    from egnn_tpu_torch.training import synthetic_chain_batch
    from egnn_tpu_torch.utils.profiling import time_fn

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=root / "build"))
    t_start = time.perf_counter()
    mb, mb_clean = molecule_batch(torch, GR.knn_graph, SP_G, SEED + 412)
    rq = synthetic_chain_batch(np.random.default_rng(SEED + 400), 1, N, device="cuda")
    ring_batch = (rq.tokens, rq.noised_coors, rq.clean_coors, rq.mask)
    g40 = torch.Generator().manual_seed(SEED + 402)
    ring_layer_in = (torch.randn(1, N, RING_DIM, generator=g40).cuda(), rq.noised_coors,
                     rq.mask)
    g41 = torch.Generator().manual_seed(SEED + 410)
    anchor1 = (torch.randn(1, N_ANCHOR12, DIM_ANCHOR12, generator=g41).cuda(),
               torch.randn(1, N_ANCHOR12, 3, generator=g41).cuda())
    rq8 = synthetic_chain_batch(np.random.default_rng(SEED + 411), DP_BATCH, N, device="cuda")
    dense = (rq8.tokens, rq8.noised_coors, rq8.clean_coors, rq8.adj_mat, rq8.mask)
    pipe_in = pipe_batch(torch, SEED + 420)

    def timed_pair(a, b):
        """Two calls timed in turns (a, b, b, a), medians of 3 after 1 as
        calls."""
        ta = [time_fn(a, reps=3, warmup=1, stat="median") * 1e3]
        tb = [time_fn(b, reps=3, warmup=1, stat="median") * 1e3]
        tb.append(time_fn(b, reps=3, warmup=1, stat="median") * 1e3)
        ta.append(time_fn(a, reps=3, warmup=1, stat="median") * 1e3)
        return ta, tb

    # ---- 40 and 42 at one NCCL rank: g = 1 and S = 1 ----
    t_phase = time.perf_counter()
    parallel.initialize(backend="nccl", init_method=f"file://{work / 'nccl_store'}",
                        world_size=1, rank=0)
    mesh = parallel.make_mesh(1, 1)
    ring_ref = {}
    for norm in (True, False):
        ref = ring_ref[norm] = ring_run(torch, norm, ring_batch)
        got = ring_run(torch, norm, ring_batch, mesh)
        tol = STREAM_NORM_COORS_GRAD_TOL if norm else PAR_GRAD_TOL
        compare_runs(torch, f"phase 40, the ring step at one NCCL rank (g = 1: one block of "
                     f"{N} x {N} pairs a layer), norm_coors={norm}, against the streamed step",
                     got, ref, tol)
        print(f"phase 40 launches over {PAR_STEPS} steps: ring {got['launches']}, streamed "
              f"{ref['launches']} (the all-pairs path runs no kernel of the port: plain torch, "
              f"as the JAX package's runs outside any Pallas kernel)")
        t_ref, t_got = timed_pair(ref["call"], got["call"])
        print(f"timing on {smi}: the depth-2 dim-64 all-pairs step at n = {N} as a call "
              f"(median of 3 after 1), streamed {t_ref[0]:.4f}/{t_ref[1]:.4f} ms, the ring at "
              f"one NCCL rank {t_got[0]:.4f}/{t_got[1]:.4f} ms")
        del got
    stream_call = ring_layer_forward(torch, *ring_layer_in)
    ring_call = ring_layer_forward(torch, *ring_layer_in, group=mesh.get_group("graph"))
    ref_out, got_out = stream_call(), ring_call()
    err = max((a - b_).abs().max().item() for a, b_ in zip(got_out, ref_out))
    t_ref, t_got = timed_pair(stream_call, ring_call)
    print(f"phase 40, the ring layer served at one NCCL rank against the streamed layer: "
          f"max err {err:.3e} (atol {GPU_VS_CPU_ATOL}); as a call {t_got[0]:.4f}/{t_got[1]:.4f} "
          f"ms against {t_ref[0]:.4f}/{t_ref[1]:.4f} ms on {smi}")
    if err > GPU_VS_CPU_ATOL:
        raise AssertionError("phase 40: the ring layer disagrees with the streamed layer")
    del stream_call, ring_call
    torch.cuda.empty_cache()

    seq = pipe_sequential(torch, pipe_in)
    one = pipe_run(torch, pipe_in, mesh.get_group("graph"))
    same = (same_bits(torch, one["loss"], seq["loss"])
            and all(same_bits(torch, one["grads"][k], seq["grads"][k]) for k in seq["grads"])
            and all(same_bits(torch, a, b_) for a, b_ in zip(one["out"], seq["out"])))
    print(f"phase 42, the pipeline at S = 1 (one NCCL rank) against the sequential stack over "
          f"the same {PIPE_M} microbatches: loss, every gradient and the outputs bitwise={same}; "
          f"launches a loss call (forward and backward) {one['loss_launches']}, an apply "
          f"{one['apply_launches']}")
    if not same:
        raise AssertionError("phase 42: the pipeline at S = 1 is not bitwise the sequential "
                             "stack")
    need = {"knn_select_gather": PIPE_M * PIPE_DEPTH, "segment_sum": PIPE_M * (PIPE_DEPTH - 1)}
    if not (all(one["loss_launches"].get(k) == v for k, v in need.items())
            and one["apply_launches"].get("knn_select_gather") == PIPE_M * PIPE_DEPTH):
        raise AssertionError(f"phase 42: S = 1 launched other than {need}")
    for key in ("loss_call", "apply_call"):
        t_seq, t_one = timed_pair(seq[key], one[key])
        print(f"timing on {smi}: {key[:-5]} over depth {PIPE_DEPTH}, b = {DP_BATCH} in {PIPE_M} "
              f"microbatches as a call (median of 3 after 1): sequential "
              f"{t_seq[0]:.4f}/{t_seq[1]:.4f} ms, the pipeline at S = 1 "
              f"{t_one[0]:.4f}/{t_one[1]:.4f} ms")
    del one
    dist.destroy_process_group()
    print(f"phases 40 and 42 at one NCCL rank: {time.perf_counter() - t_phase:.1f} s")

    # ---- 40-42 on two ranks sharing the card (gloo) ----
    t_phase = time.perf_counter()
    cpu = lambda ts: tuple(t.detach().cpu() for t in ts)  # noqa: E731
    ranks = run_two_ranks(torch, dict(ring=cpu(ring_batch), ring_layer=cpu(ring_layer_in),
                                      anchor1=cpu(anchor1), dense=cpu(dense),
                                      pipe=cpu(pipe_in), mb=type(mb)(*cpu(mb)),
                                      clean=mb_clean.cpu()),
                          work, target=model_parallel_rank_main, what="phases 40-42",
                          timeout=MP_TIMEOUT)
    print(f"phases 40-42's two ranks: {time.perf_counter() - t_phase:.1f} s")

    # 40: the ring at g = 2
    for norm in (True, False):
        tol = STREAM_NORM_COORS_GRAD_TOL if norm else PAR_GRAD_TOL
        key = f"ring_{norm}"
        for r, res in enumerate(ranks):
            compare_runs(torch, f"phase 40 rank {r}, the ring step at g = 2 ({N // 2} nodes a "
                         f"rank), norm_coors={norm}, against the streamed step in one process",
                         res[key], ring_ref[norm], tol)
        a, b_ = ranks[0][key], ranks[1][key]
        same = all(same_bits(torch, a["params"][k], b_["params"][k]) for k in a["params"])
        print(f"phase 40 ring step, norm_coors={norm}: the two ranks' parameters after "
              f"{PAR_STEPS} steps bitwise equal={same}; launches rank 0 {a['launches']}, rank 1 "
              f"{b_['launches']}; a step {a['ms']:.4f} / {b_['ms']:.4f} ms as a call on each rank "
              f"(two ranks sharing one card, gloo through host memory: not a scaling number) "
              f"on {smi}")
        if not same:
            raise AssertionError(f"phase 40: the ranks' parameters differ (norm_coors={norm})")
    got = [torch.cat([r["ring_layer"]["out"][i] for r in ranks], dim=1) for i in range(2)]
    ref_out = [t.cpu() for t in ref_out]
    err = max((a - b_).abs().max().item() for a, b_ in zip(got, ref_out))
    print(f"phase 40, the ring layer served at g = 2 against the streamed layer: max err "
          f"{err:.3e} (atol {GPU_VS_CPU_ATOL}); a call {ranks[0]['ring_layer']['ms']:.4f} / "
          f"{ranks[1]['ring_layer']['ms']:.4f} ms on each rank")
    if err > GPU_VS_CPU_ATOL:
        raise AssertionError("phase 40: the ring layer at g = 2 disagrees")
    del ring_ref

    # 41: tensor parallelism at model = 2
    ref = tp_layer_run(torch, *anchor1)
    for r, res in enumerate(ranks):
        res = res["tp_layer"]
        ef = max((a - b_.cpu()).abs().max().item() for a, b_ in zip(res["out"], ref["out"]))
        eg = max([grad_err(torch, res["feats_grad"], ref["feats_grad"])]
                 + [grad_err(torch, res["grads"][k], ref["grads"][k]) for k in ref["grads"]])
        print(f"phase 41 rank {r}, anchor 1's layer (dim {DIM_ANCHOR12}, n = {N_ANCHOR12}) at "
              f"model = 2 ({res['sharded']} sharded) against the replicated layer: forward max "
              f"err {ef:.3e} (atol {GPU_VS_CPU_ATOL}), gradients (the features' and every "
              f"parameter's, whole) up to {eg:.3e} of their largest value (tol {PAR_GRAD_TOL})")
        if not (ef <= GPU_VS_CPU_ATOL and eg <= PAR_GRAD_TOL
                and res["sharded"] == ["coors_mlp", "edge_mlp", "node_mlp"]):
            raise AssertionError("phase 41: anchor 1's layer under tensor parallelism disagrees")
    t_rep = call_ms(torch, ref["call"])
    print(f"timing on {smi}: anchor 1's fwd+bwd as a call (median of 30 after 5), replicated in "
          f"one process {t_rep:.4f} ms, at model = 2 {ranks[0]['tp_layer']['ms']:.4f} / "
          f"{ranks[1]['tp_layer']['ms']:.4f} ms on each rank (two ranks on one card, gloo)")
    ref = dense_dp_run(torch, SEED + 41, dense)
    for r, res in enumerate(ranks):
        compare_runs(torch, f"phase 41 rank {r}, anchor 3's step (b = {DP_BATCH}) at model = 2 "
                     f"against the replicated step", res["tp_step"], ref, PAR_GRAD_TOL_SELF_PAIRS)
    a, b_ = ranks[0]["tp_step"], ranks[1]["tp_step"]
    same = all(same_bits(torch, a["params"][k], b_["params"][k]) for k in a["params"])
    t_rep = call_ms(torch, lambda: ref["step"](*dense), iters=10, warmup=2)
    print(f"phase 41 anchor 3's step: the two ranks' parameters (whole) after {PAR_STEPS} steps "
          f"bitwise equal={same}; launches a step rank 0 {a['launches']}, rank 1 "
          f"{b_['launches']}; a step {a['ms']:.4f} / {b_['ms']:.4f} ms as a call on each rank, "
          f"the replicated step {t_rep:.4f} ms in one process, on {smi}")
    if not (same and all(res["tp_step"]["launches"].get(k) == DEPTH for res in ranks
                         for k in ("knn_select_gather", "segment_sum"))):
        raise AssertionError("phase 41: the ranks' parameters differ or K1 and K2 did not run "
                             "depth times a step")
    del ref
    for arm in ("b", "c"):
        ref = sparse_tp_run(torch, arm, mb, mb_clean)
        key = f"tp_sparse_{arm}"
        for r, res in enumerate(ranks):
            compare_runs(torch, f"phase 41 rank {r}, anchor 5's arm ({arm}) {SP_ARMS[arm]} "
                         f"(G = {SP_G}) at model = 2 ({res[key]['sharded']} sharded) against "
                         f"the replicated network", res[key], ref, TP_SPARSE_GRAD_TOL)
        a, b_ = ranks[0][key], ranks[1][key]
        same = all(same_bits(torch, a["params"][k], b_["params"][k]) for k in a["params"])
        t_rep = call_ms(torch, ref["call"], iters=10, warmup=2)
        print(f"phase 41 anchor 5's arm ({arm}): the two ranks' parameters (whole) after "
              f"{PAR_STEPS} steps bitwise equal={same}; launches over the steps rank 0 "
              f"{a['launches']}, rank 1 {b_['launches']}, replicated {ref['launches']}; a step "
              f"{a['ms']:.4f} / {b_['ms']:.4f} ms as a call on each rank, the replicated step "
              f"{t_rep:.4f} ms in one process, on {smi}")
        need = ["segment_sum"] + (["fused_pair_fwd", "fused_pair_bwd"] if arm == "c" else [])
        if not (same and all(res[key]["launches"].get(k) for res in ranks for k in need)
                and all(res[key]["sharded"] == ["coors_mlp", "edge_mlp", "node_mlp"]
                        for res in ranks)):
            raise AssertionError(f"phase 41 arm ({arm}): the ranks' parameters differ, an MLP "
                                 f"stayed whole or a kernel of the path ({need}) did not launch")
        del ref

    # 42: the pipeline at S = 2
    L = PIPE_DEPTH // 2
    for r, res in enumerate(ranks):
        res = res["pipe"]
        loss_err = grad_err(torch, res["loss"], seq["loss"])
        g_err = max(grad_err(torch, res["grads"][k], seq["grads"][k][r * L:(r + 1) * L])
                    for k in seq["grads"])
        ef = max((a - b_.cpu()).abs().max().item() for a, b_ in zip(res["out"], seq["out"]))
        print(f"phase 42 stage {r} of 2: pipeline_loss {res['loss'].item():.6f} against "
              f"{seq['loss'].item():.6f} (error {loss_err:.3e}, rtol {PAR_LOSS_RTOL}), its "
              f"layers' gradients up to {g_err:.3e} of their largest value (tol "
              f"{PAR_GRAD_TOL_SELF_PAIRS}), pipeline_apply's outputs max err {ef:.3e} (atol "
              f"{GPU_VS_CPU_ATOL}); launches a loss call {res['loss_launches']}, an apply "
              f"{res['apply_launches']}; a loss call {res['loss_ms']:.4f} ms, an apply "
              f"{res['apply_ms']:.4f} ms (two ranks on one card, gloo)")
        k2 = PIPE_M * (L - 1 if r == 0 else L)
        if not (loss_err <= PAR_LOSS_RTOL and g_err <= PAR_GRAD_TOL_SELF_PAIRS
                and ef <= GPU_VS_CPU_ATOL
                and res["loss_launches"].get("knn_select_gather") == PIPE_M * L
                and res["loss_launches"].get("segment_sum") == k2
                and res["apply_launches"].get("knn_select_gather") == PIPE_M * L):
            raise AssertionError(f"phase 42 stage {r}: out of tolerance or launched other than "
                                 f"K1 {PIPE_M * L}, K2 {k2}")
    del seq, ranks
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    print(f"phases 40-42: {time.perf_counter() - t_start:.1f} s")


def sparse_kernel_timing(torch, K, SK, PM, core, mb, G, sms, sp_err, serving, steps,
                         parent=None):
    """K3, K2, K10f and K10b at the shapes anchor 5 gives them, each beside
    its plain version, its bound and the library call or the unfused
    pipeline, and its launches on the main path (arm (a)'s and (c)'s serving
    of four batches, their five steps); K10b's one-block instances' registers
    and spills (raises if one spills), and K10b beside a ``parent``
    checkout's source and wrapper (``parent_pair_messages``), where given."""
    from egnn_tpu_torch.ops.cuda import build

    n, e = G * SP_NA, G * SP_NA * SP_K
    # K3: knn_graph's selection, b = G molecules of SP_NA atoms, k + 1 slots
    cg = mb.x[:, :3].reshape(G, SP_NA, 3).contiguous()
    mg = mb.node_mask.reshape(G, SP_NA).contiguous()
    ms = [device_ms(torch, f) for f in (lambda: K.knn_select_plain(cg, SP_K + 1, mg),
                                        lambda: K.knn_select(cg, SP_K + 1, mg),
                                        lambda: K.knn_select(cg, SP_K + 1, mg),
                                        lambda: K.knn_select_plain(cg, SP_K + 1, mg))]
    bound_ms, bound_by = knn_bound(G, SP_NA, 3, SP_K + 1, 0, True, 0)
    print(f"sparse timing knn_select G={G} (b={G} n={SP_NA} k={SP_K + 1}, mask): kernel "
          f"{ms[1]:.5f}/{ms[2]:.5f} ms, plain {ms[0]:.5f}/{ms[3]:.5f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); no library call computes it; {serving['a']['knn_select']} launches "
          f"serving arm (a)")
    # K2: the sender gather's backward, (E, 3 + dim) rows into n nodes (padding
    # rows point at node 0)
    senders = mb.edge_index[0].reshape(1, e).contiguous()
    data = torch.randn(1, e, 3 + SP_DIM, device="cuda")
    ms = [device_ms(torch, f) for f in (lambda: SK.segment_sum_plain(data, senders, n),
                                        lambda: SK.segment_sum(data, senders, n),
                                        lambda: SK.segment_sum(data, senders, n),
                                        lambda: SK.segment_sum_plain(data, senders, n))]
    flat = senders.reshape(-1)
    lib = device_ms(torch, lambda: torch.zeros(n, 3 + SP_DIM, device="cuda").index_add_(
        0, flat, data[0]))
    bound_ms, bound_by = segment_bound(1, e, n, 3 + SP_DIM)
    print(f"sparse timing segment_sum G={G} (E={e} S={n} D={3 + SP_DIM}, the sender gather's "
          f"backward): kernel {ms[1]:.5f}/{ms[2]:.5f} ms, plain {ms[0]:.5f}/{ms[3]:.5f} ms, "
          f"index_add_ {lib:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}); launches "
          f"{steps['a']['segment_sum']} in arm (a)'s {SP_STEPS} steps, {steps['c']['segment_sum']} "
          f"in arm (c)'s, {serving['a']['segment_sum']} serving arm (a)")
    # K10f / K10b on the molecules' own edges, dim 64, fourier 4, gate_feats_only
    case = pair_case(torch, SEED + 950 + G, b=1, n=n, k=SP_K, d=SP_DIM, fourier=4, clamp=None,
                     gfo=True)
    case.update(coors=mb.x[None, :, :3].contiguous(),
                idx=mb.edge_index[0].reshape(1, n, SP_K).contiguous(),
                pv=mb.edge_mask.reshape(1, n, SP_K).contiguous())
    e_f, e_b = check_pair_kernels(torch, PM, f"anchor5_G{G}", case, False)
    sp_err["fused_pair_fwd"] = max(sp_err["fused_pair_fwd"], e_f)
    sp_err["fused_pair_bwd"] = max(sp_err["fused_pair_bwd"], e_b)
    args, weights, opts = pair_args(torch, PM, case, False, torch.float32)
    g = (case["g_mi"], case["g_cd"])

    def unfused_fwd_bwd():
        leaves = [a.detach().requires_grad_() if i in (0, 1, 2, 3) else a
                  for i, a in enumerate(args)]
        ws = [w.detach().requires_grad_() for w in weights]
        out = unfused_pipeline(torch, core, *leaves, ws, opts)
        return torch.autograd.grad(out, [t for t in leaves if t.requires_grad] + ws, g,
                                   allow_unused=True)

    with torch.no_grad():
        timed = {
            "fwd": (lambda: PM.fused_pair_messages_forward(*args, weights, opts),
                    lambda: PM.fused_pair_messages_plain(*args, weights, opts)),
            "bwd": (lambda: PM.fused_pair_messages_backward(*args, weights, *g, opts),
                    lambda: PM.fused_pair_messages_backward_plain(*args, weights, *g, opts)),
        }
        res = {}
        for key, (k, p) in timed.items():
            p_a, k_a = device_ms(torch, p, reps=5), device_ms(torch, k, reps=5)
            was = []
            if key == "bwd" and parent is not None:   # parent, parent between this one's
                parent_pm = parent_pair_messages(parent)
                with build.using("pair_messages",
                                 source_libraries({"parent": (parent, "")})["parent"]):
                    was = [device_ms(torch, lambda: parent_pm.fused_pair_messages_backward(
                        *args, weights, *g, opts), reps=5) for _ in range(2)]
            res[key] = (p_a, k_a, device_ms(torch, k, reps=5), device_ms(torch, p, reps=5), was)
        u_fwd = device_ms(torch, lambda: unfused_pipeline(torch, core, *args, weights, opts),
                          reps=5)
    u_both = device_ms(torch, unfused_fwd_bwd, reps=5)
    unfused = {"fwd": u_fwd, "bwd": u_both - u_fwd}
    for key, backward in (("fwd", False), ("bwd", True)):
        rows = (PM._bwd_tile_rows(SP_K, 3, SP_DIM, SP_HIDDEN, 16, 64, 4, False) if backward else
                PM._fwd_tile_rows(1, n, SP_K, 3, SP_DIM, SP_HIDDEN, 16, 64, 4, False, sms))
        by_layout = (PM._bwd_blocks_per_sm(rows, 3, SP_DIM, SP_HIDDEN, 16, 64, 4, False)
                     if backward else None)
        _, grid = PM.launch_grid(1, n, SP_K, rows, backward, "cuda", by_layout)
        per_sm = PM.kernel_blocks_per_sm(rows, SP_K, 3, SP_DIM, SP_HIDDEN, 16, 64, 4, False,
                                         False, backward)
        p_a, k_a, k_b, p_b, was = res[key]
        bound_ms, bound_by, t_bytes, t_ops = pair_bound(1, n, SP_K, 3, SP_DIM, SP_HIDDEN, 16, 4,
                                                        False, False, backward)
        name = f"fused_pair_{key}"
        print(f"sparse timing {name} G={G} (n={n} k={SP_K} d={SP_DIM} h={SP_HIDDEN} fourier 4, "
              f"gate_feats_only, the molecules' edges): kernel {k_a:.5f}/{k_b:.5f} ms, plain "
              f"{p_a:.5f}/{p_b:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}; bytes "
              f"{t_bytes:.6f} ms, operations {t_ops:.6f} ms); the unfused pipeline of torch "
              f"operators on the same pairs {unfused[key]:.5f} ms"
              f"{' (its fwd+bwd less its forward)' if backward else ''}; {steps['c'][name]} "
              f"launches in arm (c)'s {SP_STEPS} steps; max err against float64 "
              f"{sp_err[name]:.3e}; a tile of {rows} rows, a grid of {grid} blocks, {per_sm} "
              f"blocks an SM" + (f"; the parent's {was[0]:.5f}/{was[1]:.5f} ms (its own tile "
                                 f"and grid)" if was else ""))
        if backward and (by_layout != per_sm or (rows, per_sm) != (32, 1)):
            raise AssertionError(f"K10b at anchor 5's widths: a tile of {rows} rows at {per_sm} "
                                 f"blocks an SM ({by_layout} by the layout), not 32 rows at one")
    if G != SP_G:
        return
    # the f32 K10b's instances of one block an SM (this one among them)
    one_block = ptxas_kernels(build, "pair_messages", r"pair_bwd_kernelILb.ELi.ELb0ELi1ELi\d+EE")
    for kname, regs, st, ld in one_block:
        print(f"ptxas {kname}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    if len(one_block) != 4 or any(st or ld for _, _, st, ld in one_block):
        raise AssertionError("the f32 K10b's four one-block instances are not all built "
                             "without spills")


# phase 43 (K10's tensor-core mode). Served outputs under "medium" against
# "highest", each tensor's largest
# |difference| over its largest value: the mode moves the layers' messages by
# bf16 roundings, and "medium" lets cuBLAS round the rest of the network's
# products too (measured: 2.0e-7 at anchor 3, whose messages the init's
# small weights keep small, and 7.0e-3 in arm (c); H100, PERF.md)
MODE_GAP = 5e-2
# the served outputs under a rotation and a shift in the mode (the motion
# itself in exact f32): the moved inputs round to other bf16 values, in K10
# and in the "medium" cuBLAS products around it. The coordinates'
# equivariance (measured: 1.1e-5 at anchor 3, 1.6e-4 in arm (c)) and the
# features' invariance (0 and 2.3e-2; H100, PERF.md)
MODE_EQUIVARIANCE_ATOL = 1e-3
MODE_FEATS_INVARIANCE_ATOL = 1e-1
MODE_STEPS = 5
# The bits of K10f in the mode and of the f32 K10f and K10b at phase 43's
# four cases: the f32 kernels' as they have been since before the mode's K10b
# moved onto the tensor cores, K10f in the mode's as its redesign (which sums
# as K10b's recomputation) gives them: the first 16 hex digits of the sha256
# of the outputs' bytes in the wrappers' order (K10f: m_i, coors_delta; K10b:
# d_coors, d_cj, d_fj, d_proj_i, the eleven weight gradients). H100 80GB
# HBM3, torch 2.11.0+cu128, CUDA 12.8; the cases come from the card's own
# generator. Anchor 5's two f32 K10b hashes are those of its 32-row tiles on
# a grid of one block an SM: the weight gradients' sums run over other tiles
# and grid rows than on the 8-row tiles at two blocks an SM they replace (the
# same at 4-7 register slots and at one or five h-wide columns).
MODE_KEPT_BITS = {
    "anchor3": {"fwd_bf16": "a71b8b40ddd818f8", "fwd_f32": "6e7c7768f9fb6295",
                "bwd_f32": "8ea5032019373dab"},
    "anchor5_G32": {"fwd_bf16": "16ab3d2a4c2496e9", "fwd_f32": "90e2f619edb7ff1c",
                    "bwd_f32": "2ad96cd6726a2ec0"},
    "anchor5_G512": {"fwd_bf16": "8a650e6a5817ab5a", "fwd_f32": "1cd395ff669282e5",
                     "bwd_f32": "a0e80f9f4639a88d"},
    "pathC": {"fwd_bf16": "c912aad0cb378ff4", "fwd_f32": "c02471ed6067436a",
              "bwd_f32": "aad98c4b1dba2952"},
}


# Phase 43 holds the mode's rule over phase 21's cases (with phase 21's
# seeds) and these narrow ones, which reach the rules' other branches: d = 4
# (fj @ Wj and its gradients stay f32), m = 4 (the gate's product, cmsg @
# cW1 and d_z2 @ W2^T stay f32), fourier 4 with both.
MODE_NARROW_CASES = [
    ("d4_m4_fourier4", dict(b=1, n=400, k=8, d=4, m=4, fourier=4)),
    ("d4_fourier0_soft", dict(b=2, n=301, k=8, d=4, soft=True)),
    ("m4_d32", dict(b=1, n=500, k=8, d=32, m=4)),
]
# A case that misses the rule outright may pass it on its tie-free rerun:
# the same case with pv = 0 at the pairs whose result may part between two
# summation orders (``pair_messages.mode_tie_pairs``), which then add exactly
# zero to every output and gradient, held to the unchanged rule. The rerun
# may take out at most this share of the case's live pairs, and three
# controls, each with as many live pairs that are no ties taken out at
# random, must still miss (``mode_rule``): the pass has to come from the
# tie pairs, not from the share. The tie finder reads the plain versions
# alone, so which pairs go is fixed before the kernel runs; a case is rerun
# only where it misses outright, and 14 of the 18 pass with no pair taken
# out. What the rerun cannot tell apart is a kernel that rounds a value
# within reach of a bf16 boundary the other way: there a defect and a tie
# look alike. Its reach has to be wide: taking out the f32 plain version's
# own flips tightens the limit, and a kernel's flip left in then fails it.
# At the reach used (4x the float32 orders' distance) it takes out 3.1% to
# 18.6% of the cases' pairs, and the four that miss outright need 10.9% to
# 16.9%; at 1x (0.8% to 5.7%) two cases fail their rerun (H100, PERF.md;
# tools/k10_mode_probe.py reach).
TIE_SHARE_MAX = 0.20


def case_ties(torch, PM, case):
    """(rounding, clamp) tie pairs of a K10 case in the mode, (b, n, k)."""
    args, weights, opts = pair_args(torch, PM, case, False, torch.float64)
    return PM.mode_tie_pairs(*args, weights, case["g_mi"], case["g_cd"], opts)


def mode_rule(torch, PM, name, case):
    """Phase 43's rule on ``case`` with the kernels now loaded: the kernel in
    the mode outright and on the tie-free rerun (the tie pairs' pv set to 0,
    at most TIE_SHARE_MAX of the live pairs); where it misses outright, the
    rerun's controls, the same case with as many live pairs that are no ties
    set to 0 (three draws), which must each still miss: taking out as many
    pairs at random must not clear the case. Returns ``passed``
    ("outright", "tie-free" or "no"), the reports of ``check_pair_kernels``
    (``outright``, ``rerun``, ``controls``), the tie masks and the share
    taken out."""
    outright, rerun = {}, {}
    check_pair_kernels(torch, PM, name, case, False, mxu_bf16=True, report=outright)
    rounding, clamp = case_ties(torch, PM, case)
    ties = rounding | clamp
    live = case["pv"].bool()
    share = int(ties.sum()) / max(int(live.sum()), 1)
    check_pair_kernels(torch, PM, f"{name}, tie-free", dict(case, pv=live & ~ties), False,
                       mxu_bf16=True, report=rerun)
    out = dict(outright=outright, rerun=rerun, controls=[], rounding=rounding, clamp=clamp,
               share=share, passed="outright")
    if not outright["failed"]:
        return out
    others = torch.nonzero((live & ~ties).reshape(-1)).reshape(-1)
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(3):
        drop = others[torch.randperm(others.numel(), generator=gen)[:int(ties.sum())]
                      .to(others.device)]
        pv = live.reshape(-1).clone()
        pv[drop] = False
        out["controls"].append({})
        check_pair_kernels(torch, PM, f"{name}, control", dict(case, pv=pv.reshape(live.shape)),
                           False, mxu_bf16=True, report=out["controls"][-1])
    cleared = (not rerun["failed"] and share <= TIE_SHARE_MAX
               and all(c["failed"] for c in out["controls"]))
    out["passed"] = "tie-free" if cleared else "no"
    return out


def clamp_flip(torch, PM, case, report):
    """Whether d_cb2's error is one pair's clamp flipping: a pair that the
    kernel and float64 take to opposite sides of the clamp adds its d_w * pv
    to d_cb2 on one side only, and its d_cj row moves by its w * g_cd. Finds
    the pair whose d_cj row parts most from float64. Returns (d_cb2's error,
    that pair's d_w * pv, its wz * pv) in float64, and the pair's index."""
    args, weights, opts = pair_args(torch, PM, case, False, torch.float64)
    coors, cj, fj, proj_i, pv = args
    n = coors.shape[1]
    pv4 = PM._pairs(pv, n)
    t = PM._tile_forward(coors, PM._pairs(cj, n), PM._mm(PM._pairs(fj, n), weights[0], opts),
                         proj_i, pv4, weights[1:], opts._replace(mxu_bf16=True))
    d_wz = ((case["g_cd"].double()[:, :, None, :] * t["rel_n"]).sum(-1, keepdim=True) * pv4)
    at = {name: i for i, name in enumerate(report["names"])}
    err = (report["kernel"][at["d_cb2"]].double() - report["ref"][at["d_cb2"]]).reshape(()).item()
    rows = (report["kernel"][at["d_cj"]].double() - report["ref"][at["d_cj"]]).abs().sum(-1)
    p = int(rows.reshape(-1).argmax())
    return err, d_wz.reshape(-1)[p].item(), t["wm"].reshape(-1)[p].item(), p


def bits_digest(tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kept_bits(torch, PM, case):
    """(K10f in the mode, the f32 K10f, the f32 K10b) on ``case`` as
    ``bits_digest``s, keyed as ``MODE_KEPT_BITS``."""
    args, weights, opts = pair_args(torch, PM, case, False, torch.float32)
    g = (case["g_mi"], case["g_cd"])
    with torch.no_grad():
        d_ci, d_cj, d_fj, d_pi, d_w = PM.fused_pair_messages_backward(*args, weights, *g, opts)
        return {"fwd_bf16": bits_digest(PM.fused_pair_messages_forward(
                    *args, weights, opts._replace(mxu_bf16=True))),
                "fwd_f32": bits_digest(PM.fused_pair_messages_forward(*args, weights, opts)),
                "bwd_f32": bits_digest([d_ci, d_cj, d_fj, d_pi, *d_w])}


def mode_bound(b, n, k, c, d, h, m, fourier, soft, backward):
    """(bound_ms, bound_by) of K10 in the tensor-core mode: the bytes of
    ``pair_bound``; the operations of the MLP products the mode rounds
    (contraction at least 8: fj @ Wj, distf @ Wd, s1 @ W2, cmsg @ cW1) over
    the bf16 tensor-core peak, the rest (the one-column products, and
    distf @ Wd below fourier 4) over the f32 peak; three times over
    backward, as ``pair_bound`` counts."""
    from egnn_tpu_torch.utils.profiling import H100_SXM_BF16_TENSOR_FLOPS, H100_SXM_F32_FLOPS

    _, _, t_bytes, _ = pair_bound(b, n, k, c, d, h, m, fourier, soft, False, backward)
    dd, pairs = 2 * fourier + 1, b * n * k
    tensor = sum(w for w, contraction in ((d * h, d), (dd * h, dd), (h * m, h), (m * 4 * m, m))
                 if contraction >= 8)
    rest = d * h + dd * h + h * m + (m if soft else 0) + m * 4 * m + 4 * m - tensor
    scale = 2 * pairs * (3 if backward else 1) * 1e3
    t_ops = scale * (tensor / H100_SXM_BF16_TENSOR_FLOPS + rest / H100_SXM_F32_FLOPS)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def source_libraries(copies):
    """Other copies of ``csrc/pair_messages.cu`` (a parent checkout's, or one
    with probe points defined), ``{tag: (path, text placed before it)}``,
    each built with the package's flags into ``build/`` under a name taken
    from its text, all ``nvcc`` started together, and loaded: ``{tag:
    library}``, to be launched through ``build.using``. What ptxas reported
    lies beside each library as ``.log``."""
    import ctypes

    from egnn_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets, procs = {}, {}
    for tag, (source, prelude) in copies.items():
        text = prelude + Path(source).read_text()
        digest = hashlib.sha256((text + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()
        target = targets[tag] = build.BUILD_DIR / f"copy_{digest[:16]}.so"
        if not target.exists():
            copy = target.with_suffix(".cu")
            copy.write_text(text)
            procs[tag] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), str(copy)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for tag, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the copy {tag}:\n{out[-4000:]}")
        targets[tag].with_suffix(".log").write_text(out)
    return {tag: ctypes.CDLL(str(target)) for tag, target in targets.items()}


def parent_pair_messages(source):
    """A parent checkout's ``ops/cuda/pair_messages.py``, found beside its
    ``csrc/pair_messages.cu`` (``source``) and loaded as a module of this
    package: its wrappers size the parent's launches by the parent's own
    rules (tile, grid). Launch them inside ``build.using`` with the parent's
    library (``source_libraries``)."""
    import importlib.util

    path = Path(source).resolve().parents[1] / "ops" / "cuda" / "pair_messages.py"
    spec = importlib.util.spec_from_file_location(
        "egnn_tpu_torch.ops.cuda.parent_pair_messages", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def mode_phase(torch, smi, parent=None):
    """Phase 43: K10 in its tensor-core mode (``mxu_bf16``, reached by
    ``torch.set_float32_matmul_precision("medium")`` on the card): the
    kernels at anchor 3's, anchor 5's (G = 32, 512) and path C's shapes
    against their plain versions in the mode (``check_pair_kernels``; the
    mode's backward on its own tile) and K10f in the mode and the f32 K10
    kernels against their kept bits (``MODE_KEPT_BITS``); the same rule
    over phase 21's cases and the narrow ones, outright or on the tie-free
    rerun; then the anchor-3 ``fused_pairs`` network and anchor 5's arm (c)
    served and trained under "medium" (the mode's launch counts; outputs
    against "highest"; equivariance), then the mode's kernels timed beside
    the f32 ones (and K10f beside a ``parent`` checkout's source, where
    given: ``source_libraries``).
    Returns the kernels line's two rows."""
    import numpy as np

    from egnn_tpu_torch import EGNNNetwork, EGNNSparseNetwork
    from egnn_tpu_torch.ops import core
    from egnn_tpu_torch.ops import graph as GR
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from egnn_tpu_torch.ops.cuda import pair_messages as PM
    from egnn_tpu_torch.training import (make_adam, make_denoise_train_step, make_fused_adam,
                                         masked_mse)
    from egnn_tpu_torch.training.data import synthetic_chain_batch

    t_start = time.perf_counter()
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("phase 43 starts from the default precision, \"highest\"")
    # ---- 43a. the kernels in the mode at the paths' shapes ----
    shapes = {  # name: (what, pair_case arguments, (reps, trials))
        "anchor3": (f"anchor 3's shape (b=1 n={N} k={KNN}, mask, self pairs)",
                    dict(b=1, n=N, k=KNN, self_pairs=True), (20, 7)),
        "anchor5_G32": (f"anchor 5's shape at G = {SP_G} (d={SP_DIM}, fourier 4, h={SP_HIDDEN}, "
                        f"gate_feats_only)", dict(b=1, n=SP_G * SP_NA, k=SP_K, d=SP_DIM,
                                                  fourier=4, clamp=None, gfo=True), (20, 7)),
        "anchor5_G512": (f"anchor 5's shape at G = {SP_G_LARGE}",
                         dict(b=1, n=SP_G_LARGE * SP_NA, k=SP_K, d=SP_DIM, fourier=4, clamp=None,
                              gfo=True), (5, 5)),
        "pathC": (f"path C's shape (n={N_A} k={KNN_A}, no mask, self pairs)",
                  dict(b=1, n=N_A, k=KNN_A, masked=False, self_pairs=True), (3, 5)),
    }
    cases, mode_err = {}, {}
    for i, (name, (what, kw, _)) in enumerate(shapes.items()):
        cases[name] = pair_case(torch, SEED + 1900 + i, **kw)
        # the backward's tile, the f32 one's too: two blocks an SM where they
        # hold one of 16 rows or more, else the largest that one block holds
        case = cases[name]
        b, n, k = case["idx"].shape
        d, h = case["feats"].shape[-1], case["proj_i"].shape[-1]
        widths = (3, d, h, 16, 64, case["opts"]["fourier"], case["opts"]["soft_edges"])
        rows_m = PM._bwd_tile_rows(k, *widths)
        per_sm = PM._bwd_blocks_per_sm(rows_m, *widths)
        _, grid = PM.launch_grid(b, n, k, rows_m, True, "cuda", per_sm)
        layout = (rows_m, *widths)
        if PM._smem_floats(*layout, True) != PM.kernel_smem_floats(*layout, True):
            raise AssertionError(f"phase 43 {name}: the wrapper's layout {layout} differs from "
                                 f"the source's")
        occupancy = PM.kernel_blocks_per_sm(rows_m, k, *widths, False, True, mxu_bf16=True)
        print(f"phase 43 {name}: the mode's K10b on {rows_m}-row tiles (as the f32 one), "
              f"{per_sm} blocks an SM by the layout ({occupancy} by the occupancy calculator), "
              f"a grid of {grid}")
        if per_sm != occupancy or (name.startswith("anchor5") and (rows_m, per_sm) != (32, 1)):
            raise AssertionError(f"phase 43 {name}: the mode's backward tile is not the rule's")
        mode_err[name] = check_pair_kernels(torch, PM, what, case, False, mxu_bf16=True)
        bits = kept_bits(torch, PM, case)
        print(f"phase 43 {name}: K10f in the mode and the f32 K10f, K10b give {bits} (kept: "
              f"{MODE_KEPT_BITS[name]})")
        if bits != MODE_KEPT_BITS[name]:
            raise AssertionError(f"phase 43 {name}: K10f in the mode or an f32 kernel changed "
                                 f"its bits")
        del case
        torch.cuda.empty_cache()
    print(f"(phase 43 so far: {time.perf_counter() - t_start:.1f} s)")

    # ---- 43a, continued: the same rule over phase 21's cases and the narrow
    # ones, outright or on the tie-free rerun (TIE_SHARE_MAX) ----
    missed = []
    for i, (name, kw) in enumerate(pair_cases() + MODE_NARROW_CASES):
        case = pair_case(torch, SEED + 200 + i, **kw)
        rule = mode_rule(torch, PM, name, case)
        outright, rerun, rounding, clamp = (rule[k] for k in ("outright", "rerun", "rounding",
                                                              "clamp"))
        ties = rounding | clamp
        line = (f"phase 43 rule {name}: {int(rounding.sum())} rounding ties, {int(clamp.sum())} "
                f"clamp ties, {int(ties.sum())} pairs of {int(case['pv'].sum())} live "
                f"({rule['share']:.3%}, at most {TIE_SHARE_MAX:.0%}); outright "
                f"{outright['ratio']:.3f} of the limit ({outright['tensor']}), an element at "
                f"{outright['reach']:.2e} of its largest, the f32 kernel at "
                f"{outright['miss'][0]:.2f} / {outright['miss'][1]:.2f} (forward / backward)")
        line += (f"; tie-free {rerun['ratio']:.3f} ({rerun['tensor']}), {rerun['reach']:.2e}, "
                 f"the f32 kernel at {rerun['miss'][0]:.2f} / {rerun['miss'][1]:.2f}")
        if rule["controls"]:
            line += "; controls (as many other pairs out) at " + ", ".join(
                f"{c['ratio']:.3f} ({c['tensor']})" for c in rule["controls"])
        print(f"{line}; passed: {rule['passed']}")
        for what, rep in (("outright", outright), ("tie-free", rerun)):
            if rep["failed"]:
                print(f"  {what}: {'; '.join(rep['failed'])}")
        if outright["failed"] and case["opts"]["clamp"] is not None:
            err, flip, wm, p = clamp_flip(torch, PM, case, outright)
            print(f"  d_cb2 differs from float64 by {err:+.6f}; the pair whose d_cj parts most "
                  f"({p}; a rounding tie: {bool(rounding.reshape(-1)[p])}, a clamp tie: "
                  f"{bool(clamp.reshape(-1)[p])}) has d_w * pv = {flip:+.6f} and wz * pv = "
                  f"{wm:+.6f} against the clamp {case['opts']['clamp']}")
        if rule["passed"] == "no":
            missed.append(name)
        del case, rule
        torch.cuda.empty_cache()
    if missed:
        raise AssertionError(f"phase 43: the mode's kernels miss the rule at {missed}, outright "
                             f"and on the tie-free rerun (or a control cleared too)")
    print(f"(phase 43 so far: {time.perf_counter() - t_start:.1f} s)")

    # ---- 43b. the fused layers under "medium": served and trained ----
    rng = np.random.default_rng(SEED + 43)
    requests = ([synthetic_chain_batch(rng, 1, N, device="cuda") for _ in range(3)]
                + [synthetic_chain_batch(rng, 8, N, device="cuda")])
    layer = {**LAYER_KWARGS, "fused_pairs": True}

    def anchor3(seed=SEED):
        return EGNNNetwork(depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
                           layer_kwargs=layer, device="cuda",
                           generator=torch.Generator().manual_seed(seed))

    def serve3(net, rq, coors=None):
        return net(rq.tokens, rq.noised_coors if coors is None else coors, adj_mat=rq.adj_mat,
                   mask=rq.mask)

    def sparse_net(seed=SEED):
        return EGNNSparseNetwork(**SP_NET, **SP_ARMS["c"], device="cuda",
                                 generator=torch.Generator().manual_seed(seed))

    def serve5(net, mb, x=None):
        es = GR.knn_graph(mb.x[:, :3] if x is None else x[:, :3], SP_K, node_mask=mb.node_mask,
                          graph_size=SP_NA)
        return net(mb.x if x is None else x, es.edge_index, batch=mb.batch_ids,
                   edge_mask=es.mask, num_graphs=mb.target.shape[0], node_mask=mb.node_mask)

    molecules = [molecule_batch(torch, GR.knn_graph, SP_G, SEED + 4300 + i) for i in range(3)]
    nets = {"anchor 3": anchor3().eval(), "arm (c)": sparse_net().eval()}
    runs = {"anchor 3": (lambda net: [tuple(serve3(net, rq)) for rq in requests], DEPTH,
                         len(requests)),
            "arm (c)": (lambda net: [(serve5(net, mb),) for mb, _ in molecules], SP_LAYERS,
                        len(molecules))}
    served, launches = {}, {}
    for precision in ("highest", "medium"):
        with matmul_precision(torch, precision):
            for path, net in nets.items():
                serve_all, depth, calls = runs[path]
                reset_launch_counts()
                with torch.inference_mode():
                    served[path, precision] = serve_all(net)
                torch.cuda.synchronize()
                counts = dict(LAUNCH_COUNTS)
                launches[path, precision] = counts
                mode_on = precision == "medium"
                want = {"fused_pair_fwd_bf16" if mode_on else "fused_pair_fwd": depth * calls,
                        "fused_pair_fwd" if mode_on else "fused_pair_fwd_bf16": 0}
                print(f"phase 43 {path} served under \"{precision}\": {calls} calls, launches "
                      f"{ {k: v for k, v in counts.items() if v} }")
                if any(counts[k] != v for k, v in want.items()):
                    raise AssertionError(f"phase 43 {path} under {precision}: K10f's launches "
                                         f"are not {want}")
    gaps = {}
    for path in nets:
        gap = 0.0
        for outs_m, outs_h in zip(served[path, "medium"], served[path, "highest"]):
            check_outputs(torch, outs_m, tuple(t.shape for t in outs_h), f"phase 43 {path}")
            gap = max(gap, *(((a - b_).abs().max() / b_.abs().max()).item()
                             for a, b_ in zip(outs_m, outs_h)))
        gaps[path] = gap
        print(f"phase 43 {path}: served outputs under \"medium\" against \"highest\": largest "
              f"|difference| {gap:.3e} of the largest value (> 0, tol {MODE_GAP})")
        if not 0.0 < gap <= MODE_GAP:
            raise AssertionError(f"phase 43 {path}: the mode's outputs are not within the bf16 "
                                 f"gap of the f32 ones, or equal to them")
    equivariance = {}
    with matmul_precision(torch, "medium"):
        rq = requests[0]
        equivariance["anchor 3"] = check_equivariance(
            torch, lambda c: serve3(nets["anchor 3"], rq, c), rq.noised_coors,
            "phase 43 anchor 3 under \"medium\"", atol=MODE_EQUIVARIANCE_ATOL,
            feats_atol=MODE_FEATS_INVARIANCE_ATOL)
        mb0 = molecules[0][0]

        def moved(c):
            o = serve5(nets["arm (c)"], mb0, torch.cat([c, mb0.x[:, 3:]], dim=-1))
            return o[:, 3:], o[:, :3]

        equivariance["arm (c)"] = check_equivariance(
            torch, moved, mb0.x[:, :3].contiguous(), "phase 43 arm (c) under \"medium\"",
            atol=MODE_EQUIVARIANCE_ATOL, feats_atol=MODE_FEATS_INVARIANCE_ATOL)
        # five train steps each, on one batch
        net3 = anchor3(SEED + 5)
        step3 = make_denoise_train_step(net3, make_fused_adam(net3.parameters(), LR))
        rq8 = requests[-1]
        net5 = sparse_net(SEED + 5)
        opt5 = make_adam(net5.parameters(), LR)
        mb, clean = molecules[0]

        def step5():
            opt5.zero_grad(set_to_none=True)
            es = GR.knn_graph(mb.x[:, :3], SP_K, node_mask=mb.node_mask, graph_size=SP_NA)
            out = net5(mb.x, es.edge_index, batch=mb.batch_ids, edge_mask=es.mask,
                       num_graphs=mb.target.shape[0], node_mask=mb.node_mask)
            loss = masked_mse(out[:, :3], clean, mb.node_mask)
            loss.backward()
            opt5.step()
            return loss.detach()

        for path, step, depth in (
                ("anchor 3", lambda: step3(rq8.tokens, rq8.noised_coors, rq8.clean_coors,
                                           rq8.adj_mat, rq8.mask), DEPTH),
                ("arm (c)", step5, SP_LAYERS)):
            reset_launch_counts()
            losses = torch.stack([step() for _ in range(MODE_STEPS)]).cpu()
            torch.cuda.synchronize()
            counts = dict(LAUNCH_COUNTS)
            launches[path, "steps"] = counts
            print(f"phase 43 {path} under \"medium\": {MODE_STEPS} train steps, losses "
                  f"{losses.tolist()}; launches { {k: v for k, v in counts.items() if v} }")
            want = {"fused_pair_fwd_bf16": depth * MODE_STEPS,
                    "fused_pair_bwd_bf16": depth * MODE_STEPS,
                    "fused_pair_fwd": 0, "fused_pair_bwd": 0}
            if any(counts[k] != v for k, v in want.items()):
                raise AssertionError(f"phase 43 {path}: the train steps' K10 launches are not "
                                     f"{want}")
            if not (bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]):
                raise AssertionError(f"phase 43 {path}: the loss is not finite or did not fall")
    del nets, net3, step3, net5, opt5
    torch.cuda.empty_cache()
    print(f"(phase 43 so far: {time.perf_counter() - t_start:.1f} s)")

    # ---- 43c. the mode's kernels timed beside the f32 ones ----
    from egnn_tpu_torch.ops.cuda import build
    parent_lib = source_libraries({"parent": (parent, "")})["parent"] if parent else None
    rows = []
    for name, (what, kw, (reps, trials)) in shapes.items():
        case = cases[name]
        args, weights, opts = pair_args(torch, PM, case, False, torch.float32)
        mode = opts._replace(mxu_bf16=True)
        g = (case["g_mi"], case["g_cd"])
        b, n, k = case["idx"].shape
        d, h = case["feats"].shape[-1], case["proj_i"].shape[-1]
        fourier, soft = case["opts"]["fourier"], case["opts"]["soft_edges"]
        t = {}
        with torch.no_grad():
            for key, kernel, plain in (
                    ("fwd", lambda o: PM.fused_pair_messages_forward(*args, weights, o),
                     lambda o: PM.fused_pair_messages_plain(*args, weights, o)),
                    ("bwd", lambda o: PM.fused_pair_messages_backward(*args, weights, *g, o),
                     lambda o: PM.fused_pair_messages_backward_plain(*args, weights, *g, o))):
                f32_a = device_ms(torch, lambda: kernel(opts), reps=reps, trials=trials)
                mode_a = device_ms(torch, lambda: kernel(mode), reps=reps, trials=trials)
                was = []
                if key == "fwd" and parent_lib is not None:   # parent, parent between this one's
                    with build.using("pair_messages", parent_lib):
                        was = [device_ms(torch, lambda: kernel(mode), reps=reps, trials=trials)
                               for _ in range(2)]
                mode_b = device_ms(torch, lambda: kernel(mode), reps=reps, trials=trials)
                f32_b = device_ms(torch, lambda: kernel(opts), reps=reps, trials=trials)
                plain_ms = device_ms(torch, lambda: plain(mode), reps=reps, trials=trials)
                t[key] = (min(mode_a, mode_b), (mode_a, mode_b), (f32_a, f32_b), plain_ms, was)
        with matmul_precision(torch, "medium"):
            with torch.no_grad():
                u_fwd = device_ms(torch, lambda: unfused_pipeline(torch, core, *args, weights,
                                                                  opts), reps=reps, trials=trials)

            def unfused_fwd_bwd():
                leaves = [a.detach().requires_grad_() if i in (0, 1, 2, 3) else a
                          for i, a in enumerate(args)]
                ws = [w.detach().requires_grad_() for w in weights]
                out = unfused_pipeline(torch, core, *leaves, ws, opts)
                return torch.autograd.grad(out, [x for x in leaves if x.requires_grad] + ws, g,
                                           allow_unused=True)

            u_both = device_ms(torch, unfused_fwd_bwd, reps=reps, trials=trials)
        unfused = {"fwd": u_fwd, "bwd": u_both - u_fwd}
        for key, backward in (("fwd", False), ("bwd", True)):
            ms, (m_a, m_b), (f_a, f_b), plain_ms, was = t[key]
            bound_ms, bound_by = mode_bound(b, n, k, 3, d, h, 16, fourier, soft, backward)
            tiles = (PM._bwd_tile_rows(k, 3, d, h, 16, 64, fourier, soft) if backward else
                     PM._fwd_tile_rows(b, n, k, 3, d, h, 16, 64, fourier, soft,
                                       torch.cuda.get_device_properties(0).multi_processor_count))
            per_sm = PM.kernel_blocks_per_sm(tiles, k, 3, d, h, 16, 64, fourier, soft, False,
                                             backward, mxu_bf16=True)
            parent_ms = f"; the parent's {was[0]:.5f}/{was[1]:.5f} ms" if was else ""
            print(f"phase 43 timing fused_pair_{key}_bf16 at {what}: mode {m_a:.5f}/{m_b:.5f} ms "
                  f"beside f32 {f_a:.5f}/{f_b:.5f} ms{parent_ms} (CUDA graph replays, one card: "
                  f"{smi}); "
                  f"plain in the mode {plain_ms:.5f} ms; the unfused pipeline under \"medium\" "
                  f"{unfused[key]:.5f} ms{' (its fwd+bwd less its forward)' if backward else ''}; "
                  f"bound {bound_ms:.6f} ms ({bound_by}); a tile of {tiles} rows, {per_sm} blocks "
                  f"an SM")
            if name == "anchor3":   # the JSON line's rows: anchor 3's shape, as K10's
                main = launches["anchor 3", "medium" if key == "fwd" else "steps"]
                rows.append({
                    "name": f"fused_pair_{key}_bf16", "route": "cuda",
                    "source": "egnn_tpu_torch/csrc/pair_messages.cu",
                    "replaces": ("egnn_tpu/ops/pallas/pair_messages.py:379" if key == "fwd"
                                 else "egnn_tpu/ops/pallas/pair_messages.py:425"),
                    "launches": main[f"fused_pair_{key}_bf16"],
                    "max_abs_err": mode_err[name][backward],   # against float64
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    # no single PyTorch call computes the pipeline: the unfused
                    # layer's torch operators under "medium"
                    "library_ms": unfused[key],
                })
        del case, args, weights
        torch.cuda.empty_cache()
    print(f"phase 43 (the tensor-core mode): {time.perf_counter() - t_start:.1f} s; equivariance "
          f"{equivariance}; outputs' gap {gaps}")
    return rows


# phase 44: the dense step sharded over nodes (the mesh's graph axis): the
# row-block mode of K1, K3 and K4, then anchor 3's step at b = 8 on a
# (data, graph) = (1, 2) mesh of two ranks sharing the card
GRAPH_STEPS = 5
N_K4_ROWS = 20000   # K4's row block: an (n, n) adjacency of 400 MB
GRAPH_TIMEOUT = 300  # seconds for both ranks of phase 44b to report


def knn_rows_bound(b, n, rows, c, k, tw, with_mask, adj_bytes):
    """(bound_ms, bound_by) of a row-block selection of ``rows`` of the n
    points: the whole table's coordinates, mask and payload read once, the
    block's adjacency rows (``adj_bytes``) once, its outputs written once;
    the operations of its rows * n pairs (``knn_bound_parts``' count)."""
    nbytes = (4 * b * n * c + (b * n if with_mask else 0) + adj_bytes + 4 * b * n * tw
              + b * rows * k * (4 + 8) + 4 * b * rows * k * tw)
    t_bytes, t_ops = bound_parts_ms(nbytes, b * rows * n * (3 * c + 3))
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


GRAPH_FLAGS = (None, "fused_pairs", "fused_knn")   # 44b's layer paths


def graph_run(torch, net_seed, batch, mesh=None, flag=None):
    """GRAPH_STEPS anchor-3 steps (flat-buffer Adam) on ``batch``, the
    layers unfused or with the fused ``flag``: with ``mesh`` a (data, graph)
    mesh, this rank's block through ``make_sharded_denoise_train_step`` (the
    nodes on the graph axis), else ``make_denoise_train_step`` on the whole
    batch. The losses, the first step's gradients, the final parameters,
    the launches over the steps, the first layer's selected indices in the
    first step, and the step."""
    from egnn_tpu_torch import EGNNNetwork, parallel
    from egnn_tpu_torch.ops import neighbors as nb
    from egnn_tpu_torch.ops.cuda import reset_launch_counts
    from egnn_tpu_torch.training import (make_denoise_train_step, make_fused_adam,
                                         make_sharded_denoise_train_step)

    net = EGNNNetwork(depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
                      layer_kwargs={**LAYER_KWARGS, **({flag: True} if flag else {})},
                      device="cuda",
                      generator=torch.Generator().manual_seed(net_seed))
    opt = make_fused_adam(net.parameters(), LR)
    if mesh is None:
        step, args = make_denoise_train_step(net, opt), batch
    else:
        step = make_sharded_denoise_train_step(net, opt, mesh)
        args = [parallel.dense_batch_block(mesh, t) for t in batch[:3]] + [
            batch[3], parallel.dense_batch_block(mesh, batch[4])]
    # the selections of the first step, recorded as the layers make them
    # (neighbors.knn_select goes through knn_select_gather)
    name = "knn_select_gather" if mesh is None else "knn_select_gather_rows"
    select, picked = getattr(nb, name), []

    def recording(*a, **kw):
        nbhd, g = select(*a, **kw)
        picked.append(nbhd.indices.clone())
        return nbhd, g

    losses, grads = [], None
    reset_launch_counts()
    for i in range(GRAPH_STEPS):
        if i == 0:
            setattr(nb, name, recording)
        try:
            losses.append(step(*args))
        finally:
            setattr(nb, name, select)
        if i == 0:
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for k, p in net.named_parameters()}
    launches = launches_now(torch)
    return dict(losses=torch.stack(losses), grads=grads, launches=launches,
                params={k: p.detach().clone() for k, p in net.named_parameters()},
                first_indices=picked[0], call=lambda: step(*args))


def graph_rank_main(rank, world, init_method, payload, queue):
    """Phase 44b's rank: gloo on cuda:0 (two ranks share the card), anchor
    3's step on a (1, 2) mesh, unfused, with ``fused_pairs`` and with
    ``fused_knn``, each timed as a call; results to the parent as numpy
    arrays."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from egnn_tpu_torch import parallel
        from egnn_tpu_torch.ops.cuda import build
        from egnn_tpu_torch.utils.profiling import time_fn

        build.build_all()      # built by the parent: loads the libraries
        parallel.initialize(backend="gloo", init_method=init_method, world_size=world,
                            rank=rank, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = parallel.make_mesh(1, world)
        batch = [t.cuda() for t in payload["dense"]]
        out = {}
        for flag in GRAPH_FLAGS:
            res = graph_run(torch, SEED + 44, batch, mesh, flag)
            res["ms"] = time_fn(res.pop("call"), reps=10, warmup=2, stat="median") * 1e3
            out[str(flag)] = res
        queue.put((rank, True, to_numpy(torch, out)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def k11_table_check(torch, smi):
    """K11 in its j-table form at anchor 3's rows on the graph axis: the
    rows R .. N - 1 (R = N / 2) of b = 8 clouds, each slot 0 its row's own
    node, against the whole cloud as the j table: forward and backward
    against the float64 plain versions by phase 21's rule (each tensor
    within 8x the float32 plain version's error plus 1e-5 of its largest
    value), three launches bitwise equal; then timed beside the plain
    versions and the bound. Returns the JSON line's entries (less their
    launches)."""
    from egnn_tpu_torch.ops.cuda import pair_messages as PM

    case = pair_case(torch, SEED + 445, b=DP_BATCH, n=N, k=KNN, self_pairs=True)
    R = N // 2
    sl = slice(R, N)
    opts = PM.PairOptions(**{**case["opts"], "gate_feats_only": False})

    def args(dtype):
        cast = lambda t: t.to(dtype)  # noqa: E731
        weights = tuple(cast(w) for w in case["weights"])
        coors = cast(case["coors"])
        return ((coors[:, sl].contiguous(), cast(case["proj_i"])[:, sl].contiguous(),
                 cast(case["feats"]) @ weights[0], case["idx"][:, sl].contiguous(),
                 case["pv"][:, sl].contiguous()), weights[1:], coors,
                (cast(case["g_mi"])[:, sl].contiguous(), cast(case["g_cd"])[:, sl].contiguous()))

    def flat(fwd, bwd):
        d_ci, d_pi, d_pj, d_w, d_cj = bwd
        return list(fwd) + [d_ci, d_pi, d_pj, d_cj] + list(d_w)

    names = (("m_i", "coors_delta", "d_coors_i", "d_proj_i", "d_proj_j", "d_coors_j")
             + tuple("d_" + w for w in PAIR_WEIGHT_NAMES[1:]))
    ref = {}
    for dtype in (torch.float64, torch.float32):
        a, w, cj, g = args(dtype)
        ref[dtype] = flat(PM.fused_knn_messages_plain(*a, w, opts, coors_j=cj),
                          PM.fused_knn_messages_backward_plain(*a, w, *g, opts, coors_j=cj))
    a, w, cj, g = args(torch.float32)
    runs = [flat(PM.fused_knn_messages_forward(*a, w, opts, coors_j=cj),
                 PM.fused_knn_messages_backward(*a, w, *g, opts, coors_j=cj)) for _ in range(3)]
    torch.cuda.synchronize()
    repeatable = all(same_bits(torch, x, y) for run in runs[1:] for x, y in zip(run, runs[0]))
    worst, errs = [], {"fwd": 0.0, "bwd": 0.0}
    for i, (tname, ker, p32, r64) in enumerate(zip(names, runs[0], ref[torch.float32],
                                                    ref[torch.float64])):
        e_k = (ker.double() - r64).abs().max().item()
        e_p = (p32.double() - r64).abs().max().item()
        limit = PAIR_ERR_FACTOR * e_p + PAIR_ERR_FLOOR * max(r64.abs().max().item(), 1e-30)
        errs["fwd" if i < 2 else "bwd"] = max(errs["fwd" if i < 2 else "bwd"], e_k)
        worst.append((e_k / limit, tname, e_k, e_p))
        if not (e_k <= limit and bool(torch.isfinite(ker).all())):
            raise AssertionError(f"phase 44a K11 j table: {tname} differs from the float64 plain "
                                 f"version by {e_k:.3e}, the float32 plain version by "
                                 f"{e_p:.3e} (limit {limit:.3e})")
    ratio, tname, e_k, e_p = max(worst)
    print(f"phase 44a K11 with a j table: the rows {R}..{N - 1} of b = {DP_BATCH} clouds of {N} "
          f"(k = {KNN}, slot 0 the row's own node) against the whole cloud: forward max err "
          f"{errs['fwd']:.3e}, backward {errs['bwd']:.3e} against float64; nearest its limit "
          f"{tname} ({e_k:.3e}, plain f32 {e_p:.3e}, {ratio:.3f} of the limit); 3 launches "
          f"bitwise={repeatable}")
    if not repeatable:
        raise AssertionError("phase 44a K11 j table: launches are not bitwise repeatable")
    h = a[1].shape[-1]
    extra_ms = bound_parts_ms(4 * DP_BATCH * (N - R) * (h + 3), 0)[0]   # the rest of the table
    out = {}
    with torch.no_grad():
        for key, kernel_fn, plain_fn in (
                ("fwd", lambda: PM.fused_knn_messages_forward(*a, w, opts, coors_j=cj),
                 lambda: PM.fused_knn_messages_plain(*a, w, opts, coors_j=cj)),
                ("bwd", lambda: PM.fused_knn_messages_backward(*a, w, *g, opts, coors_j=cj),
                 lambda: PM.fused_knn_messages_backward_plain(*a, w, *g, opts, coors_j=cj))):
            p_a, k_a, k_b, p_b = (device_ms(torch, plain_fn), device_ms(torch, kernel_fn),
                                  device_ms(torch, kernel_fn), device_ms(torch, plain_fn))
            _, _, t_bytes, t_ops = pair_bound(DP_BATCH, R, KNN, 3, DIM, h, 16, 0, False, True,
                                              key == "bwd")
            t_bytes += extra_ms * (2 if key == "bwd" else 1)
            bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                                       else "operations")
            print(f"timing on {smi}: fused_knn_{key}_table at b = {DP_BATCH}, {R} rows of {N}, "
                  f"k = {KNN}: kernel {k_a:.5f}/{k_b:.5f} ms"
                  f"{' (K2 on the j-side rows included)' if key == 'bwd' else ''}, plain "
                  f"{p_a:.5f}/{p_b:.5f} ms, bound {bound_ms:.6f} ms ({bound_by})")
            out[key] = {
                "name": f"fused_knn_{key}_table", "route": "cuda",
                "source": "egnn_tpu_torch/csrc/pair_messages.cu",
                "replaces": ("egnn_tpu/ops/pallas/knn_layer.py:380" if key == "fwd"
                             else "egnn_tpu/ops/pallas/knn_layer.py:419"),
                "max_abs_err": errs[key], "ms": min(k_a, k_b), "plain_ms": min(p_a, p_b),
                "bound_ms": bound_ms, "bound_by": bound_by,
                # no single PyTorch call computes the pipeline
                "library_ms": None,
            }
    return out


def graph_axis_phases(torch, smi):
    """Phase 44: the row-block mode of K1, K3 and K4 on the card (44a), then
    the slice's path, anchor 3's step sharded over nodes on two ranks (44b).
    Returns the JSON line's entry of the row-block K1; raises on a
    failure."""
    import shutil
    import tempfile

    import numpy as np

    from egnn_tpu_torch.ops.cuda import knn as K
    from egnn_tpu_torch.training import synthetic_chain_batch

    t_start = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # ---- 44a. the row blocks against the whole launches and the plain versions ----
    max_err = 0.0
    for ties in (False, True):
        coors, mask, adj, table = knn_inputs(torch, DP_BATCH, N, KNN, True, True, ties,
                                             SEED + 440 + ties)
        vals, idx, rows = K.knn_select_gather(coors, KNN, table, mask, adj)
        vals3, idx3 = K.knn_select(coors, KNN, mask, adj)
        for g in (2, 4):
            R = N // g
            plan = K.built_plan("knn_select_gather", DP_BATCH, R, 3, KNN, sms, adjacency=True)
            same = True
            for r in range(g):
                blk, sl = (r * R, R), slice(r * R, (r + 1) * R)
                bv, bi, brows = K.knn_select_gather(coors, KNN, table, mask, adj, rows=blk)
                pv, pi, prows = K.knn_select_gather_plain(coors, KNN, table, mask, adj, rows=blk)
                v3, i3 = K.knn_select(coors, KNN, mask, adj, rows=blk)
                same &= (same_bits(torch, bv, vals[:, sl]) and torch.equal(bi, idx[:, sl])
                         and same_bits(torch, brows, rows[:, sl]) and same_bits(torch, bv, pv)
                         and torch.equal(bi, pi) and same_bits(torch, brows, prows)
                         and same_bits(torch, v3, vals3[:, sl]) and torch.equal(i3, idx3[:, sl])
                         and same_bits(torch, v3, pv) and torch.equal(i3, pi))
                max_err = max(max_err, (bv - pv).abs().max().item(),
                              (brows - prows).abs().max().item())
            print(f"phase 44a K1 and K3 row blocks at b = {DP_BATCH}, n = {N}, k = {KNN}, "
                  f"{'integer lattice (ties)' if ties else 'gaussian'} coordinates, a mask and a "
                  f"chain with random extra edges per graph, g = {g} (R = {R}; plan {plan}): "
                  f"every block bitwise the whole launches' rows and the plain versions': {same}")
            if not same:
                raise AssertionError("phase 44a: a K1 or K3 row block disagrees")
    del coors, mask, adj, table, vals, idx, rows, vals3, idx3

    n4 = N_K4_ROWS
    g4 = torch.Generator().manual_seed(SEED + 442)
    coors4 = (3.0 * torch.randn(1, n4, 3, generator=g4)).cuda()
    mask4 = (torch.arange(n4)[None] < int(0.9 * n4)).cuda()
    ar = torch.arange(n4, device="cuda")
    adj4 = ((ar[:, None] - ar[None, :]).abs() == 1)[None]
    v4, i4 = K.knn_select_tiled(coors4, KNN, mask4, adj4)
    same = True
    R = n4 // 2
    for r in range(2):
        blk, sl = (r * R, R), slice(r * R, (r + 1) * R)
        bv, bi = K.knn_select_tiled(coors4, KNN, mask4, adj4, rows=blk)
        pv, pi = K.knn_select_plain(coors4, KNN, mask4, adj4,
                                    row_chunk=K._default_row_chunk(1, n4), rows=blk)
        same &= (same_bits(torch, bv, v4[:, sl]) and torch.equal(bi, i4[:, sl])
                 and same_bits(torch, bv, pv) and torch.equal(bi, pi))
    print(f"phase 44a K4 row blocks at n = {n4} (an (n, n) adjacency of {n4 * n4 / 1e6:.0f} MB, "
          f"a mask), g = 2: every block bitwise the whole launch's rows and the plain "
          f"version's: {same}")
    if not same:
        raise AssertionError("phase 44a: a K4 row block disagrees")
    blk = (R, R)
    fn = lambda: K.knn_select_tiled(coors4, KNN, mask4, adj4, rows=blk)  # noqa: E731
    plain = lambda: K.knn_select_plain(  # noqa: E731
        coors4, KNN, mask4, adj4, row_chunk=K._default_row_chunk(1, n4), rows=blk)
    p_a, k_a, k_b, p_b = (call_ms(torch, plain, iters=3, warmup=1),
                          device_ms(torch, fn, reps=3, trials=5),
                          device_ms(torch, fn, reps=3, trials=5),
                          call_ms(torch, plain, iters=3, warmup=1))
    b4_ms, b4_by = knn_rows_bound(1, n4, R, 3, KNN, 0, True, R * n4)
    plan = K.built_plan("knn_select_tiled", 1, R, 3, KNN, sms, adjacency=True)
    print(f"timing on {smi}: the row-block K4 at n = {n4}, R = {R} (rows {R}..{n4 - 1}), "
          f"k = {KNN}, a mask and the (n, n) adjacency, plan {plan}: kernel {k_a:.5f}/{k_b:.5f} "
          f"ms (graph replays), plain {p_a:.5f}/{p_b:.5f} ms (calls), bound {b4_ms:.6f} ms ({b4_by}); no library call "
          f"computes it; not on a main path here (beyond the full-band reach)")
    del coors4, mask4, adj4, v4, i4, bv, bi, pv, pi
    torch.cuda.empty_cache()

    # the row-block K1 at R = 512, anchor 3's shape, timed
    coors, mask, adj, table = knn_inputs(torch, DP_BATCH, N, KNN, True, True, False, SEED + 443)
    R = N // 2
    blk = (R, R)
    fn = lambda: K.knn_select_gather(coors, KNN, table, mask, adj, rows=blk)  # noqa: E731
    plain = lambda: K.knn_select_gather_plain(coors, KNN, table, mask, adj, rows=blk)  # noqa
    p_a, k_a, k_b, p_b = (device_ms(torch, plain), device_ms(torch, fn), device_ms(torch, fn),
                          device_ms(torch, plain))
    tw = table.shape[-1]
    bound_ms, bound_by = knn_rows_bound(DP_BATCH, N, R, 3, KNN, tw, True, DP_BATCH * R * N)
    plan = K.built_plan("knn_select_gather", DP_BATCH, R, 3, KNN, sms, adjacency=True)
    print(f"timing on {smi}: the row-block K1 at b = {DP_BATCH}, n = {N}, R = {R} (rows "
          f"{R}..{N - 1}), k = {KNN}, tw = {tw}, plan {plan}: kernel {k_a:.5f}/{k_b:.5f} ms, "
          f"plain {p_a:.5f}/{p_b:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}); no library call "
          f"computes it")
    del coors, mask, adj, table
    k11_table = k11_table_check(torch, smi)
    print(f"phase 44a: {time.perf_counter() - t_start:.1f} s")

    # ---- 44b. anchor 3's step on a (data, graph) = (1, 2) mesh, two ranks ----
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=root / "build"))
    rq = synthetic_chain_batch(np.random.default_rng(SEED + 444), DP_BATCH, N, device="cuda")
    dense = (rq.tokens, rq.noised_coors, rq.clean_coors, rq.adj_mat, rq.mask)
    ranks = run_two_ranks(torch, dict(dense=tuple(t.detach().cpu() for t in dense)), work,
                          target=graph_rank_main, what="phase 44b", timeout=GRAPH_TIMEOUT)
    print(f"phase 44b's two ranks: {time.perf_counter() - t_phase:.1f} s")
    path_launches = {}
    for flag in GRAPH_FLAGS:
        ref = graph_run(torch, SEED + 44, dense, flag=flag)
        what = f"anchor 3's step (b = {DP_BATCH}){f' with {flag}' if flag else ''}"
        for r, res in enumerate(ranks):
            got = res[str(flag)]
            compare_runs(torch, f"phase 44b rank {r}, {what} on a (data, graph) = (1, 2) mesh "
                         f"({N // 2} nodes a rank) against one process on the card", got, ref,
                         PAR_GRAD_TOL_SELF_PAIRS, steps=GRAPH_STEPS)
            sl = slice(r * N // 2, (r + 1) * N // 2)
            if not torch.equal(got["first_indices"], ref["first_indices"][:, sl].cpu()):
                raise AssertionError(f"phase 44b rank {r}: the first layer's selection is not "
                                     f"the one-process selection's rows")
        a, b_ = ranks[0][str(flag)], ranks[1][str(flag)]
        same = all(same_bits(torch, a["params"][k], b_["params"][k]) for k in a["params"])
        t_ref = [call_ms(torch, ref["call"], iters=10, warmup=2) for _ in range(2)]
        print(f"phase 44b {what}: the first layer's selected indices on each rank bitwise the "
              f"one-process selection's rows; the two ranks' parameters after {GRAPH_STEPS} "
              f"steps bitwise equal={same}; launches over the steps rank 0 {a['launches']}, rank "
              f"1 {b_['launches']}, one process {ref['launches']}")
        print(f"timing on {smi}: {what} as a call, on each rank of the graph axis "
              f"{a['ms']:.4f} / {b_['ms']:.4f} ms (median of 10 after 2; two ranks sharing one "
              f"card, gloo through host memory: not a scaling number), one process on the "
              f"whole batch {t_ref[0]:.4f}/{t_ref[1]:.4f} ms (median of 10 after 2)")
        per_path = DEPTH * GRAPH_STEPS
        need = ({"knn_select_rows": per_path, "fused_knn_fwd_table": per_path,
                 "fused_knn_bwd_table": per_path} if flag == "fused_knn"
                else {"knn_select_gather_rows": per_path})
        need["segment_sum"] = per_path
        if flag == "fused_pairs":
            need.update(fused_pair_fwd=per_path, fused_pair_bwd=per_path)
        if not (same and all(res[str(flag)]["launches"] == need for res in ranks)):
            raise AssertionError(f"phase 44b {what}: the ranks' parameters differ or a rank "
                                 f"launched other than {need}")
        path_launches.update(a["launches"] if flag != "fused_pairs" else {})
        del ref
    del ranks
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 44b: {time.perf_counter() - t_phase:.1f} s")
    print(f"phase 44 (the graph axis): {time.perf_counter() - t_start:.1f} s")
    entries = [{
        "name": "knn_select_gather_rows", "route": "cuda",
        "source": "egnn_tpu_torch/csrc/knn_select_large.cu",
        "replaces": "egnn_tpu/ops/pallas/knn.py:466",
        "launches": path_launches["knn_select_gather_rows"],
        # the gate is bitwise: the largest |kernel - plain| over vals and rows
        "max_abs_err": max_err, "ms": min(k_a, k_b), "plain_ms": min(p_a, p_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    for key, e in k11_table.items():
        entries.append({**e, "launches": path_launches[f"fused_knn_{key}_table"]})
    return entries


# phase 45: the last options. Anchor 4 (benchmarks/bench_all.py:106-124) at
# full width on the card, its all-pairs variant (the degrees' dense edges in
# every layer), both on the graph axis, and dropout in training mode sharded
# against one process with the same generator seed: on the graph axis (kNN,
# the ring) and under tensor parallelism (dense, sparse)
N4, DEPTH4, DIM4, DEGREES4, ADJ_DIM4, KNN4 = 512, 2, 32, 3, 8, 7
ANCHOR4_LAYER = dict(only_sparse_neighbors=True, num_nearest_neighbors=KNN4)
LAST_TIMEOUT = 300   # seconds for both ranks of phases 45b-45c to report
# 45b's all-pairs variant on two ranks against one process: without kNN its
# coordinates reach |x| ~ 1e4 (a loss of 1e7), and each gradient of the
# adjacency embedding sums 2.6e5 pair terms of both signs. On the CPU the
# f32 one-process gradient is 2.7e-6 of its largest value from float64,
# and the two-rank f32 step's 3.7e-6 to 1.0e-5 from the one-process step's
# (gloo ranks on the CPU, two runs): the sums' order alone. Anchor 4 itself
# is held to PAR_ONE_RANK_TOL.
ANCHOR4_AP_GRAD_TOL = 1e-4
# 45c's rows: (what, the tolerance of its gradients against one process)
LAST_DROPOUT_ROWS = {
    "graph_knn": (f"anchor 3's network (b = {DP_BATCH}) on a (data, graph) = (1, 2) mesh",
                  PAR_GRAD_TOL_SELF_PAIRS),
    "graph_ring": (f"phase 40's all-pairs denoiser (depth {RING_DEPTH}, dim {RING_DIM}) on the "
                   f"ring at g = 2, against the streamed layer at pairwise_chunk = {N // 2}",
                   PAR_GRAD_TOL),
    "tp_anchor1": (f"anchor 1's layer (dim {DIM_ANCHOR12}, n = {N_ANCHOR12}) at model = 2",
                   PAR_GRAD_TOL),
    "tp_anchor5b": (f"anchor 5's arm (b) at model = 2", TP_SPARSE_GRAD_TOL),
}


def anchor4_net(torch, all_pairs=False):
    """Anchor 4's network on the card, weights from SEED; ``all_pairs``:
    without ``only_sparse_neighbors`` and kNN, so that the degrees' dense
    (b, n, n, adj_dim) edges reach every all-pairs layer."""
    from egnn_tpu_torch import EGNNNetwork

    return EGNNNetwork(depth=DEPTH4, dim=DIM4, num_tokens=NUM_TOKENS, num_adj_degrees=DEGREES4,
                       adj_dim=ADJ_DIM4, layer_kwargs={} if all_pairs else ANCHOR4_LAYER,
                       device="cuda", generator=torch.Generator().manual_seed(SEED))


@contextlib.contextmanager
def constant_max_degree(k):
    """``neighbors.max_degree`` answering ``k`` without its host read, so
    that a CUDA graph can capture ``only_sparse_neighbors``' forward; ``k``
    is the value the first call read."""
    from egnn_tpu_torch.ops import neighbors as nb

    real = nb.max_degree
    nb.max_degree = lambda adj_mat: k
    try:
        yield
    finally:
        nb.max_degree = real


@contextlib.contextmanager
def recorded_masks(torch, masks, keep=None):
    """Every dropout mask the layers draw, appended to ``masks`` as ((the
    whole shape, the slices), the digest of the keep mask of the part):
    the draw is replayed on a copy of the generator's state before it.
    ``keep``: a dict that also takes each keep mask by its digest."""
    from egnn_tpu_torch.models import egnn as E
    from egnn_tpu_torch.models import egnn_sparse as S
    from egnn_tpu_torch.ops import core
    from egnn_tpu_torch.ops import pairwise_stream as PS

    real = core.dropout

    def recording(x, rate, generator, *part):
        state = generator.get_state()
        out = real(x, rate, generator, *part)
        again = torch.Generator(device=generator.device)
        again.set_state(state)
        kept = real(torch.ones_like(x), rate, again, *part) != 0
        digest = bits_digest([kept])
        masks.append((tuple(part) if part else (tuple(x.shape), ()), digest))
        if keep is not None:
            keep[digest] = kept
        return out

    mods = (E, S, PS)
    for m in mods:
        m.dropout = recording
    try:
        yield masks
    finally:
        for m in mods:
            m.dropout = real


def anchor4_step_run(torch, all_pairs, batch, mesh=None):
    """PAR_STEPS denoise steps (flat-buffer Adam) of anchor 4's network or
    its all-pairs variant on ``batch``: with ``mesh`` this rank's block on
    the graph axis (``make_sharded_denoise_train_step``), else the whole
    batch. The losses, the first step's gradients, the final parameters,
    the launches over the steps and the call."""
    from egnn_tpu_torch import parallel
    from egnn_tpu_torch.ops.cuda import reset_launch_counts
    from egnn_tpu_torch.training import (make_denoise_train_step, make_fused_adam,
                                         make_sharded_denoise_train_step)

    net = anchor4_net(torch, all_pairs)
    opt = make_fused_adam(net.parameters(), LR)
    if mesh is None:
        step, args = make_denoise_train_step(net, opt), batch
    else:
        step = make_sharded_denoise_train_step(net, opt, mesh)
        args = [parallel.dense_batch_block(mesh, t) for t in batch[:3]] + [
            batch[3], parallel.dense_batch_block(mesh, batch[4])]
    reset_launch_counts()
    losses, grads = [], None
    for i in range(PAR_STEPS):
        losses.append(step(*args))
        if i == 0:
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for k, p in net.named_parameters()}
    return dict(losses=torch.stack(losses), grads=grads, launches=launches_now(torch),
                params={k: p.detach().clone() for k, p in net.named_parameters()},
                call=lambda: step(*args))


def dropout_row(torch, name, inputs, mesh=None, keep=None):
    """One fwd+bwd of 45c's row ``name`` in training mode at DROPOUT, the
    generator on cuda:0 seeded SEED + 45: in one process on the whole
    inputs, or sharded over ``mesh`` (the graph axis: this rank's node
    block, its loss and gradients a share of the whole; tensor parallelism:
    the whole loss, the gradients gathered whole). The loss, the named
    gradients, the masks drawn (``recorded_masks``) and the launches."""
    from egnn_tpu_torch import EGNN, EGNNNetwork, EGNNSparseNetwork, parallel
    from egnn_tpu_torch.ops.cuda import reset_launch_counts

    graph = name.startswith("graph")
    if name == "graph_knn":
        net = EGNNNetwork(depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
                          layer_kwargs={**LAYER_KWARGS, "dropout": DROPOUT}, device="cuda",
                          generator=torch.Generator().manual_seed(SEED + 451))
    elif name == "graph_ring":
        net = EGNNNetwork(depth=RING_DEPTH, dim=RING_DIM, num_tokens=NUM_TOKENS,
                          layer_kwargs=dict(dropout=DROPOUT, stream_pairwise=True,
                                            pairwise_chunk=N // 2),
                          device="cuda", generator=torch.Generator().manual_seed(SEED + 452))
    elif name == "tp_anchor1":
        net = EGNN(dim=DIM_ANCHOR12, dropout=DROPOUT, device="cuda",
                   generator=torch.Generator().manual_seed(SEED + 453))
    else:
        net = EGNNSparseNetwork(**SP_NET, **SP_ARMS["b"], dropout=DROPOUT, device="cuda",
                                generator=torch.Generator().manual_seed(SEED + 454))
    placements = None
    if mesh is not None and graph:
        parallel.shard_nodes(net, mesh.get_group("graph"))
        inputs = [parallel.dense_batch_block(mesh, t) for t in inputs[:4]] + inputs[4:]
    elif mesh is not None:
        placements = parallel.tp_param_sharding(net, mesh)
        parallel.tp_shard_module(net, mesh)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 45)
    masks = []
    reset_launch_counts()
    with recorded_masks(torch, masks, keep):
        if graph:
            tokens, noised, clean, mask = inputs[:4]
            adj = inputs[4] if len(inputs) > 4 else None
            _, c = net(tokens, noised, adj_mat=adj, mask=mask, generator=gen)
            loss = (((c - clean) ** 2).sum(dim=-1) * mask).sum()
            wrt = []
        elif name == "tp_anchor1":
            feats = inputs[0].detach().requires_grad_()
            fo, co = net(feats, inputs[1], generator=gen)
            loss = (fo ** 2).mean() + (co ** 2).mean()
            wrt = [feats]
        else:
            mb, clean = inputs
            out = net(mb.x, mb.edge_index, batch=mb.batch_ids, edge_mask=mb.edge_mask,
                      num_graphs=mb.target.shape[0], node_mask=mb.node_mask, generator=gen)
            err = (out[:, :3] - clean) ** 2 * mb.node_mask[:, None].to(out.dtype)
            loss = err.sum() / (mb.node_mask.sum().to(err.dtype) * 3).clamp(min=1.0)
            wrt = []
        grads = torch.autograd.grad(loss, wrt + list(net.parameters()), allow_unused=True)
    named = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(net.named_parameters(), grads[len(wrt):])}
    if placements is not None:
        named = whole_tensors(torch, named, placements, mesh.get_group("model"))
    res = dict(loss=loss.detach(), grads=named, masks=masks, launches=launches_now(torch),
               sharded=sorted(getattr(net, "tp_sharded", None) or
                              getattr(getattr(net, "mpnn_0", None), "tp_sharded", ())))
    if wrt:
        res["grads"]["<features>"] = grads[0]
    return res


def last_rank_main(rank, world, init_method, payload, queue):
    """Phase 45's rank: gloo on cuda:0 (two ranks share the card), 45b's
    steps of anchor 4 and its all-pairs variant on the graph axis, then
    45c's sharded dropout rows; results to the parent as numpy arrays."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from egnn_tpu_torch import parallel
        from egnn_tpu_torch.ops.cuda import build
        from egnn_tpu_torch.utils.profiling import time_fn

        build.build_all()      # built by the parent: loads the libraries
        parallel.initialize(backend="gloo", init_method=init_method, world_size=world,
                            rank=rank, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda = lambda ts: [t.cuda() for t in ts]  # noqa: E731
        mesh = parallel.make_mesh(1, world)
        tp_mesh = parallel.make_tp_mesh(1, world)
        out = {}
        for all_pairs in (False, True):
            res = anchor4_step_run(torch, all_pairs, cuda(payload["anchor4"]), mesh)
            res["ms"] = time_fn(res.pop("call"), reps=5, warmup=1, stat="median") * 1e3
            out[f"anchor4_{all_pairs}"] = res
        for name in LAST_DROPOUT_ROWS:
            inputs = payload[name]
            inputs = ([type(inputs[0])(*cuda(inputs[0])), inputs[1].cuda()]
                      if name == "tp_anchor5b" else cuda(inputs))
            out[name] = dropout_row(torch, name, inputs,
                                    mesh if name.startswith("graph") else tp_mesh)
        queue.put((rank, True, to_numpy(torch, out)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def last_options_phase(torch, smi):
    """Phase 45: anchor 4 at full width served and differentiated on the card
    (45a); its all-pairs variant, and both on the graph axis of two ranks
    sharing the card (45b); dropout in training mode sharded against one
    process with the same generator seed (45c). Raises on a failure."""
    import shutil
    import tempfile

    import numpy as np

    from egnn_tpu_torch.ops import graph as GR
    from egnn_tpu_torch.ops import neighbors as nb
    from egnn_tpu_torch.ops.cuda import reset_launch_counts
    from egnn_tpu_torch.training import synthetic_chain_batch

    t_start = time.perf_counter()
    # ---- 45a. anchor 4, one process ----
    g = torch.Generator().manual_seed(SEED + 45)
    tokens = torch.randint(0, NUM_TOKENS, (1, N4), generator=g).cuda()
    coors = torch.randn(1, N4, 3, generator=g).cuda()
    adj = chain_adj(torch, N4)[0]
    k4 = nb.max_degree(nb.expand_adjacency_degrees(adj[None], DEGREES4)[0])
    net = anchor4_net(torch).eval()
    net_cpu = copy.deepcopy(net).to("cpu")

    def serve(c, model=net, t=tokens, a=adj):
        return model(t, c, adj_mat=a)

    def fb(c, model=net, t=tokens, a=adj):
        c = c.detach().requires_grad_()
        _, co = model(t, c, adj_mat=a)
        loss = (co ** 2).mean()
        return loss.detach(), torch.autograd.grad(loss, c)[0]

    reset_launch_counts()
    with torch.inference_mode():
        f, c = serve(coors)
    served = launches_now(torch)
    reset_launch_counts()
    loss, grad = fb(coors)
    both = launches_now(torch)
    check_outputs(torch, (f, c, grad), ((1, N4, DIM4), (1, N4, 3), (1, N4, 3)), "phase 45a")
    host = (tokens.cpu(), adj.cpu())
    with torch.inference_mode():
        f_cpu, c_cpu = serve(coors.cpu(), net_cpu, *host)
    loss_cpu, grad_cpu = with_k2_sums(fb, coors.cpu(), net_cpu, *host)
    ef = max((f.cpu() - f_cpu).abs().max().item(), (c.cpu() - c_cpu).abs().max().item())
    el = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    eg = rel_err(torch, grad, grad_cpu)
    print(f"phase 45a anchor 4 (depth {DEPTH4}, dim {DIM4}, n = {N4}, {DEGREES4} adjacency "
          f"degrees, adj_dim {ADJ_DIM4}, only_sparse_neighbors; num_nearest_neighbors={KNN4} "
          f"given, k = {k4}, the expanded chain's largest row degree, taken): launches in a "
          f"forward {served}, in a fwd+bwd {both}; card vs CPU forward max err {ef:.3e} (atol "
          f"{GPU_VS_CPU_ATOL}), loss {el:.3e} (rtol {TRAIN_LOSS_RTOL}), the coordinates' "
          f"gradient {eg:.3e} relative (tol {TRAIN_GRAD_TOL}; the CPU's segment sums in K2's "
          f"arithmetic)")
    if served.get("knn_select_gather") != DEPTH4 or both.get("knn_select_gather") != DEPTH4 \
            or both.get("segment_sum") != DEPTH4:
        raise AssertionError(f"phase 45a: K1 and K2 did not launch depth ({DEPTH4}) times a "
                             f"forward and a fwd+bwd")
    if ef > GPU_VS_CPU_ATOL or el > TRAIN_LOSS_RTOL or eg > TRAIN_GRAD_TOL:
        raise AssertionError("phase 45a: anchor 4 on the card and the CPU disagree")
    check_equivariance(torch, serve, coors, "phase 45a anchor 4")
    # the train step takes the given num_nearest_neighbors as k, as the JAX
    # package's jitted step does (ops/neighbors.py:static_k): one step on
    # the card against the CPU, each gradient by phase 9's rule; no mask, as
    # above, so that every slot counts and the two more slots add messages
    from egnn_tpu_torch.training import make_denoise_train_step, make_fused_adam
    rq = synthetic_chain_batch(np.random.default_rng(SEED + 451), 1, N4, device="cuda")
    step_batch = (rq.tokens, rq.noised_coors, rq.clean_coors, rq.adj_mat, None)
    cpu_batch = [None if t is None else t.cpu() for t in step_batch]
    step_nets = [anchor4_net(torch)]
    step_nets.append(copy.deepcopy(step_nets[0]).to("cpu"))
    with torch.no_grad():   # the coordinates at a direct call's k and at the step's
        _, direct = step_nets[1](cpu_batch[0], cpu_batch[1], adj_mat=cpu_batch[3])
        with nb.static_k():
            _, static = step_nets[1](cpu_batch[0], cpu_batch[1], adj_mat=cpu_batch[3])
        k_moves = (static - direct).abs().max().item()
    steps = [make_denoise_train_step(m, make_fused_adam(m.parameters(), LR)) for m in step_nets]
    reset_launch_counts()
    step_loss = steps[0](*step_batch).item()
    stepped = launches_now(torch)
    step_loss_cpu = with_k2_sums(steps[1], *cpu_batch).item()
    grad_errs = []
    for (name, p), q in zip(step_nets[0].named_parameters(), step_nets[1].parameters()):
        if p.grad is not None and q.grad is not None:
            diff, norm = (torch.linalg.vector_norm(x).item()
                          for x in (p.grad.cpu().double() - q.grad.double(), q.grad.double()))
            grad_errs.append((diff - TRAIN_GRAD_TOL * norm - 1e-12, diff / max(norm, 1e-300),
                              name))
    el_step = abs(step_loss - step_loss_cpu) / abs(step_loss_cpu)
    worst = max(grad_errs)
    print(f"phase 45a anchor 4's train step, k = {KNN4} (the given num_nearest_neighbors, as "
          f"the JAX package's jitted step): launches {stepped}; loss card {step_loss:.8f} "
          f"against CPU {step_loss_cpu:.8f} ({el_step:.3e}, rtol {TRAIN_LOSS_RTOL}), the "
          f"gradients' largest relative error {max(e for _, e, _ in grad_errs):.3e} (tol "
          f"{TRAIN_GRAD_TOL}); the initial weights' output coordinates at k = {KNN4} "
          f"against a direct call's k = {k4}: {k_moves:.3e} apart at most")
    if el_step > TRAIN_LOSS_RTOL or worst[0] > 0 or stepped.get("knn_select_gather") != DEPTH4:
        raise AssertionError(f"phase 45a: anchor 4's train step on the card and the CPU "
                             f"disagree ({worst[2]}), or K1 did not run depth times")
    del step_nets, steps
    with torch.inference_mode():
        fwd_call = [call_ms(torch, lambda: serve(coors)) for _ in range(2)]
        with constant_max_degree(k4):
            fwd_replay = [device_ms(torch, lambda: serve(coors)) for _ in range(2)]
    fb_call = [call_ms(torch, lambda: fb(coors)) for _ in range(2)]
    with constant_max_degree(k4):
        fb_replay = [device_ms(torch, lambda: fb(coors)) for _ in range(2)]
    print(f"timing on {smi}: anchor 4's forward {fwd_call[0]:.4f}/{fwd_call[1]:.4f} ms a call "
          f"(max_degree's host read included), {fwd_replay[0]:.4f}/{fwd_replay[1]:.4f} ms "
          f"replayed (k fixed at {k4} for the capture); fwd+bwd of (coors_out^2).mean() "
          f"{fb_call[0]:.4f}/{fb_call[1]:.4f} ms a call, {fb_replay[0]:.4f}/{fb_replay[1]:.4f} "
          f"ms replayed; {N4 * k4 * DEPTH4 / (min(fb_call) / 1e3):.4e} edges/s a fwd+bwd call "
          f"(b n k depth / latency)")
    profile_forward(torch, lambda: fb(coors), label="anchor-4 fwd+bwd calls", unit="fwd+bwd")

    # ---- 45b. the all-pairs variant: the degrees' dense edges in every layer ----
    net_ap = anchor4_net(torch, all_pairs=True).eval()
    net_ap_cpu = copy.deepcopy(net_ap).to("cpu")
    reset_launch_counts()
    with torch.inference_mode():
        f, c = serve(coors, net_ap)
    ap_served = launches_now(torch)
    loss, grad = fb(coors, net_ap)
    with torch.inference_mode():
        f_cpu, c_cpu = serve(coors.cpu(), net_ap_cpu, *host)
    loss_cpu, grad_cpu = fb(coors.cpu(), net_ap_cpu, *host)
    check_outputs(torch, (f, c, grad), ((1, N4, DIM4), (1, N4, 3), (1, N4, 3)), "phase 45b")
    # without kNN the coordinates reach |x| ~ 1e4 (sums over 512 pairs): the
    # forward is held at GPU_VS_CPU_ATOL of its largest value, as the CPU
    # tests scale their atol
    ef = max((f.cpu() - f_cpu).abs().max().item() / max(1.0, f_cpu.abs().max().item()),
             (c.cpu() - c_cpu).abs().max().item() / max(1.0, c_cpu.abs().max().item()))
    el = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    eg = rel_err(torch, grad, grad_cpu)
    with torch.inference_mode():
        ap_call = call_ms(torch, lambda: serve(coors, net_ap))
        ap_replay = device_ms(torch, lambda: serve(coors, net_ap))
    print(f"phase 45b anchor 4's all-pairs variant (dense (1, {N4}, {N4}, {ADJ_DIM4}) edges in "
          f"both layers): launches in a forward {ap_served} (no kernel of the port's: plain "
          f"torch over all pairs); card vs CPU forward max err {ef:.3e} of the largest value "
          f"(|coors| up to {c_cpu.abs().max().item():.1f}; tol {GPU_VS_CPU_ATOL}), loss {el:.3e} (rtol {TRAIN_LOSS_RTOL}), the coordinates' "
          f"gradient {eg:.3e} relative (tol {TRAIN_GRAD_TOL}); timing on {smi}: a forward "
          f"{ap_call:.4f} ms a call, {ap_replay:.4f} ms replayed")
    if ef > GPU_VS_CPU_ATOL or el > TRAIN_LOSS_RTOL or eg > TRAIN_GRAD_TOL:
        raise AssertionError("phase 45b: the all-pairs variant on the card and the CPU disagree")
    del net, net_cpu, net_ap, net_ap_cpu
    torch.cuda.empty_cache()
    print(f"phase 45a and 45b's one process: {time.perf_counter() - t_start:.1f} s")

    # ---- 45b and 45c on two ranks sharing the card ----
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=root / "build"))
    rq4 = synthetic_chain_batch(np.random.default_rng(SEED + 450), 1, N4, device="cuda")
    batch4 = [rq4.tokens, rq4.noised_coors, rq4.clean_coors, rq4.adj_mat, rq4.mask]
    rq8 = synthetic_chain_batch(np.random.default_rng(SEED + 455), DP_BATCH, N, device="cuda")
    rq1 = synthetic_chain_batch(np.random.default_rng(SEED + 456), 1, N, device="cuda")
    g41 = torch.Generator().manual_seed(SEED + 457)
    mb, mb_clean = molecule_batch(torch, GR.knn_graph, SP_G, SEED + 458)
    inputs = {
        "graph_knn": [rq8.tokens, rq8.noised_coors, rq8.clean_coors, rq8.mask, rq8.adj_mat],
        "graph_ring": [rq1.tokens, rq1.noised_coors, rq1.clean_coors, rq1.mask],
        "tp_anchor1": [torch.randn(1, N_ANCHOR12, DIM_ANCHOR12, generator=g41).cuda(),
                       torch.randn(1, N_ANCHOR12, 3, generator=g41).cuda()],
        "tp_anchor5b": [mb, mb_clean],
    }
    cpu = lambda ts: [t.detach().cpu() for t in ts]  # noqa: E731
    payload = {"anchor4": cpu(batch4), "tp_anchor5b": [type(mb)(*cpu(mb)), mb_clean.cpu()],
               **{k: cpu(v) for k, v in inputs.items() if k != "tp_anchor5b"}}
    ranks = run_two_ranks(torch, payload, work, target=last_rank_main, what="phase 45",
                          timeout=LAST_TIMEOUT)
    print(f"phase 45's two ranks: {time.perf_counter() - t_phase:.1f} s")

    for all_pairs in (False, True):
        key = f"anchor4_{all_pairs}"
        ref = anchor4_step_run(torch, all_pairs, batch4)
        what = "anchor 4's all-pairs variant" if all_pairs else "anchor 4"
        for r, res in enumerate(ranks):
            compare_runs(torch, f"phase 45b rank {r}, {what}'s step on a (data, graph) = (1, 2) "
                         f"mesh ({N4 // 2} nodes a rank) against one process on the card",
                         res[key], ref, ANCHOR4_AP_GRAD_TOL if all_pairs else PAR_ONE_RANK_TOL)
        a, b_ = ranks[0][key], ranks[1][key]
        same = all(same_bits(torch, a["params"][k], b_["params"][k]) for k in a["params"])
        t_ref = [call_ms(torch, ref["call"], iters=5, warmup=1) for _ in range(2)]
        need = {} if all_pairs else {"knn_select_gather_rows": DEPTH4 * PAR_STEPS,
                                     "segment_sum": DEPTH4 * PAR_STEPS}
        print(f"phase 45b {what}: the two ranks' parameters after {PAR_STEPS} steps bitwise "
              f"equal={same}; launches over the steps rank 0 {a['launches']}, rank 1 "
              f"{b_['launches']}, one process {ref['launches']}; timing on {smi}: a step "
              f"{a['ms']:.4f} / {b_['ms']:.4f} ms as a call on each rank (two ranks sharing one "
              f"card, gloo through host memory: not a scaling number), one process "
              f"{t_ref[0]:.4f}/{t_ref[1]:.4f} ms")
        if not (same and all(res[key]["launches"] == need for res in ranks)):
            raise AssertionError(f"phase 45b {what}: the ranks' parameters differ or a rank "
                                 f"launched other than {need}")
        profile_forward(torch, ref["call"], iters=3, label=f"{what}'s one-process steps",
                        unit="step")
        del ref

    for name, (what, tol) in LAST_DROPOUT_ROWS.items():
        keep = {}
        ref = dropout_row(torch, name, inputs[name], keep=keep)
        # each rank's masks against the one-process masks cut as it cut them
        parts = {part for res in ranks for part, _ in res[name]["masks"]}
        cuts = set()
        for kept in keep.values():
            for whole, slices in parts:
                if tuple(kept.shape) == whole:
                    cut = kept
                    for dim, start, length in slices:
                        cut = cut.narrow(dim, start, length)
                    cuts.add((whole, slices, bits_digest([cut])))
        matched = [all((*part, digest) in cuts for part, digest in res[name]["masks"])
                   for res in ranks]
        del keep, cuts
        graph = name.startswith("graph")
        losses = ([sum(res[name]["loss"] for res in ranks)] if graph
                  else [res[name]["loss"] for res in ranks])
        el = max(abs(v.item() - ref["loss"].item()) / abs(ref["loss"].item()) for v in losses)
        # graph axis: each rank's gradients a share of the whole
        gots = ([{k: ranks[0][name]["grads"][k] + ranks[1][name]["grads"][k]
                  for k in ref["grads"]}] if graph else [res[name]["grads"] for res in ranks])
        worst = max(max((grad_err(torch, got[k], ref["grads"][k]), k) for k in ref["grads"])
                    for got in gots)
        print(f"phase 45c dropout {DROPOUT} in training mode, {what}: every rank's masks "
              f"bitwise its part of the one-process masks (generator on cuda:0, seed "
              f"{SEED + 45}): {matched} ({len(ranks[0][name]['masks'])} draws a rank, "
              f"{len(ref['masks'])} in one process); then the loss {el:.3e} (rtol "
              f"{PAR_LOSS_RTOL}) and the gradients up to {worst[0]:.3e} of their largest value "
              f"({worst[1]}; tol {tol}) against one process"
              + ("" if graph else f"; sharded {ranks[0][name]['sharded']}")
              + f"; launches rank 0 {ranks[0][name]['launches']}, one process {ref['launches']}")
        if not all(matched):
            raise AssertionError(f"phase 45c {name}: a rank's masks are not its part of the "
                                 f"one-process masks")
        if el > PAR_LOSS_RTOL or worst[0] > tol:
            raise AssertionError(f"phase 45c {name}: out of tolerance")
        if name == "graph_knn" and not all(
                res[name]["launches"].get("knn_select_gather_rows") == DEPTH for res in ranks):
            raise AssertionError("phase 45c graph_knn: K1's row block did not run depth times")
        del ref
    del ranks
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)

    # the cost of the whole-mask draw: a rank's part drawn alone (what a
    # counter-based draw would cost), the part cut from the whole draw, and
    # the one-process draw of the whole, as calls
    from egnn_tpu_torch.ops import core
    h3, h_ring = 2 * (2 * DIM + 1), 2 * (2 * RING_DIM + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 459)
    for what, part, dim, count in (
            (f"anchor 3's edge hidden at b = {DP_BATCH}, g = 2", (DP_BATCH, N // 2, KNN, h3), 1, 2),
            (f"the ring's edge hidden, one block of {N // 2} x {N // 2}, g = 2",
             (1, N // 2, N // 2, h_ring), 1, 2),
            (f"anchor 1's edge hidden at model = 2", (1, N_ANCHOR12, N_ANCHOR12, 2050), 3, 2)):
        x = torch.randn(part, device="cuda")
        whole = list(part)
        whole[dim] *= count
        xw = torch.randn(whole, device="cuda")
        slices = ((dim, part[dim], part[dim]),)
        t = [call_ms(torch, fn) for fn in (
            lambda: core.dropout(x, DROPOUT, gen),
            lambda: core.dropout(x, DROPOUT, gen, tuple(whole), slices),
            lambda: core.dropout(xw, DROPOUT, gen))]
        print(f"timing on {smi}: the dropout mask of {what}, as calls (median of 30 after 5): "
              f"the part {tuple(part)} drawn alone {t[0]:.5f} ms, cut from the whole "
              f"{tuple(whole)}'s draw {t[1]:.5f} ms ({t[1] / t[0]:.2f}x), the one-process draw "
              f"of the whole {t[2]:.5f} ms")
        del x, xw
    print(f"phase 45 (the last options): {time.perf_counter() - t_start:.1f} s")


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
    from egnn_tpu_torch.ops import spatial
    from egnn_tpu_torch.ops.cuda import LAUNCH_COUNTS, build, reset_launch_counts
    from egnn_tpu_torch.ops.cuda import grid_knn as GK
    from egnn_tpu_torch.ops.cuda import knn as K
    from egnn_tpu_torch.ops.cuda import pair_messages as PM
    from egnn_tpu_torch.ops.cuda import segment as SK
    from egnn_tpu_torch.training import make_denoise_train_step, make_fused_adam
    from egnn_tpu_torch.training.data import synthetic_chain_batch

    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, {build.BUILD_DIR.name})")

    # ---- 2. kernels against their plain versions and CPU model, bitwise ----
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def cpu(t):
        return None if t is None else t.cpu()

    cases = [  # name, b, n, k, mask, adj, ties, c
        ("anchor", 1, N, KNN, True, True, False, 3),
        ("b4", 4, N, KNN, True, True, False, 3),
        ("ragged_n1000", 1, 1000, KNN, True, True, False, 3),
        ("no_mask_no_adj", 1, N, KNN, False, False, False, 3),
        ("tie_pileup", 1, N, KNN, True, True, True, 3),
        ("k1", 1, N, 1, True, True, False, 3),
        ("k128", 1, N, 128, True, True, False, 3),
        ("c5", 1, N, KNN, True, True, False, 5),            # the predicated loop
        # a NaN coordinate: its row and its column rank NaN, above +inf; every
        # row still ends with k real columns (the kernel's header says why)
        ("nan_rankings", 1, N, KNN, False, True, False, 3),
    ]
    max_err = {"knn_select_gather": 0.0, "knn_select": 0.0}
    for i, (name, b, n, k, wm, wa, ties, c) in enumerate(cases):
        coors, mask, adj, table = knn_inputs(torch, b, n, k, wm, wa, ties, SEED + i, c)
        if name == "nan_rankings":
            coors[0, 17, 1] = math.nan
        v1, i1, r1 = K.knn_select_gather(coors, k, table, mask, adj)
        v3, i3 = K.knn_select(coors, k, mask, adj)
        pv, pi, pr = K.knn_select_gather_plain(coors, k, table, mask, adj)
        torch.cuda.synchronize()
        ok1 = same_bits(torch, v1, pv) and torch.equal(i1, pi) and same_bits(torch, r1, pr)
        ok3 = same_bits(torch, v3, pv) and torch.equal(i3, pi)
        e1 = max(finite_err(torch, v1, pv), finite_err(torch, r1, pr))
        e3 = finite_err(torch, v3, pv)
        max_err["knn_select_gather"] = max(max_err["knn_select_gather"], e1)
        max_err["knn_select"] = max(max_err["knn_select"], e3)
        # the CPU model of the traversal at the source's plan
        rows, cols, stripes = K.built_plan("knn_select_gather", b, n, c, k, sms, adjacency=wa)
        if cols != K.BLOCK_RUN:
            raise AssertionError(f"the source ranks {cols} columns a lane a step, the CPU model "
                                 f"{K.BLOCK_RUN}")
        mv, mi, mr, mcounts = K.knn_select_block_model(
            coors.cpu(), k, cpu(mask), cpu(adj), 0, rows, None, stripes=stripes, table=table.cpu())
        ok_model = (same_bits_or_nan(torch, v1.cpu(), mv) and torch.equal(i1.cpu(), mi)
                    and same_bits(torch, r1.cpu(), mr))
        print(f"kernel case {name}: b={b} n={n} c={c} k={k} tw={table.shape[-1]} mask={wm} "
              f"adj={wa} ties={ties}, {rows} rows a warp, {stripes} warps a row: K1 "
              f"bitwise={ok1} (max err {e1}), K3 bitwise={ok3} (max err {e3}); the CPU model's "
              f"bitwise={ok_model} ({mcounts})")
        if not (ok1 and ok3 and ok_model):
            raise AssertionError(f"kernel case {name}: kernel, plain version and CPU model "
                                 "differ")

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

    rq = requests[0]
    check_equivariance(torch, lambda c: serve(rq._replace(noised_coors=c)), rq.noised_coors,
                       "anchor-3 b=1")

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

        kernels = []
        # b=1 first (the JSON line's rows), then K1 at b=8 (its own adjacencies)
        for b in (1, 8):
            coors, mask, adj, table = knn_inputs(torch, b, N, KNN, True, True, False, SEED)
            n, c = coors.shape[1:]
            tw = table.shape[-1]
            # b=1: one (n, n) bool chain, expanded over the batch; b=8: b of them
            adj_bytes = n * n * (1 if b == 1 else b)
            for name, fn, plain, width, replaces in (
                ("knn_select_gather",
                 lambda: K.knn_select_gather(coors, KNN, table, mask, adj),
                 lambda: K.knn_select_gather_plain(coors, KNN, table, mask, adj),
                 tw, "egnn_tpu/ops/pallas/knn.py:466"),
                ("knn_select",
                 lambda: K.knn_select(coors, KNN, mask, adj),
                 lambda: K.knn_select_plain(coors, KNN, mask, adj),
                 0, "egnn_tpu/ops/pallas/knn.py:203"),
            )[:2 if b == 1 else 1]:
                ms_plain_a = device_ms(torch, plain)
                ms_a = device_ms(torch, fn)
                ms_b = device_ms(torch, fn)
                ms_plain_b = device_ms(torch, plain)
                bound_ms, bound_by = knn_bound(b, n, c, KNN, width, True, adj_bytes)
                rows, _, stripes = K.built_plan(name, b, n, c, KNN, sms, adjacency=True)
                print(f"timing {name} at b={b} n={n} k={KNN} tw={width}, {rows} rows a warp, "
                      f"{stripes} warps a row: kernel {ms_a:.5f}/{ms_b:.5f} ms, plain "
                      f"{ms_plain_a:.5f}/{ms_plain_b:.5f} ms, bound {bound_ms:.6f} ms "
                      f"({bound_by}); no library call computes it")
                if b > 1:
                    continue
                launches = (serving_counts if name == "knn_select_gather"
                            else selection_counts)[name]
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": "egnn_tpu_torch/csrc/knn_select_large.cu",
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": max_err[name],
                    "ms": min(ms_a, ms_b), "plain_ms": min(ms_plain_a, ms_plain_b),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    # no single PyTorch call computes masked kNN with these fills
                    # and this tie order
                    "library_ms": None,
                })

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
    # edge cases of the fixed-point sum, with a generator of their own
    g_seg = torch.Generator().manual_seed(SEED + 21)

    def rand_seg(*shape):
        return torch.randn(*shape, generator=g_seg).cuda()

    sign = torch.where(torch.rand(1, N * KNN // 2, tw, generator=g_seg) < 0.5, -1.0, 1.0)
    wide = sign * 10.0 ** (60.0 * torch.rand(1, N * KNN // 2, tw, generator=g_seg) - 30.0)
    tiny = rand_seg(1, N * KNN // 2, tw) * 1e-37
    nonfinite = rand_seg(1, N * KNN, tw)
    nonfinite[0, ::97, 0] = float("nan")
    nonfinite[0, ::89, 1] = float("inf")
    nonfinite[0, ::83, 2] = float("-inf")
    nonfinite[0, 1::61, 3] = float("inf")
    nonfinite[0, 2::67, 3] = float("-inf")
    hub_e = 2**17 + 5
    edge_cases = [
        # one segment (a hub of 8192 edges): 1e-30 .. 1e30, each value beside its negation
        ("magnitudes_1e-30_1e30", torch.cat([wide, -wide], dim=1).cuda(),
         torch.zeros(1, N * KNN, dtype=torch.int64).cuda(), N),
        ("denormals", rand_seg(1, N * KNN, tw) * 1e-40, ids1, N),
        # x beside -x + t with |t| ~ 1e-42: sums in the denormal range
        ("denormal_results", torch.cat([tiny, -tiny + rand_seg(1, N * KNN // 2, tw) * 1e-42],
                                       dim=1), ids1[:, : N * KNN // 2].repeat(1, 2), N),
        ("nan_inf", nonfinite, ids1, N),
        ("hub_2^17", rand_seg(1, hub_e, tw), torch.zeros(1, hub_e, dtype=torch.int64).cuda(), N),
    ]
    # max_abs_err is taken over the unit-scale cases; the edge cases are held
    # to their bound and their model's bits alone (sums near 1e30 are off by 1e16)
    max_err["segment_sum"] = 0.0
    for name, data, ids, s in seg_cases:
        max_err["segment_sum"] = max(max_err["segment_sum"],
                                     check_segment_sum(torch, SK, name, data, ids, s, g_seg))
    for name, data, ids, s in edge_cases:
        check_segment_sum(torch, SK, name, data, ids, s, g_seg)

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
    # the CPU's sequential f32 sum and K2 (its error argument in
    # csrc/segment_sum.cu) each stay within half this limit
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
        net_cpu, net_plain = copy.deepcopy(net).to("cpu"), copy.deepcopy(net).to("cpu")
        step_cpu = make_denoise_train_step(net_cpu, make_fused_adam(net_cpu.parameters(), LR))
        rq = fixed[b]
        loss = step(*batch_args(rq)).item()
        loss_cpu = with_k2_sums(step_cpu, *(t.cpu() for t in batch_args(rq))).item()
        make_denoise_train_step(net_plain, make_fused_adam(net_plain.parameters(), LR))(
            *(t.cpu() for t in batch_args(rq)))
        order = max(  # the CPU alone: plain sums against K2's, information
            (torch.linalg.vector_norm(q.grad.double() - r.grad.double())
             / torch.linalg.vector_norm(q.grad.double())).item()
            for q, r in zip(net_cpu.parameters(), net_plain.parameters()) if q.grad is not None)
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
              f"(tol {TRAIN_GRAD_TOL}); the CPU with the plain version's sums against "
              f"the CPU with K2's: largest {order:.3e} (information)")
        if abs(loss - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu):
            raise AssertionError("card and CPU losses disagree")

    # ---- 10. timing: the train step and K2 ----
    for b in (1, 8):
        _, step = make_trainer()
        args = batch_args(fixed[b])
        ms = call_ms(torch, lambda: step(*args))
        edges = b * N * KNN * DEPTH
        kernel_ms, _ = profile_forward(torch, lambda: step(*args), label=f"b={b} train steps",
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
    # K2's own launches (memset, count, scan, place, hub max, reduce) by name
    profile_forward(torch, lambda: SK.segment_sum(data, ids, N), iters=20,
                    label="K2 calls at b=1 E=8192 S=1024 D=36", unit="call")
    segment_entry = {
        "name": "segment_sum", "route": "cuda",
        "source": "egnn_tpu_torch/csrc/segment_sum.cu",
        "replaces": "egnn_tpu/ops/pallas/segment.py:115",
        "launches": train_counts[1]["segment_sum"],
        "max_abs_err": max_err["segment_sum"],
        "ms": min(ms_a, ms_b), "plain_ms": min(ms_plain_a, ms_plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # torch.zeros(S, D).index_add_(0, ids, data): the same sum, with atomics
        "library_ms": ms_lib,
    }
    kernels.append(segment_entry)


    # ---- 11. K4, K5, K6 against their row-chunked plain versions, bitwise ----
    def chunk(n):
        return max(1, (1 << 27) // n)

    def block_plan(n, c, k, adjacency=False):
        """K4-K6's launch plan (rows a warp, columns a lane a step) as the
        built source computes it; the CPU model of the traversal
        (``knn_select_block_model``) must rank as many columns a lane, and
        K4-K6 take one warp a row."""
        rows, cols, stripes = K.built_plan("knn_select_tiled", 1, n, c, k, sms, adjacency)
        if cols != K.BLOCK_RUN or stripes != 1:
            raise AssertionError(f"the source ranks {cols} columns a lane a step at {stripes} "
                                 f"warps a row, the CPU model {K.BLOCK_RUN} at 1")
        return rows, cols

    def case_mask(kind, n, seed):
        """None, the prefix mask, or ``rand``: 70% of the nodes at random, so
        that masked and unmasked rows share every warp."""
        if kind == "rand":
            g = torch.Generator(device="cuda").manual_seed(seed)
            return torch.rand(1, n, generator=g, device="cuda") < 0.7
        return prefix_mask(torch, n) if kind else None

    # (list slots a lane, rows a warp) of every c = 3 instantiation of
    # knn_select_block_kernel, which the cases below must all reach; the
    # edge cases: n = 32m + 1 rows (one real row in the last block), a last
    # tile of one column, rows of n % 4 != 0 bytes (byte loads of the mask
    # and the adjacency), a random mask
    every_block = {(1, 4), (1, 2), (1, 1), (2, 2), (2, 1), (4, 1)}
    block_kernels = ("knn_select_tiled", "knn_candidates_packed_tiled", "knn_candidates_packed")
    covered = {name: set() for name in block_kernels}
    for name in block_kernels:
        max_err[name] = 0.0
    k4_cases = [  # name, n, k, c, mask, adj, cloud
        ("n20480", 20480, 16, 3, False, False, "uniform"),
        ("n65536", N_A, KNN_A, 3, False, False, "uniform"),
        ("n32768_mask_adj", N_B, KNN, 3, True, True, "uniform"),
        ("tie_pileup", 20480, KNN, 3, True, True, "ties"),
        ("k128", 4096, 128, 3, True, False, "gaussian"),   # four list slots a lane
        ("k48", 8192, 48, 3, True, True, "uniform"),        # two
        ("c5", 20480, KNN, 5, True, False, "uniform"),
        ("n16385_rand_mask_adj", 16385, 16, 3, "rand", True, "uniform"),
        ("n6001_rand_mask", 6001, 16, 3, "rand", False, "gaussian"),
        ("n2049_rand_mask_adj", 2049, 16, 3, "rand", True, "gaussian"),
        ("tie_pileup_rand_mask", 20480, 16, 3, "rand", True, "ties"),
        ("k48_n8193_rand_mask_adj", 8193, 48, 3, "rand", True, "uniform"),
        ("k48_n2000_rand_mask", 2000, 48, 3, "rand", False, "gaussian"),
        ("k128_n4097_rand_mask_adj", 4097, 128, 3, "rand", True, "uniform"),
        ("c5_n20481_rand_mask_adj", 20481, KNN, 5, "rand", True, "uniform"),
    ]
    for i, (name, n, k, c, wm, wa, kind) in enumerate(k4_cases):
        coors = cloud(torch, n, c, kind, SEED + 40 + i)
        mask = case_mask(wm, n, SEED + 140 + i)
        adj = chain_adj(torch, n) if wa else None
        v, ix = K.knn_select_tiled(coors, k, mask, adj)
        pv, pi = K.knn_select_plain(coors, k, mask, adj, row_chunk=chunk(n))
        torch.cuda.synchronize()
        ok = same_bits(torch, v, pv) and torch.equal(ix, pi)
        err = (v - pv).abs().max().item()
        max_err["knn_select_tiled"] = max(max_err["knn_select_tiled"], err)
        rows, cols = block_plan(n, c, k, wa)
        if c == 3:
            covered["knn_select_tiled"].add((-(-k // 32), rows))
        print(f"K4 case {name}: n={n} k={k} c={c} mask={wm} adj={wa} cloud={kind}, {rows} rows "
              f"a warp, {cols} columns a lane: bitwise={ok} (max err {err})")
        if not ok:
            raise AssertionError(f"K4 case {name}: kernel and plain version differ")
        del adj
    cand_cases = [  # name, n, kc, c, mask, cloud
        ("n65536", N_A, KNN_A + nb.CANDIDATE_SLACK, 3, False, "uniform"),
        ("n20480_mask", 20480, 20, 3, True, "gaussian"),
        ("n17408", 17408, 12, 3, False, "uniform"),
        ("n16384_mask", 16384, 20, 3, True, "uniform"),
        ("tie_pileup", 20480, 20, 3, False, "ties"),
        ("c5_mask", 20480, 12, 5, True, "uniform"),
        ("kc52", 8192, 52, 3, True, "gaussian"),
        ("kc128", 4096, 128, 3, False, "uniform"),
        ("n16385_rand_mask", 16385, 20, 3, "rand", "uniform"),
        ("n6001_rand_mask", 6001, 12, 3, "rand", "gaussian"),
        ("n2049_rand_mask", 2049, 20, 3, "rand", "uniform"),
        ("kc48_n2000_rand_mask", 2000, 48, 3, "rand", "gaussian"),
    ]
    for i, (name, n, kc, c, wm, kind) in enumerate(cand_cases):
        coors = cloud(torch, n, c, kind, SEED + 60 + i)
        mask = case_mask(wm, n, SEED + 160 + i)
        for kname, fn, plain in (
            ("knn_candidates_packed_tiled", K.knn_candidates_packed_tiled,
             K.knn_candidates_packed_tiled_plain),
            ("knn_candidates_packed", K.knn_candidates_packed, K.knn_candidates_packed_plain),
        ):
            keys, cols = fn(coors, kc, mask)
            pk, pc = plain(coors, kc, mask, row_chunk=chunk(n))
            torch.cuda.synchronize()
            ok = (keys.dtype == pk.dtype and cols.dtype == pc.dtype
                  and torch.equal(keys, pk) and torch.equal(cols, pc))
            err = float(max((keys - pk).abs().max().item(), (cols - pc).abs().max().item()))
            max_err[kname] = max(max_err[kname], err)
            rows, run = block_plan(n, c, kc)
            if c == 3:
                covered[kname].add((-(-kc // 32), rows))
            print(f"{kname} case {name}: n={n} kc={kc} c={c} mask={wm} cloud={kind}, {rows} "
                  f"rows a warp, {run} columns a lane: keys and cols bitwise={ok} "
                  f"(max err {err})")
            if not ok:
                raise AssertionError(f"{kname} case {name}: kernel and plain version differ")
    for name in block_kernels:
        print(f"{name}: (list slots, rows a warp) of the cases {sorted(covered[name])}")
        if covered[name] != every_block:
            raise AssertionError(f"{name}: the cases reach {sorted(covered[name])}, not every "
                                 f"instantiation {sorted(every_block)}")

    # ---- 12. the dispatcher on the card: every route gives K4's selection ----
    def winners_sorted(nbhd, n):
        """The winner slots' indices of a wide result, ascending, (b, n, k)."""
        k = int(nbhd.winner[0, 0].sum().item())
        return torch.where(nbhd.winner, nbhd.indices, n).sort(dim=-1).values[..., :k]

    def check_routes(n, k, backends, kind, seed, expect):
        coors = cloud(torch, n, 3, kind, seed)
        mask = prefix_mask(torch, n)
        payload = torch.randn(1, n, DIM, device="cuda")
        ref_v, ref_i = K.knn_select_tiled(coors, k, mask)
        for backend in backends:
            reset_launch_counts()
            compact, rows = nb.knn_select_gather(coors, k, math.inf, mask=mask,
                                                 payload=payload, backend=backend)
            wide, wrows = nb.knn_select_gather(coors, k, math.inf, mask=mask,
                                               payload=payload, backend=backend, wide=True)
            torch.cuda.synchronize()
            counts = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
            ok = (torch.equal(compact.indices, ref_i) and same_bits(torch, compact.ranking, ref_v)
                  and rows.shape == (1, n, k, 3 + 1 + DIM))
            if wide.winner is None:
                ok = ok and torch.equal(wide.indices, ref_i)
            else:
                ok = (ok and bool((wide.winner.sum(-1) == k).all())
                      and torch.equal(winners_sorted(wide, n), ref_i.sort(dim=-1).values)
                      and wrows.shape == (1, n, k + nb.CANDIDATE_SLACK, 3 + 1 + DIM))
            print(f"dispatcher n={n} k={k} cloud={kind} backend={backend}: equals K4 "
                  f"compact and wide={ok}; slots {wide.indices.shape[-1]}; launches {counts}")
            if not ok or counts != expect[backend]:
                raise AssertionError(f"backend={backend}: selection differs from K4's or the "
                                     f"launches {counts} are not {expect[backend]}")
            route_counts[backend] = counts

    route_counts = {}
    # with the grid, auto at n >= 8192 without an adjacency is the grid's
    # (k slots, also when wide is asked): a uniform cloud certifies whole, the
    # pile-up overflows its cells and takes the fallback (K5, then K4)
    check_routes(20480, KNN_A, ("grid", "auto"), "uniform", SEED + 80, {
        "grid": {"grid_knn_cells": 2}, "auto": {"grid_knn_cells": 2}})
    check_routes(20480, KNN, ("auto",), "ties", SEED + 82,
                 {"auto": {"knn_candidates_packed_tiled": 2, "knn_select_tiled": 2}})
    # the reference's own flag: auto as it was before the grid
    nb.GRID_AUTO = False
    check_routes(20480, KNN_A, ("packed_tiled", "tiled", "auto"), "uniform", SEED + 80, {
        "packed_tiled": {"knn_candidates_packed_tiled": 2},
        "tiled": {"knn_select_tiled": 2},
        "auto": {"knn_candidates_packed_tiled": 2}})
    check_routes(16384, KNN_A, ("packed",), "uniform", SEED + 81,
                 {"packed": {"knn_candidates_packed": 2}})
    packed_counts = route_counts["packed"]
    # the tie pile-up fails the certificate: the exact kernel answers
    check_routes(20480, KNN, ("auto",), "ties", SEED + 82,
                 {"auto": {"knn_candidates_packed_tiled": 2, "knn_select_tiled": 2}})
    check_routes(16384, KNN, ("packed",), "ties", SEED + 83,
                 {"packed": {"knn_candidates_packed": 2, "knn_select": 2}})
    nb.GRID_AUTO = True
    # the reference's full-band and fused backends: K1 with a payload (within
    # the fused gather's gate), K3 without
    check_routes(4096, KNN_A, ("pallas", "fused"), "uniform", SEED + 84, {
        "pallas": {"knn_select_gather": 2}, "fused": {"knn_select_gather": 2}})
    coors = cloud(torch, 4096, 3, "uniform", SEED + 84)
    mask = prefix_mask(torch, 4096)
    ref_v, ref_i = K.knn_select_tiled(coors, KNN_A, mask)
    for backend in ("pallas", "fused"):
        reset_launch_counts()
        plain_nbhd, _ = nb.knn_select_gather(coors, KNN_A, math.inf, mask=mask, backend=backend)
        torch.cuda.synchronize()
        counts = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
        ok = torch.equal(plain_nbhd.indices, ref_i) and same_bits(torch, plain_nbhd.ranking, ref_v)
        print(f"dispatcher n=4096 k={KNN_A} backend={backend} without a payload: equals K4="
              f"{ok}; launches {counts}")
        if not ok or counts != {"knn_select": 1}:
            raise AssertionError(f"backend={backend} without a payload: selection differs from "
                                 f"K4's or the launches {counts} are not K3's one")

    def time_segment_sum(what, ids, s, d, reps, trials, note=""):
        """K2's gates on the (1, E) ids a large-n path's backward gives it,
        then K2 timed beside its plain version, its bound and ``index_add_``
        on the same ids."""
        data = torch.randn(1, ids.shape[1], d, device="cuda")
        err = check_segment_sum(torch, SK, f"path {what}'s ids", data, ids, s, g_seg)
        max_err["segment_sum"] = max(max_err["segment_sum"], err)
        segment_entry["max_abs_err"] = max_err["segment_sum"]
        flat_ids, flat_data = ids.reshape(-1), data.reshape(-1, d)
        if not bool(((flat_ids >= 0) & (flat_ids < s)).all()):
            raise AssertionError(f"{what}: ids outside [0, S): index_add_ would refuse them")
        ms = device_ms(torch, lambda: SK.segment_sum(data, ids, s), reps=reps, trials=trials)
        ms_plain = device_ms(torch, lambda: SK.segment_sum_plain(data, ids, s), reps=reps,
                             trials=trials)
        ms_lib = device_ms(torch, lambda: torch.zeros(s, d, device="cuda").index_add_(
            0, flat_ids, flat_data), reps=reps, trials=trials)
        ms_b = device_ms(torch, lambda: SK.segment_sum(data, ids, s), reps=reps, trials=trials)
        bound_ms, bound_by = segment_bound(1, ids.shape[1], s, d)
        deg = torch.bincount(ids.reshape(-1), minlength=s)
        print(f"timing segment_sum at {what}'s backward, E={ids.shape[1]} S={s} D={d}: "
              f"kernel {ms:.5f}/{ms_b:.5f} ms, plain {ms_plain:.5f} ms, index_add_ "
              f"{ms_lib:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}); in-degree up to "
              f"{deg.max().item()}{note}")
        profile_forward(torch, lambda: SK.segment_sum(data, ids, s), iters=5,
                        label=f"K2 calls at {what}'s backward", unit="call")

    # ---- 13. path A: the net65k network through K5 and the kc-wide layers ----
    def make_net_a(depth=DEPTH, seed=SEED, **extra):
        return EGNNNetwork(depth=depth, dim=DIM, layer_kwargs={**LAYER_KWARGS_A, **extra},
                           device="cuda", generator=torch.Generator().manual_seed(seed))

    feats_a = torch.randn(1, N_A, DIM, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(SEED + 90))
    clouds_a = {kind: cloud(torch, N_A, 3, kind, SEED + 91)
                for kind in ("uniform", "gaussian", "heavy")}
    edges_a = N_A * KNN_A * DEPTH

    def fused_step_against_unfused(tag):
        """One train step of net65k with ``fused_pairs=True`` and one without
        on the route ``auto`` takes now, the same weights and batch: the
        losses and every parameter's gradient must agree."""
        noised = clouds_a["uniform"] + torch.randn_like(clouds_a["uniform"])
        got = {}
        for kind, extra in (("fused", dict(fused_pairs=True)), ("unfused", {})):
            net_s = make_net_a(**extra)   # the same seed: the same weights
            step = make_denoise_train_step(net_s, make_fused_adam(net_s.parameters(), LR))
            loss = step(feats_a, noised, clouds_a["uniform"], None, None).item()
            got[kind] = (loss, {name: p.grad.detach().clone()
                                for name, p in net_s.named_parameters() if p.grad is not None})
            del net_s, step
        (loss, grads), (loss_u, grads_u) = got["fused"], got["unfused"]
        if grads.keys() != grads_u.keys():
            raise AssertionError(f"{tag}: a parameter has a gradient on one path only")
        errs = []
        for name, g_u in grads_u.items():
            diff, norm = (torch.linalg.vector_norm(x.double()).item()
                          for x in (grads[name] - g_u, g_u))
            errs.append((diff / max(norm, 1e-300), name))
        print(f"{tag} one step, fused against unfused: loss {loss:.8f} beside {loss_u:.8f} (rtol "
              f"{TRAIN_LOSS_RTOL}); gradient error ||g - g_u|| / ||g_u|| largest "
              f"{max(errs)[0]:.3e} ({max(errs)[1]}) over {len(errs)} parameters (tol "
              f"{FUSED_VS_UNFUSED_GRAD_TOL})")
        if (not math.isfinite(loss) or abs(loss - loss_u) > TRAIN_LOSS_RTOL * abs(loss_u)
                or max(errs)[0] > FUSED_VS_UNFUSED_GRAD_TOL):
            raise AssertionError(f"{tag}: the fused step disagrees with the unfused one")
        torch.cuda.empty_cache()

    def drive_net65k(tag, kernel, serve_kinds, idle, also=(), fused=False):
        """Serve, check, train and time net65k on the route ``auto`` takes
        now. ``kernel`` must run depth times a forward, the selection kernels
        in ``idle`` not at all, those in ``also`` at least once while
        serving. With ``fused`` the layers carry ``fused_pairs=True``: K10f
        must run depth times a forward and K10b depth times a backward, and
        the forwards must agree with the unfused network's. Returns the
        serving run's launch counts and the measurements."""
        extra = dict(fused_pairs=True) if fused else {}
        metrics = {}
        net = make_net_a(**extra).eval()
        reset_launch_counts()
        with torch.inference_mode():
            outs = [net(feats_a, clouds_a[kind]) for kind in serve_kinds]
        torch.cuda.synchronize()
        counts = dict(LAUNCH_COUNTS)
        print(f"path {tag} serving: {len(outs)} forwards ({', '.join(serve_kinds)}) at n={N_A} "
              f"k={KNN_A}; launches {counts}")
        if (counts[kernel] != DEPTH * len(outs) or any(counts[name] for name in idle)
                or not all(counts[name] for name in also)
                or counts["fused_pair_fwd"] != (DEPTH * len(outs) if fused else 0)):
            raise AssertionError(f"path {tag}: {kernel} did not run depth times a forward, one "
                                 f"of {idle} ran, or one of {also} did not")
        for f, c in outs:
            check_outputs(torch, (f, c), ((1, N_A, DIM), (1, N_A, 3)), f"path {tag} forward")
        if fused:
            plain_net = make_net_a().eval()   # the same seed: the same weights
            with torch.inference_mode():
                for kind, (f, c) in zip(serve_kinds, outs):
                    f_u, c_u = plain_net(feats_a, clouds_a[kind])
                    ef, ec = (f - f_u).abs().max().item(), (c - c_u).abs().max().item()
                    print(f"path {tag} fused vs unfused forward ({kind}): feats max err {ef:.3e}, "
                          f"coors max err {ec:.3e} (atol {GPU_VS_CPU_ATOL})")
                    if not (ef <= GPU_VS_CPU_ATOL and ec <= GPU_VS_CPU_ATOL):
                        raise AssertionError(f"path {tag}: fused and unfused forwards disagree")
        check_equivariance(
            torch, lambda c: net(feats_a, c), clouds_a["uniform"], f"path {tag}",
            select=lambda c: K.knn_select_tiled(c.contiguous(), KNN_A)[1].sort(dim=-1).values,
            swap_share=SWAP_SHARE)

        def fwd_bwd(kind, model=net):
            """The fwd+bwd benchmarks/net65k.py times: the gradient of
            (f**2).mean() + (co**2).mean() with respect to the coordinates."""
            c = clouds_a[kind].clone().requires_grad_()
            f, co = model(feats_a, c)
            ((f ** 2).mean() + (co ** 2).mean()).backward()
            return c.grad

        reset_launch_counts()
        grad = fwd_bwd("uniform")
        torch.cuda.synchronize()
        fb_counts = dict(LAUNCH_COUNTS)
        check_outputs(torch, (grad,), ((1, N_A, 3),), f"path {tag} fwd+bwd")
        if (fb_counts[kernel] != DEPTH or fb_counts["segment_sum"] != DEPTH
                or fb_counts["fused_pair_bwd"] != (DEPTH if fused else 0)):
            raise AssertionError(f"path {tag} fwd+bwd: launches {fb_counts}")
        if fused:
            # as the path runs it, then without norm_coors: what is left of the
            # difference once no self pair's 1 / eps term stands in the sums
            bare = dict(norm_coors=False)
            for what, tol, model, model_u in (
                ("", FUSED_VS_UNFUSED_COORS_GRAD_TOL, net, plain_net),
                (" without norm_coors", FUSED_VS_UNFUSED_COORS_GRAD_TOL_BARE,
                 make_net_a(**extra, **bare).eval(), make_net_a(**bare).eval()),
            ):
                grad_f, grad_u = fwd_bwd("uniform", model), fwd_bwd("uniform", model_u)
                diff, norm = (torch.linalg.vector_norm(x.double()).item()
                              for x in (grad_f - grad_u, grad_u))
                print(f"path {tag} fwd+bwd{what}, fused against unfused: gradient wrt the "
                      f"coordinates ||g - g_u|| / ||g_u|| = {diff / norm:.3e} (tol {tol}), largest "
                      f"difference {(grad_f - grad_u).abs().max().item():.3e} of entries up to "
                      f"{grad_u.abs().max().item():.3e}")
                if not (diff <= tol * norm and bool(torch.isfinite(grad_f).all())):
                    raise AssertionError(
                        f"path {tag}{what}: fused and unfused fwd+bwd gradients disagree")
            del plain_net, grad_f, grad_u, model, model_u
            fused_step_against_unfused(f"path {tag}")

        net_train = make_net_a(**extra)
        step = make_denoise_train_step(net_train, make_fused_adam(net_train.parameters(), LR))
        noised = clouds_a["uniform"] + torch.randn_like(clouds_a["uniform"])
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launch_counts()
        losses = torch.stack([step(feats_a, noised, clouds_a["uniform"], None, None)
                              for _ in range(STEPS_A)]).cpu()
        train_counts = dict(LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        print(f"path {tag} training on one batch: {STEPS_A} steps, losses {losses.tolist()}; "
              f"launches {train_counts}; peak memory {peak / 2**30:.3f} GiB, of which "
              f"{held / 2**30:.3f} GiB were held before the first step")
        if not (bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]):
            raise AssertionError(f"path {tag}: the loss is not finite and falling")
        # the first layer gathers the inputs themselves, which carry no gradient
        # in a train step (there is no embedding under them), so its gather has
        # no backward: K2 runs depth - 1 times a step, and depth times in the
        # fwd+bwd above, whose coordinates do require a gradient
        metrics["peak_gib"], metrics["held_gib"] = peak / 2**30, held / 2**30
        for name, per_step in ((kernel, DEPTH), ("segment_sum", DEPTH - 1),
                               ("fused_pair_fwd", DEPTH if fused else 0),
                               ("fused_pair_bwd", DEPTH if fused else 0)):
            if train_counts[name] != per_step * STEPS_A:
                raise AssertionError(f"path {tag}: {name} launched {train_counts[name]} times in "
                                     f"{STEPS_A} steps, expected {per_step * STEPS_A}")

        with torch.inference_mode():
            for kind in dict.fromkeys(serve_kinds):
                ms = call_ms(torch, lambda: net(feats_a, clouds_a[kind]), iters=5, warmup=1)
                kernel_ms, launches = profile_forward(
                    torch, lambda: net(feats_a, clouds_a[kind]), iters=3,
                    label=f"path {tag} forwards ({kind})")
                metrics[f"forward_{kind}"] = (ms, kernel_ms, launches)
                print(f"path {tag} forward n={N_A} k={KNN_A} {kind}: median {ms:.4f} ms, "
                      f"{edges_a / (ms / 1e3):.6e} edges/s; kernel time {kernel_ms:.4f} ms, busy "
                      f"{kernel_ms / ms:.3f}, so the host (the route's reads of the card "
                      f"included) leaves the card idle {ms - kernel_ms:.4f} ms a forward")
        for kind in ("uniform", "gaussian"):
            ms = call_ms(torch, lambda: fwd_bwd(kind), iters=5, warmup=1)
            metrics[f"fwd_bwd_{kind}"] = ms
            print(f"path {tag} fwd+bwd (gradient wrt coordinates) {kind}: median {ms:.4f} ms, "
                  f"{edges_a / (ms / 1e3):.6e} edges/s")
        ms = call_ms(torch, lambda: step(feats_a, noised, clouds_a["uniform"], None, None),
                     iters=5, warmup=1)
        kernel_ms, launches = profile_forward(
            torch, lambda: step(feats_a, noised, clouds_a["uniform"], None, None), iters=3,
            label=f"path {tag} train steps", unit="step")
        metrics["step"] = (ms, kernel_ms, launches)
        print(f"path {tag} train step: median {ms:.4f} ms, {edges_a / (ms / 1e3):.6e} edges/s; "
              f"kernel time {kernel_ms:.4f} ms, busy {kernel_ms / ms:.3f}")

        # K2 at the path's backward: the indices of one layer (kc-wide on path A)
        with torch.inference_mode():
            nbhd, _ = nb.knn_select_gather(clouds_a["uniform"], KNN_A, math.inf, wide=True)
        time_segment_sum(f"path {tag}", nbhd.indices.reshape(1, -1), N_A, 3 + DIM, reps=3,
                         trials=5)
        del outs, net_train, step, grad, nbhd
        torch.cuda.empty_cache()
        return counts, metrics

    nb.GRID_AUTO = False   # the reference's own flag: auto stays on K5 beyond the reach
    path_a_counts, _ = drive_net65k(
        "A", "knn_candidates_packed_tiled", ("uniform", "uniform", "gaussian"),
        idle=("knn_select_tiled", "grid_knn_cells"))
    nb.GRID_AUTO = True
    ok_flag = torch.ones(N_A, dtype=torch.bool, device="cuda")
    sync_ms = call_ms(torch, lambda: bool(ok_flag.all()), iters=20, warmup=3)
    print(f"a certificate's host read on an idle card (all() and bool()): {sync_ms:.4f} ms")

    # ---- 14. path B: the anchor-3 family at n = 32768 through K4 ----
    def make_net_b(n, depth=DEPTH, seed=SEED):
        return EGNNNetwork(depth=depth, dim=DIM, num_tokens=NUM_TOKENS, num_positions=n,
                           layer_kwargs=LAYER_KWARGS, device="cuda",
                           generator=torch.Generator().manual_seed(seed))

    net_b = make_net_b(N_B).eval()
    requests_b = [synthetic_chain_batch(rng, 1, N_B, device="cuda") for _ in range(3)]
    reset_launch_counts()
    with torch.inference_mode():
        outs_b = [serve(rq, net_b) for rq in requests_b]
    torch.cuda.synchronize()
    path_b_counts = dict(LAUNCH_COUNTS)
    print(f"path B serving: {len(outs_b)} forwards at n={N_B} k={KNN}, mask, chain adjacency; "
          f"launches {path_b_counts}")
    if (path_b_counts["knn_select_tiled"] != DEPTH * len(outs_b)
            or path_b_counts["knn_select_gather"] != 0):
        raise AssertionError("path B: K4 did not run depth times a forward")
    for f, c in outs_b:
        check_outputs(torch, (f, c), ((1, N_B, DIM), (1, N_B, 3)), "path B forward")
    rq_b = requests_b[0]
    adj_b = rq_b.adj_mat.expand(1, N_B, N_B)
    check_equivariance(
        torch, lambda c: serve(rq_b._replace(noised_coors=c), net_b), rq_b.noised_coors,
        "path B",
        select=lambda c: K.knn_select_tiled(c.contiguous(), KNN, rq_b.mask, adj_b)[1]
        .sort(dim=-1).values,
        swap_share=SWAP_SHARE)

    net_b_train = make_net_b(N_B)
    step_b = make_denoise_train_step(net_b_train, make_fused_adam(net_b_train.parameters(), LR))
    reset_launch_counts()
    losses_b = torch.stack([step_b(*batch_args(rq_b)) for _ in range(STEPS_B)]).cpu()
    train_b_counts = dict(LAUNCH_COUNTS)
    print(f"path B training on one batch: {STEPS_B} steps, losses {losses_b.tolist()}; "
          f"launches {train_b_counts}")
    if not (bool(torch.isfinite(losses_b).all()) and losses_b[-1] < losses_b[0]):
        raise AssertionError("path B: the loss is not finite and falling")
    for name in ("knn_select_tiled", "segment_sum"):
        if train_b_counts[name] != DEPTH * STEPS_B:
            raise AssertionError(f"path B: {name} launched {train_b_counts[name]} times in "
                                 f"{STEPS_B} steps, expected {DEPTH * STEPS_B}")
    edges_b = N_B * KNN * DEPTH
    with torch.inference_mode():
        ms = call_ms(torch, lambda: serve(rq_b, net_b), iters=5, warmup=1)
        kernel_ms, _ = profile_forward(torch, lambda: serve(rq_b, net_b), iters=3,
                                    label="path B forwards")
    print(f"path B forward n={N_B} k={KNN}: median {ms:.4f} ms, {edges_b / (ms / 1e3):.6e} "
          f"edges/s; kernel time {kernel_ms:.4f} ms, busy {kernel_ms / ms:.3f}")
    ms = call_ms(torch, lambda: step_b(*batch_args(rq_b)), iters=3, warmup=1)
    kernel_ms, _ = profile_forward(torch, lambda: step_b(*batch_args(rq_b)), iters=2,
                                label="path B train steps", unit="step")
    print(f"path B train step: median {ms:.4f} ms, {edges_b / (ms / 1e3):.6e} edges/s; "
          f"kernel time {kernel_ms:.4f} ms, busy {kernel_ms / ms:.3f}")

    # K2 at path B's backward: K4's indices, with the masked rows' hub segments
    ids_b = K.knn_select_tiled(rq_b.noised_coors, KNN, rq_b.mask, adj_b)[1].reshape(1, -1)
    time_segment_sum("path B", ids_b, N_B, 3 + 1 + DIM, reps=2, trials=3,
                     note=f" ({int((~rq_b.mask).sum().item())} masked rows)")
    del outs_b, net_b_train, step_b, ids_b

    # ---- 15. both families just beyond the reach, depth 1, card against CPU ----
    net_small = make_net_a(depth=1, seed=SEED + 5).eval()
    feats_s, coors_s = feats_a[:, :N_CPU].contiguous(), cloud(torch, N_CPU, 3, "uniform", SEED + 92)
    rq_s = synthetic_chain_batch(rng, 1, N_CPU, device="cuda")
    net_chain = make_net_b(N_CPU, depth=1, seed=SEED + 6).eval()
    for what, model, args, kwargs, kernel, grid_auto in (
        ("net65k family through the grid", net_small, (feats_s, coors_s), {}, "grid_knn_cells",
         True),
        ("net65k family through K5", net_small, (feats_s, coors_s), {},
         "knn_candidates_packed_tiled", False),
        ("anchor-3 family", net_chain, (rq_s.tokens, rq_s.noised_coors),
         dict(adj_mat=rq_s.adj_mat, mask=rq_s.mask), "knn_select_tiled", True),
    ):
        nb.GRID_AUTO = grid_auto
        reset_launch_counts()
        with torch.inference_mode():
            f, c = model(*args, **kwargs)
            f_cpu, c_cpu = copy.deepcopy(model).to("cpu")(
                *(t.cpu() for t in args), **{k: v.cpu() for k, v in kwargs.items()})
        ef = (f.cpu() - f_cpu).abs().max().item()
        ec = (c.cpu() - c_cpu).abs().max().item()
        print(f"gpu vs cpu, {what} at n={N_CPU}, depth 1: feats max err {ef:.3e}, coors max "
              f"err {ec:.3e} (atol {GPU_VS_CPU_ATOL}); launches "
              f"{ {kn: v for kn, v in LAUNCH_COUNTS.items() if v} }")
        if not (ef <= GPU_VS_CPU_ATOL and ec <= GPU_VS_CPU_ATOL) or LAUNCH_COUNTS[kernel] != 1:
            raise AssertionError(f"{what}: card and CPU forwards disagree")
    nb.GRID_AUTO = True

    # ---- 16. timing of K4, K5, K6 at the shapes the paths give them ----
    coors_b, mask_b = rq_b.noised_coors, rq_b.mask
    coors_a = clouds_a["uniform"]
    coors_6 = cloud(torch, 16384, 3, "uniform", SEED + 81)
    kc_a = KNN_A + nb.CANDIDATE_SLACK
    for name, source, replaces, launches, shape, fn, plain in (
        ("knn_select_tiled", "egnn_tpu_torch/csrc/knn_select_large.cu",
         "egnn_tpu/ops/pallas/knn.py:1039", path_b_counts["knn_select_tiled"],
         (1, N_B, 3, KNN, True, N_B * N_B),
         lambda: K.knn_select_tiled(coors_b, KNN, mask_b, adj_b),
         lambda: K.knn_select_plain(coors_b, KNN, mask_b, adj_b, row_chunk=chunk(N_B))),
        ("knn_candidates_packed_tiled", "egnn_tpu_torch/csrc/knn_select_large.cu",
         "egnn_tpu/ops/pallas/knn.py:1414", path_a_counts["knn_candidates_packed_tiled"],
         (1, N_A, 3, kc_a, False, 0),
         lambda: K.knn_candidates_packed_tiled(coors_a, kc_a),
         lambda: K.knn_candidates_packed_tiled_plain(coors_a, kc_a, row_chunk=chunk(N_A))),
        ("knn_candidates_packed", "egnn_tpu_torch/csrc/knn_select_large.cu",
         "egnn_tpu/ops/pallas/knn.py:1208", packed_counts["knn_candidates_packed"],
         (1, 16384, 3, kc_a, False, 0),
         lambda: K.knn_candidates_packed(coors_6, kc_a),
         lambda: K.knn_candidates_packed_plain(coors_6, kc_a, row_chunk=chunk(16384))),
    ):
        b, n, c, k, wm, adj_bytes = shape
        ms_plain_a = call_ms(torch, plain, iters=3, warmup=1)
        ms_a = device_ms(torch, fn, reps=3, trials=5)
        ms_b = device_ms(torch, fn, reps=3, trials=5)
        ms_plain_b = call_ms(torch, plain, iters=3, warmup=1)
        t_bytes, t_ops = knn_bound_parts(b, n, c, k, 0, wm, adj_bytes)
        bound_ms, bound_by = knn_bound(b, n, c, k, 0, wm, adj_bytes)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err[name],
            "ms": min(ms_a, ms_b), "plain_ms": min(ms_plain_a, ms_plain_b),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes this selection (fills, tie
            # order, truncated keys)
            "library_ms": None,
        })
        rows, cols = block_plan(n, c, k, adj_bytes > 0)
        print(f"timing {name} at b={b} n={n} k={k} mask={wm} adjacency bytes={adj_bytes}, "
              f"{rows} rows a warp, {cols} columns a lane a step: "
              f"kernel {ms_a:.5f}/{ms_b:.5f} ms, plain {ms_plain_a:.5f}/{ms_plain_b:.5f} ms "
              f"(row chunks of {chunk(n)}), bound {bound_ms:.6f} ms ({bound_by}; bytes "
              f"{t_bytes:.6f} ms, operations {t_ops:.6f} ms); no library call computes it")
    ms_k4_a = device_ms(torch, lambda: K.knn_select_tiled(coors_a, KNN_A), reps=3, trials=5)
    t_bytes, t_ops = knn_bound_parts(1, N_A, 3, KNN_A, 0, False, 0)
    rows, cols = block_plan(N_A, 3, KNN_A)
    print(f"timing knn_select_tiled at n={N_A} k={KNN_A}, no mask or adjacency, {rows} rows a "
          f"warp, {cols} columns a lane a step: kernel {ms_k4_a:.5f} ms; bound bytes "
          f"{t_bytes:.6f} ms, operations {t_ops:.6f} ms")

    # path B's 1 GiB adjacencies are not needed again
    del requests_b, rq_b, rq_s, adj_b, coors_b, mask_b, net_b, net_chain
    torch.cuda.empty_cache()

    # ---- 17. K7, K8, K9 against their plain versions, bitwise ----
    for name in ("grid_knn_cells", "knn_select_queries", "knn_select_window"):
        max_err[name] = 0.0

    def tenth_mask(n):
        return (torch.arange(n, device="cuda") % 10 != 3)[None, :]

    def cell_tables(coors, mask, gdim):
        _, counts, _, order = spatial.assign_cells(coors, mask, gdim)
        return GK.cell_csr(counts, order) + (counts,)

    k7_cases = [  # name, n, k, cloud, mask
        ("n8192_k8", 8192, 8, "uniform", False),
        ("n20480_k16_mask", 20480, 16, "gaussian", True),
        ("n65536_k16", N_A, KNN_A, "uniform", False),        # the reference's resident kernel
        ("n65536_k16_mask", N_A, KNN_A, "gaussian", True),
        ("n131072_k16", 2 * N_A, KNN_A, "uniform", False),   # its streamed kernel (gdim 13)
        ("n131072_k8_mask", 2 * N_A, 8, "gaussian", True),
        ("k128", N_A, 128, "gaussian", False),               # four list slots a lane
        ("lattice_ties", 32768, 16, "lattice", False),       # distance ties inside a block
        ("k48", 20480, 48, "gaussian", False),               # two list slots a lane
        ("k64_mask", 32768, 64, "uniform", True),
        ("ties", 20480, 16, "ties", False),                  # 320 copies a site: cells past 128
    ]
    for i, (name, n, k, kind, wm) in enumerate(k7_cases):
        coors = cloud(torch, n, 3, kind, SEED + 100 + i)
        mask = tenth_mask(n) if wm else None
        gdim = GK.grid_kernel_gdim(n)
        cell_start, cell_nodes, counts = cell_tables(coors, mask, gdim)
        v, ix = GK.grid_knn_cells(coors, cell_start, cell_nodes, k, gdim)
        pv, pi = GK.grid_knn_cells_plain(coors, cell_start, cell_nodes, k, gdim, cell_chunk=16)
        # the whole selection with its certificate: certified rows are K4's
        sv, si, s_ok, s_rx = GK.grid_knn_select(coors, k, mask)
        rv, ri = K.knn_select_tiled(coors, k, mask)
        torch.cuda.synchronize()
        ok = same_bits(torch, v, pv) and torch.equal(ix, pi)
        certified = same_bits(torch, sv[s_rx], rv[s_rx]) and torch.equal(si[s_rx], ri[s_rx])
        finite = torch.isfinite(pv)
        err = (v[finite] - pv[finite]).abs().max().item()
        max_err["grid_knn_cells"] = max(max_err["grid_knn_cells"], err)
        print(f"K7 case {name}: n={n} k={k} gdim={gdim} cloud={kind} mask={wm}, fullest cell "
              f"{counts[:, :-1].max().item()}: bitwise={ok} (max err {err}); certificate "
              f"ok={bool(s_ok)}, {int((~s_rx).sum())} rows fail it, the others equal K4's "
              f"bitwise={certified}")
        if not (ok and certified):
            raise AssertionError(f"K7 case {name}: kernel and plain version differ, or a "
                                 "certified row differs from K4's")
    # K7's plan as the source makes it: candidates a lane a step, the values
    # a merge takes and the cells' order; the CPU model must take the same
    k7_plan = GK.built_grid_plan()
    if k7_plan != (GK.GRID_RUN, GK.GRID_BATCH, GK.GRID_ORDER):
        raise AssertionError(f"K7's source takes (candidates a lane, values a merge, cell "
                             f"order) {k7_plan}, the CPU model ({GK.GRID_RUN}, "
                             f"{GK.GRID_BATCH}, {GK.GRID_ORDER})")
    print(f"K7 plan (candidates a lane, values a merge, cell order): {k7_plan}")
    # hand-made cells: one of a single node, one of exactly 128, two past 128
    # (their nodes beyond the 128th have no row), 61 and 221 nodes (no
    # multiple of queries a warp x warps), nodes in no cell; on the card
    # against the plain version and against the CPU model at the source's plan
    n_hand, gdim_hand = 900, 4
    g_hand = torch.Generator(device="cuda").manual_seed(SEED + 114)
    coors_hand = torch.rand(1, n_hand, 3, generator=g_hand, device="cuda")
    coors_hand[0, 300:340] = coors_hand[0, 7]                  # a pile at distance 0
    counts_hand = torch.zeros(1, gdim_hand ** 3 + 1, dtype=torch.int64, device="cuda")
    counts_hand[0, [0, 1, 5, 21, 22, 42, 63]] = torch.tensor([1, 61, 128, 200, 150, 129, 221],
                                                            device="cuda")
    order_hand = torch.randperm(n_hand, generator=g_hand, device="cuda")[None]
    cs_hand, cn_hand = GK.cell_csr(counts_hand, order_hand)
    for k in (1, 16, 48, 128):
        v, ix = GK.grid_knn_cells(coors_hand, cs_hand, cn_hand, k, gdim_hand)
        pv, pi = GK.grid_knn_cells_plain(coors_hand, cs_hand, cn_hand, k, gdim_hand)
        mv, mi, mcounts = GK.grid_knn_cells_model(coors_hand.cpu(), cs_hand.cpu(), cn_hand.cpu(), k,
                                                  gdim_hand)
        torch.cuda.synchronize()
        ok = same_bits(torch, v, pv) and torch.equal(ix, pi)
        ok_model = same_bits(torch, v.cpu(), mv) and torch.equal(ix.cpu(), mi)
        print(f"K7 case hand_cells_k{k}: cells of 1, 61, 128, 129, 150, 200, 221 nodes: "
              f"bitwise={ok}, the CPU model's bitwise={ok_model} ({mcounts})")
        if not (ok and ok_model):
            raise AssertionError(f"K7 case hand_cells_k{k}: kernel, plain version and model "
                                 "differ")

    # a batch of two clouds, the second masked
    pair = torch.cat([cloud(torch, 8192, 3, "uniform", SEED + 111),
                      cloud(torch, 8192, 3, "gaussian", SEED + 112)])
    pair_mask = torch.cat([torch.ones_like(tenth_mask(8192)), tenth_mask(8192)])
    gdim = GK.grid_kernel_gdim(8192)
    cell_start, cell_nodes, _ = cell_tables(pair, pair_mask, gdim)
    v, ix = GK.grid_knn_cells(pair, cell_start, cell_nodes, KNN, gdim)
    pv, pi = GK.grid_knn_cells_plain(pair, cell_start, cell_nodes, KNN, gdim, cell_chunk=16)
    ok = same_bits(torch, v, pv) and torch.equal(ix, pi)
    print(f"K7 case batch_of_two: b=2 n=8192 k={KNN}: bitwise={ok}")
    if not ok:
        raise AssertionError("K7 case batch_of_two: kernel and plain version differ")
    reset_launch_counts()
    pile = GK.grid_knn_select(cloud(torch, 20480, 3, "ties", SEED + 110), KNN)
    print(f"K7 duplicate pile-up (64 sites, 320 nodes each): ok={bool(pile[2])}, rows trusted "
          f"{int(pile[3].sum())}, K7 launches {LAUNCH_COUNTS['grid_knn_cells']} (early reject)")
    if bool(pile[2]) or bool(pile[3].any()) or LAUNCH_COUNTS["grid_knn_cells"]:
        raise AssertionError("the pile-up must skip the kernel and trust no row")

    def pick_rows(mask, n, r, seed):
        """r valid rows, ascending."""
        g = torch.Generator(device="cuda").manual_seed(seed)
        rows = torch.arange(n, device="cuda") if mask is None else torch.nonzero(mask[0])[:, 0]
        return rows[torch.randperm(len(rows), generator=g, device="cuda")[:r]].sort().values[None]

    def take_rows(t, fidx):
        return torch.gather(t, 1, fidx if t.dim() == 2 else
                            fidx[..., None].expand(*fidx.shape, t.shape[-1])).contiguous()

    k8_cases = [  # name, n, k, R, cloud, mask, c
        ("r128", N_A, KNN_A, 128, "gaussian", False, 3),
        ("r2800_mask", N_A, KNN_A, 2800, "gaussian", True, 3),
        ("r_quarter", N_A, KNN_A, N_A // 4, "uniform", False, 3),
        ("n20000_mask", 20000, KNN, 5000, "uniform", True, 3),   # n not a multiple of 128
        ("ties", 20480, KNN, 1280, "ties", True, 3),
        ("k128_mask", 4096, 128, 1024, "gaussian", True, 3),
        ("r1", N_A, KNN_A, 1, "gaussian", True, 3),             # eight warps a row
        ("r5", N_A, KNN_A, 5, "uniform", False, 3),             # fewer rows than a block's warps
        ("n20000_r700_mask", 20000, KNN, 700, "gaussian", True, 3),   # stripes of 20 and 19 steps
        ("k48_r300_mask", 20000, 48, 300, "uniform", True, 3),
        ("c5_r700", 20000, KNN_A, 700, "gaussian", False, 5),      # c != 3: the predicated loop
        ("c5_r2000_mask", 20000, KNN_A, 2000, "uniform", True, 5),
    ]
    for i, (name, n, k, r, kind, wm, c) in enumerate(k8_cases):
        coors = cloud(torch, n, c, kind, SEED + 120 + i)
        mask = tenth_mask(n) if wm else None
        # any rows, masked ones too: their result is the fill
        fidx = pick_rows(None, n, r, SEED + 130 + i)
        q, qm = take_rows(coors, fidx), (None if mask is None else take_rows(mask, fidx))
        v, ix = K.knn_select_queries(q, coors, k, qm, mask)
        pv, pi = K.knn_select_queries_plain(q, coors, k, qm, mask, row_chunk=chunk(n))
        rv, ri = K.knn_select_tiled(coors, k, mask)
        torch.cuda.synchronize()
        ok = same_bits(torch, v, pv) and torch.equal(ix, pi)
        rows_of_k4 = same_bits(torch, v, take_rows(rv, fidx)) and torch.equal(
            ix, take_rows(ri, fidx))
        err = (v - pv).abs().max().item()
        max_err["knn_select_queries"] = max(max_err["knn_select_queries"], err)
        rows, cols, stripes = K.built_plan("knn_select_queries", 1, r, c, k, sms)
        if cols != K.BLOCK_RUN:
            raise AssertionError(f"K8's source ranks {cols} columns a lane a step, the CPU model "
                                 f"{K.BLOCK_RUN}")
        print(f"K8 case {name}: n={n} c={c} k={k} R={r} cloud={kind} mask={wm}, {rows} rows a "
              f"warp, {stripes} warps a row: bitwise={ok} (max err {err}); equals K4's rows "
              f"bitwise={rows_of_k4}")
        if not (ok and rows_of_k4):
            raise AssertionError(f"K8 case {name}: kernel, plain version and K4 differ")

    # the CPU model of K8's traversal at the source's plan, against the card
    for name, n, k, r, wm in (("n20000_r700_mask", 20000, KNN, 700, True),
                              ("n4100_r9_k48", 4100, 48, 9, True)):
        coors = cloud(torch, n, 3, "gaussian", SEED + 135)
        mask = tenth_mask(n) if wm else None
        fidx = pick_rows(None, n, r, SEED + 136)
        q, qm = take_rows(coors, fidx), (None if mask is None else take_rows(mask, fidx))
        v, ix = K.knn_select_queries(q, coors, k, qm, mask)
        rows, _, stripes = K.built_plan("knn_select_queries", 1, r, 3, k, sms)
        mv, mi, mcounts = K.knn_select_block_model(
            coors.cpu(), k, None if mask is None else mask.cpu(), None, 0, rows, None, q.cpu(),
            None if qm is None else qm.cpu(), stripes)
        ok = same_bits(torch, v.cpu(), mv) and torch.equal(ix.cpu(), mi)
        print(f"K8 model {name}: {rows} rows a warp, {stripes} warps a row: the CPU model's "
              f"bitwise={ok} ({mcounts})")
        if not ok:
            raise AssertionError(f"K8 model {name}: kernel and CPU model differ")

    def window_inputs(coors, mask, fidx):
        """The dispatcher's preparation: the x-sort (masked points last), the
        nodes' x-ranks, the query rows sorted by rank."""
        n = coors.shape[1]
        xkey = coors[..., 0] if mask is None else torch.where(mask, coors[..., 0], math.inf)
        order = torch.sort(xkey, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device="cuda").expand_as(order))
        fidx = take_rows(fidx, take_rows(rank, fidx).sort(dim=1).indices)
        return (take_rows(coors, fidx), take_rows(rank, fidx), take_rows(coors, order), order,
                None if mask is None else take_rows(mask, order), fidx)

    k9_cases = [  # name, n, k, R, W, cloud, mask
        ("w_quarter", N_A, KNN_A, 4096, N_A // 4, "gaussian", False),
        ("w_quarter_mask", N_A, KNN_A, 3500, N_A // 4, "heavy", True),
        ("w_full", N_A, KNN_A, 1000, N_A, "uniform", False),
        ("n20000_mask", 20000, KNN, 1250, 5120, "gaussian", True),   # n not a multiple of 128
        ("n20000_w_full", 20000, KNN, 500, 20096, "uniform", False),
        ("ties", 20480, KNN, 1280, 5120, "ties", False),
        ("k128_mask", 8192, 128, 512, 2048, "gaussian", True),
    ]
    for i, (name, n, k, r, w, kind, wm) in enumerate(k9_cases):
        coors = cloud(torch, n, 3, kind, SEED + 140 + i)
        mask = tenth_mask(n) if wm else None
        q, qr, pts, order, pm, fidx = window_inputs(coors, mask,
                                                    pick_rows(mask, n, r, SEED + 150 + i))
        v, ix, mg = K.knn_select_window(q, qr, pts, order, k, w, pm)
        pv, pi, pmg = K.knn_select_window_plain(q, qr, pts, order, k, w, pm,
                                                row_chunk=max(1, (1 << 25) // w))
        rv, ri = K.knn_select_tiled(coors, k, mask)
        torch.cuda.synchronize()
        ok = same_bits(torch, v, pv) and torch.equal(ix, pi) and same_bits(torch, mg, pmg)
        cert = v[..., k - 1] < mg * mg
        if mask is not None:
            cert = cert & (v[..., k - 1] < nb.MASKED_RANK_FILL)
        rows_of_k4 = same_bits(torch, v[cert], take_rows(rv, fidx)[cert]) and torch.equal(
            ix[cert], take_rows(ri, fidx)[cert])
        err = (v - pv).abs().max().item()
        max_err["knn_select_window"] = max(max_err["knn_select_window"], err)
        ti = K._pick_ti_window(w, K._lane_pad(n), r)
        rows, _, stripes = K.built_plan("knn_select_window", 1, r, 3, k, sms, ti=ti)
        print(f"K9 case {name}: n={n} k={k} R={r} W={w} cloud={kind} mask={wm}, groups of {ti} "
              f"rows, {rows} rows a warp, {stripes} warps a row: vals, idx and margin "
              f"bitwise={ok} (max err {err}); its margin certifies "
              f"{cert.float().mean().item():.4f} of the rows, which equal K4's "
              f"bitwise={rows_of_k4}")
        if not (ok and rows_of_k4):
            raise AssertionError(f"K9 case {name}: kernel and plain version differ, or a "
                                 "certified row differs from K4's")
        if name in ("n20000_mask", "ties"):
            # the CPU model of K9's traversal at the source's plan, and windows
            # that start on any column: the kernel against the plain selection
            # at the same starts
            ti, starts, _ = K._window_plan(q, qr, pts, k, w, pm)
            mv, mi, mcounts = K.knn_select_block_model(
                pts.cpu(), k, cpu(pm), None, 0, rows, None, q.cpu(), None, stripes,
                window=(starts.cpu(), ti, w, order.cpu()))
            ok_model = same_bits(torch, v.cpu(), mv) and torch.equal(ix.cpu(), mi)
            g_start = torch.Generator(device="cuda").manual_seed(SEED + 158 + i)
            odd = torch.randint(0, n - w // 2, starts.shape, generator=g_start, device="cuda")
            odd[0, :3] = torch.tensor([1, 2, 3], device="cuda")
            ov, oi = K._launch_window(q, pts, order, k, w, pm, ti, odd)
            opv, opi = K._window_select_plain(q.float(), pts, order, k, w, pm, ti, odd,
                                              max(1, (1 << 25) // w))
            ok_odd = same_bits(torch, ov, opv) and torch.equal(oi, opi)
            print(f"K9 case {name}: the CPU model's bitwise={ok_model} ({mcounts}); at "
                  f"{odd.shape[1]} windows from columns {odd[0, :6].tolist()}...: "
                  f"bitwise={ok_odd}")
            if not (ok_model and ok_odd):
                raise AssertionError(f"K9 case {name}: kernel and CPU model differ, or a window "
                                     "from an odd column differs from the plain selection")

    # K8 and K9 on the batch of two
    fidx = torch.cat([pick_rows(pair_mask[bi:bi + 1], 8192, 700, SEED + 113 + bi)
                      for bi in range(2)])
    q, qm = take_rows(pair, fidx), take_rows(pair_mask, fidx)
    v, ix = K.knn_select_queries(q, pair, KNN, qm, pair_mask)
    pv, pi = K.knn_select_queries_plain(q, pair, KNN, qm, pair_mask, row_chunk=chunk(8192))
    ok8 = same_bits(torch, v, pv) and torch.equal(ix, pi)
    q, qr, pts, order, pm, _ = window_inputs(pair, pair_mask, fidx)
    v, ix, mg = K.knn_select_window(q, qr, pts, order, KNN, 2048, pm)
    pv, pi, pmg = K.knn_select_window_plain(q, qr, pts, order, KNN, 2048, pm, row_chunk=4096)
    ok9 = same_bits(torch, v, pv) and torch.equal(ix, pi) and same_bits(torch, mg, pmg)
    print(f"K8 and K9 case batch_of_two: b=2 n=8192 k={KNN} R=700 (W=2048): K8 bitwise={ok8}, "
          f"K9 bitwise={ok9}")
    if not (ok8 and ok9):
        raise AssertionError("batch_of_two: K8 or K9 differs from its plain version")

    # ---- 18. the grid route on the card, arm by arm ----
    repaired_rows = []          # the rows each K8 call of an arm was given
    launch_queries = K.knn_select_queries

    def recording_queries(queries, *args, **kwargs):
        repaired_rows.append(queries.shape[1])
        return launch_queries(queries, *args, **kwargs)

    def check_arm(name, n, k, kind, seed, wm, backends, expect):
        coors = cloud(torch, n, 3, kind, seed)
        mask = tenth_mask(n) if wm else None
        select = GK.grid_knn_select if GK.supports_grid_knn(n, k) else spatial.grid_knn_select
        nbad = int((~select(coors, k, mask)[3]).sum())
        ref_v, ref_i = K.knn_select_tiled(coors, k, mask)
        for backend in backends:
            reset_launch_counts()
            repaired_rows.clear()
            K.knn_select_queries = recording_queries
            try:
                nbhd, _ = nb.knn_select_gather(coors, k, math.inf, mask=mask, backend=backend)
            finally:
                K.knn_select_queries = launch_queries
            torch.cuda.synchronize()
            counts = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
            ok = (torch.equal(nbhd.indices, ref_i) and same_bits(torch, nbhd.ranking, ref_v)
                  and nbhd.winner is None)
            print(f"grid arm {name}: n={n} k={k} cloud={kind} mask={wm} backend={backend}: "
                  f"{nbad} rows fail the certificate (3n/64={3 * n // 64}, n/16={n // 16}, "
                  f"n/4={n // 4}); K8 was given {repaired_rows} rows; equals K4 bitwise={ok}; "
                  f"launches {counts}")
            if not ok or not expect(counts):
                raise AssertionError(f"grid arm {name}: selection differs from K4's or the "
                                     f"launches {counts} are not the arm's")

    def launched(**wanted):
        """A check that exactly these kernels ran, each that many times."""
        return lambda counts: counts == wanted

    check_arm("certified whole", N_A, KNN_A, "uniform", SEED + 160, False, ("grid", "auto"),
              launched(grid_knn_cells=1))
    check_arm("direct repair", N_A, KNN_A, "gaussian", SEED + 161, False, ("grid", "auto"),
              launched(grid_knn_cells=1, knn_select_queries=1))
    check_arm("direct repair, mask", N_A, KNN_A, "gaussian", SEED + 162, True, ("auto",),
              launched(grid_knn_cells=1, knn_select_queries=1))
    # a share in (3n/64, n/16]: K9, then K8 on the rows its margin left
    def window_arm(counts):
        return (counts.get("grid_knn_cells") == 1 and counts.get("knn_select_window") == 1
                and counts.get("knn_select_queries", 0) <= 1 and len(counts) <= 3)

    check_arm("window tier", N_A, KNN_A, "heavy", SEED + 163, False, ("grid", "auto"), window_arm)
    check_arm("window tier, mask", N_A, KNN_A, "heavy", SEED + 164, True, ("auto",), window_arm)
    check_arm("n/4 bucket", N_A, KNN_A, "tail", SEED + 165, False, ("auto",),
              launched(grid_knn_cells=1, knn_select_queries=1))
    # a cell overflows in spite of the equal-mass edges: no K7, the packed fallback
    check_arm("whole-call fallback", N_A, KNN_A, "diagonal", SEED + 166, False, ("auto",),
              lambda c: "grid_knn_cells" not in c and c.get("knn_candidates_packed_tiled") == 1)
    # below the kernel's gate backend="grid" is the plain-torch grid
    check_arm("plain-torch grid", 4096, KNN, "gaussian", SEED + 167, True, ("grid",),
              launched(knn_select_queries=1))

    # a batch: the cloud with fewer failing rows pads its repair with certified ones
    ref_v, ref_i = K.knn_select_tiled(pair, KNN, pair_mask)
    reset_launch_counts()
    nbhd, _ = nb.knn_select_gather(pair, KNN, math.inf, mask=pair_mask)
    ok = torch.equal(nbhd.indices, ref_i) and same_bits(torch, nbhd.ranking, ref_v)
    counts = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
    print(f"grid arm batch of two: b=2 n=8192 k={KNN} backend=auto: equals K4 bitwise={ok}; "
          f"launches {counts}")
    if not ok or counts != {"grid_knn_cells": 1, "knn_select_queries": 1}:
        raise AssertionError("grid arm batch of two: selection differs from K4's, or the "
                             "launches are not K7 and K8 once each")

    # ---- 19. path C: net65k as auto routes it, through the grid ----
    path_c_counts, path_c_metrics = drive_net65k(
        "C", "grid_knn_cells", ("uniform", "uniform", "gaussian", "heavy"),
        idle=("knn_candidates_packed_tiled", "knn_select_tiled"),
        also=("knn_select_queries", "knn_select_window"))

    # ---- 20. timing of K7, K8, K9 at the shapes path C gives them ----
    def time_rows_kernel(name, replaces, source, what, fn, plain, nbytes, pairs):
        ms_plain_a = call_ms(torch, plain, iters=2, warmup=1)
        ms_a = device_ms(torch, fn, reps=3, trials=5)
        ms_b = device_ms(torch, fn, reps=3, trials=5)
        ms_plain_b = call_ms(torch, plain, iters=2, warmup=1)
        bound_ms, bound_by, t_bytes, t_ops = pairs_bound(nbytes, pairs)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_c_counts[name], "max_abs_err": max_err[name],
            "ms": min(ms_a, ms_b), "plain_ms": min(ms_plain_a, ms_plain_b),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call selects by (distance, id) within cell
            # blocks, a row subset or a window, with these fills
            "library_ms": None,
        })
        print(f"timing {name} at {what}: kernel {ms_a:.5f}/{ms_b:.5f} ms, plain "
              f"{ms_plain_a:.5f}/{ms_plain_b:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}; bytes "
              f"{t_bytes:.6f} ms, operations {t_ops:.6f} ms over {pairs} real pairs); no library "
              "call computes it")

    def k7_work(coors, k):
        """K7's inputs at ``coors`` and what it must do there: the bytes of
        its tables and outputs, and the real pairs (every node times the
        nodes of its 27 cells)."""
        n = coors.shape[1]
        gdim = GK.grid_kernel_gdim(n)
        cell_start, cell_nodes, counts = cell_tables(coors, None, gdim)
        cell_cand = counts[:, spatial.neighbor_cells(gdim, coors.device)].sum(dim=-1)
        pairs = int((counts[:, :-1] * cell_cand).sum())
        nbytes = 12 * n + 4 * (gdim ** 3 + 1) + 4 * n + 12 * n * k
        return gdim, cell_start, cell_nodes, nbytes, pairs

    gdim, cell_start, cell_nodes, nbytes, pairs = k7_work(coors_a, KNN_A)
    time_rows_kernel(
        "grid_knn_cells", "egnn_tpu/ops/pallas/grid_knn.py:225,281",
        "egnn_tpu_torch/csrc/grid_knn.cu", f"n={N_A} k={KNN_A} gdim={gdim} (uniform)",
        lambda: GK.grid_knn_cells(coors_a, cell_start, cell_nodes, KNN_A, gdim),
        lambda: GK.grid_knn_cells_plain(coors_a, cell_start, cell_nodes, KNN_A, gdim,
                                        cell_chunk=16), nbytes, pairs)
    coors_2a = cloud(torch, 2 * N_A, 3, "uniform", SEED + 170)
    gdim2, cs2, cn2, nbytes2, pairs2 = k7_work(coors_2a, KNN_A)
    ms_k7b = device_ms(torch, lambda: GK.grid_knn_cells(coors_2a, cs2, cn2, KNN_A, gdim2), reps=3,
                       trials=5)
    ms_k7b_plain = call_ms(torch, lambda: GK.grid_knn_cells_plain(
        coors_2a, cs2, cn2, KNN_A, gdim2, cell_chunk=16), iters=2, warmup=1)
    bound2 = pairs_bound(nbytes2, pairs2)
    print(f"timing grid_knn_cells at n={2 * N_A} k={KNN_A} gdim={gdim2} (the size of the "
          f"reference's streamed kernel): kernel {ms_k7b:.5f} ms, plain {ms_k7b_plain:.5f} ms; "
          f"bound {bound2[0]:.6f} ms ({bound2[1]}) over {pairs2} real pairs; no library call "
          f"computes it")
    # first timed here: K7 at k = 128 (four list slots, one query a warp)
    ms_k128 = device_ms(torch, lambda: GK.grid_knn_cells(coors_a, cell_start, cell_nodes, 128,
                                                         gdim), reps=3, trials=5)
    b128 = pairs_bound(12 * N_A + 4 * (gdim ** 3 + 1) + 4 * N_A + 12 * N_A * 128, pairs)
    print(f"timing grid_knn_cells at n={N_A} k=128 gdim={gdim} (uniform): kernel {ms_k128:.5f} "
          f"ms, bound {b128[0]:.6f} ms ({b128[1]})")
    for source, keep in (("grid_knn", r"grid_knn_kernel"),
                         # the c = 3 instantiations of K1 and K3, K8, K9 (the last
                         # template argument: 1, 2, 3)
                         ("knn_select_large", r"knn_select_block_kernel.*Li3ELb.ELb.ELi[123]EE")):
        for name, regs, st, ld in ptxas_kernels(build, source, keep):
            print(f"ptxas {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    with torch.inference_mode():
        for kind in ("uniform", "gaussian", "heavy"):
            c_kind = clouds_a[kind]
            sel_ms = call_ms(torch, lambda: GK.grid_knn_select(c_kind, KNN_A), iters=10, warmup=2)
            route_ms = call_ms(torch, lambda: nb.knn_select_gather(c_kind, KNN_A, math.inf),
                               iters=10, warmup=2)
            kernel_ms, _ = profile_forward(
                torch, lambda: nb.knn_select_gather(c_kind, KNN_A, math.inf), iters=5,
                label=f"grid route calls ({kind})", unit="call")
            print(f"one grid route call at n={N_A} k={KNN_A} {kind}: {route_ms:.4f} ms a call, "
                  f"kernel time {kernel_ms:.4f} ms; grid_knn_select alone (cell assignment, "
                  f"the early read, K7, certificate) {sel_ms:.4f} ms a call")

    # K8 and K9 on the rows that fail the certificate on path C's clouds
    for name, replaces, kind in (
        ("knn_select_queries", "egnn_tpu/ops/pallas/knn.py:616", "gaussian"),
        ("knn_select_window", "egnn_tpu/ops/pallas/knn.py:779", "heavy"),
    ):
        c_kind = clouds_a[kind]
        bad = ~GK.grid_knn_select(c_kind, KNN_A)[3]
        fidx = torch.nonzero(bad[0])[:, 0][None]
        r = fidx.shape[1]
        if name == "knn_select_queries":
            q = take_rows(c_kind, fidx)
            time_rows_kernel(
                name, replaces, "egnn_tpu_torch/csrc/knn_select_large.cu",
                f"R={r} rows of n={N_A}, k={KNN_A} ({kind})",
                lambda: K.knn_select_queries(q, c_kind, KNN_A),
                lambda: K.knn_select_queries_plain(q, c_kind, KNN_A, row_chunk=chunk(N_A)),
                12 * r + 12 * N_A + 12 * r * KNN_A, r * N_A)
            # first timed here: K8 at R = n/4, the n/4 bucket's largest repair
            rq = N_A // 4
            q4 = take_rows(c_kind, pick_rows(None, N_A, rq, SEED + 171))
            ms_q4 = device_ms(torch, lambda: K.knn_select_queries(q4, c_kind, KNN_A), reps=3,
                              trials=5)
            bq4 = pairs_bound(12 * rq + 12 * N_A + 12 * rq * KNN_A, rq * N_A)
            print(f"timing knn_select_queries at R={rq} rows of n={N_A}, k={KNN_A} ({kind}), "
                  f"{K.built_plan('knn_select_queries', 1, rq, 3, KNN_A, sms)} (rows a warp, "
                  f"columns a lane, warps a row): kernel {ms_q4:.5f} ms, bound {bq4[0]:.6f} ms "
                  f"({bq4[1]})")
        else:
            w = N_A // 4
            q, qr, pts, order, _, _ = window_inputs(c_kind, None, fidx)
            ti = K._pick_ti_window(w, K._lane_pad(N_A), r)
            rows, _, stripes = K.built_plan(name, 1, r, 3, KNN_A, sms, ti=ti)
            time_rows_kernel(
                name, replaces, "egnn_tpu_torch/csrc/knn_select_large.cu",
                f"R={r} rows, W={w} of n={N_A}, k={KNN_A} ({kind}; the window's starts and "
                f"the margins, computed in torch, included), groups of {ti} rows, {rows} rows "
                f"a warp, {stripes} warps a row",
                lambda: K.knn_select_window(q, qr, pts, order, KNN_A, w),
                lambda: K.knn_select_window_plain(q, qr, pts, order, KNN_A, w,
                                                  row_chunk=max(1, (1 << 25) // w)),
                # queries, ranks, points, ids; vals, idx, margin
                12 * r + 8 * r + 12 * N_A + 8 * N_A + 12 * r * KNN_A + 4 * r, r * w)
            # K8 on the rows that K9's margin leaves, as the route hands them
            # over: below two blocks an SM at one row a warp (block_plan)
            handed = []

            def keep_queries(queries, *args, **kwargs):
                handed.append((queries, args, kwargs))
                return launch_queries(queries, *args, **kwargs)

            K.knn_select_queries = keep_queries
            try:
                nb.knn_select_gather(c_kind, KNN_A, math.inf)
            finally:
                K.knn_select_queries = launch_queries
            if len(handed) != 1:
                raise AssertionError(f"the {kind} cloud's route called K8 {len(handed)} times")
            qh, args, kwargs = handed[0]
            rh = qh.shape[1]
            ms_h = device_ms(torch, lambda: launch_queries(qh, *args, **kwargs), reps=10,
                             trials=5)
            bh = pairs_bound(12 * rh + 12 * N_A + 12 * rh * KNN_A, rh * N_A)
            print(f"timing knn_select_queries at the R={rh} rows K9 leaves on the {kind} cloud, "
                  f"{K.built_plan('knn_select_queries', 1, rh, 3, KNN_A, sms)} (rows a warp, "
                  f"columns a lane, warps a row): kernel {ms_h:.5f} ms, bound {bh[0]:.6f} ms "
                  f"({bh[1]})")


    # ---- 21. K10 and K11 against their plain versions in float64 ----
    pair_err = {"fused_pair_fwd": 0.0, "fused_pair_bwd": 0.0, "fused_knn_fwd": 0.0,
                "fused_knn_bwd": 0.0}
    for layout in ((64, 3, DIM, 130, 16, 64, 0, False), (8, 3, 64, 258, 16, 64, 0, False),
                   (24, 5, 0, 74, 8, 32, 2, True), (64, 3, 16, 66, 16, 64, 4, True),
                   (32, 3, DIM, 130, 16, 64, 0, False), (24, 3, 0, 130, 16, 64, 0, False),
                   (32, 3, 10, 54, 12, 48, 3, True)):
        # the wrapper's copy of the shared-memory layout; the forward's with
        # its staging region for one node and for rows / 8
        for backward, ti in ((False, 1), (False, layout[0] // 8), (True, 1)):
            if PM._smem_floats(*layout, backward, ti) != PM.kernel_smem_floats(*layout, backward,
                                                                               ti):
                raise AssertionError(f"the wrapper's layout {layout} (backward={backward}, "
                                     f"ti={ti}) differs from the source's")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fwd_edges = dict.fromkeys(("a tile below the gates' 64 rows", "a 64-row tile",
                               "a partial last tile", "blocks with unequal tile counts",
                               "a block's tiles in two batch elements",
                               "three nodes of kc = 20 a tile", "h not a multiple of 5",
                               "a 64-row tile at h not a multiple of 5", "repeated ids"), False)
    for i, (name, kw) in enumerate(pair_cases()):
        case = pair_case(torch, SEED + 200 + i, **kw)
        b, n, k = case["idx"].shape
        c_w, m_w = case["coors"].shape[-1], case["weights"][2].shape[-1]
        h_w, o = case["proj_i"].shape[-1], case["opts"]
        for gather, prefix in ((False, "fused_pair"), (True, "fused_knn")):
            # the forward's tile and grid here, and which of its edges they reach
            d_w = 0 if gather else case["feats"].shape[-1]
            widths = (c_w, d_w, h_w, m_w, 4 * m_w, o["fourier"], o["soft_edges"])
            rows_f = PM._fwd_tile_rows(b, n, k, *widths, sms)
            ti, grid = PM.launch_grid(b, n, k, rows_f, False, "cuda")
            per_b = -(-n // ti)
            tiles = b * per_b
            fwd_edges["a tile below the gates' 64 rows"] |= rows_f < PM._tile_rows(k, *widths)
            fwd_edges["a 64-row tile"] |= rows_f == 64
            fwd_edges["a partial last tile"] |= n % ti != 0
            fwd_edges["blocks with unequal tile counts"] |= tiles % grid != 0
            fwd_edges["a block's tiles in two batch elements"] |= any(
                len({t // per_b for t in range(blk, tiles, grid)}) > 1 for blk in range(grid))
            fwd_edges["three nodes of kc = 20 a tile"] |= k == 20 and ti == 3
            fwd_edges["h not a multiple of 5"] |= h_w % 5 != 0
            fwd_edges["a 64-row tile at h not a multiple of 5"] |= rows_f == 64 and h_w % 5 != 0
            fwd_edges["repeated ids"] |= gather and "id_pool" in kw
            print(f"{'K11' if gather else 'K10'}f case {name}: a forward tile of {rows_f} rows "
                  f"({ti} nodes), {tiles} tiles on a grid of {grid} blocks")
            e_f, e_b = check_pair_kernels(torch, PM, name, case, gather)
            pair_err[prefix + "_fwd"] = max(pair_err[prefix + "_fwd"], e_f)
            pair_err[prefix + "_bwd"] = max(pair_err[prefix + "_bwd"], e_b)
        del case
    torch.cuda.empty_cache()
    missed = [edge for edge, seen in fwd_edges.items() if not seen]
    print(f"the forward's edges reached by phase 21's cases: {sorted(fwd_edges)}")
    if missed:
        raise AssertionError(f"phase 21's cases no longer reach the forward's edges {missed}")

    # ---- 22. anchor 3 through the fused pair pipeline ----
    def make_anchor(seed=SEED, **extra):
        return EGNNNetwork(
            depth=DEPTH, dim=DIM, num_tokens=NUM_TOKENS, num_positions=N,
            layer_kwargs={**LAYER_KWARGS, **extra}, device="cuda",
            generator=torch.Generator().manual_seed(seed))

    def time_anchor(model, label):
        """(call ms, device ms, kernel ms, launches) of a b=1 forward, and of
        a b=1 train step on a fresh trainer of the same kind."""
        rq1 = requests[0]
        with torch.inference_mode():
            fwd = (call_ms(torch, lambda: serve(rq1, model)),
                   device_ms(torch, lambda: serve(rq1, model), reps=5),
                   *profile_forward(torch, lambda: serve(rq1, model),
                                    label=f"{label} b=1 forwards"))
        trainer = copy.deepcopy(model).train()
        step = make_denoise_train_step(trainer, make_fused_adam(trainer.parameters(), LR))
        args = batch_args(fixed[1])
        stp = (call_ms(torch, lambda: step(*args)),
               device_ms(torch, lambda: step(*args), reps=5),
               *profile_forward(torch, lambda: step(*args), label=f"{label} b=1 train steps",
                                unit="step"))
        return fwd, stp

    anchor_plain = make_anchor().eval()
    with torch.inference_mode():
        outs_plain = [serve(rq, anchor_plain) for rq in requests]
    anchor_times = {"unfused": time_anchor(anchor_plain, "anchor-3 unfused")}
    anchor_counts = {}
    for flag, fwd_name, bwd_name, select_name in (
        ("fused_pairs", "fused_pair_fwd", "fused_pair_bwd", "knn_select_gather"),
        ("fused_knn", "fused_knn_fwd", "fused_knn_bwd", "knn_select"),
    ):
        model = make_anchor(**{flag: True}).eval()   # the same seed: the same weights
        reset_launch_counts()
        with torch.inference_mode():
            outs_f = [serve(rq, model) for rq in requests]
        torch.cuda.synchronize()
        counts = dict(LAUNCH_COUNTS)
        print(f"anchor-3 {flag} serving: {len(requests)} forwards, {n_requests} requests; "
              f"launches { {kn: v for kn, v in counts.items() if v} }")
        if (counts[fwd_name] != DEPTH * len(requests)
                or counts[select_name] != DEPTH * len(requests)
                or sum(counts.values()) != 2 * DEPTH * len(requests)):
            raise AssertionError(f"{flag}: {fwd_name} and {select_name} did not each run depth "
                                 "times a forward, or another kernel ran")
        model_cpu = copy.deepcopy(model).to("cpu")
        for idx, (rq, (f, c), (f_u, c_u)) in enumerate(zip(requests, outs_f, outs_plain)):
            b = rq.tokens.shape[0]
            check_outputs(torch, (f, c), ((b, N, DIM), (b, N, 3)), f"{flag} forward")
            ef, ec = (f - f_u).abs().max().item(), (c - c_u).abs().max().item()
            if not (ef <= GPU_VS_CPU_ATOL and ec <= GPU_VS_CPU_ATOL):
                raise AssertionError(f"{flag}: fused and unfused forwards disagree "
                                     f"({ef:.3e}, {ec:.3e})")
            if idx in (0, len(requests) - 1):  # one b=1 and one b=8 forward
                with torch.inference_mode():
                    f_cpu, c_cpu = serve(type(rq)(*(t.cpu() for t in rq)), model_cpu)
                gf = (f.cpu() - f_cpu).abs().max().item()
                gc = (c.cpu() - c_cpu).abs().max().item()
                print(f"anchor-3 {flag} b={b}: against the unfused network on the card feats "
                      f"{ef:.3e}, coors {ec:.3e}; against the same module on the CPU feats "
                      f"{gf:.3e}, coors {gc:.3e} (atol {GPU_VS_CPU_ATOL})")
                if not (gf <= GPU_VS_CPU_ATOL and gc <= GPU_VS_CPU_ATOL):
                    raise AssertionError(f"{flag}: card and CPU forwards disagree")
        rq = requests[0]
        check_equivariance(torch, lambda c: serve(rq._replace(noised_coors=c), model),
                           rq.noised_coors, f"anchor-3 {flag} b=1")

        def make_fused_trainer(seed=SEED):
            net_f = make_anchor(seed, **{flag: True})
            return net_f, make_denoise_train_step(net_f, make_fused_adam(net_f.parameters(), LR))

        anchor_counts[flag] = {"serving": counts}
        for b in (1, 8):
            _, step = make_fused_trainer()
            batches = [synthetic_chain_batch(rng, b, N, device="cuda") for _ in range(TRAIN_STEPS)]
            reset_launch_counts()
            losses = torch.stack([step(*batch_args(rq)) for rq in batches]).cpu()
            torch.cuda.synchronize()
            counts = dict(LAUNCH_COUNTS)
            anchor_counts[flag][b] = counts
            print(f"anchor-3 {flag} training b={b}: {TRAIN_STEPS} steps, losses "
                  f"{losses.tolist()}; launches { {kn: v for kn, v in counts.items() if v} }")
            if not bool(torch.isfinite(losses).all()):
                raise AssertionError(f"{flag}: non-finite training loss")
            # K2 is K1's backward under fused_pairs, K11b's j-side sum under fused_knn
            for name in (fwd_name, bwd_name, select_name, "segment_sum"):
                if counts[name] != DEPTH * TRAIN_STEPS:
                    raise AssertionError(f"{flag}: {name} launched {counts[name]} times in "
                                         f"{TRAIN_STEPS} steps, expected {DEPTH * TRAIN_STEPS}")
        _, step = make_fused_trainer()
        falling = torch.stack([step(*batch_args(fixed[1])) for _ in range(FALL_STEPS)]).cpu()
        print(f"anchor-3 {flag} training b=1 on one batch: loss {falling[0].item():.6f} -> "
              f"{falling[-1].item():.6f} over {FALL_STEPS} steps")
        if not falling[-1] < falling[0]:
            raise AssertionError(f"{flag}: the loss did not fall on a fixed batch")

        # one step on the card against the CPU and against the unfused network
        for b in (1, 8):
            net_f, step = make_fused_trainer(SEED + 3)
            net_c = copy.deepcopy(net_f).to("cpu")
            step_c = make_denoise_train_step(net_c, make_fused_adam(net_c.parameters(), LR))
            net_u = make_anchor(SEED + 3)
            step_u = make_denoise_train_step(net_u, make_fused_adam(net_u.parameters(), LR))
            rq = fixed[b]
            loss = step(*batch_args(rq)).item()
            loss_u = step_u(*batch_args(rq)).item()
            loss_c = step_c(*(t.cpu() for t in batch_args(rq))).item()
            errs = {"CPU": [], "unfused": []}
            for (name, p), q, u in zip(net_f.named_parameters(), net_c.parameters(),
                                       net_u.parameters()):
                if p.grad is None:
                    if q.grad is not None or u.grad is not None:
                        raise AssertionError(f"{flag}: {name} has a gradient on one path only")
                    continue
                for key, other, tol in (("CPU", q.grad, FUSED_CARD_VS_CPU_GRAD_TOL),
                                        ("unfused", u.grad.cpu(), FUSED_VS_UNFUSED_GRAD_TOL)):
                    gp, go = p.grad.cpu().double(), other.double()
                    diff, norm = (torch.linalg.vector_norm(x).item() for x in (gp - go, go))
                    errs[key].append((diff / max(norm, 1e-300), name))
                    if diff > tol * norm + 1e-12:
                        raise AssertionError(f"{flag}: gradients of {name} on the card and "
                                             f"{key} disagree: {diff:.3e} against {norm:.3e}")
            print(f"anchor-3 {flag} one step b={b}: loss {loss:.8f}, unfused on the card "
                  f"{loss_u:.8f}, the same module on the CPU {loss_c:.8f} (rtol "
                  f"{TRAIN_LOSS_RTOL}); gradient error ||g - g_ref|| / ||g_ref|| largest "
                  f"{max(errs['CPU'])[0]:.3e} ({max(errs['CPU'])[1]}) against the CPU, "
                  f"{max(errs['unfused'])[0]:.3e} ({max(errs['unfused'])[1]}) against the unfused "
                  f"network (tol {FUSED_CARD_VS_CPU_GRAD_TOL} and {FUSED_VS_UNFUSED_GRAD_TOL})")
            if (abs(loss - loss_c) > TRAIN_LOSS_RTOL * abs(loss_c)
                    or abs(loss - loss_u) > TRAIN_LOSS_RTOL * abs(loss_u)):
                raise AssertionError(f"{flag}: the card's loss disagrees with the CPU's or the "
                                     "unfused network's")
        anchor_times[flag] = time_anchor(model, f"anchor-3 {flag}")
        del model, model_cpu, outs_f
    for kind, (fwd, stp) in anchor_times.items():
        print(f"anchor-3 b=1 {kind}: forward {fwd[0]:.4f} ms a call, device {fwd[1]:.4f} ms (CUDA "
              f"graph replay), kernel time {fwd[2]:.4f} ms, {fwd[3]:.1f} launches; train step "
              f"{stp[0]:.4f} ms a call ({N * KNN * DEPTH / (stp[0] / 1e3):.6e} edges/s), device "
              f"{stp[1]:.4f} ms, kernel time {stp[2]:.4f} ms, busy {stp[2] / stp[0]:.3f}, "
              f"{stp[3]:.1f} launches")
    del anchor_plain, outs_plain

    # ---- 23. net65k through the fused pair pipeline: path C, then path A ----
    path_cf_counts, path_cf_metrics = drive_net65k(
        "C fused", "grid_knn_cells", ("uniform", "gaussian", "heavy"),
        idle=("knn_candidates_packed_tiled", "knn_select_tiled"),
        also=("knn_select_queries", "knn_select_window"), fused=True)

    def beside(what, fused_m, plain_m):
        for key in ("forward_uniform", "forward_gaussian", "forward_heavy", "step"):
            f, u = fused_m[key], plain_m[key]
            print(f"{what} {key}: fused {f[0]:.4f} ms (kernel time {f[1]:.4f} ms, {f[2]:.1f} "
                  f"launches) beside unfused {u[0]:.4f} ms ({u[1]:.4f} ms, {u[2]:.1f})")
        for key in ("fwd_bwd_uniform", "fwd_bwd_gaussian"):
            print(f"{what} {key}: fused {fused_m[key]:.4f} ms beside unfused {plain_m[key]:.4f} ms")
        print(f"{what} peak memory of {STEPS_A} train steps: fused {fused_m['peak_gib']:.3f} GiB "
              f"({fused_m['held_gib']:.3f} held before) beside unfused "
              f"{plain_m['peak_gib']:.3f} GiB ({plain_m['held_gib']:.3f})")

    beside("path C", path_cf_metrics, path_c_metrics)

    # path A: K5's kc = 20 candidate slots, summed by K10 under the winner mask
    nb.GRID_AUTO = False
    kc_a = KNN_A + nb.CANDIDATE_SLACK
    net_af, net_au = make_net_a(fused_pairs=True).eval(), make_net_a().eval()
    reset_launch_counts()
    with torch.inference_mode():
        f_f, c_f = net_af(feats_a, clouds_a["uniform"])
    torch.cuda.synchronize()
    counts = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
    with torch.inference_mode():
        f_u, c_u = net_au(feats_a, clouds_a["uniform"])
    check_outputs(torch, (f_f, c_f), ((1, N_A, DIM), (1, N_A, 3)), "path A fused forward")
    ef, ec = (f_f - f_u).abs().max().item(), (c_f - c_u).abs().max().item()
    print(f"path A fused forward at n={N_A} k={KNN_A} over kc={kc_a} slots: launches {counts}; "
          f"against the unfused network feats max err {ef:.3e}, coors max err {ec:.3e} (atol "
          f"{GPU_VS_CPU_ATOL})")
    if (counts != {"knn_candidates_packed_tiled": DEPTH, "fused_pair_fwd": DEPTH}
            or not (ef <= GPU_VS_CPU_ATOL and ec <= GPU_VS_CPU_ATOL)):
        raise AssertionError("path A fused: K5 and K10f did not each run depth times, or the "
                             "fused and unfused forwards disagree")
    check_equivariance(
        torch, lambda c: net_af(feats_a, c), clouds_a["uniform"], "path A fused",
        select=lambda c: K.knn_select_tiled(c.contiguous(), KNN_A)[1].sort(dim=-1).values,
        swap_share=SWAP_SHARE)
    noised = clouds_a["uniform"] + torch.randn_like(clouds_a["uniform"])
    path_af = {}
    for kind, model in (("fused", net_af), ("unfused", net_au)):
        trainer = copy.deepcopy(model).train()
        step = make_denoise_train_step(trainer, make_fused_adam(trainer.parameters(), LR))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        loss = step(feats_a, noised, clouds_a["uniform"], None, None).item()
        counts = {kn: v for kn, v in LAUNCH_COUNTS.items() if v}
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode():
            fwd_ms = call_ms(torch, lambda: model(feats_a, clouds_a["uniform"]), iters=5, warmup=1)
        step_ms = call_ms(torch, lambda: step(feats_a, noised, clouds_a["uniform"], None, None),
                          iters=5, warmup=1)
        path_af[kind] = (loss, fwd_ms, step_ms, peak / 2**30)
        print(f"path A {kind}: one train step, loss {loss:.8f}, launches {counts}; forward "
              f"{fwd_ms:.4f} ms, train step {step_ms:.4f} ms "
              f"({edges_a / (step_ms / 1e3):.6e} edges/s), peak memory {peak / 2**30:.3f} GiB")
        if kind == "fused" and counts != {
                "knn_candidates_packed_tiled": DEPTH, "fused_pair_fwd": DEPTH,
                "fused_pair_bwd": DEPTH, "segment_sum": DEPTH - 1}:
            raise AssertionError("path A fused step: launches are not K5, K10f, K10b depth "
                                 "times and K2 depth - 1 times")
        del trainer, step
    if not (math.isfinite(path_af["fused"][0]) and abs(path_af["fused"][0] - path_af["unfused"][0])
            <= TRAIN_LOSS_RTOL * abs(path_af["unfused"][0])):
        raise AssertionError("path A fused: the step's loss disagrees with the unfused network's")
    fused_step_against_unfused("path A fused")
    nb.GRID_AUTO = True
    del net_af, net_au, f_f, c_f, f_u, c_u
    torch.cuda.empty_cache()

    # ---- 24. K10 and K11 at the shapes the paths give them: check, then timing ----
    def real_case(coors, idx, pv, seed):
        """pair_case at this neighbourhood: the path's coordinates, ids and
        validity, random features, weights and upstream gradients."""
        b, n, k = idx.shape
        case = pair_case(torch, seed, b=b, n=n, k=k)
        case.update(coors=coors.contiguous(), idx=idx.contiguous(), pv=pv.contiguous())
        return case

    rq = requests[0]
    adj1 = rq.adj_mat.expand(1, N, N)
    with torch.no_grad():   # not inference mode: the unfused pipeline's autograd saves the ids
        idx_anchor = K.knn_select(rq.noised_coors, KNN, rq.mask, adj1)[1]
        pv_anchor = rq.mask[:, :, None] & core.gather_bool(rq.mask, idx_anchor)
        nbhd_c, _ = nb.knn_select_gather(clouds_a["uniform"], KNN_A, math.inf, wide=True)
        nb.GRID_AUTO = False
        nbhd_a, _ = nb.knn_select_gather(clouds_a["uniform"], KNN_A, math.inf, wide=True)
        nb.GRID_AUTO = True
    timing_cases = [  # what, case, the kernels timed there, (reps, trials)
        (f"anchor 3's shape (b=1 n={N} k={KNN}, its mask, adjacency and self pairs)",
         real_case(rq.noised_coors, idx_anchor, pv_anchor, SEED + 300), (False, True), (20, 7)),
        (f"path C's shape (n={N_A} k={KNN_A}, the grid's neighbours)",
         real_case(clouds_a["uniform"], nbhd_c.indices, torch.ones_like(nbhd_c.valid),
                   SEED + 301), (False, True), (3, 5)),
        (f"path A's shape (n={N_A} kc={kc_a} slots, pv = the winner mask)",
         real_case(clouds_a["uniform"], nbhd_a.indices, nbhd_a.winner, SEED + 302), (False,),
         (3, 5)),
    ]
    site = {"fused_pair_fwd": "egnn_tpu/ops/pallas/pair_messages.py:379",
            "fused_pair_bwd": "egnn_tpu/ops/pallas/pair_messages.py:425",
            "fused_knn_fwd": "egnn_tpu/ops/pallas/knn_layer.py:380",
            "fused_knn_bwd": "egnn_tpu/ops/pallas/knn_layer.py:419"}
    launches = {"fused_pair_fwd": anchor_counts["fused_pairs"]["serving"]["fused_pair_fwd"],
                "fused_pair_bwd": anchor_counts["fused_pairs"][1]["fused_pair_bwd"],
                "fused_knn_fwd": anchor_counts["fused_knn"]["serving"]["fused_knn_fwd"],
                "fused_knn_bwd": anchor_counts["fused_knn"][1]["fused_knn_bwd"]}
    for case_no, (what, case, gathers, (reps, trials)) in enumerate(timing_cases):
        b, n, k = case["idx"].shape
        g = (case["g_mi"], case["g_cd"])
        # the unfused pipeline starts from K10's gathered rows; under K11 its
        # gathers (of coors and of the projected features) are part of it
        pre_args, pre_weights, opts = pair_args(torch, PM, case, False, torch.float32)
        table = torch.cat([case["coors"], case["feats"]], dim=-1)

        def unfused_forward(gather, args=pre_args, weights=pre_weights, rows_of=table):
            args = list(args)
            if gather:
                rows = core.gather_nodes(rows_of, case["idx"])
                args[1], args[2] = (rows[..., :3].reshape(b, n * k, 3),
                                    rows[..., 3:].reshape(b, n * k, -1))
            return unfused_pipeline(torch, core, *args, weights, opts)

        def unfused_fwd_bwd(gather):
            """The gradient of everything K10 (or K11, whose j side is the
            table under the gather) differentiates."""
            leaf = lambda t: t.detach().requires_grad_()  # noqa: E731
            args = [leaf(t) if i in ((0, 3) if gather else (0, 1, 2, 3)) else t
                    for i, t in enumerate(pre_args)]
            weights, rows_of = [leaf(w) for w in pre_weights], leaf(table)
            out = unfused_forward(gather, args, weights, rows_of)
            leaves = [t for t in args if t.requires_grad] + weights + ([rows_of] if gather else [])
            return torch.autograd.grad(out, leaves, g, allow_unused=True)

        for gather in gathers:
            prefix = "fused_knn" if gather else "fused_pair"
            # the path's own neighbourhood against the float64 plain versions
            e_f, e_b = check_pair_kernels(torch, PM, what, case, gather)
            pair_err[prefix + "_fwd"] = max(pair_err[prefix + "_fwd"], e_f)
            pair_err[prefix + "_bwd"] = max(pair_err[prefix + "_bwd"], e_b)
            torch.cuda.empty_cache()
            args, weights, kopts = pair_args(torch, PM, case, gather, torch.float32)
            fwd, bwd = ((PM.fused_knn_messages_forward, PM.fused_knn_messages_backward) if gather
                        else (PM.fused_pair_messages_forward, PM.fused_pair_messages_backward))
            plain_f, plain_b = ((PM.fused_knn_messages_plain, PM.fused_knn_messages_backward_plain)
                                if gather else (PM.fused_pair_messages_plain,
                                                PM.fused_pair_messages_backward_plain))
            with torch.no_grad():
                timed = {
                    "fwd": [lambda: fwd(*args, weights, kopts),
                            lambda: plain_f(*args, weights, kopts)],
                    "bwd": [lambda: bwd(*args, weights, *g, kopts),
                            lambda: plain_b(*args, weights, *g, kopts)],
                }
                ms = {}
                for key, (kernel_fn, plain_fn) in timed.items():
                    p_a = device_ms(torch, plain_fn, reps=reps, trials=trials)
                    k_a = device_ms(torch, kernel_fn, reps=reps, trials=trials)
                    k_b = device_ms(torch, kernel_fn, reps=reps, trials=trials)
                    p_b = device_ms(torch, plain_fn, reps=reps, trials=trials)
                    ms[key] = (k_a, k_b, p_a, p_b)
            with torch.no_grad():
                u_fwd = device_ms(torch, lambda: unfused_forward(gather), reps=reps, trials=trials)
            u_both = device_ms(torch, lambda: unfused_fwd_bwd(gather), reps=reps, trials=trials)
            unfused = {"fwd": u_fwd, "bwd": u_both - u_fwd}
            # each kernel's tile, grid and blocks an SM at this shape
            d_k = 0 if gather else DIM
            h_k = case["proj_i"].shape[-1]
            tile_line = {}
            for key, backward in (("fwd", False), ("bwd", True)):
                rows_t = (PM._bwd_tile_rows(k, 3, d_k, h_k, 16, 64, 0, False) if backward else
                          PM._fwd_tile_rows(b, n, k, 3, d_k, h_k, 16, 64, 0, False, sms))
                by_layout = (PM._bwd_blocks_per_sm(rows_t, 3, d_k, h_k, 16, 64, 0, False)
                             if backward else None)
                _, grid_t = PM.launch_grid(b, n, k, rows_t, backward, "cuda", by_layout)
                per_sm = PM.kernel_blocks_per_sm(rows_t, k, 3, d_k, h_k, 16, 64, 0, False,
                                                 gather, backward)
                tile_line[key] = (f"a tile of {rows_t} rows, a grid of {grid_t} blocks, "
                                  f"{per_sm} blocks an SM")
            for key in ("fwd", "bwd"):
                k_a, k_b, p_a, p_b = ms[key]
                bound_ms, bound_by, t_bytes, t_ops = pair_bound(
                    b, n, k, 3, DIM, case["proj_i"].shape[-1], 16, 0, False, gather, key == "bwd")
                print(f"timing {prefix}_{key} at {what}: kernel {k_a:.5f}/{k_b:.5f} ms"
                      f"{' (K2 on the j-side rows included)' if gather and key == 'bwd' else ''}, "
                      f"plain {p_a:.5f}/{p_b:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}; bytes "
                      f"{t_bytes:.6f} ms, operations {t_ops:.6f} ms); no single library call "
                      f"computes it: the unfused pipeline of torch operators on the same pairs "
                      f"{unfused[key]:.5f} ms"
                      f"{' (its fwd+bwd less its forward)' if key == 'bwd' else ''}"
                      + (f"; {launches[prefix + '_bwd']} launches on the main path (anchor 3's "
                         f"b=1 steps)" if key == "bwd" else "") + f"; here {tile_line[key]}")
                if case_no == 0:   # the JSON line's row: anchor 3's shape
                    kernels.append({
                        "name": f"{prefix}_{key}", "route": "cuda",
                        "source": "egnn_tpu_torch/csrc/pair_messages.cu",
                        "replaces": site[f"{prefix}_{key}"],
                        "launches": launches[f"{prefix}_{key}"],
                        "max_abs_err": pair_err[f"{prefix}_{key}"],
                        "ms": min(k_a, k_b), "plain_ms": min(p_a, p_b),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        # no single PyTorch call computes the pipeline: this is the
                        # unfused layer's chain of torch operators on the same pairs
                        "library_ms": unfused[key],
                    })
        del case
        torch.cuda.empty_cache()

    parent = sys.argv[sys.argv.index("--parent-source") + 1] if "--parent-source" in sys.argv \
        else None
    sparse_phases(torch, parent)
    dense_option_phases(torch)
    eager_trainers = host_runtime_phases(torch, smi)
    parallel_phases(torch, smi)
    model_parallel_phases(torch, smi)
    kernels.extend(mode_phase(torch, smi, parent))
    kernels.extend(graph_axis_phases(torch, smi))
    last_options_phase(torch, smi)
    trainer_block_phase(torch, smi, eager_trainers)
    dense_dim64_phase(torch, smi)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
