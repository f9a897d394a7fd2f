"""Kernels K10 and K11 (the fused pair pipeline of the dense kNN layer,
forward and backward), their plain PyTorch versions and their gates.

- K10f / K10b ``fused_pair_messages`` replace the TPU kernels of
  ``egnn_tpu/ops/pallas/pair_messages.py:fused_pair_messages`` (``_fwd_kernel``,
  ``_bwd_kernel``): the pipeline on pre-gathered neighbour rows.
- K11f / K11b ``fused_knn_messages`` replace those of
  ``egnn_tpu/ops/pallas/knn_layer.py:fused_knn_messages``: the same pipeline
  reading ``coors[idx]`` and ``proj_j[idx]`` itself, from the i side's own
  rows or from a j table of its own (``coors_j``: the node-sharded layer's
  gathered cloud; launches ``fused_knn_{fwd,bwd}_table``).

For each pair row r = (node i, slot t)::

    rel = c_i - c_j;  dist = |rel|^2;  distf = [sin(dist/2^f).., cos(dist/2^f).., dist]
    h1 = proj_i[i] + fj @ Wj + distf @ Wd      (K11: proj_i[i] + proj_j[idx] + distf @ Wd)
    m0 = silu(silu(h1) @ W2 + b2);  msg = m0 * sigmoid(m0 @ gw + gb) if soft_edges else m0
    cmsg = m0 if gate_feats_only else msg
    wz = silu(cmsg @ cW1 + cb1) @ cW2 + cb2;  w = clip(wz * pv, +-clamp)
    rel_n = rel / sqrt(max(dist, eps^2)) * scale if norm_coors else rel
    m_i[i] = sum_t msg * pv;  coors_delta[i] = sum_t w * rel_n

All four run ``csrc/pair_messages.cu`` (one source, the gather a template
flag); its header gives the design and the bound on the card. The forward
takes a tile of its own (``_fwd_tile_rows``: whole nodes, at most the gates'
tile, sized to the pair count so that the card's block slots fill: 32 rows at
anchor 3's 8192 pairs, 64 at path C's million) and loads the next tile's
inputs while it computes. The backward recomputes the pipeline from the
inputs and saves nothing of pair size; it keeps its weight gradients in
registers, one owner thread an entry, on tiles of its own
(``_bwd_tile_rows``, about 32 pair rows, two blocks an SM where they fit,
else one). K11b
writes its j-side gradients in pair layout and sums them per node with the
segment-sum kernel K2 (order-free, bitwise equal to its model), so both
backwards repeat bit for bit.

A CUDA tensor launches the kernels or raises; a CPU tensor runs the plain
versions: ``*_plain`` (the pipeline in torch ops, any dtype) and
``*_backward_plain`` (the backward derived by hand, line for line the
kernel's formulas, not autograd of the forward), which the tests hold against
the JAX kernels and against float64 autograd, and ``chip_smoke.py`` holds the
kernels against on the card. Launches count into ``LAUNCH_COUNTS`` under
``fused_pair_fwd``, ``fused_pair_bwd``, ``fused_knn_fwd``, ``fused_knn_bwd``.

The gates state the kernel's own limits and nothing else: coordinate width
c <= 8, at most 16 Fourier encodings, k <= 64 slots, and widths (h, m, 4m,
d) at which the layouts the kernels launch with (``_smem_floats``) fit a
block's 227 KB of shared memory: the forward's on a tile of at least k pair
rows, the backward's on its least tile, one node. Anchor 3 (dim = 32,
h = 130, m = 16) takes a 64-row forward tile (110 KiB with its staging
region) and a 32-row backward one (99 KiB); the sparse molecule layer
(dim = 64, fourier 4, h = 274) forward tiles of up to 48 rows (176 KiB at
32), one block an SM, and 32-row backward tiles (217 KiB), one block an SM,
in both modes. The backward keeps the weight gradients of the widths it is
tuned for in registers and the rest in device memory
(``csrc/pair_messages.cu``, ``kWgSlots``; ``kOneBlockWgSlots`` in the
float32 instance of one block an SM).

The tensor-core mode of K10 (``mxu_bf16``, the TPU kernel's ``_mm_maker``
and ``dG``): the MLP products round their operands to bfloat16 (to nearest,
ties to even) and sum the exact products in float32; the geometry, the
elementwise chain and the k-sums stay float32. A forward product rounds
where its contraction has at least 8 elements (``_mm``), a backward one
where the contraction and every width of both operands have (``_dG``; the
pair rows of a JAX tile are ti * k >= 8, so the rule reads the widths
alone). K10f takes the four wide products onto the tensor cores (bf16
``mma.sync``), summed as K10b's recomputation sums them, so that the two
kernels round every value they share alike; it keeps the values it reads
only rounded (fj, s1, cmsg, silu(cz1)) as bf16 rows. K10b takes its
recomputation's three products and its four data gradients there and keeps
its weight gradients on the FMAs, rounding as it reads; they count under
``fused_pair_fwd_bf16`` and ``fused_pair_bwd_bf16``. The bf16 copies of the
weights and the bf16 rows lie in the place of their float32 copies and
lines, so the layouts and the gates are those of the float32 mode
(``_mode_fwd_fits``). ``mode_tie_pairs`` finds the pairs whose result may
part between two summation orders in the mode (``chip_smoke.py`` phase 43
takes them out for its tie-free rerun). Both modes' backwards take
one tile: where two blocks an SM hold no tile of 16 rows or more, the
largest that one block holds (``_bwd_tile_rows``: 32 rows at the sparse
molecule layer's widths, which fill the mode's m16 fragments), their grid
sized by that one block (``_bwd_blocks_per_sm``). The layers
ask ``mxu_bf16_for(device)``; K11 has no such mode, in either package.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from . import LAUNCH_COUNTS, build, raise_on_launch_error
from . import segment as seg_kernels

MAX_C = 8             # kMaxC in csrc/pair_messages.cu
MAX_FOURIER = 16      # kMaxFourier
MAX_ROWS = 64         # kMaxRows: pair rows of a tile, and so the most slots k
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472   # an SM's shared memory, of which each block takes 1 KB more
_ROW_SCALARS = 10     # kRowScalars
_FWD_BLOCKS_PER_SM, _BWD_BLOCKS_PER_SM = 2, 2
_BWD_ROWS = 32        # the backward's tile: whole nodes up to this many pair rows
_FWD_TILE_COST_ROWS = 16   # a forward tile's fixed cost (staging, barriers) in pair rows

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class _Shape(ctypes.Structure):
    """``Shape`` of csrc/pair_messages.cu."""
    _fields_ = [(name, _I) for name in (
        "b", "n", "k", "c", "d", "h", "m", "m4", "fourier", "ti", "rows",
        "soft_edges", "norm_coors", "has_clamp", "gate_feats_only", "mxu_bf16")] + [
        ("clamp", _F), ("eps", _F), ("nj", _I)]


_TENSOR_FIELDS = (
    "coors", "cj", "fj", "proj_i", "proj_j", "idx", "pv",
    "wj", "wd", "w2", "b2", "gw", "gb", "cw1", "cb1", "cw2", "cb2", "scale",
    "m_i", "cd", "g_mi", "g_cd", "d_ci", "d_cj", "d_fj", "d_pi", "d_pairs", "partial",
    "coors_j")


class _Tensors(ctypes.Structure):
    """``Tensors`` of csrc/pair_messages.cu: one pointer a field."""
    _fields_ = [(name, _P) for name in _TENSOR_FIELDS]


_ARGTYPES = [ctypes.POINTER(_Shape), ctypes.POINTER(_Tensors), _I, _I, _I, _P, _P]


class PairOptions(NamedTuple):
    """The pipeline's static options."""

    fourier: int
    soft_edges: bool
    norm_coors: bool
    clamp: Optional[float]
    eps: float
    gate_feats_only: bool = False
    mxu_bf16: bool = False


# ---------------------------------------------------------------------------
# the gates: the kernel's shared-memory layout, mirrored
# ---------------------------------------------------------------------------


def _grad_sizes(d, h, m, m4, fourier):
    """Element counts of the weight gradients, in the weight tuple's order
    (wj, wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2, scale): ``grad_layout``."""
    dd = 2 * fourier + 1
    return [d * h, dd * h, h * m, m, m, 1, m * m4, m4, m4, 1, 1]


def _weight_floats(d, h, m, m4, fourier):
    """Floats of the staged weights (odd row strides) and the misc scalars,
    rounded up to a float4: where the tile buffers begin."""
    dd = 2 * fourier + 1
    odd = lambda x: x | 1  # noqa: E731
    total = d * odd(h) + dd * odd(h) + h * odd(m) + 2 * m + m * odd(m4) + 2 * m4 + 3
    return (total + 3) & ~3


def _smem_floats(rows, c, d, h, m, m4, fourier, soft_edges, backward, ti=1):
    """Floats of shared memory a block keeps: ``make_layout`` of the source.
    Both keep the weights and the tile lines h1, fj, distf, m0, (msg), cz1,
    rel, the row scalars and the ids. The forward adds its staging region:
    a pair row's inputs (K10: cj, fj at an odd stride, pv; K11: int64 idx
    and pv) and the ``ti`` nodes' coordinates and proj_i rows. The backward
    adds the lines silu(h1), z2 and the gradient lines d_z2, d_rel, d_distf,
    d_cz1 and a line of ones; its weight gradients live in registers."""
    dd = 2 * fourier + 1
    ldr = rows + 4    # a tile buffer's line: the rows of one feature, padded
    msg = m if soft_edges else 0
    total = _weight_floats(d, h, m, m4, fourier)
    total += ldr * (h + d + dd + m + msg + m4 + c + _ROW_SCALARS + 1)
    if backward:
        total += ldr * (h + m) + ldr * (m + c + dd + m4 + 1)
    else:
        ldn = c + (d | 1) + 1 if d > 0 else 3
        total += rows * ldn + ti * (c + h)
    return total


def _mode_fwd_fits(rows, d, h, m, m4, fourier) -> bool:
    """Whether the tensor-core mode's forward finds room in the f32
    forward's layout (``bf16_copies`` and ``mode_rows`` of the source, which
    ``shape_ok`` checks): each bf16 copy of a weight whose widths are both
    at least 8, in W's orientation from the first 16-byte boundary of its
    f32 copy's place, and each tile's bf16 rows in the place of their f32
    lines (rows + 4 floats a line)."""
    dd, odd = 2 * fourier + 1, lambda x: x | 1  # noqa: E731
    up = lambda x, q: -(-x // q) * q  # noqa: E731
    w2 = (d + dd) * odd(h)
    places = [(d, h, 0, odd(h)), (dd, h, d * odd(h), odd(h)), (h, m, w2, odd(m)),
              (m, m4, w2 + h * odd(m) + 2 * m, odd(m4))]   # K, N, offset, f32 stride
    for K, N, off, ld32 in places:
        room = 2 * (K * ld32 - (((off + 3) & ~3) - off))
        if K >= 8 and N >= 8 and K * up(N, 8) > room:
            return False
    line = 2 * (rows + 4)                  # bf16 values in an f32 line's place
    for K, on in ((d, d >= 8 and h >= 8), (dd, dd >= 8 and h >= 8), (h, h >= 8)):
        if on and rows * up(K, 16) > K * line:
            return False
    cm = up(m, 16) if m >= 8 and m4 >= 8 else 0
    return m4 < 8 or rows * (up(m4, 16) + cm) <= m4 * line


def _tile_rows(k, c, d, h, m, m4, fourier, soft_edges) -> Optional[int]:
    """The gates' test and the forward's largest tile: the largest tile (a
    multiple of 8 pair rows, at least k, at most 64) whose forward layout,
    rows // k nodes, fits one block, where the backward's layout on its
    least tile (k rows rounded up to 8) fits one block too; else None. These
    are the layouts the kernels launch with and ``shape_ok`` of the source
    checks, so every shape that passes launches."""
    if not (1 <= k <= MAX_ROWS and 1 <= c <= MAX_C and 0 <= fourier <= MAX_FOURIER
            and h >= 1 and m >= 1 and m4 >= 1):
        return None
    fits = lambda rows, backward: 4 * _smem_floats(  # noqa: E731
        rows, c, d, h, m, m4, fourier, soft_edges, backward, rows // k) <= MAX_SMEM_BYTES
    if not fits(-(-k // 8) * 8, True):
        return None
    for rows in range(MAX_ROWS, 0, -8):
        if rows < k:
            return None
        if fits(rows, False):
            return rows
    return None


def _fits_sm(floats: int, blocks: int) -> bool:
    """Whether ``blocks`` blocks of this many floats fit one SM's shared
    memory (and one of them a block's limit)."""
    return 4 * floats <= MAX_SMEM_BYTES and blocks * (4 * floats + 1024) <= SM_SMEM_BYTES


def _bwd_tile_rows(k, c, d, h, m, m4, fourier, soft_edges) -> Optional[int]:
    """The backward's tile, in both modes: whole nodes, as many as fit in
    ``_BWD_ROWS`` pair rows (at least one), rounded up to a multiple of 8,
    and fewer nodes until ``_BWD_BLOCKS_PER_SM`` blocks fit an SM's shared
    memory. Where two blocks an SM fit no tile of 16 rows or more, the
    largest tile of whole nodes up to ``_BWD_ROWS`` rows that one block
    holds: a smaller tile pays the block's fixed costs (barriers, the
    weight-gradient pass) for few rows and half fills the tensor-core
    mode's m16 fragments (anchor 5's widths: 32 rows at one block an SM,
    where one node of 8 rows already takes 140 KiB). None where the gates
    refuse the shape (or no tile fits)."""
    if _tile_rows(k, c, d, h, m, m4, fourier, soft_edges) is None:
        return None
    floats = lambda rows: _smem_floats(  # noqa: E731
        rows, c, d, h, m, m4, fourier, soft_edges, True)
    tiles = [-(-ti * k // 8) * 8 for ti in range(max(1, _BWD_ROWS // k), 0, -1)]
    two = [rows for rows in tiles if _fits_sm(floats(rows), _BWD_BLOCKS_PER_SM)]
    if two and two[0] >= 16:
        return two[0]
    one = [rows for rows in tiles if _fits_sm(floats(rows), 1)]
    return one[0] if one else None


def _bwd_blocks_per_sm(rows, c, d, h, m, m4, fourier, soft_edges) -> int:
    """The blocks an SM the backward's grid is sized by (``launch_grid``),
    in both modes: those that one SM holds at this tile, two or one (the
    instance ``bwd_kernel`` of the source picks by the same test)."""
    floats = _smem_floats(rows, c, d, h, m, m4, fourier, soft_edges, True)
    return _BWD_BLOCKS_PER_SM if _fits_sm(floats, _BWD_BLOCKS_PER_SM) else 1


def _fwd_tile_rows(b, n, k, c, d, h, m, m4, fourier, soft_edges, sms) -> Optional[int]:
    """The forward's tile on a card of ``sms`` SMs: whole nodes (ti = rows //
    k), a multiple of 8 rows, at most the gates' tile (``_tile_rows``), and
    the one whose waves of tiles cost least, ``waves * (rows +
    _FWD_TILE_COST_ROWS)`` with ``waves = ceil(b * ceil(n / ti) / (sms *
    _FWD_BLOCKS_PER_SM))``: fewer rows where the tiles would leave block
    slots empty (anchor 3's 8192 pairs: 32 rows, 256 tiles for 264 slots on
    132 SMs), the gates' tile where every slot takes many (path C). Ties go
    to the larger tile. Only tiles whose layout fits ``_FWD_BLOCKS_PER_SM``
    blocks an SM compete, or, where none does, those that fit one. None
    where the gates refuse the shape."""
    gate = _tile_rows(k, c, d, h, m, m4, fourier, soft_edges)
    if gate is None:
        return None
    tiles = [rows for rows in range(gate, 0, -8) if rows >= k]
    floats = lambda rows: _smem_floats(  # noqa: E731
        rows, c, d, h, m, m4, fourier, soft_edges, False, rows // k)
    fit = ([rows for rows in tiles if _fits_sm(floats(rows), _FWD_BLOCKS_PER_SM)]
           or [rows for rows in tiles if _fits_sm(floats(rows), 1)])
    if not fit:
        return None
    slots = sms * _FWD_BLOCKS_PER_SM
    waves = lambda rows: -(-(b * -(-n // (rows // k))) // slots)  # noqa: E731
    return min(fit, key=lambda rows: waves(rows) * (rows + _FWD_TILE_COST_ROWS))


def kernel_smem_floats(rows, c, d, h, m, m4, fourier, soft_edges, backward, ti=1) -> int:
    """What the built source says of the same layout (``chip_smoke.py`` holds
    ``_smem_floats`` against it)."""
    shape = _Shape(b=1, n=1, k=1, c=c, d=d, h=h, m=m, m4=m4, fourier=fourier, ti=ti, rows=rows,
                   soft_edges=int(soft_edges))
    fn = build.function("pair_messages", "pair_messages_smem_floats",
                        [ctypes.POINTER(_Shape), _I])
    return fn(ctypes.byref(shape), int(backward))


def kernel_blocks_per_sm(rows, k, c, d, h, m, m4, fourier, soft_edges, gather,
                         backward, mxu_bf16=False) -> int:
    """Blocks of the kernel one SM of the current card holds at this shape
    (the CUDA occupancy calculator, for ``chip_smoke.py``'s timing lines)."""
    shape = _Shape(b=1, n=1, k=k, c=c, d=d, h=h, m=m, m4=m4, fourier=fourier, ti=rows // k,
                   rows=rows, soft_edges=int(soft_edges), mxu_bf16=int(mxu_bf16))
    fn = build.function("pair_messages", "pair_messages_blocks_per_sm",
                        [ctypes.POINTER(_Shape), _I, _I])
    return fn(ctypes.byref(shape), int(gather), int(backward))


def supports_fused_pair_messages(k: int, hidden: int, m_dim: int, dim: int, c: int = 3,
                                 fourier: int = 0, soft_edges: bool = False) -> bool:
    """Whether K10 takes k slots a node at these widths (see the module's
    docstring): a limit of the kernel's shared-memory layout, the same on
    the card and on the CPU, where the plain version runs."""
    return _tile_rows(k, c, dim, hidden, m_dim, 4 * m_dim, fourier, soft_edges) is not None


def supports_fused_knn_layer(k: int, hidden: int, m_dim: int, c: int = 3, fourier: int = 0,
                             soft_edges: bool = False) -> bool:
    """The same for K11, which stages no Wj."""
    return _tile_rows(k, c, 0, hidden, m_dim, 4 * m_dim, fourier, soft_edges) is not None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _silu(x):
    return x * torch.sigmoid(x)


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _fourier(dist, fourier: int):
    """[sin(d/2^f)..., cos(d/2^f)..., d] over the last axis (``ops/core.py:
    fourier_encode_dist``); dist (..., 1)."""
    if fourier == 0:
        return dist
    xs = [dist / (2.0 ** f) for f in range(fourier)]
    return torch.cat([torch.sin(x) for x in xs] + [torch.cos(x) for x in xs] + [dist], dim=-1)


def _d_fourier(dist, g_distf, fourier: int):
    """The chain rule of ``_fourier`` back to dist: (..., dd) -> (..., 1)."""
    if fourier == 0:
        return g_distf
    g = g_distf[..., -1:]
    for f in range(fourier):
        xs = dist / (2.0 ** f)
        g = g + g_distf[..., f:f + 1] * torch.cos(xs) / (2.0 ** f)
        g = g - g_distf[..., fourier + f:fourier + f + 1] * torch.sin(xs) / (2.0 ** f)
    return g


def _bf16(x):
    """x rounded to bfloat16 (to nearest, ties to even), in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _mm(a, b, opts: PairOptions):
    """A product of the forward (``_mm_maker``): in the mode both operands
    rounded where the contraction has at least 8 elements."""
    if opts.mxu_bf16 and a.shape[-1] >= 8:
        a, b = _bf16(a), _bf16(b)
    return a @ b


def _dG(a, b, opts: PairOptions, *widths):
    """A product of the backward (``dG``): in the mode both operands rounded
    where ``widths``, the contraction and every width of a and b other than
    the pair rows, are all at least 8."""
    if opts.mxu_bf16 and min(widths) >= 8:
        a, b = _bf16(a), _bf16(b)
    return a @ b


def mxu_bf16_for(device) -> bool:
    """Whether the layers run K10 in its tensor-core mode on ``device``: on
    a CUDA device where float32 products may drop to bfloat16,
    ``torch.get_float32_matmul_precision() == "medium"``. This is no knob
    of its own: it is the port's counterpart of the JAX layers'
    ``mxu_bf16=on_tpu``, whose mode is the TPU's default precision for float32
    products. Under the default ``"highest"`` and on the CPU the layers keep
    exact float32. On an H100 80GB HBM3 at 700 W the mode's K10f takes
    0.92-1.16x the float32 kernel's time over two runs of the smoke (below
    it at the sparse molecule layer's widths; 1.05-1.09x at anchor 3,
    1.12-1.16x at net65k's pairs, where the float32 kernel's own readings
    part by 6%), its K10b 1.4-1.6x at every width now that both take one
    tile (``PERF.md``): "medium" buys the TPU's numbers, not speed.
    ``fused_pair_messages(..., mxu_bf16=...)`` takes either mode directly."""
    return (torch.device(device).type == "cuda"
            and torch.get_float32_matmul_precision() == "medium")


def _tile_forward(coors, cj, hj, proj_i, pv, weights, opts: PairOptions):
    """Every intermediate of the pipeline. coors (b, n, c), cj (b, n, k, c),
    hj (b, n, k, h) the j-side term of h1, proj_i (b, n, h), pv (b, n, k, 1);
    weights without Wj."""
    wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2, scale = weights
    t = {}
    t["rel"] = rel = coors[:, :, None, :] - cj
    t["dist"] = dist = (rel * rel).sum(dim=-1, keepdim=True)
    t["distf"] = distf = _fourier(dist, opts.fourier)
    t["h1"] = h1 = proj_i[:, :, None, :] + hj + _mm(distf, wd, opts)
    t["s1"] = s1 = _silu(h1)
    t["z2"] = z2 = _mm(s1, w2, opts) + b2
    t["m0"] = m0 = _silu(z2)
    if opts.soft_edges:
        t["gate"] = gate = torch.sigmoid(_mm(m0, gw.reshape(-1, 1), opts) + gb.reshape(()))
        t["msg"] = msg = m0 * gate
    else:
        t["msg"] = msg = m0
    t["cmsg"] = cmsg = m0 if opts.gate_feats_only else msg
    t["cz1"] = cz1 = _mm(cmsg, cw1, opts) + cb1
    t["cs1"] = cs1 = _silu(cz1)
    t["wz"] = wz = _mm(cs1, cw2.reshape(-1, 1), opts) + cb2.reshape(())
    t["wm"] = wm = wz * pv
    t["w"] = wm.clamp(-opts.clamp, opts.clamp) if opts.clamp is not None else wm
    if opts.norm_coors:
        t["nrm"] = nrm = torch.sqrt(dist.clamp(min=opts.eps * opts.eps))
        t["rel_n"] = rel / nrm * scale.reshape(())
    else:
        t["rel_n"] = rel
    return t


def _aggregate(t, pv):
    return (t["msg"] * pv).sum(dim=2), (t["w"] * t["rel_n"]).sum(dim=2)


def _tile_backward(t, pv, weights, g_mi, g_cd, opts: PairOptions, keep=None):
    """The hand-derived backward of ``_tile_forward`` and ``_aggregate``:
    (d_rel (b, n, k, c), d_h1 (b, n, k, h), the gradients of the ten weights
    without Wj), by the formulas of the kernel. ``keep``, a dict, receives
    the pair gradients that the mode rounds: d_cz1, d_z2 and d_h1."""
    wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2, scale = weights
    rows = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
    gm_b, gc_b = g_mi[:, :, None, :], g_cd[:, :, None, :]

    # aggregation, clamp (strictly inside) and CoorsNorm
    d_msg = gm_b * pv
    d_w = (gc_b * t["rel_n"]).sum(dim=-1, keepdim=True)
    d_rel_n = t["w"] * gc_b
    if opts.clamp is not None:
        inside = (t["wm"] > -opts.clamp) & (t["wm"] < opts.clamp)
        d_w = d_w * inside.to(d_w.dtype)
    d_wz = d_w * pv
    d_dist = torch.zeros_like(t["dist"])
    d_scale = torch.zeros_like(scale)
    if opts.norm_coors:
        s, nrm = scale.reshape(()), t["nrm"]
        d_rel = d_rel_n * (s / nrm)
        dot = (d_rel_n * t["rel"]).sum(dim=-1, keepdim=True)
        live = (t["dist"] > opts.eps * opts.eps).to(dot.dtype)
        d_dist = d_dist + dot * (-s / (nrm * nrm)) * live * 0.5 / nrm
        d_scale = (dot / nrm).sum().reshape(scale.shape)
    else:
        d_rel = d_rel_n

    # coordinate-weight MLP
    d_cs1 = d_wz @ cw2.reshape(1, -1)
    d_cw2 = (rows(t["cs1"]).T @ rows(d_wz)).reshape(cw2.shape)
    d_cb2 = d_wz.sum().reshape(cb2.shape)
    d_cz1 = d_cs1 * _dsilu(t["cz1"])
    m, m4 = cw1.shape
    d_cmsg = _dG(d_cz1, cw1.T, opts, m4, m)
    d_cw1 = _dG(rows(t["cmsg"]).T, rows(d_cz1), opts, m, m4)
    d_cb1 = rows(d_cz1).sum(dim=0).reshape(cb1.shape)
    gfo = opts.gate_feats_only
    if not gfo:
        d_msg = d_msg + d_cmsg

    # soft gate
    if opts.soft_edges:
        gate = t["gate"]
        d_g = (d_msg * t["m0"]).sum(dim=-1, keepdim=True)
        d_zg = d_g * gate * (1.0 - gate)
        d_m0 = d_msg * gate + d_zg @ gw.reshape(1, -1)
        d_gw = (rows(t["m0"]).T @ rows(d_zg)).reshape(gw.shape)
        d_gb = d_zg.sum().reshape(gb.shape)
        if gfo:
            d_m0 = d_m0 + d_cmsg   # the ungated coordinate branch
    else:
        d_m0 = d_msg + d_cmsg if gfo else d_msg
        d_gw, d_gb = torch.zeros_like(gw), torch.zeros_like(gb)

    # edge MLP
    d_z2 = d_m0 * _dsilu(t["z2"])
    h = w2.shape[0]
    d_s1 = _dG(d_z2, w2.T, opts, m, h)
    d_w2 = _dG(rows(t["s1"]).T, rows(d_z2), opts, h, m)
    d_b2 = rows(d_z2).sum(dim=0).reshape(b2.shape)
    d_h1 = d_s1 * _dsilu(t["h1"])
    dd = wd.shape[0]
    d_distf = _dG(d_h1, wd.T, opts, h, dd)
    d_wd = _dG(rows(t["distf"]).T, rows(d_h1), opts, dd, h)
    d_dist = d_dist + _d_fourier(t["dist"], d_distf, opts.fourier)
    d_rel = d_rel + 2.0 * t["rel"] * d_dist
    if keep is not None:
        keep.update(d_cz1=d_cz1, d_z2=d_z2, d_h1=d_h1)
    return d_rel, d_h1, (d_wd, d_w2, d_b2, d_gw, d_gb, d_cw1, d_cb1, d_cw2, d_cb2, d_scale)


def _pairs(x, n):
    """(b, n*k, w) pair rows -> (b, n, k, w)."""
    return x.reshape(x.shape[0], n, -1, x.shape[-1])


def fused_pair_messages_plain(coors, cj, fj, proj_i, pv, weights, opts: PairOptions):
    """K10f's plain version: (m_i (b, n, m), coors_delta (b, n, c))."""
    n = coors.shape[1]
    pv4 = _pairs(pv, n).to(coors.dtype)
    t = _tile_forward(coors, _pairs(cj, n), _mm(_pairs(fj, n), weights[0], opts), proj_i, pv4,
                      weights[1:], opts)
    return _aggregate(t, pv4)


def fused_pair_messages_backward_plain(coors, cj, fj, proj_i, pv, weights, g_mi, g_cd,
                                       opts: PairOptions):
    """K10b's plain version: (d_coors, d_cj, d_fj, d_proj_i, the eleven
    weight gradients), recomputing the forward."""
    b, n, _ = coors.shape
    pv4 = _pairs(pv, n).to(coors.dtype)
    fj4 = _pairs(fj, n)
    t = _tile_forward(coors, _pairs(cj, n), _mm(fj4, weights[0], opts), proj_i, pv4, weights[1:],
                      opts)
    d_rel, d_h1, d_w = _tile_backward(t, pv4, weights[1:], g_mi, g_cd, opts)
    d, h = weights[0].shape
    d_fj = _dG(d_h1, weights[0].T, opts, h, d)
    d_wj = _dG(fj4.reshape(-1, d).T, d_h1.reshape(-1, h), opts, d, h)
    return (d_rel.sum(dim=2), (-d_rel).reshape(cj.shape), d_fj.reshape(fj.shape),
            d_h1.sum(dim=2), (d_wj,) + d_w)


# ---------------------------------------------------------------------------
# the tensor-core mode's ties: where two summation orders may round apart
# ---------------------------------------------------------------------------

TIE_FACTOR = 4.0   # a value's reach: this many times its float32 samples' largest distance
TIE_ORDERS = 3     # float32 samples: the plain version in three orders of its contractions
TIE_FLOOR = 2.0 ** -16   # values below this share of their tensor's largest are no ties


def bf16_boundary_distance(x):
    """How far each value of ``x`` lies from the nearest bf16 rounding
    boundary, the midpoint of two adjacent bf16 values where rounding to
    nearest turns (float64; inf at 0, which every order rounds to 0)."""
    a = x.double().abs()
    _, e = torch.frexp(a)                               # a in [2**(e-1), 2**e)
    step = torch.ldexp(torch.ones_like(a), e - 8)       # bf16's spacing there
    u = a / step                                        # in [128, 256)
    # the boundaries of the binade and, at 127.75, the one below 2**(e-1)
    d = torch.minimum((u - u.floor() - 0.5).abs(), u - 127.75) * step
    return torch.where(a > 0, d, torch.full_like(a, float("inf")))


def within_reach(ref, samples, distance, factor=TIE_FACTOR):
    """Where a value ``ref`` (float64) lies nearer an edge (``distance``)
    than ``factor`` times the largest distance of its ``samples`` (the same
    value computed in float32 in other orders) from it, at least one
    float32 rounding of it: two summation orders may put it on either side."""
    reach = torch.full_like(ref, 0.0)
    for s in samples:
        reach = torch.maximum(reach, (s.double() - ref).abs())
    reach = torch.maximum(reach, ref.abs() * 2.0 ** -24)
    return distance < factor * reach


def _permuted(perm, coors, cj, fj, proj_i, pv, weights, g_mi, g_cd):
    """The same pipeline with its features reordered (``perm`` = (d, h, m,
    m4) orders): every contraction sums its terms in another order, and
    each intermediate is the same one with its last axis permuted."""
    pd, ph, pm, pm4 = perm
    wj, wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2, scale = weights
    take = lambda w, p: w.reshape(-1)[p].reshape(w.shape)  # noqa: E731
    weights = (wj[pd][:, ph], wd[:, ph], w2[ph][:, pm], b2[pm], take(gw, pm), gb,
               cw1[pm][:, pm4], cb1[pm4], take(cw2, pm4), cb2, scale)
    return coors, cj, fj[..., pd], proj_i[..., ph], pv, weights, g_mi[..., pm], g_cd


def _mode_values(coors, cj, fj, proj_i, pv, weights, g_mi, g_cd, opts, perm=None):
    """The values the mode rounds, where the rules round them, and the
    clamp's wz * pv: {name: (b, n, k, width)} in the features' own order."""
    n = coors.shape[1]
    if perm is not None:
        coors, cj, fj, proj_i, pv, weights, g_mi, g_cd = _permuted(
            perm, coors, cj, fj, proj_i, pv, weights, g_mi, g_cd)
    pv4 = _pairs(pv, n).to(coors.dtype)
    t = _tile_forward(coors, _pairs(cj, n), _mm(_pairs(fj, n), weights[0], opts), proj_i, pv4,
                      weights[1:], opts)
    keep = {}
    _tile_backward(t, pv4, weights[1:], g_mi, g_cd, opts, keep)
    d, h = weights[0].shape
    m, m4 = weights[6].shape
    dd = 2 * opts.fourier + 1
    axes = {"distf": None, "s1": 1, "m0": 2, "cmsg": 2, "cs1": 3, "d_z2": 2, "d_h1": 1,
            "d_cz1": 3}
    rounds = {"distf": dd >= 8, "s1": h >= 8, "m0": opts.soft_edges and m >= 8,
              "cmsg": m >= 8, "cs1": m4 >= 8, "d_z2": h >= 8 and m >= 8,
              "d_h1": h >= 8 and (d >= 8 or dd >= 8), "d_cz1": m >= 8 and m4 >= 8}
    values = {}
    for name, on in rounds.items():
        if on:
            x = t[name] if name in t else keep[name]
            if perm is not None and axes[name] is not None:
                x = x[..., torch.argsort(perm[axes[name]])]
            values[name] = x
    if opts.clamp is not None:
        values["wm"] = t["wm"]
    return values


def mode_tie_pairs(coors, cj, fj, proj_i, pv, weights, g_mi, g_cd, opts: PairOptions,
                   factor=TIE_FACTOR, detail=None):
    """The live pairs of a K10 case in the tensor-core mode whose result may
    part between two summation orders, from the plain versions alone:
    (rounding (b, n, k), clamp (b, n, k)) booleans. A rounding tie: a value
    that the mode rounds (forward: distf, s1, m0, cmsg, cs1; backward:
    d_z2, d_h1, d_cz1, also the weight gradients' lines) lies within reach
    of a bf16 rounding boundary (``within_reach``: ``factor`` times the
    largest distance of its float32 values from float64, over the plain
    version summed in TIE_ORDERS orders of its features), unless it is below
    TIE_FLOOR of its tensor's largest value, where one bf16 step moves what
    reads it by less than a float32 rounding of that tensor's largest. A
    clamp tie: |wz * pv| within reach of the clamp. Such a pair, given pv =
    0, adds exactly zero to every output and gradient. ``detail``, a dict,
    receives each value's ties by name, (b, n, k, width) booleans ("wm":
    the clamp's)."""
    opts = opts._replace(mxu_bf16=True)
    args = (coors, cj, fj, proj_i, pv, weights, g_mi, g_cd)
    cast = lambda dtype: [  # noqa: E731
        tuple(w.to(dtype) for w in a) if isinstance(a, tuple) else a.to(dtype) for a in args]
    ref = _mode_values(*cast(torch.float64), opts)
    d, h = weights[0].shape
    m, m4 = weights[6].shape
    gen = torch.Generator().manual_seed(0)
    perms = [None] + [tuple(torch.randperm(w, generator=gen).to(coors.device)
                            for w in (d, h, m, m4)) for _ in range(TIE_ORDERS - 1)]
    f32 = cast(torch.float32)
    samples = [_mode_values(*f32, opts, perm) for perm in perms]
    n = coors.shape[1]
    live = _pairs(pv, n)[..., 0] > 0
    rounding = torch.zeros_like(live)
    clamp = torch.zeros_like(live)
    for name, r in ref.items():
        near = within_reach(r, [s[name] for s in samples],
                            (r.abs() - opts.clamp).abs() if name == "wm"
                            else bf16_boundary_distance(r), factor)
        if name != "wm":
            near &= r.abs() >= TIE_FLOOR * r.abs().max()
        near &= live[..., None]
        if detail is not None:
            detail[name] = near
        if name == "wm":
            clamp |= near[..., 0]
        else:
            rounding |= near.any(dim=-1)
    return rounding, clamp


def _gather_rows(x, idx):
    """(b, n, w) at (b, n, k) -> (b, n, k, w)."""
    b, n, k = idx.shape
    flat = idx.reshape(b, n * k, 1).long().expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(b, n, k, x.shape[-1])


def fused_knn_messages_plain(coors, proj_i, proj_j, idx, pv, weights, opts: PairOptions,
                             coors_j=None):
    """K11f's plain version; ``coors_j`` (b, nj, c), with ``proj_j`` (b, nj,
    h), a j table of its own that ``idx`` indexes (the i side's by
    default)."""
    pv4 = pv[..., None].to(coors.dtype)
    cj = _gather_rows(coors if coors_j is None else coors_j, idx)
    t = _tile_forward(coors, cj, _gather_rows(proj_j, idx), proj_i, pv4, weights, opts)
    return _aggregate(t, pv4)


def fused_knn_messages_backward_plain(coors, proj_i, proj_j, idx, pv, weights, g_mi, g_cd,
                                      opts: PairOptions, coors_j=None):
    """K11b's plain version: (d_coors, d_proj_i, d_proj_j, the ten weight
    gradients); the j-side rows [-d_rel | d_h1] summed per node by K2's
    plain version. With a j table ``coors_j`` (b, nj, c), d_coors is the i
    side's alone, and the j table's follows the weight gradients."""
    b, n, c = coors.shape
    table = coors if coors_j is None else coors_j
    pv4 = pv[..., None].to(coors.dtype)
    t = _tile_forward(coors, _gather_rows(table, idx), _gather_rows(proj_j, idx), proj_i, pv4,
                      weights, opts)
    d_rel, d_h1, d_w = _tile_backward(t, pv4, weights, g_mi, g_cd, opts)
    j_side = seg_kernels.segment_sum_plain(
        torch.cat([-d_rel, d_h1], dim=-1).reshape(b, -1, c + d_h1.shape[-1]),
        idx.reshape(b, -1), table.shape[1])
    if coors_j is not None:
        return d_rel.sum(dim=2), d_h1.sum(dim=2), j_side[..., c:], d_w, j_side[..., :c]
    return d_rel.sum(dim=2) + j_side[..., :c], d_h1.sum(dim=2), j_side[..., c:], d_w


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _f32(x):
    return x.detach().to(torch.float32).contiguous()


def _launch(gather: bool, opts: PairOptions, coors, cj, fj, proj_i, proj_j, idx, pv, weights,
            grads=None, coors_j=None):
    """One launch of csrc/pair_messages.cu: the forward, or with ``grads`` =
    (g_mi, g_cd) the backward and its reduction of the weight gradients.
    ``weights`` are the eleven of K10 (Wj None for K11); pv is (b, n, k).
    K11's j table: ``coors_j`` (b, nj, c) with ``proj_j`` (b, nj, h), or
    ``coors`` itself (nj = n); its launches count under
    ``fused_knn_{fwd,bwd}_table``."""
    backward = grads is not None
    dev = coors.device
    b, n, c = coors.shape
    k = pv.shape[2]
    wj, wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2, scale = weights
    h, m, m4 = proj_i.shape[-1], w2.shape[-1], cw1.shape[-1]
    d = 0 if gather else fj.shape[-1]
    dd = 2 * opts.fourier + 1
    if backward:
        rows = _bwd_tile_rows(k, c, d, h, m, m4, opts.fourier, opts.soft_edges)
    else:
        rows = _fwd_tile_rows(b, n, k, c, d, h, m, m4, opts.fourier, opts.soft_edges,
                              _sm_count(dev))
    if rows is None:
        raise ValueError(
            f"the fused pair kernel takes k <= {MAX_ROWS}, c <= {MAX_C}, at most {MAX_FOURIER} "
            f"Fourier encodings and widths that fit {MAX_SMEM_BYTES} bytes of shared memory; "
            f"got k={k}, c={c}, d={d}, h={h}, m={m}, 4m={m4}, fourier={opts.fourier}")
    expect = {"coors": ((b, n, c), coors), "proj_i": ((b, n, h), proj_i),
              "pv": ((b, n, k), pv), "wd": ((dd, h), wd), "w2": ((h, m), w2),
              "cw1": ((m, m4), cw1)}
    table = coors if coors_j is None else coors_j
    nj = table.shape[1]
    if gather:
        expect.update(proj_j=((b, nj, h), proj_j), idx=((b, n, k), idx),
                      coors_j=((b, nj, c), table))
    else:
        expect.update(cj=((b, n * k, c), cj), fj=((b, n * k, d), fj), wj=((d, h), wj))
    for name, (shape, x) in expect.items():
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must have shape {shape} on {dev}, got {tuple(x.shape)} "
                             f"on {x.device}")
    sizes = {"b2": (b2, m), "cb1": (cb1, m4), "cw2": (cw2, m4), "cb2": (cb2, 1)}
    if opts.soft_edges:
        sizes.update(gw=(gw, m), gb=(gb, 1))
    if opts.norm_coors:
        sizes.update(scale=(scale, 1))
    for name, (x, count) in sizes.items():
        if x.numel() != count or x.device != dev:
            raise ValueError(f"{name} must hold {count} elements on {dev}")

    per_sm = (_bwd_blocks_per_sm(rows, c, d, h, m, m4, opts.fourier, opts.soft_edges)
              if backward else None)
    ti, grid = launch_grid(b, n, k, rows, backward, dev, per_sm)
    shape = _Shape(b=b, n=n, k=k, c=c, d=d, h=h, m=m, m4=m4, fourier=opts.fourier, ti=ti,
                   rows=rows, soft_edges=int(opts.soft_edges), norm_coors=int(opts.norm_coors),
                   has_clamp=int(opts.clamp is not None),
                   gate_feats_only=int(opts.gate_feats_only), mxu_bf16=int(opts.mxu_bf16),
                   clamp=float(opts.clamp or 0.0), eps=float(opts.eps), nj=nj)
    # float32 contiguous copies live until the launch has been queued
    held = {"coors": _f32(coors), "proj_i": _f32(proj_i), "pv": _f32(pv)}
    if gather:
        held.update(proj_j=_f32(proj_j), idx=idx.detach().to(torch.int64).contiguous())
        held["coors_j"] = held["coors"] if coors_j is None else _f32(coors_j)
    else:
        held.update(cj=_f32(cj), fj=_f32(fj))
    for name, w in zip(_TENSOR_FIELDS[7:18], weights):
        if w is not None:
            held[name] = _f32(w)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out = {}
    weight_grads = None
    if not backward:
        out.update(m_i=new(b, n, m), cd=new(b, n, c))
    else:
        held.update(g_mi=_f32(grads[0]), g_cd=_f32(grads[1]))
        total = sum(_grad_sizes(d, h, m, m4, opts.fourier))
        weight_grads = new(total)
        out.update(d_ci=new(b, n, c), d_pi=new(b, n, h), partial=new(grid, total))
        if gather:
            out.update(d_pairs=new(b, n * k, c + h))
        else:
            out.update(d_cj=new(b, n * k, c), d_fj=new(b, n * k, d))
    tensors = _Tensors(**{name: t.data_ptr() for name, t in {**held, **out}.items()})
    name = (("fused_knn_" if gather else "fused_pair_") + ("bwd" if backward else "fwd")
            + ("_bf16" if opts.mxu_bf16 else "") + ("_table" if coors_j is not None else ""))
    with torch.cuda.device(dev):
        # read here, not cached: autograd runs backward on its own thread
        stream = torch.cuda.current_stream().cuda_stream
        err = build.function("pair_messages", "pair_messages_launch", _ARGTYPES)(
            ctypes.byref(shape), ctypes.byref(tensors), int(gather), int(backward), grid,
            None if weight_grads is None else weight_grads.data_ptr(), stream)
    raise_on_launch_error(err, name)
    LAUNCH_COUNTS[name] += 1
    if not backward:
        return out["m_i"], out["cd"]
    parts = weight_grads.split(_grad_sizes(d, h, m, m4, opts.fourier))
    d_weights = tuple(None if w is None else g.reshape(w.shape).to(w.dtype)
                      for g, w in zip(parts, weights))
    return out, d_weights


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_grid(b, n, k, rows, backward, device, per_sm=None):
    """(nodes a tile, blocks) of a launch on tiles of ``rows`` pair rows: one
    block a tile up to ``per_sm`` blocks an SM of the card (by default the
    kernel's two; by the shape and the SM count alone, so that the
    weight-gradient sums repeat)."""
    ti = rows // k
    if per_sm is None:
        per_sm = _BWD_BLOCKS_PER_SM if backward else _FWD_BLOCKS_PER_SM
    return ti, min(b * -(-n // ti), _sm_count(device) * per_sm)


def _on_card(x: torch.Tensor) -> bool:
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"no fused pair kernel for device {x.device}")
    return x.is_cuda


def fused_pair_messages_forward(coors, cj, fj, proj_i, pv, weights, opts: PairOptions):
    """K10f: a CUDA tensor launches the kernel (operands cast to float32, the
    results back), a CPU tensor runs ``fused_pair_messages_plain``."""
    if not _on_card(coors):
        return fused_pair_messages_plain(coors, cj, fj, proj_i, pv, weights, opts)
    m_i, cd = _launch(False, opts, coors, cj, fj, proj_i, None, None,
                      _pairs(pv, coors.shape[1])[..., 0], weights)
    return m_i.to(proj_i.dtype), cd.to(coors.dtype)


def fused_pair_messages_backward(coors, cj, fj, proj_i, pv, weights, g_mi, g_cd,
                                 opts: PairOptions):
    """K10b: (d_coors, d_cj, d_fj, d_proj_i, the eleven weight gradients)."""
    if not _on_card(coors):
        return fused_pair_messages_backward_plain(coors, cj, fj, proj_i, pv, weights, g_mi,
                                                  g_cd, opts)
    out, d_w = _launch(False, opts, coors, cj, fj, proj_i, None, None,
                       _pairs(pv, coors.shape[1])[..., 0], weights, grads=(g_mi, g_cd))
    return (out["d_ci"].to(coors.dtype), out["d_cj"].to(cj.dtype), out["d_fj"].to(fj.dtype),
            out["d_pi"].to(proj_i.dtype), d_w)


def fused_knn_messages_forward(coors, proj_i, proj_j, idx, pv, weights, opts: PairOptions,
                               coors_j=None):
    """K11f, as ``fused_pair_messages_forward``; ``coors_j``: a j table of
    its own (``fused_knn_messages_plain``)."""
    if not _on_card(coors):
        return fused_knn_messages_plain(coors, proj_i, proj_j, idx, pv, weights, opts, coors_j)
    m_i, cd = _launch(True, opts, coors, None, None, proj_i, proj_j, idx, pv,
                      (None,) + tuple(weights), coors_j=coors_j)
    return m_i.to(proj_i.dtype), cd.to(coors.dtype)


def fused_knn_messages_backward(coors, proj_i, proj_j, idx, pv, weights, g_mi, g_cd,
                                opts: PairOptions, coors_j=None):
    """K11b: (d_coors, d_proj_i, d_proj_j, the ten weight gradients). The
    kernel leaves the j-side rows [-d_rel | d_h1] in pair layout; K2 sums
    them per node of the j table, order-free. With a j table ``coors_j``,
    d_coors is the i side's alone and the j table's follows (as
    ``fused_knn_messages_backward_plain``)."""
    if not _on_card(coors):
        return fused_knn_messages_backward_plain(coors, proj_i, proj_j, idx, pv, weights, g_mi,
                                                 g_cd, opts, coors_j)
    b, n, c = coors.shape
    out, d_w = _launch(True, opts, coors, None, None, proj_i, proj_j, idx, pv,
                       (None,) + tuple(weights), grads=(g_mi, g_cd), coors_j=coors_j)
    nj = n if coors_j is None else coors_j.shape[1]
    j_side = seg_kernels.segment_sum(out["d_pairs"], idx.reshape(b, -1).contiguous(), nj)
    if coors_j is not None:
        return (out["d_ci"].to(coors.dtype), out["d_pi"].to(proj_i.dtype),
                j_side[..., c:].to(proj_j.dtype), d_w[1:], j_side[..., :c].to(coors_j.dtype))
    return ((out["d_ci"] + j_side[..., :c]).to(coors.dtype), out["d_pi"].to(proj_i.dtype),
            j_side[..., c:].to(proj_j.dtype), d_w[1:])


class _FusedPairMessages(torch.autograd.Function):
    @staticmethod
    def forward(ctx, opts, coors, cj, fj, proj_i, pv, *weights):
        ctx.opts = opts
        ctx.save_for_backward(coors, cj, fj, proj_i, pv, *weights)
        return fused_pair_messages_forward(coors, cj, fj, proj_i, pv, weights, opts)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mi, g_cd):
        coors, cj, fj, proj_i, pv, *weights = ctx.saved_tensors
        d_ci, d_cj, d_fj, d_pi, d_w = fused_pair_messages_backward(
            coors, cj, fj, proj_i, pv, weights, g_mi, g_cd, ctx.opts)
        d_w = tuple(g.reshape(w.shape) for g, w in zip(d_w, weights))
        return (None, d_ci, d_cj, d_fj, d_pi, None) + d_w


class _FusedKnnMessages(torch.autograd.Function):
    @staticmethod
    def forward(ctx, opts, coors, proj_i, proj_j, idx, pv, coors_j, *weights):
        ctx.opts, ctx.table = opts, coors_j is not None
        ctx.save_for_backward(coors, proj_i, proj_j, idx, pv, coors_j, *weights)
        return fused_knn_messages_forward(coors, proj_i, proj_j, idx, pv, weights, opts, coors_j)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mi, g_cd):
        coors, proj_i, proj_j, idx, pv, coors_j, *weights = ctx.saved_tensors
        out = fused_knn_messages_backward(coors, proj_i, proj_j, idx, pv, weights, g_mi, g_cd,
                                          ctx.opts, coors_j if ctx.table else None)
        d_coors, d_pi, d_pj, d_w = out[:4]
        d_w = tuple(g.reshape(w.shape) for g, w in zip(d_w, weights))
        return (None, d_coors, d_pi, d_pj, None, None, out[4] if ctx.table else None) + d_w


def fused_pair_messages(coors, cj, fj, proj_i, pv, fourier: int, soft_edges: bool,
                        norm_coors: bool, clamp: Optional[float], eps: float,
                        mxu_bf16: bool = False, gate_feats_only: bool = False, *weights):
    """K10, differentiable: the fused pair pipeline on pre-gathered rows.

    coors (b, n, c); cj (b, n*k, c) and fj (b, n*k, d) the neighbours' rows,
    i-major (row i*k + t); proj_i (b, n, h) with the edge MLP's first bias
    folded in; pv (b, n*k, 1) pair validity (no gradient; ones when nothing
    is masked). ``weights`` = (wj, wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2,
    scale): pass dummies for unused options (gw and gb without
    ``soft_edges``, scale without ``norm_coors``); their gradients are zero.
    ``gate_feats_only``: the coordinate-weight MLP reads the ungated
    messages; ``mxu_bf16``: the tensor-core mode (the module's docstring).
    Returns (m_i (b, n, m), the sum of the pv-masked messages, and
    coors_delta (b, n, c)); a mean pooling divides outside. Any k (or kc)
    goes: nothing is padded.
    """
    if len(weights) != 11:
        raise ValueError(f"expected 11 weights, got {len(weights)}")
    opts = PairOptions(fourier, soft_edges, norm_coors, clamp, eps, gate_feats_only,
                       bool(mxu_bf16))
    return _FusedPairMessages.apply(opts, coors, cj, fj, proj_i, pv, *weights)


def fused_knn_messages(coors, proj_i, proj_j, idx, pv, fourier: int, soft_edges: bool,
                       norm_coors: bool, clamp: Optional[float], eps: float, *weights,
                       coors_j=None):
    """K11, differentiable: the same pipeline gathering ``coors[idx]`` and
    ``proj_j[idx]`` itself. proj_i, proj_j (b, n, h); idx (b, n, k) integer
    neighbour ids and pv (b, n, k) pair validity (bool or integer), neither
    with a gradient. ``weights`` = (wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2,
    scale), dummies as in ``fused_pair_messages``. Returns (m_i, coors_delta).

    ``coors_j`` (b, nj, c): a j table of its own, whose rows ``idx`` and
    ``proj_j`` (b, nj, h) index: the node-sharded layer's gathered cloud,
    while coors and proj_i are the rank's own rows; it gets its gradient.
    """
    if len(weights) != 10:
        raise ValueError(f"expected 10 weights, got {len(weights)}")
    opts = PairOptions(fourier, soft_edges, norm_coors, clamp, eps, False)
    return _FusedKnnMessages.apply(opts, coors, proj_i, proj_j, idx, pv, coors_j, *weights)
