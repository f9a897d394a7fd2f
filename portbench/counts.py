"""Operations and bytes of the program's kernels and of a model step, counted
from shapes as the algorithm needs them, whatever implements it: each input
read once and each output written once, 2 operations a multiply-add, no
recomputation. Where the work depends on the data, the counts take the valid
pairs and nodes the inputs hold, not the padded capacity.

Kernels (the ids of ``PERF.md``'s kernel table):
- K1 / K3, the kNN selection with and without a gathered table;
- K2, the segment sum;
- K10f / K10b, the fused pair pipeline on gathered rows (it computes
  f_j @ W_j per pair, as it is handed f_j);
- K11f / K11b, the same pipeline on proj_j = f_j @ W_j rows that it gathers
  itself by index: f_j @ W_j runs before it, once a node, and is not its work.
The backward of a pair kernel is twice its forward products: the gradients
of the data and of the weights.

Model steps count the MLP products of the EGNN equations in their factorised
form: f_i @ W_i and f_j @ W_j once a node (both act on node rows before any
pair exists), the distance features, the second edge product and the
coordinate MLP once a valid pair, the node MLP once a node, a readout head
once a graph. A training micro-step is three times its forward.
"""
from __future__ import annotations

F32, I64 = 4, 8


def knn_select(b: int, n: int, c: int, k: int, table_width: int, masked: bool,
               adj_bytes: int) -> tuple:
    """(ops, bytes) of K1 (``table_width`` > 0: the gathered rows are
    written) or K3 (0). Per pair: 3c for the squared distance, a fill select
    and two compares; bytes: coordinates, mask, adjacency and table in, the k
    rankings (f32), ids (i64) and gathered rows out."""
    ops = b * n * n * (3 * c + 3)
    nbytes = (F32 * b * n * c + (b * n if masked else 0) + adj_bytes
              + F32 * b * n * table_width
              + b * n * k * (F32 + I64) + F32 * b * n * k * table_width)
    return ops, nbytes


def segment_sum(b: int, e: int, s: int, d: int) -> tuple:
    """(ops, bytes) of K2: e rows of width d summed into s segments (one add
    an element); data and int64 ids in, the sums out."""
    return b * e * d, b * (F32 * e * d + I64 * e + F32 * s * d)


def pair_macs(d: int, h: int, m: int, fourier: int, soft: bool, gathers_proj: bool) -> int:
    """Multiply-adds a pair of the pair pipeline's products: f_j @ W_j (K10
    only), distance features @ W_d, s1 @ W_2, the soft gate, m @ cW_1 and
    cw @ cW_2."""
    dd = 2 * fourier + 1
    return ((0 if gathers_proj else d * h) + dd * h + h * m + (m if soft else 0)
            + m * 4 * m + 4 * m)


def _pair_weights(d, h, m, fourier, soft, gathers_proj) -> int:
    dd = 2 * fourier + 1
    return ((0 if gathers_proj else d * h) + dd * h + h * m + m + (m + 1 if soft else 0)
            + m * 4 * m + 4 * m + 4 * m + 1 + 1)


def pair_forward(pairs: int, nodes: int, c: int, d: int, h: int, m: int, fourier: int,
                 soft: bool = False, gathers_proj: bool = False) -> tuple:
    """(ops, bytes) of K10f (``gathers_proj`` False: the gathered rows
    [c_j | f_j] and a f32 validity a pair) or K11f (True: proj_j (nodes, h)
    once, an int64 id and a bool validity a pair). Both read the coordinates
    and proj_i of their nodes and the weights, and write the summed messages
    and the coordinate change."""
    w = _pair_weights(d, h, m, fourier, soft, gathers_proj)
    j_side = (nodes * h * F32 + pairs * (I64 + 1)) if gathers_proj \
        else pairs * (c + d + 1) * F32
    nbytes = nodes * (c + h) * F32 + j_side + w * F32 + nodes * (m + c) * F32
    return 2 * pair_macs(d, h, m, fourier, soft, gathers_proj) * pairs, nbytes


def pair_backward(pairs: int, nodes: int, c: int, d: int, h: int, m: int, fourier: int,
                  soft: bool = False, gathers_proj: bool = False) -> tuple:
    """(ops, bytes) of K10b / K11b: twice the forward's products; the
    forward's inputs and the upstream gradients of its two outputs in, the
    gradient of every input out (K11b: of proj_j a node)."""
    ops, fwd_in = pair_forward(pairs, nodes, c, d, h, m, fourier, soft, gathers_proj)
    w = _pair_weights(d, h, m, fourier, soft, gathers_proj)
    outputs_fwd = nodes * (m + c) * F32
    inputs = fwd_in - outputs_fwd
    grads_out = (nodes * (c + h) * F32 + w * F32
                 + (nodes * h * F32 if gathers_proj else pairs * (c + d) * F32))
    return 2 * ops, inputs + outputs_fwd + grads_out


def egnn_layer_macs(nodes: int, pairs: int, d: int, h: int, m: int, fourier: int,
                    soft: bool = False, coors: bool = True) -> int:
    """Multiply-adds of one EGNN layer's forward over ``nodes`` valid nodes
    and ``pairs`` valid pairs (see the module's docstring); ``soft``: the
    soft edge gate (m x 1) a pair; ``coors``: the coordinate MLP a pair."""
    dd = 2 * fourier + 1
    node = 2 * d * h + (d + m) * 2 * d + 2 * d * d
    pair = dd * h + h * m + (m if soft else 0) + ((m * 4 * m + 4 * m) if coors else 0)
    return nodes * node + pairs * pair


def model_forward_flops(layers: int, nodes: int, pairs: int, d: int, h: int, m: int,
                        fourier: int, graphs: int = 0, head: bool = False,
                        soft: bool = False, coors: bool = True) -> int:
    """Operations of a network's forward: ``layers`` EGNN layers, and with
    ``head`` a two-layer readout (d x d, d x 1) a graph."""
    macs = layers * egnn_layer_macs(nodes, pairs, d, h, m, fourier, soft, coors)
    if head:
        macs += graphs * (d * d + d)
    return 2 * macs


def train_flops(forward_flops: int) -> int:
    """A training micro-step: the forward and twice it for the backward."""
    return 3 * forward_flops
