"""The frozen counts against hand-worked values at anchor 3's shapes (b = 1,
n = 1024, k = 8, dim 32, h = 2 (2 * 32 + 1) = 130, m = 16, no Fourier
features) and anchor 5's (G = 512 molecules of 32 slots, k = 8, dim 64,
fourier 4, h = 2 (2 * 64 + 9) = 274)."""
import pytest

from portbench import counts
from portbench.peaks import least_seconds


def test_k10_at_anchor5():
    # multiply-adds a pair: 64*274 + 9*274 + 274*16 + 16*64 + 64 = 25474;
    # 131 072 pairs, 2 operations each
    ops, _ = counts.pair_forward(131072, 16384, 3, 64, 274, 16, 4)
    assert ops == 2 * 25474 * 131072 == 6677856256
    assert least_seconds(ops, 0) == pytest.approx(6677856256 / 67e12)
    # the backward: the data and the weight gradients, twice the forward
    ops_b, _ = counts.pair_backward(131072, 16384, 3, 64, 274, 16, 4)
    assert ops_b == 2 * ops


def test_k10_k11_at_anchor3():
    # 32*130 + 1*130 + 130*16 + 16*64 + 64 = 7458 a pair, 8192 pairs
    ops, nbytes = counts.pair_forward(8192, 1024, 3, 32, 130, 16, 0)
    assert ops == 2 * 7458 * 8192 == 122191872
    # bytes: nodes (c + h) + pairs (c + d + 1) + weights + nodes (m + c),
    # 4 bytes each; weights 32*130 + 130 + 130*16 + 16 + 16*64 + 64 + 64 + 2
    weights = 4160 + 130 + 2080 + 16 + 1024 + 64 + 64 + 2
    assert nbytes == 4 * (1024 * 133 + 8192 * 36 + weights + 1024 * 19)
    # K11 gathers proj_j = f_j @ W_j rows made before it: 130 + 2080 + 1024
    # + 64 = 3298 a pair, and proj_j read once a node
    ops11, nbytes11 = counts.pair_forward(8192, 1024, 3, 32, 130, 16, 0, gathers_proj=True)
    assert ops11 == 2 * 3298 * 8192 == 54034432
    weights11 = 130 + 2080 + 16 + 1024 + 64 + 64 + 2
    assert nbytes11 == 4 * (1024 * 133 + 1024 * 130 + weights11 + 1024 * 19) + 8192 * 9
    assert counts.pair_backward(8192, 1024, 3, 32, 130, 16, 0, gathers_proj=True)[0] == 2 * ops11


def test_k1_k3_k2_at_anchor3():
    # K1: coordinates 4*1024*3, mask 1024, the chain adjacency 1024^2, table
    # 4*1024*36 ([coors | mask | feats]), rankings and ids 1024*8*12, rows
    # 4*1024*8*36
    ops, nbytes = counts.knn_select(1, 1024, 3, 8, 36, True, 1024 * 1024)
    assert nbytes == 12288 + 1024 + 1048576 + 147456 + 98304 + 1179648 == 2487296
    assert ops == 1024 * 1024 * 12
    assert least_seconds(ops, nbytes) == pytest.approx(2487296 / 3.35e12)
    _, nbytes3 = counts.knn_select(1, 1024, 3, 8, 0, True, 1024 * 1024)
    assert nbytes3 == 12288 + 1024 + 1048576 + 98304 == 1160192
    # K2: 8192 rows of 36 into 1024 segments
    assert counts.segment_sum(1, 8192, 1024, 36) == (294912, 1179648 + 65536 + 147456)


def test_k3_at_anchor5():
    # 512 molecules, 32 slots, k + 1 = 9 selected: 512*32*32*12 operations;
    # bytes 4*512*32*3 + 512*32 + 512*32*9*12
    ops, nbytes = counts.knn_select(512, 32, 3, 9, 0, True, 0)
    assert ops == 6291456
    assert nbytes == 196608 + 16384 + 1769472


def test_model_steps():
    # anchor 5, every slot valid: a node 2*64*274 + 80*128 + 128*64 = 53504,
    # an edge 9*274 + 274*16 + 16*64 + 64 = 7938 multiply-adds; 4 layers;
    # the head 64*64 + 64 a molecule
    fwd = counts.model_forward_flops(4, 16384, 131072, 64, 274, 16, 4, 512, head=True)
    assert fwd == 2 * (4 * (16384 * 53504 + 131072 * 7938) + 512 * 4160) == 15340732416
    assert counts.train_flops(fwd) == 3 * fwd
    # anchor 3: a node 2*32*130 + 48*64 + 64*32 = 13440, a pair 130 + 2080 +
    # 1024 + 64 = 3298; 3 layers
    assert counts.model_forward_flops(3, 1024, 8192, 32, 130, 16, 0) == \
        2 * 3 * (1024 * 13440 + 8192 * 3298) == 244678656


def test_model_step_at_the_qm9_widths():
    # one fully connected molecule of 29 atoms (812 pairs), one layer of dim
    # 128, h = 2 (2 * 128 + 1) = 514, m = 128, soft edges, no coordinate MLP:
    # a node 2*128*514 + 256*256 + 256*128 = 229888, a pair 514 + 514*128 +
    # 128 = 66434 multiply-adds; the head 128*128 + 128
    fwd = counts.model_forward_flops(1, 29, 812, 128, 514, 128, 0, 1, head=True, soft=True,
                                     coors=False)
    assert fwd == 2 * (29 * 229888 + 812 * 66434 + 16512) == 121255344
