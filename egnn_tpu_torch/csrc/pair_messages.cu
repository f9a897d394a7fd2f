// The fused pair pipeline of the dense kNN EGNN layer for Hopper (sm_90a),
// forward and backward. Plain C interface, loaded with ctypes
// (egnn_tpu_torch/ops/cuda/build.py, egnn_tpu_torch/ops/cuda/pair_messages.py).
//
// Replaces the TPU kernels
//   K10f egnn_tpu/ops/pallas/pair_messages.py:fused_pair_messages (_fwd_kernel)
//   K10b                                                          (_bwd_kernel)
//   K11f egnn_tpu/ops/pallas/knn_layer.py:fused_knn_messages      (_fwd_kernel)
//   K11b                                                          (_bwd_kernel)
// which compute, for every pair row r = (node i, slot t),
//   rel = c_i - c_j; dist = |rel|^2; distf = [sin(dist/2^f).., cos(dist/2^f).., dist]
//   h1 = proj_i[i] + fj @ Wj + distf @ Wd     (K11: proj_i[i] + proj_j[idx] + distf @ Wd)
//   m0 = silu(silu(h1) @ W2 + b2); msg = m0 * sigmoid(m0 @ gw + gb) if soft_edges else m0
//   cmsg = m0 if gate_feats_only else msg
//   wz = silu(cmsg @ cW1 + cb1) @ cW2 + cb2; w = clip(wz * pv, +-clamp)
//   rel_n = rel / sqrt(max(dist, eps^2)) * scale if norm_coors else rel
//   m_i[i] = sum_t msg * pv;  coors_delta[i] = sum_t w * rel_n
// and, in the backward, recompute this from the inputs and give every input's
// and every weight's gradient in one pass. Nothing of pair size reaches
// device memory but the inputs and the j-side gradients.
//
// K11 is K10's source with one template flag: on this card a gather is an
// indexed load, so the rows of coors and proj_j are read at idx where K10
// reads its pre-gathered rows and multiplies by Wj. They are the rows of a
// j table of nj rows (coors_j, proj_j): the i side's own (nj = n), or, on
// the dense step sharded over nodes, the whole gathered cloud while the i
// side is the rank's own rows.
//
// Design. A block takes tiles of whole nodes, ti nodes x k slots pair rows,
// in a loop (tile = blockIdx.x, += gridDim.x); the grid depends on the shape
// and the SM count alone. The weights are staged in shared memory once a
// block, every row stride odd, so that a product reads them without bank
// conflicts both ways round (W and W^T). The tile's activations lie
// transposed in shared memory, one feature a line of rows + 4 floats, so that
// the float4 accesses of a quarter warp fall on distinct banks ((rows + 4) / 4
// is odd). Each stage of the pipeline is a product by the whole block with
// f32 FMAs, and stages are separated by barriers. What follows a product
// elementwise rides in its epilogue: the per-node and gathered terms of h1,
// the activations, silu' in the backward. The reductions over a node's k
// slots run over the tile's rows in slot order.
//
// The forward (K10f, K11f): 256 threads, two blocks an SM, on a tile of its
// own (the wrapper's _fwd_tile_rows: whole nodes, at most the gates' 64 rows,
// fewer where the tiles would leave some of the card's block slots empty). A
// block loads the next tile's inputs with cp.async into a staging region (K10:
// cj, fj and pv rows; K11: idx and pv; both: the tile's own coordinates and
// proj_i rows) while it computes the current tile, then unpacks them into the
// tile buffers with every thread at work: the geometry a thread a (row,
// encoding), fj transposed with no bank conflicts, and H filled with proj_i[i]
// (K11: + proj_j[idx], gathered there), which the h1 product's epilogue adds.
// The weights are staged with cp.async too, under the first tile's copies.
// The products are the backward's register-blocked routine (four rows by
// five columns a thread in h1, by one in z2 and by two in cz1); the
// coordinate weight takes eight lanes a row, each lane's share summed in a
// fixed order, and the k-sums a thread an output, so that launches repeat bit
// for bit.
//
// The backward (K10b, K11b): 256 threads, two blocks an SM, tiles of about 32
// rows (the wrapper's _bwd_tile_rows), so that two blocks' layouts fit an
// SM's shared memory and one block's barrier leaves the SM the other's work.
// Where two blocks fit no tile of 16 rows or more (dim 64, h = 274: one node
// of 8 rows takes 140 KiB), a tile of up to 32 rows that one block holds
// (222 400 B at those widths), the grid sized by one block an SM and an
// instance bounded by it (bwd_kernel), which keeps every weight-gradient
// block of those widths in registers (kOneBlockWgSlots): a tile of one node
// (8 rows) would pay its barriers and its pass over all 1685 weight-gradient
// blocks for 8 rows, and three slots leave 917 of them to device memory.
// Measured on the H100 at anchor 5 (G = 512, 131 072 pairs;
// tools/k10b_variants.py): 4.34 ms on 8-row tiles at three slots, 2.15 ms
// on 32-row ones with 7 slots (254 registers, no spills; 2.29 ms with 4). The h-wide products keep
// wide_cost's choice there, five columns: one measured 1.3% slower at
// G = 512 and 2.7% at G = 32 (PERF.md).
// It recomputes the tile's forward with its own products, keeping each
// sigmoid it evaluates (of h1, z2, cz1) so that silu' = sg + silu * (1 - sg)
// needs no second exponential. Its products are register-blocked: a thread
// owns four rows by one column, or by five interleaved columns for the
// h-wide products (h1, d_h1), where one column would leave some threads five
// rounds of items. The row-wise stages are spread over the block: eight
// lanes a row for the clamp and CoorsNorm backward and for the distance
// backward (the Fourier encodings split over the lanes), a thread a (row,
// feature) for the silu backward, a warp a row for the soft gate's sum.
//
// Weight gradients. The TPU grid is sequential and adds into resident blocks
// step after step. Here each weight gradient of a tile is an outer product of
// two sets of tile lines, cut into 4 x 4 blocks of entries (below, at
// wgrad_plan). Each block has one owner thread, which keeps the sum in
// registers for the whole tile loop, adds each tile's rows to it in row
// order, and writes it to the block's row of `partial` at the end; a second
// kernel adds the rows in block order. No float atomics: the result repeats
// bit for bit.
//
// K11b's j-side sums (d_proj_j, and the neighbours' share of d_coors) are
// written in pair layout, [-d_rel | d_h1] rows of width c + h, and summed
// per node by the segment-sum kernel K2 (csrc/segment_sum.cu) in the
// wrapper: ordered and repeatable, where a float atomicAdd over hub nodes
// would be neither repeatable nor fast.
//
// Bound on the H100: about 2 * (d*h + dd*h + h*m + m*4m + 4m) f32
// operations a pair forward (14.8 K at d = 32, h = 130, m = 16) and three
// times that backward, against (c + d + 1) * 4 bytes a pair read: bound by
// operations (0.23 ms forward, 0.70 ms backward at 1 048 576 pairs, against
// 0.05 ms of bytes). The forward stays five to six times above its bound
// and the backward about six (the times are in PERF.md): the exact expf and
// IEEE division of the activations (210 sigmoids a pair forward, about 400
// backward), the barriers between stages, and FMAs outside the tensor cores.
// In the backward, loading a tile's inputs under the tile before it is later
// work.
//
// The tensor-core mode (K10 only: the TPU kernel's mxu_bf16, its _mm_maker
// and dG). The MLP products round their operands to bf16 (to nearest, ties
// to even) and add the exact products in f32; the geometry, the elementwise
// chain, the biases and the k-sums stay f32. A forward product rounds where
// its contraction has at least 8 elements, a backward product where the
// contraction and every width of its operands have (the pair rows of a TPU
// tile, ti * k, are at least 8, so the rules read the widths alone). The
// products whose weight's widths are both at least 8 run on the tensor cores
// with mma.sync (bf16 fragments, f32 accumulators; tc_mma): the weights are
// rounded once a block as they are staged, into a bf16 copy that lies in the
// place of their f32 copy (bf16_copy), and the widths are padded with zeros
// (h = 130 to 144). Both kernels sum each step of 16 as two m16n8k8 halves
// from zero, added in round-to-nearest (the tensor cores truncate as they
// add), segment after segment and step after step in the same order, so that
// the forward and the backward's recomputation give the same bits for the
// values they share (s1 and silu(cz1) as the forward reads them, m0, msg and
// the clamped w: bit for bit at the smoke's shapes and cases on an H100,
// tools/k10_mode_probe.py taps); the rest stays on the FMAs in the order of
// its terms, rounding where the rules round, in both kernels alike.
// - K10f in the mode (pair_fwd_mode_kernel, mode_products): fj @ Wj,
//   distf @ Wd (dd >= 8), s1 @ W2 and cmsg @ cW1. Its weights' copies keep
//   W's orientation (B by ldmatrix.trans), staged with 16-byte loads, eight
//   in flight a thread. fj, distf, s1, cmsg and silu(cz1), which it reads
//   only rounded, lie as bf16 rows in the place of their f32 lines
//   (ModeRows), written once each, rounded, as packed pairs, and read as A
//   fragments by ldmatrix.x4; m0 and msg stay f32 lines for the gate and the
//   sums. The h1 product adds proj_i from the staging region (no per-row H),
//   and the next tile's copies are queued after it. wz is summed a warp a
//   row, as the recomputation sums it. The layout, its total and the gates
//   are the f32 forward's.
// - K10b in the mode (pair_bwd_kernel<false, 1, true, *>): the recomputation's
//   h1, z2 and cz1, and the data gradients d_cmsg = d_cz1 @ cW1^T, d_h1 =
//   (d_z2 @ W2^T) * silu'(h1), d_distf = d_h1 @ Wd^T and d_fj = d_h1 @ Wj^T.
//   The four weights take one transposed bf16 copy each, read both ways
//   round: a product by W takes its B fragments as two words a lane from the
//   copy's rows, a product by W^T by ldmatrix.trans from the same rows
//   (load_b_frag). ldmatrix reads rows of 16 bytes: the copy starts at the
//   first 16-byte boundary of its place and its stride is a multiple of 8
//   values. A second copy, in W^T's own orientation, would not fit in the f32
//   copy's place beside the first at anchor 3's Wj (32 x 130: at least 8 768
//   values against 8 384). The recomputation rounds its activations as their
//   A fragments are loaded from the f32 tile lines. The weight gradients'
//   outer products stay on the FMAs (wgrad_block, rounding their lines as
//   they read them); they are most of what the mode's K10b costs beyond the
//   f32 one (PERF.md). It takes the f32 backward's tile, grid and one-block
//   rule (a tile below 16 rows would half fill an m16 fragment).
// A weight with a width below 8 keeps its f32 copy, and the products that
// read it stay on the FMAs, rounding where the rules round. Launches repeat
// bit for bit.
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxC = 8;         // coordinate width
constexpr int kMaxFourier = 16;  // Fourier encodings
constexpr int kMaxRows = 64;     // pair rows of a tile
constexpr int kRowScalars = 10;  // per-row scalars kept in shared memory
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 256;
constexpr int kMaxSmemBytes = 232448;
constexpr int kSmSmemBytes = 233472;   // an SM's shared memory,
constexpr int kSmBlockReserve = 1024;  // of which the card keeps 1 KB a block
constexpr unsigned kFull = 0xffffffffu;

// Probe points, empty in the package's build. tools/k10_mode_probe.py builds
// copies of this source that pre-include a header defining them: K10_STAGE(k)
// reads the clock at the end of the forward's stage k (-1: the block's
// start), K10_TAP_* write out the values that the mode's forward and the
// backward's recomputation share, and K10_MODE_TILES sets the column tiles of
// a warp item in mode_products.
#ifndef K10_PROBES
#define K10_STAGE(k)
#define K10_TAP_W(sub, r, w)
#define K10_TAP_FWD(s, L, mr, sm, rows, p0)
#define K10_TAP_BWD(on, s, L, sm, rows, p0)
#endif
#ifndef K10_MODE_TILES
#define K10_MODE_TILES 1
#endif

// Shape and Tensors are the launch function's arguments, C structs that the
// wrapper fills with ctypes: they have external linkage.
struct Shape {
  int b, n, k, c, d, h, m, m4, fourier, ti, rows;  // d = 0 in the gathering form
  int soft_edges, norm_coors, has_clamp, gate_feats_only;
  int mxu_bf16;  // the tensor-core mode (K10 only)
  float clamp, eps;
  int nj;        // the gathering form's j table: its rows (n: the i side's own)
};

struct Tensors {
  const float* coors;    // (b, n, c)
  const float* cj;       // (b, n*k, c)     pre-gathered form
  const float* fj;       // (b, n*k, d)     pre-gathered form
  const float* proj_i;   // (b, n, h)
  const float* proj_j;   // (b, nj, h)      gathering form
  const long long* idx;  // (b, n, k)       gathering form, rows of the j table
  const float* pv;       // (b, n*k)
  const float *wj, *wd, *w2, *b2, *gw, *gb, *cw1, *cb1, *cw2, *cb2, *scale;
  float* m_i;            // (b, n, m)       forward
  float* cd;             // (b, n, c)       forward
  const float* g_mi;     // (b, n, m)       backward from here on
  const float* g_cd;     // (b, n, c)
  float* d_ci;           // (b, n, c)
  float* d_cj;           // (b, n*k, c)     pre-gathered form
  float* d_fj;           // (b, n*k, d)     pre-gathered form
  float* d_pi;           // (b, n, h)
  float* d_pairs;        // (b, n*k, c + h) gathering form: [-d_rel | d_h1]
  float* partial;        // (grid, E) weight gradients by block
  const float* coors_j;  // (b, nj, c)      gathering form: the j table's coordinates
};

namespace {

__host__ __device__ inline int odd(int x) { return x | 1; }

// Offsets (in floats) of the weight gradients in a block's row of `partial`,
// in the order of the wrappers' weight tuples.
struct GradLayout {
  int wj, wd, w2, b2, gw, gb, cw1, cb1, cw2, cb2, scale, total;
};

__host__ __device__ inline GradLayout grad_layout(const Shape& s) {
  GradLayout g;
  const int dd = 2 * s.fourier + 1;
  int o = 0;
  g.wj = o; o += s.d * s.h;
  g.wd = o; o += dd * s.h;   // straight after wj: one product gives both
  g.w2 = o; o += s.h * s.m;
  g.b2 = o; o += s.m;
  g.gw = o; o += s.m;
  g.gb = o; o += 1;
  g.cw1 = o; o += s.m * s.m4;
  g.cb1 = o; o += s.m4;
  g.cw2 = o; o += s.m4;
  g.cb2 = o; o += 1;
  g.scale = o; o += 1;
  g.total = o;
  return g;
}

// Offsets (in floats) of everything a block keeps in shared memory. A tile
// buffer of `cols` features is cols lines of ldr = rows + 4 floats: element
// (row r, feature j) lies at j * ldr + r.
struct Layout {
  int ld_h, ld_m, ld_m4;  // odd row strides of the staged weights
  int ldr;                // line stride of the tile buffers
  int ldn;                // floats a pair row takes in the forward's staging region
  int wj, wd, w2, b2, gw, cw1, cb1, cw2, misc;  // misc: gb, cb2, scale
  int H, S, X, DISTF, Z2, M0, MSG, DM, CZ1, REL, DREL, DDF, ROW, JDX, DCZ1, ONES;
  int NXT;                // the forward's staging region (next_inputs)
  int total;
};

__host__ __device__ inline Layout make_layout(const Shape& s, bool backward) {
  Layout L;
  const int dd = 2 * s.fourier + 1;
  L.ld_h = odd(s.h);
  L.ld_m = odd(s.m);
  L.ld_m4 = odd(s.m4);
  L.ldr = s.rows + 4;
  // the forward's staging region, a pair row: K10 cj (c), fj (d, at an odd
  // stride), pv; K11 (d = 0) idx (int64), pv
  L.ldn = s.d > 0 ? s.c + odd(s.d) + 1 : 3;
  int o = 0;
  L.wj = o; o += s.d * L.ld_h;
  L.wd = o; o += dd * L.ld_h;   // straight after wj: [Wj; Wd] is one matrix
  L.w2 = o; o += s.h * L.ld_m;
  L.b2 = o; o += s.m;
  L.gw = o; o += s.m;
  L.cw1 = o; o += s.m * L.ld_m4;
  L.cb1 = o; o += s.m4;
  L.cw2 = o; o += s.m4;
  L.misc = o; o += 3;
  o = (o + 3) & ~3;             // the tile buffers are read as float4
  L.H = o; o += s.h * L.ldr;
  if (backward) { L.S = o; o += s.h * L.ldr; } else { L.S = L.H; }
  L.X = o; o += s.d * L.ldr;
  L.DISTF = o; o += dd * L.ldr;  // straight after X: [fj | distf] is one operand
  if (backward) { L.Z2 = o; o += s.m * L.ldr; } else { L.Z2 = -1; }  // the forward keeps no z2
  L.M0 = o; o += s.m * L.ldr;
  if (s.soft_edges) { L.MSG = o; o += s.m * L.ldr; } else { L.MSG = L.M0; }
  L.CZ1 = o; o += s.m4 * L.ldr;
  L.REL = o; o += s.c * L.ldr;
  L.ROW = o; o += kRowScalars * L.ldr;
  L.JDX = o; o += L.ldr;
  L.DM = L.DREL = L.DDF = L.DCZ1 = L.ONES = L.NXT = o;
  if (backward) {
    L.DM = o; o += s.m * L.ldr;
    L.DREL = o; o += s.c * L.ldr;
    L.DDF = o; o += dd * L.ldr;
    L.DCZ1 = o; o += s.m4 * L.ldr;
    L.ONES = o; o += L.ldr;       // a line of ones: the biases' column
  } else {
    // the staging region: rows pair rows, then the tile's nodes' coordinates
    // and proj_i rows
    L.NXT = o; o += s.rows * L.ldn + s.ti * (s.c + s.h);
  }
  L.total = o;
  return L;
}

// the per-row scalars, each a line of the ROW buffer
enum RowScalar { DIST = 0, PV, NRM, GATE, WZ, WCL, DWZ, DZG, DDIST, DSC };

// The activations use the exact exponential and the IEEE division, as the
// plain versions and the unfused layer do; the approximate intrinsics
// (__expf, __fdividef) would save time and are left to a later redesign.
__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
// silu'(x) = sg + silu(x) * (1 - sg), sg = sigmoid(x): from the two values
// the recomputation keeps, with no second exponential
__device__ __forceinline__ float dsilu_from(float sg, float silu) {
  return fmaf(silu, 1.f - sg, sg);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---- the tensor-core mode's rounding ----

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded to bf16 where the mode rounds the product it feeds (`on`); x
// itself in the f32 instantiations, where the test compiles to nothing
template <bool kBf16>
__device__ __forceinline__ float rnd(float x, bool on) {
  return kBf16 && on ? bf16_round(x) : x;
}

template <bool kBf16>
__device__ __forceinline__ float4 rnd4(float4 v, bool on) {
  return make_float4(rnd<kBf16>(v.x, on), rnd<kBf16>(v.y, on), rnd<kBf16>(v.z, on),
                     rnd<kBf16>(v.w, on));
}

// The lines [*lo, *hi) of two operands laid end to end (n1 lines, then n2)
// whose products round: the first where `first`, the second where `second`.
__host__ __device__ inline void round_range(bool first, int n1, bool second, int n2, int* lo,
                                            int* hi) {
  *lo = first ? 0 : n1;
  *hi = second ? n1 + n2 : n1;
}

// kRows (a multiple of 4) consecutive floats, 16-byte aligned
template <int kRows>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows; q += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + q);
    v[q] = a.x; v[q + 1] = a.y; v[q + 2] = a.z; v[q + 3] = a.w;
  }
}

template <int kRows>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows; q += 4)
    *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// One product of the tile and what is done with it where it lands:
//   v(r, j) = sum_i A(r, i) * W[i * wsi + j * wsj]          r < rows, j < J
//             + bias[j], + node_bias[r / k][j], + row_bias[row_idx[r]][j],
//             + add_of(r, j)                                 (each where given)
//   v *= silu'(x) from sig_of(r, j) = sigmoid(x), silu_of(r, j) = silu(x)
//                                                            (where given)
//   out(r, j) = v, silu_out(r, j) = silu(v), sig_out(r, j) = sigmoid(v)
//                                                            (each where given;
//                                                             sig_out with silu_out)
// A, out, silu_out, sig_out, sig_of, silu_of and add_of are tile buffers (line stride ldr); with
// row_major_ld > 0 `out` is a row-major array in device memory with that row
// stride. node_bias and row_bias are row-major (J wide) in device memory.
struct MmArgs {
  float* out;
  int row_major_ld;
  const float* A;
  const float* W;
  int wsi, wsj;
  const float* bias;
  int rows, I, J, ldr;
  float* silu_out;
  float* sig_out;
  const float* sig_of;
  const float* silu_of;
  const float* add_of;
  const float* node_bias;
  const float* row_bias;
  const int* row_idx;
  int k;
  int rlo, rhi;  // the tensor-core mode: the terms i in [rlo, rhi) round A and W
};

__device__ __forceinline__ MmArgs mm_args(float* out, const float* A, const float* W, int wsi,
                                          int wsj, int rows, int I, int J, int ldr) {
  MmArgs a;
  a.out = out; a.row_major_ld = 0; a.A = A; a.W = W; a.wsi = wsi; a.wsj = wsj;
  a.bias = nullptr; a.rows = rows; a.I = I; a.J = J; a.ldr = ldr;
  a.silu_out = nullptr; a.sig_out = nullptr; a.sig_of = nullptr; a.silu_of = nullptr;
  a.add_of = nullptr; a.node_bias = nullptr; a.row_bias = nullptr;
  a.row_idx = nullptr; a.k = 1;
  a.rlo = a.rhi = 0;
  return a;
}

// What follows a product elementwise, on the kRows rows r0.. of column j
// that a thread holds in v (see MmArgs).
template <int kRows>
__device__ __forceinline__ void mm_epilogue(const MmArgs& m, int j, int r0, float (&v)[kRows]) {
  const int ldr = m.ldr;
  // the rows past `rows` of the last group hold no one's data: they are
  // computed and stored like the others, and never read as results
  if (m.bias != nullptr) {
    const float base = m.bias[j];
#pragma unroll
    for (int q = 0; q < kRows; ++q) v[q] += base;
  }
  if (m.node_bias != nullptr) {
    // the rows of a group lie in one node or a few: one load a node
    int node = r0 / m.k, left = m.k - (r0 - node * m.k);
    float base = r0 < m.rows ? m.node_bias[(size_t)node * m.J + j] : 0.f;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (left == 0) {
        ++node;
        left = m.k;
        base = r0 + q < m.rows ? m.node_bias[(size_t)node * m.J + j] : 0.f;
      }
      v[q] += base;
      --left;
    }
  }
  if (m.row_bias != nullptr) {
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (r0 + q < m.rows) v[q] += m.row_bias[(size_t)m.row_idx[r0 + q] * m.J + j];
  }
  if (m.add_of != nullptr) {
    float ad[kRows];
    load_rows<kRows>(m.add_of + j * ldr + r0, ad);
#pragma unroll
    for (int q = 0; q < kRows; ++q) v[q] += ad[q];
  }
  if (m.sig_of != nullptr) {
    float sg[kRows], sl[kRows];
    load_rows<kRows>(m.sig_of + j * ldr + r0, sg);
    load_rows<kRows>(m.silu_of + j * ldr + r0, sl);
#pragma unroll
    for (int q = 0; q < kRows; ++q) v[q] *= dsilu_from(sg[q], sl[q]);
  }
  if (m.row_major_ld > 0) {
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (r0 + q < m.rows) m.out[(size_t)(r0 + q) * m.row_major_ld + j] = v[q];
  } else if (m.out != nullptr) {
    store_rows<kRows>(m.out + j * ldr + r0, v);
  }
  if (m.sig_out != nullptr) {
    float sg[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      sg[q] = sigmoid_f(v[q]);
      v[q] *= sg[q];  // silu_f(v), its sigmoid kept
    }
    store_rows<kRows>(m.sig_out + j * ldr + r0, sg);
    store_rows<kRows>(m.silu_out + j * ldr + r0, v);
  } else if (m.silu_out != nullptr) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) v[q] = silu_f(v[q]);
    store_rows<kRows>(m.silu_out + j * ldr + r0, v);
  }
}

// The products, register-blocked: a thread owns four rows by kCols
// columns, interleaved (jq, jq + nq, jq + 2 nq, ...; nq = ceil(J / kCols)), and
// a step of the sum is one float4 of activations and kCols weights for
// 4 * kCols FMAs. The threads of a warp take consecutive jq of one row group:
// the float4 is one broadcast, and each weight load falls on 32 distinct banks
// in either orientation (W and W^T) because the staged row strides are odd.
// Columns past J read the last column and are not stored. Each output adds
// its terms in the order of i. Inlined, so that the weight-gradient sums
// the backward keeps in registers are not saved and restored around a call.
// In the tensor-core mode (kBf16) the terms i in [m.rlo, m.rhi) round the
// activations and the weights to bf16 (mm_steps<kCols, true>): the products
// that stay on the FMAs in the mode, at widths below 8.
template <int kCols, bool kRound>
__device__ __forceinline__ void mm_steps(const MmArgs& m, const float* a, const int (&wo)[kCols],
                                         int i0, int i1, float (&v)[kCols][4]) {
#pragma unroll 4  // four steps' loads in flight: K10b 4.48 -> 4.35 ms at path C on the H100
  for (int i = i0; i < i1; ++i) {
    const float4 x = rnd4<kRound>(*reinterpret_cast<const float4*>(a + i * m.ldr), true);
    const float* w = m.W + i * m.wsi;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float wv = rnd<kRound>(w[wo[c]], true);
      v[c][0] = fmaf(x.x, wv, v[c][0]);
      v[c][1] = fmaf(x.y, wv, v[c][1]);
      v[c][2] = fmaf(x.z, wv, v[c][2]);
      v[c][3] = fmaf(x.w, wv, v[c][3]);
    }
  }
}

template <int kCols, bool kBf16 = false>
__device__ __forceinline__ void mm_blocked(const MmArgs& m) {
  const int groups = (m.rows + 3) >> 2;
  const int nq = (m.J + kCols - 1) / kCols;
  for (int o = threadIdx.x; o < groups * nq; o += blockDim.x) {
    const int g = o / nq, jq = o - g * nq, r0 = g * 4;
    const float* a = m.A + r0;
    int wo[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) wo[c] = min(jq + nq * c, m.J - 1) * m.wsj;
    float v[kCols][4];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[c][q] = 0.f;
    if (kBf16) {
      mm_steps<kCols, false>(m, a, wo, 0, m.rlo, v);
      mm_steps<kCols, true>(m, a, wo, m.rlo, m.rhi, v);
      mm_steps<kCols, false>(m, a, wo, m.rhi, m.I, v);
    } else {
      mm_steps<kCols, false>(m, a, wo, 0, m.I, v);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (jq + nq * c < m.J) mm_epilogue<4>(m, jq + nq * c, r0, v[c]);
  }
}

// The backward's column blocks, fixed for a launch. The narrow products (m,
// 4m or d wide) take one column: a wider block leaves threads idle and
// lengthens the others' paths. The h-wide ones (h1, d_h1) take kWideCols,
// one or five, which the launch picks by the shorter path through the block's
// threads (wide_cost): at 32 rows and h = 130 five columns make 208 items,
// one a thread, where one column makes 1040, five rounds for some threads
// and twice the loads; at 20 rows (kc = 20) one column makes three rounds and
// five leave half the threads idle. A choice made in the kernel, with both
// variants inlined at a site, measured slower than either fixed one
// (PERF.md): the choice is a template argument. The path of one thread
// through an h-wide product of a tile of ti * k rows: rounds of items (four
// rows by `cols` columns) times the instructions of a step of the sum (4 cols
// FMAs, 1 + cols loads).
inline int wide_cost(const Shape& s, int cols) {
  const int items = ((s.ti * s.k + 3) / 4) * ((s.h + cols - 1) / cols);
  return (items + kBwdThreads - 1) / kBwdThreads * (5 * cols + 1);
}

// ---- weight gradients in registers ----
//
// Every weight gradient of a tile is an outer product over its rows,
// dW(i, j) = sum_r A(r, i) * dY(r, j), of two sets of tile lines; a bias is
// one more A line of ones. The backward has five such products (six with the
// soft gate), each written to the weight-gradient layout as a matrix of I x J
// entries in order:
//   [fj | distf]^T d_h1   -> [Wj; Wd]            (K11: distf^T d_h1 -> Wd)
//   [s1 | 1]^T d_z2       -> [W2; b2]
//   [m0 | 1]^T d_zg       -> [gw; gb]            (soft gate)
//   [cmsg | 1]^T d_cz1    -> [cW1; cb1]
//   [cs1 | 1]^T d_wz      -> [cW2; cb2]
//   [1]^T d_scale         -> scale               (norm_coors)
// Each matrix is cut into blocks of 4 x 4 entries, interleaved: block (iq, jq)
// holds rows iq + P*a and columns jq + Q*c (a, c < 4; P = ceil(I/4), Q =
// ceil(J/4)), so that the threads of a warp, which take consecutive blocks,
// read consecutive lines, on distinct banks. Block b of the concatenated list
// belongs to thread b % blockDim.x, in slot b / blockDim.x; a thread keeps its
// first kSlots blocks in registers for the whole tile loop, adds each tile's
// sum over its rows (in row order) to them, and writes them to its block's row
// of `partial` at the end. Blocks beyond those slots (widths past the ones the
// kernel is tuned for) add their tile sums to `partial` in device memory in
// the same order, so where a block lives does not change its bits. No two
// threads share an entry: the result repeats. The slots are an instance's
// (bwd_kernel): kWgSlots where two blocks share an SM's registers (768
// blocks: all of anchor 3's 527), kOneBlockWgSlots in the f32 instances of
// one block an SM, which may take 255 registers a thread (1792 blocks: all
// of anchor 5's 1685).
constexpr int kWgSlots = 3;
constexpr int kOneBlockWgSlots = 7;
constexpr int kMaxWgMats = 6;
constexpr int kBwdTcTiles = 4;   // column tiles a warp item of the mode's h-wide products

struct WgMat {
  int a, ia;    // A lines: ia lines from shared-memory offset a, then the ones line
  int y;        // dY lines' offset
  int I, J, P, Q, dest, first;  // first: index of its first block in the list
  int rlo, rhi;  // the tensor-core mode: A lines [rlo, rhi) and dY round there
};

struct WgPlan {
  WgMat mat[kMaxWgMats];
  int count, blocks;
};

inline void add_mat(WgPlan& p, int a, int ia, int y, int I, int J, int dest, int rlo = 0,
                    int rhi = 0) {
  WgMat& M = p.mat[p.count++];
  M.a = a; M.ia = ia; M.y = y; M.I = I; M.J = J;
  M.rlo = rlo; M.rhi = rhi;
  M.P = (I + 3) >> 2; M.Q = (J + 3) >> 2;
  M.dest = dest; M.first = p.blocks;
  p.blocks += M.P * M.Q;
}

// In the tensor-core mode each outer product rounds where dG rounds it: the
// widths of both of its factors at least 8 (the one-column ones never; the
// biases' line of ones never).
WgPlan wgrad_plan(const Shape& s, bool gather, const Layout& L, const GradLayout& G) {
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const bool mode = s.mxu_bf16 != 0;
  WgPlan p;
  p.count = 0; p.blocks = 0;
  // [X | DISTF] are adjacent lines, as are the gradients of Wj and Wd
  if (gather) {
    add_mat(p, L.DISTF, dd, L.H, dd, s.h, G.wd);
  } else {
    int lo, hi;
    round_range(mode && s.d >= 8 && s.h >= 8, s.d, mode && dd >= 8 && s.h >= 8, dd, &lo, &hi);
    add_mat(p, L.X, s.d + dd, L.H, s.d + dd, s.h, G.wj, lo, hi);
  }
  const bool w2 = mode && s.h >= 8 && s.m >= 8, cw1 = mode && s.m >= 8 && s.m4 >= 8;
  add_mat(p, L.S, s.h, L.DM, s.h + 1, s.m, G.w2, 0, w2 ? s.h : 0);   // b2 follows w2
  if (s.soft_edges) add_mat(p, L.M0, s.m, L.ROW + DZG * ldr, s.m + 1, 1, G.gw);
  add_mat(p, s.gate_feats_only ? L.M0 : L.MSG, s.m, L.DCZ1, s.m + 1, s.m4, G.cw1, 0,
          cw1 ? s.m : 0);
  add_mat(p, L.CZ1, s.m4, L.ROW + DWZ * ldr, s.m4 + 1, 1, G.cw2);  // cb2 follows cw2
  if (s.norm_coors) add_mat(p, 0, 0, L.ROW + DSC * ldr, 1, 1, G.scale);
  return p;
}

// The matrix that block b of the plan belongs to.
__device__ __forceinline__ WgMat find_mat(const WgPlan& p, int b) {
  int q = 0;
  for (int t = 1; t < p.count; ++t)
    if (b >= p.mat[t].first) q = t;
  return p.mat[q];
}

// v(a, c) = sum over r < rows, in row order, of A(r, i_a) * dY(r, j_c) for
// block b of matrix M; entries past the matrix's edge read a valid line and
// are never stored. In the tensor-core mode (kBf16) the A lines in
// [M.rlo, M.rhi) and the dY they meet round to bf16.
template <bool kBf16 = false>
__device__ __forceinline__ void wgrad_block(const float* sm, const WgMat& M, int b, int rows,
                                            int ldr, int ones, float (&v)[4][4]) {
  const int bb = b - M.first, iq = bb / M.Q, jq = bb - iq * M.Q;
  int al[4], yl[4];
  bool ra[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = iq + M.P * a;
    al[a] = i < M.ia ? M.a + i * ldr : ones;
    ra[a] = kBf16 && i >= M.rlo && i < M.rhi;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) yl[c] = M.y + min(jq + M.Q * c, M.J - 1) * ldr;
  const int ncols = M.J == 1 ? 1 : 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) v[a][c] = 0.f;
  int r = 0;
  for (; r + 4 <= rows; r += 4) {
    float4 y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = *reinterpret_cast<const float4*>(sm + yl[c] + r);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 x = rnd4<kBf16>(*reinterpret_cast<const float4*>(sm + al[a] + r), ra[a]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c > 0 && c >= ncols) break;  // a matrix one column wide (the J = 1 ones)
        const float4 yc = rnd4<kBf16>(y[c], ra[a]);
        v[a][c] = fmaf(x.x, yc.x, v[a][c]);
        v[a][c] = fmaf(x.y, yc.y, v[a][c]);
        v[a][c] = fmaf(x.z, yc.z, v[a][c]);
        v[a][c] = fmaf(x.w, yc.w, v[a][c]);
      }
    }
  }
  for (; r < rows; ++r) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[a][c] = fmaf(rnd<kBf16>(sm[al[a] + r], ra[a]), rnd<kBf16>(sm[yl[c] + r], ra[a]),
                       v[a][c]);
  }
}

// Calls f(a, c, offset) for the entries of block b that lie in its matrix,
// with their offset in the weight-gradient layout.
template <typename F>
__device__ __forceinline__ void for_block_entries(const WgMat& M, int b, F f) {
  const int bb = b - M.first, iq = bb / M.Q, jq = bb - iq * M.Q;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = iq + M.P * a, j = jq + M.Q * c;
      if (i < M.I && j < M.J) f(a, c, M.dest + i * M.J + j);
    }
}

// kAsync: by cp.async (the caller commits and waits), so that every thread's
// loads are in flight at once
template <bool kAsync>
__device__ void stage_matrix(float* dst, int ld, const float* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, j = e - r * cols;
    if (kAsync) __pipeline_memcpy_async(dst + r * ld + j, src + e, sizeof(float));
    else dst[r * ld + j] = src[e];
  }
}

// The tensor-core mode's copies of a K x N weight (K, N >= 8), rounded to
// bf16 once as a block stages them, in the place of the f32 copy (K rows of
// ld32 >= N floats from float `off`) from its first 16-byte boundary (ldmatrix
// reads rows of 16 bytes). The backward's is transposed: row j holds column
// j's K values and zeros up to kp, the next multiple of 16, at a stride `ld`
// of kp + 8 values where that fits there (a fragment's loads then fall on 32
// distinct banks, (kp + 8) / 2 words being 4 modulo 8), else kp, which fits
// at every shape whose widths are all at least 8 but K = 8 with N odd, which
// no layer gives (h and 4m are even; shape_ok refuses it: ld 0). The
// forward's keeps W's own orientation (`rows`): row k holds its N values at a
// stride of np + 8, np, or N rounded up to 8 values, the first that fits (np:
// N rounded up to 16), and its products read B from it by ldmatrix.trans, as
// the backward reads W^T. off < 0: no copy, the f32 one.
struct Bf16Copy {
  int off = -1, ld = 0;
};

__host__ __device__ inline Bf16Copy bf16_copy(bool on, int off, int K, int N, int ld32,
                                              bool rows) {
  if (!on) return {};
  const int at = (off + 3) & ~3, room = 2 * (K * ld32 - (at - off));
  if (rows) {
    const int np = (N + 15) & ~15, n8 = (N + 7) & ~7;
    return {at, K * (np + 8) <= room ? np + 8 : K * np <= room ? np : K * n8 <= room ? n8 : 0};
  }
  const int kp = (K + 15) & ~15;
  return {at, (kp + 8) * N <= room ? kp + 8 : kp * N <= room ? kp : 0};
}

// The bf16 copies of Wj, Wd, W2 and cW1 in the mode: one for each weight
// that every product reading it rounds, the forward's by the forward's rule
// (contraction at least 8) and the backward's by dG's. That is where both
// widths of the weight are at least 8, at every shape the layers give (the
// two rules part only at h, m or m4 below 8); there both orientations of the
// weight go onto the tensor cores and no product needs its f32 copy.
// Elsewhere the f32 copy stays, and the products that read it stay on the
// FMAs, rounding their operands as they read them where the rules round.
// The forward and the backward take their copies by the same rule, so that
// the forward sums each product as the backward's recomputation does.
struct Bf16Copies {
  Bf16Copy wj, wd, w2, cw1;
};

__host__ __device__ inline Bf16Copies bf16_copies(const Shape& s, const Layout& L, bool backward) {
  const int dd = 2 * s.fourier + 1;
  const bool on = s.mxu_bf16 != 0, rows = !backward;
  return {bf16_copy(on && s.d >= 8 && s.h >= 8, L.wj, s.d, s.h, L.ld_h, rows),
          bf16_copy(on && dd >= 8 && s.h >= 8, L.wd, dd, s.h, L.ld_h, rows),
          bf16_copy(on && s.h >= 8 && s.m >= 8, L.w2, s.h, s.m, L.ld_m, rows),
          bf16_copy(on && s.m >= 8 && s.m4 >= 8, L.cw1, s.m, s.m4, L.ld_m4, rows)};
}

// The forward's tile buffers in the mode that hold bf16 rows in the place of
// f32 lines: row r holds its K values rounded to bf16, zeros from K up to
// the next multiple of 16, at a stride `ld` that is a multiple of 8 values
// (ldmatrix reads them as A fragments; kp + 8 where that fits the place, so
// that a fragment's rows fall on distinct banks, else kp). fj lies in X's
// place and distf in DISTF's where their product takes the tensor cores (Wj,
// Wd have copies), s1 in H's (h >= 8), silu(cz1) in CZ1's (4m >= 8) and after
// it cmsg where cmsg @ cW1 takes the tensor cores: the values that the
// forward reads only rounded, each rounded once where it is written. Each
// product reads the same bits that rounding on load would give. off < 0: the
// f32 lines.
struct ModeRows {
  Bf16Copy x, df, s1, cs1, cm;
};

__host__ __device__ inline int rows_ld(int K, int rows, int room) {
  const int kp = (K + 15) & ~15;
  return rows * (kp + 8) <= room ? kp + 8 : rows * kp <= room ? kp : 0;
}

__host__ __device__ inline ModeRows mode_rows(const Shape& s, const Layout& L,
                                              const Bf16Copies& cp) {
  const int dd = 2 * s.fourier + 1, R = s.rows, room = 2 * L.ldr;   // bf16 values a line
  ModeRows b;
  b.x = cp.wj.off >= 0 ? Bf16Copy{L.X, rows_ld(s.d, R, s.d * room)} : Bf16Copy{};
  b.df = cp.wd.off >= 0 ? Bf16Copy{L.DISTF, rows_ld(dd, R, dd * room)} : Bf16Copy{};
  b.s1 = s.h >= 8 ? Bf16Copy{L.H, rows_ld(s.h, R, s.h * room)} : Bf16Copy{};
  if (s.m4 >= 8) {
    // both in CZ1's place: the wider strides first
    const int p = (s.m4 + 15) & ~15, q = cp.cw1.off >= 0 ? (s.m + 15) & ~15 : 0;
    const int total = s.m4 * room;
    int lp = p, lq = q;
    if (R * (p + 8 + (q ? q + 8 : 0)) <= total) { lp = p + 8; lq = q ? q + 8 : 0; }
    else if (R * (p + (q ? q + 8 : 0)) <= total) { lq = q ? q + 8 : 0; }
    else if (R * (p + 8 + q) <= total) { lp = p + 8; }
    else if (R * (p + q) > total) { lp = 0; }
    b.cs1 = Bf16Copy{L.CZ1, lp};
    if (q) b.cm = Bf16Copy{L.CZ1 + R * lp / 2, lp ? lq : 0};
  }
  return b;
}

__device__ __forceinline__ __nv_bfloat16* bf16_at(float* p) {
  return reinterpret_cast<__nv_bfloat16*>(p);
}

// W (K x N, row-major in device memory) into the backward's bf16 copy
// (transposed), rounded once; reads coalesced along the columns, eight of a
// thread's in flight at once.
__device__ void stage_bf16(__nv_bfloat16* dst, int ld, const float* src, int K, int N) {
  constexpr int kInFlight = 8;
  const int kp = (K + 15) & ~15, total = kp * N, nt = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += kInFlight * nt) {
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * nt;
      v[u] = e < K * N ? __ldg(src + e) : 0.f;   // the rows from K to kp are zeros
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * nt;
      if (e < total) {
        const int k = e / N, j = e - k * N;
        dst[j * ld + k] = __float2bfloat16_rn(v[u]);
      }
    }
  }
}

// W (K x N, row-major in device memory) into the forward's bf16 copy (rows),
// rounded once: 16-byte loads where W is 16-byte aligned, eight of a
// thread's in flight at once (anchor 3's four weights in one round of a
// block), so that the block waits for one round trip to L2 and not eight.
// The padding is left as it is: B's columns past N give outputs that are
// never stored, and its rows past K are never read (load_b_frag).
__device__ void stage_bf16_rows(__nv_bfloat16* dst, int ld, const float* src, int K, int N) {
  constexpr int kInFlight = 8;
  const int total = K * N, nt = blockDim.x;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int n4 = vec ? total >> 2 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int v0 = threadIdx.x; v0 < n4; v0 += kInFlight * nt) {
    float4 x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (v0 + u * nt < n4) x[u] = __ldg(src4 + v0 + u * nt);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (v0 + u * nt >= n4) break;
      const int e = 4 * (v0 + u * nt);
      int k = e / N, j = e - k * N;
      const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dst[k * ld + j] = __float2bfloat16_rn(xs[c]);
        if (++j == N) { j = 0; ++k; }
      }
    }
  }
  for (int e0 = 4 * n4 + threadIdx.x; e0 < total; e0 += kInFlight * nt) {
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * nt;
      v[u] = e < total ? __ldg(src + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * nt;
      if (e < total) dst[(e / N) * ld + e % N] = __float2bfloat16_rn(v[u]);
    }
  }
}

// In the tensor-core mode (kBf16) the weights with a bf16 copy (`cp`) take it
// in place of their f32 copy: the forward's (kRows) in W's orientation, the
// backward's transposed.
template <bool kAsync = false, bool kBf16 = false, bool kRows = false>
__device__ void stage_weights(const Shape& s, const Tensors& t, const Layout& L, float* sm,
                              const Bf16Copies& cp) {
  const int dd = 2 * s.fourier + 1;
  auto copy = [&](const Bf16Copy& c, const float* w, int K, int N) {
    if (kRows) stage_bf16_rows(bf16_at(sm + c.off), c.ld, w, K, N);
    else stage_bf16(bf16_at(sm + c.off), c.ld, w, K, N);
  };
  if (kBf16 && cp.wj.off >= 0) copy(cp.wj, t.wj, s.d, s.h);
  else stage_matrix<kAsync>(sm + L.wj, L.ld_h, t.wj, s.d, s.h);
  if (kBf16 && cp.wd.off >= 0) copy(cp.wd, t.wd, dd, s.h);
  else stage_matrix<kAsync>(sm + L.wd, L.ld_h, t.wd, dd, s.h);
  if (kBf16 && cp.w2.off >= 0) copy(cp.w2, t.w2, s.h, s.m);
  else stage_matrix<kAsync>(sm + L.w2, L.ld_m, t.w2, s.h, s.m);
  stage_matrix<kAsync>(sm + L.b2, s.m, t.b2, 1, s.m);
  if (s.soft_edges) stage_matrix<kAsync>(sm + L.gw, s.m, t.gw, 1, s.m);
  if (kBf16 && cp.cw1.off >= 0) copy(cp.cw1, t.cw1, s.m, s.m4);
  else stage_matrix<kAsync>(sm + L.cw1, L.ld_m4, t.cw1, s.m, s.m4);
  stage_matrix<kAsync>(sm + L.cb1, s.m4, t.cb1, 1, s.m4);
  stage_matrix<kAsync>(sm + L.cw2, s.m4, t.cw2, 1, s.m4);
  if (threadIdx.x == 0) {
    sm[L.misc + 0] = s.soft_edges ? t.gb[0] : 0.f;
    sm[L.misc + 1] = t.cb2[0];
    sm[L.misc + 2] = s.norm_coors ? t.scale[0] : 1.f;
  }
}

// The soft gate, one thread a row, the sum over m in order: GATE, and
// MSG = m0 * gate. The mode rounds m0 and gw at m >= 8. kCm: msg also into
// the bf16 rows `cm` (the mode's forward, where cmsg = msg feeds cmsg @ cW1).
template <bool kBf16 = false, bool kCm = false>
__device__ __forceinline__ void soft_gate(const Shape& s, const Layout& L, float* sm, int rows,
                                          __nv_bfloat16* cm = nullptr, int ldc = 0) {
  const int ldr = L.ldr;
  const bool rg = s.m >= 8;
  float* row = sm + L.ROW;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float zg = sm[L.misc + 0];
    for (int j = 0; j < s.m; ++j)
      zg = fmaf(rnd<kBf16>(sm[L.M0 + j * ldr + r], rg), rnd<kBf16>(sm[L.gw + j], rg), zg);
    const float gate = sigmoid_f(zg);
    row[GATE * ldr + r] = gate;
    for (int j = 0; j < s.m; ++j) {
      const float msg = sm[L.M0 + j * ldr + r] * gate;
      sm[L.MSG + j * ldr + r] = msg;
      if (kCm) cm[r * ldc + j] = __float2bfloat16_rn(msg);
    }
  }
}

// ---- the forward (K10f, K11f) ----

// The pointers into the forward's staging region, for one tile: K10's cj
// (rows x c), fj (rows x odd(d)) and pv, or K11's idx (int64) and pv; then
// the tile's own coordinates (ti x c) and proj_i rows (ti x h).
struct Staged {
  float *cj, *fj, *pv, *ci, *pi;
  long long* idx;
};

__device__ __forceinline__ Staged staged(const Shape& s, const Layout& L, float* sm) {
  Staged g;
  float* o = sm + L.NXT;
  g.idx = reinterpret_cast<long long*>(o);   // K11; 16-byte aligned
  g.cj = o;                                  // K10
  g.fj = o + s.rows * s.c;
  g.pv = s.d > 0 ? g.fj + s.rows * odd(s.d) : o + 2 * s.rows;
  g.ci = g.pv + s.rows;
  g.pi = g.ci + s.ti * s.c;
  return g;
}

// Queues the copies of a tile's inputs into the staging region (cp.async,
// four or eight bytes each: any alignment, any width) and commits them.
template <bool kGather>
__device__ __forceinline__ void stage_inputs(const Shape& s, const Tensors& t, const Layout& L,
                                             float* sm, int tile) {
  const int tiles_per_b = (s.n + s.ti - 1) / s.ti;
  const int ib = tile / tiles_per_b, i0 = (tile - ib * tiles_per_b) * s.ti;
  const int tn = min(s.ti, s.n - i0), rows = tn * s.k;
  const size_t node0 = (size_t)ib * s.n + i0, p0 = node0 * s.k;
  const int nt = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = nt >> 5;
  const Staged g = staged(s, L, sm);
  if (kGather) {
    for (int e = threadIdx.x; e < rows; e += nt)
      __pipeline_memcpy_async(g.idx + e, t.idx + p0 + e, sizeof(long long));
  } else {
    for (int e = threadIdx.x; e < rows * s.c; e += nt)
      __pipeline_memcpy_async(g.cj + e, t.cj + p0 * s.c + e, sizeof(float));
    const int ldf = odd(s.d);
    for (int r = warp; r < rows; r += nwarps)   // a warp a row, coalesced
      for (int j = lane; j < s.d; j += 32)
        __pipeline_memcpy_async(g.fj + r * ldf + j, t.fj + (p0 + r) * s.d + j, sizeof(float));
  }
  for (int e = threadIdx.x; e < rows; e += nt)
    __pipeline_memcpy_async(g.pv + e, t.pv + p0 + e, sizeof(float));
  for (int e = threadIdx.x; e < tn * s.c; e += nt)
    __pipeline_memcpy_async(g.ci + e, t.coors + node0 * s.c + e, sizeof(float));
  for (int e = threadIdx.x; e < tn * s.h; e += nt)
    __pipeline_memcpy_async(g.pi + e, t.proj_i + node0 * s.h + e, sizeof(float));
  __pipeline_commit();
}

// From the staging region (and, in K11, the gathered rows) into the tile
// buffers: REL, DIST, PV, NRM, [fj | distf] transposed, H = proj_i[i]
// (+ proj_j[idx]). The rows past `rows` are left as they are. The mode
// (kBf16) writes fj and distf as bf16 rows where ModeRows has them, and no H:
// its h1 product reads proj_i from the staging region.
template <bool kGather, bool kBf16 = false>
__device__ __forceinline__ void unpack_inputs(const Shape& s, const Tensors& t, const Layout& L,
                                              float* sm, int ib, int rows,
                                              const ModeRows& mr = ModeRows{}) {
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const int nt = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = nt >> 5;
  const Staged g = staged(s, L, sm);
  const float* coors_jb = kGather ? t.coors_j + (size_t)ib * s.nj * s.c : nullptr;  // K11
  float* row = sm + L.ROW;
  const bool df_rows = kBf16 && mr.df.off >= 0;
  auto put_df = [&](int f, int r, float v) {
    if (df_rows) bf16_at(sm + mr.df.off)[r * mr.df.ld + f] = __float2bfloat16_rn(v);
    else sm[L.DISTF + f * ldr + r] = v;
  };
  // geometry: a thread a (row, encoding); item f = 0 of a row writes its
  // rel, distance and scalars, item f > 0 the encodings of scale 2^(f-1)
  for (int e = threadIdx.x; e < rows * (s.fourier + 1); e += nt) {
    const int f = e / rows, r = e - f * rows;
    const float* ci = g.ci + (r / s.k) * s.c;
    const float* cj = kGather ? coors_jb + (size_t)g.idx[r] * s.c : g.cj + r * s.c;
    float dist = 0.f;
    for (int cc = 0; cc < s.c; ++cc) {
      const float rel = ci[cc] - cj[cc];
      if (f == 0) sm[L.REL + cc * ldr + r] = rel;
      dist = fmaf(rel, rel, dist);
    }
    if (f == 0) {
      row[DIST * ldr + r] = dist;
      row[PV * ldr + r] = g.pv[r];
      row[NRM * ldr + r] = sqrtf(fmaxf(dist, s.eps * s.eps));
      put_df(dd - 1, r, dist);
      // the mode's h1 epilogue: where row r's proj_i starts in the staging region
      if (kBf16) reinterpret_cast<int*>(sm + L.JDX)[r] = (r / s.k) * s.h;
    } else {
      const float xs = ldexpf(dist, -(f - 1));
      put_df(f - 1, r, sinf(xs));
      put_df(s.fourier + f - 1, r, cosf(xs));
    }
  }
  const int ldf = odd(s.d);
  if (!kGather && kBf16 && mr.x.off >= 0) {
    // fj as bf16 rows: a warp a row, two features a lane
    __nv_bfloat16* x = bf16_at(sm + mr.x.off);
    for (int r = warp; r < rows; r += nwarps)
      for (int j = 2 * lane; j < s.d; j += 64) {
        const float* src = g.fj + r * ldf + j;
        if (j + 1 < s.d)
          *reinterpret_cast<__nv_bfloat162*>(x + r * mr.x.ld + j) =
              __floats2bfloat162_rn(src[0], src[1]);
        else
          x[r * mr.x.ld + j] = __float2bfloat16_rn(src[0]);
      }
  } else if (!kGather) {
    // fj transposed: lanes over rows; the staged row stride is odd, so both
    // the reads and the writes fall on 32 distinct banks
    for (int j = warp; j < s.d; j += nwarps)
      for (int r = lane; r < rows; r += 32) sm[L.X + j * ldr + r] = g.fj[r * ldf + j];
  }
  if (kBf16) return;
  // H = proj_i[i] (+ proj_j[idx]): a warp takes four rows by eight features
  // a step (32-byte pieces of the rows in device memory; 32 distinct banks,
  // ldr being four times an odd number)
  for (int r4 = warp * 4; r4 < rows; r4 += nwarps * 4) {
    const int r = r4 + (lane & 3);
    if (r >= rows) continue;
    const float* pi = g.pi + (r / s.k) * s.h;
    const float* pj = kGather ? t.proj_j + ((size_t)ib * s.nj + g.idx[r]) * s.h : nullptr;
#pragma unroll 4
    for (int j = lane >> 2; j < s.h; j += 8)
      sm[L.H + j * ldr + r] = kGather ? pi[j] + __ldg(pj + j) : pi[j];
  }
}

// ---- the tensor-core products (the mode) ----

// d += a * b for one m16n8k8 tile, A 16 x 8 and B 8 x 8 in bf16, f32 sums:
// the first or the second half of an m16n8k16 step's fragments (a0 = a[0] or
// a[2], a1 = a[1] or a[3], b = b0 or b1).
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One operand pair of a tensor-core product: K tile lines of A (A(r, k) at
// A[k * ldr + r], f32), or in the mode's forward K values a row of bf16 rows
// Ab (A(r, k) at Ab[r * lda + k]; ModeRows), against a weight's bf16 copy W
// at stride ld (bf16_copy): B = the weight, or its transpose (tc_product_t).
struct TcSeg {
  const float* A;
  const __nv_bfloat16* W;
  int K, ld;
  const __nv_bfloat16* Ab;
  int lda;
};

// out(r, j) = silu(sum over the segments of A @ W (+ fA @ fW, f32, K < 8)
//                  + bias[j] + add_of(r, j))             r < rows, j < N
// and sig_out(r, j) = the sigmoid that silu took (where given).
struct TcArgs {
  TcSeg seg[2];
  int nseg;
  int rows, N, ldr;
  const float* fA;  // an f32 term of fK < 8 lines against f32 weights fW (row stride fws)
  const float* fW;
  int fK, fws;
  const float* bias;
  const float* add_of;
  float* out;
  float* sig_out;
};

__device__ __forceinline__ TcArgs tc_args(int rows, int N, int ldr, float* out) {
  TcArgs m;
  m.nseg = 0; m.rows = rows; m.N = N; m.ldr = ldr;
  m.fA = nullptr; m.fW = nullptr; m.fK = 0; m.fws = 0;
  m.bias = nullptr; m.add_of = nullptr; m.out = out; m.sig_out = nullptr;
  return m;
}

// A term of a product of the backward's recomputation (K lines of A against
// a K x N weight): onto the tensor cores where the weight has a bf16 copy
// (`c`, where bf16_copies places it), else the f32 term against the f32 copy
// at float w32 of sm (h1's fj @ Wj at d < 8 or distf @ Wd below fourier 4).
__device__ __forceinline__ void tc_term(TcArgs& m, const float* A, float* sm, const Bf16Copy& c,
                                        int w32, int K, int ld32) {
  if (c.off >= 0) {
    const TcSeg seg{A, bf16_at(sm + c.off), K, c.ld};
    if (m.nseg == 0) m.seg[0] = seg;   // fixed indices: the segments stay in registers
    else m.seg[1] = seg;
    ++m.nseg;
  } else if (K > 0) {
    m.fA = A; m.fW = sm + w32; m.fK = K; m.fws = ld32;
  }
}

// The A fragment of rows r0.. and contraction k0.. (zero from K on), rounded
// to bf16 as it is loaded. Rows past the tile's read the lines' padding or the
// next line: their results are never stored.
__device__ __forceinline__ void load_a_frag(const float* A, int K, int ldr, int r0, int k0,
                                            uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = (lane & 3) * 2;
  auto at = [&](int k, int r) { return k < K ? A[k * ldr + r] : 0.f; };
  a[0] = pack_bf16(at(k0 + q, r0 + g), at(k0 + q + 1, r0 + g));
  a[1] = pack_bf16(at(k0 + q, r0 + g + 8), at(k0 + q + 1, r0 + g + 8));
  a[2] = pack_bf16(at(k0 + q + 8, r0 + g), at(k0 + q + 9, r0 + g));
  a[3] = pack_bf16(at(k0 + q + 8, r0 + g + 8), at(k0 + q + 9, r0 + g + 8));
}

// The same from bf16 rows (A(r, k) at A[r * ld + k], rows of 16 bytes, zeros
// from K on): one ldmatrix.x4, whose four 8 x 8 blocks are the fragment's
// (rows r0.. and r0 + 8.., contraction k0.. and k0 + 8..), on distinct banks
// at a stride of kp + 8 values (ModeRows).
__device__ __forceinline__ void load_a_rows(const __nv_bfloat16* A, int ld, int r0, int k0,
                                            uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, blk = lane >> 3;
  const __nv_bfloat16* p = A + (r0 + (lane & 7) + (blk & 1) * 8) * ld + k0 + (blk >> 1) * 8;
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(at));
}

// The B fragment of contraction k0.. and column tile n0.. of a segment.
// kTrans false: W is the backward's copy of a K x N weight (row j holds
// column j), read as two words a lane; columns past N read the last column.
// kTrans true: W's rows are B's (each a contraction index: the backward's
// copy of an N x K weight, whose transpose B is, or the forward's copy of a K
// x N weight in its own orientation); its rows k0.. and k0 + 8.. give the two
// 8 x 8 blocks of the fragment by ldmatrix.trans, from rows of 16 bytes (the
// copy's start and stride are multiples of 16 bytes: bf16_copy), on 32
// distinct banks where the stride is 8 values past a multiple of 16 (anchor
// 3's and 5's widths); rows past K read row K - 1 against A's zeros there,
// and the columns past N give outputs that are never stored.
template <bool kTrans>
__device__ __forceinline__ void load_b_frag(const TcSeg& seg, int N, int k0, int n0, uint32_t& b0,
                                            uint32_t& b1) {
  const int lane = threadIdx.x & 31;
  if (kTrans) {
    const int row = min(k0 + (lane & 15), seg.K - 1);
    const uint32_t at = (uint32_t)__cvta_generic_to_shared(seg.W + row * seg.ld + n0);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b0), "=r"(b1) : "r"(at));
  } else {
    const int j = min(n0 + (lane >> 2), N - 1), q = lane & 3;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(seg.W + j * seg.ld + k0);
    b0 = w[q];
    b1 = w[q + 4];
  }
}

// The product by the block's warps, out(r, j) = sum over the segments of A @
// B, handed to epi(r, j, v) for r < rows, j < N: a warp item is one tile of
// 16 rows by a chunk of up to kTiles column tiles of 8; each step of 16 in
// the contraction loads the A fragment once for the chunk. The chunk is the
// one that gives the busiest warp the fewest column tiles (the epilogue's
// activations are most of the work), the larger on a tie. The A fragments'
// loads fall on 32 distinct banks (ldr is four times an odd number), as do
// the epilogue's.
// The tensor cores add a step's products to the sum they are given with
// truncation, not rounding to nearest. So both K10 kernels in the mode sum
// each half of a step (m16n8k8, eight products) from zero and add it to the
// f32 sum in round-to-nearest, which keeps their bf16 roundings of
// the activations nearer to the plain version's, and the forward sums every
// product as the backward's recomputation does (the same segments, steps and
// halves in the same order), so that the two round each value alike. On the
// H100 at path C, 28 of 65 536 self pairs' d_cj parted from the f32 plain
// version's by a bf16 step of their weight, against 46 with whole m16n8k16
// steps; chained, the tensor nearest chip_smoke.py phase 43's limit at anchor
// 5 went from 0.31 to 0.51 of it. kRowsA: A from bf16 rows (the mode's
// forward); kPairs: epi(r, j, v, v1) takes the two adjacent columns j and j + 1
// that a lane holds (v1 is past N where j + 1 is), else epi(r, j, v).
template <int kTiles, bool kTrans, bool kRowsA = false, bool kPairs = false, typename Epi>
__device__ __forceinline__ void tc_mma(const TcSeg (&segs)[2], int nseg, int rows, int N, int ldr,
                                       Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, q = (lane & 3) * 2;
  const int mt = (rows + 15) >> 4, nt = (N + 7) >> 3;
  int cnt = 1, busiest = 1 << 30;
  for (int c = 1; c <= kTiles; ++c) {
    const int tiles = (mt * ((nt + c - 1) / c) + nwarps - 1) / nwarps * c;
    if (tiles <= busiest) { busiest = tiles; cnt = c; }
  }
  const int chunks = (nt + cnt - 1) / cnt;
  for (int item = warp; item < mt * chunks; item += nwarps) {
    const int r0 = (item % mt) * 16, n0 = (item / mt) * cnt * 8;
    float acc[kTiles][4];
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      if (sg >= nseg) break;
      const TcSeg seg = segs[sg];
      for (int k0 = 0; k0 < seg.K; k0 += 16) {
        uint32_t a[4];
        if (kRowsA) load_a_rows(seg.Ab, seg.lda, r0, k0, a);
        else load_a_frag(seg.A, seg.K, ldr, r0, k0, a);
#pragma unroll
        for (int t = 0; t < kTiles; ++t) {
          if (t < cnt && n0 + t * 8 < N) {   // the same for the whole warp
            uint32_t b0, b1;
            load_b_frag<kTrans>(seg, N, k0, n0 + t * 8, b0, b1);
            float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16_k8(lo, a[0], a[1], b0);
            mma_bf16_k8(hi, a[2], a[3], b1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][e] = (acc[t][e] + lo[e]) + hi[e];
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (t >= cnt) break;
      if constexpr (kPairs) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = r0 + g + (e >> 1) * 8, j = n0 + t * 8 + q;
          if (r < rows && j < N) epi(r, j, acc[t][e], acc[t][e + 1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + (e >> 1) * 8, j = n0 + t * 8 + q + (e & 1);
          if (r < rows && j < N) epi(r, j, acc[t][e]);
        }
      }
    }
  }
}

// A product of TcArgs (the backward's recomputation: A @ W).
template <int kTiles>
__device__ __forceinline__ void tc_product(const TcArgs& m) {
  tc_mma<kTiles, false>(m.seg, m.nseg, m.rows, m.N, m.ldr, [&](int r, int j, float v) {
    for (int f = 0; f < m.fK; ++f) v = fmaf(m.fA[f * m.ldr + r], m.fW[f * m.fws + j], v);
    if (m.bias != nullptr) v += m.bias[j];
    if (m.add_of != nullptr) v += m.add_of[j * m.ldr + r];
    if (m.sig_out != nullptr) {
      const float sg = sigmoid_f(v);
      m.sig_out[j * m.ldr + r] = sg;
      m.out[j * m.ldr + r] = v * sg;   // silu_f(v), its sigmoid kept
    } else {
      m.out[j * m.ldr + r] = silu_f(v);
    }
  });
}

// A data-gradient product of the backward, out(r, j) = sum over i < K of
// A(r, i) * W(j, i) for the N x K weight W whose bf16 copy is `c` (A @ W^T,
// on the tensor cores), handed to epi(r, j, v).
template <int kTiles, typename Epi>
__device__ __forceinline__ void tc_product_t(const float* A, float* sm, const Bf16Copy& c, int K,
                                             int rows, int N, int ldr, Epi epi) {
  const TcSeg segs[2] = {{A, bf16_at(sm + c.off), K, c.ld}, {A, nullptr, 0, 0}};
  tc_mma<kTiles, true>(segs, 1, rows, N, ldr, epi);
}

// The tile's pipeline after the unpacking: H <- silu(h1), M0, MSG (GATE),
// CZ1 <- silu(cz1), and REL <- w * rel_n with w = clip(wz * pv). Ends on a
// barrier. (The tensor-core mode's is mode_products.)
template <bool kGather>
__device__ __forceinline__ void forward_products(const Shape& s, const Layout& L, float* sm,
                                                 int rows) {
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const int nt = blockDim.x;
  float* row = sm + L.ROW;
  float* cmsg = sm + (s.gate_feats_only ? L.M0 : L.MSG);

  // h1 = H + [fj | distf] @ [Wj; Wd] (K11: distf @ Wd); H <- silu(h1)
  {
    MmArgs m = kGather ? mm_args(nullptr, sm + L.DISTF, sm + L.wd, L.ld_h, 1, rows, dd, s.h, ldr)
                       : mm_args(nullptr, sm + L.X, sm + L.wj, L.ld_h, 1, rows, s.d + dd, s.h,
                                 ldr);
    m.add_of = sm + L.H;
    m.silu_out = sm + L.H;   // each element read and rewritten by its owner
    mm_blocked<5>(m);
  }
  __syncthreads();
  K10_STAGE(5);

  // m0 = silu(s1 @ W2 + b2)
  {
    MmArgs m = mm_args(nullptr, sm + L.H, sm + L.w2, L.ld_m, 1, rows, s.h, s.m, ldr);
    m.bias = sm + L.b2;
    m.silu_out = sm + L.M0;
    mm_blocked<1>(m);
  }
  __syncthreads();
  K10_STAGE(6);

  if (s.soft_edges) {
    soft_gate(s, L, sm, rows);
    __syncthreads();
    K10_STAGE(7);
  }

  // CZ1 <- silu(cmsg @ cW1 + cb1)
  {
    MmArgs m = mm_args(nullptr, cmsg, sm + L.cw1, L.ld_m4, 1, rows, s.m, s.m4, ldr);
    m.bias = sm + L.cb1;
    m.silu_out = sm + L.CZ1;
    mm_blocked<2>(m);
  }
  __syncthreads();
  K10_STAGE(8);

  // wz = silu(cz1) @ cW2 + cb2, w = clip(wz * pv), REL <- w * rel_n: eight
  // lanes a row, a lane every eighth feature, summed by a butterfly (each
  // lane ends with the same bits) and then a lane a coordinate
  {
    const int sub = threadIdx.x & 7, group = threadIdx.x >> 3, groups = nt >> 3;
    const float scale = sm[L.misc + 2];
    for (int base = 0; base < rows; base += groups) {   // the same trips for every lane
      const int r = base + group;
      const bool live = r < rows;
      const int rr = live ? r : 0;
      float acc = 0.f;
      for (int q = sub; q < s.m4; q += 8) acc = fmaf(sm[L.CZ1 + q * ldr + rr], sm[L.cw2 + q], acc);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (live && sub < s.c) {
        const float wm = (acc + sm[L.misc + 1]) * row[PV * ldr + r];
        const float w = s.has_clamp ? fminf(fmaxf(wm, -s.clamp), s.clamp) : wm;
        float rel_n = sm[L.REL + sub * ldr + r];
        if (s.norm_coors) rel_n = rel_n / row[NRM * ldr + r] * scale;
        sm[L.REL + sub * ldr + r] = w * rel_n;
      }
    }
  }
  __syncthreads();
  K10_STAGE(9);
}

// ---- the forward in the tensor-core mode (K10f, mxu_bf16) ----

// What follows a forward product in the mode that runs on the FMAs alone
// (its weight has no bf16 copy: a width below 8), on an output (r, j): its
// sum, fK terms of the f32 lines fA or of the bf16 rows fAb against the f32
// weight fW in the order of f, rounding both operands of the terms in [flo,
// fhi) as the rules do, then bias[j]; silu of that. The sums and their order
// are the backward's recomputation's (mm_blocked), so that the two compute
// the same bits. out32: f32 lines; out16: bf16 rows (ld16).
struct FwdEpi {
  const float* fA;
  const __nv_bfloat16* fAb;
  int fK, flo, fhi, fald;
  const float* fW;
  int fws;
  const float* bias;
  float* out32;
  __nv_bfloat16* out16;
  int ld16, N, ldr;
};

__device__ __forceinline__ FwdEpi fwd_epi(int N, int ldr) {
  FwdEpi e;
  e.fA = nullptr; e.fAb = nullptr; e.fK = 0; e.flo = e.fhi = 0; e.fald = 0;
  e.fW = nullptr; e.fws = 0; e.bias = nullptr;
  e.out32 = nullptr; e.out16 = nullptr; e.ld16 = 0; e.N = N; e.ldr = ldr;
  return e;
}

__device__ __forceinline__ float fwd_value(const FwdEpi e, int r, int j) {
  float v = 0.f;
  for (int f = 0; f < e.fK; ++f) {
    float a = e.fAb != nullptr ? __bfloat162float(e.fAb[r * e.fald + f]) : e.fA[f * e.ldr + r];
    float w = e.fW[f * e.fws + j];
    if (f >= e.flo && f < e.fhi) { a = bf16_round(a); w = bf16_round(w); }
    v = fmaf(a, w, v);
  }
  if (e.bias != nullptr) v += e.bias[j];
  return silu_f(v);
}

// o[0], o[1] (a bf16 row's columns j, j + 1) <- v0, v1 rounded, as one
// bf16x2 where both lie in the row (`two`)
__device__ __forceinline__ void put_pair(__nv_bfloat16* o, float v0, float v1, bool two) {
  if (two) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  else *o = __float2bfloat16_rn(v0);
}

// A forward product on the FMAs alone (FwdEpi), a thread an output: where
// a narrow width keeps a weight off the tensor cores.
__device__ __forceinline__ void fwd_product_fma(int rows, const FwdEpi e) {
  for (int o = threadIdx.x; o < rows * e.N; o += blockDim.x) {
    const int j = o / rows, r = o - j * rows;
    const float v = fwd_value(e, r, j);
    if (e.out32 != nullptr) e.out32[j * e.ldr + r] = v;
    if (e.out16 != nullptr) e.out16[r * e.ld16 + j] = __float2bfloat16_rn(v);
  }
}

// A tensor-core segment: K values a row of the bf16 rows `a` against the
// weight's copy `c`.
__device__ __forceinline__ TcSeg seg_rows(float* sm, const Bf16Copy& c, int K, const Bf16Copy& a) {
  return TcSeg{nullptr, bf16_at(sm + c.off), K, c.ld, bf16_at(sm + a.off), a.ld};
}

// The bf16 rows' padding, from K to the next multiple of 16, zeroed once a
// launch: an A fragment's last step reads it against B's row K - 1.
__device__ __forceinline__ void zero_padding(const Shape& s, const ModeRows& mr, float* sm) {
  auto zero = [&](const Bf16Copy& c, int K) {
    const int w = ((K + 15) & ~15) - K;
    if (c.off < 0 || w == 0) return;
    __nv_bfloat16* p = bf16_at(sm + c.off);
    for (int e = threadIdx.x; e < s.rows * w; e += blockDim.x)
      p[(e / w) * c.ld + K + e % w] = __float2bfloat16_rn(0.f);
  };
  zero(mr.x, s.d);
  zero(mr.df, 2 * s.fourier + 1);
  zero(mr.s1, s.h);
  zero(mr.cm, s.m);
}

// The mode's pipeline after the unpacking (K10 only): s1, m0 (MSG, GATE),
// silu(cz1), and REL <- w * rel_n. Each product sums as the backward's
// recomputation does: on the tensor cores where its weight has a bf16 copy,
// else on the FMAs in the order of its terms. s1, silu(cz1) and cmsg are
// written once as bf16 rows where the products read them rounded (ModeRows);
// m0 and msg stay f32 lines for the gate and the sums. proj_i is read from
// the staging region (pi), so the next tile's copies are queued
// (issue_next) only once the h1 product is done. A warp item is one tile of
// 16 rows by 8 columns: its A fragment is one ldmatrix.x4 a step, and items
// of two or four column tiles, which share it, took more registers than two
// blocks an SM leave (spills) and ran 2-21% slower on the H100
// (tools/k10_mode_probe.py clock ...@tiles=N). Ends on a barrier.
template <typename Next>
__device__ __forceinline__ void mode_products(const Shape& s, const Layout& L, const Bf16Copies& cp,
                                              const ModeRows& mr, float* sm, int rows,
                                              const float* pi, Next issue_next) {
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* row = sm + L.ROW;
  const TcSeg none{nullptr, nullptr, 0, 0, nullptr, 0};

  // h1 = proj_i[i] + [fj | distf] @ [Wj; Wd]; s1 = silu(h1). On the tensor
  // cores the epilogue adds the f32 term of the operand below 8 (fj @ Wj at d
  // < 8, distf @ Wd below fourier 4), then proj_i[i] from the staging region
  // (node_row: row r's node's offset there), as tile_forward's does.
  if (cp.wj.off >= 0 || cp.wd.off >= 0) {
    // fixed indices: the segments stay in registers
    const TcSeg sx = cp.wj.off >= 0 ? seg_rows(sm, cp.wj, s.d, mr.x) : none;
    const TcSeg sd = cp.wd.off >= 0 ? seg_rows(sm, cp.wd, dd, mr.df) : none;
    const TcSeg segs[2] = {cp.wj.off >= 0 ? sx : sd, sd};
    const int nseg = (cp.wj.off >= 0) + (cp.wd.off >= 0);
    const float* fA = sm + (cp.wj.off < 0 ? L.X : L.DISTF);
    const float* fW = sm + (cp.wj.off < 0 ? L.wj : L.wd);
    const int fK = cp.wj.off < 0 ? s.d : cp.wd.off < 0 ? dd : 0, fws = L.ld_h, N = s.h;
    const int* node_row = reinterpret_cast<const int*>(sm + L.JDX);
    __nv_bfloat16* out = bf16_at(sm + mr.s1.off);
    const int ld16 = mr.s1.ld;
    tc_mma<K10_MODE_TILES, true, true, true>(segs, nseg, rows, N, ldr,
                                             [=](int r, int j, float v0, float v1) {
      const bool two = j + 1 < N;
      for (int f = 0; f < fK; ++f) {
        const float a = fA[f * ldr + r];
        v0 = fmaf(a, fW[f * fws + j], v0);
        if (two) v1 = fmaf(a, fW[f * fws + j + 1], v1);
      }
      const float* p = pi + node_row[r] + j;
      v0 = silu_f(v0 + p[0]);
      if (two) v1 = silu_f(v1 + p[1]);
      put_pair(out + r * ld16 + j, v0, v1, two);
    });
  } else {
    // the FMAs: [fj | distf] against [Wj; Wd] in the order of i, rounding
    // where the rules round (tile_forward's mm_blocked), then proj_i
    int lo, hi;
    round_range(s.d >= 8, s.d, dd >= 8, dd, &lo, &hi);
    const int* node_row = reinterpret_cast<const int*>(sm + L.JDX);
    for (int o = threadIdx.x; o < rows * s.h; o += blockDim.x) {
      const int j = o / rows, r = o - j * rows;
      float v = 0.f;
      for (int f = 0; f < s.d + dd; ++f) {
        float a = sm[L.X + f * ldr + r], w = sm[L.wj + f * L.ld_h + j];
        if (f >= lo && f < hi) { a = bf16_round(a); w = bf16_round(w); }
        v = fmaf(a, w, v);
      }
      v = silu_f(v + pi[node_row[r] + j]);
      if (mr.s1.off >= 0) bf16_at(sm + mr.s1.off)[r * mr.s1.ld + j] = __float2bfloat16_rn(v);
      else sm[L.H + j * ldr + r] = v;
    }
  }
  __syncthreads();
  K10_STAGE(5);
  issue_next();   // the staging region's proj_i rows are read
  K10_STAGE(4);

  // m0 = silu(s1 @ W2 + b2) into M0, and cmsg's bf16 rows where cmsg is m0
  // and its product takes the tensor cores
  {
    float* m0 = sm + L.M0;
    const float* b2 = sm + L.b2;
    __nv_bfloat16* cm = (!s.soft_edges || s.gate_feats_only) && mr.cm.off >= 0
                            ? bf16_at(sm + mr.cm.off) : nullptr;
    const int ldc = mr.cm.ld, N = s.m;
    if (cp.w2.off >= 0) {
      const TcSeg segs[2] = {seg_rows(sm, cp.w2, s.h, mr.s1), none};
      tc_mma<K10_MODE_TILES, true, true, true>(segs, 1, rows, N, ldr,
                                               [=](int r, int j, float v0, float v1) {
        const bool two = j + 1 < N;
        v0 = silu_f(v0 + b2[j]);
        m0[j * ldr + r] = v0;
        if (two) {
          v1 = silu_f(v1 + b2[j + 1]);
          m0[(j + 1) * ldr + r] = v1;
        }
        if (cm != nullptr) put_pair(cm + r * ldc + j, v0, v1, two);
      });
    } else {
      FwdEpi e = fwd_epi(N, ldr);
      e.fK = s.h;
      e.fW = sm + L.w2;
      e.fws = L.ld_m;
      if (mr.s1.off >= 0) { e.fAb = bf16_at(sm + mr.s1.off); e.fald = mr.s1.ld; e.fhi = s.h; }
      else e.fA = sm + L.H;     // h < 8: exact
      e.bias = b2;
      e.out32 = m0;
      e.out16 = cm;
      e.ld16 = ldc;
      fwd_product_fma(rows, e);
    }
  }
  __syncthreads();
  K10_STAGE(6);

  if (s.soft_edges) {
    if (!s.gate_feats_only && mr.cm.off >= 0)
      soft_gate<true, true>(s, L, sm, rows, bf16_at(sm + mr.cm.off), mr.cm.ld);
    else
      soft_gate<true>(s, L, sm, rows);
    __syncthreads();
    K10_STAGE(7);
  }

  // silu(cz1) = silu(cmsg @ cW1 + cb1)
  {
    const float* cb1 = sm + L.cb1;
    const int N = s.m4;
    if (cp.cw1.off >= 0) {   // 4m >= 8: silu(cz1) as bf16 rows
      const TcSeg segs[2] = {seg_rows(sm, cp.cw1, s.m, mr.cm), none};
      __nv_bfloat16* out = bf16_at(sm + mr.cs1.off);
      const int ld16 = mr.cs1.ld;
      tc_mma<K10_MODE_TILES, true, true, true>(segs, 1, rows, N, ldr,
                                               [=](int r, int j, float v0, float v1) {
        const bool two = j + 1 < N;
        v0 = silu_f(v0 + cb1[j]);
        if (two) v1 = silu_f(v1 + cb1[j + 1]);
        put_pair(out + r * ld16 + j, v0, v1, two);
      });
    } else {
      FwdEpi e = fwd_epi(N, ldr);
      e.fA = sm + (s.gate_feats_only ? L.M0 : L.MSG);
      e.fK = s.m;
      e.fW = sm + L.cw1;
      e.fws = L.ld_m4;
      e.fhi = s.m >= 8 ? s.m : 0;
      e.bias = cb1;
      if (mr.cs1.off >= 0) { e.out16 = bf16_at(sm + mr.cs1.off); e.ld16 = mr.cs1.ld; }
      else e.out32 = sm + L.CZ1;
      fwd_product_fma(rows, e);
    }
  }
  __syncthreads();
  K10_STAGE(8);

  // wz = silu(cz1) @ cW2 + cb2, w = clip(wz * pv), REL <- w * rel_n: eight
  // lanes a row, summed as the backward's recomputation sums wz (a warp a
  // row: lane l's chain over the features l, l + 32, ..., then a butterfly),
  // so that both take each clamp alike: lane s of the eight keeps the chains
  // of lanes s, s + 8, s + 16 and s + 24, adds them as the butterfly's first
  // two levels do, then the last three by shuffles
  {
    const int sub = threadIdx.x & 7, group = threadIdx.x >> 3, groups = blockDim.x >> 3;
    const float scale = sm[L.misc + 2];
    const bool rc = s.m4 >= 8;
    const __nv_bfloat16* cs = mr.cs1.off >= 0 ? bf16_at(sm + mr.cs1.off) : nullptr;
    const int ldc = mr.cs1.ld;
    for (int base = 0; base < rows; base += groups) {   // the same trips for every lane
      const int r = base + group;
      const bool live = r < rows;
      const int rr = live ? r : 0;
      float leaf[4] = {0.f, 0.f, 0.f, 0.f};   // the chains of lanes sub + 8 * u
      if (cs != nullptr) {
        const __nv_bfloat16* x = cs + rr * ldc;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          for (int q = sub + 8 * u; q < s.m4; q += 32)
            leaf[u] = fmaf(__bfloat162float(x[q]), bf16_round(sm[L.cw2 + q]), leaf[u]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          for (int q = sub + 8 * u; q < s.m4; q += 32)
            leaf[u] = fmaf(sm[L.CZ1 + q * ldr + rr], rnd<true>(sm[L.cw2 + q], rc), leaf[u]);
      }
      float acc = (leaf[0] + leaf[2]) + (leaf[1] + leaf[3]);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (live && sub < s.c) {
        const float wm = (acc + sm[L.misc + 1]) * row[PV * ldr + r];
        const float w = s.has_clamp ? fminf(fmaxf(wm, -s.clamp), s.clamp) : wm;
        K10_TAP_W(sub, r, w);
        float rel_n = sm[L.REL + sub * ldr + r];
        if (s.norm_coors) rel_n = rel_n / row[NRM * ldr + r] * scale;
        sm[L.REL + sub * ldr + r] = w * rel_n;
      }
    }
  }
  __syncthreads();
  K10_STAGE(9);
}

// m_i[i] = sum_t msg * pv, coors_delta[i] = sum_t (w * rel_n): a thread an
// output, its node's slots in order. (Two, four or eight lanes an output,
// combined by a butterfly, measured slower for K10 at anchor 3's, path C's
// and path A's shapes: PERF.md.)
__device__ __forceinline__ void forward_sums(const Shape& s, const Tensors& t, const Layout& L,
                                             const float* sm, size_t node0, int tn) {
  const int ldr = L.ldr;
  const int width = s.m + s.c;
  const float* pv = sm + L.ROW + PV * ldr;
  for (int o = threadIdx.x; o < tn * width; o += blockDim.x) {
    const int i = o / width, j = o - i * width;
    const int r0 = i * s.k;
    float acc = 0.f;
    if (j < s.m) {
      const float* msg = sm + L.MSG + j * ldr + r0;
      for (int q = 0; q < s.k; ++q) acc = fmaf(msg[q], pv[r0 + q], acc);
      t.m_i[(node0 + i) * s.m + j] = acc;
    } else {
      const float* wrel = sm + L.REL + (j - s.m) * ldr + r0;
      for (int q = 0; q < s.k; ++q) acc += wrel[q];
      t.cd[(node0 + i) * s.c + (j - s.m)] = acc;
    }
  }
}

// A block walks its tiles (tile = blockIdx.x, += gridDim.x, across batch
// elements): it waits for the tile's staged inputs, unpacks them, queues the
// next tile's copies (none after its last) and computes.
template <bool kGather>
__global__ void __launch_bounds__(kFwdThreads, 2)
pair_fwd_kernel(const Shape s, const Tensors t) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout L = make_layout(s, false);
  const int tiles_per_b = (s.n + s.ti - 1) / s.ti, tiles = s.b * tiles_per_b;
  K10_STAGE(-1);
  if ((int)blockIdx.x < tiles) stage_inputs<kGather>(s, t, L, sm, blockIdx.x);
  K10_STAGE(0);
  stage_weights<true>(s, t, L, sm, bf16_copies(s, L, false));
  __pipeline_commit();
  K10_STAGE(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ib = tile / tiles_per_b, i0 = (tile - ib * tiles_per_b) * s.ti;
    const int tn = min(s.ti, s.n - i0), rows = tn * s.k;
    __pipeline_wait_prior(0);
    __syncthreads();   // the inputs have landed; the last tile's sums are read
    K10_STAGE(2);
    unpack_inputs<kGather>(s, t, L, sm, ib, rows);
    __syncthreads();   // the staging region is free
    K10_STAGE(3);
    if (tile + (int)gridDim.x < tiles) stage_inputs<kGather>(s, t, L, sm, tile + gridDim.x);
    K10_STAGE(4);
    forward_products<kGather>(s, L, sm, rows);
    forward_sums(s, t, L, sm, (size_t)ib * s.n + i0, tn);
    K10_STAGE(10);
  }
}

// K10f in the tensor-core mode: pair_fwd_kernel's tile loop around
// mode_products. Its weights' bf16 copies are staged synchronously under the
// first tile's copies, and it queues the next tile's copies after its h1
// product, which reads proj_i from the staging region.
__global__ void __launch_bounds__(kFwdThreads, 2)
pair_fwd_mode_kernel(const Shape s, const Tensors t) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout L = make_layout(s, false);
  const Bf16Copies cp = bf16_copies(s, L, false);
  const ModeRows mr = mode_rows(s, L, cp);
  const int tiles_per_b = (s.n + s.ti - 1) / s.ti, tiles = s.b * tiles_per_b;
  K10_STAGE(-1);
  if ((int)blockIdx.x < tiles) stage_inputs<false>(s, t, L, sm, blockIdx.x);
  K10_STAGE(0);
  stage_weights<true, true, true>(s, t, L, sm, cp);
  __pipeline_commit();
  zero_padding(s, mr, sm);
  K10_STAGE(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ib = tile / tiles_per_b, i0 = (tile - ib * tiles_per_b) * s.ti;
    const int tn = min(s.ti, s.n - i0), rows = tn * s.k;
    const int next = tile + (int)gridDim.x;
    __pipeline_wait_prior(0);
    __syncthreads();   // the inputs have landed; the last tile's sums are read
    K10_STAGE(2);
    unpack_inputs<false, true>(s, t, L, sm, ib, rows, mr);
    __syncthreads();   // the staging region is read, but for proj_i
    K10_STAGE(3);
    mode_products(s, L, cp, mr, sm, rows, staged(s, L, sm).pi, [&] {
      if (next < tiles) stage_inputs<false>(s, t, L, sm, next);
    });
    K10_TAP_FWD(s, L, mr, sm, rows, ((size_t)ib * s.n + i0) * s.k);
    forward_sums(s, t, L, sm, (size_t)ib * s.n + i0, tn);
    K10_STAGE(10);
  }
}

// ---- the backward (K10b, K11b) ----

// The backward's recomputation of a tile's forward: leaves in shared memory
// silu(h1) (S), m0, msg, rel, [fj | distf], the row scalars DIST, PV, NRM,
// GATE, WZ, WCL (the clipped weight), the sigmoids of h1, z2, cz1 in H, Z2,
// CZ1 (for silu' without a second exponential) and silu(cz1) in DCZ1. Ends
// on a barrier. The tensor-core mode (kBf16) rounds the products' operands
// by the forward's rule, as K10f does: on the tensor cores where the weight
// has a bf16 copy (`cp`), the A fragments rounded as they load, else on the
// FMAs, rounding as they read.
template <bool kGather, int kWideCols, bool kBf16>
__device__ __forceinline__ void tile_forward(const Shape& s, const Tensors& t, const Layout& L,
                                             const Bf16Copies& cp, float* sm, int ib, int i0,
                                             int rows) {
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const size_t node0 = (size_t)ib * s.n + i0;
  const size_t p0 = node0 * s.k;
  float* row = sm + L.ROW;
  int* jdx = reinterpret_cast<int*>(sm + L.JDX);

  // the tensor-core h1 (the mode): H = proj_i[i] first, which the product's
  // epilogue adds, as in K10f's unpack_inputs (a warp four rows by eight
  // features a step, eight loads in flight)
  const bool tc_h1 = kBf16 && (cp.wj.off >= 0 || cp.wd.off >= 0);
  if (tc_h1) {
    for (int r4 = warp * 4; r4 < rows; r4 += nwarps * 4) {
      const int r = r4 + (lane & 3);
      if (r >= rows) continue;
      const float* pi = t.proj_i + (node0 + r / s.k) * s.h;
#pragma unroll 8
      for (int j = lane >> 2; j < s.h; j += 8) sm[L.H + j * ldr + r] = __ldg(pi + j);
    }
  }

  // geometry, one thread a row
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* ci = t.coors + (node0 + r / s.k) * s.c;
    const float* cjp;
    if (kGather) {
      const int j = (int)t.idx[p0 + r];
      jdx[r] = j;
      cjp = t.coors_j + ((size_t)ib * s.nj + j) * s.c;
    } else {
      cjp = t.cj + (p0 + r) * s.c;
    }
    float dist = 0.f;
    for (int cc = 0; cc < s.c; ++cc) {
      const float rel = ci[cc] - cjp[cc];
      sm[L.REL + cc * ldr + r] = rel;
      dist = fmaf(rel, rel, dist);
    }
    row[DIST * ldr + r] = dist;
    row[PV * ldr + r] = t.pv[p0 + r];
    row[NRM * ldr + r] = sqrtf(fmaxf(dist, s.eps * s.eps));
    float* df = sm + L.DISTF + r;
    for (int f = 0; f < s.fourier; ++f) {
      const float xs = ldexpf(dist, -f);
      df[f * ldr] = sinf(xs);
      df[(s.fourier + f) * ldr] = cosf(xs);
    }
    df[(dd - 1) * ldr] = dist;
  }
  if (!kGather) {
    // coalesced over a row's features; the transposed store is 4-way conflicted
    const float* src = t.fj + p0 * s.d;
    for (int r = warp; r < rows; r += nwarps)
      for (int j = lane; j < s.d; j += 32) sm[L.X + j * ldr + r] = src[r * s.d + j];
  }
  __syncthreads();

  // h1 = proj_i[i] (+ proj_j[idx]) + [fj | distf] @ [Wj; Wd]; s1 = silu(h1)
  if (tc_h1) {
    TcArgs m = tc_args(rows, s.h, ldr, sm + L.S);
    tc_term(m, sm + L.X, sm, cp.wj, L.wj, s.d, L.ld_h);
    tc_term(m, sm + L.DISTF, sm, cp.wd, L.wd, dd, L.ld_h);
    m.add_of = sm + L.H;
    m.sig_out = sm + L.H;   // each element read and rewritten by its owner
    tc_product<kBwdTcTiles>(m);
  } else {
    MmArgs m = kGather ? mm_args(nullptr, sm + L.DISTF, sm + L.wd, L.ld_h, 1, rows, dd, s.h, ldr)
                       : mm_args(nullptr, sm + L.X, sm + L.wj, L.ld_h, 1, rows, s.d + dd, s.h,
                                 ldr);
    m.sig_out = sm + L.H;
    m.silu_out = sm + L.S;
    m.node_bias = t.proj_i + node0 * s.h;
    m.k = s.k;
    if (kGather) {
      m.row_bias = t.proj_j + (size_t)ib * s.nj * s.h;
      m.row_idx = jdx;
    }
    round_range(s.d >= 8, s.d, dd >= 8, dd, &m.rlo, &m.rhi);   // kGather has no mode
    mm_blocked<kWideCols, kBf16>(m);
  }
  __syncthreads();

  // z2 = s1 @ W2 + b2; m0 = silu(z2)
  if (kBf16 && cp.w2.off >= 0) {
    TcArgs m = tc_args(rows, s.m, ldr, sm + L.M0);
    tc_term(m, sm + L.S, sm, cp.w2, L.w2, s.h, L.ld_m);
    m.bias = sm + L.b2;
    m.sig_out = sm + L.Z2;
    tc_product<kBwdTcTiles>(m);
  } else {
    MmArgs m = mm_args(nullptr, sm + L.S, sm + L.w2, L.ld_m, 1, rows, s.h, s.m, ldr);
    m.bias = sm + L.b2;
    m.silu_out = sm + L.M0;
    m.sig_out = sm + L.Z2;
    m.rhi = s.h >= 8 ? s.h : 0;
    mm_blocked<1, kBf16>(m);
  }
  __syncthreads();

  if (s.soft_edges) {
    soft_gate<kBf16>(s, L, sm, rows);
    __syncthreads();
  }

  // cz1 = cmsg @ cW1 + cb1
  const float* cmsg = sm + (s.gate_feats_only ? L.M0 : L.MSG);
  if (kBf16 && cp.cw1.off >= 0) {
    TcArgs m = tc_args(rows, s.m4, ldr, sm + L.DCZ1);
    tc_term(m, cmsg, sm, cp.cw1, L.cw1, s.m, L.ld_m4);
    m.bias = sm + L.cb1;
    m.sig_out = sm + L.CZ1;
    tc_product<kBwdTcTiles>(m);
  } else {
    MmArgs m = mm_args(nullptr, cmsg, sm + L.cw1, L.ld_m4, 1, rows, s.m, s.m4, ldr);
    m.bias = sm + L.cb1;
    m.sig_out = sm + L.CZ1;
    m.silu_out = sm + L.DCZ1;
    m.rhi = s.m >= 8 ? s.m : 0;
    mm_blocked<1, kBf16>(m);
  }
  __syncthreads();

  // wz = silu(cz1) @ cW2 + cb2; w = clip(wz * pv); one warp a row
  const bool rc = s.m4 >= 8;
  for (int r = warp; r < rows; r += nwarps) {
    float acc = 0.f;
    for (int q = lane; q < s.m4; q += 32)
      acc = fmaf(rnd<kBf16>(sm[L.DCZ1 + q * ldr + r], rc), rnd<kBf16>(sm[L.cw2 + q], rc), acc);
    const float wz = warp_sum(acc) + sm[L.misc + 1];
    if (lane == 0) {
      const float wm = wz * row[PV * ldr + r];
      row[WZ * ldr + r] = wz;
      row[WCL * ldr + r] = s.has_clamp ? fminf(fmaxf(wm, -s.clamp), s.clamp) : wm;
    }
  }
  __syncthreads();
  K10_TAP_BWD(kBf16, s, L, sm, rows, p0);
}

// The backward's offsets, computed on the host and read from the kernel's
// parameter space, where they take no registers.
struct BwdPlan {
  Layout L;
  GradLayout G;
  WgPlan wg;
  Bf16Copies cp;
};

// kBf16: the tensor-core mode (K10 only), its operands rounded where dG
// rounds them: the products with a real output width on the tensor cores
// wherever their weight has a bf16 copy (p.cp), the rest on the FMAs.
// kMinBlocks: the blocks an SM holds (bwd_kernel), which bound the registers;
// kSlots: the weight-gradient blocks a thread keeps in registers.
template <bool kGather, int kWideCols, bool kBf16, int kMinBlocks = 2, int kSlots = kWgSlots>
__global__ void __launch_bounds__(kBwdThreads, kMinBlocks)
pair_bwd_kernel(const Shape s, const Tensors t, const __grid_constant__ BwdPlan p) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout& L = p.L;
  const GradLayout& G = p.G;
  const WgPlan& plan = p.wg;
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = nt >> 5;
  float* row = sm + L.ROW;
  float* mine = t.partial + (size_t)blockIdx.x * G.total;
  const Bf16Copies& cp = p.cp;
  stage_weights<false, kBf16>(s, t, L, sm, cp);
  for (int r = threadIdx.x; r < ldr; r += nt) sm[L.ONES + r] = 1.f;
  float acc[kSlots][4][4];
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[sl][a][c] = 0.f;
  // the blocks past the register slots sum in the block's row of `partial`
  for (int b = kSlots * nt + threadIdx.x; b < plan.blocks; b += nt)
    for_block_entries(find_mat(plan, b), b, [&](int, int, int o) { mine[o] = 0.f; });
  __syncthreads();
  const float scale = sm[L.misc + 2];
  const float eps2 = s.eps * s.eps;
  const int tiles_per_b = (s.n + s.ti - 1) / s.ti;
  for (int tile = blockIdx.x; tile < s.b * tiles_per_b; tile += gridDim.x) {
    const int ib = tile / tiles_per_b, i0 = (tile - ib * tiles_per_b) * s.ti;
    const int tn = min(s.ti, s.n - i0), rows = tn * s.k;
    const size_t node0 = (size_t)ib * s.n + i0;
    const size_t p0 = node0 * s.k;
    tile_forward<kGather, kWideCols, kBf16>(s, t, L, cp, sm, ib, i0, rows);

    // ---- aggregation, clamp and CoorsNorm backward: eight lanes a row, a
    // lane a coordinate (c <= 8) ----
    {
      const int sub = threadIdx.x & 7, group = threadIdx.x >> 3, groups = nt >> 3;
      for (int base = 0; base < rows; base += groups) {   // the same trips for every lane
        const int r = base + group;
        const bool live = r < rows;
        const int rr = live ? r : 0;
        const float pv = row[PV * ldr + rr], nrm = row[NRM * ldr + rr], w = row[WCL * ldr + rr];
        float d_w = 0.f, dot = 0.f;  // dot = sum_c d_rel_n * rel
        if (live && sub < s.c) {
          const float gc = t.g_cd[(node0 + r / s.k) * s.c + sub];
          const float rel = sm[L.REL + sub * ldr + r];
          const float rel_n = s.norm_coors ? rel / nrm * scale : rel;
          const float d_rel_n = w * gc;
          d_w = gc * rel_n;
          dot = d_rel_n * rel;
          sm[L.DREL + sub * ldr + r] = s.norm_coors ? d_rel_n * (scale / nrm) : d_rel_n;
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) {
          d_w += __shfl_xor_sync(kFull, d_w, o);
          dot += __shfl_xor_sync(kFull, dot, o);
        }
        if (live && sub == 0) {
          const float wm = row[WZ * ldr + r] * pv;
          const bool inside = !s.has_clamp || (wm > -s.clamp && wm < s.clamp);
          row[DWZ * ldr + r] = inside ? d_w * pv : 0.f;
          float d_dist = 0.f, d_scale = 0.f;
          if (s.norm_coors) {
            const float d_nrm = dot * (-scale / (nrm * nrm));
            if (row[DIST * ldr + r] > eps2) d_dist = d_nrm * 0.5f / nrm;
            d_scale = dot / nrm;
          }
          row[DDIST * ldr + r] = d_dist;
          row[DSC * ldr + r] = d_scale;
        }
      }
    }
    __syncthreads();

    // ---- coordinate-weight MLP backward: CZ1 <- silu(cz1), DCZ1 <- d_cz1 ----
    for (int e = threadIdx.x; e < s.m4 * rows; e += nt) {
      const int q = e / rows, r = e - q * rows;
      const float sg = sm[L.CZ1 + q * ldr + r], cs = sm[L.DCZ1 + q * ldr + r];
      sm[L.DCZ1 + q * ldr + r] = row[DWZ * ldr + r] * sm[L.cw2 + q] * dsilu_from(sg, cs);
      sm[L.CZ1 + q * ldr + r] = cs;
    }
    __syncthreads();
    // d_cmsg = d_cz1 @ cW1^T
    if (kBf16 && cp.cw1.off >= 0) {
      tc_product_t<2>(sm + L.DCZ1, sm, cp.cw1, s.m4, rows, s.m, ldr,
                      [&](int r, int j, float v) { sm[L.DM + j * ldr + r] = v; });
    } else {
      mm_blocked<1>(mm_args(sm + L.DM, sm + L.DCZ1, sm + L.cw1, 1, L.ld_m4, rows, s.m4, s.m, ldr));
    }
    __syncthreads();

    // ---- messages, soft gate and silu backward: DM <- d_z2 ----
    if (s.soft_edges) {  // d_zg, a warp a row
      for (int r = warp; r < rows; r += nwarps) {
        const float* gm = t.g_mi + (node0 + r / s.k) * s.m;
        const float pv = row[PV * ldr + r];
        float d_g = 0.f;
        for (int j = lane; j < s.m; j += 32) {
          const float d_msg = fmaf(gm[j], pv, s.gate_feats_only ? 0.f : sm[L.DM + j * ldr + r]);
          d_g = fmaf(d_msg, sm[L.M0 + j * ldr + r], d_g);
        }
        d_g = warp_sum(d_g);
        if (lane == 0) {
          const float gate = row[GATE * ldr + r];
          row[DZG * ldr + r] = d_g * gate * (1.f - gate);
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < s.m * rows; e += nt) {
      const int j = e / rows, r = e - j * rows;
      const float gm = t.g_mi[(node0 + r / s.k) * s.m + j];
      const float d_cmsg = sm[L.DM + j * ldr + r];
      const float d_msg = fmaf(gm, row[PV * ldr + r], s.gate_feats_only ? 0.f : d_cmsg);
      float d_m0 = d_msg;
      if (s.soft_edges)
        d_m0 = fmaf(row[DZG * ldr + r], sm[L.gw + j], d_msg * row[GATE * ldr + r]);
      if (s.gate_feats_only) d_m0 += d_cmsg;  // the ungated coordinate branch
      sm[L.DM + j * ldr + r] = d_m0 * dsilu_from(sm[L.Z2 + j * ldr + r], sm[L.M0 + j * ldr + r]);
    }
    __syncthreads();

    // ---- edge MLP backward: H <- d_h1 = (d_z2 @ W2^T) * silu'(h1), in place ----
    if (kBf16 && cp.w2.off >= 0) {
      tc_product_t<kBwdTcTiles>(sm + L.DM, sm, cp.w2, s.m, rows, s.h, ldr,
                                [&](int r, int j, float v) {
                                  float* h = sm + L.H + j * ldr + r;   // read, then rewritten
                                  *h = v * dsilu_from(*h, sm[L.S + j * ldr + r]);
                                });
    } else {
      MmArgs m = mm_args(sm + L.H, sm + L.DM, sm + L.w2, 1, L.ld_m, rows, s.m, s.h, ldr);
      m.sig_of = sm + L.H;
      m.silu_of = sm + L.S;
      mm_blocked<kWideCols>(m);
    }
    __syncthreads();

    // ---- d_distf = d_h1 @ Wd^T, d_fj = d_h1 @ Wj^T (or the j-side rows),
    // d_proj_i, and every weight gradient of the tile ----
    if (kBf16 && cp.wd.off >= 0) {
      tc_product_t<2>(sm + L.H, sm, cp.wd, s.h, rows, dd, ldr,
                      [&](int r, int j, float v) { sm[L.DDF + j * ldr + r] = v; });
    } else {
      for (int e = threadIdx.x; e < dd * rows; e += nt) {  // four chains of j mod 4
        const int f = e / rows, r = e - f * rows;
        const float* w = sm + L.wd + f * L.ld_h;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        int j = 0;
        for (; j + 4 <= s.h; j += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = fmaf(sm[L.H + (j + q) * ldr + r], w[j + q], v[q]);
        for (; j < s.h; ++j) v[j & 3] = fmaf(sm[L.H + j * ldr + r], w[j], v[j & 3]);
        sm[L.DDF + f * ldr + r] = (v[0] + v[1]) + (v[2] + v[3]);
      }
    }
    if (!kGather && kBf16 && cp.wj.off >= 0) {
      float* d_fj = t.d_fj + p0 * s.d;   // row-major into device memory
      tc_product_t<2>(sm + L.H, sm, cp.wj, s.h, rows, s.d, ldr,
                      [&](int r, int j, float v) { d_fj[(size_t)r * s.d + j] = v; });
    } else if (!kGather) {
      MmArgs m = mm_args(t.d_fj + p0 * s.d, sm + L.H, sm + L.wj, 1, L.ld_h, rows, s.h, s.d, ldr);
      m.row_major_ld = s.d;  // row-major into device memory
      mm_blocked<1>(m);
    } else {
      const int pw = s.c + s.h;
      for (int e = threadIdx.x; e < rows * s.h; e += nt) {
        const int r = e / s.h, j = e - r * s.h;
        t.d_pairs[(p0 + r) * pw + s.c + j] = sm[L.H + j * ldr + r];
      }
    }
    for (int e = threadIdx.x; e < tn * s.h; e += nt) {
      const int i = e / s.h, j = e - i * s.h;
      float sum = 0.f;
      for (int q = 0; q < s.k; ++q) sum += sm[L.H + j * ldr + i * s.k + q];
      t.d_pi[(node0 + i) * s.h + j] = sum;
    }
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int b = sl * nt + threadIdx.x;
      if (b < plan.blocks) {
        float v[4][4];
        wgrad_block<kBf16>(sm, find_mat(plan, b), b, rows, ldr, L.ONES, v);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[sl][a][c] += v[a][c];
      }
    }
    for (int b = kSlots * nt + threadIdx.x; b < plan.blocks; b += nt) {
      const WgMat M = find_mat(plan, b);
      float v[4][4];
      wgrad_block<kBf16>(sm, M, b, rows, ldr, L.ONES, v);
      for_block_entries(M, b, [&](int a, int c, int o) { mine[o] += v[a][c]; });
    }
    __syncthreads();

    // ---- distance backward: eight lanes a row, the Fourier encodings
    // split over them and summed in a fixed order, a lane a coordinate ----
    {
      const int sub = threadIdx.x & 7, group = threadIdx.x >> 3, groups = nt >> 3;
      for (int base = 0; base < rows; base += groups) {   // the same trips for every lane
        const int r = base + group;
        const bool live = r < rows;
        const int rr = live ? r : 0;
        const float dist = row[DIST * ldr + rr];
        const float* ddf = sm + L.DDF + rr;
        float d_dist = 0.f;
        for (int f = sub; f < s.fourier; f += 8) {
          const float xs = ldexpf(dist, -f);
          d_dist += ldexpf(ddf[f * ldr] * cosf(xs) - ddf[(s.fourier + f) * ldr] * sinf(xs), -f);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) d_dist += __shfl_xor_sync(kFull, d_dist, o);
        d_dist += row[DDIST * ldr + rr] + ddf[(dd - 1) * ldr];
        if (live && sub < s.c) {
          const float d_rel =
              fmaf(2.f * sm[L.REL + sub * ldr + r], d_dist, sm[L.DREL + sub * ldr + r]);
          sm[L.DREL + sub * ldr + r] = d_rel;
          if (kGather) t.d_pairs[(p0 + r) * (s.c + s.h) + sub] = -d_rel;
          else t.d_cj[(p0 + r) * s.c + sub] = -d_rel;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tn * s.c; e += nt) {
      const int i = e / s.c, cc = e - i * s.c;
      float sum = 0.f;
      for (int q = 0; q < s.k; ++q) sum += sm[L.DREL + cc * ldr + i * s.k + q];
      t.d_ci[(node0 + i) * s.c + cc] = sum;
    }
    __syncthreads();  // the next tile rewrites the buffers
  }
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    const int b = sl * nt + threadIdx.x;
    if (b < plan.blocks)
      for_block_entries(find_mat(plan, b), b,
                        [&](int a, int c, int o) { mine[o] = acc[sl][a][c]; });
  }
  // the weights of options that are off have no block: their gradient is 0
  for (int e = threadIdx.x; e <= s.m; e += nt)
    if (!s.soft_edges) mine[G.gw + e] = 0.f;   // gw, then gb
  if (!s.norm_coors && threadIdx.x == 0) mine[G.scale] = 0.f;
}

// out[e] = partial[0][e] + partial[1][e] + ... in block order
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int blocks, int total,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int g = 0; g < blocks; ++g) s = __fadd_rn(s, partial[(size_t)g * total + e]);
  out[e] = s;
}

bool shape_ok(const Shape& s, bool gather, bool backward) {
  if (s.b < 1 || s.n < 1 || s.k < 1 || s.c < 1 || s.c > kMaxC || s.h < 1 || s.m < 1 ||
      s.m4 < 1 || s.fourier < 0 || s.fourier > kMaxFourier)
    return false;
  if (gather ? s.d != 0 || s.nj < 1 : s.d < 1) return false;
  if (gather && s.mxu_bf16) return false;   // K11 has no tensor-core mode
  if (s.rows < 8 || s.rows > kMaxRows || s.rows % 8 || s.ti < 1 || s.ti * s.k > s.rows)
    return false;
  const Layout L = make_layout(s, backward);
  const Bf16Copies cp = bf16_copies(s, L, backward);
  const ModeRows mr = backward || !s.mxu_bf16 ? ModeRows{} : mode_rows(s, L, cp);
  const Bf16Copy copies[9] = {cp.wj, cp.wd, cp.w2, cp.cw1, mr.x, mr.df, mr.s1, mr.cs1, mr.cm};
  for (const Bf16Copy& c : copies)
    if (c.off >= 0 && c.ld == 0) return false;   // no room for a copy or bf16 rows
  return (size_t)L.total * sizeof(float) <= (size_t)kMaxSmemBytes;
}

using FwdKernel = decltype(&pair_fwd_kernel<false>);
using BwdKernel = decltype(&pair_bwd_kernel<false, 1, false>);

// The f32 forward's instance (the mode's is pair_fwd_mode_kernel). K10's
// instances in the tensor-core mode are instantiated without the gather
// alone (shape_ok refuses K11 in the mode).
FwdKernel fwd_kernel(bool gather) {
  return gather ? &pair_fwd_kernel<true> : &pair_fwd_kernel<false>;
}

// The backward's instance: five columns a thread in the h-wide products
// where that gives the threads no longer a path (wide_cost), else one. The
// tensor-core mode takes one: its h-wide products run on the tensor cores
// wherever h is at least 8. Where two blocks fit no SM's shared memory (the
// wrapper's one-block tiles: anchor 5's 32 rows), both modes take the
// instance bounded by one block an SM. The mode's fragments spilled some of
// its weight-gradient sums with 128 registers (228 bytes) and none with 234,
// 8% off its time there; the f32 instance keeps kOneBlockWgSlots blocks in
// registers (H100).
BwdKernel bwd_kernel(const Shape& s, bool gather) {
  const size_t block = (size_t)make_layout(s, true).total * sizeof(float) + kSmBlockReserve;
  const bool one = 2 * block > (size_t)kSmSmemBytes;
  if (s.mxu_bf16)
    return one ? &pair_bwd_kernel<false, 1, true, 1> : &pair_bwd_kernel<false, 1, true, 2>;
  const bool wide = wide_cost(s, 5) <= wide_cost(s, 1);
  if (one && wide)
    return gather ? &pair_bwd_kernel<true, 5, false, 1, kOneBlockWgSlots>
                  : &pair_bwd_kernel<false, 5, false, 1, kOneBlockWgSlots>;
  if (one)
    return gather ? &pair_bwd_kernel<true, 1, false, 1, kOneBlockWgSlots>
                  : &pair_bwd_kernel<false, 1, false, 1, kOneBlockWgSlots>;
  if (wide) return gather ? &pair_bwd_kernel<true, 5, false> : &pair_bwd_kernel<false, 5, false>;
  return gather ? &pair_bwd_kernel<true, 1, false> : &pair_bwd_kernel<false, 1, false>;
}

// Lets `kernel` take the shape's shared memory, `*bytes` of it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, const Shape& s, bool backward, size_t* bytes) {
  *bytes = (size_t)make_layout(s, backward).total * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// The forward kernel takes (s, t); the backward kernel (s, t, plan).
template <typename Kernel, typename... Extra>
int launch_kernel(Kernel kernel, const Shape& s, const Tensors& t, bool backward, int grid,
                  cudaStream_t stream, const Extra&... extra) {
  size_t bytes;
  const cudaError_t err = allow_smem(kernel, s, backward, &bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, backward ? kBwdThreads : kFwdThreads, bytes, stream>>>(s, t, extra...);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int occupancy(Kernel kernel, const Shape& s, bool backward) {
  size_t bytes;
  int blocks = 0;
  if (allow_smem(kernel, s, backward, &bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, backward ? kBwdThreads : kFwdThreads, bytes) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

// Launches the forward (backward == 0) or the backward kernel of the
// pre-gathered (gather == 0) or the gathering form on `grid` blocks. The
// backward leaves each block's weight gradients in t->partial (grid, E) and
// then sums them in block order into weight_grads (E).
int pair_messages_launch(const Shape* s, const Tensors* t, int gather, int backward, int grid,
                         void* weight_grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = s->b * ((s->n + s->ti - 1) / s->ti);
  if (!shape_ok(*s, gather != 0, backward != 0) || grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  if (!backward && s->mxu_bf16)
    return launch_kernel(&pair_fwd_mode_kernel, *s, *t, false, grid, stream);
  if (!backward) return launch_kernel(fwd_kernel(gather != 0), *s, *t, false, grid, stream);
  BwdPlan plan;
  plan.L = make_layout(*s, true);
  plan.G = grad_layout(*s);
  plan.wg = wgrad_plan(*s, gather != 0, plan.L, plan.G);
  plan.cp = bf16_copies(*s, plan.L, true);
  const int err = launch_kernel(bwd_kernel(*s, gather != 0), *s, *t, true, grid, stream, plan);
  if (err != 0) return err;
  const int total = grad_layout(*s).total;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      t->partial, grid, total, static_cast<float*>(weight_grads));
  return (int)cudaGetLastError();
}

// Floats of shared memory a block keeps for this shape (the wrappers check
// their own copy of the layout against it).
int pair_messages_smem_floats(const Shape* s, int backward) {
  return make_layout(*s, backward != 0).total;
}

// Blocks of the kernel an SM holds at once for this shape (-1 on an error).
int pair_messages_blocks_per_sm(const Shape* s, int gather, int backward) {
  return backward ? occupancy(bwd_kernel(*s, gather != 0), *s, true)
         : s->mxu_bf16 ? occupancy(&pair_fwd_mode_kernel, *s, false)
                       : occupancy(fwd_kernel(gather != 0), *s, false);
}

}  // extern "C"
