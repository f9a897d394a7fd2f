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
// reads its pre-gathered rows and multiplies by Wj.
//
// Design. A block takes tiles of whole nodes, ti nodes x k slots <= 64 pair
// rows, in a loop (tile = blockIdx.x, += gridDim.x). The weights are staged in
// shared memory once a block, every row stride odd, so that a product reads
// them without bank conflicts both ways round (W and W^T). The tile's
// activations lie transposed in shared memory, one feature a line of
// rows + 4 floats: a thread that owns one output column of four rows reads
// one weight and one float4 of activations for four FMAs, and the float4
// accesses of a quarter warp fall on distinct banks because (rows + 4) / 4
// is odd. Each stage of the pipeline is such a product by the whole block
// with f32 FMAs (four rows a thread, or two where that gives the block's
// threads more even work), and stages are separated by barriers. What
// follows a product elementwise rides in its epilogue: the per-node and
// gathered terms of h1, the silu after it and after z2, the dsilu of the
// backward. The reductions over a node's k slots run over the tile's rows
// in slot order.
//
// Weight gradients. The TPU grid is sequential and adds into resident blocks
// step after step. Here every block keeps the gradient of all weights in
// shared memory; each entry is owned by one thread, which adds the tile's
// rows to it in row order, tile after tile. At the end a block writes its
// sums to its own row of `partial`, and a second kernel adds the rows in
// block order. No float atomics: with the grid fixed by the shape, the
// result repeats bit for bit.
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
// operations (0.23 ms forward at 1 048 576 pairs against 0.05 ms of bytes).
// This version makes two shared-memory loads for four FMAs in the products
// and three float4 loads for eight in the weight gradients, and waits at a
// barrier between stages with at most 16 warps an SM: it stays about ten
// times above the bound (the times are in PERF.md). Overlapping a tile's
// loads with the tile before it, and tensor cores (wgmma on bf16 or tf32
// operands), are later work.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxC = 8;         // coordinate width
constexpr int kMaxFourier = 16;  // Fourier encodings
constexpr int kMaxRows = 64;     // pair rows of a tile
constexpr int kRowScalars = 10;  // per-row scalars kept in shared memory
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

// Shape and Tensors are the launch function's arguments, C structs that the
// wrapper fills with ctypes: they have external linkage.
struct Shape {
  int b, n, k, c, d, h, m, m4, fourier, ti, rows;  // d = 0 in the gathering form
  int soft_edges, norm_coors, has_clamp, gate_feats_only;
  float clamp, eps;
};

struct Tensors {
  const float* coors;    // (b, n, c)
  const float* cj;       // (b, n*k, c)     pre-gathered form
  const float* fj;       // (b, n*k, d)     pre-gathered form
  const float* proj_i;   // (b, n, h)
  const float* proj_j;   // (b, n, h)       gathering form
  const long long* idx;  // (b, n, k)       gathering form
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
  int wj, wd, w2, b2, gw, cw1, cb1, cw2, misc;  // misc: gb, cb2, scale
  int H, S, X, DISTF, Z2, M0, MSG, DM, CZ1, REL, DREL, DDF, ROW, JDX, ACC;
  int total;
};

__host__ __device__ inline Layout make_layout(const Shape& s, bool backward) {
  Layout L;
  const int dd = 2 * s.fourier + 1;
  L.ld_h = odd(s.h);
  L.ld_m = odd(s.m);
  L.ld_m4 = odd(s.m4);
  L.ldr = s.rows + 4;
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
  L.Z2 = o; o += s.m * L.ldr;
  L.M0 = o; o += s.m * L.ldr;
  if (s.soft_edges) { L.MSG = o; o += s.m * L.ldr; } else { L.MSG = L.M0; }
  L.CZ1 = o; o += s.m4 * L.ldr;
  L.REL = o; o += s.c * L.ldr;
  L.ROW = o; o += kRowScalars * L.ldr;
  L.JDX = o; o += L.ldr;
  L.DM = L.DREL = L.DDF = L.ACC = o;
  if (backward) {
    L.DM = o; o += s.m * L.ldr;
    L.DREL = o; o += s.c * L.ldr;
    L.DDF = o; o += dd * L.ldr;
    L.ACC = o; o += grad_layout(s).total;
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
__device__ __forceinline__ float dsilu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.f + x * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// kRows consecutive floats, 16-byte (kRows = 2: 8-byte) aligned
template <int kRows>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[kRows]) {
  if constexpr (kRows == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < kRows; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      v[q] = a.x; v[q + 1] = a.y; v[q + 2] = a.z; v[q + 3] = a.w;
    }
  }
}

template <int kRows>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[kRows]) {
  if constexpr (kRows == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < kRows; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}

// One product of the tile and what is done with it where it lands:
//   v(r, j) = sum_i A(r, i) * W[i * wsi + j * wsj]          r < rows, j < J
//             + bias[j], + node_bias[r / k][j], + row_bias[row_idx[r]][j]
//                                                            (each where given)
//   v *= dsilu(dsilu_of(r, j))                               (where given)
//   out(r, j) = v, silu_out(r, j) = silu(v)                  (each where given)
// A, out, silu_out and dsilu_of are tile buffers (line stride ldr); with
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
  const float* dsilu_of;
  const float* node_bias;
  const float* row_bias;
  const int* row_idx;
  int k;
};

__device__ __forceinline__ MmArgs mm_args(float* out, const float* A, const float* W, int wsi,
                                          int wsj, int rows, int I, int J, int ldr) {
  MmArgs a;
  a.out = out; a.row_major_ld = 0; a.A = A; a.W = W; a.wsi = wsi; a.wsj = wsj;
  a.bias = nullptr; a.rows = rows; a.I = I; a.J = J; a.ldr = ldr;
  a.silu_out = nullptr; a.dsilu_of = nullptr; a.node_bias = nullptr; a.row_bias = nullptr;
  a.row_idx = nullptr; a.k = 1;
  return a;
}

// A thread owns column j of kRows rows: one weight and one float4 (float2) of
// activations a step of the sum.
template <int kRows>
__device__ __noinline__ void tile_mm_rows(const MmArgs m) {
  const int groups = (m.rows + kRows - 1) / kRows;
  const int ldr = m.ldr;
  for (int o = threadIdx.x; o < groups * m.J; o += blockDim.x) {
    const int g = o / m.J, j = o - g * m.J, r0 = g * kRows;
    const float* a = m.A + r0;
    const float* w = m.W + j * m.wsj;
    float v[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) v[q] = 0.f;
    for (int i = 0; i < m.I; ++i) {
      const float wv = w[i * m.wsi];
      float av[kRows];
      load_rows<kRows>(a + i * ldr, av);
#pragma unroll
      for (int q = 0; q < kRows; ++q) v[q] = fmaf(av[q], wv, v[q]);
    }
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
    if (m.dsilu_of != nullptr) {
      float x[kRows];
      load_rows<kRows>(m.dsilu_of + j * ldr + r0, x);
#pragma unroll
      for (int q = 0; q < kRows; ++q) v[q] *= dsilu_f(x[q]);
    }
    if (m.row_major_ld > 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (r0 + q < m.rows) m.out[(size_t)(r0 + q) * m.row_major_ld + j] = v[q];
    } else if (m.out != nullptr) {
      store_rows<kRows>(m.out + j * ldr + r0, v);
    }
    if (m.silu_out != nullptr) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) v[q] = silu_f(v[q]);
      store_rows<kRows>(m.silu_out + j * ldr + r0, v);
    }
  }
}

// The product with the rows a thread takes (4 or 2) picked by the cost of
// the block's rounds: rounds * (FMAs + loads of one step of the sum). Eight
// rows a thread spill registers under the kernels' launch bounds.
__device__ __forceinline__ void tile_mm(const MmArgs& m) {
  const int nt = blockDim.x;
  const int c4 = ((((m.rows + 3) >> 2) * m.J + nt - 1) / nt) * 6;
  const int c2 = ((((m.rows + 1) >> 1) * m.J + nt - 1) / nt) * 4;
  if (c4 <= c2) tile_mm_rows<4>(m);
  else tile_mm_rows<2>(m);
}

// acc[i * J + j] += sum over r < rows, in row order, of A(r, i) * dY(r, j), both
// tile buffers; A == nullptr stands for a column of ones (a bias). Each entry
// has one owner, so the order of its adds is fixed. A thread owns the entries
// (i, j) and (i + 1, j): one float4 of dY feeds both.
__device__ __noinline__ void tile_wgrad(float* acc, const float* A, const float* dY, int rows,
                                        int I, int J, int ldr) {
  const int pairs = (I + 1) >> 1;
  for (int e = threadIdx.x; e < pairs * J; e += blockDim.x) {
    const int ip = e / J, j = e - ip * J, i = ip << 1;
    const bool two = i + 1 < I;
    const float* a0 = A != nullptr ? A + i * ldr : nullptr;
    const float* a1 = two ? a0 + ldr : a0;
    const float* y = dY + j * ldr;
    float s0 = 0.f, s1 = 0.f;
    int r = 0;
    if (a0 != nullptr) {
      for (; r + 4 <= rows; r += 4) {
        const float4 yv = *reinterpret_cast<const float4*>(y + r);
        const float4 u = *reinterpret_cast<const float4*>(a0 + r);
        const float4 w = *reinterpret_cast<const float4*>(a1 + r);
        s0 = fmaf(u.x, yv.x, s0); s1 = fmaf(w.x, yv.x, s1);
        s0 = fmaf(u.y, yv.y, s0); s1 = fmaf(w.y, yv.y, s1);
        s0 = fmaf(u.z, yv.z, s0); s1 = fmaf(w.z, yv.z, s1);
        s0 = fmaf(u.w, yv.w, s0); s1 = fmaf(w.w, yv.w, s1);
      }
      for (; r < rows; ++r) {
        s0 = fmaf(a0[r], y[r], s0);
        s1 = fmaf(a1[r], y[r], s1);
      }
    } else {
      for (; r < rows; ++r) s0 += y[r];
    }
    acc[i * J + j] += s0;
    if (two) acc[(i + 1) * J + j] += s1;
  }
}

__device__ void stage_matrix(float* dst, int ld, const float* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, j = e - r * cols;
    dst[r * ld + j] = src[e];
  }
}

__device__ void stage_weights(const Shape& s, const Tensors& t, const Layout& L, float* sm) {
  const int dd = 2 * s.fourier + 1;
  stage_matrix(sm + L.wj, L.ld_h, t.wj, s.d, s.h);
  stage_matrix(sm + L.wd, L.ld_h, t.wd, dd, s.h);
  stage_matrix(sm + L.w2, L.ld_m, t.w2, s.h, s.m);
  stage_matrix(sm + L.b2, s.m, t.b2, 1, s.m);
  if (s.soft_edges) stage_matrix(sm + L.gw, s.m, t.gw, 1, s.m);
  stage_matrix(sm + L.cw1, L.ld_m4, t.cw1, s.m, s.m4);
  stage_matrix(sm + L.cb1, s.m4, t.cb1, 1, s.m4);
  stage_matrix(sm + L.cw2, s.m4, t.cw2, 1, s.m4);
  if (threadIdx.x == 0) {
    sm[L.misc + 0] = s.soft_edges ? t.gb[0] : 0.f;
    sm[L.misc + 1] = t.cb2[0];
    sm[L.misc + 2] = s.norm_coors ? t.scale[0] : 1.f;
  }
}

// The tile's forward: leaves in shared memory h1 (H; silu(h1) when H and S
// are one buffer), silu(h1) (S), z2, m0, msg, cz1, rel, [fj | distf] and the
// row scalars DIST, PV, NRM, GATE, WZ, WCL (the clipped weight). Ends on a
// barrier.
template <bool kGather>
__device__ void tile_forward(const Shape& s, const Tensors& t, const Layout& L, float* sm,
                             int ib, int i0, int rows) {
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const size_t node0 = (size_t)ib * s.n + i0;
  const size_t p0 = node0 * s.k;
  float* row = sm + L.ROW;
  int* jdx = reinterpret_cast<int*>(sm + L.JDX);

  // geometry, one thread a row
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* ci = t.coors + (node0 + r / s.k) * s.c;
    const float* cjp;
    if (kGather) {
      const int j = (int)t.idx[p0 + r];
      jdx[r] = j;
      cjp = t.coors + ((size_t)ib * s.n + j) * s.c;
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

  // h1 = proj_i[i] (+ proj_j[idx]) + [fj | distf] @ [Wj; Wd]; s1 = silu(h1).
  // The backward keeps h1 beside s1; the forward has one buffer for both.
  {
    MmArgs m = kGather ? mm_args(nullptr, sm + L.DISTF, sm + L.wd, L.ld_h, 1, rows, dd, s.h, ldr)
                       : mm_args(nullptr, sm + L.X, sm + L.wj, L.ld_h, 1, rows, s.d + dd, s.h,
                                 ldr);
    if (L.S != L.H) m.out = sm + L.H;
    m.silu_out = sm + L.S;
    m.node_bias = t.proj_i + node0 * s.h;
    m.k = s.k;
    if (kGather) {
      m.row_bias = t.proj_j + (size_t)ib * s.n * s.h;
      m.row_idx = jdx;
    }
    tile_mm(m);
  }
  __syncthreads();

  // z2 = s1 @ W2 + b2; m0 = silu(z2)
  {
    MmArgs m = mm_args(sm + L.Z2, sm + L.S, sm + L.w2, L.ld_m, 1, rows, s.h, s.m, ldr);
    m.bias = sm + L.b2;
    m.silu_out = sm + L.M0;
    tile_mm(m);
  }
  __syncthreads();

  // the soft gate, one thread a row, the sum over m in order
  if (s.soft_edges) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float zg = sm[L.misc + 0];
      for (int j = 0; j < s.m; ++j) zg = fmaf(sm[L.M0 + j * ldr + r], sm[L.gw + j], zg);
      const float gate = sigmoid_f(zg);
      row[GATE * ldr + r] = gate;
      for (int j = 0; j < s.m; ++j) sm[L.MSG + j * ldr + r] = sm[L.M0 + j * ldr + r] * gate;
    }
    __syncthreads();
  }

  // cz1 = cmsg @ cW1 + cb1
  const float* cmsg = sm + (s.gate_feats_only ? L.M0 : L.MSG);
  {
    MmArgs m = mm_args(sm + L.CZ1, cmsg, sm + L.cw1, L.ld_m4, 1, rows, s.m, s.m4, ldr);
    m.bias = sm + L.cb1;
    tile_mm(m);
  }
  __syncthreads();

  // wz = silu(cz1) @ cW2 + cb2; w = clip(wz * pv); one warp a row
  for (int r = warp; r < rows; r += nwarps) {
    float acc = 0.f;
    for (int q = lane; q < s.m4; q += 32)
      acc = fmaf(silu_f(sm[L.CZ1 + q * ldr + r]), sm[L.cw2 + q], acc);
    const float wz = warp_sum(acc) + sm[L.misc + 1];
    if (lane == 0) {
      const float wm = wz * row[PV * ldr + r];
      row[WZ * ldr + r] = wz;
      row[WCL * ldr + r] = s.has_clamp ? fminf(fmaxf(wm, -s.clamp), s.clamp) : wm;
    }
  }
  __syncthreads();
}

template <bool kGather>
__global__ void __launch_bounds__(kFwdThreads, 2)
pair_fwd_kernel(const Shape s, const Tensors t) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout L = make_layout(s, false);
  const int ldr = L.ldr;
  const float* row = sm + L.ROW;
  stage_weights(s, t, L, sm);
  __syncthreads();
  const int tiles_per_b = (s.n + s.ti - 1) / s.ti;
  for (int tile = blockIdx.x; tile < s.b * tiles_per_b; tile += gridDim.x) {
    const int ib = tile / tiles_per_b, i0 = (tile - ib * tiles_per_b) * s.ti;
    const int tn = min(s.ti, s.n - i0), rows = tn * s.k;
    tile_forward<kGather>(s, t, L, sm, ib, i0, rows);
    const size_t node0 = (size_t)ib * s.n + i0;
    const float scale = sm[L.misc + 2];
    // m_i[i] = sum_t msg * pv, coors_delta[i] = sum_t w * rel_n, in slot order
    for (int e = threadIdx.x; e < tn * (s.m + s.c); e += blockDim.x) {
      const int i = e / (s.m + s.c), j = e - i * (s.m + s.c);
      float acc = 0.f;
      if (j < s.m) {
        for (int q = 0; q < s.k; ++q) {
          const int r = i * s.k + q;
          acc = fmaf(sm[L.MSG + j * ldr + r], row[PV * ldr + r], acc);
        }
        t.m_i[(node0 + i) * s.m + j] = acc;
      } else {
        const int cc = j - s.m;
        for (int q = 0; q < s.k; ++q) {
          const int r = i * s.k + q;
          float rel_n = sm[L.REL + cc * ldr + r];
          if (s.norm_coors) rel_n = rel_n / row[NRM * ldr + r] * scale;
          acc = fmaf(row[WCL * ldr + r], rel_n, acc);
        }
        t.cd[(node0 + i) * s.c + cc] = acc;
      }
    }
    __syncthreads();  // the next tile rewrites the buffers
  }
}

template <bool kGather>
__global__ void __launch_bounds__(kBwdThreads, 1)
pair_bwd_kernel(const Shape s, const Tensors t) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout L = make_layout(s, true);
  const GradLayout G = grad_layout(s);
  const int dd = 2 * s.fourier + 1;
  const int ldr = L.ldr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* row = sm + L.ROW;
  float* acc = sm + L.ACC;
  stage_weights(s, t, L, sm);
  for (int e = threadIdx.x; e < G.total; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();
  const float scale = sm[L.misc + 2];
  const float eps2 = s.eps * s.eps;
  const int tiles_per_b = (s.n + s.ti - 1) / s.ti;
  for (int tile = blockIdx.x; tile < s.b * tiles_per_b; tile += gridDim.x) {
    const int ib = tile / tiles_per_b, i0 = (tile - ib * tiles_per_b) * s.ti;
    const int tn = min(s.ti, s.n - i0), rows = tn * s.k;
    const size_t node0 = (size_t)ib * s.n + i0;
    const size_t p0 = node0 * s.k;
    tile_forward<kGather>(s, t, L, sm, ib, i0, rows);

    // ---- aggregation, clamp and CoorsNorm backward, one thread a row ----
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* gc = t.g_cd + (node0 + r / s.k) * s.c;
      const float pv = row[PV * ldr + r], nrm = row[NRM * ldr + r], w = row[WCL * ldr + r];
      const float wm = row[WZ * ldr + r] * pv;
      float d_w = 0.f, dot = 0.f;  // dot = sum_c d_rel_n * rel
      for (int cc = 0; cc < s.c; ++cc) {
        const float rel = sm[L.REL + cc * ldr + r];
        const float rel_n = s.norm_coors ? rel / nrm * scale : rel;
        const float d_rel_n = w * gc[cc];
        d_w = fmaf(gc[cc], rel_n, d_w);
        dot = fmaf(d_rel_n, rel, dot);
        sm[L.DREL + cc * ldr + r] = s.norm_coors ? d_rel_n * (scale / nrm) : d_rel_n;
      }
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
    __syncthreads();

    // ---- coordinate-weight MLP backward ----
    // d_cW2[q] = sum_r silu(cz1) * d_wz: one warp an entry, lanes over the rows
    for (int q = warp; q < s.m4; q += nwarps) {
      float part = 0.f;
      for (int r = lane; r < rows; r += 32)
        part = fmaf(silu_f(sm[L.CZ1 + q * ldr + r]), row[DWZ * ldr + r], part);
      part = warp_sum(part);
      if (lane == 0) acc[G.cw2 + q] += part;
    }
    tile_wgrad(acc + G.cb2, nullptr, row + DWZ * ldr, rows, 1, 1, ldr);
    if (s.norm_coors) tile_wgrad(acc + G.scale, nullptr, row + DSC * ldr, rows, 1, 1, ldr);
    __syncthreads();
    for (int q = warp; q < s.m4; q += nwarps) {
      for (int r = lane; r < rows; r += 32) {
        float* cz = sm + L.CZ1 + q * ldr + r;
        *cz = row[DWZ * ldr + r] * sm[L.cw2 + q] * dsilu_f(*cz);  // d_cz1
      }
    }
    __syncthreads();
    const float* cmsg = sm + (s.gate_feats_only ? L.M0 : L.MSG);
    tile_mm(mm_args(sm + L.DM, sm + L.CZ1, sm + L.cw1, 1, L.ld_m4, rows, s.m4, s.m,
                    ldr));  // d_cmsg = d_cz1 @ cW1^T
    tile_wgrad(acc + G.cw1, cmsg, sm + L.CZ1, rows, s.m, s.m4, ldr);
    tile_wgrad(acc + G.cb1, nullptr, sm + L.CZ1, rows, 1, s.m4, ldr);
    __syncthreads();

    // ---- messages, soft gate and silu backward, one thread a row: DM <- d_z2 ----
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* gm = t.g_mi + (node0 + r / s.k) * s.m;
      const float pv = row[PV * ldr + r];
      float gate = 1.f, d_zg = 0.f;
      if (s.soft_edges) {
        gate = row[GATE * ldr + r];
        float d_g = 0.f;
        for (int j = 0; j < s.m; ++j) {
          const float d_msg = fmaf(gm[j], pv, s.gate_feats_only ? 0.f : sm[L.DM + j * ldr + r]);
          d_g = fmaf(d_msg, sm[L.M0 + j * ldr + r], d_g);
        }
        d_zg = d_g * gate * (1.f - gate);
      }
      row[DZG * ldr + r] = d_zg;
      for (int j = 0; j < s.m; ++j) {
        const float d_cmsg = sm[L.DM + j * ldr + r];
        const float d_msg = fmaf(gm[j], pv, s.gate_feats_only ? 0.f : d_cmsg);
        float d_m0 = s.soft_edges ? fmaf(d_zg, sm[L.gw + j], d_msg * gate) : d_msg;
        if (s.gate_feats_only) d_m0 += d_cmsg;  // the ungated coordinate branch
        sm[L.DM + j * ldr + r] = d_m0 * dsilu_f(sm[L.Z2 + j * ldr + r]);
      }
    }
    __syncthreads();
    if (s.soft_edges) {
      tile_wgrad(acc + G.gw, sm + L.M0, row + DZG * ldr, rows, s.m, 1, ldr);
      tile_wgrad(acc + G.gb, nullptr, row + DZG * ldr, rows, 1, 1, ldr);
    }

    // ---- edge MLP backward: S <- d_h1 ----
    tile_wgrad(acc + G.w2, sm + L.S, sm + L.DM, rows, s.h, s.m, ldr);
    tile_wgrad(acc + G.b2, nullptr, sm + L.DM, rows, 1, s.m, ldr);
    __syncthreads();
    {
      // d_h1 = (d_z2 @ W2^T) * dsilu(h1)
      MmArgs m = mm_args(sm + L.S, sm + L.DM, sm + L.w2, 1, L.ld_m, rows, s.m, s.h, ldr);
      m.dsilu_of = sm + L.H;
      tile_mm(m);
    }
    __syncthreads();

    // d_distf = d_h1 @ Wd^T; d[Wj; Wd] = [fj | distf]^T d_h1; the j-side rows
    tile_mm(mm_args(sm + L.DDF, sm + L.S, sm + L.wd, 1, L.ld_h, rows, s.h, dd, ldr));
    if (!kGather) {
      tile_wgrad(acc + G.wj, sm + L.X, sm + L.S, rows, s.d + dd, s.h, ldr);
      MmArgs m = mm_args(t.d_fj + p0 * s.d, sm + L.S, sm + L.wj, 1, L.ld_h, rows, s.h, s.d, ldr);
      m.row_major_ld = s.d;  // d_fj = d_h1 @ Wj^T, row-major into device memory
      tile_mm(m);
    } else {
      tile_wgrad(acc + G.wd, sm + L.DISTF, sm + L.S, rows, dd, s.h, ldr);
      const int pw = s.c + s.h;
      for (int e = threadIdx.x; e < rows * s.h; e += blockDim.x) {
        const int r = e / s.h, j = e - r * s.h;
        t.d_pairs[(p0 + r) * pw + s.c + j] = sm[L.S + j * ldr + r];
      }
    }
    for (int e = threadIdx.x; e < tn * s.h; e += blockDim.x) {
      const int i = e / s.h, j = e - i * s.h;
      float sum = 0.f;
      for (int q = 0; q < s.k; ++q) sum += sm[L.S + j * ldr + i * s.k + q];
      t.d_pi[(node0 + i) * s.h + j] = sum;
    }
    __syncthreads();

    // ---- distance backward, one thread a row ----
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float dist = row[DIST * ldr + r];
      const float* ddf = sm + L.DDF + r;
      float d_dist = row[DDIST * ldr + r] + ddf[(dd - 1) * ldr];
      for (int f = 0; f < s.fourier; ++f) {
        const float xs = ldexpf(dist, -f);
        d_dist += ldexpf(ddf[f * ldr] * cosf(xs) - ddf[(s.fourier + f) * ldr] * sinf(xs), -f);
      }
      for (int cc = 0; cc < s.c; ++cc) {
        const float d_rel = fmaf(2.f * sm[L.REL + cc * ldr + r], d_dist,
                                 sm[L.DREL + cc * ldr + r]);
        sm[L.DREL + cc * ldr + r] = d_rel;
        if (kGather) t.d_pairs[(p0 + r) * (s.c + s.h) + cc] = -d_rel;
        else t.d_cj[(p0 + r) * s.c + cc] = -d_rel;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tn * s.c; e += blockDim.x) {
      const int i = e / s.c, cc = e - i * s.c;
      float sum = 0.f;
      for (int q = 0; q < s.k; ++q) sum += sm[L.DREL + cc * ldr + i * s.k + q];
      t.d_ci[(node0 + i) * s.c + cc] = sum;
    }
    __syncthreads();  // the next tile rewrites the buffers
  }
  float* mine = t.partial + (size_t)blockIdx.x * G.total;
  for (int e = threadIdx.x; e < G.total; e += blockDim.x) mine[e] = acc[e];
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
  if (gather ? s.d != 0 : s.d < 1) return false;
  if (s.rows < 8 || s.rows > kMaxRows || s.rows % 8 || s.ti < 1 || s.ti * s.k > s.rows)
    return false;
  return (size_t)make_layout(s, backward).total * sizeof(float) <= (size_t)kMaxSmemBytes;
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const Shape& s, const Tensors& t, bool backward, int grid,
                  cudaStream_t stream) {
  const size_t bytes = (size_t)make_layout(s, backward).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, backward ? kBwdThreads : kFwdThreads, bytes, stream>>>(s, t);
  return (int)cudaGetLastError();
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
  int err;
  if (!backward) {
    err = gather ? launch_kernel(pair_fwd_kernel<true>, *s, *t, false, grid, stream)
                 : launch_kernel(pair_fwd_kernel<false>, *s, *t, false, grid, stream);
    return err;
  }
  err = gather ? launch_kernel(pair_bwd_kernel<true>, *s, *t, true, grid, stream)
               : launch_kernel(pair_bwd_kernel<false>, *s, *t, true, grid, stream);
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

}  // extern "C"
