// kNN selection at any n for Hopper (sm_90a): the exact j-tiled selection,
// the packed-key candidates, and the exact selection of a subset of query
// rows against all points or against a window of them. Plain C interface,
// loaded with ctypes (egnn_tpu_torch/ops/cuda/build.py,
// egnn_tpu_torch/ops/cuda/knn.py).
//
// Replaces the TPU kernels
//   K4 egnn_tpu/ops/pallas/knn.py:knn_select_pallas_tiled (_knn_tiled_kernel)
//   K5 egnn_tpu/ops/pallas/knn.py:knn_candidates_packed_tiled
//      (_knn_packed_tiled_kernel): 20-bit keys, masked pairs at 0x7F800
//   K6 egnn_tpu/ops/pallas/knn.py:knn_candidates_packed
//      (_knn_packed_kernel):       18-bit keys, masked pairs at 0x1FF00
//   K8 egnn_tpu/ops/pallas/knn.py:knn_select_queries_pallas
//      (_knn_query_kernel): K4's ranking of R query rows, given apart from
//      the points with their own mask bits, without an adjacency
//   K9 egnn_tpu/ops/pallas/knn.py:knn_select_window_pallas
//      (_knn_window_kernel): K8 over the columns [start, start + W) of the
//      points sorted by x, one start for each group of rows, ordered and
//      reported by the columns' original ids; every query row counts as
//      unmasked
// For every row i and column j, with d = x_i - x_j,
//   r_ij = ((0 + d_0^2) + d_1^2) + ...                       (f32, no FMA)
// K4 ranks by r with the fills of K1 and K3 (csrc/knn_select.cu):
//   r_ij = 1e5 where !(mask_i && mask_j), then with an adjacency
//   r_ij = -1 where j == i and r_ij = 0 where adj_ij && j != i,
// and keeps the k smallest in (r, j) order as vals (f32) and idx.
// K5 and K6 rank by a coarsened key and take no adjacency:
//   key_ij = bits(r_ij) >> kShift   (12 or 14; the bit pattern of a
//                                    non-negative float is monotonic)
//   key_ij = sentinel               where !(mask_i && mask_j)
// and keep the kc smallest in (key, j) order as keys (i32) and cols. Their
// caller re-ranks the candidates exactly and certifies that they cover the
// true top-k (ops/neighbors.py).
//
// What is not carried over. The TPU kernels walk j-tiles as a sequential
// grid axis, park each tile's top-k in an (nj, ti, k) VMEM scratch and merge
// once at the end; K5 and K6 pack a tile-local column beside the key into
// one int32, so that a row minimum is one vector reduction, and restore the
// global order by (tile, slot). Those tile widths and bit budgets (12 + 20,
// 14 + 18, 6 + 5 merge bits) are the vector unit's needs. The order they
// produce is the lexicographic order on (key, global column), which this
// kernel computes directly on one 64-bit integer (key << 32) | j; only the
// key widths are kept, because the keys are part of the result. K4's key is
// the f32 ranking mapped to an order-preserving unsigned integer, so all
// three are one template. K8 is K4's instantiation itself, given the query
// rows where K4 gives the points again. K9's lane-aligned window starts in
// units of 128, its lane padding and the window-wide plane of ids are the
// vector unit's too: here a block's window is a loop range, clipped to the
// real columns, and the low word of the packed value is the column's
// original id in place of j.
//
// Design. One warp per query row; a block of 8 warps shares a tile of
// coordinates (and mask bits) staged in shared memory; the j-tile grid axis
// is the loop over those tiles. The warp keeps one ascending list of its k
// best packed values in registers (warp_topk.cuh). Each lane ranks the
// column tile + lane and offers its value. A row inserts about
// k * ln(n / k) times in all. A list per lane, as K1 and K3 keep at their small n, inserts some 32
// times as often, and at n = 65536 nearly every step has one lane inserting
// while 31 wait: measured on the H100 at n = 65536, kc = 20, 40.2 ms with
// per-lane lists (and a predicated kMaxC-step pair loop) against 6.5 ms.
//
// Bound on the H100: at n = 65536, c = 3 without an adjacency the function
// moves under 20 MB (0.005 ms at 3.35 TB/s) and does n^2 * (3c + 3) = 5.2e10
// f32 operations (0.77 ms at 67 TFLOP/s): bound by operations. With a
// 32768^2 adjacency its 1 GiB of bytes (0.32 ms) is the larger bound. So the
// pair loop is kept short (c = 3 is its own instantiation, without the
// predicated kMaxC-step loop) and a lane's adjacency bytes of a tile are
// loaded together ahead of the loop. Each lane still ranks one pair a step
// and re-reads the coordinate tile from shared memory for every row; nothing
// is held across rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using warp_topk::kEmpty;

constexpr int kTile = 512;   // columns staged per shared-memory tile
constexpr int kWarps = 8;    // query rows per block
constexpr int kMaxC = 16;    // largest coordinate dimension handled
constexpr int kMaxK = 128;   // longest list: 4 slots a lane

// kShift == 0: K4, K8, K9 (exact ranking, fills, adjacency); 12: K5; 14: K6.
// kSlots: list entries a lane holds, ceil(k / 32).
// kC: the coordinate dimension when it is 3, else 0: any c <= kMaxC through
// a predicated loop, which issues all kMaxC steps for every pair.
// kWindow (K9): a block's rows rank the columns [win_start, win_start +
// win_width) only, clipped to n, and a column goes by col_ids[j].
template <int kShift, int kSlots, int kC, bool kWindow>
__global__ void __launch_bounds__(kWarps * 32) knn_select_large_kernel(
    const float* __restrict__ queries,       // (b, nq, c): the rows (K4-K6: coors)
    const unsigned char* __restrict__ qmask, // (b, nq) the rows' mask bits; null: all set
    const float* __restrict__ coors,         // (b, n, c): the columns
    const unsigned char* __restrict__ mask,  // (b, n) or null: no pair is masked
    const unsigned char* __restrict__ adj,   // rows of n bytes, or null (K4 only)
    long long adj_bstride,                   // 0 when one (n, n) is shared
    const int* __restrict__ win_start,       // (b, ceil(nq / win_rows)), K9 only
    const int* __restrict__ col_ids,         // (b, n), K9 only
    int win_rows, int win_width,             // rows that share a window; its width
    int nq, int n, int c, int k, unsigned sentinel,
    unsigned* __restrict__ out_hi,           // (b, nq, k): vals f32 bits, or keys
    long long* __restrict__ out_idx) {       // (b, nq, k)
  extern __shared__ float smem[];
  float* tile_x = smem;               // kTile * c
  float* tile_m = smem + kTile * c;   // kTile
  int* tile_id = reinterpret_cast<int*>(tile_m + kTile);  // kTile, K9 only
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * kWarps + warp;
  const bool row_ok = i < nq;

  const float* cb = coors + (size_t)b * n * c;
  const float* qb = queries + (size_t)b * nq * c;
  constexpr int kDims = kC > 0 ? kC : kMaxC;
  float xi[kDims];
#pragma unroll
  for (int cc = 0; cc < kDims; ++cc) xi[cc] = (row_ok && cc < c) ? qb[(size_t)i * c + cc] : 0.f;
  const bool has_mask = mask != nullptr;
  const bool has_adj = kShift == 0 && !kWindow && adj != nullptr;
  const bool mask_i =
      has_mask && row_ok && (qmask == nullptr || qmask[(size_t)b * nq + i] != 0);
  const unsigned char* adj_row =
      has_adj && row_ok ? adj + (size_t)b * adj_bstride + (size_t)i * n : nullptr;

  warp_topk::List<kSlots> list;
  list.init(k, lane);
  const int stride = kC > 0 ? kC : c;  // floats a staged column takes

  int j_begin = 0, j_end = n;
  if (kWindow) {  // win_rows is a multiple of kWarps: one window a block
    const int groups = (nq + win_rows - 1) / win_rows;
    j_begin = win_start[(size_t)b * groups + (blockIdx.x * kWarps) / win_rows];
    j_end = min(j_begin + win_width, n);
  }

  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    __syncthreads();
    const int span = min(kTile, j_end - j0);
    for (int t = threadIdx.x; t < span * c; t += blockDim.x)
      tile_x[t] = cb[(size_t)j0 * c + t];
    if (has_mask)
      for (int t = threadIdx.x; t < span; t += blockDim.x)
        tile_m[t] = mask[(size_t)b * n + j0 + t] != 0 ? 1.f : 0.f;
    if (kWindow)
      for (int t = threadIdx.x; t < span; t += blockDim.x)
        tile_id[t] = col_ids[(size_t)b * n + j0 + t];
    __syncthreads();
    if (!row_ok) continue;
    // this lane's adjacency bytes of the tile, one bit a step, all loaded
    // up front so that their latencies overlap
    unsigned adj_bits = 0;
    if (has_adj) {
#pragma unroll
      for (int step = 0; step < kTile / 32; ++step) {
        const int t = step * 32 + lane;
        if (t < span && adj_row[j0 + t] != 0) adj_bits |= 1u << step;
      }
    }
    for (int t0 = 0; t0 < span; t0 += 32) {  // the whole warp takes every step
      const int t = t0 + lane;
      const int j = j0 + t;
      unsigned long long p = kEmpty;
      if (t < span) {
        float r = 0.f;
#pragma unroll
        for (int cc = 0; cc < kDims; ++cc) {
          if (kC > 0 || cc < c) {
            const float d = __fsub_rn(xi[cc], tile_x[t * stride + cc]);
            r = __fadd_rn(r, __fmul_rn(d, d));
          }
        }
        const bool masked = has_mask && !(mask_i && tile_m[t] != 0.f);
        unsigned hi;
        if (kShift == 0) {
          if (masked) r = 1e5f;
          if (has_adj) {
            if (j == i) r = -1.f;
            else if ((adj_bits >> (t0 >> 5)) & 1u) r = 0.f;
          }
          hi = warp_topk::ordered_bits(r);
        } else {
          hi = masked ? sentinel : (__float_as_uint(r) >> kShift);
        }
        const unsigned lo = kWindow ? (unsigned)tile_id[t] : (unsigned)j;
        p = ((unsigned long long)hi << 32) | (unsigned long long)lo;
      }
      list.offer(p);
    }
  }
  if (!row_ok) return;  // whole warp: no block barrier follows

  const size_t row = (size_t)b * nq + i;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = s * 32 + lane;
    if (e < k) {
      const unsigned hi = (unsigned)(list.entry[s] >> 32);
      out_hi[row * k + e] = kShift == 0 ? warp_topk::float_bits_of_ordered(hi) : hi;
      out_idx[row * k + e] = (long long)(list.entry[s] & 0xffffffffull);
    }
  }
}

// What a launch ranks: the rows (queries; null: the points themselves, with
// the points' mask) against the columns (coors), all of them or a window.
struct Problem {
  const float* queries;
  const unsigned char* qmask;
  const float* coors;
  const unsigned char* mask;
  const unsigned char* adj;
  long long adj_bstride;
  const int* win_start;
  const int* col_ids;
  int win_rows, win_width;
  int b, nq, n, c, k;
};

template <int kShift, bool kWindow>
int launch(const Problem& q, unsigned sentinel, void* out_hi, long long* out_idx,
           cudaStream_t stream) {
  // k <= the columns a row ranks: every list element ends as a real column
  // (a window clipped at n may hold fewer than win_width: the caller's care)
  if (q.b < 1 || q.nq < 1 || q.n < 1 || q.c < 1 || q.c > kMaxC || q.k < 1 || q.k > kMaxK ||
      q.k > (kWindow ? q.win_width : q.n))
    return (int)cudaErrorInvalidValue;
  if (kWindow && (q.win_rows < kWarps || q.win_rows % kWarps != 0 || q.win_start == nullptr ||
                  q.col_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTile * q.c + kTile) +
                      (kWindow ? sizeof(int) * kTile : 0);
  const dim3 grid((q.nq + kWarps - 1) / kWarps, q.b);
  unsigned* hi = static_cast<unsigned*>(out_hi);
#define LAUNCH_LARGE(SLOTS, C)                                                         \
  knn_select_large_kernel<kShift, SLOTS, C, kWindow><<<grid, kWarps * 32, smem, stream>>>( \
      q.queries, q.qmask, q.coors, q.mask, q.adj, q.adj_bstride, q.win_start, q.col_ids,   \
      q.win_rows, q.win_width, q.nq, q.n, q.c, q.k, sentinel, hi, out_idx)
  if (q.c == 3) {
    if (q.k <= 32) LAUNCH_LARGE(1, 3);
    else if (q.k <= 64) LAUNCH_LARGE(2, 3);
    else LAUNCH_LARGE(4, 3);
  } else {
    if (q.k <= 32) LAUNCH_LARGE(1, 0);
    else if (q.k <= 64) LAUNCH_LARGE(2, 0);
    else LAUNCH_LARGE(4, 0);
  }
#undef LAUNCH_LARGE
  return (int)cudaGetLastError();
}

// the points against themselves: K4, K5, K6
Problem self_problem(const void* coors, const void* mask, const void* adj,
                     long long adj_bstride, int b, int n, int c, int k) {
  const float* x = static_cast<const float*>(coors);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  return Problem{x, m, x, m, static_cast<const unsigned char*>(adj), adj_bstride,
                 nullptr, nullptr, 0, 0, b, n, n, c, k};
}

}  // namespace

extern "C" {

// K4: exact selection at any n; vals f32 and idx i64. mask and adj may be null.
int knn_select_tiled_launch(const void* coors, const void* mask, const void* adj,
                            long long adj_bstride, int b, int n, int c, int k,
                            void* vals, void* idx, void* stream) {
  return launch<0, false>(self_problem(coors, mask, adj, adj_bstride, b, n, c, k), 0u, vals,
                          static_cast<long long*>(idx), static_cast<cudaStream_t>(stream));
}

// K5: 20-bit keys (f32 bits >> 12), masked pairs keyed 0x7F800. mask may be null.
int knn_candidates_packed_tiled_launch(const void* coors, const void* mask, int b, int n,
                                       int c, int kc, void* keys, void* cols,
                                       void* stream) {
  return launch<12, false>(self_problem(coors, mask, nullptr, 0, b, n, c, kc), 0x7F800u, keys,
                           static_cast<long long*>(cols), static_cast<cudaStream_t>(stream));
}

// K6: 18-bit keys (f32 bits >> 14), masked pairs keyed 0x1FF00. mask may be null.
int knn_candidates_packed_launch(const void* coors, const void* mask, int b, int n, int c,
                                 int kc, void* keys, void* cols, void* stream) {
  return launch<14, false>(self_problem(coors, mask, nullptr, 0, b, n, c, kc), 0x1FF00u, keys,
                           static_cast<long long*>(cols), static_cast<cudaStream_t>(stream));
}

// K8: r query rows (b, r, c) against the n points; vals f32 and idx i64,
// (b, r, k). qmask (b, r) and pmask (b, n) are both given or both null.
int knn_select_queries_launch(const void* queries, const void* qmask, const void* points,
                              const void* pmask, int b, int r, int n, int c, int k,
                              void* vals, void* idx, void* stream) {
  if ((qmask == nullptr) != (pmask == nullptr)) return (int)cudaErrorInvalidValue;
  const Problem q{static_cast<const float*>(queries),
                  static_cast<const unsigned char*>(qmask),
                  static_cast<const float*>(points),
                  static_cast<const unsigned char*>(pmask),
                  nullptr, 0, nullptr, nullptr, 0, 0, b, r, n, c, k};
  return launch<0, false>(q, 0u, vals, static_cast<long long*>(idx),
                          static_cast<cudaStream_t>(stream));
}

// K9: r query rows, all unmasked, against the columns [start, start + width)
// of the sorted points, clipped to n; starts (b, ceil(r / rows)) holds one
// start for each group of `rows` consecutive query rows (a multiple of 8);
// ids (b, n) are the columns' original ids, by which ties are ordered and
// columns reported. pmask (b, n) may be null.
int knn_select_window_launch(const void* queries, const void* points, const void* pmask,
                             const void* ids, const void* starts, int rows, int width, int b,
                             int r, int n, int c, int k, void* vals, void* idx,
                             void* stream) {
  const Problem q{static_cast<const float*>(queries), nullptr,
                  static_cast<const float*>(points),
                  static_cast<const unsigned char*>(pmask),
                  nullptr, 0, static_cast<const int*>(starts), static_cast<const int*>(ids),
                  rows, width, b, r, n, c, k};
  return launch<0, true>(q, 0u, vals, static_cast<long long*>(idx),
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
