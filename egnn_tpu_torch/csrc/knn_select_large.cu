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
//      the points with their own mask bits, without an adjacency (K4's
//      kernel, kQuery)
//   K9 egnn_tpu/ops/pallas/knn.py:knn_select_window_pallas
//      (_knn_window_kernel): K8 over the columns [start, start + W) of the
//      points sorted by x, one start for each group of rows, ordered and
//      reported by the columns' original ids; every query row counts as
//      unmasked
// For every row i and column j, with d = x_i - x_j,
//   r_ij = (d_0^2 + d_1^2) + ...                             (f32, no FMA)
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
// produce is the lexicographic order on (key, global column), which these
// kernels compute directly on one 64-bit integer (key << 32) | j; only the
// key widths are kept, because the keys are part of the result. K4's key is
// the f32 ranking mapped to an order-preserving unsigned integer. K8 is
// K4's ranking given the query rows where K4 gives the points again. K9's
// lane-aligned window starts in units of 128, its lane padding and the
// window-wide plane of ids are the vector unit's too: here a block's window
// is a loop range, clipped to the real columns, and the low word of the
// packed value is the column's original id in place of j.
//
// Every warp keeps, for each of its rows, one ascending list of the k best
// packed values in registers (warp_topk.cuh). A row inserts about
// k * ln(n / k) times in all. A list per lane, as K1 and K3 keep at their
// small n, inserts some 32 times as often: measured on the H100 at
// n = 65536, kc = 20, 40.2 ms with per-lane lists against 6.5 ms.
//
// Bound on the H100: at n = 65536, c = 3 without an adjacency the function
// moves under 20 MB (0.005 ms at 3.35 TB/s) and does n^2 * (3c + 3) = 5.2e10
// f32 operations (0.77 ms at 67 TFLOP/s, which counts an FMA as two): bound
// by operations. The distance may not contract into FMAs (bitwise equality
// with the plain version), so it issues 3c - 1 = 8 f32 instructions a pair,
// and the key and the compare with the row's k-th value some 3 more: the
// floor of this arithmetic is about twice the written bound. With a
// 32768^2 adjacency its 1 GiB of bytes (0.32 ms) is the larger bound.
//
// Design of K4, K5, K6 (knn_select_block_kernel). The first version (one
// row a warp, kept for K9) ranked one pair a lane a step and paid for
// each pair three shared loads, the mask and fills, a 64-bit pack and a
// warp ballot against tau (some 25 instructions for 8 of distance),
// re-staged all columns for every 8 rows and exposed each tile's load. Now:
//  - kRows rows a warp (rows_a_warp: 4 at k <= 32, 2 with an adjacency or
//    at k <= 64, 1 beyond and at c != 3; fewer where the grid would not
//    fill the card), each with its list and tau in registers. A staged
//    column is loaded once and ranked against all of the warp's rows, and
//    a block stages each tile for 8 * kRows rows.
//  - kRun = 4 consecutive columns a lane a step. The tile is staged as c
//    planes (x of every column, then y, ...), so a lane's four columns of a
//    plane are one 16-byte shared load and the 32 lanes read 512
//    consecutive bytes: no bank conflict. The mask bytes and each row's
//    adjacency bytes of the four columns are one 4-byte global load, issued
//    a step ahead of their use.
//  - One vote a step, on a pre-test that costs one compare a pair: each row
//    keeps a float threshold, the largest distance that its k-th packed
//    value lets in, and a column threshold for its masked pairs, whose key
//    is one constant (row_thresholds). A pair below tau always passes
//    (ties of the key pass too, and the exact test follows); a row's self
//    and adjacent columns, which the fills -1 and 0 rank first, always
//    pass; a masked row tests its columns only. The warp takes the
//    insertion path only when a lane's pair passed, and then, row by row,
//    the flagged lanes offer their exact packed values; any order of offers
//    ends in the same list, since packed values are distinct. A row still
//    inserts about k (1 + ln(n / k)) times: at 4 rows and kc = 20 some 40%
//    of the warp steps of n = 65536 columns vote (by the rate 4 k 128 / m).
//  - Tiles of 2048 columns at c = 3 (512 otherwise): the next tile's
//    coordinates are copied into the second of two shared buffers (4-byte
//    cp.async, any n and alignment) while the current tile is ranked, one
//    barrier a tile. Past the last column the planes hold +inf, which no
//    distance pre-test lets in.
//  - Four blocks an SM at c = 3 (at most 64 registers a thread; 32 warps):
//    on the H100 K5 and K4 ran slower at two. Of the instantiations that
//    run, only K4's at two slots and two rows with a mask and an adjacency
//    spills, 16 bytes (ptxas, PERF.md §6). Any other c keeps two (its
//    predicated loop holds 16 coordinates a row).
//  - Rows past n get thresholds that nothing passes: they take part in
//    every vote and barrier but never insert.
// K8 is an instantiation of the same kernel (kQuery): its rows are the
// query rows, its row mask qmask, and it has no adjacency. Its rows are
// few (2820 on path C's Gaussian cloud), so rows_a_warp's halving gives
// them one row a warp (353 blocks), which on the H100 beat two and four
// rows a warp there (PERF.md §6). Where even one row
// a warp leaves fewer than two blocks an SM (stripes_a_row: R under 2112 on
// 132 SMs; the 1401 rows that K9 leaves on path C's heavy cloud), `stripes`
// warps share a row: warp s of the group takes the steps
// s, s + stripes, ... of every tile into lists of its own, and at the end
// the group's first warp merges the others' lists, parked in shared memory,
// into its own (warp_topk.cuh, merge_list): the union's top k is one,
// whatever the split. Each stripe fills a list of its own, so a split
// inserts more in all: at R = 2820 two stripes were slower than one, at
// 1401 rows two were 4% faster on the H100 (PERF.md §6).
// K9 (knn_select_rows_kernel) keeps one row a warp and one column a lane a
// step (the first version's loop).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using warp_topk::kEmpty;
using warp_topk::kFull;

constexpr int kTile = 512;   // columns staged per shared-memory tile
constexpr int kWarps = 8;    // warps a block
constexpr int kMaxC = 16;    // largest coordinate dimension handled
constexpr int kMaxK = 128;   // longest list: 4 slots a lane
// K4-K6: columns a tile, 2048 at c = 3 (48 KB in two buffers), else 512
template <int kC>
__host__ __device__ constexpr int block_tile() { return kC == 3 ? 2048 : 512; }
constexpr int kRun = 4;          // K4-K6: consecutive columns a lane ranks a step
constexpr int kStep = 32 * kRun;

// ---------------------------------------------------------------------------
// K4, K5, K6: the points against themselves, kRows rows a warp
// ---------------------------------------------------------------------------

// The 4 bytes p[0..3], of which `avail` exist (0 past the end), as one word:
// one load where the caller knows them 4-byte aligned.
__device__ __forceinline__ unsigned load_bytes4(const unsigned char* p, int avail,
                                                bool aligned) {
  if (aligned && avail >= 4) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < avail) w |= (unsigned)__ldg(p + q) << (8 * q);
  return w;
}

// Columns [j0, j0 + kBlockTile) of cb (clipped to n) into `planes` plane-major:
// planes[cc * kBlockTile + t] = cb[(j0 + t) * c + cc], as asynchronous copies.
// A partial tile's planes are +inf from its last column to the end of its
// last step, so that those columns fail every distance pre-test.
template <int kC>
__device__ __forceinline__ void stage_tile(const float* __restrict__ cb, int j0, int n, int c,
                                           float* planes) {
  constexpr int kBlockTile = block_tile<kC>();
  const int span = min(kBlockTile, n - j0);
  const int count = span * c;
  const float* src = cb + (size_t)j0 * c;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int t = kC > 0 ? e / kC : e / c;
    __pipeline_memcpy_async(planes + (e - t * c) * kBlockTile + t, src + e, sizeof(float));
  }
  __pipeline_commit();
  const int pad = (kStep - span % kStep) % kStep;
  for (int e = threadIdx.x; e < pad * c; e += blockDim.x) {
    const int cc = e / pad;
    planes[cc * kBlockTile + span + (e - cc * pad)] = __uint_as_float(0x7f800000u);
  }
}

// The pre-tests of a row whose k-th packed value is tau. A pair whose packed
// value is below tau has, unless it is masked, a distance v with
// !(v > thr) (thr NaN: every pair passes, the list is not full or tau is
// NaN); a masked pair, whose key is fill_key, exactly when its column is
// below mthr. K4's key is the order of v itself; K5's and K6's keep the
// bits of v above kShift, so thr is the largest float of tau's key.
template <int kShift>
__device__ __forceinline__ void row_thresholds(unsigned long long tau, unsigned fill_key,
                                               float& thr, unsigned& mthr) {
  const unsigned hi = (unsigned)(tau >> 32);
  if (kShift == 0)
    thr = __uint_as_float(warp_topk::float_bits_of_ordered(hi));
  else
    thr = __uint_as_float(hi > (0x7f7fffffu >> kShift) ? 0x7fffffffu
                                                         : (hi << kShift) | ((1u << kShift) - 1));
  mthr = hi > fill_key ? 0xffffffffu : hi == fill_key ? (unsigned)tau : 0u;
}

// kShift: 0 (K4: exact ranking, fills, adjacency), 12 (K5), 14 (K6).
// kSlots: list entries a lane holds, ceil(k / 32). kRows: rows a warp.
// kC: the coordinate dimension when it is 3, else 0: any c <= kMaxC through
// a predicated loop (one row a warp). kMask, kAdj: the mask (adjacency) is
// given; at kC == 0 they say it may be, and the pointer decides. kQuery
// (K8): the rows are the nq query rows with their mask qmask, ranked by
// `stripes` warps each (K4-K6: the n points, one warp each).
template <int kShift, int kSlots, int kRows, int kC, bool kMask, bool kAdj, bool kQuery = false>
__global__ void __launch_bounds__(kWarps * 32, kC == 3 ? 4 : 2) knn_select_block_kernel(
    const float* __restrict__ coors,         // (b, n, c)
    const unsigned char* __restrict__ mask,  // (b, n)
    const unsigned char* __restrict__ adj,   // rows of n bytes (K4 only)
    long long adj_bstride,                   // 0 when one (n, n) is shared
    bool aligned4,                           // mask and adjacency rows 4-byte aligned
    int n, int c, int k, unsigned sentinel,
    const float* __restrict__ queries,       // (b, nq, c), K8 only
    const unsigned char* __restrict__ qmask, // (b, nq), K8 only: given with mask
    int nq, int stripes,                     // K8 only
    unsigned* __restrict__ out_hi,           // (b, nrows, k): vals f32 bits, or keys
    long long* __restrict__ out_idx) {       // (b, nrows, k)
  extern __shared__ __align__(16) float smem[];  // two tiles of c planes
  constexpr int kDims = kC > 0 ? kC : kMaxC;
  constexpr int kBlockTile = block_tile<kC>();
  const bool has_mask = kMask && (kC > 0 || mask != nullptr);
  const bool has_adj = kShift == 0 && kAdj && !kQuery && (kC > 0 || adj != nullptr);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  // K8: `stripes` warps a group of rows, warp `stripe` of it taking every
  // stripes-th step of a tile
  const int stripe = kQuery ? warp % stripes : 0;
  const int groups = kQuery ? kWarps / stripes : kWarps;
  const int stride = kQuery ? stripes * kStep : kStep;  // between a warp's steps
  const int nrows = kQuery ? nq : n;
  const int row0 = (blockIdx.x * groups + (kQuery ? warp / stripes : warp)) * kRows;
  const float* cb = coors + (size_t)b * n * c;
  const float* rb = kQuery ? queries + (size_t)b * nq * c : cb;  // the rows' coordinates
  const unsigned char* mb = has_mask ? mask + (size_t)b * n : nullptr;
  const unsigned char* rmb = has_mask ? (kQuery ? qmask + (size_t)b * nq : mb) : nullptr;

  float xi[kRows][kDims];
  bool mask_i[kRows];
  const unsigned char* adj_row[kRows];
  warp_topk::List<kSlots> list[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r;
    const bool ok = i < nrows;
#pragma unroll
    for (int cc = 0; cc < kDims; ++cc)
      xi[r][cc] = (ok && (kC > 0 || cc < c)) ? rb[(size_t)i * c + cc] : 0.f;
    mask_i[r] = has_mask && ok && rmb[i] != 0;
    adj_row[r] = has_adj && ok ? adj + (size_t)b * adj_bstride + (size_t)i * n : nullptr;
    list[r].init(k, lane);
  }

  // the pre-tests of each row, from its k-th value (row_thresholds)
  const unsigned fill_key = kShift == 0 ? warp_topk::ordered_bits(1e5f) : sentinel;
  float thr[kRows];
  unsigned mthr[kRows];
  int self_col[kRows];  // the row's own column; none for a row past n
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row_thresholds<kShift>(list[r].tau, fill_key, thr[r], mthr[r]);
    self_col[r] = row0 + r;
    if (row0 + r >= nrows) {  // a row past the last passes no pre-test and never inserts
      thr[r] = __uint_as_float(0xff800000u);  // -inf
      mthr[r] = 0u;
      self_col[r] = -2 * kRun;
    }
  }

  // the mask bytes and each row's adjacency bytes of the lane's columns,
  // loaded a step ahead of their use
  auto load_words = [&](int j, unsigned& mw, unsigned (&aw)[kRows]) {
    mw = has_mask ? load_bytes4(mb + j, n - j, aligned4) : 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      aw[r] = has_adj && adj_row[r] != nullptr ? load_bytes4(adj_row[r] + j, n - j, aligned4)
                                               : 0u;
  };
  unsigned mnext, anext[kRows];
  load_words(stripe * kStep + kRun * lane, mnext, anext);

  const int tile_floats = kBlockTile * c;  // one of the two buffers
  const int ntiles = (n + kBlockTile - 1) / kBlockTile;
  stage_tile<kC>(cb, 0, n, c, smem);
  for (int tile = 0; tile < ntiles; ++tile) {
    // this thread's copies of the tile have landed; after the barrier every
    // thread's have, and no warp still ranks the tile before, whose buffer
    // the next copies overwrite
    __pipeline_wait_prior(0);
    __syncthreads();
    if (tile + 1 < ntiles)
      stage_tile<kC>(cb, (tile + 1) * kBlockTile, n, c, smem + ((tile + 1) & 1) * tile_floats);
    const float* xt = smem + (tile & 1) * tile_floats;
    const int j0 = tile * kBlockTile;
    const int span = min(kBlockTile, n - j0);
#pragma unroll 2
    for (int t0 = stripe * kStep; t0 < span; t0 += stride) {  // the whole warp takes every step
      const int t = t0 + kRun * lane;             // the lane's first column of the step
      const int j = j0 + t;
      float xj[kDims][kRun];  // +inf past the last column (stage_tile)
#pragma unroll
      for (int cc = 0; cc < kDims; ++cc) {
        if (kC > 0 || cc < c) {
          const float4 v = *reinterpret_cast<const float4*>(xt + cc * kBlockTile + t);
          xj[cc][0] = v.x; xj[cc][1] = v.y; xj[cc][2] = v.z; xj[cc][3] = v.w;
        }
      }
      const unsigned mword = mnext;
      unsigned aword[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) aword[r] = anext[r];
      // the warp's next step's columns, across tiles too (stripes divides a
      // tile's steps)
      load_words(j + stride, mnext, anext);

      auto dist = [&](int r, int q) {
        float d = __fsub_rn(xi[r][0], xj[0][q]);
        float v = __fmul_rn(d, d);
#pragma unroll
        for (int cc = 1; cc < kDims; ++cc) {
          if (kC > 0 || cc < c) {
            d = __fsub_rn(xi[r][cc], xj[cc][q]);
            v = __fadd_rn(v, __fmul_rn(d, d));
          }
        }
        return v;
      };
      // the packed value of (row r, column j + q), all fills applied
      auto packed = [&](int r, int q) -> unsigned long long {
        float v = dist(r, q);
        const bool masked = has_mask && !(mask_i[r] && ((mword >> (8 * q)) & 0xffu) != 0);
        unsigned hi;
        if (kShift == 0) {
          if (masked) v = 1e5f;
          if (has_adj) {
            if (j + q == row0 + r) v = -1.f;
            else if (((aword[r] >> (8 * q)) & 0xffu) != 0) v = 0.f;
          }
          hi = warp_topk::ordered_bits(v);
        } else {
          hi = masked ? sentinel : (__float_as_uint(v) >> kShift);
        }
        return ((unsigned long long)hi << 32) | (unsigned)(j + q);
      };

      // bit r: a pair of row r may be below the row's tau. Unmasked pairs
      // test their distance against thr, masked ones (one key) their column
      // against mthr; a row's self and adjacent columns (fills -1 and 0)
      // always take the insertion path.
      unsigned flags = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        bool pass = false;
        if (!has_mask || mask_i[r]) {  // uniform
#pragma unroll
          for (int q = 0; q < kRun; ++q) {
            bool below = !(dist(r, q) > thr[r]);
            if (has_mask && ((mword >> (8 * q)) & 0xffu) == 0) below = (unsigned)(j + q) < mthr[r];
            pass = pass || below;
          }
        } else {
          pass = (unsigned)j < mthr[r];  // every pair of the row is masked
        }
        if (has_adj && (aword[r] != 0 || (unsigned)(self_col[r] - j) < (unsigned)kRun)) pass = true;
        flags |= (unsigned)pass << r;
      }
      if (__any_sync(kFull, flags != 0)) {
        const int avail = span - t;  // of the lane's kRun columns, those that exist
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (!__any_sync(kFull, (flags >> r) & 1u)) continue;  // uniform
#pragma unroll
          for (int q = 0; q < kRun; ++q)
            list[r].offer(((flags >> r) & 1u) && q < avail ? packed(r, q) : kEmpty);
          row_thresholds<kShift>(list[r].tau, fill_key, thr[r], mthr[r]);
        }
      }
    }
  }

  if (kQuery && stripes > 1) {  // the group's first warp takes the others' lists
    // every warp is past its last tile: the tiles' buffers hold the lists,
    // (warp, row, 32 * kSlots)
    unsigned long long* parked = reinterpret_cast<unsigned long long*>(smem);
    __syncthreads();
    if (stripe != 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          parked[((warp * kRows + r) * kSlots + s) * 32 + lane] = list[r].entry[s];
    }
    __syncthreads();
    if (stripe != 0) return;  // whole warp: no block barrier follows
    for (int o = 1; o < stripes; ++o) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        list[r].merge_list(parked + ((warp + o) * kRows + r) * kSlots * 32);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r;
    if (i >= nrows) continue;
    const size_t row = (size_t)b * nrows + i;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = s * 32 + lane;
      if (e < k) {
        const unsigned hi = (unsigned)(list[r].entry[s] >> 32);
        out_hi[row * k + e] = kShift == 0 ? warp_topk::float_bits_of_ordered(hi) : hi;
        out_idx[row * k + e] = (long long)(list[r].entry[s] & 0xffffffffull);
      }
    }
  }
}

// The blocks of knn_select_block_kernel for b * n rows at `rows` rows a
// warp and `stripes` warps a row.
long long block_count(int b, int n, int rows, int stripes) {
  const int per_block = kWarps / stripes * rows;
  return (long long)b * ((n + per_block - 1) / per_block);
}

// Rows a warp of knn_select_block_kernel: 4 at k <= 32 (one list slot a
// lane), 2 at k <= 64, 1 beyond, and 1 at c != 3; 2 at most with an
// adjacency, whose bytes are each row's own (no reuse across rows) and
// whose latency twice the warps hide better (K4 on path B's chain ran
// slower at 4 on the H100); halved while the grid would hold fewer than two
// blocks an SM. knn_select_block_plan and knn_select_queries_plan export it.
int rows_a_warp(int b, int n, int c, int k, bool adj, int sms, int stripes = 1) {
  int rows = c != 3 ? 1 : k <= 32 ? (adj ? 2 : 4) : k <= 64 ? 2 : 1;
  while (rows > 1 && block_count(b, n, rows, stripes) < 2LL * sms) rows /= 2;
  return rows;
}

// K8's warps a row: 1 while one row a warp gives two blocks an SM, else the
// fewest of 2, 4, 8 that do; 1 at c != 3.
int stripes_a_row(int b, int nq, int c, int sms) {
  int stripes = 1;
  while (c == 3 && stripes < kWarps && block_count(b, nq, 1, stripes) < 2LL * sms) stripes *= 2;
  return stripes;
}

struct SelfArgs {
  const float* coors;
  const unsigned char* mask;
  const unsigned char* adj;
  long long adj_bstride;
  int b, n, c, k;
  unsigned sentinel;
  unsigned* out_hi;
  long long* out_idx;
  const float* queries = nullptr;       // K8: the query rows and their mask
  const unsigned char* qmask = nullptr;
  int nq = 0, stripes = 1;
};

template <int kShift, int kSlots, int kRows, int kC, bool kMask, bool kAdj, bool kQuery>
int launch_block_kernel(const SelfArgs& a, cudaStream_t stream) {
  auto kernel = knn_select_block_kernel<kShift, kSlots, kRows, kC, kMask, kAdj, kQuery>;
  const size_t smem = 2 * sizeof(float) * block_tile<kC>() * a.c;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uintptr_t m = reinterpret_cast<uintptr_t>(a.mask), j = reinterpret_cast<uintptr_t>(a.adj);
  const bool aligned4 = a.n % 4 == 0 && m % 4 == 0 && j % 4 == 0 && a.adj_bstride % 4 == 0;
  const int nrows = kQuery ? a.nq : a.n;
  const int per_block = kWarps / a.stripes * kRows;
  const dim3 grid((nrows + per_block - 1) / per_block, a.b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a.coors, a.mask, a.adj, a.adj_bstride, aligned4,
                                              a.n, a.c, a.k, a.sentinel, a.queries, a.qmask,
                                              a.nq, a.stripes, a.out_hi, a.out_idx);
  return (int)cudaGetLastError();
}

// the instantiation for the given mask and adjacency
template <int kShift, int kSlots, int kRows, int kC, bool kQuery>
int launch_block_flags(const SelfArgs& a, cudaStream_t stream) {
  if constexpr (kC == 0) {
    return launch_block_kernel<kShift, kSlots, kRows, 0, true, kShift == 0 && !kQuery, kQuery>(
        a, stream);
  } else {
    const bool m = a.mask != nullptr;
    // rows_a_warp: 2 at most with an adjacency; K8 takes none
    if constexpr (kShift == 0 && kRows <= 2 && !kQuery) {
      if (a.adj != nullptr)
        return m ? launch_block_kernel<kShift, kSlots, kRows, kC, true, true, false>(a, stream)
                 : launch_block_kernel<kShift, kSlots, kRows, kC, false, true, false>(a, stream);
    } else {
      if (a.adj != nullptr) return (int)cudaErrorInvalidValue;
    }
    return m ? launch_block_kernel<kShift, kSlots, kRows, kC, true, false, kQuery>(a, stream)
             : launch_block_kernel<kShift, kSlots, kRows, kC, false, false, kQuery>(a, stream);
  }
}

// K4-K6 (kQuery false: the points against themselves) and K8 (the query
// rows against the points), at the plan of rows_a_warp and stripes_a_row.
template <int kShift, bool kQuery>
int launch_self(SelfArgs a, cudaStream_t stream) {
  const int nrows = kQuery ? a.nq : a.n;
  // k <= n: every list element ends as a real column
  if (a.b < 1 || a.n < 1 || nrows < 1 || a.c < 1 || a.c > kMaxC || a.k < 1 || a.k > kMaxK ||
      a.k > a.n)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (kQuery) a.stripes = stripes_a_row(a.b, nrows, a.c, sms);
  const int rows = rows_a_warp(a.b, nrows, a.c, a.k, a.adj != nullptr, sms, a.stripes);
  if (a.c != 3) {
    if (a.k <= 32) return launch_block_flags<kShift, 1, 1, 0, kQuery>(a, stream);
    if (a.k <= 64) return launch_block_flags<kShift, 2, 1, 0, kQuery>(a, stream);
    return launch_block_flags<kShift, 4, 1, 0, kQuery>(a, stream);
  }
  if (a.k <= 32) {
    if (rows == 4) return launch_block_flags<kShift, 1, 4, 3, kQuery>(a, stream);
    if (rows == 2) return launch_block_flags<kShift, 1, 2, 3, kQuery>(a, stream);
    return launch_block_flags<kShift, 1, 1, 3, kQuery>(a, stream);
  }
  if (a.k <= 64) {
    if (rows == 2) return launch_block_flags<kShift, 2, 2, 3, kQuery>(a, stream);
    return launch_block_flags<kShift, 2, 1, 3, kQuery>(a, stream);
  }
  return launch_block_flags<kShift, 4, 1, 3, kQuery>(a, stream);
}

// ---------------------------------------------------------------------------
// K9: query rows against a window of the points, one row a warp
// ---------------------------------------------------------------------------

// K4's exact ranking of the query rows, all unmasked, against a window of
// the points, the first version's loop. kSlots: list entries a lane holds,
// ceil(k / 32). kC: as above. A block's rows rank the columns
// [win_start, win_start + win_width) only, clipped to n, and a column goes
// by col_ids[j]. A block of 8 warps shares a tile of coordinates (and mask
// bits) staged in shared memory; each lane ranks the column tile + lane a
// step and offers its value to the warp's list.
template <int kSlots, int kC>
__global__ void __launch_bounds__(kWarps * 32) knn_select_rows_kernel(
    const float* __restrict__ queries,       // (b, nq, c): the rows
    const float* __restrict__ coors,         // (b, n, c): the columns
    const unsigned char* __restrict__ mask,  // (b, n) or null: no pair is masked
    const int* __restrict__ win_start,       // (b, ceil(nq / win_rows))
    const int* __restrict__ col_ids,         // (b, n)
    int win_rows, int win_width,             // rows that share a window; its width
    int nq, int n, int c, int k,
    unsigned* __restrict__ out_hi,           // (b, nq, k): vals f32 bits
    long long* __restrict__ out_idx) {       // (b, nq, k)
  extern __shared__ float smem[];
  float* tile_x = smem;               // kTile * c
  float* tile_m = smem + kTile * c;   // kTile
  int* tile_id = reinterpret_cast<int*>(tile_m + kTile);  // kTile
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
  const bool mask_i = has_mask && row_ok;

  warp_topk::List<kSlots> list;
  list.init(k, lane);
  const int stride = kC > 0 ? kC : c;  // floats a staged column takes

  // win_rows is a multiple of kWarps: one window a block
  const int groups = (nq + win_rows - 1) / win_rows;
  const int j_begin = win_start[(size_t)b * groups + (blockIdx.x * kWarps) / win_rows];
  const int j_end = min(j_begin + win_width, n);

  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    __syncthreads();
    const int span = min(kTile, j_end - j0);
    for (int t = threadIdx.x; t < span * c; t += blockDim.x)
      tile_x[t] = cb[(size_t)j0 * c + t];
    if (has_mask)
      for (int t = threadIdx.x; t < span; t += blockDim.x)
        tile_m[t] = mask[(size_t)b * n + j0 + t] != 0 ? 1.f : 0.f;
    for (int t = threadIdx.x; t < span; t += blockDim.x)
      tile_id[t] = col_ids[(size_t)b * n + j0 + t];
    __syncthreads();
    if (!row_ok) continue;
    for (int t0 = 0; t0 < span; t0 += 32) {  // the whole warp takes every step
      const int t = t0 + lane;
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
        if (has_mask && !(mask_i && tile_m[t] != 0.f)) r = 1e5f;
        const unsigned hi = warp_topk::ordered_bits(r);
        p = ((unsigned long long)hi << 32) | (unsigned long long)(unsigned)tile_id[t];
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
      out_hi[row * k + e] = warp_topk::float_bits_of_ordered((unsigned)(list.entry[s] >> 32));
      out_idx[row * k + e] = (long long)(list.entry[s] & 0xffffffffull);
    }
  }
}

// What a K9 launch ranks: the query rows against a window of the columns
// (coors).
struct Problem {
  const float* queries;
  const float* coors;
  const unsigned char* mask;
  const int* win_start;
  const int* col_ids;
  int win_rows, win_width;
  int b, nq, n, c, k;
};

int launch_rows(const Problem& q, void* out_hi, long long* out_idx, cudaStream_t stream) {
  // k <= the columns a row ranks: every list element ends as a real column
  // (a window clipped at n may hold fewer than win_width: the caller's care)
  if (q.b < 1 || q.nq < 1 || q.n < 1 || q.c < 1 || q.c > kMaxC || q.k < 1 || q.k > kMaxK ||
      q.k > q.win_width)
    return (int)cudaErrorInvalidValue;
  if (q.win_rows < kWarps || q.win_rows % kWarps != 0 || q.win_start == nullptr ||
      q.col_ids == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTile * q.c + kTile) + sizeof(int) * kTile;
  const dim3 grid((q.nq + kWarps - 1) / kWarps, q.b);
  unsigned* hi = static_cast<unsigned*>(out_hi);
#define LAUNCH_ROWS(SLOTS, C)                                                                \
  knn_select_rows_kernel<SLOTS, C><<<grid, kWarps * 32, smem, stream>>>(                      \
      q.queries, q.coors, q.mask, q.win_start, q.col_ids, q.win_rows, q.win_width, q.nq, q.n, \
      q.c, q.k, hi, out_idx)
  if (q.c == 3) {
    if (q.k <= 32) LAUNCH_ROWS(1, 3);
    else if (q.k <= 64) LAUNCH_ROWS(2, 3);
    else LAUNCH_ROWS(4, 3);
  } else {
    if (q.k <= 32) LAUNCH_ROWS(1, 0);
    else if (q.k <= 64) LAUNCH_ROWS(2, 0);
    else LAUNCH_ROWS(4, 0);
  }
#undef LAUNCH_ROWS
  return (int)cudaGetLastError();
}

SelfArgs self_args(const void* coors, const void* mask, const void* adj, long long adj_bstride,
                   int b, int n, int c, int k, unsigned sentinel, void* out_hi, void* out_idx) {
  return SelfArgs{static_cast<const float*>(coors), static_cast<const unsigned char*>(mask),
                  static_cast<const unsigned char*>(adj), adj_bstride, b, n, c, k, sentinel,
                  static_cast<unsigned*>(out_hi), static_cast<long long*>(out_idx)};
}

}  // namespace

extern "C" {

// K4: exact selection at any n; vals f32 and idx i64. mask and adj may be null.
int knn_select_tiled_launch(const void* coors, const void* mask, const void* adj,
                            long long adj_bstride, int b, int n, int c, int k,
                            void* vals, void* idx, void* stream) {
  return launch_self<0, false>(
      self_args(coors, mask, adj, adj_bstride, b, n, c, k, 0u, vals, idx),
      static_cast<cudaStream_t>(stream));
}

// K5: 20-bit keys (f32 bits >> 12), masked pairs keyed 0x7F800. mask may be null.
int knn_candidates_packed_tiled_launch(const void* coors, const void* mask, int b, int n,
                                       int c, int kc, void* keys, void* cols,
                                       void* stream) {
  return launch_self<12, false>(
      self_args(coors, mask, nullptr, 0, b, n, c, kc, 0x7F800u, keys, cols),
      static_cast<cudaStream_t>(stream));
}

// K6: 18-bit keys (f32 bits >> 14), masked pairs keyed 0x1FF00. mask may be null.
int knn_candidates_packed_launch(const void* coors, const void* mask, int b, int n, int c,
                                 int kc, void* keys, void* cols, void* stream) {
  return launch_self<14, false>(
      self_args(coors, mask, nullptr, 0, b, n, c, kc, 0x1FF00u, keys, cols),
      static_cast<cudaStream_t>(stream));
}

// The launch plan of K4, K5, K6 at (b, n, c, k), with an adjacency or not,
// on a card of `sms` SMs: rows a warp and columns a lane a step.
int knn_select_block_plan(int b, int n, int c, int k, int adj, int sms, int* rows, int* cols) {
  *rows = rows_a_warp(b, n, c, k, adj != 0, sms);
  *cols = kRun;
  return 0;
}

// K8: r query rows (b, r, c) against the n points; vals f32 and idx i64,
// (b, r, k). qmask (b, r) and pmask (b, n) are both given or both null.
int knn_select_queries_launch(const void* queries, const void* qmask, const void* points,
                              const void* pmask, int b, int r, int n, int c, int k,
                              void* vals, void* idx, void* stream) {
  if ((qmask == nullptr) != (pmask == nullptr)) return (int)cudaErrorInvalidValue;
  SelfArgs a = self_args(points, pmask, nullptr, 0, b, n, c, k, 0u, vals, idx);
  a.queries = static_cast<const float*>(queries);
  a.qmask = static_cast<const unsigned char*>(qmask);
  a.nq = r;
  return launch_self<0, true>(a, static_cast<cudaStream_t>(stream));
}

// The launch plan of K8 at (b, r, c, k) on a card of `sms` SMs: rows a
// warp, columns a lane a step, and warps a row.
int knn_select_queries_plan(int b, int r, int c, int k, int sms, int* rows, int* cols,
                            int* stripes) {
  *stripes = stripes_a_row(b, r, c, sms);
  *rows = rows_a_warp(b, r, c, k, false, sms, *stripes);
  *cols = kRun;
  return 0;
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
  const Problem q{static_cast<const float*>(queries), static_cast<const float*>(points),
                  static_cast<const unsigned char*>(pmask),
                  static_cast<const int*>(starts), static_cast<const int*>(ids),
                  rows, width, b, r, n, c, k};
  return launch_rows(q, vals, static_cast<long long*>(idx),
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
