// kNN selection for Hopper (sm_90a): the exact selection of every row (with
// or without the gather of the winners' payload rows), the packed-key
// candidates, and the exact selection of a subset of query rows against all
// points or against a window of them. Plain C interface, loaded with ctypes
// (egnn_tpu_torch/ops/cuda/build.py, egnn_tpu_torch/ops/cuda/knn.py).
//
// Replaces the TPU kernels
//   K1 egnn_tpu/ops/pallas/knn.py:knn_select_gather_pallas
//      (_knn_gather_kernel): K3 and the payload rows table[b, j] of every
//      winner, copied as raw floats
//   K3 egnn_tpu/ops/pallas/knn.py:knn_select_pallas (_knn_kernel): K4's
//      selection within the full-band reach (n <= 16384)
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
//      unmasked (K4's kernel, kWindow)
// For every row i and column j, with d = x_i - x_j,
//   r_ij = (d_0^2 + d_1^2) + ...                             (f32, no FMA)
// K1, K3 and K4 rank by r with the fills
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
// packed value is the column's original id in place of j. K1's TPU kernel
// gathers its payload from a table split into bf16 planes by one-hot
// matrix products (the matrix unit's way to gather); here the winners'
// rows are copied as they are.
//
// Every warp keeps, for each of its rows, one ascending list of the k best
// packed values in registers (warp_topk.cuh). A row inserts about
// k * ln(n / k) times in all. A list per lane inserts some 32 times as
// often: measured on the H100 at n = 65536, kc = 20, 40.2 ms with per-lane
// lists against 6.5 ms.
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
// row a warp) ranked one pair a lane a step and paid for
// each pair three shared loads, the mask and fills, a 64-bit pack and a
// warp ballot against tau (some 25 instructions for 8 of distance),
// re-staged all columns for every 8 rows and exposed each tile's load. Now:
//  - kRows rows a warp (block_plan: 4 at k <= 32, 2 with an adjacency or
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
// K1, K3, K8 and K9 are instantiations of the same kernel for rows that are
// few: K1 and K3 the points at n <= 16384 (anchor 3: 1024 rows at b = 1),
// K8 the query rows with their mask qmask (kQuery; 2820 on path C's
// Gaussian cloud), K9 the query rows, all unmasked, each against the
// window of its group of rows (kWindow; 3802 on path C's `heavy` cloud).
// Where one row a warp would leave fewer than two blocks an SM (block_plan:
// under 2112 rows on 132 SMs), `stripes` warps share a row: warp s of the
// group takes the steps s, s + stripes, ... of every tile into lists of its
// own, and at the end the group's first warp merges the others' lists,
// parked in shared memory, into its own (warp_topk.cuh, merge_list): the
// union's top k is one, whatever the split. Each stripe fills a list of its
// own, so a split inserts more in all: at R = 2820 two stripes were slower
// than one, at the 1401 rows K9 leaves on `heavy` two were 4% faster on the
// H100 (PERF.md §6); anchor 3's 1024 rows at b = 1 take four (512
// blocks; eight were slower), at b = 8 none (two rows a warp). K4-K6 take
// no stripes, at compile time (kTiled): their plan at any n is the one
// above. Further:
//  - K1, K3 (kPoints): a row's adjacency bytes are its own, so a stripe
//    reads only its columns' bytes. K1's epilogue copies the k winners'
//    table rows, tw floats each, into the row's contiguous k * tw output
//    floats, a float a lane (coalesced stores; each winner's row is read in
//    order). Every column ranks as a packed value below kEmpty, a NaN
//    ranking too (by its bits, above +inf where it is positive), so with
//    k <= n every list ends with k real columns and every copied row exists.
//  - K1, K3, K4 rank a row block: the points r0 .. r0 + R - 1 against all n
//    columns (R = n, r0 = 0: every row), as the dense step sharded over
//    nodes ranks each rank's own rows against the gathered table. A row's
//    global id r0 + i sets its self column, its mask bit and its adjacency
//    row; its list is the k smallest packed values of its pairs whatever
//    the plan, so it equals the whole launch's row r0 + i bit for bit. K1's
//    epilogue copies the winners' rows from the whole table.
//  - K9: all rows of a block lie in one group of ti rows (block_plan halves
//    rows a warp until the block's rows divide ti, a multiple of kWarps), so
//    a block ranks one window [start, min(start + W, n)), start any column:
//    its tiles are copied by 4-byte cp.async, and the mask bytes loaded
//    byte by byte where start is not a multiple of 4. The columns' original
//    ids are one more plane of each tile, copied with the coordinates; the
//    low word of a packed value is the id, and a masked pair's pre-test
//    compares its id with the row's column threshold. Past the window the
//    coordinates are +inf and the ids ~0u. The window's columns ascend in
//    x, so a sweep from its start would meet a row's nearest columns last
//    and insert all the way: the block ranks first the tile that holds its
//    first row by x, then the tiles after it, then those before it
//    downwards (an ascending sweep was far slower at path C's heavy shape
//    on the H100). Tiles of 1024 columns at c = 3 (32 KB in two buffers
//    with the ids) keep four blocks an SM (2048: three, and slower).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using warp_topk::kEmpty;
using warp_topk::kFull;

constexpr int kWarps = 8;    // warps a block
constexpr int kMaxC = 16;    // largest coordinate dimension handled
constexpr int kMaxK = 128;   // longest list: 4 slots a lane
constexpr int kRun = 4;      // consecutive columns a lane ranks a step
constexpr int kStep = 32 * kRun;

// The rows of knn_select_block_kernel: the points against themselves, one
// warp a row (K4-K6) or `stripes` (K1, K3), query rows against all points
// (K8), query rows against a window of the points (K9). K4-K6 keep one
// warp a row at compile time: with the split of their steps a run-time
// argument K4 and K5 ran slower on the H100.
enum Rows : int { kTiled = 0, kPoints = 1, kQuery = 2, kWindow = 3 };

// whether the rows are the points themselves
__host__ __device__ constexpr bool self_rows(int mode) {
  return mode == kTiled || mode == kPoints;
}

// Columns a tile: 2048 at c = 3 (48 KB in two buffers), 1024 for K9, whose
// tiles carry the ids too (32 KB), 512 at any other c.
template <int kC, int kMode>
__host__ __device__ constexpr int block_tile() {
  return kC != 3 ? 512 : kMode == kWindow ? 1024 : 2048;
}

// K9's windows: one start for each group of ti consecutive query rows.
struct Window {
  const int* start;  // (b, ceil(nq / ti))
  const int* ids;    // (b, n): the columns' original ids
  int ti, width;
};

// K1's payload: the winners' rows of a table.
struct Payload {
  const float* table;  // (b, n, tw); null: none
  int tw;
  float* rows;         // (b, n, k, tw)
};

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

// Columns [j0, min(j0 + kBlockTile, j_end)) of cb into `planes` plane-major,
// planes[cc * kBlockTile + t] = cb[(j0 + t) * c + cc], and given `ids` (K9)
// their ids as plane c, as asynchronous copies. A partial tile's planes are
// +inf (the ids ~0u) from its last column to the end of its last step, so
// that those columns fail every distance pre-test.
template <int kC, int kBlockTile>
__device__ __forceinline__ void stage_tile(const float* __restrict__ cb,
                                           const int* __restrict__ ids, int j0, int j_end,
                                           int c, float* planes) {
  const int span = min(kBlockTile, j_end - j0);
  const int count = span * c;
  const float* src = cb + (size_t)j0 * c;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int t = kC > 0 ? e / kC : e / c;
    __pipeline_memcpy_async(planes + (e - t * c) * kBlockTile + t, src + e, sizeof(float));
  }
  if (ids != nullptr)
    for (int t = threadIdx.x; t < span; t += blockDim.x)
      __pipeline_memcpy_async(planes + c * kBlockTile + t, ids + j0 + t, sizeof(int));
  __pipeline_commit();
  const int pad = (kStep - span % kStep) % kStep;
  const int nplanes = ids != nullptr ? c + 1 : c;
  for (int e = threadIdx.x; e < pad * nplanes; e += blockDim.x) {
    const int cc = e / pad;
    planes[cc * kBlockTile + span + (e - cc * pad)] =
        __uint_as_float(cc < c ? 0x7f800000u : 0xffffffffu);
  }
}

// The pre-tests of a row whose k-th packed value is tau. A pair whose packed
// value is below tau has, unless it is masked, a distance v with
// !(v > thr) (thr NaN: every pair passes, the list is not full or tau is
// NaN); a masked pair, whose key is fill_key, exactly when the low word of
// its packed value (its column, K9: its id) is below mthr. K4's key is the
// order of v itself; K5's and K6's keep the bits of v above kShift, so thr
// is the largest float of tau's key.
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

// kShift: 0 (K1, K3, K4, K8, K9: exact ranking and fills), 12 (K5), 14
// (K6). kSlots: list entries a lane holds, ceil(k / 32). kRows: rows a warp.
// kC: the coordinate dimension when it is 3, else 0: any c <= kMaxC through
// a predicated loop (one row a warp). kMask, kAdj: the mask (adjacency) is
// given; at kC == 0 they say it may be, and the pointer decides. kMode: the
// rows (Rows), each ranked by `stripes` warps (kTiled: one).
template <int kShift, int kSlots, int kRows, int kC, bool kMask, bool kAdj, int kMode>
__global__ void __launch_bounds__(kWarps * 32, kC == 3 ? 4 : 2) knn_select_block_kernel(
    const float* __restrict__ coors,         // (b, n, c): the columns
    const unsigned char* __restrict__ mask,  // (b, n): the columns' mask
    const unsigned char* __restrict__ adj,   // rows of n bytes (K1, K3, K4)
    long long adj_bstride,                   // 0 when one (n, n) is shared
    bool aligned4,                           // mask and adjacency rows 4-byte aligned
    int n, int c, int k, unsigned sentinel,
    const float* __restrict__ queries,       // (b, nq, c): the rows of K8 and K9
    const unsigned char* __restrict__ qmask, // (b, nq), K8 only: given with mask
    int r0,                                  // K1, K3, K4: the first of the nq points ranked
    int nq, int stripes,
    Window win,                              // K9
    Payload pay,                             // K1
    unsigned* __restrict__ out_hi,           // (b, nrows, k): vals f32 bits, or keys
    long long* __restrict__ out_idx) {       // (b, nrows, k)
  extern __shared__ __align__(16) float smem[];  // two tiles of c planes (K9: c + 1)
  constexpr int kDims = kC > 0 ? kC : kMaxC;
  constexpr int kBlockTile = block_tile<kC, kMode>();
  const bool has_mask = kMask && (kC > 0 || mask != nullptr);
  const bool has_adj = kShift == 0 && kAdj && self_rows(kMode) && (kC > 0 || adj != nullptr);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  // `stripes` warps a group of rows, warp `stripe` of it taking every
  // stripes-th step of a tile
  const int stripe = kMode == kTiled ? 0 : warp % stripes;
  const int groups = kMode == kTiled ? kWarps : kWarps / stripes;
  const int stride = kMode == kTiled ? kStep : stripes * kStep;  // between a warp's steps
  // the rows ranked: the points r0 .. r0 + nq - 1 (K1, K3, K4: a row block,
  // all n at r0 = 0), or the nq query rows (K8, K9); row0 counts from the first
  const int nrows = nq;
  const int row0 = (blockIdx.x * groups + (kMode == kTiled ? warp : warp / stripes)) * kRows;
  const float* cb = coors + (size_t)b * n * c;
  // the rows' coordinates
  const float* rb = self_rows(kMode) ? cb + (size_t)r0 * c : queries + (size_t)b * nq * c;
  const unsigned char* mb = has_mask ? mask + (size_t)b * n : nullptr;
  const unsigned char* rmb =
      has_mask ? (kMode == kQuery ? qmask + (size_t)b * nq : mb + r0) : nullptr;

  // the block's columns: all n, or (K9) the window of its rows' group
  int j_begin = 0, j_end = n;
  const int* ids = nullptr;
  if (kMode == kWindow) {
    const int group = blockIdx.x * groups * kRows / win.ti;
    j_begin = win.start[(size_t)b * ((nq + win.ti - 1) / win.ti) + group];
    j_end = min(j_begin + win.width, n);
    ids = win.ids + (size_t)b * n;
    aligned4 = aligned4 && j_begin % 4 == 0;
  }

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
    mask_i[r] = has_mask && ok && (kMode == kWindow || rmb[i] != 0);
    adj_row[r] = has_adj && ok ? adj + (size_t)b * adj_bstride + (size_t)(r0 + i) * n : nullptr;
    list[r].init(k, lane);
  }

  // the pre-tests of each row, from its k-th value (row_thresholds)
  const unsigned fill_key = kShift == 0 ? warp_topk::ordered_bits(1e5f) : sentinel;
  float thr[kRows];
  unsigned mthr[kRows];
  int self_col[kRows];  // the row's own column; none for a row past the last
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row_thresholds<kShift>(list[r].tau, fill_key, thr[r], mthr[r]);
    self_col[r] = r0 + row0 + r;
    if (row0 + r >= nrows) {  // a row past the last passes no pre-test and never inserts
      thr[r] = __uint_as_float(0xff800000u);  // -inf
      mthr[r] = 0u;
      self_col[r] = -2 * kRun;
    }
  }

  // the mask bytes and each row's adjacency bytes of the lane's columns,
  // loaded a step ahead of their use
  auto load_words = [&](int j, unsigned& mw, unsigned (&aw)[kRows]) {
    mw = has_mask ? load_bytes4(mb + j, j_end - j, aligned4) : 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      aw[r] = has_adj && adj_row[r] != nullptr ? load_bytes4(adj_row[r] + j, n - j, aligned4)
                                               : 0u;
  };
  const int tile_floats = kBlockTile * (kMode == kWindow ? c + 1 : c);  // one of the two buffers
  const int ntiles = (j_end - j_begin + kBlockTile - 1) / kBlockTile;
  // K9: the tile that holds the block's first row by x (the window's
  // columns ascend in x) is ranked first, then the tiles after it, then
  // those before it downwards: the nearest columns come early and the
  // row's k-th value falls fast
  int first = 0;
  if (kMode == kWindow) {
    const float xq = rb[(size_t)blockIdx.x * groups * kRows * c];
    const int t = threadIdx.x + 1;  // of the first kWarps * 32 tiles
    first = __syncthreads_count(t < ntiles && cb[(size_t)(j_begin + t * kBlockTile) * c] <= xq);
  }
  // the first column of the v-th tile ranked (K9: j_end past the last)
  auto tile_start = [&](int v) {
    if (kMode != kWindow) return v * kBlockTile;
    if (v >= ntiles) return j_end;
    return j_begin + (v < ntiles - first ? first + v : ntiles - 1 - v) * kBlockTile;
  };

  unsigned mnext, anext[kRows];
  load_words(tile_start(0) + stripe * kStep + kRun * lane, mnext, anext);
  stage_tile<kC, kBlockTile>(cb, ids, tile_start(0), j_end, c, smem);
  for (int tile = 0; tile < ntiles; ++tile) {
    // this thread's copies of the tile have landed; after the barrier every
    // thread's have, and no warp still ranks the tile before, whose buffer
    // the next copies overwrite
    __pipeline_wait_prior(0);
    __syncthreads();
    const int j_next = tile_start(tile + 1);
    if (tile + 1 < ntiles)
      stage_tile<kC, kBlockTile>(cb, ids, j_next, j_end, c, smem + ((tile + 1) & 1) * tile_floats);
    const float* xt = smem + (tile & 1) * tile_floats;
    const unsigned* idt = reinterpret_cast<const unsigned*>(xt + c * kBlockTile);  // K9's ids
    const int j0 = tile_start(tile);
    const int span = min(kBlockTile, j_end - j0);
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
      // the low words of the lane's packed values: the columns, K9 their ids
      unsigned col[kRun];
      if (kMode == kWindow) {
        const uint4 u = *reinterpret_cast<const uint4*>(idt + t);
        col[0] = u.x; col[1] = u.y; col[2] = u.z; col[3] = u.w;
      } else {
#pragma unroll
        for (int q = 0; q < kRun; ++q) col[q] = (unsigned)(j + q);
      }
      const unsigned mword = mnext;
      unsigned aword[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) aword[r] = anext[r];
      // the warp's next step's columns, across tiles too (stripes divides a
      // tile's steps; K9's next tile may lie anywhere)
      load_words(kMode != kWindow || t0 + stride < span ? j + stride
                                                        : j_next + stripe * kStep + kRun * lane,
                 mnext, anext);

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
            if (j + q == self_col[r]) v = -1.f;
            else if (((aword[r] >> (8 * q)) & 0xffu) != 0) v = 0.f;
          }
          hi = warp_topk::ordered_bits(v);
        } else {
          hi = masked ? sentinel : (__float_as_uint(v) >> kShift);
        }
        return ((unsigned long long)hi << 32) | col[q];
      };

      // bit r: a pair of row r may be below the row's tau. Unmasked pairs
      // test their distance against thr, masked ones (one key) their low
      // word against mthr; a row's self and adjacent columns (fills -1 and
      // 0) always take the insertion path.
      unsigned flags = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        bool pass = false;
        if (!has_mask || mask_i[r]) {  // uniform
#pragma unroll
          for (int q = 0; q < kRun; ++q) {
            bool below = !(dist(r, q) > thr[r]);
            if (has_mask && ((mword >> (8 * q)) & 0xffu) == 0) below = col[q] < mthr[r];
            pass = pass || below;
          }
        } else {
          pass = (unsigned)j < mthr[r];  // every pair of the row is masked (not K9)
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

  if (kMode != kTiled && stripes > 1) {  // the group's first warp takes the others' lists
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
    if (i >= nrows) continue;  // uniform
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
    if (kMode == kPoints && pay.table != nullptr) {
      // K1: the winners' table rows into the row's k * tw floats, float f
      // of them float f % tw of winner f / tw, one float a lane
      const int tw = pay.tw;
      const float* tb = pay.table + (size_t)b * n * tw;
      float* dst = pay.rows + row * k * tw;
      int e = lane / tw, t = lane % tw;  // of the lane's float f0 + lane
      const int de = 32 / tw, dt = 32 % tw;
      for (int f0 = 0; f0 < k * tw; f0 += 32) {
        unsigned col = 0;  // winner e's column: lane e % 32 of slot e / 32
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const unsigned v = __shfl_sync(kFull, (unsigned)list[r].entry[s], e & 31);
          if (s == e >> 5) col = v;
        }
        if (f0 + lane < k * tw) dst[f0 + lane] = __ldg(tb + (size_t)col * tw + t);
        e += de;
        t += dt;
        if (t >= tw) {
          t -= tw;
          ++e;
        }
      }
    }
  }
}

// The blocks of knn_select_block_kernel for b * nrows rows at `rows` rows a
// warp and `stripes` warps a row.
long long block_count(int b, int nrows, int rows, int stripes) {
  const int per_block = kWarps / stripes * rows;
  return (long long)b * ((nrows + per_block - 1) / per_block);
}

struct Plan {
  int rows, stripes;  // rows a warp, warps a row
};

// The launch plan of knn_select_block_kernel, its one owner
// (knn_select_plan exports it):
//  - warps a row: 1 for K4-K6 (`striped` false); for K1, K3, K8 and K9, 1
//    while one row a warp gives two blocks an SM, else the fewest of 2, 4,
//    8 that do; 1 at c != 3;
//  - rows a warp: 4 at k <= 32 (one list slot a lane), 2 at k <= 64, 1
//    beyond, and 1 at c != 3; 2 at most with an adjacency, whose bytes are
//    each row's own (no reuse across rows) and whose latency twice the
//    warps hide better (K4 on path B's chain ran slower at 4 on the H100);
//    halved while the grid would hold fewer than two blocks an SM, and
//    (K9: ti > 0, the rows that share a window, a multiple of kWarps) while
//    a block's rows do not divide ti.
Plan block_plan(int b, int nrows, int c, int k, bool adj, bool striped, int ti, int sms) {
  Plan p{c != 3 ? 1 : k <= 32 ? (adj ? 2 : 4) : k <= 64 ? 2 : 1, 1};
  while (striped && c == 3 && p.stripes < kWarps &&
         block_count(b, nrows, 1, p.stripes) < 2LL * sms)
    p.stripes *= 2;
  while (p.rows > 1 && (block_count(b, nrows, p.rows, p.stripes) < 2LL * sms ||
                        (ti > 0 && ti % (kWarps / p.stripes * p.rows) != 0)))
    p.rows /= 2;
  return p;
}

struct BlockArgs {
  const float* coors;
  const unsigned char* mask;
  const unsigned char* adj;
  long long adj_bstride;
  int b, n, c, k;
  unsigned sentinel;
  unsigned* out_hi;
  long long* out_idx;
  const float* queries = nullptr;  // K8, K9: the query rows; K8 their mask
  const unsigned char* qmask = nullptr;
  int nq = 0;                      // the rows: K8, K9 the queries; K1, K3, K4 the block's
  int r0 = 0;                      // K1, K3, K4: the block's first point
  Window win = {nullptr, nullptr, 0, 0};
  Payload pay = {nullptr, 0, nullptr};
  Plan plan = {1, 1};
};

template <int kShift, int kSlots, int kRows, int kC, bool kMask, bool kAdj, int kMode>
int launch_block_kernel(const BlockArgs& a, cudaStream_t stream) {
  auto kernel = knn_select_block_kernel<kShift, kSlots, kRows, kC, kMask, kAdj, kMode>;
  // two tiles of c planes (K9: c + 1); at the end the stripes' lists take
  // their place
  const size_t tiles = 2 * sizeof(float) * block_tile<kC, kMode>() *
                       (kMode == kWindow ? a.c + 1 : a.c);
  const size_t lists = a.plan.stripes > 1 ? 8 * 32 * kSlots * kRows * kWarps : 0;
  const size_t smem = tiles > lists ? tiles : lists;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uintptr_t m = reinterpret_cast<uintptr_t>(a.mask), j = reinterpret_cast<uintptr_t>(a.adj);
  const bool aligned4 = a.n % 4 == 0 && m % 4 == 0 && j % 4 == 0 && a.adj_bstride % 4 == 0;
  const int per_block = kWarps / a.plan.stripes * kRows;
  const dim3 grid((a.nq + per_block - 1) / per_block, a.b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a.coors, a.mask, a.adj, a.adj_bstride, aligned4,
                                              a.n, a.c, a.k, a.sentinel, a.queries, a.qmask,
                                              a.r0, a.nq, a.plan.stripes, a.win, a.pay, a.out_hi,
                                              a.out_idx);
  return (int)cudaGetLastError();
}

// the instantiation for the given mask and adjacency
template <int kShift, int kSlots, int kRows, int kC, int kMode>
int launch_block_flags(const BlockArgs& a, cudaStream_t stream) {
  if constexpr (kC == 0) {
    return launch_block_kernel<kShift, kSlots, kRows, 0, true, kShift == 0 && self_rows(kMode),
                               kMode>(a, stream);
  } else {
    const bool m = a.mask != nullptr;
    // block_plan: 2 rows at most with an adjacency; K8 and K9 take none
    if constexpr (kShift == 0 && kRows <= 2 && self_rows(kMode)) {
      if (a.adj != nullptr)
        return m ? launch_block_kernel<kShift, kSlots, kRows, kC, true, true, kMode>(a, stream)
                 : launch_block_kernel<kShift, kSlots, kRows, kC, false, true, kMode>(a, stream);
    } else {
      if (a.adj != nullptr) return (int)cudaErrorInvalidValue;
    }
    return m ? launch_block_kernel<kShift, kSlots, kRows, kC, true, false, kMode>(a, stream)
             : launch_block_kernel<kShift, kSlots, kRows, kC, false, false, kMode>(a, stream);
  }
}

// Every kernel of this source at the plan of block_plan.
template <int kShift, int kMode>
int launch_rows(BlockArgs a, cudaStream_t stream) {
  const int nrows = a.nq;
  // k <= n: every list element ends as a real column; a row block lies in the points
  if (a.b < 1 || a.n < 1 || nrows < 1 || a.c < 1 || a.c > kMaxC || a.k < 1 || a.k > kMaxK ||
      a.k > a.n || a.r0 < 0 || (self_rows(kMode) && a.r0 > a.n - nrows) ||
      (!self_rows(kMode) && a.r0 != 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  a.plan = block_plan(a.b, nrows, a.c, a.k, a.adj != nullptr, kMode != kTiled,
                      kMode == kWindow ? a.win.ti : 0, sms);
  const int rows = a.plan.rows;
  if (a.c != 3) {
    if (a.k <= 32) return launch_block_flags<kShift, 1, 1, 0, kMode>(a, stream);
    if (a.k <= 64) return launch_block_flags<kShift, 2, 1, 0, kMode>(a, stream);
    return launch_block_flags<kShift, 4, 1, 0, kMode>(a, stream);
  }
  if (a.k <= 32) {
    if (rows == 4) return launch_block_flags<kShift, 1, 4, 3, kMode>(a, stream);
    if (rows == 2) return launch_block_flags<kShift, 1, 2, 3, kMode>(a, stream);
    return launch_block_flags<kShift, 1, 1, 3, kMode>(a, stream);
  }
  if (a.k <= 64) {
    if (rows == 2) return launch_block_flags<kShift, 2, 2, 3, kMode>(a, stream);
    return launch_block_flags<kShift, 2, 1, 3, kMode>(a, stream);
  }
  return launch_block_flags<kShift, 4, 1, 3, kMode>(a, stream);
}

// The arguments of a launch over the points' rows r0 .. r0 + nrows - 1 (K8
// and K9 set their query rows in place of the points').
BlockArgs block_args(const void* coors, const void* mask, const void* adj, long long adj_bstride,
                     int b, int n, int c, int k, int r0, int nrows, unsigned sentinel,
                     void* out_hi, void* out_idx) {
  BlockArgs a{static_cast<const float*>(coors), static_cast<const unsigned char*>(mask),
              static_cast<const unsigned char*>(adj), adj_bstride, b, n, c, k, sentinel,
              static_cast<unsigned*>(out_hi), static_cast<long long*>(out_idx)};
  a.r0 = r0;
  a.nq = nrows;
  return a;
}

}  // namespace

extern "C" {

// K1, K3 and K4 rank the rows r0 .. r0 + nrows - 1 of the n points (a row
// block; all of them at r0 = 0, nrows = n) against all n columns: row r0 + i
// of the block takes its own mask bit, adjacency row and self column, and
// equals the whole launch's row r0 + i bit for bit. The outputs are
// (b, nrows, ...).
//
// K1: selection and the winners' payload rows, gathered from the whole
// table; vals f32, idx i64 (b, nrows, k), rows f32 (b, nrows, k, tw). mask and
// adj may be null.
int knn_select_gather_launch(const void* coors, const void* mask, const void* adj,
                             long long adj_bstride, const void* table, int b, int n, int c,
                             int k, int tw, int r0, int nrows, void* vals, void* idx, void* rows,
                             void* stream) {
  if (table == nullptr || rows == nullptr || tw < 1) return (int)cudaErrorInvalidValue;
  BlockArgs a = block_args(coors, mask, adj, adj_bstride, b, n, c, k, r0, nrows, 0u, vals, idx);
  a.pay = Payload{static_cast<const float*>(table), tw, static_cast<float*>(rows)};
  return launch_rows<0, kPoints>(a, static_cast<cudaStream_t>(stream));
}

// K3: K1's selection alone. mask and adj may be null.
int knn_select_launch(const void* coors, const void* mask, const void* adj,
                      long long adj_bstride, int b, int n, int c, int k, int r0, int nrows,
                      void* vals, void* idx, void* stream) {
  return launch_rows<0, kPoints>(
      block_args(coors, mask, adj, adj_bstride, b, n, c, k, r0, nrows, 0u, vals, idx),
      static_cast<cudaStream_t>(stream));
}

// K4: exact selection at any n; vals f32 and idx i64. mask and adj may be null.
int knn_select_tiled_launch(const void* coors, const void* mask, const void* adj,
                            long long adj_bstride, int b, int n, int c, int k, int r0,
                            int nrows, void* vals, void* idx, void* stream) {
  return launch_rows<0, kTiled>(
      block_args(coors, mask, adj, adj_bstride, b, n, c, k, r0, nrows, 0u, vals, idx),
      static_cast<cudaStream_t>(stream));
}

// K5: 20-bit keys (f32 bits >> 12), masked pairs keyed 0x7F800. mask may be null.
int knn_candidates_packed_tiled_launch(const void* coors, const void* mask, int b, int n,
                                       int c, int kc, void* keys, void* cols,
                                       void* stream) {
  return launch_rows<12, kTiled>(
      block_args(coors, mask, nullptr, 0, b, n, c, kc, 0, n, 0x7F800u, keys, cols),
      static_cast<cudaStream_t>(stream));
}

// K6: 18-bit keys (f32 bits >> 14), masked pairs keyed 0x1FF00. mask may be null.
int knn_candidates_packed_launch(const void* coors, const void* mask, int b, int n, int c,
                                 int kc, void* keys, void* cols, void* stream) {
  return launch_rows<14, kTiled>(
      block_args(coors, mask, nullptr, 0, b, n, c, kc, 0, n, 0x1FF00u, keys, cols),
      static_cast<cudaStream_t>(stream));
}

// K8: r query rows (b, r, c) against the n points; vals f32 and idx i64,
// (b, r, k). qmask (b, r) and pmask (b, n) are both given or both null.
int knn_select_queries_launch(const void* queries, const void* qmask, const void* points,
                              const void* pmask, int b, int r, int n, int c, int k,
                              void* vals, void* idx, void* stream) {
  if ((qmask == nullptr) != (pmask == nullptr)) return (int)cudaErrorInvalidValue;
  BlockArgs a = block_args(points, pmask, nullptr, 0, b, n, c, k, 0, r, 0u, vals, idx);
  a.queries = static_cast<const float*>(queries);
  a.qmask = static_cast<const unsigned char*>(qmask);
  return launch_rows<0, kQuery>(a, static_cast<cudaStream_t>(stream));
}

// K9: r query rows, all unmasked, against the columns [start, start + width)
// of the sorted points, clipped to n; starts (b, ceil(r / rows)) holds one
// start for each group of `rows` consecutive query rows (a multiple of 8),
// any column; ids (b, n) are the columns' original ids, by which ties are
// ordered and columns reported. pmask (b, n) may be null. Every window must
// hold k columns of the n.
int knn_select_window_launch(const void* queries, const void* points, const void* pmask,
                             const void* ids, const void* starts, int rows, int width, int b,
                             int r, int n, int c, int k, void* vals, void* idx,
                             void* stream) {
  if (starts == nullptr || ids == nullptr || rows < kWarps || rows % kWarps != 0 || k > width)
    return (int)cudaErrorInvalidValue;
  BlockArgs a = block_args(points, pmask, nullptr, 0, b, n, c, k, 0, r, 0u, vals, idx);
  a.queries = static_cast<const float*>(queries);
  a.win = Window{static_cast<const int*>(starts), static_cast<const int*>(ids), rows, width};
  return launch_rows<0, kWindow>(a, static_cast<cudaStream_t>(stream));
}

// The launch plan of knn_select_block_kernel (block_plan) for b * nrows
// rows at (c, k), with an adjacency or not, on a card of `sms` SMs: rows a
// warp, columns a lane a step and warps a row. striped: K1, K3, K8 or K9
// (0: K4-K6); ti: K9's rows that share a window (0: none).
int knn_select_plan(int striped, int b, int nrows, int c, int k, int adj, int ti, int sms,
                    int* rows, int* cols, int* stripes) {
  const Plan p = block_plan(b, nrows, c, k, adj != 0, striped != 0, ti, sms);
  *rows = p.rows;
  *cols = kRun;
  *stripes = p.stripes;
  return 0;
}

}  // extern "C"
